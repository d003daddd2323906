"""LM-family model zoo (functional PyTorch)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import Transformer


def model_for(cfg: ModelConfig):
    """Instantiate the right model class for a config."""
    if cfg.encdec:
        raise NotImplementedError(
            "encoder-decoder models are not ported yet (ROADMAP.md: encdec/mrope)"
        )
    return Transformer(cfg)


__all__ = ["ModelConfig", "Transformer", "model_for"]
