"""LM-family model zoo (functional PyTorch)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.models.encdec import EncDecTransformer
from repro_torch.models.transformer import Transformer


def model_for(cfg: ModelConfig):
    """Instantiate the right model class for a config."""
    if cfg.encdec:
        return EncDecTransformer(cfg)
    return Transformer(cfg)


__all__ = ["EncDecTransformer", "ModelConfig", "Transformer", "model_for"]
