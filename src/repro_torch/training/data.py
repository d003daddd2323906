"""Synthetic token data pipeline (a copy of ``repro.training.data``, numpy
only, so the port imports nothing of the reference).

Deterministic, seekable, and shardable: batch ``i`` is a pure function of
(seed, i), so a restarted run resumes mid-epoch from the checkpointed
step with identical data, and each data-parallel host can generate only
its slice (``host_slice``). Generation mimics a Zipfian token
distribution so embedding-gather and softmax cost profiles are realistic
rather than uniform-random. Batches are numpy arrays; the caller moves
them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.1


class SyntheticTokens:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # Zipfian token probabilities (stable across runs).
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_alpha)
        self._probs = (p / p.sum()).astype(np.float64)

    def batch(self, index: int, host_slice: Optional[Tuple[int, int]] = None
              ) -> Dict[str, np.ndarray]:
        """Batch ``index``; host_slice=(host_id, n_hosts) generates only
        this host's rows of the global batch."""
        cfg = self.cfg
        lo, hi = 0, cfg.global_batch
        if host_slice is not None:
            host, n_hosts = host_slice
            per = cfg.global_batch // n_hosts
            lo, hi = host * per, (host + 1) * per
        rows = []
        for r in range(lo, hi):
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, index, r])
            )
            rows.append(
                rng.choice(cfg.vocab_size, size=cfg.seq_len, p=self._probs)
            )
        tokens = np.stack(rows).astype(np.int32)
        return {"tokens": tokens}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        i = 0
        while True:
            yield self.batch(i)
            i += 1
