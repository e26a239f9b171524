"""Deterministic synthetic token pipeline (numpy, the reference's).

A copy of ``repro/train/data.py``: every batch is a pure function of
(seed, step), so a restarted run regenerates byte-identical batches for any
step range and a restore at step k continues the same data order.  The
batches are numpy arrays, byte for byte the reference's (int32 ids, f32
frames); the train step turns ids into int64 tensors as they enter the
model.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig

__all__ = ["DataConfig", "synthetic_batch", "batch_for"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab_size: int = 50304
    batch: int = 8
    seq_len: int = 512


def synthetic_batch(dc: DataConfig, step: int) -> dict[str, np.ndarray]:
    """Markov-ish synthetic tokens with learnable local structure (so the
    loss goes down; uniform noise would not)."""
    rng = np.random.default_rng(dc.seed * 1_000_003 + step)
    B, S, V = dc.batch, dc.seq_len, dc.vocab_size
    # piecewise-repeating pattern: next token = (prev * a + b) % V on most
    # positions, with 10% noise
    a = 31, 17
    base = rng.integers(0, V, size=(B, 1))
    toks = [base]
    for _ in range(S):
        nxt = (toks[-1] * a[0] + a[1]) % V
        noise = rng.integers(0, V, size=(B, 1))
        mask = rng.random((B, 1)) < 0.1
        toks.append(np.where(mask, noise, nxt))
    seq = np.concatenate(toks, axis=1)
    return {"tokens": seq[:, :S].astype(np.int32),
            "labels": seq[:, 1:S + 1].astype(np.int32)}


def batch_for(cfg: ModelConfig, shape: ShapeConfig, step: int,
              *, seed: int = 0) -> dict[str, np.ndarray]:
    """A batch of ``shape``; enc-dec configs also get stub frame embeddings
    ``[B, S, D]`` and decoder tokens of ``S // dec_len_ratio``."""
    dc = DataConfig(seed=seed, vocab_size=cfg.vocab_size,
                    batch=shape.global_batch, seq_len=shape.seq_len)
    b = synthetic_batch(dc, step)
    if cfg.encoder_layers:
        rng = np.random.default_rng(seed * 7 + step)
        Sd = max(shape.seq_len // cfg.dec_len_ratio, 1)
        return {
            "frames": rng.normal(size=(shape.global_batch, shape.seq_len,
                                       cfg.d_model)).astype(np.float32),
            "tokens": b["tokens"][:, :Sd],
            "labels": b["labels"][:, :Sd],
        }
    return b
