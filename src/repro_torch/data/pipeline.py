"""Deterministic synthetic token pipeline with stateless resume.

A copy of the reference package's ``data/pipeline.py`` (numpy only, kept
here because the port imports nothing of the reference): every batch is
a pure function of (seed, step, shard), so a restarted job regenerates
exactly the token stream it would have seen, with no iterator state to
checkpoint. Shards slice the global batch. The batches are numpy arrays,
bit for bit the reference's; the caller makes tensors of them on its
device.

The synthetic text is a Zipf-ish Markov stream: enough structure for a
small model to show steadily decreasing loss.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1
    shard: int = 0


def _batch_rng(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step]))


def make_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Global batch for ``step``, sliced to this shard: int32 ``tokens``
    and ``labels`` (the next tokens), each (global_batch / n_shards,
    seq_len)."""
    rng = _batch_rng(cfg, step)
    B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    # zipf-ish unigram pool mixed with short-range repetition structure
    base = (rng.zipf(1.3, size=(B, S + 1)) - 1) % V
    rep = np.roll(base, 7, axis=1)
    mask = rng.random((B, S + 1)) < 0.35
    toks = np.where(mask, rep, base).astype(np.int32)
    tokens, labels = toks[:, :-1], toks[:, 1:]
    shard_sz = B // cfg.n_shards
    lo = cfg.shard * shard_sz
    hi = lo + shard_sz
    return {"tokens": tokens[lo:hi], "labels": labels[lo:hi]}


def iterate(cfg: DataConfig, start_step: int = 0
            ) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield make_batch(cfg, step)
        step += 1
