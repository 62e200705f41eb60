"""Deterministic synthetic data pipeline: the port of
``repro.data.pipeline`` (numpy, the same batches bit for bit).

A noisy modular-arithmetic token stream, so the training loss can fall,
without an external corpus.  Every batch is a pure function of
(seed, step), which makes a resume from a checkpoint exactly reproducible.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    prefix_len: int = 0       # vlm/audio stub prefix embeddings
    d_model: int = 0


def synth_batch(dc: DataConfig, step: int) -> dict:
    """Pure function of (seed, step) -> {"tokens", "labels"} int32 (B, S)
    numpy arrays (and "prefix" (B, P, D) float32 with ``prefix_len``)."""
    rng = np.random.default_rng(np.random.SeedSequence([dc.seed, step]))
    B, S, V = dc.batch, dc.seq_len, dc.vocab_size
    # structured stream: x_{t+1} = (a * x_t + b) mod Veff, with noise
    veff = max(2, min(V, 4096))
    a = rng.integers(2, 8, size=(B, 1))
    b = rng.integers(0, veff, size=(B, 1))
    x0 = rng.integers(0, veff, size=(B, 1))
    toks = np.empty((B, S + 1), np.int64)
    toks[:, 0:1] = x0
    for t in range(S):
        nxt = (a[:, 0] * toks[:, t] + b[:, 0]) % veff
        noise = rng.random(B) < 0.05
        nxt = np.where(noise, rng.integers(0, veff, size=B), nxt)
        toks[:, t + 1] = nxt
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    if dc.prefix_len:
        batch["prefix"] = rng.standard_normal(
            (B, dc.prefix_len, dc.d_model)).astype(np.float32)
    return batch


def data_iterator(dc: DataConfig, start_step: int = 0) -> Iterator[dict]:
    step = start_step
    while True:
        yield synth_batch(dc, step)
        step += 1
