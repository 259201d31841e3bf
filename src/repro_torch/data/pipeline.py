"""Deterministic synthetic token pipeline, sharded per host.

The port's copy of the reference's ``data/pipeline.py``: pure numpy, so
the batches are the reference's bit for bit (the port never imports the
reference, not even a module of it that needs no JAX).

Real clusters stream from a distributed store; the repo ships no
dataset, so the pipeline synthesizes a *deterministic* token stream from
(seed, step, shard) — the properties that matter for the framework are kept:

  * restart-safety: batch(step) is a pure function, so resuming from a
    checkpoint replays the exact stream (tested),
  * per-host sharding: each data-parallel shard draws a disjoint slice,
  * learnable structure: tokens follow a noisy affine-recurrence language
    (next = (a * cur + b) % vocab with ~10% noise) so train-loss decreases
    measurably within a few hundred steps on the smoke models.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.1
    n_shards: int = 1
    shard: int = 0


def _batch_numpy(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Pure function of (cfg, step) -> host-local batch."""
    assert cfg.global_batch % cfg.n_shards == 0
    local = cfg.global_batch // cfg.n_shards
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.shard]))
    a = 31, 17
    start = rng.integers(0, cfg.vocab, size=(local, 1))
    seq = [start]
    cur = start
    for _ in range(cfg.seq_len):
        nxt = (a[0] * cur + a[1]) % cfg.vocab
        flip = rng.random((local, 1)) < cfg.noise
        rand = rng.integers(0, cfg.vocab, size=(local, 1))
        cur = np.where(flip, rand, nxt)
        seq.append(cur)
    toks = np.concatenate(seq, axis=1).astype(np.int32)   # (local, S+1)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


class SyntheticPipeline:
    """Iterator with explicit step state (checkpointable)."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self.step = start_step

    def next(self) -> Dict[str, np.ndarray]:
        batch = _batch_numpy(self.cfg, self.step)
        self.step += 1
        return batch

    def state(self) -> Dict:
        return {"step": self.step}

    def restore(self, state: Dict) -> None:
        self.step = int(state["step"])

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next()


def frontend_stub(batch: int, tokens: int, d_model: int,
                  step: int = 0, seed: int = 0) -> np.ndarray:
    """Deterministic stand-in for modality frontends (image patches /
    audio frames): input_specs() feeds these pre-computed embeddings."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, 7]))
    return (0.02 * rng.standard_normal((batch, tokens, d_model))
            ).astype(np.float32)
