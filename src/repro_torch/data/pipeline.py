"""Deterministic sharded synthetic token pipeline.

Every (step, host) pair maps to a unique slice of an infinite deterministic
stream (hash-seeded), so (a) restarts resume exactly, (b) any host can
recompute any other host's shard (straggler/failure recovery), (c) the
global batch is identical regardless of host count — the elastic-restart
invariant tested in tests/test_fault_tolerance.py.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234


def _example(cfg: DataConfig, index: int) -> np.ndarray:
    """Deterministic pseudo-text: a seeded markov-ish integer stream."""
    rng = np.random.default_rng((cfg.seed, index))
    # zipf-ish marginal so the loss has structure
    z = rng.zipf(1.3, cfg.seq_len + 1) % cfg.vocab
    return z.astype(np.int32)


def global_batch_indices(cfg: DataConfig, step: int) -> np.ndarray:
    start = step * cfg.global_batch
    return np.arange(start, start + cfg.global_batch)


def host_batch(cfg: DataConfig, step: int, host_id: int = 0,
               n_hosts: int = 1) -> Dict[str, np.ndarray]:
    """The host's slice of the global batch for `step`."""
    idx = global_batch_indices(cfg, step)
    assert cfg.global_batch % n_hosts == 0
    per = cfg.global_batch // n_hosts
    mine = idx[host_id * per:(host_id + 1) * per]
    toks = np.stack([_example(cfg, int(i)) for i in mine])
    return {
        "tokens": toks[:, :-1],
        "targets": toks[:, 1:],
        "mask": np.ones((per, cfg.seq_len), np.float32),
    }


def stream(cfg: DataConfig, start_step: int = 0, host_id: int = 0,
           n_hosts: int = 1) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield host_batch(cfg, step, host_id, n_hosts)
        step += 1
