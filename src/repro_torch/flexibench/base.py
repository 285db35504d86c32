"""FlexiBench workload framework.

Each workload provides: an RV32E assembly program (built with the asm eDSL),
a bit-exact jnp functional reference, a synthetic dataset generator, and
deployment metadata (SDG, lifetime, task frequency) from the paper's
Table 2. The ISS output must equal the reference output on every input —
that equivalence is property-tested.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.flexibits.asm import Program

DAY_S = 86_400.0
WEEK_S = 7 * DAY_S
MONTH_S = 30 * DAY_S
YEAR_S = 365 * DAY_S


@dataclasses.dataclass(frozen=True)
class Workload:
    key: str                      # short id (WQ, FS, ...)
    name: str
    sdg: str
    algorithm: str
    lifetime_s: float             # example deployment lifetime (Table 2)
    execs_per_day: float          # example task frequency (red star)
    program: Program
    mem_words: int                # RAM words for the ISS
    n_inputs: int                 # input words written at RAM[0..]
    gen_inputs: Callable[[np.random.Generator, int], np.ndarray]
    ref: Callable[[np.ndarray], np.ndarray]   # (n, n_inputs) -> (n,) int32
    out_addr: int = 0             # RAM word index of the scalar output
    max_steps: int = 2_000_000
    feasible_note: str = ""

    @property
    def nvm_kb(self) -> float:
        return self.program.nvm_bytes / 1024.0

    def vm_kb(self, measured_stack_bytes: int = 64) -> float:
        """VM = inputs/globals (reserved) + measured peak stack."""
        return (self.program.vm_reserved + measured_stack_bytes) / 1024.0

    @property
    def total_mem_words(self) -> int:
        """RAM image size: declared VM + the ROM (constants) segment, which
        the ISS maps into the same address space."""
        need = self.program.ro_base // 4 + len(self.program.ro_words) + 16
        return max(self.mem_words, need)

    def initial_memory(self, inputs: np.ndarray) -> np.ndarray:
        mem = self.program.initial_memory(self.total_mem_words)
        mem = mem.copy()
        mem[:len(inputs)] = np.asarray(inputs, np.int32)
        return mem


_REGISTRY: Dict[str, Workload] = {}


def register(w: Workload) -> Workload:
    _REGISTRY[w.key] = w
    return w


def get(key: str) -> Workload:
    _ensure_loaded()
    return _REGISTRY[key]


def all_workloads() -> List[Workload]:
    _ensure_loaded()
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


def _ensure_loaded():
    if _REGISTRY:
        return
    from repro_torch.flexibench import workloads  # noqa: F401  (registers all)
