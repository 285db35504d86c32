"""FlexiFault: deterministic fault injection for the lane steppers.

The port of the reference's `flexibits/faults.py` (DESIGN.md §9.14). A
fault schedule is a pure function of

    (spec.seed, lane, epoch, n_instr)

with no sampler state: per-lane base keys are JAX's `fold_in` of the
seed key by lane (`lane_keys`, built on `repro_torch/prng.py`, so the
port draws the reference's keys bit for bit), and every per-step draw is
a murmur3-finalizer hash (`mix32`) of the lane key, the lane's retry
`epoch` and its post-commit `n_instr`. The same integer arithmetic
exists three times: in torch here (the plain version, which
`flexibits/iss.py` applies), in the CUDA segment kernel's
`kernels/csrc/flexifault.cuh`, and in pure Python (`FaultOracle`, the
PyISS hook), so all of them flip the same bits.

Fault model (a post-commit transform applied after every live retired
instruction; the halting instruction is exempt):

- ``transient``: with probability `rate` per retired instruction, flip
  one bit of one enabled target: a register (x1..x15), a data-memory
  word (within the lane's own `mem_len`) or the pc (bits 2..11).
- ``stuck``: with probability `rate` per lane, one drawn register bit is
  forced to a drawn value after every live step (epoch-independent).
- ``dead``: with probability `rate` per lane, the whole register file
  reads zero after every live step (epoch-independent).

uint32 values are held in int32 tensors and go through
`repro_torch._u32` (logical shifts, wrapping products, unsigned
compares): torch's `>>` on int32 is arithmetic.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import _u32, prng

I32 = torch.int32

_TARGETS = ("regs", "mem", "pc")
_MASK32 = 0xFFFFFFFF

# derivation salts (arbitrary odd constants, shared with the oracle and
# with kernels/csrc/flexifault.cuh)
_T1 = 0x9E3779B9      # fire draw -> index draw
_T2 = 0x632BE59B      # index draw -> bit draw
_STUCK = 0x27220A95   # per-lane stuck-at decision
_DEAD = 0x85157AF5    # per-lane dead-lane decision


def _c(v: int) -> int:
    """A uint32 constant as the int32 that holds its bits."""
    v &= _MASK32
    return v - (1 << 32) if v >= (1 << 31) else v


def _bit(sh: torch.Tensor) -> torch.Tensor:
    """The int32 word with only bit `sh` (0..31) set, per element."""
    return _u32.wrap(torch.ones_like(sh, dtype=torch.int64) << sh.long())


def mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer over uint32 bit patterns held in int32 (the
    products wrap modulo 2**32); `mix32_py` is its pure-Python mirror."""
    x = x ^ _u32.srl(x, 16)
    x = _u32.wmul(x, 0x85EBCA6B)
    x = x ^ _u32.srl(x, 13)
    x = _u32.wmul(x, 0xC2B2AE35)
    return x ^ _u32.srl(x, 16)


def mix32_py(x: int) -> int:
    """Pure-Python mirror of `mix32` (masked 32-bit arithmetic)."""
    x &= _MASK32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & _MASK32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & _MASK32
    x ^= x >> 16
    return x


def width_scaled_rate(rate: float, width: int) -> float:
    """Per-retired-instruction transient rate for a `width`-bit serial
    core: a narrower datapath holds each instruction in flight for more
    cycles (cycles/instr ~ 32/width, cycles.py), so its exposure window
    per retirement is proportionally longer."""
    return min(1.0, rate * (32.0 / float(width)))


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Static description of a fault schedule (frozen and hashable).

    `rate` is per retired instruction for ``transient`` and per lane for
    ``stuck``/``dead``. `targets` picks the transient flip targets
    (canonical order; ignored by stuck/dead, which are register-file
    defects). `for_core` derives the width-scaled rate of a core from a
    technology base rate.
    """
    rate: float
    seed: int = 0
    targets: Tuple[str, ...] = ("regs",)
    mode: str = "transient"

    def __post_init__(self):
        if self.mode not in ("transient", "stuck", "dead"):
            raise ValueError(f"unknown fault mode {self.mode!r}")
        bad = set(self.targets) - set(_TARGETS)
        if bad or not self.targets:
            raise ValueError(f"targets must be a non-empty subset of "
                             f"{_TARGETS}, got {self.targets!r}")
        # canonical target order, so equal specs hash equal
        object.__setattr__(self, "targets",
                           tuple(t for t in _TARGETS if t in self.targets))
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")

    @property
    def threshold(self) -> int:
        """uint32 fire threshold: draw < threshold fires."""
        return min(_MASK32, int(round(self.rate * 4294967296.0)))

    @property
    def always(self) -> bool:
        """rate >= 1: fire unconditionally (no draw)."""
        return self.rate >= 1.0

    @property
    def off(self) -> bool:
        """A schedule that can never fire: the fault-free path runs."""
        return self.threshold == 0 and not self.always

    def for_core(self, core) -> "FaultSpec":
        """Width-scaled copy of this spec for `core` (cycles.Core)."""
        return dataclasses.replace(
            self, rate=width_scaled_rate(self.rate, core.width))


@functools.lru_cache(maxsize=64)
def lane_keys(seed: int, n_lanes: int) -> np.ndarray:
    """Per-lane uint32 base keys: JAX's `fold_in(PRNGKey(seed), lane)`,
    both key words xored down to 32 bits, with JAX's x64 flag off (as
    the reference's engine derives them). Read-only and cached."""
    w0, w1 = prng.fold_in(prng.prng_key(seed, x64=False),
                          torch.arange(n_lanes, dtype=torch.int64))
    out = (w0 ^ w1).numpy().astype(np.uint32)
    out.setflags(write=False)
    return out


def lane_keys_tensor(seed: int, n_lanes: int,
                     device="cpu") -> torch.Tensor:
    """`lane_keys` as the int32 tensor (the same bits) the steppers take."""
    return torch.from_numpy(lane_keys(seed, n_lanes).view(np.int32).copy()
                            ).to(device)


# ---------------------------------------------------------------------------
# The post-commit transform (torch, over a lane tile)
# ---------------------------------------------------------------------------


def apply_fault_arrays(spec: Optional[FaultSpec], lane_key, epoch,
                       regs, pc, mem, n_instr, gate, mem_len=None):
    """Post-commit fault transform over a lane tile: `regs` (L, 16),
    `mem` (L, M), `pc`/`n_instr`/`gate`/`lane_key`/`epoch` (L,), int32
    (`gate` bool). `gate` must already exclude lanes that are halted
    after the commit; `mem_len` (L,) bounds the memory-word draw at each
    lane's own word count (None: the full width M).

    Returns (regs, pc, mem), new tensors; with `spec=None` or an off
    schedule the inputs pass through untouched.
    """
    if spec is None or spec.off:
        return regs, pc, mem
    key = lane_key.to(I32)
    thr = torch.full_like(key, _c(spec.threshold))
    iota16 = torch.arange(16, dtype=I32, device=regs.device)

    if spec.mode == "dead":
        hit = _u32.ult(mix32(key ^ _c(_DEAD)), thr)
        dead = gate if spec.always else (gate & hit)
        return torch.where(dead[:, None], 0, regs), pc, mem

    if spec.mode == "stuck":
        sk = mix32(key ^ _c(_STUCK))
        hit = gate if spec.always else (gate & _u32.ult(sk, thr))
        s1 = mix32(sk ^ _c(_T1))
        reg = 1 + _u32.srl(s1, 8) % 15
        mask = _bit(s1 & 31)
        sel = (iota16 == reg[:, None]) & hit[:, None]
        stuck_one = (_u32.srl(s1, 5) & 1) == 1
        forced = torch.where(stuck_one[:, None], regs | mask[:, None],
                             regs & ~mask[:, None])
        return torch.where(sel, forced, regs), pc, mem

    # ---- transient: one draw per retired instruction
    k = mix32(key ^ mix32(epoch.to(I32)))
    h0 = mix32(k ^ n_instr)
    fire = gate if spec.always else (gate & _u32.ult(h0, thr))
    h1 = mix32(h0 ^ _c(_T1))
    h2 = mix32(h1 ^ _c(_T2))
    t = _u32.as_u32(h1) % len(spec.targets)
    bmask = _bit(h2 & 31)

    if "regs" in spec.targets:
        f = fire & (t == spec.targets.index("regs"))
        reg = 1 + _u32.srl(h1, 8) % 15
        sel = (iota16 == reg[:, None]) & f[:, None]
        regs = torch.where(sel, regs ^ bmask[:, None], regs)
    if "mem" in spec.targets:
        f = fire & (t == spec.targets.index("mem"))
        mwords = mem.shape[-1]
        ml = torch.full_like(key, mwords) if mem_len is None else mem_len
        word = _u32.srl(h1, 8) % ml
        iota_mem = torch.arange(mwords, dtype=I32, device=mem.device)
        wsel = (iota_mem == word[:, None]) & f[:, None]
        mem = torch.where(wsel, mem ^ bmask[:, None], mem)
    if "pc" in spec.targets:
        f = fire & (t == spec.targets.index("pc"))
        pmask = _bit(2 + _u32.as_u32(h2) % 10)
        pc = torch.where(f, pc ^ pmask, pc)
    return regs, pc, mem


def apply_faults(spec: Optional[FaultSpec], lane_key, epoch, state,
                 live=None, mem_len=None):
    """`ISSState`-level wrapper over `apply_fault_arrays`: `state` is the
    lane tile after its commit, `live` the pre-step active mask (None:
    all live). The gate excludes lanes halted by the commit."""
    if spec is None or spec.off:
        return state
    gate = ~state.halted if live is None else (live & ~state.halted)
    regs, pc, mem = apply_fault_arrays(
        spec, lane_key, epoch, state.regs, state.pc, state.mem,
        state.n_instr, gate, mem_len=mem_len)
    return state._replace(regs=regs, pc=pc, mem=mem)


def arch_digest(regs, pc, mem, halted, n_instr) -> torch.Tensor:
    """Per-lane 32-bit digest of the architectural state (int32 bits of
    the reference's uint32 digest): the DMR boundary compare. Position-
    mixed, so permuted corruption cannot cancel; the sums wrap."""
    dev = regs.device
    rpos = mix32(torch.arange(1, 17, dtype=I32, device=dev))
    mpos = mix32(torch.arange(17, 17 + mem.shape[-1], dtype=I32,
                              device=dev))
    d = _u32.as_u32(mix32(regs ^ rpos)).sum(-1)
    d = d + _u32.as_u32(mix32(mem ^ mpos)).sum(-1)
    d = d + _u32.as_u32(mix32(pc ^ _c(0x7FB5D329)))
    d = d + _u32.as_u32(mix32(n_instr ^ _c(0x2B7E1516)))
    return _u32.wrap(d + halted.to(torch.int64))


# ---------------------------------------------------------------------------
# PyISS fault oracle (pure Python, the same draws)
# ---------------------------------------------------------------------------


def _s32(v: int) -> int:
    v &= _MASK32
    return v - 0x100000000 if v >= 0x80000000 else v


class FaultOracle:
    """Post-commit hook for `pyiss.PyISS`: the fault oracle.

    Attach as ``p.post_commit = FaultOracle(spec, lane_key)``; PyISS
    calls it after every non-halting retired instruction, where the
    steppers apply `apply_fault_arrays`, with the same draws. `fired`
    counts transient fires (for stuck/dead, 1 per application while the
    lane defect is active).
    """

    def __init__(self, spec: FaultSpec, lane_key: int, epoch: int = 0):
        self.spec = spec
        self.lane_key = int(lane_key) & _MASK32
        self.epoch = int(epoch) & _MASK32
        self.fired = 0
        # per-lane (epoch-independent) defect decisions
        sk = mix32_py(self.lane_key ^ _STUCK)
        self._stuck = spec.mode == "stuck" and \
            (spec.always or sk < spec.threshold)
        s1 = mix32_py(sk ^ _T1)
        self._stuck_reg = 1 + ((s1 >> 8) % 15)
        self._stuck_mask = 1 << (s1 % 32)
        self._stuck_one = (s1 >> 5) & 1
        dk = mix32_py(self.lane_key ^ _DEAD)
        self._dead = spec.mode == "dead" and \
            (spec.always or dk < spec.threshold)

    def __call__(self, iss):
        spec = self.spec
        if spec.off:
            return
        if spec.mode == "dead":
            if self._dead:
                iss.regs = [0] * 16
                self.fired += 1
            return
        if spec.mode == "stuck":
            if self._stuck:
                r = self._stuck_reg
                w = iss.regs[r] & _MASK32
                w = (w | self._stuck_mask) if self._stuck_one \
                    else (w & ~self._stuck_mask)
                iss.regs[r] = _s32(w)
                self.fired += 1
            return
        # ---- transient
        k = mix32_py(self.lane_key ^ mix32_py(self.epoch))
        h0 = mix32_py(k ^ (iss.n_instr & _MASK32))
        if not spec.always and h0 >= spec.threshold:
            return
        self.fired += 1
        h1 = mix32_py(h0 ^ _T1)
        h2 = mix32_py(h1 ^ _T2)
        t = spec.targets[h1 % len(spec.targets)]
        bmask = 1 << (h2 % 32)
        if t == "regs":
            r = 1 + ((h1 >> 8) % 15)
            iss.regs[r] = _s32((iss.regs[r] & _MASK32) ^ bmask)
        elif t == "mem":
            w = (h1 >> 8) % len(iss.mem)
            iss.mem[w] = _s32((int(iss.mem[w]) & _MASK32) ^ bmask)
        else:  # pc: flip a word-aligned bit (2..11)
            iss.pc = _s32((iss.pc & _MASK32) ^ (1 << (2 + (h2 % 10))))


# ---------------------------------------------------------------------------
# Measurement: SDC / derating against the golden fault-free PyISS run
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultReport:
    """Per-workload resilience rates (AVF-style, DESIGN.md §9.14).

    Of `exposed` trials (at least one fault fired), each is `masked`
    (final memory and every FlexiLint-live register match the golden
    run), `derated` (halt status or retirement count differ: what a
    watchdog or budget check catches) or `sdc` (silent data corruption:
    the run completes on time but the visible state is wrong).
    """
    n_trials: int
    exposed: int
    masked: int
    derated: int
    sdc: int
    live_regs: Tuple[int, ...]

    @property
    def sdc_rate(self) -> float:
        return self.sdc / self.exposed if self.exposed else 0.0

    @property
    def derate_rate(self) -> float:
        return self.derated / self.exposed if self.exposed else 0.0

    @property
    def avf(self) -> float:
        """Architectural vulnerability: visible failures / exposures."""
        return (self.sdc + self.derated) / self.exposed \
            if self.exposed else 0.0


def measure_rates(code, mems, *, max_steps: int, spec: FaultSpec,
                  analysis=None) -> FaultReport:
    """Golden-vs-faulty differential over a batch of items: every item
    runs twice through PyISS, fault-free and under its lane's schedule
    (`lane_keys(spec.seed, n_items)[i]`, epoch 0), and each exposed trial
    is classified per `FaultReport`. Registers count only where
    FlexiLint finds them read (all 15 when its CFG degrades)."""
    from repro_torch.flexibits import analyze, pyiss

    code = np.asarray(code)
    mems = np.asarray(mems)
    n_items, mem_words = mems.shape
    if analysis is None:
        analysis = analyze.analyze_code(code, mem_words)
    if analysis.degraded:
        live = tuple(range(1, 16))
    else:
        live = tuple(sorted(analyze.read_registers(analysis)))
    keys = lane_keys(spec.seed, n_items)

    exposed = masked = derated = sdc = 0
    for i in range(n_items):
        golden = pyiss.PyISS(code, mem_words, init_mem=mems[i])
        golden.run(max_steps)
        faulty = pyiss.PyISS(code, mem_words, init_mem=mems[i])
        oracle = FaultOracle(spec, int(keys[i]))
        faulty.post_commit = oracle
        faulty.run(max_steps)
        if oracle.fired == 0:
            continue
        exposed += 1
        if golden.halted != faulty.halted \
                or golden.n_instr != faulty.n_instr:
            derated += 1
        elif np.array_equal(golden.mem, faulty.mem) and all(
                golden.regs[r] == faulty.regs[r] for r in live):
            masked += 1
        else:
            sdc += 1
    return FaultReport(n_trials=n_items, exposed=exposed, masked=masked,
                       derated=derated, sdc=sdc, live_regs=live)
