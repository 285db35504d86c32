"""The fleet path's two CUDA kernels, their wrappers and plain versions.

- `iss_segment_banked` (csrc/iss_segment.cu) replaces the TPU kernel
  `repro/kernels/iss_stepper.py::iss_segment_banked`: up to `seg_steps`
  RV32E steps for every lane of a packed pool, each lane on its own bank
  program, fault-free, timing tally on or off.
- `iss_refill` (csrc/iss_refill.cu) replaces the TPU kernel
  `repro/kernels/iss_stepper.py::iss_refill`: swap staged items into the
  lanes that take one.

Each wrapper takes `device=None` (meaning "cuda") and checks its tensors
against it. On a CUDA device it launches the kernel on the current
stream or raises; the state is updated in place (the counterpart of the
TPU kernels' `input_output_aliases`) and returned. Only when the caller
asks for `device="cpu"`, with CPU tensors, does it run the plain version
(`iss_segment_banked_plain`, `iss_refill_plain`: the port's
`flexibits/iss.py`), which returns new tensors. No wrapper falls back to
the plain version when a build or a launch fails.

Each wrapper counts its kernel launches (`.launches`) and its plain
calls (`.plain_calls`); `reset_counts()` zeroes both.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import DeviceLike, resolve
from repro_torch.flexibits import iss
from repro_torch.flexibits.cycles import MIX_CLASSES, N_COST
from repro_torch.flexibits.iss import PackedState
from repro_torch.kernels import _build

I32 = torch.int32
N_MIX = len(MIX_CLASSES)

iss_segment_banked_plain = iss.run_segment_lanes_banked
iss_refill_plain = iss.refill_lanes


def _check(name: str, t: torch.Tensor, dev: torch.device, dtype,
           shape) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_state(ps: PackedState, dev: torch.device) -> "tuple[int, int]":
    n_lanes, mem_words = ps.lanes.mem.shape
    ln = ps.lanes
    for name, t, dtype, shape in (
            ("regs", ln.regs, I32, (n_lanes, 16)),
            ("pc", ln.pc, I32, (n_lanes,)),
            ("mem", ln.mem, I32, (n_lanes, mem_words)),
            ("halted", ln.halted, torch.bool, (n_lanes,)),
            ("n_instr", ln.n_instr, I32, (n_lanes,)),
            ("n_two_stage", ln.n_two_stage, I32, (n_lanes,)),
            ("mix", ln.mix, I32, (n_lanes, N_MIX)),
            ("n_cycles", ln.n_cycles, I32, (n_lanes,)),
            ("prog_id", ps.prog_id, I32, (n_lanes,)),
            ("max_steps", ps.max_steps, I32, (n_lanes,))):
        _check(name, t, dev, dtype, shape)
    return n_lanes, mem_words


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({torch.cuda.get_device_name()})")


def iss_segment_banked(bank: torch.Tensor, code_len: torch.Tensor,
                       state: PackedState, *, seg_steps: int,
                       subset=None, mem_len: Optional[torch.Tensor] = None,
                       cost: Optional[torch.Tensor] = None,
                       device: DeviceLike = None) -> PackedState:
    """Up to `seg_steps` steps for every lane, each on its own program.

    `bank` (P, W), `code_len`, `mem_len` (P,) and `cost` (P, 19; None
    turns the tick tally off) are per program; `state` holds L lanes of
    M memory words. `subset` is used by the plain version only: the
    kernel decodes the full RV32E set, which is exact whenever `subset`
    covers the bank's fetchable opcodes (the plain version needs that as
    well).
    """
    if seg_steps < 1:
        raise ValueError("seg_steps must be >= 1")
    dev = resolve(device)
    n_progs, bank_width = bank.shape
    if dev.type == "cpu":
        iss_segment_banked.plain_calls += 1
        return iss_segment_banked_plain(bank, code_len, state, seg_steps,
                                        subset, mem_len, cost)
    n_lanes, mem_words = _check_state(state, dev)
    if mem_len is None:
        mem_len = torch.full((n_progs,), mem_words, dtype=I32, device=dev)
    timing = cost is not None
    _check("bank", bank, dev, I32, (n_progs, bank_width))
    _check("code_len", code_len, dev, I32, (n_progs,))
    _check("mem_len", mem_len, dev, I32, (n_progs,))
    if timing:
        _check("cost", cost, dev, I32, (n_progs, N_COST))
    ln = state.lanes
    fn = getattr(_build.load("iss_segment"), "iss_segment_banked_launch")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(bank.data_ptr(), n_progs, bank_width, code_len.data_ptr(),
                mem_len.data_ptr(), cost.data_ptr() if timing else None,
                int(timing),
                state.prog_id.data_ptr(), state.max_steps.data_ptr(),
                ln.regs.data_ptr(), ln.pc.data_ptr(), ln.mem.data_ptr(),
                mem_words, ln.halted.data_ptr(), ln.n_instr.data_ptr(),
                ln.n_two_stage.data_ptr(), ln.mix.data_ptr(),
                ln.n_cycles.data_ptr(), n_lanes, seg_steps, stream)
    _raise_on(rc, "iss_segment_banked launch")
    iss_segment_banked.launches += 1
    return state


def iss_refill(state: PackedState, take: torch.Tensor, src: torch.Tensor,
               staged_mems: torch.Tensor, staged_prog: torch.Tensor,
               staged_ms: torch.Tensor, *,
               device: DeviceLike = None) -> PackedState:
    """Swap staged rows `src` into the lanes with `take` (see
    `iss.refill_lanes` for the semantics; `take`/`src` come from
    `iss.refill_take`)."""
    dev = resolve(device)
    if dev.type == "cpu":
        iss_refill.plain_calls += 1
        return iss_refill_plain(state, take, src, staged_mems, staged_prog,
                                staged_ms)
    n_lanes, mem_words = _check_state(state, dev)
    n_rows = staged_mems.shape[0]
    _check("take", take, dev, torch.bool, (n_lanes,))
    _check("src", src, dev, I32, (n_lanes,))
    _check("staged_mems", staged_mems, dev, I32, (n_rows, mem_words))
    _check("staged_prog", staged_prog, dev, I32, (n_rows,))
    _check("staged_ms", staged_ms, dev, I32, (n_rows,))
    ln = state.lanes
    fn = getattr(_build.load("iss_refill"), "iss_refill_launch")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(take.data_ptr(), src.data_ptr(), staged_mems.data_ptr(),
                staged_prog.data_ptr(), staged_ms.data_ptr(), n_rows,
                ln.regs.data_ptr(), ln.pc.data_ptr(), ln.mem.data_ptr(),
                mem_words, ln.halted.data_ptr(), ln.n_instr.data_ptr(),
                ln.n_two_stage.data_ptr(), ln.mix.data_ptr(),
                ln.n_cycles.data_ptr(), state.prog_id.data_ptr(),
                state.max_steps.data_ptr(), n_lanes, stream)
    _raise_on(rc, "iss_refill launch")
    iss_refill.launches += 1
    return state


def reset_counts() -> None:
    """Zero both wrappers' launch and plain-call counts."""
    for fn in (iss_segment_banked, iss_refill):
        fn.launches = 0
        fn.plain_calls = 0


reset_counts()
