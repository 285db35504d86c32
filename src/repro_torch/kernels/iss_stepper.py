"""The fleet path's two CUDA kernels, their wrappers and plain versions.

- `iss_segment_banked` (csrc/iss_segment.cu) replaces the TPU kernel
  `repro/kernels/iss_stepper.py::iss_segment_banked`: up to `seg_steps`
  RV32E steps for every lane of a packed pool, each lane on its own bank
  program, timing tally on or off, and with a `faults.FaultSpec` the
  `faults` variant (the post-commit fault transform, csrc/flexifault.cuh,
  under per-lane keys and epochs). `iss_segment` is its one-program
  wrapper (the reference's `iss_segment`), not a second kernel.
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

Each wrapper counts its kernel launches (`.launches`; the segment
kernel's `faults` variant under `.fault_launches`) and its plain calls
(`.plain_calls`); `reset_counts()` zeroes them all.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import DeviceLike, resolve
from repro_torch.flexibits import iss
from repro_torch.flexibits.cycles import MIX_CLASSES, N_COST
from repro_torch.flexibits.iss import ISSState, PackedState
from repro_torch.kernels import _build

I32 = torch.int32
N_MIX = len(MIX_CLASSES)
# csrc/flexifault.cuh's fault modes and transient targets
_FAULT_MODES = {"transient": 1, "stuck": 2, "dead": 3}
_FAULT_TARGETS = {"regs": 0, "mem": 1, "pc": 2}

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


def _on_cpu(**tensors) -> None:
    for name, t in tensors.items():
        if t.device.type != "cpu":
            raise ValueError(f"{name} is on {t.device}, expected cpu")


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


def _fault_args(faults, lane_key, epoch, n_lanes: int, dev):
    """The faults variant's launch arguments after the segment's own:
    (mode, key, epoch, threshold, always, n_targets, target0..2)."""
    if faults is None:
        return (0, None, None, 0, 0, 0, 0, 0, 0)
    _check("lane_key", lane_key, dev, I32, (n_lanes,))
    _check("epoch", epoch, dev, I32, (n_lanes,))
    tg = [_FAULT_TARGETS[t] for t in faults.targets] + [0, 0]
    return (_FAULT_MODES[faults.mode], lane_key.data_ptr(),
            epoch.data_ptr(), faults.threshold, int(faults.always),
            len(faults.targets), *tg[:3])


def iss_segment_banked(bank: torch.Tensor, code_len: torch.Tensor,
                       state: PackedState, *, seg_steps: int,
                       subset=None, mem_len: Optional[torch.Tensor] = None,
                       cost: Optional[torch.Tensor] = None, faults=None,
                       lane_key: Optional[torch.Tensor] = None,
                       epoch: Optional[torch.Tensor] = None,
                       device: DeviceLike = None) -> PackedState:
    """Up to `seg_steps` steps for every lane, each on its own program.

    `bank` (P, W), `code_len`, `mem_len` (P,) and `cost` (P, 19; None
    turns the tick tally off) are per program; `state` holds L lanes of
    M memory words. `faults` (a `faults.FaultSpec`; None or an off
    schedule runs the fault-free build) applies the post-commit fault
    transform under per-LANE `lane_key` (int32 holding the uint32 key
    bits) and `epoch` (int32). `subset` is used by the plain version
    only: the kernel decodes the full RV32E set, which is exact whenever
    `subset` covers the bank's fetchable opcodes (the plain version needs
    that as well).
    """
    if seg_steps < 1:
        raise ValueError("seg_steps must be >= 1")
    dev = resolve(device)
    if faults is not None and faults.off:
        faults = None
    n_progs, bank_width = bank.shape
    if dev.type == "cpu":
        iss_segment_banked.plain_calls += 1
        return iss_segment_banked_plain(bank, code_len, state, seg_steps,
                                        subset, mem_len, cost, faults=faults,
                                        lane_key=lane_key, epoch=epoch)
    n_lanes, mem_words = _check_state(state, dev)
    if mem_len is None:
        mem_len = torch.full((n_progs,), mem_words, dtype=I32, device=dev)
    timing = cost is not None
    _check("bank", bank, dev, I32, (n_progs, bank_width))
    _check("code_len", code_len, dev, I32, (n_progs,))
    _check("mem_len", mem_len, dev, I32, (n_progs,))
    if timing:
        _check("cost", cost, dev, I32, (n_progs, N_COST))
    fargs = _fault_args(faults, lane_key, epoch, n_lanes, dev)
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
                ln.n_cycles.data_ptr(), n_lanes, seg_steps, *fargs, stream)
    _raise_on(rc, "iss_segment_banked launch")
    if faults is None:
        iss_segment_banked.launches += 1
    else:
        iss_segment_banked.fault_launches += 1
    return state


def iss_segment(code: torch.Tensor, state: ISSState, *, seg_steps: int,
                max_steps: int, subset=None,
                cost: Optional[torch.Tensor] = None, faults=None,
                lane_key: Optional[torch.Tensor] = None,
                epoch: Optional[torch.Tensor] = None,
                device: DeviceLike = None) -> ISSState:
    """Up to `seg_steps` steps for every lane of a one-program pool under
    a uniform `max_steps` budget (the reference's `iss_segment`): the
    1-row-bank case of `iss_segment_banked`, through the same kernel.
    `code` (W,) int32 words, `cost` one (19,) row or None; memory bounds
    are the pool width."""
    n_lanes = state.pc.shape[0]
    dev = state.pc.device
    packed = PackedState(
        lanes=state,
        prog_id=torch.zeros(n_lanes, dtype=I32, device=dev),
        max_steps=torch.full((n_lanes,), max_steps, dtype=I32, device=dev))
    out = iss_segment_banked(
        code[None, :].contiguous(),
        torch.tensor([code.shape[0]], dtype=I32, device=dev), packed,
        seg_steps=seg_steps, subset=subset,
        cost=None if cost is None else cost[None, :].contiguous(),
        faults=faults, lane_key=lane_key, epoch=epoch, device=device)
    return out.lanes


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
    iss_segment_banked.fault_launches = 0


reset_counts()
