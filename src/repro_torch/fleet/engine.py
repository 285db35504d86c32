"""Packed, device-resident fleet runtime on one card.

The port of the reference's `fleet/engine.py` resident path
(`run_packed(refill="device")` and its `_stream_resident` loop) at one
shard. Every group of a heterogeneous plan runs through ONE pool of
`chunk` lanes: programs sit in a padded bank, each lane carries its bank
row and step budget, and freed lanes are refilled from any pending group
(`_apportion`), so one group's tail hides behind the others' backlog.

The lane pool and the per-item result accumulators (`ResidentAcc`) live
on the device for the whole run. Per iteration, in stream order:

    refill_i  retire finished lanes into their items' accumulator rows
              and swap staged items into free lanes (plain torch ops
              around the `iss_refill` kernel), producing a small stats
              vector, which is copied at once into pinned host memory
    seg_i     the `iss_segment_banked` kernel, at the controller's bound
    (host)    wait for refill_i's stats copy only (seg_i is running),
              then restock the staged batch for refill_{i+1} from the
              per-group prefetchers, overlapped with seg_i

The staged batch is uploaded from pinned memory with `non_blocking=True`
before the next refill. Per-item results are read once, at the end.

FlexiFault (DESIGN.md §9.14): with `faults` every lane runs the segment
kernel's `faults` variant under its own key (`faults.lane_keys`) and an
epoch it bumps when it takes a fresh item. `redundancy="dmr"` pairs
lanes (2p, 2p+1) on one item image, compares their architectural
digests at every refill boundary, rolls a mismatching pair back to the
boundary snapshot (kept in preallocated lane buffers, since the kernel
updates the pool in place) and quarantines a pair after `max_retries`
consecutive mismatches, requeueing its item ahead of fresh admissions.

Not ported yet, and raising `NotImplementedError` (see ROADMAP.md,
queue 1): the host-refill loop (`refill="host"`, and the reference's
fallback to it past the resident safety bounds), `mesh=` and
`checkpoint_dir=`.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import threading
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve
from repro_torch.flexibench.base import Workload
from repro_torch.flexibits import faults as flexifault
from repro_torch.flexibits import iss
from repro_torch.flexibits.cycles import MIX_CLASSES, N_COST
from repro_torch.kernels import iss_stepper

REFILLS = ("device", "host")   # "host" is the reference's A/B loop
REDUNDANCY = ("none", "dmr")
I32 = torch.int32
N_MIX = len(MIX_CLASSES)

# resident-runtime safety bounds: the per-group mix counters are int32,
# and keep_state scatters full final state into O(fleet) device rows
_RESIDENT_MIX_LIMIT = 2**31 - 1
_RESIDENT_KEEP_STATE_WORDS = 1 << 27   # ~512 MB of int32 device rows

# source protocol: source(start, count) -> (count, mem_words) int32
Source = Callable[[int, int], np.ndarray]


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md, queue 1, "
        f"{item})")


def array_source(mems: np.ndarray) -> Source:
    """Stream an in-memory (n_items, M) array (parity tests, small fleets)."""
    mems = np.asarray(mems, np.int32)

    def src(start: int, count: int) -> np.ndarray:
        return mems[start:start + count]

    return src


def workload_source(w: Workload, seed: int = 0,
                    gen_block: int = 256) -> Source:
    """O(chunk) on-demand input generation for one workload.

    Item i's inputs are row `i % gen_block` of
    `w.gen_inputs(default_rng([seed, i // gen_block]), gen_block)`, so an
    item is a pure function of (seed, index) however the engine slices
    the stream, and bit-identical to the reference's item i. The last
    generated block is cached, since items are consumed in order.
    """
    base = w.initial_memory(np.zeros(w.n_inputs, np.int32))
    gen_block = max(1, gen_block)
    cache = {"blk": -1, "xs": None}

    def block(blk: int) -> np.ndarray:
        if cache["blk"] != blk:
            rng = np.random.default_rng([seed, blk])
            cache["xs"] = np.asarray(w.gen_inputs(rng, gen_block), np.int32)
            cache["blk"] = blk
        return cache["xs"]

    def src(start: int, count: int) -> np.ndarray:
        if count <= 0:
            return np.zeros((0, base.size), np.int32)
        parts = []
        i = start
        while i < start + count:
            blk, off = divmod(i, gen_block)
            k = min(gen_block - off, start + count - i)
            parts.append(block(blk)[off:off + k])
            i += k
        xs = parts[0] if len(parts) == 1 else np.concatenate(parts)
        mems = np.tile(base, (count, 1))
        mems[:, :xs.shape[1]] = xs
        return mems

    return src


class _Prefetcher:
    """Double-buffered async host refill: a one-worker executor keeps
    one `block`-sized fetch in flight, so generating the next items
    overlaps the device's segment. Items are taken strictly in stream
    order. `background=False` fetches synchronously. A source error is
    latched and re-raised, with the stream's cursor, on every later
    `take()`."""

    def __init__(self, source: Source, n_items: int, block: int,
                 background: bool = True):
        self._source = source
        self._n = n_items
        self._block = max(1, block)
        self._cursor = 0          # next un-requested item
        self._taken = 0           # items handed to the engine so far
        self._buf: Optional[np.ndarray] = None
        self._off = 0
        self._fut = None
        self._fut_span = (0, 0)   # [start, start+count) of the fetch
        self._err: Optional[BaseException] = None
        self._closed = False
        self._ex = concurrent.futures.ThreadPoolExecutor(max_workers=1) \
            if background else None
        if self._ex is not None:
            self._submit()

    def _submit(self):
        count = min(self._block, self._n - self._cursor)
        if count > 0:
            start = self._cursor
            self._cursor += count
            self._fut_span = (start, count)
            self._fut = self._ex.submit(self._source, start, count)
        else:
            self._fut = None

    def _fetch_failed(self, exc: BaseException, start: int,
                      count: int) -> RuntimeError:
        self._err = exc
        self._fut = None
        return RuntimeError(
            f"prefetch source {self._source!r} raised while fetching "
            f"items [{start}:{start + count}) of {self._n} (stream "
            f"cursor {self._taken}): {exc!r}")

    def take(self, count: int) -> np.ndarray:
        """Next `count` item memories, in stream order."""
        if self._closed:
            raise RuntimeError("prefetcher is closed: take() after "
                               "close() at stream cursor "
                               f"{self._taken}, n_items={self._n}")
        if self._err is not None:
            raise RuntimeError(
                f"prefetch source {self._source!r} already failed "
                f"(stream cursor {self._taken}, n_items={self._n}); "
                f"the stream cannot continue") from self._err
        if self._taken + count > self._n:
            raise RuntimeError(
                f"source stream exhausted: requested {count} item(s) at "
                f"stream cursor {self._taken}, but the source holds only "
                f"{self._n} item(s) "
                f"({self._n - self._taken} item(s) remaining)")
        self._taken += count
        if self._ex is None:
            start = self._cursor
            self._cursor += count
            try:
                return np.asarray(self._source(start, count), np.int32)
            except Exception as e:
                raise self._fetch_failed(e, start, count) from e
        parts = []
        while count > 0:
            if self._buf is None or self._off >= len(self._buf):
                if self._fut is None:
                    raise RuntimeError(
                        f"source stream exhausted: no fetch in flight at "
                        f"stream cursor {self._taken}, request cursor "
                        f"{self._cursor}, n_items={self._n}")
                try:
                    self._buf = np.asarray(self._fut.result(), np.int32)
                except Exception as e:
                    raise self._fetch_failed(e, *self._fut_span) from e
                self._off = 0
                self._submit()          # refill the second buffer now
            k = min(count, len(self._buf) - self._off)
            parts.append(self._buf[self._off:self._off + k])
            self._off += k
            count -= k
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def close(self):
        """Cancel or drain the in-flight fetch and join the worker, so
        the source is never called after close(). Idempotent."""
        if self._closed:
            return
        self._closed = True
        if self._ex is not None:
            self._ex.shutdown(wait=True, cancel_futures=True)
            self._fut = None


@dataclasses.dataclass
class FleetResult:
    """Per-item scalars plus engine-level accounting for one group."""
    n_items: int
    n_instr: np.ndarray          # (n,) retired instructions per item
    n_two_stage: np.ndarray      # (n,)
    halted: np.ndarray           # (n,) bool (False = max_steps exhausted)
    out: np.ndarray              # (n,) word at out_addr (0 if no out_addr)
    mix: np.ndarray              # (8,) retired-instruction mix, group total
    lane_steps: int              # lane-step slots of the group's lanes
    n_segments: int
    chunk: int
    seg_steps: int
    wall_s: float
    stepper: str = "cuda"        # "cuda" (the kernel) or "plain" (CPU)
    n_devices: int = 1
    # full final state, only with keep_state=True (O(fleet) host memory)
    mems: Optional[np.ndarray] = None    # (n, M)
    regs: Optional[np.ndarray] = None    # (n, 16)
    pc: Optional[np.ndarray] = None      # (n,)
    mix_items: Optional[np.ndarray] = None  # (n, 8)
    # per-item timing ticks; None for a group without a cost row
    n_cycles: Optional[np.ndarray] = None   # (n,)

    @property
    def busy_steps(self) -> int:
        """Lane-steps that retired a real instruction (useful work)."""
        return int(self.n_instr.sum())

    @property
    def monolithic_lane_steps(self) -> int:
        """Cost of running every lane until the slowest item halts."""
        if self.n_items == 0:
            return 0
        return int(self.n_items) * int(self.n_instr.max())

    @property
    def items_per_s(self) -> float:
        return self.n_items / self.wall_s if self.wall_s > 0 else float("inf")


@dataclasses.dataclass(frozen=True)
class PackedGroup:
    """One group's inputs to the packed runtime."""
    code: np.ndarray                  # program words (uint32 or int32)
    source: Source
    n_items: int
    max_steps: int
    mem_words: int
    out_addr: Optional[int] = None
    # optional (N_COST,) int32 cycle-cost row (cycles.cost_row)
    cost: Optional[np.ndarray] = None
    # optional opcode subset (e.g. FlexiLint's reachable-only subset);
    # the plain path uses the union over groups, the kernel decodes all
    subset: Optional[frozenset] = None


@dataclasses.dataclass
class PackedStats:
    """Whole-run accounting of one packed stream.

    `host_syncs` counts every blocking device->host read, `sync_wait_s`
    the host time spent in them, `refill_wall_s` the host time spent
    restocking the staged batch, `device_busy_frac` estimates the share
    of the wall clock in which the device had work queued (1 minus the
    restock intervals during which the segment had already finished),
    and `seg_schedule` the step bound of each segment. `stepper` says
    what ran the segments: "cuda" (the kernel) or "plain" (the plain
    version on the CPU); `device` names the device. The resilience
    counters (DMR runs): `detected` digest mismatches, `corrected` pair
    rollbacks that re-executed a segment, `quarantined` pairs retired
    from the pool."""
    n_groups: int
    n_progs: int
    bank_width: int
    lane_steps: int               # chunk x max-step-delta, summed
    n_segments: int
    chunk: int
    seg_steps: int
    wall_s: float
    stepper: str
    n_devices: int
    refill: str = "device"
    adaptive: bool = False
    host_syncs: int = 0
    sync_wait_s: float = 0.0
    refill_wall_s: float = 0.0
    device_busy_frac: float = 1.0
    seg_schedule: tuple = ()
    device: str = ""
    redundancy: str = "none"
    detected: int = 0
    corrected: int = 0
    quarantined: int = 0


class _SyncClock:
    """Counts and times every blocking device->host read, plus the host
    restock work, and accumulates device-idle intervals."""

    def __init__(self):
        self.host_syncs = 0
        self.sync_wait_s = 0.0
        self.refill_wall_s = 0.0
        self.idle_s = 0.0

    def fetch(self, x: torch.Tensor) -> np.ndarray:
        t0 = time.perf_counter()
        out = x.cpu().numpy()
        self.sync_wait_s += time.perf_counter() - t0
        self.host_syncs += 1
        return out

    def wait(self, event: Optional["torch.cuda.Event"]) -> None:
        t0 = time.perf_counter()
        if event is not None:
            event.synchronize()
        self.sync_wait_s += time.perf_counter() - t0
        self.host_syncs += 1

    def busy_frac(self, wall_s: float) -> float:
        if wall_s <= 0.0:
            return 1.0
        return max(0.0, 1.0 - self.idle_s / wall_s)


class _SuperstepController:
    """Adaptive superstep sizing: an EMA of the pool's finish hazard
    (retirements per pool-step) picks the next segment length from a
    power-of-two ladder under `seg_steps` (at most 5 rungs below it).
    High churn shortens segments so freed lanes refill sooner; a quiet
    pool grows them back. Decisions are a pure function of the observed
    (retired, steps) sequence, so a plan reruns to the same schedule."""

    LADDER_SPAN = 16       # smallest rung = seg_steps / 16
    TARGET_FRAC = 0.25     # aim for ~chunk/4 retirements per segment
    EMA = 0.5

    def __init__(self, seg_steps: int, chunk: int, enabled: bool):
        base = max(1, seg_steps)
        rungs = {base}
        v = base
        while v > max(1, base // self.LADDER_SPAN):
            v = max(1, v // 2)
            rungs.add(v)
        self.ladder = tuple(sorted(rungs))
        self.base = base
        self.enabled = enabled
        self.target = max(1.0, self.TARGET_FRAC * chunk)
        self.rate = 0.0            # EMA of retirements per pool-step
        self.schedule = []

    def record(self, n_retired: int, steps: int):
        if steps > 0:
            self.rate = (self.EMA * (n_retired / steps)
                         + (1.0 - self.EMA) * self.rate)

    def next_seg(self) -> int:
        seg = self.base
        if self.enabled:
            for s in self.ladder:  # smallest rung meeting the target
                if self.rate * s >= self.target:
                    seg = s
                    break
        self.schedule.append(seg)
        return seg


def _apportion(slots: int, remaining) -> np.ndarray:
    """Admission policy: split `slots` free lanes over groups in
    proportion to their remaining backlogs (largest remainder, ties to
    the lower group index). Per-item results do not depend on it."""
    remaining = np.asarray(remaining, np.int64)
    total = int(remaining.sum())
    slots = min(int(slots), total)
    take = np.zeros(len(remaining), np.int64)
    if slots <= 0:
        return take
    quota = slots * remaining / total
    take = np.minimum(np.floor(quota).astype(np.int64), remaining)
    left = slots - int(take.sum())
    if left > 0:
        frac = np.where(remaining > take, quota - take, -1.0)
        for g in np.argsort(-frac, kind="stable")[:left]:
            take[g] += 1
    return take


class ResidentAcc(NamedTuple):
    """On-device result accumulators of the resident loop.

    Per-item leaves hold `n_items + 1` rows: row i is item i's (items in
    group order, group g's first row at the sum of earlier groups'
    sizes), and the last row takes the retire scatters of lanes that did
    not retire, so the scatter needs no data-dependent shape. `mix_g`
    sums the retired mix per group (int32: see the safety bounds),
    `prev_instr` is each lane's retired count at the last refill. The
    keep_state leaves are None unless full final state was asked for.
    """
    n_instr: torch.Tensor               # (n+1,) int32
    n_two: torch.Tensor                 # (n+1,) int32
    n_cycles: torch.Tensor              # (n+1,) int32 timing ticks
    halted: torch.Tensor                # (n+1,) bool
    out: torch.Tensor                   # (n+1,) int32
    mix_g: torch.Tensor                 # (n_groups, 8) int32
    prev_instr: torch.Tensor            # (chunk,) int32
    mems: Optional[torch.Tensor]        # (n+1, M) int32
    regs: Optional[torch.Tensor]        # (n+1, 16) int32
    pc: Optional[torch.Tensor]          # (n+1,) int32
    mix_items: Optional[torch.Tensor]   # (n+1, 8) int32


def _fresh_acc(n_items: int, chunk: int, n_groups: int, mem_words: int,
               keep_state: bool, dev: torch.device) -> ResidentAcc:
    def z(*shape, dtype=I32):
        return torch.zeros(shape, dtype=dtype, device=dev)
    rows = n_items + 1
    return ResidentAcc(
        n_instr=z(rows), n_two=z(rows), n_cycles=z(rows),
        halted=z(rows, dtype=torch.bool), out=z(rows),
        mix_g=z(n_groups, N_MIX), prev_instr=z(chunk),
        mems=z(rows, mem_words) if keep_state else None,
        regs=z(rows, 16) if keep_state else None,
        pc=z(rows) if keep_state else None,
        mix_items=z(rows, N_MIX) if keep_state else None)


def _scatter_retired(state: iss.PackedState, item_slot: torch.Tensor,
                     acc: ResidentAcc, out_addr: torch.Tensor,
                     retired: torch.Tensor) -> ResidentAcc:
    """Write retiring lanes' tallies into their items' rows, in place;
    every other lane writes the discard row."""
    lanes = state.lanes
    discard = acc.n_instr.shape[0] - 1
    slot = torch.where(retired, item_slot, discard).long()
    pid = state.prog_id.long()

    def put(buf, val):
        return None if buf is None else buf.index_copy_(0, slot, val)

    col = out_addr[pid]
    out_val = lanes.mem.gather(
        1, torch.clamp(col, 0, lanes.mem.shape[1] - 1).long()[:, None])[:, 0]
    out_val = torch.where(col >= 0, out_val, 0)
    return acc._replace(
        n_instr=put(acc.n_instr, lanes.n_instr),
        n_two=put(acc.n_two, lanes.n_two_stage),
        n_cycles=put(acc.n_cycles, lanes.n_cycles),
        halted=put(acc.halted, lanes.halted),
        out=put(acc.out, out_val),
        mix_g=acc.mix_g.index_add_(
            0, pid, torch.where(retired[:, None], lanes.mix, 0)),
        mems=put(acc.mems, lanes.mem),
        regs=put(acc.regs, lanes.regs),
        pc=put(acc.pc, lanes.pc),
        mix_items=put(acc.mix_items, lanes.mix))


def retire_refill(state: iss.PackedState, item_slot: torch.Tensor,
                  acc: ResidentAcc, staged_mems: torch.Tensor,
                  staged_prog: torch.Tensor, staged_ms: torch.Tensor,
                  staged_slot: torch.Tensor, n_staged: torch.Tensor,
                  out_addr: torch.Tensor, n_groups: int,
                  device: DeviceLike = None):
    """The resident loop's retire/refill op (the reference's
    `_resident_refill_runner` body at one shard).

    Finished lanes (`iss.retire_mask`) scatter their tallies into their
    items' accumulator rows; free lanes take staged rows in lane-rank
    order (`iss.refill_take`, then the `iss_refill` kernel). Returns
    (state, item_slot, acc, stats) with stats an int32 vector
    [retired, taken, max step delta, active lanes per group...]
    describing the segment that just ran. On the card the lane pool and
    `acc` are updated in place. Everything that reads the old lanes is
    queued before the swap.
    """
    dev = resolve(device)
    lanes = state.lanes
    active = item_slot >= 0
    retired = iss.retire_mask(state, item_slot)
    delta = torch.clamp((lanes.n_instr - acc.prev_instr).max(), min=0)
    act_g = torch.zeros(n_groups, dtype=I32, device=dev).index_add_(
        0, state.prog_id.long(), active.to(I32))
    acc = _scatter_retired(state, item_slot, acc, out_addr, retired)

    free = retired | ~active
    take, src = iss.refill_take(free, n_staged)
    srow = torch.clamp(src, 0, staged_slot.shape[0] - 1).long()
    new_slot = torch.where(take, staged_slot[srow],
                           torch.where(retired, -1, item_slot))
    prev = torch.where(take, 0, lanes.n_instr)
    stats = torch.cat([torch.stack([retired.sum(dtype=I32),
                                    take.sum(dtype=I32), delta.to(I32)]),
                       act_g])
    state = iss_stepper.iss_refill(state, take, src, staged_mems,
                                   staged_prog, staged_ms, device=dev)
    return state, new_slot, acc._replace(prev_instr=prev), stats


def retire_refill_dmr(state: iss.PackedState, item_slot: torch.Tensor,
                      epoch: torch.Tensor, retries: torch.Tensor,
                      quar: torch.Tensor, snap: iss.ISSState,
                      acc: ResidentAcc, staged_mems: torch.Tensor,
                      staged_prog: torch.Tensor, staged_ms: torch.Tensor,
                      staged_slot: torch.Tensor, n_staged: torch.Tensor,
                      out_addr: torch.Tensor, n_groups: int,
                      max_retries: int, device: DeviceLike = None):
    """The DMR retire/refill op (the reference's `refill_dmr` at one
    shard).

    Lanes pair up as (2p primary, 2p+1 shadow) on the same item image;
    only the primary carries the item's accumulator row (the shadow's
    `item_slot` is -1). At the boundary the pair's `arch_digest`s are
    compared: a mismatching pair rolls back to `snap`, its state at the
    previous boundary, with a bumped epoch (fresh transient draws; a
    stuck or dead defect recurs), or, after `max_retries` consecutive
    mismatches, is quarantined: parked for good, its item row reported in
    the stats for the host to requeue (at most one pair per boundary).
    Matching finished pairs retire and refill as in `retire_refill`, at
    pair granularity, through the `iss_refill` kernel with `take`/`src`
    repeated per pair. A clean boundary resets a pair's mismatch count.

    Returns (state, item_slot, epoch, retries, quar, acc, stats) with
    stats the int32 vector [retired, taken, max step delta, mismatches,
    rollbacks, quarantined item row or -1, active lanes per group...].
    The pool is rolled back and refilled in place on the card; the caller
    copies the returned lanes into `snap` before the next segment.
    """
    dev = resolve(device)
    lanes = state.lanes
    active = item_slot >= 0                  # primaries only
    d2 = flexifault.arch_digest(lanes.regs, lanes.pc, lanes.mem,
                                lanes.halted, lanes.n_instr).view(-1, 2)
    pair_active = active.view(-1, 2)[:, 0]
    mismatch = pair_active & (d2[:, 0] != d2[:, 1])
    done_l = lanes.halted | (lanes.n_instr >= state.max_steps)
    pair_retire = pair_active & done_l.view(-1, 2)[:, 0] & ~mismatch
    wants_q = mismatch & (retries >= max_retries)
    new_q = wants_q & (torch.cumsum(wants_q.to(I32), 0, dtype=I32) == 1)
    rollback = mismatch & ~new_q
    q_slot = torch.where(new_q, item_slot.view(-1, 2)[:, 0], -1).max()

    # ---- accounting of the segment that just ran
    delta = torch.clamp((lanes.n_instr - acc.prev_instr).max(), min=0)
    act_g = torch.zeros(n_groups, dtype=I32, device=dev).index_add_(
        0, state.prog_id.long(), active.to(I32))

    # ---- retire matching finished pairs (primary rows scatter)
    retired = iss.retire_mask(state, item_slot) \
        & pair_retire.repeat_interleave(2)
    acc = _scatter_retired(state, item_slot, acc, out_addr, retired)

    # ---- roll mismatching pairs back to the last boundary, park the
    # quarantined pair (in place: everything above read the old lanes)
    rb_l = rollback.repeat_interleave(2)
    q_l = new_q.repeat_interleave(2)
    for x, y in zip(lanes, snap):
        torch.where(rb_l.view((-1,) + (1,) * (x.dim() - 1)), y, x, out=x)
    lanes.halted.masked_fill_(q_l, True)

    # ---- refill freed pairs: both lanes get the item image
    free_p = (pair_retire | ~pair_active) & ~(quar | new_q)
    take_p, src_p = iss.refill_take(free_p, n_staged)
    take_l = take_p.repeat_interleave(2)
    src_l = src_p.repeat_interleave(2)
    is_primary = (torch.arange(item_slot.shape[0], device=dev) % 2) == 0
    srow = torch.clamp(src_l, 0, staged_slot.shape[0] - 1).long()
    new_slot = torch.where(take_l & is_primary, staged_slot[srow],
                           torch.where(retired | q_l, -1, item_slot))
    new_epoch = torch.where(take_l | rb_l, epoch + 1, epoch)
    # consecutive-mismatch count: any clean boundary resets it
    new_retries = torch.where(rollback, retries + 1,
                              torch.where(new_q, retries, 0))
    stats = torch.cat([torch.stack([
        pair_retire.sum(dtype=I32), take_p.sum(dtype=I32), delta.to(I32),
        mismatch.sum(dtype=I32), rollback.sum(dtype=I32), q_slot.to(I32)]),
        act_g])
    state = iss_stepper.iss_refill(state, take_l, src_l, staged_mems,
                                   staged_prog, staged_ms, device=dev)
    acc = acc._replace(prev_instr=state.lanes.n_instr.clone())
    return state, new_slot, new_epoch, new_retries, quar | new_q, acc, stats


def _locked(source: Source) -> Source:
    """`source` behind a lock: a DMR requeue reads an item on the main
    thread while the group's prefetcher may be reading the same source
    (`workload_source`'s block cache is not thread-safe) on its worker."""
    lock = threading.Lock()

    def src(start: int, count: int) -> np.ndarray:
        with lock:
            return source(start, count)

    return src


def run_packed(groups, *, chunk: int = 256, seg_steps: int = 4096,
               keep_state: bool = False, mesh=None,
               subset: Optional[frozenset] = None,
               prefetch: bool = True, refill: str = "device",
               adaptive: bool = False, checkpoint_dir: Optional[str] = None,
               faults=None, redundancy: str = "none", max_retries: int = 2,
               device: DeviceLike = None):
    """Execute every `PackedGroup` through ONE packed, resident stream.

    Returns `(results, stats)`: `results[g]` is group g's `FleetResult`,
    bit-exact with the reference's `run_packed(refill="device")` (per-item
    tallies, final state with `keep_state`, and, at equal `chunk`,
    `seg_steps` and `adaptive`, the schedule statistics), and `stats`
    the whole-run `PackedStats`. The segments run on the
    `iss_segment_banked` kernel on the card (`device=None` means
    "cuda"), or on its plain version when `device="cpu"`.

    `adaptive` turns on the superstep controller. `subset` pins the
    opcode subset the plain version is specialised to (default: the
    union of the groups' text subsets). `faults` (a `faults.FaultSpec`;
    rate 0 is the fault-free run) injects faults; `redundancy="dmr"`
    runs every item on a lane pair and recovers by rollback, quarantining
    a pair after `max_retries` consecutive mismatches. Unprotected faulty
    results depend on the lane and epoch each item lands on, so they
    match the reference's only at equal `chunk`, `seg_steps` and
    `adaptive`; DMR results equal the fault-free ones at any chunk. The
    options the reference has beyond these (`refill="host"`, `mesh`,
    `checkpoint_dir`, and plans past the resident safety bounds, where
    the reference falls back to its host loop) raise
    NotImplementedError, except that a resilient plan raises the
    reference's ValueError where the reference does.
    """
    dev = resolve(device)
    groups = list(groups)
    if not groups:
        raise ValueError("run_packed needs at least one group")
    if seg_steps < 1:
        raise ValueError("seg_steps must be >= 1")
    if chunk < 1:
        raise ValueError("chunk must be >= 1")
    if refill not in REFILLS:
        raise ValueError(f"refill must be one of {REFILLS}")
    if redundancy not in REDUNDANCY:
        raise ValueError(f"redundancy must be one of {REDUNDANCY} "
                         f"(tmr is priced by the carbon planner but "
                         f"not executed), got {redundancy!r}")
    if faults is not None and faults.off:
        faults = None              # rate 0 is the fault-free run
    dmr = redundancy == "dmr"
    resilient = faults is not None or dmr
    if resilient:
        if refill != "device":
            raise ValueError(
                "fault injection / DMR needs the resident loop: the "
                "fault epoch and rollback snapshots live on device "
                "(pass refill='device')")
        if checkpoint_dir is not None:
            raise ValueError(
                "fault injection / DMR is incompatible with "
                "checkpoint_dir: epoch/retry/snapshot state is not "
                "part of the durable checkpoint schema")
    if refill == "host":
        raise _not_ported("refill='host' (the host-refill loop)", "item 4")
    if mesh is not None:
        raise _not_ported("mesh= (shard-local multi-GPU streaming)",
                          "item 9")
    if checkpoint_dir is not None:
        raise _not_ported("checkpoint_dir= (durable resident streams)",
                          "item 7")

    n_groups = len(groups)
    counts = np.array([g.n_items for g in groups], np.int64)
    total_items = int(counts.sum())
    mix_bound = max(int(g.n_items) * int(g.max_steps) for g in groups)
    ks_words = total_items * (max(g.mem_words for g in groups) + 16 + 1
                              + N_MIX) if keep_state else 0
    if mix_bound > _RESIDENT_MIX_LIMIT \
            or ks_words > _RESIDENT_KEEP_STATE_WORDS:
        if resilient:
            raise ValueError(
                "plan exceeds the resident-runtime safety bounds "
                "(int32 mix counters / keep_state device rows) and "
                "fault injection / DMR cannot fall back to the "
                "host-refill loop — shrink the plan or drop the "
                "fault/redundancy knobs")
        raise _not_ported(
            "a plan past the resident safety bounds (int32 mix counters, "
            "keep_state device rows), which the reference runs on its "
            "host-refill loop,", "item 4")
    stepper = "cuda" if dev.type == "cuda" else "plain"
    dev_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else "cpu"
    if total_items == 0:
        empty = [FleetResult(
            n_items=0, n_instr=np.zeros(0, np.int64),
            n_two_stage=np.zeros(0, np.int64), halted=np.zeros(0, bool),
            out=np.zeros(0, np.int32), mix=np.zeros(N_MIX, np.int64),
            lane_steps=0, n_segments=0, chunk=0, seg_steps=seg_steps,
            wall_s=0.0, stepper=stepper,
            n_cycles=None if g.cost is None else np.zeros(0, np.int64))
            for g in groups]
        return empty, PackedStats(
            n_groups=n_groups, n_progs=n_groups, bank_width=0,
            lane_steps=0, n_segments=0, chunk=0, seg_steps=seg_steps,
            wall_s=0.0, stepper=stepper, n_devices=1, adaptive=adaptive,
            device=dev_name, redundancy=redundancy)

    mem_words = max(g.mem_words for g in groups)
    bank_np, code_len_np = iss.pack_programs([g.code for g in groups])
    if subset is None:
        subset = frozenset().union(
            *(g.subset if g.subset is not None
              else iss.opcode_subset(g.code) for g in groups))
    # per-program memory bounds and cost rows (a cost-less group in a
    # timed plan gets a zero row)
    timing = any(g.cost is not None for g in groups)
    cost_np = np.zeros((n_groups, N_COST), np.int32)
    for i, g in enumerate(groups):
        if g.cost is not None:
            cost_np[i] = np.asarray(g.cost, np.int32)
    consts = {
        "bank": torch.from_numpy(bank_np).to(dev),
        "code_len": torch.from_numpy(code_len_np).to(dev),
        "mem_len": torch.tensor([g.mem_words for g in groups], dtype=I32,
                                device=dev),
        "cost": torch.from_numpy(cost_np).to(dev) if timing else None,
        "out_addr": torch.tensor(
            [-1 if g.out_addr is None else g.out_addr for g in groups],
            dtype=I32, device=dev)}
    # a DMR pair takes two lanes per item: the pool rounds up to even
    chunk = min(chunk, total_items * (2 if dmr else 1))
    if dmr:
        chunk += chunk % 2
    ms_of = np.array([g.max_steps for g in groups], np.int64)

    clock = _SyncClock()
    controller = _SuperstepController(seg_steps, chunk, adaptive)
    t0 = time.perf_counter()
    out = _stream_resident(groups, prefetch, counts, ms_of, consts, chunk,
                           keep_state, subset, mem_words, timing,
                           controller, clock, dev, faults=faults, dmr=dmr,
                           max_retries=max_retries)
    wall_s = time.perf_counter() - t0

    busy = np.array([r.sum() for r in out["r_instr"]], np.float64)
    busy_share = busy / max(busy.sum(), 1.0)
    results = []
    for g, grp in enumerate(groups):
        results.append(FleetResult(
            n_items=grp.n_items, n_instr=out["r_instr"][g],
            n_two_stage=out["r_two"][g], halted=out["r_halt"][g],
            out=out["r_out"][g], mix=out["r_mix"][g],
            lane_steps=int(out["g_lane_steps"][g]),
            n_segments=int(out["g_segments"][g]),
            chunk=chunk, seg_steps=seg_steps,
            wall_s=wall_s * float(busy_share[g]), stepper=stepper,
            mems=out["r_mem"][g] if keep_state else None,
            regs=out["r_regs"][g] if keep_state else None,
            pc=out["r_pc"][g] if keep_state else None,
            mix_items=out["r_mix_items"][g] if keep_state else None,
            n_cycles=out["r_cycles"][g] if grp.cost is not None else None))
    stats = PackedStats(
        n_groups=n_groups, n_progs=bank_np.shape[0],
        bank_width=bank_np.shape[1], lane_steps=out["lane_steps"],
        n_segments=out["n_segments"], chunk=chunk, seg_steps=seg_steps,
        wall_s=wall_s, stepper=stepper, n_devices=1, adaptive=adaptive,
        host_syncs=clock.host_syncs, sync_wait_s=clock.sync_wait_s,
        refill_wall_s=clock.refill_wall_s,
        device_busy_frac=clock.busy_frac(wall_s),
        seg_schedule=tuple(controller.schedule[:out["n_segments"]]),
        device=dev_name, redundancy=redundancy, detected=out["detected"],
        corrected=out["corrected"], quarantined=out["quarantined"])
    return results, stats


def run_stream(code: np.ndarray, source: Source, *, n_items: int,
               mem_words: int, max_steps: int, chunk: int = 256,
               seg_steps: int = 4096, out_addr: Optional[int] = None,
               keep_state: bool = False, mesh=None,
               subset: Optional[frozenset] = None, prefetch: bool = True,
               refill: str = "device", adaptive: bool = False,
               cost: Optional[np.ndarray] = None, faults=None,
               redundancy: str = "none", max_retries: int = 2,
               device: DeviceLike = None) -> FleetResult:
    """Stream `n_items` memory images of one program from `source`
    through `chunk` lanes: the single-group case of `run_packed`, with
    the run's whole-pool accounting (lane-step slots, segments, wall
    clock) folded into the returned `FleetResult`."""
    results, stats = run_packed(
        [PackedGroup(code=code, source=source, n_items=n_items,
                     max_steps=max_steps, mem_words=mem_words,
                     out_addr=out_addr, cost=cost)],
        chunk=chunk, seg_steps=seg_steps, keep_state=keep_state,
        mesh=mesh, subset=subset, prefetch=prefetch, refill=refill,
        adaptive=adaptive, faults=faults, redundancy=redundancy,
        max_retries=max_retries, device=device)
    return dataclasses.replace(
        results[0], lane_steps=stats.lane_steps,
        n_segments=stats.n_segments, chunk=stats.chunk,
        wall_s=stats.wall_s)


def _host_buffer(shape, dtype, dev: torch.device) -> torch.Tensor:
    """A host staging tensor: page-locked when the device is a card, so
    copies from it can run asynchronously."""
    return torch.zeros(shape, dtype=dtype, pin_memory=dev.type == "cuda")


def _stream_resident(groups, prefetch, counts, ms_of, consts, chunk,
                     keep_state, subset, mem_words, timing,
                     controller: _SuperstepController, clock: _SyncClock,
                     dev: torch.device, faults=None, dmr: bool = False,
                     max_retries: int = 2):
    """The resident stream loop (see the module docstring) at one shard.
    The loop exits after the refill that retires the last item; the
    segment queued behind it finds every lane parked and takes no step.
    """
    n_groups = len(groups)
    total = int(counts.sum())
    slot_base = np.zeros(n_groups, np.int64)
    np.cumsum(counts[:-1], out=slot_base[1:])
    cuda = dev.type == "cuda"

    sources = [_locked(g.source) for g in groups]
    prefs = [_Prefetcher(sources[i], int(counts[i]),
                         block=max(1, min(chunk, int(counts[i]))),
                         background=prefetch)
             for i in range(n_groups)]

    # ---- staged batch: a host mirror in (pinned) tensors, FIFO, plus
    # its device copy; the mirror is written only after the refill that
    # read the last upload has finished (the stats wait orders that)
    st_host = [_host_buffer((chunk, mem_words), I32, dev),
               _host_buffer(chunk, I32, dev), _host_buffer(chunk, I32, dev),
               _host_buffer(chunk, I32, dev), _host_buffer(1, I32, dev)]
    st_mems, st_prog, st_ms, st_slot, st_n = (t.numpy() for t in st_host)
    st_dev = [torch.empty_like(t, device=dev) for t in st_host]
    staged_cursor = np.zeros(n_groups, np.int64)
    dirty = [True]
    # a quarantined pair's item comes back here (group, index, row) and is
    # staged again, under its own row, ahead of fresh admissions
    requeue = []

    def restock():
        while requeue and int(st_n[0]) < chunk:
            g, local, row = requeue.pop(0)
            off = int(st_n[0])
            st_mems[off] = 0
            st_mems[off, :groups[g].mem_words] = np.asarray(
                sources[g](local, 1), np.int32)[0]
            st_prog[off], st_ms[off], st_slot[off] = g, ms_of[g], row
            st_n[0] = off + 1
            dirty[0] = True
        free = chunk - int(st_n[0])
        remaining = counts - staged_cursor
        if free <= 0 or int(remaining.sum()) == 0:
            return
        take = _apportion(free, remaining)
        off = int(st_n[0])
        for g in np.nonzero(take)[0]:
            k = int(take[g])
            st_mems[off:off + k] = 0
            st_mems[off:off + k, :groups[g].mem_words] = prefs[g].take(k)
            st_prog[off:off + k] = g
            st_ms[off:off + k] = ms_of[g]
            st_slot[off:off + k] = slot_base[g] + np.arange(
                staged_cursor[g], staged_cursor[g] + k)
            staged_cursor[g] += k
            off += k
        if off != int(st_n[0]):
            st_n[0] = off
            dirty[0] = True

    def consume(k: int):
        if k <= 0:
            return
        n = int(st_n[0])
        for buf in (st_mems, st_prog, st_ms, st_slot):
            buf[:n - k] = buf[k:n].copy()
        st_n[0] = n - k
        dirty[0] = True

    def upload():
        if dirty[0]:
            for d, h in zip(st_dev, st_host):
                d.copy_(h, non_blocking=True)
            dirty[0] = False

    # ---- device state: an all-parked lane pool and the accumulators
    state = iss.PackedState(
        lanes=iss.fresh_lanes(torch.zeros((chunk, mem_words), dtype=I32,
                                          device=dev))._replace(
            halted=torch.ones(chunk, dtype=torch.bool, device=dev)),
        prog_id=torch.zeros(chunk, dtype=I32, device=dev),
        max_steps=torch.zeros(chunk, dtype=I32, device=dev))
    item_slot = torch.full((chunk,), -1, dtype=I32, device=dev)
    acc = _fresh_acc(total, chunk, n_groups, mem_words, keep_state, dev)
    # resilience state: per-lane fault keys and epochs; per-pair mismatch
    # counts and quarantine flags; the rollback snapshot of the lanes
    lane_key = None if faults is None else flexifault.lane_keys_tensor(
        faults.seed, chunk, dev)
    epoch = torch.zeros(chunk, dtype=I32, device=dev) \
        if faults is not None or dmr else None
    retries = torch.zeros(chunk // 2, dtype=I32, device=dev) if dmr else None
    quar = torch.zeros(chunk // 2, dtype=torch.bool, device=dev) \
        if dmr else None
    snap = iss.ISSState(*(x.clone() for x in state.lanes)) if dmr else None
    n_head = 6 if dmr else 3
    stats_host = _host_buffer(n_head + n_groups, I32, dev)
    stats_ev = torch.cuda.Event() if cuda else None
    seg_ev = torch.cuda.Event() if cuda else None

    g_lane_steps = np.zeros(n_groups, np.int64)
    g_segments = np.zeros(n_groups, np.int64)
    lane_steps = n_segments = prev_seg = retired = 0
    detected = corrected = quarantined = 0
    try:
        restock()
        while retired < total:
            upload()
            if dmr:
                (state, item_slot, epoch, retries, quar, acc,
                 stats) = retire_refill_dmr(
                    state, item_slot, epoch, retries, quar, snap, acc,
                    *st_dev[:4], st_dev[4], consts["out_addr"], n_groups,
                    max_retries, device=dev)
                # the refreshed boundary state is the next rollback point
                for x, y in zip(snap, state.lanes):
                    x.copy_(y)
            else:
                old_slot = item_slot
                state, item_slot, acc, stats = retire_refill(
                    state, item_slot, acc, *st_dev[:4], st_dev[4],
                    consts["out_addr"], n_groups, device=dev)
                if epoch is not None:
                    # a lane that takes a fresh item draws a fresh
                    # schedule (draws key on (lane, epoch, n_instr))
                    epoch += ((item_slot != old_slot)
                              & (item_slot >= 0)).to(I32)
            # the stats copy is queued right behind the refill, ahead of
            # the segment, so waiting for it does not wait for the segment
            stats_host.copy_(stats, non_blocking=True)
            if cuda:
                stats_ev.record()
            seg_steps = controller.next_seg()
            state = iss_stepper.iss_segment_banked(
                consts["bank"], consts["code_len"], state,
                seg_steps=seg_steps, subset=subset,
                mem_len=consts["mem_len"], cost=consts["cost"],
                faults=faults, lane_key=lane_key, epoch=epoch, device=dev)
            if cuda:
                seg_ev.record()
            clock.wait(stats_ev)
            sv = stats_host.numpy().astype(np.int64)
            n_ret, delta, act_g = int(sv[0]), int(sv[2]), sv[n_head:]
            if dmr:
                detected += int(sv[3])
                corrected += int(sv[4])
                if sv[5] >= 0:
                    # quarantined pair: hand its item back to restock
                    row = int(sv[5])
                    g = int(np.searchsorted(slot_base, row,
                                            side="right") - 1)
                    requeue.append((g, row - int(slot_base[g]), row))
                    quarantined += 1
                    if quarantined >= chunk // 2:
                        raise RuntimeError(
                            f"DMR pool starved: all {chunk // 2} lane "
                            f"pair(s) of shard 0 are quarantined with "
                            f"items still pending — raise chunk, raise "
                            f"max_retries, or fix the fault rate")
            if act_g.sum() > 0:
                n_segments += 1
                g_segments += act_g > 0
                g_lane_steps += act_g * delta
                lane_steps += chunk * delta
            controller.record(n_ret, prev_seg)
            prev_seg = seg_steps
            retired += n_ret
            t_refill = time.perf_counter()
            consume(int(sv[1]))
            restock()
            dt = time.perf_counter() - t_refill
            clock.refill_wall_s += dt
            if not cuda or seg_ev.query():   # segment already done:
                clock.idle_s += dt           # the restock was idle time
    finally:
        for p in prefs:
            p.close()

    # ---- drain: one read of each accumulator
    rows = slice(0, total)
    accv = {"n_instr": clock.fetch(acc.n_instr[rows]),
            "n_two": clock.fetch(acc.n_two[rows])}
    accv["n_cycles"] = clock.fetch(acc.n_cycles[rows]) if timing \
        else np.zeros(total, np.int64)
    accv["halted"] = clock.fetch(acc.halted[rows])
    accv["out"] = clock.fetch(acc.out[rows])
    mix_g = clock.fetch(acc.mix_g).astype(np.int64)
    if keep_state:
        for k in ("mems", "regs", "pc", "mix_items"):
            accv[k] = clock.fetch(getattr(acc, k)[rows])

    res = {k: [] for k in ("r_instr", "r_two", "r_cycles", "r_halt", "r_out",
                           "r_mix", "r_mem", "r_regs", "r_pc",
                           "r_mix_items")}
    for g, grp in enumerate(groups):
        sl = slice(int(slot_base[g]), int(slot_base[g] + counts[g]))
        res["r_instr"].append(accv["n_instr"][sl].astype(np.int64))
        res["r_two"].append(accv["n_two"][sl].astype(np.int64))
        res["r_cycles"].append(accv["n_cycles"][sl].astype(np.int64))
        res["r_halt"].append(accv["halted"][sl])
        res["r_out"].append(accv["out"][sl])
        res["r_mix"].append(mix_g[g])
        if keep_state:
            res["r_mem"].append(accv["mems"][sl, :grp.mem_words].copy())
            res["r_regs"].append(accv["regs"][sl])
            res["r_pc"].append(accv["pc"][sl])
            res["r_mix_items"].append(accv["mix_items"][sl])
    res.update(g_lane_steps=g_lane_steps, g_segments=g_segments,
               lane_steps=lane_steps, n_segments=n_segments,
               detected=detected, corrected=corrected,
               quarantined=quarantined)
    return res

