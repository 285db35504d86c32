"""Packed, device-resident fleet runtime on one or more cards.

The port of the reference's `fleet/engine.py` (`run_packed` with its
resident `_stream_resident` loop and host-refill `_stream_host` loop).
Every group of a heterogeneous plan runs through ONE pool of `chunk`
lanes: programs sit in a padded bank, each lane carries its bank row and
step budget, and freed lanes are refilled from any pending group
(`_apportion`), so one group's tail hides behind the others' backlog.

The lane pool and the per-item result accumulators (`ResidentAcc`) live
on the device for the whole run. Per iteration, in stream order:

    refill_i  retire finished lanes into their items' accumulator rows
              and swap staged items into free lanes (plain torch ops
              around the `iss_refill` kernel), producing a small stats
              block, which is copied at once into pinned host memory
    seg_i     the segment, at the controller's bound
    (host)    wait for refill_i's stats copy only (seg_i is running),
              then restock the staged batch for refill_{i+1} from the
              per-group prefetchers, overlapped with seg_i

The staged batch is uploaded from pinned memory with `non_blocking=True`
before the next refill. Per-item results are read once, at the end.

`stepper` picks what runs a segment (the reference's `STEPPERS`):
"pallas", the port's default, is the kernel route: the
`iss_segment_banked` CUDA kernel on the card, its plain version on the
CPU. "branchless" and "switch" are the reference's baseline steppers
(`iss.run_segment_lanes_banked(edges="xla")`, `iss.run_segment_banked`),
plain torch on the run's device, the card included; they run only when
the caller names them. The reference's own default is "branchless"; on
FlexiBench workloads the two agree bit for bit. Refills on the card are
the `iss_refill` kernel whatever the stepper.

Shard-local streaming (`mesh=`, DESIGN.md §9.12): `mesh` is a sequence
of devices, one per shard (`["cuda"] * 4` is four logical shards on one
card). Shard s owns lanes `[s*spc, (s+1)*spc)` of the pool, its own
staged FIFO, its own per-group prefetchers over `shard_partition`'s
spans and its own block of accumulator rows, so the refill's rank, the
retire scatter and the swap never read another shard's rows. The shards
on one device share one pool tensor, so the segment kernel launches once
a segment per device over all of them; consecutive shards on one device
form one part, and every part runs the same code, with no collectives.
The stats blocks of all shards land in one pinned host buffer, read with
one host sync a segment whatever the shard count. One shard is the
`mesh=None` case of the same code.

FlexiFault (DESIGN.md §9.14): with `faults` every lane runs the segment
kernel's `faults` variant under its own key (`faults.lane_keys`) and an
epoch it bumps when it takes a fresh item. `redundancy="dmr"` pairs
lanes (2p, 2p+1) on one item image (a pair never straddles a shard),
compares their architectural digests at every refill boundary, rolls a
mismatching pair back to the boundary snapshot (kept in preallocated
lane buffers, since the kernel updates the pool in place) and
quarantines a pair after `max_retries` consecutive mismatches,
requeueing its item on its shard ahead of fresh admissions.

The host-refill loop (`refill="host"`, `_stream_host`) is the
reference's A/B baseline: a blocking done-count read per segment, then,
on a finishing segment, a host demux of the finished lanes and a
rebuild of the pool, through the same segment. Its schedule is the
single-device one; under a mesh only the state is split over the
shards' devices. A plan past the resident safety bounds (int32 mix
counters, keep_state device rows) falls back to it, as the reference's
does; `PackedStats.refill` says which loop ran.

Durable streams (`checkpoint_dir=`, `checkpoint_every=`): at a refill
boundary the resident loop writes the reference's canonical snapshot
(`distributed/checkpoint.py`): per-item results so far, done mask,
in-flight lanes, pending item spans and controller state, independent
of the shard count. A run whose `checkpoint_dir` holds a checkpoint
resumes from the newest intact one, dealing the in-flight lanes and the
pending spans over its own shards as the reference does: per-item
results bit-exact with an uninterrupted run, the schedule that of the
reference's resume (which stages the unconsumed items again, so it may
take other segments than the uninterrupted run). A checkpoint written
at N shards, by either package, resumes at M shards.
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
from repro_torch.distributed import checkpoint as dckpt
from repro_torch.flexibench.base import Workload
from repro_torch.flexibits import faults as flexifault
from repro_torch.flexibits import iss
from repro_torch.flexibits.cycles import MIX_CLASSES, N_COST
from repro_torch.kernels import iss_stepper

STEPPERS = ("branchless", "pallas", "switch")
REFILLS = ("device", "host")   # "host" is the reference's A/B loop
REDUNDANCY = ("none", "dmr")
I32 = torch.int32
N_MIX = len(MIX_CLASSES)

# resident-runtime safety bounds: the per-group mix counters are int32,
# and keep_state scatters full final state into O(fleet) device rows;
# past either, run_packed falls back to the host-refill loop
_RESIDENT_MIX_LIMIT = 2**31 - 1
_RESIDENT_KEEP_STATE_WORDS = 1 << 27   # ~512 MB of int32 device rows

# source protocol: source(start, count) -> (count, mem_words) int32
Source = Callable[[int, int], np.ndarray]


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
    # "cuda" (the kernel) or "plain" (its plain version on the CPU) for
    # stepper="pallas", else the stepper's name
    stepper: str = "cuda"
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
    what ran the segments: "cuda" (the kernel) or "plain" (its plain
    version on the CPU) for `stepper="pallas"`, else "branchless" or
    "switch"; `device` names the device.

    The shard fields (DESIGN.md §9.12): `n_shards` is the lane pool's
    shard count (the mesh's length, 1 without a mesh), and for the
    resident loop `shard_retired`/`shard_lane_steps` break the items
    retired and the lane-step slots down per shard. `n_devices` counts
    DISTINCT devices: four logical shards on one card report 1 (the
    reference reports its mesh's device count, 4 there).

    The resilience counters (DMR runs): `detected` digest mismatches,
    `corrected` pair rollbacks that re-executed a segment, `quarantined`
    pairs retired from the pool; `sdc` (silent data corruption) is 0, as
    in the reference: only a golden fault-free run can count what the
    detector missed (`faults.measure_rates`)."""
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
    n_shards: int = 1
    shard_retired: tuple = ()
    shard_lane_steps: tuple = ()
    redundancy: str = "none"
    detected: int = 0
    corrected: int = 0
    quarantined: int = 0
    sdc: int = 0


class _SyncClock:
    """Counts and times every blocking device->host read, plus the host
    restock work, and accumulates device-idle intervals."""

    def __init__(self):
        self.host_syncs = 0
        self.sync_wait_s = 0.0
        self.refill_wall_s = 0.0
        self.idle_s = 0.0

    def fetch(self, x) -> np.ndarray:
        """One read: a host copy of `x` (never a view of a CPU tensor the
        run goes on updating in place), or of a list of tensors (one per
        part of a pool) concatenated."""
        t0 = time.perf_counter()
        xs = x if isinstance(x, (list, tuple)) else [x]
        host = [t.to("cpu", copy=True).numpy() for t in xs]
        out = host[0] if len(host) == 1 else np.concatenate(host)
        self.sync_wait_s += time.perf_counter() - t0
        self.host_syncs += 1
        return out

    def wait(self, events) -> None:
        """One read: wait for every event (none on the CPU)."""
        t0 = time.perf_counter()
        for ev in events:
            ev.synchronize()
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


# ---------------------------------------------------------------- host loop
# The reference's PR-4 loop primitives as plain torch ops on the run's
# device. Where the reference donates its buffers, these update the pool
# in place.

def _fresh_chunk(mems: np.ndarray, active: np.ndarray,
                 dev: torch.device) -> iss.ISSState:
    lanes = iss.fresh_lanes(torch.tensor(mems, dtype=I32, device=dev))
    # padding lanes never step
    return lanes._replace(halted=torch.tensor(~active, device=dev))


def _refill(state: iss.ISSState, replace: torch.Tensor,
            new_mems: torch.Tensor) -> iss.ISSState:
    """Reset `replace` lanes to a fresh item (mem from new_mems), in
    place."""
    rep1 = replace[:, None]
    state.regs.masked_fill_(rep1, 0)
    state.pc.masked_fill_(replace, 0)
    torch.where(rep1, new_mems, state.mem, out=state.mem)
    state.halted.masked_fill_(replace, False)
    for x in (state.n_instr, state.n_two_stage, state.n_cycles):
        x.masked_fill_(replace, 0)
    state.mix.masked_fill_(rep1, 0)
    return state


def _fresh_packed(mems: np.ndarray, active: np.ndarray, prog_id: np.ndarray,
                  max_steps: np.ndarray,
                  dev: torch.device) -> iss.PackedState:
    return iss.PackedState(
        lanes=_fresh_chunk(mems, active, dev),
        prog_id=torch.tensor(prog_id, dtype=I32, device=dev),
        max_steps=torch.tensor(max_steps, dtype=I32, device=dev))


def _refill_packed(state: iss.PackedState, replace: torch.Tensor,
                   new_mems: torch.Tensor, new_prog: torch.Tensor,
                   new_ms: torch.Tensor) -> iss.PackedState:
    """Reset `replace` lanes to a fresh item of (possibly) another group:
    new memory image, bank row and step budget, in place."""
    _refill(state.lanes, replace, new_mems)
    torch.where(replace, new_prog, state.prog_id, out=state.prog_id)
    torch.where(replace, new_ms, state.max_steps, out=state.max_steps)
    return state


def _done_count_packed(state: iss.PackedState) -> torch.Tensor:
    """Scalar count of done lanes (halted or own step budget spent;
    padding lanes carry budget 0 and count as done): the host loop's
    one read per segment."""
    return (state.lanes.halted
            | (state.lanes.n_instr >= state.max_steps)).sum()


# ------------------------------------------------------- durable streams

class InjectedFault(RuntimeError):
    """Raised by the resident loop's fault-injection knob
    (`run_packed(..., _crash_after_segments=n)`): the stream dies at the
    top of a loop iteration, so a test can kill a run at a segment
    boundary and resume it from its last checkpoint."""


def shard_partition(counts, n_shards: int):
    """Static item->shard partition of the packed stream: `spans[g][s]`
    is a list of `(lo, hi)` half-open item-index ranges of group g owned
    by shard s, a contiguous balanced split (shard item counts differ by
    at most one). At one shard it is the whole group, in order."""
    spans = []
    for c in np.asarray(counts, np.int64):
        c = int(c)
        base, rem = divmod(c, n_shards)
        row, lo = [], 0
        for s in range(n_shards):
            k = base + (1 if s < rem else 0)
            row.append([(lo, lo + k)] if k else [])
            lo += k
        spans.append(row)
    return spans


def _span_items(spans) -> np.ndarray:
    """Flat item-index vector of a span list."""
    if not spans:
        return np.zeros(0, np.int64)
    return np.concatenate([np.arange(lo, hi, dtype=np.int64)
                           for lo, hi in spans])


def _items_to_spans(items):
    """Compress a sorted item-index vector back into (lo, hi) spans."""
    items = np.asarray(items, np.int64)
    if items.size == 0:
        return []
    brk = np.nonzero(np.diff(items) != 1)[0]
    starts = np.concatenate([[0], brk + 1])
    ends = np.concatenate([brk, [items.size - 1]])
    return [(int(items[a]), int(items[b]) + 1)
            for a, b in zip(starts, ends)]


def _split_spans(spans, n_shards: int):
    """Contiguous balanced split of a span list over `n_shards`: the
    pending items of a restored stream, dealt to the resuming shards."""
    items = _span_items(spans)
    base, rem = divmod(items.size, n_shards)
    out, lo = [], 0
    for s in range(n_shards):
        k = base + (1 if s < rem else 0)
        out.append(_items_to_spans(items[lo:lo + k]))
        lo += k
    return out


def _span_source(source: Source, spans) -> Source:
    """View of `source` restricted to a span list: linear index i maps
    to the i-th item of the concatenated spans, fetched from the
    underlying source in contiguous runs."""
    lens = np.array([hi - lo for lo, hi in spans], np.int64)
    offs = np.concatenate([np.zeros(1, np.int64), np.cumsum(lens)])

    def src(start: int, count: int) -> np.ndarray:
        parts = []
        i, end = int(start), int(start) + int(count)
        while i < end:
            k = int(np.searchsorted(offs, i, side="right")) - 1
            take = min(end - i, int(offs[k + 1]) - i)
            a = spans[k][0] + (i - int(offs[k]))
            parts.append(np.asarray(source(a, take), np.int32))
            i += take
        if not parts:
            return np.zeros((0, 0), np.int32)
        return parts[0] if len(parts) == 1 else np.concatenate(parts)
    return src


# the canonical resident checkpoint's leaves: merged per-item results
# (`val_*`) and the in-flight lanes (`lane_*`), as the reference writes
_CKPT_VALS = ("n_instr", "n_two", "n_cycles", "halted", "out")
_CKPT_KEEP = ("mems", "regs", "pc", "mix_items")
_CKPT_LANES = ("regs", "pc", "mem", "halted", "n_instr", "n_two",
               "mix", "n_cycles", "prog", "ms")


def _resident_ckpt_skeleton(n_groups: int, keep_state: bool) -> dict:
    """Flat-dict skeleton of a resident checkpoint: `restore` needs only
    the key set; shapes come from the stored arrays."""
    keys = ["counts", "done_mask", "mix_g", "pending", "counters",
            "ctrl", "sched", "g_lane_steps", "g_segments",
            "lane_item", "lane_prev"]
    keys += ["val_" + k for k in _CKPT_VALS]
    if keep_state:
        keys += ["val_" + k for k in _CKPT_KEEP]
    keys += ["lane_" + k for k in _CKPT_LANES]
    return {k: np.zeros(0, np.int64) for k in keys}


class ResidentAcc(NamedTuple):
    """On-device result accumulators of the resident loop, laid out
    shard-locally (DESIGN.md §9.12), for the shards of one device.

    Per-item leaves hold `n_sh * (cap + 1)` rows: shard j (of this
    device's `n_sh`) owns the block `[j*(cap+1), (j+1)*(cap+1))`, whose
    first `cap` rows are its items' (the host's item->row table,
    `rowmap`, says whose) and whose last row takes the retire scatters of
    its lanes that did not retire, so the scatter needs no data-dependent
    shape and never leaves the shard. `item_slot` holds shard-local rows
    (0..cap-1), as the reference's. `mix_g` sums the retired mix per
    shard and group (int32: see the safety bounds), `prev_instr` is each
    lane's retired count at the last refill. The keep_state leaves are
    None unless full final state was asked for. Dropping each shard's
    last row gives the reference's `n_shards * cap` layout.
    """
    n_instr: torch.Tensor               # (n_sh*(cap+1),) int32
    n_two: torch.Tensor                 # (n_sh*(cap+1),) int32
    n_cycles: torch.Tensor              # (n_sh*(cap+1),) int32 ticks
    halted: torch.Tensor                # (n_sh*(cap+1),) bool
    out: torch.Tensor                   # (n_sh*(cap+1),) int32
    mix_g: torch.Tensor                 # (n_sh, n_groups, 8) int32
    prev_instr: torch.Tensor            # (lanes,) int32
    mems: Optional[torch.Tensor]        # (n_sh*(cap+1), M) int32
    regs: Optional[torch.Tensor]        # (n_sh*(cap+1), 16) int32
    pc: Optional[torch.Tensor]          # (n_sh*(cap+1),) int32
    mix_items: Optional[torch.Tensor]   # (n_sh*(cap+1), 8) int32


def _fresh_acc(n_sh: int, cap: int, n_lanes: int, n_groups: int,
               mem_words: int, keep_state: bool,
               dev: torch.device) -> ResidentAcc:
    def z(*shape, dtype=I32):
        return torch.zeros(shape, dtype=dtype, device=dev)
    rows = n_sh * (cap + 1)
    return ResidentAcc(
        n_instr=z(rows), n_two=z(rows), n_cycles=z(rows),
        halted=z(rows, dtype=torch.bool), out=z(rows),
        mix_g=z(n_sh, n_groups, N_MIX), prev_instr=z(n_lanes),
        mems=z(rows, mem_words) if keep_state else None,
        regs=z(rows, 16) if keep_state else None,
        pc=z(rows) if keep_state else None,
        mix_items=z(rows, N_MIX) if keep_state else None)


def _lane_shard(acc: ResidentAcc, n_lanes: int) -> "tuple[int, torch.Tensor]":
    """(shards in the pool, each lane's shard) of a pool whose shards
    hold equal contiguous lane blocks."""
    n_sh = acc.mix_g.shape[0]
    return n_sh, torch.arange(n_lanes, device=acc.mix_g.device) \
        // (n_lanes // n_sh)


def _scatter_retired(state: iss.PackedState, item_slot: torch.Tensor,
                     acc: ResidentAcc, out_addr: torch.Tensor,
                     retired: torch.Tensor) -> ResidentAcc:
    """Write retiring lanes' tallies into their items' rows of their own
    shard's block, in place; every other lane writes its shard's discard
    row, and its retired mix adds nothing."""
    lanes = state.lanes
    n_sh, shard = _lane_shard(acc, item_slot.shape[0])
    cap1 = acc.n_instr.shape[0] // n_sh
    slot = (shard * cap1 + torch.where(retired, item_slot, cap1 - 1)).long()
    pid = state.prog_id.long()

    def put(buf, val):
        return None if buf is None else buf.index_copy_(0, slot, val)

    col = out_addr[pid]
    out_val = lanes.mem.gather(
        1, torch.clamp(col, 0, lanes.mem.shape[1] - 1).long()[:, None])[:, 0]
    out_val = torch.where(col >= 0, out_val, 0)
    n_groups = acc.mix_g.shape[1]
    acc.mix_g.view(-1, N_MIX).index_add_(
        0, shard * n_groups + pid, torch.where(retired[:, None], lanes.mix, 0))
    return acc._replace(
        n_instr=put(acc.n_instr, lanes.n_instr),
        n_two=put(acc.n_two, lanes.n_two_stage),
        n_cycles=put(acc.n_cycles, lanes.n_cycles),
        halted=put(acc.halted, lanes.halted),
        out=put(acc.out, out_val),
        mems=put(acc.mems, lanes.mem),
        regs=put(acc.regs, lanes.regs),
        pc=put(acc.pc, lanes.pc),
        mix_items=put(acc.mix_items, lanes.mix))


def _shard_accounting(lanes: iss.ISSState, prog_id: torch.Tensor,
                      active: torch.Tensor, acc: ResidentAcc,
                      n_groups: int):
    """Per shard: the max step delta of the segment that just ran
    (n_sh,) and the active lanes per group (n_sh, n_groups)."""
    n_sh, shard = _lane_shard(acc, active.shape[0])
    delta = torch.clamp((lanes.n_instr - acc.prev_instr).view(n_sh, -1)
                        .max(1).values, min=0)
    act_g = torch.zeros(n_sh * n_groups, dtype=I32,
                        device=active.device).index_add_(
        0, shard * n_groups + prog_id.long(), active.to(I32))
    return delta.to(I32), act_g.view(n_sh, n_groups)


def _take_per_shard(free: torch.Tensor, n_staged: torch.Tensor,
                    rows_per_shard: int):
    """`iss.refill_take` in each shard's block of `free` (equal blocks,
    one staged count per shard): returns (take, src) with `src` the row
    of the device's staged batch, whose shards hold `rows_per_shard`
    rows each, so a lane only ever reads its own shard's rows."""
    n_sh = n_staged.shape[0]
    take, src = iss.refill_take(free.view(n_sh, -1), n_staged.view(n_sh, 1))
    base = torch.arange(n_sh, dtype=I32, device=free.device) * rows_per_shard
    return take.reshape(-1), (src + base[:, None]).reshape(-1)


def retire_refill(state: iss.PackedState, item_slot: torch.Tensor,
                  acc: ResidentAcc, staged_mems: torch.Tensor,
                  staged_prog: torch.Tensor, staged_ms: torch.Tensor,
                  staged_slot: torch.Tensor, n_staged: torch.Tensor,
                  out_addr: torch.Tensor, n_groups: int,
                  device: DeviceLike = None):
    """The resident loop's retire/refill op (the reference's
    `_resident_refill_runner` body) for the shards of one device.

    The pool holds `n_sh = acc.mix_g.shape[0]` shards of equal lane
    blocks, and the staged batch (shard-major, one count per shard in
    `n_staged`) as many blocks of rows. Finished lanes
    (`iss.retire_mask`) scatter their tallies into their items' rows of
    their shard's accumulator block; free lanes take their shard's staged
    rows in lane-rank order (`iss.refill_take`, then the `iss_refill`
    kernel). Returns (state, item_slot, acc, stats) with stats the int32
    vector of the `(n_sh, 3 + n_groups)` block, per shard [retired,
    taken, max step delta, active lanes per group...], describing the
    segment that just ran. On the card the lane pool and `acc` are
    updated in place. Everything that reads the old lanes is queued
    before the swap.
    """
    dev = resolve(device)
    lanes = state.lanes
    n_sh = acc.mix_g.shape[0]
    active = item_slot >= 0
    retired = iss.retire_mask(state, item_slot)
    delta, act_g = _shard_accounting(lanes, state.prog_id, active, acc,
                                     n_groups)
    acc = _scatter_retired(state, item_slot, acc, out_addr, retired)

    free = retired | ~active
    take, src = _take_per_shard(free, n_staged,
                                staged_slot.shape[0] // n_sh)
    srow = torch.clamp(src, 0, staged_slot.shape[0] - 1).long()
    new_slot = torch.where(take, staged_slot[srow],
                           torch.where(retired, -1, item_slot))
    prev = torch.where(take, 0, lanes.n_instr)
    stats = torch.cat([torch.stack([retired.view(n_sh, -1).sum(1, dtype=I32),
                                    take.view(n_sh, -1).sum(1, dtype=I32),
                                    delta], 1), act_g], 1)
    state = iss_stepper.iss_refill(state, take, src, staged_mems,
                                   staged_prog, staged_ms, device=dev)
    return state, new_slot, acc._replace(prev_instr=prev), stats.reshape(-1)


def retire_refill_dmr(state: iss.PackedState, item_slot: torch.Tensor,
                      epoch: torch.Tensor, retries: torch.Tensor,
                      quar: torch.Tensor, snap: iss.ISSState,
                      acc: ResidentAcc, staged_mems: torch.Tensor,
                      staged_prog: torch.Tensor, staged_ms: torch.Tensor,
                      staged_slot: torch.Tensor, n_staged: torch.Tensor,
                      out_addr: torch.Tensor, n_groups: int,
                      max_retries: int, device: DeviceLike = None):
    """The DMR retire/refill op (the reference's `refill_dmr`) for the
    shards of one device, laid out as in `retire_refill`.

    Lanes pair up as (2p primary, 2p+1 shadow) on the same item image;
    only the primary carries the item's accumulator row (the shadow's
    `item_slot` is -1). At the boundary the pair's `arch_digest`s are
    compared: a mismatching pair rolls back to `snap`, its state at the
    previous boundary, with a bumped epoch (fresh transient draws; a
    stuck or dead defect recurs), or, after `max_retries` consecutive
    mismatches, is quarantined: parked for good, its item row reported in
    the stats for the host to requeue (at most one pair per shard per
    boundary). Matching finished pairs retire and refill as in
    `retire_refill`, at pair granularity, through the `iss_refill` kernel
    with `take`/`src` repeated per pair. A clean boundary resets a
    pair's mismatch count.

    Returns (state, item_slot, epoch, retries, quar, acc, stats) with
    stats the int32 vector of the `(n_sh, 6 + n_groups)` block, per
    shard [retired, taken, max step delta, mismatches, rollbacks,
    quarantined item row or -1, active lanes per group...]. The pool is
    rolled back and refilled in place on the card; the caller copies the
    returned lanes into `snap` before the next segment.
    """
    dev = resolve(device)
    lanes = state.lanes
    n_sh = acc.mix_g.shape[0]
    active = item_slot >= 0                  # primaries only
    d2 = flexifault.arch_digest(lanes.regs, lanes.pc, lanes.mem,
                                lanes.halted, lanes.n_instr).view(-1, 2)
    pair_active = active.view(-1, 2)[:, 0]
    mismatch = pair_active & (d2[:, 0] != d2[:, 1])
    done_l = lanes.halted | (lanes.n_instr >= state.max_steps)
    pair_retire = pair_active & done_l.view(-1, 2)[:, 0] & ~mismatch
    wants_q = mismatch & (retries >= max_retries)
    new_q = wants_q & (torch.cumsum(wants_q.view(n_sh, -1).to(I32), 1,
                                    dtype=I32) == 1).view(-1)
    rollback = mismatch & ~new_q
    q_slot = torch.where(new_q, item_slot.view(-1, 2)[:, 0], -1) \
        .view(n_sh, -1).max(1).values

    # ---- accounting of the segment that just ran
    delta, act_g = _shard_accounting(lanes, state.prog_id, active, acc,
                                     n_groups)

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

    # ---- refill freed pairs from their shard's staged rows: both lanes
    # get the item image
    free_p = (pair_retire | ~pair_active) & ~(quar | new_q)
    take_p, src_p = _take_per_shard(free_p, n_staged,
                                    staged_slot.shape[0] // n_sh)
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

    def per_shard(x):
        return x.view(n_sh, -1).sum(1, dtype=I32)
    stats = torch.cat([torch.stack([
        per_shard(pair_retire), per_shard(take_p), delta,
        per_shard(mismatch), per_shard(rollback), q_slot.to(I32)], 1),
        act_g], 1)
    state = iss_stepper.iss_refill(state, take_l, src_l, staged_mems,
                                   staged_prog, staged_ms, device=dev)
    acc = acc._replace(prev_instr=state.lanes.n_instr.clone())
    return (state, new_slot, new_epoch, new_retries, quar | new_q, acc,
            stats.reshape(-1))


def _locked(source: Source) -> Source:
    """`source` behind a lock: a DMR requeue reads an item on the main
    thread while the group's prefetcher may be reading the same source
    (`workload_source`'s block cache is not thread-safe) on its worker."""
    lock = threading.Lock()

    def src(start: int, count: int) -> np.ndarray:
        with lock:
            return source(start, count)

    return src


@dataclasses.dataclass(frozen=True)
class _Part:
    """Consecutive shards `[s0, s1)` of the mesh on one device: one pool
    tensor there holds their lanes, one segment launch steps them."""
    dev: torch.device
    s0: int
    s1: int


def mesh_devices(mesh, device: DeviceLike) -> "list[torch.device]":
    """The run's shard devices: each of `mesh`'s, or one shard on
    `device` without a mesh."""
    if mesh is None:
        return [resolve(device)]
    devs = [resolve(d) for d in mesh]
    if not devs:
        raise ValueError("mesh needs at least one device")
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"mesh mixes CPU and CUDA devices: "
                         f"{[str(d) for d in devs]}")
    if device is not None and any(d != resolve(device) for d in devs):
        raise ValueError(f"device={device!r} is not the mesh's device "
                         f"({[str(d) for d in devs]}): pass device=None "
                         f"with a mesh")
    return devs


def _parts(devs) -> "list[_Part]":
    out = []
    for s, d in enumerate(devs):
        if out and out[-1].dev == d:
            out[-1] = _Part(d, out[-1].s0, s + 1)
        else:
            out.append(_Part(d, s, s + 1))
    return out


def _device_consts(groups, bank_np, code_len_np, timing, dev) -> dict:
    """The program bank and per-program operands on one device (a
    cost-less group in a timed plan gets a zero row)."""
    cost_np = np.zeros((len(groups), N_COST), np.int32)
    for i, g in enumerate(groups):
        if g.cost is not None:
            cost_np[i] = np.asarray(g.cost, np.int32)
    return {
        "bank": torch.from_numpy(bank_np).to(dev),
        "code_len": torch.from_numpy(code_len_np).to(dev),
        "mem_len": torch.tensor([g.mem_words for g in groups], dtype=I32,
                                device=dev),
        "cost": torch.from_numpy(cost_np).to(dev) if timing else None,
        "out_addr": torch.tensor(
            [-1 if g.out_addr is None else g.out_addr for g in groups],
            dtype=I32, device=dev)}


def _segment(stepper: str, c: dict, state: iss.PackedState, seg_steps: int,
             subset, faults, lane_key, epoch,
             dev: torch.device) -> iss.PackedState:
    """One segment of every lane of a device's pool through `stepper`."""
    if stepper == "pallas":
        return iss_stepper.iss_segment_banked(
            c["bank"], c["code_len"], state, seg_steps=seg_steps,
            subset=subset, mem_len=c["mem_len"], cost=c["cost"],
            faults=faults, lane_key=lane_key, epoch=epoch, device=dev)
    if stepper == "branchless":
        return iss.run_segment_lanes_banked(
            c["bank"], c["code_len"], state, seg_steps, subset,
            c["mem_len"], c["cost"], faults=faults, lane_key=lane_key,
            epoch=epoch, edges="xla")
    lanes = iss.run_segment_banked(
        c["bank"], c["code_len"], state.prog_id, state.max_steps,
        state.lanes, seg_steps, c["mem_len"], c["cost"], faults=faults,
        lane_key=lane_key, epoch=epoch)
    return iss.PackedState(lanes=lanes, prog_id=state.prog_id,
                           max_steps=state.max_steps)


def run_packed(groups, *, chunk: int = 256, seg_steps: int = 4096,
               keep_state: bool = False, mesh=None,
               stepper: str = "pallas",
               subset: Optional[frozenset] = None,
               prefetch: bool = True, refill: str = "device",
               adaptive: bool = False, checkpoint_dir: Optional[str] = None,
               checkpoint_every: int = 0, faults=None,
               redundancy: str = "none", max_retries: int = 2,
               device: DeviceLike = None,
               _crash_after_segments: Optional[int] = None):
    """Execute every `PackedGroup` through ONE packed stream.

    Returns `(results, stats)`: `results[g]` is group g's `FleetResult`,
    bit-exact with the reference's `run_packed` (per-item tallies, final
    state with `keep_state`, and, at equal `chunk`, `seg_steps`,
    `adaptive`, stepper and shard count, the schedule statistics and
    host syncs), and `stats` the whole-run `PackedStats`. Runs on the
    card (`device=None` means "cuda"), or with `device="cpu"` on the CPU.

    `stepper` picks what runs the segments: "pallas" (the default, and
    the port's kernel route: the `iss_segment_banked` kernel on the
    card, its plain version on the CPU), or the reference's baseline
    "branchless" or "switch" stepper in plain torch on the run's device.
    The reference's default is "branchless"; on FlexiBench workloads the
    two agree bit for bit.

    `mesh` (a sequence of devices, one per shard: `["cuda"] * 4` is four
    logical shards on the one card) streams shard-locally (module
    docstring); `device` must then be None or the mesh's one device.
    The pool rounds `chunk` up to a multiple of the shard count (of
    twice it under DMR, so a pair never straddles a shard).

    `refill` picks the loop: "device" (the resident loop) or "host" (the
    reference's host-refill A/B loop, with its host syncs read for
    read). A plan past the resident safety bounds runs on the host loop
    whatever `refill` says, and `stats.refill` reports which ran.
    `adaptive` turns on the superstep controller. `subset` pins the
    opcode subset the branchless steppers are specialised to (default:
    the union of the groups' text subsets).

    `checkpoint_dir` makes the resident stream durable: every
    `checkpoint_every` segments it writes the reference's canonical
    snapshot there, and a run whose `checkpoint_dir` already holds one
    resumes from the newest intact checkpoint, its per-item results
    bit-exact with an uninterrupted run and its schedule the reference's
    resume's, at any shard count (a checkpoint written at N shards, by
    either package, resumes at M). `_crash_after_segments` raises
    `InjectedFault` at the top of the loop once that many segments have
    run.

    `faults` (a `faults.FaultSpec`; rate 0 is the fault-free run)
    injects faults; `redundancy="dmr"` runs every item on a lane pair
    and recovers by rollback, quarantining a pair after `max_retries`
    consecutive mismatches. Unprotected faulty results depend on the
    lane and epoch each item lands on, so they match the reference's
    only at equal `chunk`, `seg_steps` and `adaptive`; DMR results equal
    the fault-free ones at any chunk. A resilient plan needs the
    resident loop and no checkpoint, and raises the reference's
    ValueErrors otherwise.
    """
    devs = mesh_devices(mesh, device)
    groups = list(groups)
    if not groups:
        raise ValueError("run_packed needs at least one group")
    if seg_steps < 1:
        raise ValueError("seg_steps must be >= 1")
    if chunk < 1:
        raise ValueError("chunk must be >= 1")
    if stepper not in STEPPERS:
        raise ValueError(f"stepper must be one of {STEPPERS}")
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

    n_groups = len(groups)
    counts = np.array([g.n_items for g in groups], np.int64)
    total_items = int(counts.sum())
    if refill == "device":
        # past the int32 mix counters' bound or the keep_state device-row
        # budget the host loop (int64 collectors, host-RAM state) runs
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
            refill = "host"
    if checkpoint_dir is not None and refill != "device":
        raise ValueError(
            "checkpoint_dir requires the resident loop: refill='device' "
            "within the resident safety bounds (the host-refill loop "
            "keeps no durable on-device state)")
    cuda = devs[0].type == "cuda"
    route = ("cuda" if cuda else "plain") if stepper == "pallas" \
        else stepper
    dev_name = torch.cuda.get_device_name(devs[0]) if cuda else "cpu"
    n_shards, n_dev = len(devs), len(set(devs))
    if total_items == 0:
        empty = [FleetResult(
            n_items=0, n_instr=np.zeros(0, np.int64),
            n_two_stage=np.zeros(0, np.int64), halted=np.zeros(0, bool),
            out=np.zeros(0, np.int32), mix=np.zeros(N_MIX, np.int64),
            lane_steps=0, n_segments=0, chunk=0, seg_steps=seg_steps,
            wall_s=0.0, stepper=route,
            n_cycles=None if g.cost is None else np.zeros(0, np.int64))
            for g in groups]
        return empty, PackedStats(
            n_groups=n_groups, n_progs=n_groups, bank_width=0,
            lane_steps=0, n_segments=0, chunk=0, seg_steps=seg_steps,
            wall_s=0.0, stepper=route, n_devices=1, refill=refill,
            adaptive=adaptive, device=dev_name, redundancy=redundancy)

    mem_words = max(g.mem_words for g in groups)
    bank_np, code_len_np = iss.pack_programs([g.code for g in groups])
    if subset is None:
        subset = frozenset().union(
            *(g.subset if g.subset is not None
              else iss.opcode_subset(g.code) for g in groups))
    timing = any(g.cost is not None for g in groups)
    consts = {d: _device_consts(groups, bank_np, code_len_np, timing, d)
              for d in dict.fromkeys(devs)}
    # a DMR pair takes two lanes per item, and neither a pair nor a lane
    # block straddles a shard: the pool rounds up to the shards (x 2)
    chunk = min(chunk, total_items * (2 if dmr else 1))
    round_to = (2 if dmr else 1) * n_shards
    chunk = -(-chunk // round_to) * round_to
    ms_of = np.array([g.max_steps for g in groups], np.int64)

    clock = _SyncClock()
    controller = _SuperstepController(seg_steps, chunk, adaptive)
    t0 = time.perf_counter()
    if refill == "device":
        out = _stream_resident(groups, prefetch, counts, ms_of, consts,
                               chunk, keep_state, subset, mem_words, timing,
                               controller, clock, devs, stepper,
                               faults=faults, dmr=dmr,
                               max_retries=max_retries,
                               checkpoint_dir=checkpoint_dir,
                               checkpoint_every=checkpoint_every,
                               crash_after=_crash_after_segments)
    else:
        prefs = [_Prefetcher(g.source, g.n_items,
                             block=max(1, min(chunk, g.n_items)),
                             background=prefetch)
                 for g in groups]
        try:
            out = _stream_host(groups, prefs, counts, ms_of, consts, chunk,
                               keep_state, subset, mem_words, timing,
                               controller, clock, devs, stepper)
        finally:
            for p in prefs:
                p.close()
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
            wall_s=wall_s * float(busy_share[g]), stepper=route,
            n_devices=n_dev,
            mems=out["r_mem"][g] if keep_state else None,
            regs=out["r_regs"][g] if keep_state else None,
            pc=out["r_pc"][g] if keep_state else None,
            mix_items=out["r_mix_items"][g] if keep_state else None,
            n_cycles=out["r_cycles"][g] if grp.cost is not None else None))
    stats = PackedStats(
        n_groups=n_groups, n_progs=bank_np.shape[0],
        bank_width=bank_np.shape[1], lane_steps=out["lane_steps"],
        n_segments=out["n_segments"], chunk=chunk, seg_steps=seg_steps,
        wall_s=wall_s, stepper=route, n_devices=n_dev, refill=refill,
        adaptive=adaptive, host_syncs=clock.host_syncs,
        sync_wait_s=clock.sync_wait_s, refill_wall_s=clock.refill_wall_s,
        device_busy_frac=clock.busy_frac(wall_s),
        seg_schedule=tuple(controller.schedule[:out["n_segments"]]),
        device=dev_name, n_shards=n_shards,
        shard_retired=tuple(int(x) for x in out.get("shard_retired", ())),
        shard_lane_steps=tuple(int(x)
                               for x in out.get("shard_lane_steps", ())),
        redundancy=redundancy,
        detected=out.get("detected", 0), corrected=out.get("corrected", 0),
        quarantined=out.get("quarantined", 0))
    return results, stats


def _stream_host(groups, prefs, counts, ms_of, consts, chunk, keep_state,
                 subset, mem_words, timing,
                 controller: _SuperstepController, clock: _SyncClock,
                 devs, stepper: str):
    """The host-refill stream loop (the reference's `_stream_host`, read
    for read): a blocking done-count read per segment; on a finishing
    segment, pulls of the finished lanes' tallies, a host demux into
    int64 collectors, and an admission that rebuilds the freed lanes.
    The schedule is the single-device one; under a mesh the pool is
    split over the parts' devices and each read spans them all."""
    n_groups = len(groups)
    parts = _parts(devs)
    spc = chunk // len(devs)
    bounds = [(p.s0 * spc, p.s1 * spc) for p in parts]
    r_instr = [np.zeros(n, np.int64) for n in counts]
    r_two = [np.zeros(n, np.int64) for n in counts]
    r_cycles = [np.zeros(n, np.int64) for n in counts]
    r_halt = [np.zeros(n, bool) for n in counts]
    r_out = [np.zeros(n, np.int32) for n in counts]
    r_mix = [np.zeros(N_MIX, np.int64) for _ in groups]
    g_lane_steps = np.zeros(n_groups, np.int64)
    g_segments = np.zeros(n_groups, np.int64)
    r_mem = r_regs = r_pc = r_mix_items = None
    if keep_state:
        r_mem = [np.zeros((n, g.mem_words), np.int32)
                 for n, g in zip(counts, groups)]
        r_regs = [np.zeros((n, 16), np.int32) for n in counts]
        r_pc = [np.zeros(n, np.int32) for n in counts]
        r_mix_items = [np.zeros((n, N_MIX), np.int32) for n in counts]

    cursor = np.zeros(n_groups, np.int64)   # next item per group
    ids = np.full(chunk, -1, np.int64)      # item index within group
    lane_group = np.full(chunk, -1, np.int64)
    lane_ms = np.zeros(chunk, np.int64)     # host copy of budgets

    def admit(states, free_lanes):
        """Backfill `free_lanes` with items from any pending group."""
        take = _apportion(len(free_lanes), counts - cursor)
        n_new = int(take.sum())
        if n_new == 0:
            return states, 0
        new_mems = np.zeros((chunk, mem_words), np.int32)
        new_prog = np.zeros(chunk, np.int32)
        new_ms = np.zeros(chunk, np.int32)
        replace = np.zeros(chunk, bool)
        off = 0
        for g in np.nonzero(take)[0]:
            k = int(take[g])
            lanes = free_lanes[off:off + k]
            off += k
            new_mems[lanes, :groups[g].mem_words] = prefs[g].take(k)
            new_prog[lanes] = g
            new_ms[lanes] = ms_of[g]
            replace[lanes] = True
            ids[lanes] = np.arange(cursor[g], cursor[g] + k)
            lane_group[lanes] = g
            lane_ms[lanes] = ms_of[g]
            cursor[g] += k
        if states is None:
            return (new_mems, replace, new_prog, new_ms), n_new
        return [_refill_packed(
            ps, *(torch.from_numpy(x[lo:hi]).to(p.dev)
                  for x in (replace, new_mems, new_prog, new_ms)))
            for ps, p, (lo, hi) in zip(states, parts, bounds)], n_new

    def pull(get, idx=None) -> np.ndarray:
        """One read of a lane field over every part (lanes `idx` only)."""
        ts = []
        for ps, p, (lo, hi) in zip(states, parts, bounds):
            x = get(ps)
            if idx is not None:
                sel = idx[(idx >= lo) & (idx < hi)] - lo
                x = x[torch.from_numpy(sel).to(p.dev)]
            ts.append(x)
        return clock.fetch(ts)

    # initial fill (padding lanes carry budget 0 and stay parked)
    (first, active0, prog0, ms0), _ = admit(None, np.arange(chunk))
    states = [_fresh_packed(first[lo:hi], active0[lo:hi], prog0[lo:hi],
                            ms0[lo:hi], p.dev)
              for p, (lo, hi) in zip(parts, bounds)]

    prev_instr = np.zeros(chunk, np.int64)
    lane_steps = 0
    n_segments = 0
    expected_done = chunk - int((ids >= 0).sum())
    need_mem = keep_state or any(g.out_addr is not None for g in groups)

    while (ids >= 0).any():
        seg_steps = controller.next_seg()
        states = [_segment(stepper, consts[p.dev], ps, seg_steps, subset,
                           None, None, None, p.dev)
                  for ps, p in zip(states, parts)]
        n_segments += 1
        active = ids >= 0
        act_per_group = np.bincount(lane_group[active], minlength=n_groups)
        g_segments += act_per_group > 0

        # one scalar read: if no lane finished, every active lane ran
        # exactly seg_steps
        done_n = pull(lambda ps: _done_count_packed(ps).reshape(1))
        if int(done_n.sum()) == expected_done:
            lane_steps += chunk * seg_steps
            g_lane_steps += act_per_group * seg_steps
            prev_instr[active] += seg_steps
            controller.record(0, seg_steps)
            continue

        t_harvest = time.perf_counter()
        wait_before = clock.sync_wait_s
        halted = pull(lambda ps: ps.lanes.halted)
        n_instr = pull(lambda ps: ps.lanes.n_instr).astype(np.int64)
        delta = int((n_instr - prev_instr).max(initial=0))
        lane_steps += chunk * delta
        g_lane_steps += act_per_group * delta
        prev_instr = n_instr

        done = active & (halted | (n_instr >= lane_ms))
        idx = np.nonzero(done)[0]
        if idx.size:
            two = pull(lambda ps: ps.lanes.n_two_stage).astype(np.int64)
            mix_rows = pull(lambda ps: ps.lanes.mix, idx).astype(np.int64)
            if timing:
                cyc = pull(lambda ps: ps.lanes.n_cycles).astype(np.int64)
            # one O(done x mem_words) row gather serves every group's
            # out word (and the keep_state memories)
            if need_mem:
                mem_rows = pull(lambda ps: ps.lanes.mem, idx)
            if keep_state:
                regs_rows = pull(lambda ps: ps.lanes.regs, idx)
                pc_rows = pull(lambda ps: ps.lanes.pc)[idx]
            for g in np.unique(lane_group[idx]):
                sel = lane_group[idx] == g
                lg = idx[sel]
                items = ids[lg]
                r_instr[g][items] = n_instr[lg]
                r_two[g][items] = two[lg]
                if timing:
                    r_cycles[g][items] = cyc[lg]
                r_halt[g][items] = halted[lg]
                r_mix[g] += mix_rows[sel].sum(0)
                if groups[g].out_addr is not None:
                    r_out[g][items] = mem_rows[sel][:, groups[g].out_addr]
                if keep_state:
                    r_mem[g][items] = mem_rows[sel][:, :groups[g].mem_words]
                    r_regs[g][items] = regs_rows[sel]
                    r_pc[g][items] = pc_rows[sel]
                    r_mix_items[g][items] = mix_rows[sel]

            # retire done lanes, then backfill from any pending group
            ids[idx] = -1
            lane_group[idx] = -1
            lane_ms[idx] = 0
            states, _ = admit(states, idx)
            # refilled lanes restart at n_instr=0; retired-but-empty
            # lanes keep their frozen counters
            prev_instr[idx] = np.where(ids[idx] >= 0, 0, prev_instr[idx])
        controller.record(int(idx.size), seg_steps)
        # the harvest and rebuild run with the segment finished and
        # nothing queued: device-idle host work, less the transfer time
        # already booked as sync wait
        dt = time.perf_counter() - t_harvest
        clock.refill_wall_s += dt
        clock.idle_s += max(0.0, dt - (clock.sync_wait_s - wait_before))
        expected_done = chunk - int((ids >= 0).sum())

    return {"r_instr": r_instr, "r_two": r_two, "r_halt": r_halt,
            "r_out": r_out, "r_mix": r_mix, "r_mem": r_mem,
            "r_regs": r_regs, "r_pc": r_pc, "r_mix_items": r_mix_items,
            "r_cycles": r_cycles, "g_lane_steps": g_lane_steps,
            "g_segments": g_segments, "lane_steps": lane_steps,
            "n_segments": n_segments}


def run_stream(code: np.ndarray, source: Source, *, n_items: int,
               mem_words: int, max_steps: int, chunk: int = 256,
               seg_steps: int = 4096, out_addr: Optional[int] = None,
               keep_state: bool = False, mesh=None, stepper: str = "pallas",
               subset: Optional[frozenset] = None, prefetch: bool = True,
               refill: str = "device", adaptive: bool = False,
               cost: Optional[np.ndarray] = None, faults=None,
               redundancy: str = "none", max_retries: int = 2,
               device: DeviceLike = None) -> FleetResult:
    """Stream `n_items` memory images of one program from `source`
    through `chunk` lanes: the single-group case of `run_packed` (its
    `stepper`, `mesh` and the rest), with the run's whole-pool
    accounting (lane-step slots, segments, wall clock) folded into the
    returned `FleetResult`."""
    results, stats = run_packed(
        [PackedGroup(code=code, source=source, n_items=n_items,
                     max_steps=max_steps, mem_words=mem_words,
                     out_addr=out_addr, cost=cost)],
        chunk=chunk, seg_steps=seg_steps, keep_state=keep_state,
        mesh=mesh, stepper=stepper, subset=subset, prefetch=prefetch,
        refill=refill, adaptive=adaptive, faults=faults,
        redundancy=redundancy, max_retries=max_retries, device=device)
    return dataclasses.replace(
        results[0], lane_steps=stats.lane_steps,
        n_segments=stats.n_segments, chunk=stats.chunk,
        wall_s=stats.wall_s)


def run_workload_stream(w: Workload, n_items: int, *, seed: int = 0,
                        chunk: int = 256, seg_steps: int = 4096,
                        max_steps: Optional[int] = None,
                        keep_state: bool = False, mesh=None,
                        stepper: str = "pallas",
                        prefetch: bool = True, refill: str = "device",
                        adaptive: bool = False,
                        cost: Optional[np.ndarray] = None,
                        subset: Optional[frozenset] = None, faults=None,
                        redundancy: str = "none", max_retries: int = 2,
                        device: DeviceLike = None) -> FleetResult:
    """Stream one FlexiBench workload end to end (`run_stream` over its
    `workload_source`); `subset` pins the branchless steppers' opcode
    subset, e.g. FlexiLint's reachable-only one."""
    return run_stream(
        w.program.code, workload_source(w, seed), n_items=n_items,
        mem_words=w.total_mem_words,
        max_steps=w.max_steps if max_steps is None else max_steps,
        chunk=chunk, subset=subset, seg_steps=seg_steps,
        out_addr=w.out_addr, keep_state=keep_state, mesh=mesh,
        stepper=stepper, prefetch=prefetch, refill=refill,
        adaptive=adaptive, cost=cost, faults=faults, redundancy=redundancy,
        max_retries=max_retries, device=device)


def _host_buffer(shape, dtype, pin: bool) -> torch.Tensor:
    """A host staging tensor: page-locked when the run is on a card, so
    copies from and to it can run asynchronously."""
    return torch.zeros(shape, dtype=dtype, pin_memory=pin)


def _stream_resident(groups, prefetch, counts, ms_of, consts, chunk,
                     keep_state, subset, mem_words, timing,
                     controller: _SuperstepController, clock: _SyncClock,
                     devs, stepper: str, faults=None, dmr: bool = False,
                     max_retries: int = 2, checkpoint_dir=None,
                     checkpoint_every: int = 0, crash_after=None):
    """The resident stream loop (see the module docstring), shard-local
    over `devs` (one entry per shard). The loop exits after the refill
    that retires the last item; the segment queued behind it finds every
    lane parked and takes no step.

    Shard s owns the item spans `shard_partition` (or, on a resume,
    `_split_spans`) gives it, and a block of `cap` accumulator rows;
    `rowmap` maps a global item row (group g's items from the sum of
    earlier groups' sizes) to `s * cap` plus its shard-local row, the
    reference's layout, which the drain and the checkpoint read. With
    `checkpoint_dir` the loop saves the reference's canonical snapshot
    at the top of an iteration (before the refill) once
    `checkpoint_every` segments have passed, and resumes from the newest
    intact checkpoint there; items done before a resume keep their
    results in the host-side `base` and are merged at the drain.
    """
    n_groups = len(groups)
    total = int(counts.sum())
    slot_base = np.zeros(n_groups, np.int64)
    np.cumsum(counts[:-1], out=slot_base[1:])
    n_shards = len(devs)
    spc = chunk // n_shards          # lanes (and staged rows) per shard
    parts = _parts(devs)
    cuda = devs[0].type == "cuda"

    # ---- host-side merged results: items finished before a resume
    # live here and never get device rows again
    done_mask = np.zeros(total, bool)
    base = {"n_instr": np.zeros(total, np.int64),
            "n_two": np.zeros(total, np.int64),
            "n_cycles": np.zeros(total, np.int64),
            "halted": np.zeros(total, bool),
            "out": np.zeros(total, np.int32)}
    if keep_state:
        base.update(mems=np.zeros((total, mem_words), np.int32),
                    regs=np.zeros((total, 16), np.int32),
                    pc=np.zeros(total, np.int32),
                    mix_items=np.zeros((total, N_MIX), np.int32))
    mix_base = np.zeros((n_groups, N_MIX), np.int64)
    g_lane_steps = np.zeros(n_groups, np.int64)
    g_segments = np.zeros(n_groups, np.int64)
    shard_retired = np.zeros(n_shards, np.int64)
    shard_steps = np.zeros(n_shards, np.int64)
    lane_steps = n_segments = prev_seg = 0
    detected = corrected = quarantined = 0
    n_quar = np.zeros(n_shards, np.int64)         # quarantined pairs

    # ---- resume? (the canonical checkpoint is independent of the shard
    # count and chunk it was written under)
    resume = None
    if checkpoint_dir is not None \
            and dckpt.latest_step(checkpoint_dir) is not None:
        tree, _ = dckpt.restore(
            checkpoint_dir, _resident_ckpt_skeleton(n_groups, keep_state))
        resume = {k: np.asarray(v) for k, v in tree.items()}
        if not np.array_equal(resume["counts"], counts):
            raise ValueError(
                f"checkpoint in {checkpoint_dir} was written for group "
                f"sizes {resume['counts'].tolist()}, plan has "
                f"{counts.tolist()}")
        if int(resume["lane_mem"].shape[1]) != mem_words:
            raise ValueError("checkpoint lane memory width "
                             f"{resume['lane_mem'].shape[1]} != plan "
                             f"mem_words {mem_words}")
        done_mask = resume["done_mask"].astype(bool).copy()
        for k in base:
            base[k] = resume["val_" + k].astype(base[k].dtype).copy()
        mix_base = resume["mix_g"].astype(np.int64).copy()
        lane_steps = int(resume["counters"][0])
        n_segments = int(resume["counters"][1])
        controller.rate = float(resume["ctrl"][0])
        prev_seg = int(resume["ctrl"][1])
        controller.schedule = [int(x) for x in resume["sched"]]
        g_lane_steps = resume["g_lane_steps"].astype(np.int64).copy()
        g_segments = resume["g_segments"].astype(np.int64).copy()
    retired = int(done_mask.sum())

    # ---- the item->shard partition: pending spans, plus the in-flight
    # lanes a resume deals onto the shards (a contiguous balanced deal)
    if resume is None:
        spans = shard_partition(counts, n_shards)
        live = lane_shard = np.zeros(0, np.int64)
        lane_item = None
    else:
        lane_item = resume["lane_item"].astype(np.int64)
        live = np.nonzero(lane_item >= 0)[0]
        if live.size > chunk:
            raise ValueError(
                f"cannot resume {live.size} in-flight lanes onto a "
                f"{chunk}-lane pool ({n_shards} shards x {spc})")
        lane_shard = (np.arange(live.size) * n_shards) // max(live.size, 1)
        pend = resume["pending"].astype(np.int64).reshape(-1, 3)
        spans = [_split_spans([(int(lo), int(hi))
                               for g2, lo, hi in pend if g2 == g], n_shards)
                 for g in range(n_groups)]
    infl_items = [lane_item[live[lane_shard == s]] if resume is not None
                  else np.zeros(0, np.int64) for s in range(n_shards)]

    # ---- shard-local accumulator layout: shard s owns rows
    # [s*cap, (s+1)*cap); rowmap[global item row] -> that row
    pend_n = np.array([[sum(hi - lo for lo, hi in spans[g][s])
                        for s in range(n_shards)]
                       for g in range(n_groups)],
                      np.int64).reshape(n_groups, n_shards)
    infl_n = np.array([x.size for x in infl_items], np.int64)
    cap = int(max(int((infl_n + pend_n.sum(0)).max()), 1))
    rowmap = np.full(total, -1, np.int64)
    lbase = np.zeros((n_shards, n_groups), np.int64)
    for s in range(n_shards):
        rowmap[infl_items[s]] = s * cap + np.arange(infl_n[s])
        off = int(infl_n[s])
        for g in range(n_groups):
            lbase[s, g] = off
            items = slot_base[g] + _span_items(spans[g][s])
            rowmap[items] = s * cap + off + np.arange(items.size)
            off += items.size
    row_owner = np.full(n_shards * cap, -1, np.int64)
    have = np.nonzero(rowmap >= 0)[0]
    row_owner[rowmap[have]] = have

    # ---- per-(group, shard) prefetchers over the pending spans
    sources = [_locked(g.source) for g in groups]
    prefs = [[_Prefetcher(_span_source(sources[g], spans[g][s]),
                          int(pend_n[g, s]),
                          block=max(1, min(spc, int(pend_n[g, s]))),
                          background=prefetch)
              for s in range(n_shards)] for g in range(n_groups)]

    # ---- staged batches: a host mirror in (pinned) tensors, a FIFO per
    # shard, plus each part's device copy of its shards' rows; the mirror
    # is written only after the refill that read the last upload has
    # finished (the stats wait orders that)
    st_host = [_host_buffer((chunk, mem_words), I32, cuda),
               _host_buffer(chunk, I32, cuda), _host_buffer(chunk, I32, cuda),
               _host_buffer(chunk, I32, cuda),
               _host_buffer(n_shards, I32, cuda)]
    st_mems = st_host[0].numpy().reshape(n_shards, spc, mem_words)
    st_prog, st_ms, st_slot = (t.numpy().reshape(n_shards, spc)
                               for t in st_host[1:4])
    st_n = st_host[4].numpy()
    st_dev = [[torch.empty_like(t[p.s0 * spc:p.s1 * spc], device=p.dev)
               for t in st_host[:4]]
              + [torch.empty(p.s1 - p.s0, dtype=I32, device=p.dev)]
              for p in parts]
    staged_cursor = np.zeros((n_groups, n_shards), np.int64)
    dirty = [True]
    # a quarantined pair's item comes back here (group, index, row) and is
    # staged again on its shard, under its own row, ahead of fresh items
    requeue = [[] for _ in range(n_shards)]

    def restock():
        for s in range(n_shards):
            while requeue[s] and int(st_n[s]) < spc:
                g, local, row = requeue[s].pop(0)
                off = int(st_n[s])
                st_mems[s, off] = 0
                st_mems[s, off, :groups[g].mem_words] = np.asarray(
                    sources[g](local, 1), np.int32)[0]
                st_prog[s, off], st_ms[s, off], st_slot[s, off] = \
                    g, ms_of[g], row
                st_n[s] = off + 1
                dirty[0] = True
        for s in range(n_shards):
            free = spc - int(st_n[s])
            remaining = pend_n[:, s] - staged_cursor[:, s]
            if free <= 0 or int(remaining.sum()) == 0:
                continue
            take = _apportion(free, remaining)
            off = int(st_n[s])
            for g in np.nonzero(take)[0]:
                k = int(take[g])
                c = int(staged_cursor[g, s])
                st_mems[s, off:off + k] = 0
                st_mems[s, off:off + k, :groups[g].mem_words] = \
                    prefs[g][s].take(k)
                st_prog[s, off:off + k] = g
                st_ms[s, off:off + k] = ms_of[g]
                st_slot[s, off:off + k] = lbase[s, g] + np.arange(c, c + k)
                staged_cursor[g, s] += k
                off += k
            if off != int(st_n[s]):
                st_n[s] = off
                dirty[0] = True

    def consume(con):
        for s in range(n_shards):
            k, n = int(con[s]), int(st_n[s])
            if k <= 0:
                continue
            for buf in (st_mems, st_prog, st_ms, st_slot):
                buf[s, :n - k] = buf[s, k:n].copy()
            st_n[s] = n - k
            dirty[0] = True

    def upload():
        if dirty[0]:
            for p, bufs in zip(parts, st_dev):
                lo, hi = p.s0 * spc, p.s1 * spc
                for d, h in zip(bufs[:4], st_host[:4]):
                    d.copy_(h[lo:hi], non_blocking=True)
                bufs[4].copy_(st_host[4][p.s0:p.s1], non_blocking=True)
            dirty[0] = False

    # ---- device state per part: an all-parked lane pool and the
    # accumulators; a resume seats each shard's dealt lanes at the head
    # of its lane block, on the first rows of its accumulator block
    states, slots, accs = [], [], []
    for p in parts:
        n = (p.s1 - p.s0) * spc
        states.append(iss.PackedState(
            lanes=iss.fresh_lanes(torch.zeros((n, mem_words), dtype=I32,
                                              device=p.dev))._replace(
                halted=torch.ones(n, dtype=torch.bool, device=p.dev)),
            prog_id=torch.zeros(n, dtype=I32, device=p.dev),
            max_steps=torch.zeros(n, dtype=I32, device=p.dev)))
        slots.append(torch.full((n,), -1, dtype=I32, device=p.dev))
        accs.append(_fresh_acc(p.s1 - p.s0, cap, n, n_groups, mem_words,
                               keep_state, p.dev))
    for p, ps, slot, acc in zip(parts, states, slots, accs):
        for s in range(p.s0, p.s1):
            old = live[lane_shard == s]
            if not old.size:
                continue
            pos = slice((s - p.s0) * spc, (s - p.s0) * spc + old.size)
            ln = ps.lanes
            for t, key in ((ln.regs, "regs"), (ln.pc, "pc"), (ln.mem, "mem"),
                           (ln.halted, "halted"), (ln.n_instr, "n_instr"),
                           (ln.n_two_stage, "n_two"), (ln.mix, "mix"),
                           (ln.n_cycles, "n_cycles"), (ps.prog_id, "prog"),
                           (ps.max_steps, "ms")):
                t[pos] = torch.as_tensor(resume["lane_" + key][old],
                                         dtype=t.dtype).to(p.dev)
            slot[pos] = torch.arange(old.size, dtype=I32, device=p.dev)
            acc.prev_instr[pos] = torch.as_tensor(
                resume["lane_prev"][old], dtype=I32).to(p.dev)
    # resilience state: per-lane fault keys and epochs; per-pair mismatch
    # counts and quarantine flags; the rollback snapshot of the lanes
    keys = None if faults is None else flexifault.lane_keys_tensor(
        faults.seed, chunk, devs[0])
    lane_keys, epochs, retries, quars, snaps = [], [], [], [], []
    for p, ps in zip(parts, states):
        n = (p.s1 - p.s0) * spc
        lane_keys.append(None if keys is None else
                         keys[p.s0 * spc:p.s1 * spc].to(p.dev))
        epochs.append(torch.zeros(n, dtype=I32, device=p.dev)
                      if faults is not None or dmr else None)
        retries.append(torch.zeros(n // 2, dtype=I32, device=p.dev)
                       if dmr else None)
        quars.append(torch.zeros(n // 2, dtype=torch.bool, device=p.dev)
                     if dmr else None)
        snaps.append(iss.ISSState(*(x.clone() for x in ps.lanes))
                     if dmr else None)
    n_head = 6 if dmr else 3
    stats_host = _host_buffer((n_shards, n_head + n_groups), I32, cuda)
    stats_ev = [torch.cuda.Event() for _ in parts] if cuda else []
    seg_ev = [torch.cuda.Event() for _ in parts] if cuda else []

    def acc_rows(name: str) -> np.ndarray:
        """One read of a per-item leaf over every part, in the canonical
        `n_shards * cap` row order (each shard's discard row dropped)."""
        v = clock.fetch([getattr(a, name) for a in accs])
        v = v.reshape((n_shards, cap + 1) + v.shape[1:])[:, :cap]
        return v.reshape((n_shards * cap,) + v.shape[2:])

    def merged_vals(accv):
        """Per-item results: the host `base` where done before a resume,
        else the item's accumulator row through the item->row table."""
        idx = np.clip(rowmap, 0, None)
        out = {}
        for k, b in base.items():
            v = accv[k][idx].astype(b.dtype)
            mask = done_mask if b.ndim == 1 else done_mask[:, None]
            out[k] = np.where(mask, b, v)
        return out

    def save_checkpoint():
        """The canonical snapshot at a refill boundary: (state,
        item_slot, acc) are the inputs the next refill would see, and
        staged but unconsumed items go back into the pending spans
        (never stepped, so staging them again after a resume is
        bit-exact)."""
        accv = {k: acc_rows(k) for k in base}
        slot_h = clock.fetch(slots).astype(np.int64)
        prev_h = clock.fetch([a.prev_instr for a in accs])
        mix_now = mix_base + clock.fetch(
            [a.mix_g for a in accs]).astype(np.int64).sum(0)
        merged = merged_vals(accv)
        # global item of each in-flight lane, through the row table
        lane_rows = (np.arange(chunk) // spc) * cap + slot_h
        lane_item_now = np.where(
            slot_h >= 0,
            row_owner[np.clip(lane_rows, 0, n_shards * cap - 1)], -1)
        # pending = staged but unconsumed + not yet staged
        pend_now = [[] for _ in range(n_groups)]
        for s in range(n_shards):
            k = int(st_n[s])
            if k:
                sitems = row_owner[s * cap + st_slot[s, :k].astype(np.int64)]
                for g in range(n_groups):
                    pend_now[g].append(sitems[st_prog[s, :k] == g]
                                       - slot_base[g])
            for g in range(n_groups):
                rest = _span_items(spans[g][s])
                pend_now[g].append(rest[int(staged_cursor[g, s]):])
        prows = []
        for g in range(n_groups):
            items = np.sort(np.concatenate([np.zeros(0, np.int64)]
                                           + pend_now[g]))
            prows += [(g, lo, hi) for lo, hi in _items_to_spans(items)]
        done_now = np.ones(total, bool)
        done_now[lane_item_now[lane_item_now >= 0]] = False
        for g, lo, hi in prows:
            done_now[slot_base[g] + lo:slot_base[g] + hi] = False
        tree = {"counts": counts.copy(), "done_mask": done_now,
                "mix_g": mix_now, "lane_item": lane_item_now,
                "lane_prev": prev_h,
                "pending": np.asarray(prows, np.int64).reshape(-1, 3),
                "counters": np.array([lane_steps, n_segments], np.int64),
                "ctrl": np.array([controller.rate, prev_seg], np.float64),
                "sched": np.array(controller.schedule, np.int64),
                "g_lane_steps": g_lane_steps.copy(),
                "g_segments": g_segments.copy()}
        tree.update({"val_" + k: v for k, v in merged.items()})
        for key, get in (("regs", lambda ps: ps.lanes.regs),
                         ("pc", lambda ps: ps.lanes.pc),
                         ("mem", lambda ps: ps.lanes.mem),
                         ("halted", lambda ps: ps.lanes.halted),
                         ("n_instr", lambda ps: ps.lanes.n_instr),
                         ("n_two", lambda ps: ps.lanes.n_two_stage),
                         ("mix", lambda ps: ps.lanes.mix),
                         ("n_cycles", lambda ps: ps.lanes.n_cycles),
                         ("prog", lambda ps: ps.prog_id),
                         ("ms", lambda ps: ps.max_steps)):
            tree["lane_" + key] = clock.fetch([get(ps) for ps in states])
        dckpt.save(checkpoint_dir, n_segments, tree)

    last_saved = n_segments
    try:
        restock()
        while retired < total:
            if crash_after is not None and n_segments >= crash_after:
                raise InjectedFault(
                    f"injected fault after segment {n_segments}")
            if checkpoint_dir is not None and checkpoint_every > 0 \
                    and n_segments - last_saved >= checkpoint_every:
                save_checkpoint()
                last_saved = n_segments
            upload()
            seg_steps = controller.next_seg()
            for i, p in enumerate(parts):
                if dmr:
                    (states[i], slots[i], epochs[i], retries[i], quars[i],
                     accs[i], stats) = retire_refill_dmr(
                        states[i], slots[i], epochs[i], retries[i],
                        quars[i], snaps[i], accs[i], *st_dev[i][:4],
                        st_dev[i][4], consts[p.dev]["out_addr"], n_groups,
                        max_retries, device=p.dev)
                    # the refreshed boundary state is the next rollback
                    # point
                    for x, y in zip(snaps[i], states[i].lanes):
                        x.copy_(y)
                else:
                    old_slot = slots[i]
                    states[i], slots[i], accs[i], stats = retire_refill(
                        states[i], slots[i], accs[i], *st_dev[i][:4],
                        st_dev[i][4], consts[p.dev]["out_addr"], n_groups,
                        device=p.dev)
                    if epochs[i] is not None:
                        # a lane that takes a fresh item draws a fresh
                        # schedule (draws key on (lane, epoch, n_instr))
                        epochs[i] += ((slots[i] != old_slot)
                                      & (slots[i] >= 0)).to(I32)
                # the stats copy is queued right behind the refill, ahead
                # of the segment, so waiting for it does not wait for the
                # segment
                stats_host[p.s0:p.s1].view(-1).copy_(stats,
                                                     non_blocking=True)
                if cuda:
                    stats_ev[i].record(torch.cuda.current_stream(p.dev))
                states[i] = _segment(stepper, consts[p.dev], states[i],
                                     seg_steps, subset, faults,
                                     lane_keys[i], epochs[i], p.dev)
                if cuda:
                    seg_ev[i].record(torch.cuda.current_stream(p.dev))
            clock.wait(stats_ev)
            sv = stats_host.numpy().astype(np.int64)
            if dmr:
                detected += int(sv[:, 3].sum())
                corrected += int(sv[:, 4].sum())
                for s in np.nonzero(sv[:, 5] >= 0)[0]:
                    # quarantined pair: map its row back to the item and
                    # hand it to its shard's restock
                    q = int(sv[s, 5])
                    item = int(row_owner[int(s) * cap + q])
                    g = int(np.searchsorted(slot_base, item,
                                            side="right") - 1)
                    requeue[int(s)].append((g, item - int(slot_base[g]), q))
                    quarantined += 1
                    n_quar[s] += 1
                    if n_quar[s] >= spc // 2:
                        raise RuntimeError(
                            f"DMR pool starved: all {spc // 2} lane "
                            f"pair(s) of shard {int(s)} are quarantined "
                            f"with items still pending — raise chunk, "
                            f"raise max_retries, or fix the fault rate")
            act_s, deltas = sv[:, n_head:], sv[:, 2]
            sh_act = act_s.sum(1) > 0
            if sh_act.any():
                n_segments += 1
                g_segments += act_s.sum(0) > 0
                g_lane_steps += (act_s * deltas[:, None]).sum(0)
                stepped = spc * deltas * sh_act
                lane_steps += int(stepped.sum())
                shard_steps += stepped
            n_ret = int(sv[:, 0].sum())
            controller.record(n_ret, prev_seg)
            prev_seg = seg_steps
            retired += n_ret
            shard_retired += sv[:, 0]
            t_refill = time.perf_counter()
            consume(sv[:, 1])
            restock()
            dt = time.perf_counter() - t_refill
            clock.refill_wall_s += dt
            if all(ev.query() for ev in seg_ev):   # segments already done:
                clock.idle_s += dt                 # the restock was idle
    finally:
        for row in prefs:
            for p in row:
                p.close()

    # ---- drain: one read of each accumulator, merged with the host
    # base of the items done before a resume
    accv = {"n_instr": acc_rows("n_instr"), "n_two": acc_rows("n_two")}
    accv["n_cycles"] = acc_rows("n_cycles") if timing \
        else np.zeros(n_shards * cap, np.int64)
    accv["halted"] = acc_rows("halted")
    accv["out"] = acc_rows("out")
    mix_g = mix_base + clock.fetch([a.mix_g for a in accs]).astype(
        np.int64).sum(0)
    if keep_state:
        for k in ("mems", "regs", "pc", "mix_items"):
            accv[k] = acc_rows(k)
    merged = merged_vals(accv)

    res = {k: [] for k in ("r_instr", "r_two", "r_cycles", "r_halt", "r_out",
                           "r_mix", "r_mem", "r_regs", "r_pc",
                           "r_mix_items")}
    for g, grp in enumerate(groups):
        sl = slice(int(slot_base[g]), int(slot_base[g] + counts[g]))
        res["r_instr"].append(merged["n_instr"][sl].astype(np.int64))
        res["r_two"].append(merged["n_two"][sl].astype(np.int64))
        res["r_cycles"].append(merged["n_cycles"][sl].astype(np.int64))
        res["r_halt"].append(merged["halted"][sl])
        res["r_out"].append(merged["out"][sl])
        res["r_mix"].append(mix_g[g])
        if keep_state:
            res["r_mem"].append(merged["mems"][sl, :grp.mem_words].copy())
            res["r_regs"].append(merged["regs"][sl])
            res["r_pc"].append(merged["pc"][sl])
            res["r_mix_items"].append(merged["mix_items"][sl])
    res.update(g_lane_steps=g_lane_steps, g_segments=g_segments,
               lane_steps=lane_steps, n_segments=n_segments,
               n_shards=n_shards, shard_retired=shard_retired.tolist(),
               shard_lane_steps=shard_steps.tolist(), detected=detected,
               corrected=corrected, quarantined=quarantined)
    return res
