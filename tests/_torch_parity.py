"""Shared inputs and comparisons for the port's parity tests.

Everything here is numpy plus the port's own copies of the ISA and the
FlexiBench workloads, so the card's tests (which run where JAX is not
installed) can use it too. The reference is reached only inside the
`ref_*` functions, which import it on call.

States are `PackedState`s of numpy arrays in the reference's layout;
`repro_torch.convert` carries them onto the port's tensors and back.
"""
from __future__ import annotations

import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.flexibench.base import all_workloads
from repro_torch.flexibits import isa
from repro_torch.flexibits.cycles import CORES, MIX_CLASSES, cost_row
from repro_torch.flexibits.iss import ISSState, PackedState, pack_programs

N_MIX = len(MIX_CLASSES)
EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"


def spoilage_memory(algo, x) -> np.ndarray:
    """(n, words) memory images of a Fig. 6 spoilage variant: its ROM
    under `mem_words` of RAM, one input of `x` at word 0 of each, as
    benchmarks/spoilage.py lays them."""
    p = algo.program
    words = p.ro_base // 4 + len(p.ro_words) + max(algo.mem_words, 64)
    mems = np.repeat(p.initial_memory(words)[None], len(x), 0)
    mems[:, :x.shape[1]] = x
    return mems


class RoutesRecorded:
    """While entered, records every `repro_torch.models.moe.router_topk`
    call's top-k indices (`idx`: (tokens, k) tensors, on their device):
    the MoE routes of a run, which the port does not otherwise return."""

    def __enter__(self):
        from repro_torch.models import moe
        self.idx, self._moe, self._fn = [], moe, moe.router_topk

        def keep(logits, mcfg):
            out = self._fn(logits, mcfg)
            self.idx.append(out[1])
            return out
        moe.router_topk = keep
        return self

    def __exit__(self, *exc):
        self._moe.router_topk = self._fn


def load_example(name: str):
    """`examples/<name>.py` as a module (the examples are scripts, not a
    package), so a test or chip_smoke.py can call its `main(argv)`."""
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
_OPCODES = (isa.OP_LUI, isa.OP_AUIPC, isa.OP_JAL, isa.OP_JALR,
            isa.OP_BRANCH, isa.OP_LOAD, isa.OP_STORE, isa.OP_IMM,
            isa.OP_REG, isa.OP_SYSTEM)
_MEM_OPS = ("lb", "lh", "lw", "lbu", "lhu", "sb", "sh", "sw")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain path steps small tensors, where torch's intra-op
    threads cost more than they give (and the suite runs in parallel
    worker processes): one thread while a module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_word(rng, mem_words: int) -> int:
    """One instruction word: mostly an encoded RV32E instruction with
    random fields, sometimes a word whose opcode is RV32E but whose other
    bits are random (odd f3/f7: never-taken branches, clipped load and
    store widths), rarely an opcode outside RV32E."""
    r = rng.random()
    if r < 0.3:
        op = int(rng.choice(_OPCODES[:-1]))   # no SYSTEM: halt rarely
        return op | int(rng.integers(0, 1 << 25)) << 7
    if r < 0.33:
        op = int(rng.integers(0, 128))
        while op in _OPCODES:
            op = int(rng.integers(0, 128))
        return op | int(rng.integers(0, 1 << 25)) << 7
    name = str(rng.choice(isa.ALL_OPS))
    while name in ("ecall", "ebreak") and rng.random() < 0.8:
        name = str(rng.choice(isa.ALL_OPS))   # halt rarely: longer runs
    rd, rs1, rs2 = (int(x) for x in rng.integers(0, 16, 3))
    imm = int(rng.integers(-2048, 2048))
    if name in isa.SHIFT_OPS:
        imm = int(rng.integers(0, 32))
    elif name in isa.B_OPS or name == "jal":
        imm = int(rng.integers(-16, 16)) * 4
    elif name in ("lui", "auipc"):
        imm = int(rng.integers(0, 1 << 20))
    elif name in _MEM_OPS:
        imm = int(rng.integers(0, mem_words * 4 + 64))
    return isa.encode(name, rd=rd, rs1=rs1, rs2=rs2, imm=imm) & 0xFFFFFFFF


def soup_bank(rng, n_progs: int, length: int, mem_words: int):
    """A bank of random programs of 1..length words: (bank, code_len)."""
    progs = [np.array([random_word(rng, mem_words)
                       for _ in range(int(rng.integers(1, length + 1)))],
                      np.uint32) for _ in range(n_progs)]
    return pack_programs(progs)


def soup_state(rng, n_lanes: int, mem_words: int, n_progs: int,
               max_steps: int = 1 << 30) -> PackedState:
    """Random lanes: registers biased toward small non-negative values
    (memory addresses in and just past range), random memory, random
    program rows and a few parked lanes."""
    regs = rng.integers(-2**31, 2**31, (n_lanes, 16)).astype(np.int64)
    small = rng.random((n_lanes, 16)) < 0.7
    regs = np.where(small, np.abs(regs) % (mem_words * 8), regs)
    regs[:, 0] = 0
    z = np.zeros(n_lanes, np.int32)
    return PackedState(
        lanes=ISSState(
            regs=regs.astype(np.int32),
            pc=z.copy(),
            mem=rng.integers(-2**31, 2**31, (n_lanes, mem_words)
                             ).astype(np.int32),
            halted=rng.random(n_lanes) < 0.1,
            n_instr=z.copy(), n_two_stage=z.copy(),
            mix=np.zeros((n_lanes, N_MIX), np.int32),
            n_cycles=z.copy()),
        prog_id=rng.integers(0, n_progs, n_lanes).astype(np.int32),
        max_steps=np.full(n_lanes, max_steps, np.int32))


def soup_cost(rng, n_progs: int) -> np.ndarray:
    """Random non-negative cost rows (every entry exercised)."""
    return rng.integers(0, 200, (n_progs, 19)).astype(np.int32)


def workload_pool(n_lanes: int, seed: int = 0):
    """A pool running all 11 FlexiBench workloads, lane i on workload
    i % 11, each on its inputs drawn from `seed`; memory padded to the
    largest workload's. Returns (bank, code_len, mem_len, cost, state)
    with `dynamic` cost rows of SERV, QERV and HERV in turn."""
    ws = all_workloads()
    bank, clen = pack_programs([w.program.code for w in ws])
    mlen = np.array([w.total_mem_words for w in ws], np.int32)
    cores = [CORES[c] for c in ("SERV", "QERV", "HERV")]
    cost = np.stack([cost_row(cores[i % 3], dynamic=True)
                     for i in range(len(ws))]).astype(np.int32)
    mem_words = int(mlen.max())
    pids = (np.arange(n_lanes) % len(ws)).astype(np.int32)
    mems = np.zeros((n_lanes, mem_words), np.int32)
    for i, p in enumerate(pids):
        w = ws[p]
        x = w.gen_inputs(np.random.default_rng([seed, i]), 1)[0]
        m = w.initial_memory(x)
        mems[i, :len(m)] = m
    z = np.zeros(n_lanes, np.int32)
    state = PackedState(
        lanes=ISSState(regs=np.zeros((n_lanes, 16), np.int32), pc=z.copy(),
                       mem=mems, halted=np.zeros(n_lanes, bool),
                       n_instr=z.copy(), n_two_stage=z.copy(),
                       mix=np.zeros((n_lanes, N_MIX), np.int32),
                       n_cycles=z.copy()),
        prog_id=pids,
        max_steps=np.array([ws[p].max_steps for p in pids], np.int32))
    return bank, clen, mlen, cost, state


def edge_program(m: int):
    """Loads and stores at word m - 1 (inside), at word m (a load clamps,
    a store drops) and at negative word indices (a load reads word 0, a
    store drops), in every width, then a halt. m <= 400 keeps every
    address in a 12-bit immediate."""
    e = isa.encode
    words = [e("addi", rd=1, rs1=0, imm=4 * (m - 1)),
             e("addi", rd=5, rs1=0, imm=-1234),
             e("addi", rd=2, rs1=0, imm=-4),
             e("sw", rs1=1, rs2=5, imm=0),          # word m - 1
             e("lw", rd=6, rs1=1, imm=0),
             e("sb", rs1=1, rs2=5, imm=4),          # word m: dropped
             e("sh", rs1=1, rs2=5, imm=6),
             e("lw", rd=7, rs1=1, imm=4),           # clamps to m - 1
             e("lbu", rd=8, rs1=1, imm=7),
             e("sw", rs1=2, rs2=5, imm=0),          # word -1: dropped
             e("sb", rs1=2, rs2=6, imm=-5),
             e("lh", rd=9, rs1=2, imm=2),           # word -1 -> word 0
             e("lb", rd=10, rs1=0, imm=-3),
             e("sh", rs1=1, rs2=9, imm=2),          # word m - 1, high half
             e("lhu", rd=11, rs1=1, imm=2),
             e("ecall")]
    return np.array(words, np.uint32)


def edge_soup(rng, n_lanes: int, mem_words: int):
    """Random programs and the edge programs in one bank, with mixed
    mem_len (one program at the pool's full width), random lanes, some
    halted and some past their budget. Returns (bank, code_len, mem_len,
    state)."""
    soup = [np.asarray(c).view(np.uint32)
            for c in (soup_bank(rng, 1, 24, mem_words)[0][0]
                      for _ in range(4))]
    mlen = np.concatenate([rng.integers(8, mem_words + 1, 4),
                           [mem_words, 9, 33, 40, 1]]).astype(np.int32)
    progs = soup + [edge_program(int(m)) for m in mlen[4:]]
    bank, clen = pack_programs(progs)
    st = soup_state(rng, n_lanes, mem_words, len(progs))
    ms = rng.integers(0, 200, n_lanes).astype(np.int32)
    ms[rng.random(n_lanes) < 0.5] = 1 << 30
    return bank, clen, mlen, st._replace(max_steps=ms)


def parked_workload_pool(n_lanes: int, seed: int):
    """`workload_pool` with about a fifth of its lanes halted and a fifth
    at a zero budget: lanes a segment must leave as they are."""
    bank, clen, mlen, cost, st = workload_pool(n_lanes, seed=seed)
    rng = np.random.default_rng(seed)
    ln = st.lanes
    st = st._replace(
        lanes=ln._replace(halted=ln.halted | (rng.random(n_lanes) < 0.2)),
        max_steps=np.where(rng.random(n_lanes) < 0.2, 0, st.max_steps))
    return bank, clen, mlen, cost, st


def skew_program():
    """Counting loop: iterates mem[0] times, stores the count at mem[1]
    (the program of `benchmarks/fleet.py::skew_program`, built with the
    port's assembler)."""
    from repro_torch.flexibits.asm import Asm
    a = Asm(vm_reserved=32)
    a.lw(a.t0, a.zero, 0)
    a.li(a.t1, 0)
    a.label("loop")
    a.addi(a.t1, a.t1, 1)
    a.blt(a.t1, a.t0, "loop")
    a.sw(a.t1, a.zero, 4)
    a.halt()
    return a.assemble()


def skew_mems(prog, n_items: int, short_iters: int, long_iters: int,
              long_frac: float, seed: int) -> np.ndarray:
    """Memory images with a skewed halt-time distribution (the idiom of
    `benchmarks/fleet.py::skew_fleet`)."""
    rng = np.random.default_rng(seed)
    iters = np.where(rng.random(n_items) < long_frac, long_iters,
                     short_iters).astype(np.int32)
    mems = np.tile(prog.initial_memory(32), (n_items, 1))
    mems[:, 0] = iters
    return mems


def skew_groups(mod, max_steps_b: int = 200):
    """Two groups of the skew program with 40 and 24 items (the resident
    tests' plan); group b's budget cuts its long items off, so its items
    end by budget, not by halting. `mod` is the engine module (the
    reference's or the port's) whose PackedGroup/array_source to use."""
    prog = skew_program()
    mems_a = skew_mems(prog, 40, 8, 400, 0.2, 13)
    mems_b = skew_mems(prog, 24, 16, 300, 0.3, 14)
    return [
        mod.PackedGroup(code=prog.code, source=mod.array_source(mems_a),
                        n_items=40, max_steps=100_000, mem_words=32,
                        out_addr=1),
        mod.PackedGroup(code=prog.code, source=mod.array_source(mems_b),
                        n_items=24, max_steps=max_steps_b, mem_words=32,
                        out_addr=1),
    ]


RESULT_FIELDS = ("n_instr", "n_two_stage", "halted", "out", "mix", "mems",
                 "regs", "pc", "mix_items", "n_cycles")


def assert_results_equal(refs, gots, ctx: str = "") -> None:
    """Per-group FleetResults: every per-item field and the final state."""
    for g, (a, b) in enumerate(zip(refs, gots)):
        assert a.n_items == b.n_items
        for f in RESULT_FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f"{ctx} group {g}: {f}"
            if x is not None:
                np.testing.assert_array_equal(
                    np.asarray(x), np.asarray(y),
                    err_msg=f"{ctx} group {g}: {f}")


def assert_packed_equal(a, b, ctx: str = "") -> None:
    """Every field of two PackedStates (numpy or array-likes) equal."""
    for f in ISSState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(a.lanes, f)),
                                      np.asarray(getattr(b.lanes, f)),
                                      err_msg=f"{ctx}: lanes.{f}")
    for f in ("prog_id", "max_steps"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)),
                                      err_msg=f"{ctx}: {f}")


@functools.lru_cache(maxsize=None)
def _ref_segment_fn(kind: str, seg_steps: int, subset, timing: bool,
                    faults=None):
    import jax
    from repro.flexibits import iss as riss
    from repro.kernels.iss_stepper import iss_segment_banked

    def seg(bank, clen, ps, mem_len, cost, lane_key, epoch):
        cost = cost if timing else None
        kw = {} if faults is None else dict(faults=faults, lane_key=lane_key,
                                            epoch=epoch)
        if kind == "xla":
            return riss.run_segment_lanes_banked(bank, clen, ps, seg_steps,
                                                 subset, mem_len, cost, **kw)
        return iss_segment_banked(bank, clen, ps, seg_steps=seg_steps,
                                  subset=subset, mem_len=mem_len, cost=cost,
                                  **kw)
    return jax.jit(seg)


def ref_segment(kind: str, bank, clen, state: PackedState, seg_steps: int,
                mem_len, cost=None, subset=None, faults=None, lane_key=None,
                epoch=None) -> PackedState:
    """One segment of the reference: its XLA stepper
    (`iss.run_segment_lanes_banked`, kind="xla") or its Pallas kernel in
    interpret mode (`iss_stepper.iss_segment_banked`, kind="pallas").
    numpy in, numpy out; `cost=None` turns the tick tally off; `faults`
    is a reference `FaultSpec`, with per-lane uint32 `lane_key` and int32
    `epoch` arrays."""
    import jax.numpy as jnp
    from repro.flexibits import iss as riss

    ps = riss.PackedState(
        lanes=riss.ISSState(*(jnp.asarray(x) for x in state.lanes)),
        prog_id=jnp.asarray(state.prog_id),
        max_steps=jnp.asarray(state.max_steps))
    timing = cost is not None
    co = jnp.asarray(cost if timing else np.zeros((len(clen), 19), np.int32))
    n = len(state.prog_id)
    key = jnp.asarray(np.zeros(n, np.uint32) if lane_key is None
                      else np.asarray(lane_key).view(np.uint32))
    ep = jnp.asarray(np.zeros(n, np.int32) if epoch is None
                     else np.asarray(epoch, np.int32))
    fn = _ref_segment_fn(kind, seg_steps,
                         None if subset is None else frozenset(subset),
                         timing, faults)
    out = fn(jnp.asarray(bank), jnp.asarray(clen), ps, jnp.asarray(mem_len),
             co, key, ep)
    return PackedState(
        lanes=ISSState(*(np.asarray(x) for x in out.lanes)),
        prog_id=np.asarray(out.prog_id), max_steps=np.asarray(out.max_steps))


# ------------------------------------------------------- carbon sweep
# Tolerances of the sweep comparisons, each with its reason:
# - everything but the per-cell sums is held bit for bit;
# - a per-cell sum over N draws follows no fixed order (XLA's, torch's
#   and the kernel's tree differ), and any two orders of N non-negative
#   terms differ by a relative 2 (N - 1) u at most; a mean divides that
#   sum by N and `fleet_mean` multiplies it by the volume, two more
#   roundings of u / 2 on each side: 2 (N + 1) u;
# - log10 differs by a few ulp between XLA, torch on the CPU and CUDA, so
#   a value whose scaled log10 lies within EDGE of an interior bin edge
#   may land in the neighbouring bin; the comparisons count such values
#   and allow exactly those moves, and none where there are none.
TILE_SUM_FIELDS = ("sum_best", "sum_emb", "sum_op")
RESULT_SUM_FIELDS = ("mean", "mean_emb", "mean_op", "fleet_mean")
RESULT_EXACT_FIELDS = ("p50", "p90", "p99", "min", "max", "counts")
EDGE = 1e-4


def unit_roundoff(dtype) -> float:
    return 2.0 ** -53 if np.dtype(dtype) == np.float64 else 2.0 ** -24


def assert_rel_close(a, b, rel: float, what: str) -> float:
    """|a - b| <= rel * max(|a|, |b|) elementwise (equal infinities and
    NaNs pass); returns the largest relative difference seen."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    den = np.maximum(np.abs(a), np.abs(b))
    with np.errstate(invalid="ignore", divide="ignore"):
        r = np.where(same, 0.0, np.abs(a - b) / den)
    worst = float(np.nanmax(r)) if r.size else 0.0
    assert not np.isnan(r).any() and worst <= rel, \
        f"{what}: relative difference {worst:.3g} > {rel:.3g}"
    return worst


def near_edges(x, lo: float, inv: float, n_bins: int, dtype):
    """Interior bin edges (1..n_bins-1) that some finite value of `x`
    lies within EDGE of, in the scaled log10 computed in float64 with
    `lo`/`inv` rounded to the sweep's dtype as the kernel rounds them."""
    x = np.asarray(x, np.float64).ravel()
    x = x[np.isfinite(x) & (x > 0)]
    lo, inv = float(np.asarray(lo, dtype)), float(np.asarray(inv, dtype))
    s = (np.log10(x) - lo) * inv
    e = np.rint(s)
    hit = (np.abs(s - e) < EDGE) & (e >= 1) & (e <= n_bins - 1)
    return e[hit].astype(np.int64)


def assert_hist_equal(ha, hb, edges, what: str) -> None:
    """Histograms equal, up to one move across an edge per value that
    lies at one."""
    diff = np.abs(np.asarray(ha, np.int64) - np.asarray(hb, np.int64))
    assert diff.sum() <= 2 * len(edges), \
        f"{what}: histograms differ by {diff.sum()} counts, " \
        f"{len(edges)} values lie at a bin edge"
    assert np.asarray(ha).sum() == np.asarray(hb).sum(), what


def assert_pareto_equal(pa, pb, edges, what: str) -> None:
    """The six per-bin Pareto fields equal, except in the two bins beside
    an edge that some champion's embodied kg lies at. `pa`, `pb` map
    field -> array (SweepResult.pareto) or are SweepAcc-ordered tuples."""
    if not isinstance(pa, dict):
        pa = dict(zip(PAR_FIELDS, list(pa)[1:]))
        pb = dict(zip(PAR_FIELDS, list(pb)[1:]))
    n = len(pa["op"])
    free = np.zeros(n, bool)
    for e in edges:
        free[max(e - 1, 0):min(e + 1, n)] = True
    for k in PAR_FIELDS:
        np.testing.assert_array_equal(np.asarray(pa[k])[~free],
                                      np.asarray(pb[k])[~free],
                                      err_msg=f"{what}: pareto {k}")


PAR_FIELDS = ("op", "emb", "life", "cell", "draw", "core")


def tile_inputs(rng, n_cells: int, n_draws: int, n_cand: int, dtype,
                *, inf_cells: int = 0, invalid_frac: float = 0.2,
                ties: bool = False, cell0: int = 0):
    """Numpy inputs of one sweep tile (the idiom of the reference's
    `tests/test_sweep.py::test_pallas_row_tiles_bit_exact`): embodied kg,
    intensity-1 operational anchors, intensities, frequencies and
    lifetimes in days. `inf_cells` cells get some +inf lifetimes,
    `ties` makes candidate pairs identical (exact argmin ties), and
    `cell0` offsets the global cell indices."""
    emb = rng.uniform(1e-4, 1e-2, (n_cells, n_cand))
    kwh = rng.uniform(1e-9, 1e-6, (n_cells, n_cand))
    if ties:
        emb[:, 1::2] = emb[:, 0:n_cand - 1:2][:, :emb[:, 1::2].shape[1]]
        kwh[:, 1::2] = kwh[:, 0:n_cand - 1:2][:, :kwh[:, 1::2].shape[1]]
    life = rng.uniform(1, 4000, (n_cells, n_draws))
    for c in range(min(inf_cells, n_cells)):
        life[c, rng.random(n_draws) < 0.5] = np.inf
    return dict(
        emb=emb.astype(dtype), kwh=kwh.astype(dtype),
        inten=rng.uniform(0.01, 1.1, n_cells).astype(dtype),
        freq=rng.uniform(0.5, 100, n_cells).astype(dtype),
        life_days=life.astype(dtype),
        valid=rng.random(n_cells) >= invalid_frac,
        cell_idx=np.arange(cell0, cell0 + n_cells, dtype=np.int32))


TILE_KW = dict(hist_lo=-4.0, hist_inv=12.8, par_lo=-4.0, par_inv=6.4)


def assert_tiles_equal(out_a, out_b, n_draws: int, dtype, what: str
                       ) -> float:
    """Two TileOuts (numpy): every field bit for bit but the sums, which
    hold to 2 (N - 1) u. Returns the largest relative sum difference."""
    worst = 0.0
    for f in out_a._fields:
        a, b = np.asarray(getattr(out_a, f)), np.asarray(getattr(out_b, f))
        if f in TILE_SUM_FIELDS:
            worst = max(worst, assert_rel_close(
                a, b, 2 * (n_draws - 1) * unit_roundoff(dtype),
                f"{what}: {f}"))
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{what}: {f}")
    return worst


def assert_sweeps_equal(ra, rb, tables, best_totals, embs, what: str
                        ) -> float:
    """Two SweepResults: the percentiles, min, max and counts bit for bit,
    the means to 2 (N + 1) u, the histogram and the Pareto bins with the
    bin-edge allowance of the best totals and candidate embodied kg that
    the sweep's valid cells saw (`best_totals`, `embs`), binned by
    `tables` (hist_lo/hist_inv/par_lo/par_inv). Returns the largest
    relative difference of the means."""
    dtype = ra.mean.dtype
    n = ra.spec.draws
    for f in RESULT_EXACT_FIELDS:
        np.testing.assert_array_equal(getattr(ra, f), getattr(rb, f),
                                      err_msg=f"{what}: {f}")
    worst = 0.0
    for f in RESULT_SUM_FIELDS:
        worst = max(worst, assert_rel_close(
            getattr(ra, f), getattr(rb, f),
            2 * (n + 1) * unit_roundoff(dtype), f"{what}: {f}"))
    assert_hist_equal(ra.hist, rb.hist, near_edges(
        best_totals, tables.hist_lo, tables.hist_inv, len(ra.hist), dtype),
        what)
    assert_pareto_equal(ra.pareto, rb.pareto, near_edges(
        embs, tables.par_lo, tables.par_inv, len(ra.pareto["op"]), dtype),
        what)
    return worst


class _Recording:
    """One wrapper of `repro_torch.kernels.carbon_sweep` replaced by a
    recording call; the counts stay on the wrapper (which counts through
    its module-level name, this object while it is installed)."""

    def __init__(self, rec, name):
        self.rec, self.name = rec, name
        self.orig = getattr(rec.csk, name)

    def __call__(self, *args, **kw):
        out, acc = self.orig(*args, **kw)
        self.rec.keep(out, args[self.rec.VALID[self.name]],
                      args[self.rec.EMB[self.name]])
        return out, acc

    @property
    def launches(self):
        return self.orig.launches

    @launches.setter
    def launches(self, v):
        self.orig.launches = v

    @property
    def plain_calls(self):
        return self.orig.plain_calls

    @plain_calls.setter
    def plain_calls(self, v):
        self.orig.plain_calls = v


class TileRecorder:
    """Wraps `sweep_tile` and `sweep_tile_drawn` of
    `repro_torch.kernels.carbon_sweep` (`install()`/`remove()`) and keeps
    the best totals and candidate embodied kg of each tile's valid
    cells, for the bin-edge allowance of `assert_sweeps_equal`."""
    # positions of `valid` and `emb` in each wrapper's arguments
    VALID = {"sweep_tile": 5, "sweep_tile_drawn": 9}
    EMB = {"sweep_tile": 0, "sweep_tile_drawn": 5}

    def __init__(self):
        from repro_torch.kernels import carbon_sweep as csk
        self.csk = csk
        self.entries = [_Recording(self, n) for n in self.VALID]
        self.best, self.emb = [], []

    def keep(self, out, valid, emb):
        v = valid.cpu().numpy()
        self.best.append(out.best_total.cpu().numpy()[v].ravel())
        self.emb.append(emb.cpu().numpy()[v].ravel())

    def install(self):
        for e in self.entries:
            setattr(self.csk, e.name, e)
        return self

    def remove(self):
        for e in self.entries:
            setattr(self.csk, e.name, e.orig)

    def arrays(self):
        return np.concatenate(self.best), np.concatenate(self.emb)


TILE_ORDER = ("emb", "kwh", "inten", "freq", "life_days", "valid",
              "cell_idx")


def stream_cases(rng, dtype, n_cells=12, n_draws=8, n_cand=3):
    """Three tiles of the reference test's shape (12 cells x 8 draws x 3
    candidates by default): plain, then +inf lifetimes and more invalid
    cells, then exact candidate ties over one more candidate."""
    return [tile_inputs(rng, n_cells, n_draws, n_cand, dtype),
            tile_inputs(rng, n_cells, n_draws, n_cand, dtype, inf_cells=4,
                        invalid_frac=0.5, cell0=n_cells),
            tile_inputs(rng, n_cells, n_draws, n_cand + 1, dtype,
                        ties=True, cell0=2 * n_cells)]


def port_stream(cases, dtype, device="cpu", fn=None):
    """The port's `sweep_tile` (or `fn`, e.g. `sweep_tile_plain`) over
    the tiles on `device`, one accumulator set; numpy TileOuts and
    accumulators after every tile."""
    from repro_torch import convert
    from repro_torch.kernels import carbon_sweep as pcs
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    acc = pcs.init_acc(64, 32, tdt, device)
    outs, accs = [], []
    for case in cases:
        args = [torch.from_numpy(case[k]).to(device) for k in TILE_ORDER]
        if fn is None:
            out, acc = pcs.sweep_tile(*args, acc, device=device, **TILE_KW)
        else:
            out, acc = fn(*args, acc, **TILE_KW)
        outs.append(pcs.TileOut(*(x.cpu().numpy() for x in out)))
        accs.append(convert.sweep_acc_to_numpy(acc))
    return outs, accs


def stream_edges(cases, outs, dtype):
    """The histogram and Pareto bin edges that some valid value of the
    streamed tiles lies at (the allowance of the comparisons)."""
    best = np.concatenate([o.best_total[c["valid"]].ravel()
                           for c, o in zip(cases, outs)])
    emb = np.concatenate([c["emb"][c["valid"]].ravel() for c in cases])
    kw = TILE_KW
    return (near_edges(best, kw["hist_lo"], kw["hist_inv"], 64, dtype),
            near_edges(emb, kw["par_lo"], kw["par_inv"], 32, dtype))


def assert_streams_equal(cases, ref, got, dtype, what) -> float:
    """Two streams of (TileOuts, accumulators): tiles by
    `assert_tiles_equal`, accumulators with the bin-edge allowance.
    Returns the largest relative sum difference."""
    (r_outs, r_accs), (g_outs, g_accs) = ref, got
    n_draws = cases[0]["life_days"].shape[1]
    worst = 0.0
    for k, (a, b) in enumerate(zip(r_outs, g_outs)):
        worst = max(worst, assert_tiles_equal(a, b, n_draws, dtype,
                                              f"{what} tile {k}"))
    h_edges, p_edges = stream_edges(cases, r_outs, dtype)
    for k, (a, b) in enumerate(zip(r_accs, g_accs)):
        assert_hist_equal(a.hist, b.hist, h_edges, f"{what} acc {k}")
        assert_pareto_equal(a, b, p_edges, f"{what} acc {k}")
    return worst


# lifetimes: the port's against the reference's and the card's against the
# CPU's, in ulps (see tests/test_torch_sweep.py for their causes)
LIFE_ULPS = {np.float32: 64, np.float64: 256}
DRAWN_ORDER = ("kind", "p1", "p2", "cum_prev", "emb", "kwh", "inten",
               "freq", "valid", "cell_idx")
DAY_S = 86_400.0


def drawn_dists(L=None):
    """Lifetime distributions that reach every branch of the draws: a
    lognormal/Weibull mixture, a point mass, a Weibull of shape 2.5 and
    a point/lognormal mixture (the main sweep's fourth), built with the
    `LifetimeDist` class `L` (the port's by default)."""
    if L is None:
        from repro_torch.core.sweep import LifetimeDist as L
    return (L.mixture([(L.lognormal(DAY_S * 30, 1.8), 0.7),
                       (L.weibull(DAY_S * 300, 0.8), 0.3)]),
            L.point(DAY_S * 100), L.weibull(DAY_S * 30, 2.5),
            L.mixture([(L.point(DAY_S * 10), 0.5),
                       (L.lognormal(DAY_S * 1000, 0.8), 0.5)]))


def drawn_tile_inputs(rng, n_cells: int, n_draws: int, n_cand: int, dtype,
                      *, invalid_frac: float = 0.2, cell0: int = 0,
                      seed: int = 5):
    """Numpy inputs of one drawn sweep tile: `tile_inputs`' candidate
    rows and masks (no lifetimes), each cell's mixture rows
    (`build_tables` of `drawn_dists()`, picked at random) and the sweep
    key of `seed` (the x64 key in float64)."""
    import dataclasses
    from repro_torch import prng
    from repro_torch.core import sweep as ps
    case = tile_inputs(rng, n_cells, n_draws, n_cand, dtype,
                       invalid_frac=invalid_frac, cell0=cell0)
    del case["life_days"]
    tb = ps.build_tables(dataclasses.replace(sweep_mixture_spec(),
                                             dists=drawn_dists()))
    di = rng.integers(0, tb.kind.shape[0], n_cells)
    case.update(kind=tb.kind[di].astype(np.int32),
                p1=tb.p1[di].astype(dtype), p2=tb.p2[di].astype(dtype),
                cum_prev=np.ascontiguousarray(tb.cum_prev[di], dtype),
                key=prng.prng_key(seed, x64=dtype == np.float64),
                n_draws=n_draws)
    return case


def drawn_stream_cases(rng, dtype, n_cells=12, n_draws=8, n_cand=3):
    """Three drawn tiles of consecutive cells (the last one wider in its
    candidates and with more invalid cells)."""
    return [drawn_tile_inputs(rng, n_cells, n_draws, n_cand, dtype),
            drawn_tile_inputs(rng, n_cells, n_draws, n_cand, dtype,
                              invalid_frac=0.5, cell0=n_cells),
            drawn_tile_inputs(rng, n_cells, n_draws, n_cand + 1, dtype,
                              cell0=2 * n_cells)]


def port_stream_drawn(cases, dtype, device="cpu", fn=None):
    """The port's `sweep_tile_drawn` (or `fn`, e.g.
    `sweep_tile_drawn_plain`) over the tiles on `device`, one
    accumulator set: numpy TileOuts, accumulators after every tile, and
    each tile's lifetimes (`life_out`)."""
    from repro_torch import convert
    from repro_torch.kernels import carbon_sweep as pcs
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    acc = pcs.init_acc(64, 32, tdt, device)
    outs, accs, lifes = [], [], []
    for case in cases:
        args = [torch.from_numpy(case[k]).to(device) for k in DRAWN_ORDER]
        life = torch.empty((case["emb"].shape[0], case["n_draws"]),
                           dtype=tdt, device=device)
        kw = dict(TILE_KW, n_draws=case["n_draws"], day_s=DAY_S,
                  life_out=life)
        if fn is None:
            out, acc = pcs.sweep_tile_drawn(case["key"], *args, acc,
                                            device=device, **kw)
        else:
            out, acc = fn(case["key"], *args, acc, **kw)
        outs.append(pcs.TileOut(*(x.cpu().numpy() for x in out)))
        accs.append(convert.sweep_acc_to_numpy(acc))
        lifes.append(life.cpu().numpy())
    return outs, accs, lifes


def with_lifetimes(cases, lifes):
    """The drawn tiles as `sweep_tile` inputs, fed `lifes`."""
    return [dict({k: c[k] for k in TILE_ORDER if k != "life_days"},
                 life_days=life) for c, life in zip(cases, lifes)]


def ulps(a, b) -> np.ndarray:
    """|a - b| in units in the last place, elementwise (float32 or 64)."""
    it = np.int64 if a.dtype == np.float64 else np.int32
    return np.abs(a.view(it).astype(np.int64) - b.view(it).astype(np.int64))


def sweep_mixture_spec(draws=32, seed=7):
    """The reference test's `_mixture_spec` (`tests/test_sweep.py`), built
    from the port's classes: 48 cells of a lognormal/Weibull mixture and
    a point mass, over frequencies, intensities and volumes."""
    from repro_torch.core.carbon import DeviceProfile
    from repro_torch.core.sweep import LifetimeDist, SweepSpec
    day = 86_400.0
    prof = DeviceProfile(n_one_stage=600, n_two_stage=400, vm_kb=0.4,
                         nvm_kb=1.0)
    mix = LifetimeDist.mixture(
        [(LifetimeDist.lognormal(day * 30, 1.8), 0.7),
         (LifetimeDist.weibull(day * 300, 0.8), 0.3)])
    return SweepSpec(
        workloads=("w0", "w1"), profiles=(prof, prof),
        dists=(mix, LifetimeDist.point(day * 100)),
        execs_per_day=(1.0, 24.0, 96.0), intensities=(0.028, 0.367),
        volumes=(1.0, 1e9), draws=draws, seed=seed)


def sweep_point_spec(draws=8, seed=3):
    """The reference test's `_point_spec`, from the port's classes: four
    point-mass lifetimes (1 to 1,000 days) x three frequencies. Returns
    (spec, lifetimes in seconds)."""
    from repro_torch.core.carbon import DeviceProfile
    from repro_torch.core.sweep import LifetimeDist, SweepSpec
    day = 86_400.0
    prof = DeviceProfile(n_one_stage=600, n_two_stage=400, vm_kb=0.4,
                         nvm_kb=1.0)
    lifes = [day * d for d in (1, 10, 100, 1000)]
    return SweepSpec(
        workloads=("w0",), profiles=(prof,),
        dists=tuple(LifetimeDist.point(L) for L in lifes),
        execs_per_day=(1.0, 24.0, 96.0), intensities=(0.367,),
        volumes=(1e6,), draws=draws, seed=seed), lifes


def sweep_life_days(spec, dtype, device, n_cells: int) -> np.ndarray:
    """The lifetimes (days) that the port's sweep on `device` uses for
    global cells 0..n_cells-1 of `spec` (cells past the spec's take its
    last cell's distribution, as a padded tile's do): on the card the
    sweep kernel's own draws (`life_out`), on the CPU the eager ones."""
    from repro_torch.core import sweep as ps
    from repro_torch.kernels import carbon_sweep as csk
    step = ps._Step(spec, n_cells, ps._torch_dtype(dtype), 64, 32,
                    torch.device(device))
    life = torch.empty((n_cells, spec.draws), dtype=step.dtype,
                       device=step.dev)
    step(csk.init_acc(64, 32, step.dtype, step.dev), 0, life_out=life)
    return life.cpu().numpy()


def run_sweep_recorded(spec, *, life_days=None, **kw):
    """`run_sweep(spec, **kw)` of the port, recording each tile's valid
    best totals and candidate embodied kg (the bin-edge allowance of
    `assert_sweeps_equal`); with `life_days` (an array over global
    cells), the sweep is fed those lifetimes instead of drawing its own.
    Returns (result, best totals, embodied kg). Only the CPU's sweep
    reads `life_days` (the card's draws in its kernel)."""
    from repro_torch.core import sweep as ps
    if life_days is not None and torch.device(kw.get("device") or "cuda"
                                              ).type != "cpu":
        raise ValueError("only the CPU's sweep can be fed lifetimes")
    rec = TileRecorder().install()
    orig = ps._Step.life_days
    if life_days is not None:
        def fed(self, cell, di):
            return torch.from_numpy(
                life_days[cell.cpu().numpy()].copy()).to(self.dev)
        ps._Step.life_days = fed
    try:
        res = ps.run_sweep(spec, **kw)
    finally:
        ps._Step.life_days = orig
        rec.remove()
    return (res,) + rec.arrays()


def assert_sweeps_identical(ra, rb, what: str) -> None:
    """Two SweepResults of the port bit for bit in every field (tile
    size and flush cadence must not change a sweep)."""
    for f in RESULT_SUM_FIELDS + RESULT_EXACT_FIELDS + ("hist",):
        np.testing.assert_array_equal(getattr(ra, f), getattr(rb, f),
                                      err_msg=f"{what}: {f}")
    for k in PAR_FIELDS:
        np.testing.assert_array_equal(ra.pareto[k], rb.pareto[k],
                                      err_msg=f"{what}: pareto {k}")
