"""Shard-local streaming (`mesh=`, DESIGN.md §9.12) in the port against
the reference, on the CPU: logical shards `["cpu"] * n` of one pool.

In process: per-item results at 2 and 4 shards equal the reference's
single-device run (resident and host loop, keep_state, adaptive); the
pool rounds to the shards (twice them under DMR); one host sync a
segment whatever the shard count; DMR at 2 shards equals the fault-free
run; checkpoints cross shard counts (4 -> 1, 4 -> 2, 1 -> 4), and the
reference resumes the port's 4-shard checkpoint at one device with the
port's schedule; `run_fleet_sharded` equals the reference's.

In a subprocess with `--xla_force_host_platform_device_count=4` (the
reference pins its device count at start-up), the reference runs the
skew plan under a 4-device mesh for its three steppers, one unprotected
faulty run and one crash with a checkpoint and its resume; the port at
`["cpu"] * 4` is held to every per-item field and to `n_shards`,
`shard_retired`, `shard_lane_steps`, `host_syncs`, `lane_steps`,
`n_segments` and `seg_schedule` of each, and resumes the reference's
checkpoint with the reference's resume schedule.
"""
import functools
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import _torch_parity as tp
from _torch_parity import one_torch_thread  # noqa: F401
from repro.fleet import engine as reng
from repro_torch.distributed import checkpoint as pck
from repro_torch.flexibits import faults as pf
from repro_torch.fleet import engine

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_KW = dict(chunk=16, seg_steps=64, keep_state=True)
_SCHEDULE = ("lane_steps", "n_segments", "seg_schedule", "host_syncs")
_SHARD = ("n_shards", "shard_retired", "shard_lane_steps")


def _cpu(n):
    return ["cpu"] * n


@functools.lru_cache(maxsize=None)
def _reference(refill: str, adaptive: bool):
    return reng.run_packed(tp.skew_groups(reng, max_steps_b=100_000),
                           refill=refill, adaptive=adaptive, **_KW)


@pytest.mark.parametrize("refill", ["device", "host"])
@pytest.mark.parametrize("shards", [2, 4])
def test_shards_match_single_device_reference(shards, refill):
    """Every per-item field and the final state at 2 and 4 logical
    shards equal the reference's single-device run; the host loop's
    schedule is the single-device one, the resident loop's per-shard
    statistics add up to the run's."""
    ref, rs = _reference(refill, True)
    got, ps = engine.run_packed(tp.skew_groups(engine, max_steps_b=100_000),
                                mesh=_cpu(shards), refill=refill,
                                adaptive=True, **_KW)
    tp.assert_results_equal(ref, got, f"{shards} shards {refill}")
    assert (ps.n_shards, ps.n_devices, ps.chunk) == (shards, 1, 16)
    if refill == "host":
        for f in _SCHEDULE:
            assert getattr(ps, f) == getattr(rs, f), f
        assert ps.shard_retired == ()
    else:
        assert sum(ps.shard_retired) == 64
        assert len(ps.shard_retired) == shards
        assert sum(ps.shard_lane_steps) == ps.lane_steps


def test_chunk_rounds_to_the_shards_and_one_sync_a_segment():
    """The pool rounds up to a multiple of the shard count (of twice it
    under DMR, so a pair never straddles a shard); the resident loop
    reads once a segment whatever the shard count: host syncs are
    n_segments + 1 + the drain's 9 reads (keep_state, timing off)."""
    groups = tp.skew_groups(engine, max_steps_b=100_000)
    for shards, dmr, chunk, want in ((4, False, 10, 12), (3, False, 16, 18),
                                     (2, True, 10, 12), (4, True, 13, 16)):
        _, ps = engine.run_packed(
            groups, chunk=chunk, seg_steps=64, keep_state=True,
            mesh=_cpu(shards), redundancy="dmr" if dmr else "none")
        assert ps.chunk == want, (shards, dmr, chunk)
        assert ps.host_syncs == ps.n_segments + 1 + 9, ps
    _, one = engine.run_packed(groups, device="cpu", **_KW)
    _, four = engine.run_packed(groups, mesh=_cpu(4), **_KW)
    assert one.host_syncs - one.n_segments == four.host_syncs \
        - four.n_segments == 10


def test_dmr_at_two_shards_equals_fault_free():
    """Transients under DMR with the pool split over 2 shards: every
    item's architectural result equals the fault-free run, and faults
    were detected and corrected."""
    gold, _ = engine.run_packed(tp.skew_groups(engine, max_steps_b=100_000),
                                device="cpu", **_KW)
    spec = pf.FaultSpec(rate=0.0008, seed=5, targets=("regs", "mem", "pc"))
    got, ps = engine.run_packed(tp.skew_groups(engine, max_steps_b=100_000),
                                mesh=_cpu(2), faults=spec, redundancy="dmr",
                                max_retries=6, **_KW)
    for a, b in zip(gold, got):
        for f in ("n_instr", "halted", "out", "mems", "regs", "pc"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f)
    assert ps.detected > 0 and ps.corrected > 0 and ps.n_shards == 2


def _crash(mod, cdir, shards, **kw):
    dev = {"device": "cpu"} if shards == 1 else {"mesh": _cpu(shards)}
    with pytest.raises(mod.InjectedFault):
        mod.run_packed(tp.skew_groups(mod, max_steps_b=100_000),
                       checkpoint_dir=cdir, checkpoint_every=3,
                       _crash_after_segments=8, **dev, **_KW, **kw)


@pytest.mark.parametrize("written, resumed", [(4, 1), (4, 2), (1, 4)])
def test_checkpoints_cross_shard_counts(written, resumed, tmp_path):
    """A stream checkpointed every 3 segments at `written` shards and
    killed after 8 resumes at `resumed` shards with per-item results
    equal to the uninterrupted run; at one shard the reference resumes
    the same checkpoint with the same schedule."""
    ref, _ = _reference("device", False)
    cdir = str(tmp_path / "ck")
    _crash(engine, cdir, written)
    assert sorted(pck.all_steps(cdir)) == [3, 6]
    tree, _ = pck.restore(cdir, engine._resident_ckpt_skeleton(2, True))
    assert (tree["lane_item"] >= 0).sum() > 0      # lanes were in flight
    rdir = str(tmp_path / "ref")
    shutil.copytree(cdir, rdir)
    dev = {"device": "cpu"} if resumed == 1 else {"mesh": _cpu(resumed)}
    got, ps = engine.run_packed(tp.skew_groups(engine, max_steps_b=100_000),
                                checkpoint_dir=cdir, checkpoint_every=3,
                                **dev, **_KW)
    tp.assert_results_equal(ref, got, f"{written} -> {resumed}")
    assert ps.n_shards == resumed
    if resumed == 1:
        want, rs = reng.run_packed(
            tp.skew_groups(reng, max_steps_b=100_000), checkpoint_dir=rdir,
            checkpoint_every=3, **_KW)
        tp.assert_results_equal(want, got, "reference resume")
        for f in _SCHEDULE:
            assert getattr(ps, f) == getattr(rs, f), f


def test_run_fleet_sharded_matches_reference():
    """`flexibits.fleet.run_fleet_sharded` at 2 shards against the
    reference's on one device: every field of the final state, and the
    fleet's energy priced from it."""
    import jax
    from repro.flexibench.base import get as rget
    from repro.flexibits import fleet as rfleet
    from repro_torch.flexibench.base import get
    from repro_torch.flexibits import fleet
    w = get("MC")
    mems = fleet.fleet_inputs(w, 20, seed=4)
    np.testing.assert_array_equal(
        mems, rfleet.fleet_inputs(rget("MC"), 20, seed=4))
    want = rfleet.run_fleet_sharded(rget("MC"), mems,
                                    jax.make_mesh((1,), ("fleet",)),
                                    seg_steps=32)
    got = fleet.run_fleet_sharded(w, mems, _cpu(2), seg_steps=32)
    for f in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      getattr(got, f).numpy(), err_msg=f)
    assert not got.n_cycles.any() and got.halted.all()
    from repro.flexibits.cycles import CORES as RCORES
    from repro_torch.flexibits.cycles import CORES
    for core in ("SERV", "HERV"):
        assert fleet.fleet_energy_kwh(got, CORES[core], 2.0) == \
            rfleet.fleet_energy_kwh(want, RCORES[core], 2.0)


_MESH_SCRIPT = r"""
import shutil, sys
import jax
import numpy as np
import _torch_parity as tp
from repro.flexibits.faults import FaultSpec
from repro.fleet import engine
out, cdir = sys.argv[1], sys.argv[2]
mesh = jax.make_mesh((4,), ("fleet",))
kw = dict(chunk=16, seg_steps=64, keep_state=True, mesh=mesh)
rec = {}

def keep(tag, res, st):
    for g, r in enumerate(res):
        for f in tp.RESULT_FIELDS:
            v = getattr(r, f)
            if v is not None:
                rec[f"{tag}/{g}/{f}"] = np.asarray(v)
    for f in ("n_shards", "shard_retired", "shard_lane_steps",
              "host_syncs", "lane_steps", "n_segments", "seg_schedule",
              "n_devices"):
        rec[f"{tag}/stats/{f}"] = np.asarray(getattr(st, f), np.int64)

def groups():
    return tp.skew_groups(engine, max_steps_b=100_000)

for stepper in ("branchless", "pallas", "switch"):
    keep(stepper, *engine.run_packed(groups(), stepper=stepper,
                                     adaptive=True, **kw))
spec = FaultSpec(rate=0.002, seed=11, targets=("regs", "mem", "pc"))
keep("faulty", *engine.run_packed(groups(), stepper="pallas", faults=spec,
                                  **kw))
try:
    engine.run_packed(groups(), checkpoint_dir=cdir, checkpoint_every=3,
                      _crash_after_segments=8, **kw)
    raise SystemExit("expected InjectedFault")
except engine.InjectedFault:
    pass
shutil.copytree(cdir, cdir + "-resume")
keep("resume", *engine.run_packed(groups(), checkpoint_dir=cdir + "-resume",
                                  checkpoint_every=3, **kw))
np.savez(out, **rec)
print("ok")
"""


@pytest.fixture(scope="module")
def mesh_reference(tmp_path_factory):
    """The reference's runs under a 4-device CPU mesh (one subprocess)."""
    d = tmp_path_factory.mktemp("mesh")
    out, cdir = str(d / "ref.npz"), str(d / "ck")
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=4")
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(_ROOT, "src"), _ROOT, os.path.join(_ROOT, "tests"),
         env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable, "-c", _MESH_SCRIPT, out, cdir],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "ok"
    with np.load(out) as z:
        return {k: z[k] for k in z.files}, cdir


def _assert_like(rec, tag, res, stats):
    for g, r in enumerate(res):
        for f in tp.RESULT_FIELDS:
            v = getattr(r, f)
            key = f"{tag}/{g}/{f}"
            assert (v is None) == (key not in rec), key
            if v is not None:
                np.testing.assert_array_equal(v, rec[key], err_msg=key)
    for f in _SCHEDULE + _SHARD:
        np.testing.assert_array_equal(
            np.asarray(getattr(stats, f), np.int64), rec[f"{tag}/stats/{f}"],
            err_msg=f"{tag}: {f}")
    assert int(rec[f"{tag}/stats/n_devices"]) == 4 and stats.n_devices == 1


def test_four_shards_match_the_reference_under_a_4_device_mesh(
        mesh_reference, tmp_path):
    """The port at `["cpu"] * 4` against the reference's 4-device mesh:
    the three steppers (adaptive), an unprotected faulty run on the
    kernel route, and the resume of the reference's own checkpoint,
    every per-item field and every shard and schedule statistic."""
    rec, cdir = mesh_reference
    kw = dict(mesh=_cpu(4), **_KW)

    def groups():
        return tp.skew_groups(engine, max_steps_b=100_000)
    for stepper in ("branchless", "pallas", "switch"):
        _assert_like(rec, stepper, *engine.run_packed(
            groups(), stepper=stepper, adaptive=True, **kw))
    spec = pf.FaultSpec(rate=0.002, seed=11, targets=("regs", "mem", "pc"))
    res, st = engine.run_packed(groups(), faults=spec, **kw)
    _assert_like(rec, "faulty", res, st)
    gold, _ = _reference("device", False)
    assert any((a.out != b.out).any() for a, b in zip(gold, res))
    mine = str(tmp_path / "resume")
    shutil.copytree(cdir, mine)
    res, st = engine.run_packed(groups(), checkpoint_dir=mine,
                                checkpoint_every=3, **kw)
    _assert_like(rec, "resume", res, st)
    tp.assert_results_equal(gold, res, "resume vs uninterrupted")
