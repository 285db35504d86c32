"""The port's checkpoint module and its durable resident streams, against
the reference's, on the CPU.

`repro_torch.distributed.checkpoint` keeps the reference's on-disk
format: round trips, keep-N pruning, CRC32 and truncation checks, the
newest-intact fallback, and a checkpoint of each package verifying and
restoring under the other (bfloat16 leaves too). The resident loop's
checkpoints (`run_packed(checkpoint_dir=, checkpoint_every=)`), after
`tests/test_fault_tolerance.py`: a stream killed at a segment boundary
resumes bit-exact with an uninterrupted run (and, on that plan, with
its schedule), past a corrupt newest checkpoint, across the two packages
in both directions (equal to the reference's own resume in every
schedule statistic), and from a checkpoint the reference wrote under a
4-device mesh; the port's checkpoint at step k equals the reference's,
leaf for leaf."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_parity as tp
from _torch_parity import one_torch_thread  # noqa: F401
from repro.distributed import checkpoint as rck
from repro.fleet import engine as reng
from repro_torch.distributed import checkpoint as pck
from repro_torch.fleet import engine

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_KW = dict(chunk=16, seg_steps=64, keep_state=True)
_SCHEDULE = ("lane_steps", "n_segments", "seg_schedule")


def _flip_byte(path, offset):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


def _tree():
    rng = np.random.default_rng(0)
    return {"a": np.arange(256, dtype=np.int32),
            "b": rng.normal(size=(4, 8)),
            "mask": rng.random(17) < 0.5,
            "t": torch.arange(12, dtype=torch.int64).reshape(3, 4),
            "h": torch.linspace(-3, 3, 40).to(torch.bfloat16)}


def _assert_tree_equal(want, got):
    assert set(want) == set(got)
    for k, v in want.items():
        g = got[k]
        if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16:
            assert isinstance(g, torch.Tensor) and g.dtype == torch.bfloat16
            assert torch.equal(v.view(torch.int16), g.view(torch.int16)), k
        else:
            v = v.numpy() if isinstance(v, torch.Tensor) else v
            assert np.asarray(g).dtype == v.dtype, k
            np.testing.assert_array_equal(np.asarray(g), v, err_msg=k)


def test_checkpoint_round_trip(tmp_path):
    d = str(tmp_path)
    path = pck.save(d, 3, _tree())
    assert path.endswith("step_3")
    assert sorted(os.listdir(path)) == ["arrays.npz", "meta.json"]
    got, step = pck.restore(d, _tree())
    assert step == 3
    _assert_tree_equal(_tree(), got)
    meta = json.load(open(os.path.join(path, "meta.json")))
    assert meta["step"] == 3 and meta["n_arrays"] == 5
    assert meta["ext_dtypes"] == {"h": "bfloat16"}
    assert set(meta["crc32"]) == set(_tree())


def test_checkpoint_keep_n_and_latest(tmp_path):
    d = str(tmp_path)
    for s in (1, 5, 2, 9, 7):
        pck.save(d, s, {"x": np.full(3, s, np.int32)}, keep=3)
    assert sorted(pck.all_steps(d)) == [5, 7, 9]
    assert pck.latest_step(d) == 9
    got, step = pck.restore(d, {"x": None}, step=5)
    assert step == 5 and (got["x"] == 5).all()
    assert not [n for n in os.listdir(d) if n.startswith(".tmp_")]
    assert pck.latest_step(str(tmp_path / "none")) is None


def test_checkpoint_crc_detects_bit_flip(tmp_path):
    d = str(tmp_path)
    pck.save(d, 3, {"a": np.arange(256, dtype=np.int32)})
    npz = os.path.join(d, "step_3", "arrays.npz")
    _flip_byte(npz, 300)    # inside the member's array payload
    with pytest.raises(pck.CheckpointCorrupt) as ei:
        pck.restore(d, {"a": None}, step=3)
    assert ei.value.leaf == "a"
    assert "arrays.npz" in str(ei.value)


def test_checkpoint_truncation_detected(tmp_path):
    d = str(tmp_path)
    pck.save(d, 1, {"a": np.arange(256, dtype=np.int32)})
    npz = os.path.join(d, "step_1", "arrays.npz")
    size = os.path.getsize(npz)
    with open(npz, "r+b") as f:
        f.truncate(size // 2)
    with pytest.raises(pck.CheckpointCorrupt):
        pck.verify(d, 1)


def test_checkpoint_resume_falls_back_to_newest_intact(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3):
        pck.save(d, s, {"a": np.full(64, s, np.int32)})
    _flip_byte(os.path.join(d, "step_3", "arrays.npz"), 200)
    got, step = pck.restore(d, {"a": None})
    assert step == 2 and (got["a"] == 2).all()
    with pytest.raises(pck.CheckpointCorrupt):
        pck.restore(d, {"a": None}, step=3)      # an explicit step raises
    _flip_byte(os.path.join(d, "step_2", "arrays.npz"), 200)
    _flip_byte(os.path.join(d, "step_1", "arrays.npz"), 200)
    with pytest.raises(pck.CheckpointCorrupt):
        pck.restore(d, {"a": None})
    with pytest.raises(FileNotFoundError):
        pck.restore(str(tmp_path / "empty"), {"a": None})


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_readable_by_the_other_package(writer, tmp_path):
    """The on-disk format is the reference's: bfloat16 as its uint16 bits
    named in `ext_dtypes`, a CRC32 per leaf."""
    import jax.numpy as jnp
    import ml_dtypes
    d = str(tmp_path)
    want = _tree()
    ref_tree = {k: (jnp.asarray(v.view(torch.int16).numpy().view(
        ml_dtypes.bfloat16)) if isinstance(v, torch.Tensor)
        and v.dtype == torch.bfloat16 else jnp.asarray(np.asarray(v)))
        for k, v in want.items()}
    if writer == "port":
        pck.save(d, 4, want)
    else:
        rck.save(d, 4, ref_tree)
    # the other package verifies and restores it
    if writer == "port":
        rck.verify(d, 4)
        got, step = rck.restore(d, ref_tree)
        assert step == 4
        for k, v in ref_tree.items():
            np.testing.assert_array_equal(
                np.asarray(got[k]).view(np.uint8),
                np.asarray(v).view(np.uint8), err_msg=k)
            assert np.asarray(got[k]).dtype == np.asarray(v).dtype
    else:
        # JAX without x64 stored float64 and int64 leaves as 32-bit ones
        stored = {k: v if isinstance(v, torch.Tensor)
                  and v.dtype == torch.bfloat16 else np.asarray(ref_tree[k])
                  for k, v in want.items()}
        pck.verify(d, 4)
        got, step = pck.restore(d, want)
        assert step == 4
        _assert_tree_equal(stored, got)
    a, _ = rck.verify(d, 4)
    b, _ = pck.verify(d, 4)
    assert a.keys() == b.keys()


# ----------------------------------------------------- resident streams

def _groups(mod):
    """`tests/test_fault_tolerance.py::_fleet_groups`: 40 and 24 items
    of the skew program, no item ended by its budget."""
    return tp.skew_groups(mod, max_steps_b=100_000)


@pytest.fixture(scope="module")
def uninterrupted():
    """The reference's uninterrupted run, and the port's."""
    ref, rs = reng.run_packed(_groups(reng), **_KW)
    got, ps = engine.run_packed(_groups(engine), device="cpu", **_KW)
    tp.assert_results_equal(ref, got, "uninterrupted")
    for f in _SCHEDULE:
        assert getattr(rs, f) == getattr(ps, f), f
    return ref, rs


def _crash(mod, cdir, every, at, **dev):
    with pytest.raises(mod.InjectedFault):
        mod.run_packed(_groups(mod), checkpoint_dir=cdir,
                       checkpoint_every=every, _crash_after_segments=at,
                       **dev, **_KW)


def _assert_resumed(uninterrupted, res, stats, ctx):
    """Per-item results equal to the uninterrupted run's, and (on this
    plan, as in `tests/test_fault_tolerance.py`) its segment count and
    schedule. In general a resume stages the unconsumed items again in
    another order, which may change the schedule: the port is held to
    the reference's resume for that
    (`test_resident_stream_resumes_across_packages`)."""
    ref, rs = uninterrupted
    tp.assert_results_equal(ref, res, ctx)
    for f in _SCHEDULE:
        assert getattr(rs, f) == getattr(stats, f), f"{ctx}: {f}"


@pytest.mark.parametrize("adaptive", [False, True])
def test_resident_stream_kill_and_resume_bit_exact(uninterrupted, adaptive,
                                                   tmp_path):
    """Kill the stream at segment 10 and rerun against the same
    directory: it resumes from its last checkpoint and drains equal to
    an uninterrupted run, with the same segment count and schedule (the
    adaptive case also restores the controller's rate and schedule)."""
    kw = dict(_KW, adaptive=adaptive)
    ref, rs = (uninterrupted if not adaptive
               else reng.run_packed(_groups(reng), **kw))
    cdir = str(tmp_path / "ck")
    with pytest.raises(engine.InjectedFault, match="after segment 10"):
        engine.run_packed(_groups(engine), checkpoint_dir=cdir,
                          checkpoint_every=4, _crash_after_segments=10,
                          adaptive=adaptive, device="cpu", **_KW)
    assert pck.latest_step(cdir) == 8
    res, stats = engine.run_packed(_groups(engine), checkpoint_dir=cdir,
                                   checkpoint_every=4, adaptive=adaptive,
                                   device="cpu", **_KW)
    _assert_resumed((ref, rs), res, stats, f"adaptive={adaptive}")


def test_resident_stream_resume_skips_corrupt_newest(uninterrupted,
                                                     tmp_path):
    cdir = str(tmp_path / "ck")
    _crash(engine, cdir, 3, 10, device="cpu")
    steps = sorted(pck.all_steps(cdir))
    assert len(steps) >= 2
    _flip_byte(os.path.join(cdir, f"step_{steps[-1]}", "arrays.npz"), 400)
    with pytest.raises(pck.CheckpointCorrupt):
        pck.verify(cdir, steps[-1])
    res, stats = engine.run_packed(_groups(engine), checkpoint_dir=cdir,
                                   checkpoint_every=3, device="cpu", **_KW)
    _assert_resumed(uninterrupted, res, stats, "past a corrupt newest")


def _workload_groups(mod):
    """WQ, MC and AD with their own sources: a plan whose resume stages
    the pending items in another order than the uninterrupted run, so
    its segment count and lane-steps change."""
    from repro.flexibench.base import get as rget
    from repro_torch.flexibench.base import get as pget
    get = rget if mod is reng else pget
    out = []
    for i, (key, n) in enumerate((("WQ", 60), ("MC", 50), ("AD", 40))):
        w = get(key)
        out.append(mod.PackedGroup(
            code=w.program.code, source=mod.workload_source(w, seed=i),
            n_items=n, max_steps=w.max_steps, mem_words=w.total_mem_words,
            out_addr=w.out_addr))
    return out


@pytest.mark.parametrize("plan", ["skew", "workloads"])
@pytest.mark.parametrize("crashed_by", ["reference", "port"])
def test_resident_stream_resumes_across_packages(uninterrupted, crashed_by,
                                                 plan, tmp_path):
    """One package crashes; both resume copies of its checkpoint. The
    two resumes agree bit for bit, in every schedule statistic too, and
    their per-item results equal an uninterrupted run's. On the workload
    plan the resumed schedule differs from the uninterrupted one (the
    reference's resume re-stages the unconsumed items)."""
    import shutil
    groups = _groups if plan == "skew" else _workload_groups
    kw = dict(_KW) if plan == "skew" else dict(chunk=16, seg_steps=32)
    cdir, copy = str(tmp_path / "ck"), str(tmp_path / "ck2")
    crasher, dev = (reng, {}) if crashed_by == "reference" \
        else (engine, {"device": "cpu"})
    with pytest.raises(crasher.InjectedFault):
        crasher.run_packed(groups(crasher), checkpoint_dir=cdir,
                           checkpoint_every=4, _crash_after_segments=10,
                           **dev, **kw)
    shutil.copytree(cdir, copy)
    res, ps = engine.run_packed(groups(engine), checkpoint_dir=cdir,
                                checkpoint_every=4, device="cpu", **kw)
    want, rs = reng.run_packed(groups(reng), checkpoint_dir=copy,
                               checkpoint_every=4, **kw)
    tp.assert_results_equal(want, res, f"crashed by {crashed_by}")
    for f in _SCHEDULE + ("host_syncs",):
        assert getattr(rs, f) == getattr(ps, f), f
    for a, b in zip(want, res):
        assert (a.lane_steps, a.n_segments) == (b.lane_steps, b.n_segments)
    if plan == "skew":
        _assert_resumed(uninterrupted, res, ps, f"crashed by {crashed_by}")
    else:
        gold, gs = reng.run_packed(groups(reng), **kw)
        tp.assert_results_equal(gold, res, "vs uninterrupted")
        assert (gs.n_segments, gs.lane_steps) != (ps.n_segments,
                                                  ps.lane_steps)


@pytest.mark.parametrize("timed", [False, True])
def test_port_checkpoint_equals_reference_leaf_for_leaf(timed, tmp_path):
    """The same crash in both packages: at every step both wrote, the
    checkpoints hold the same keys, dtypes, shapes and values (with the
    timing layer on in one case, so the tick tallies are nonzero)."""
    from repro_torch.flexibits.cycles import CORES, cost_row
    cost = cost_row(CORES["QERV"], dynamic=True) if timed else None

    def groups(mod):
        return [g if i else mod.PackedGroup(**{**g.__dict__, "cost": cost})
                for i, g in enumerate(_groups(mod))]
    dirs = {"ref": str(tmp_path / "r"), "port": str(tmp_path / "p")}
    for key, mod, dev in (("ref", reng, {}),
                          ("port", engine, {"device": "cpu"})):
        with pytest.raises(mod.InjectedFault):
            mod.run_packed(groups(mod), checkpoint_dir=dirs[key],
                           checkpoint_every=3, _crash_after_segments=11,
                           **dev, **_KW)
    steps = sorted(rck.all_steps(dirs["ref"]))
    assert steps == sorted(pck.all_steps(dirs["port"])) == [3, 6, 9]
    for s in steps:
        a, ad = rck.verify(dirs["ref"], s)
        b, bd = pck.verify(dirs["port"], s)
        assert ad == bd == {}
        assert sorted(a) == sorted(b) == sorted(
            engine._resident_ckpt_skeleton(2, True))
        for k in a:
            assert a[k].dtype == b[k].dtype, (s, k)
            assert a[k].shape == b[k].shape, (s, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{s} {k}")
        assert (a["val_n_cycles"].any() or s == 3) if timed \
            else not a["val_n_cycles"].any()


@pytest.mark.parametrize("what", ["counts", "mem_words", "lanes"])
def test_resume_checks_match_reference(what, tmp_path):
    """A checkpoint of another plan: the reference's ValueErrors, word
    for word (other group sizes; another lane memory width; more
    in-flight lanes than the resuming pool)."""
    cdir = str(tmp_path / "ck")
    _crash(reng, cdir, 4, 6)

    def run(mod, **dev):
        groups = _groups(mod)
        kw = dict(_KW)
        if what == "counts":
            groups = groups[:1]
        elif what == "mem_words":
            groups = [mod.PackedGroup(**{**g.__dict__, "mem_words": 40})
                      for g in groups]
        else:
            kw["chunk"] = 4
        return mod.run_packed(groups, checkpoint_dir=cdir,
                              checkpoint_every=4, **dev, **kw)
    with pytest.raises(ValueError) as r:
        run(reng)
    with pytest.raises(ValueError) as p:
        run(engine, device="cpu")
    assert str(r.value) == str(p.value)


@pytest.mark.slow
def test_resume_from_a_reference_checkpoint_under_a_4_device_mesh(
        uninterrupted, tmp_path):
    """The reference crashes a stream sharded over a 4-device CPU mesh
    (a subprocess with `--xla_force_host_platform_device_count=4`, as
    `tests/test_fault_tolerance.py` does); the port resumes its
    canonical checkpoint at one shard, with per-item results bit for bit.
    `n_segments` is not compared across shard counts: per-shard lane
    occupancy, and so the drain cadence, differ."""
    cdir = str(tmp_path / "elastic-ck")
    crash = r"""
import json
import jax
import _torch_parity as tp
from repro.fleet import engine
mesh = jax.make_mesh((4,), ("fleet",))
try:
    engine.run_packed(tp.skew_groups(engine, max_steps_b=100_000),
                      chunk=16, seg_steps=64, keep_state=True, mesh=mesh,
                      checkpoint_dir=%(cdir)r, checkpoint_every=3,
                      _crash_after_segments=8)
    raise SystemExit("expected InjectedFault")
except engine.InjectedFault:
    pass
print(json.dumps({"ok": True}))
""" % {"cdir": cdir}
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=4")
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(_ROOT, "src"), _ROOT, os.path.join(_ROOT, "tests"),
         env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable, "-c", crash], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["ok"]
    tree, _ = pck.restore(cdir, engine._resident_ckpt_skeleton(2, True))
    assert (tree["lane_item"] >= 0).sum() > 0     # lanes were in flight
    res, stats = engine.run_packed(_groups(engine), checkpoint_dir=cdir,
                                   checkpoint_every=3, device="cpu", **_KW)
    ref, _ = uninterrupted
    tp.assert_results_equal(ref, res, "elastic resume")
    assert stats.n_devices == 1
