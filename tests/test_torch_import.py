"""The port stands alone: it imports without JAX and without the
reference package (its checkpoint module also without ml_dtypes), its
sources import neither, its entry points run on the card by default and
raise without one, the one reference option it does not port yet
(`mesh=`) raises NotImplementedError, and a resilient plan raises the
reference's ValueErrors where the reference does."""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from repro_torch.fleet import engine, plan

_ROOT = pathlib.Path(__file__).resolve().parent.parent
_SRC = _ROOT / "src" / "repro_torch"

_BLOCKED_IMPORT = r"""
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
mods = ["repro_torch"]
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
    mods.append(m.name)
assert not any(k.split(".")[0] in ("jax", "repro") for k in sys.modules)
print(" ".join(mods))
print(len(mods))
"""

# the modules of each slice that must be among those imported
_SLICE_MODULES = ("repro_torch.fleet.engine",
                  "repro_torch.kernels.iss_stepper", "repro_torch.prng",
                  "repro_torch.core.sweep",
                  "repro_torch.kernels.carbon_sweep",
                  "repro_torch.flexibits.pyiss",
                  "repro_torch.flexibench.memory",
                  "repro_torch.flexibits.faults",
                  "repro_torch.configs.registry",
                  "repro_torch.configs.zamba2_7b",
                  "repro_torch.kernels.ref", "repro_torch.kernels.ops",
                  "repro_torch.kernels.flash_attention",
                  "repro_torch.kernels.ssd_scan",
                  "repro_torch.kernels.bitplane_matmul",
                  "repro_torch.models.layers", "repro_torch.models.mamba",
                  "repro_torch.models.transformer",
                  "repro_torch.models.hybrid", "repro_torch.models.model",
                  "repro_torch.launch.serve",
                  "repro_torch.distributed.checkpoint")


def test_port_imports_with_jax_and_the_reference_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(_ROOT / "src"),
                                         env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    # every module of the package, subpackages included
    n_files = len(list(_SRC.rglob("*.py")))
    lines = proc.stdout.strip().splitlines()
    assert int(lines[-1]) == n_files
    assert set(_SLICE_MODULES) <= set(lines[-2].split())


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+jaxlib\b|"
    r"import\s+repro(\.|\s|$)|from\s+repro(\.|\s))", re.MULTILINE)


_CHECKPOINT_IMPORT = r"""
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import numpy as np
import torch
from repro_torch.distributed import checkpoint
assert not any(k.split(".")[0] in ("jax", "ml_dtypes", "repro")
               for k in sys.modules)
d = sys.argv[1]
checkpoint.save(d, 1, {"a": np.arange(3), "h": torch.ones(2).bfloat16()})
tree, step = checkpoint.restore(d, {"a": None, "h": None})
assert step == 1 and tree["h"].dtype == torch.bfloat16
print("ok")
"""


def test_checkpoint_module_imports_no_jax_ml_dtypes_or_reference(tmp_path):
    """The checkpoint module saves and restores bfloat16 leaves with jax,
    ml_dtypes and the reference blocked."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(_ROOT / "src"),
                                         env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable, "-c", _CHECKPOINT_IMPORT,
                           str(tmp_path)], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "ok"


def test_sources_import_neither_jax_nor_the_reference():
    offenders = []
    for path in sorted(_SRC.rglob("*.py")):
        for m in _FORBIDDEN.finditer(path.read_text()):
            offenders.append(f"{path.relative_to(_ROOT)}: {m.group(0)}")
    assert not offenders, offenders
    assert len(list(_SRC.rglob("*.py"))) > 20


def _tiny_plan(**kw):
    return plan.FleetPlan(groups=(plan.FleetGroup(workload="WQ",
                                                  n_items=4),),
                          chunk=4, **kw)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    with pytest.raises(RuntimeError, match="CUDA card"):
        plan.run_plan(_tiny_plan())
    with pytest.raises(RuntimeError, match="CUDA card"):
        engine.run_packed([])
    from repro_torch.kernels import iss_stepper
    with pytest.raises(RuntimeError, match="CUDA card"):
        iss_stepper.iss_refill(None, None, None, None, None, None)


def test_host_loop_and_checkpoint_entry_points_default_to_the_card(
        tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    cdir = str(tmp_path / "ck")
    calls = [lambda: plan.run_plan(_tiny_plan(refill="host")),
             lambda: plan.run_plan(_tiny_plan(packed=False)),
             lambda: plan.run_plan(_tiny_plan(), checkpoint_dir=cdir,
                                   checkpoint_every=1),
             lambda: engine.run_workload_stream(
                 plan.FleetGroup(workload="WQ").resolve()[0], 4)]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA card"):
            call()
    assert not os.path.exists(cdir)


def test_sweep_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    from repro_torch.core import sweep
    from repro_torch.kernels import carbon_sweep
    spec = sweep.SweepSpec(workloads=("w",), profiles=(None,),
                           dists=(sweep.LifetimeDist.point(1.0),),
                           execs_per_day=(1.0,), intensities=(1.0,))
    with pytest.raises(RuntimeError, match="CUDA card"):
        sweep.run_sweep(spec)
    with pytest.raises(RuntimeError, match="CUDA card"):
        carbon_sweep.sweep_tile(*[None] * 8, hist_lo=0.0, hist_inv=1.0,
                                par_lo=0.0, par_inv=1.0)
    with pytest.raises(RuntimeError, match="CUDA card"):
        carbon_sweep.sweep_tile_drawn(*[None] * 12, n_draws=1, day_s=1.0,
                                      hist_lo=0.0, hist_inv=1.0, par_lo=0.0,
                                      par_inv=1.0)
    with pytest.raises(RuntimeError, match="CUDA card"):
        carbon_sweep.init_acc(64, 32, torch.float32)


def test_resilient_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    from repro_torch.flexibits import faults, iss
    from repro_torch.kernels import iss_stepper
    spec = faults.FaultSpec(rate=1e-3, targets=("regs", "mem", "pc"))
    for kw in (dict(faults=spec), dict(redundancy="dmr"),
               dict(faults=spec, redundancy="dmr")):
        with pytest.raises(RuntimeError, match="CUDA card"):
            plan.run_plan(_tiny_plan(**kw))
    lanes = iss.fresh_lanes(torch.zeros((2, 4), dtype=torch.int32))
    key = faults.lane_keys_tensor(0, 2)
    ep = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA card"):
        iss_stepper.iss_segment(torch.zeros(3, dtype=torch.int32), lanes,
                                seg_steps=1, max_steps=1, faults=spec,
                                lane_key=key, epoch=ep)
    with pytest.raises(RuntimeError, match="CUDA card"):
        iss_stepper.iss_segment_banked(
            torch.zeros((1, 3), dtype=torch.int32),
            torch.ones(1, dtype=torch.int32),
            iss.PackedState(lanes, torch.zeros(2, dtype=torch.int32),
                            torch.ones(2, dtype=torch.int32)),
            seg_steps=1, faults=spec, lane_key=key, epoch=ep)


def test_lm_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.kernels import bitplane_matmul as pbp
    from repro_torch.kernels import flash_attention as pfa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as pss
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model
    cfg = get_smoke_config("zamba2-7b")
    q = torch.zeros((1, 8, 16))
    planes = torch.zeros((4, 128, 128), dtype=torch.int8)
    calls = [
        lambda: serve.generate(cfg, batch=1, prompt_len=4, gen=2),
        lambda: build_model(cfg).init_params(),
        lambda: build_model(cfg).init_cache(1, 8),
        lambda: pfa.flash_attention(q, q, q, tq=8, tk=8),
        lambda: pss.ssd_scan(torch.zeros(2), torch.zeros((2, 8, 4)),
                             torch.zeros((2, 8)), torch.zeros((2, 8, 4)),
                             torch.zeros((2, 8, 4)), q=8),
        lambda: pbp.bitplane_matmul(torch.zeros((128, 128)), planes,
                                    torch.ones(128), bits=4),
        lambda: ops.gqa_flash_attention(q[None], q[None], q[None]),
        lambda: ops.quantized_linear(torch.zeros((2, 128)),
                                     torch.ones((128, 128)), bits=4),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA card"):
            call()


@pytest.mark.parametrize("what", ["refill_host", "checkpoint",
                                  "past_bounds"])
def test_resilient_plans_raise_the_references_errors(what):
    """Fault injection and DMR need the resident loop, keep no durable
    checkpoint and cannot fall back past the resident safety bounds: the
    reference's ValueErrors, word for word."""
    from repro_torch.flexibits import faults
    spec = faults.FaultSpec(rate=1e-3)
    runs = {
        "refill_host": lambda: plan.run_plan(
            _tiny_plan(refill="host", faults=spec), device="cpu"),
        "checkpoint": lambda: plan.run_plan(
            _tiny_plan(redundancy="dmr"), checkpoint_dir="ckpt",
            device="cpu"),
        "past_bounds": lambda: plan.run_plan(plan.FleetPlan(
            groups=(plan.FleetGroup(workload="WQ", n_items=4,
                                    max_steps=2**30),), chunk=4,
            faults=spec, redundancy="dmr"), device="cpu"),
    }
    match = {"refill_host": "needs the resident loop",
             "checkpoint": "incompatible with checkpoint_dir",
             "past_bounds": "cannot fall back to the host-refill loop"}
    with pytest.raises(ValueError, match=match[what]):
        runs[what]()


@pytest.mark.parametrize("what", ["mesh"])
def test_unported_options_raise_not_implemented(what):
    plans = {
        "mesh": lambda: plan.run_plan(_tiny_plan(), mesh=object(),
                                      device="cpu"),
    }
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        plans[what]()
