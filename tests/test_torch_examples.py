"""The port's examples on the CPU (`--device cpu`, the kernels' plain
versions) at a small size: `torch_quickstart.py` end to end (its part 3
trains five steps before it decodes), `torch_train_100m.py` at a few
short steps with a resume, and
`torch_carbon_planner.py`'s sweep, tables and serving planner (its
torch mirror equal to `plan_grid` bit for bit). The fleet example is in
tests/test_torch_fleet_example.py; chip_smoke.py phase 19(b) runs all
three on the card."""
import dataclasses

import numpy as np
import pytest

from _torch_parity import load_example, one_torch_thread  # noqa: F401
from repro.core.carbon import DeviceProfile as RProfile
from repro.core.selection import optimal_core as r_optimal_core
from repro.flexibench.base import WEEK_S, get
from repro.flexibits.pyiss import PyISS


def test_quickstart_runs_on_the_cpu(capsys):
    assert load_example("torch_quickstart").main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "quickstart OK"
    # part 1 prices FS as the reference's quickstart does
    fs = get("FS")
    x = fs.gen_inputs(np.random.default_rng(0), 1)[0]
    sim = PyISS(fs.program.code, fs.total_mem_words,
                fs.initial_memory(x)).run()
    prof = RProfile(sim.n_instr - sim.n_two_stage, sim.n_two_stage,
                    vm_kb=0.1, nvm_kb=fs.nvm_kb)
    core, totals = r_optimal_core(prof, lifetime_s=WEEK_S, execs_per_day=24)
    assert out[0] == (f"[carbon] {'meat (1 week)':16s} -> {core.name}  "
                      + " ".join(f"{k}={v * 1e3:.2f}g"
                                 for k, v in totals.items()))
    want = int(fs.ref(x[None])[0])
    assert out[2].startswith(f"[iss] spoilage class={want} (ref={want}) "
                             f"in {sim.n_instr} instrs on cpu")
    assert out[3].startswith("[lm] qwen2-1.5b smoke config")
    # part 3 trains five steps, as the reference's does, then decodes
    assert out[3].startswith("[lm] qwen2-1.5b smoke config, 5 train steps: "
                             "loss ")
    assert out[4].startswith("[lm] generated (2, 8) tokens")


def test_train_100m_runs_and_resumes_on_the_cpu(tmp_path, capsys):
    """The reference's CFG_100M through the port's train loop, cut to a
    few short steps: 2 steps and a checkpoint, then a second run that
    resumes there to step 3."""
    mod = load_example("torch_train_100m")
    ref = load_example("train_100m")
    assert dataclasses.asdict(mod.CFG_100M) == \
        dataclasses.asdict(ref.CFG_100M)
    argv = ["--device", "cpu", "--batch", "2", "--seq", "16", "--ckpt-dir",
            str(tmp_path)]
    first = mod.main(argv + ["--steps", "2"])
    second = mod.main(argv + ["--steps", "3"])
    out = capsys.readouterr().out.splitlines()
    assert len(first["losses"]) == 2 and len(second["losses"]) == 1
    assert np.all(np.isfinite(first["losses"] + second["losses"]))
    assert "[train] resumed from step 2" in out
    assert out[-1].startswith("[100m] 46.8M params; loss ")


def test_carbon_planner_runs_on_the_cpu(capsys):
    mod = load_example("torch_carbon_planner")
    res, ok = mod.main(["--device", "cpu", "--draws", "16", "--serving",
                        "--embodied-kg", "1500", "--power-w", "700"])
    out = capsys.readouterr().out
    assert ok is True and res.path == "plain"
    spec = res.spec
    assert spec.draws == 16 and res.n_cells == 3 * 3 * 3 * 3
    np.testing.assert_array_equal(res.counts.sum(-1), spec.draws)
    for head in ("[sweep]", "[selection]", "[risk]", "[frontier]",
                 "[serving]"):
        assert head in out
    assert "torch mirror on cpu == numpy plan_grid" in out
    # the reference's grammar, mixtures included
    ref = load_example("carbon_planner")
    for s in ("point:90d", "lognormal:100d:1.8", "weibull:300d:1.5",
              "point:7200", "mix:point:10d@0.3+lognormal:1000d:0.8@0.7"):
        assert mod.parse_dist(s).normalized() == \
            ref.parse_dist(s).normalized()


def test_carbon_planner_serving_needs_an_embodied_figure():
    mod = load_example("torch_carbon_planner")
    with pytest.raises(SystemExit) as e:
        mod.parse_args(["--serving"])
    assert e.value.code == 2
    with pytest.raises(SystemExit):
        mod.parse_args(["--path", "pallas"])     # dropped in the port
