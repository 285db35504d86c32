"""The port's examples on the CPU (`--device cpu`, the kernels' plain
versions) at a small size: `torch_quickstart.py` end to end, and
`torch_carbon_planner.py`'s sweep, tables and serving planner (its
torch mirror equal to `plan_grid` bit for bit). The fleet example is in
tests/test_torch_fleet_example.py; chip_smoke.py phase 19(b) runs all
three on the card."""
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
