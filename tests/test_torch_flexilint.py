"""The port's FlexiLint CLI (`python -m repro_torch.tools.flexilint`)
against the reference's (`repro.tools.flexilint`): the same arguments
print the same report, line for line, apart from the analysis wall time
each program's report carries, and return the same exit status."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

from repro.tools import flexilint as rlint
from repro_torch.tools import flexilint as plint

_ROOT = pathlib.Path(__file__).resolve().parent.parent
_WALL = re.compile(r"analysis wall time [0-9.]+ ms")


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out
    return rc, _WALL.sub("analysis wall time <t> ms", out)


@pytest.mark.parametrize("argv", [
    ["WQ", "MC", "--measure", "1"],
    ["FS", "HC", "--core", "HERV", "--timing", "base", "--strict"],
])
def test_cli_prints_the_references_report(argv, capsys):
    rc_ref, want = _run(rlint.main, argv, capsys)
    rc, got = _run(plint.main, argv, capsys)
    assert rc == rc_ref
    assert got.splitlines() == want.splitlines()
    assert "program(s) analyzed" in got.splitlines()[-1]


def test_cli_rejects_an_unknown_workload_as_the_reference(capsys):
    errs = []
    for main in (rlint.main, plint.main):
        with pytest.raises(SystemExit) as e:
            main(["WQ", "NOPE"])
        assert e.value.code == 2
        errs.append(capsys.readouterr().err.splitlines()[-1])
    assert errs[0] == errs[1]
    assert "unknown workload 'NOPE'" in errs[1]


def test_module_runs_as_a_script():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(_ROOT / "src"),
                                         env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable, "-m", "repro_torch.tools.flexilint",
                           "WQ"], env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == \
        "flexilint: 1 program(s) analyzed, ok"
