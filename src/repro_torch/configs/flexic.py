"""The paper's own system configuration: FlexiBits cores on Pragmatic's
0.6um FlexIC process, plus the documented red-star deployment points
(paper Table 2 / Fig. 5) and all calibration constants (DESIGN.md §5).

The per-workload lifetime/frequency metadata itself lives on each
Workload (flexibench/workloads.py); this module centralizes the paper's
hardware operating points for reference and tests.
"""
from repro_torch.flexibits.cycles import CORES, HERV, QERV, SERV  # noqa: F401

CLOCK_HZ = 10_000.0            # minimum viable ILI frequency (§4.4)
TAPEOUT_HZ = 30_900.0          # OpenROAD tape-out result (§6.5) — the
#                                hardware-gated part we do not reproduce
TESTED_HZ = 33_000.0           # fabricated dies' reliable maximum

# Fig. 5 red stars we validate claims at (within Table 2's stated ranges)
RED_STARS = {
    "FS": dict(lifetime_days=7, execs_per_day=24),      # produce patch
    "CT": dict(lifetime_days=270, execs_per_day=48),    # full-term patch
    "MC": dict(lifetime_days=4 * 365, execs_per_day=1),  # garment tag
    "AP": dict(lifetime_days=4 * 365, execs_per_day=24),  # urban monitor
}
