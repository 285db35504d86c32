"""Lifetime-aware carbon planner for LLM serving fleets (beyond the paper).

The reference's `core/planner.py` with the chip as a parameter. It
applies FLEXIFLOW's embodied-vs-operational structure to datacenter
inference: the paper's datapath-width knob (1/4/8-bit) becomes the weight
bit-width knob (W16/W8/W4 bit-plane serving, kernels/bitplane_matmul), and
"deployment lifetime x task frequency" becomes "deployment lifetime x QPS".

  embodied   = chips_needed x chip.embodied_kg   (ACT-style per-chip LCA)
  operational= energy/token x tokens(lifetime, qps) x intensity

tokens/s/chip for decode is memory-bound: chip.hbm_bw / bytes moved per
token, with bytes ~ (param_bytes(bits) + kv_bytes)/chips.

The reference fixes its chip in module constants; here a `ServeChip`
carries the memory bandwidth, the power and the embodied carbon of one
chip, and every function takes it, keeping the reference's formulas and
their order of operations, so that its own constants passed in give its
numbers bit for bit. `h100_sxm` gives an H100 SXM's bandwidth from
NVIDIA's data sheet and, by default, the card's own power limit; the
embodied carbon of an H100 has no source in this repo, so the caller
gives it. `plan_grid` is the numpy oracle of `core/sweep.py::
serving_plan`, the float64 torch mirror that runs on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

PUE = 1.1     # datacenter power usage effectiveness

# HBM3 bandwidth of an H100 SXM (NVIDIA's data sheet)
H100_SXM_HBM_BW = 3.35e12


@dataclasses.dataclass(frozen=True)
class ServeChip:
    hbm_bw: float             # bytes/s one chip reads from its memory
    power_w: float            # one chip's draw, host share included
    embodied_kg: float        # kg CO2e per chip (package + board)


def h100_sxm(embodied_kg: float,
             power_w: Optional[float] = None) -> ServeChip:
    """An H100 SXM serving chip: the data sheet's HBM bandwidth, and
    `power_w` or, when it is None, the card's power limit as nvidia-smi
    reports it (RuntimeError where it reports none)."""
    if power_w is None:
        from repro_torch.device import card_power_limit_w
        power_w = card_power_limit_w()
        if power_w is None:
            raise RuntimeError("h100_sxm: nvidia-smi reports no power "
                               "limit here; pass power_w")
    return ServeChip(hbm_bw=H100_SXM_HBM_BW, power_w=float(power_w),
                     embodied_kg=float(embodied_kg))


@dataclasses.dataclass(frozen=True)
class ServeVariant:
    name: str                 # e.g. "W16", "W8", "W4"
    weight_bits: int
    quality_penalty: float    # relative quality loss (documented, not opt.)
    prep_kg: float            # ONE-TIME carbon to produce the variant
    #                           (PTQ calibration / QAT distillation) — the
    #                           direct analogue of the paper's embodied
    #                           area cost: paid once, amortized by lifetime.


# prep costs: W8 = PTQ calibration+eval (~100 chip-hours);
# W4 = QAT/distillation (~4000 chip-hours) at the chip's power, PUE 1.1,
# US grid.
def _prep_kg(chip: ServeChip, chip_hours: float,
             intensity: float = 0.367) -> float:
    return chip_hours * chip.power_w / 1000.0 * PUE * intensity


def serve_variants(chip: ServeChip) -> Tuple[ServeVariant, ...]:
    """The reference's three serving variants, prepared on `chip`."""
    return (ServeVariant("W16", 16, 0.0, 0.0),
            ServeVariant("W8", 8, 0.002, _prep_kg(chip, 100.0)),
            ServeVariant("W4", 4, 0.01, _prep_kg(chip, 4000.0)))


def tokens_per_s_per_chip(chip: ServeChip, n_params: float,
                          weight_bits: int, kv_bytes_per_token: float,
                          chips: int, batch: int = 64) -> float:
    """Decode roofline: each step reads all weights + the batch's KV."""
    weight_bytes = n_params * weight_bits / 8.0 / chips
    kv_bytes = kv_bytes_per_token * batch / chips
    step_s = (weight_bytes + kv_bytes) / chip.hbm_bw
    return batch / step_s / chips


def plan_options(chip: ServeChip, n_params: float,
                 kv_bytes_per_token: float, chips_options: Sequence[int],
                 variants: Sequence[ServeVariant]):
    """The per-option anchors, variant-major: (variant index int32,
    chips, fleet tokens/s, prep kg), float64 vectors of K options."""
    if not list(chips_options):
        raise ValueError("plan_grid: chips_options is empty — need at "
                         "least one fleet size to plan over")
    if not list(variants):
        raise ValueError("plan_grid: variants is empty — need at least "
                         "one serving variant to plan over")
    opt_vi, opt_chips, opt_tps = [], [], []
    for vi, v in enumerate(variants):
        for chips in chips_options:
            opt_vi.append(vi)
            opt_chips.append(chips)
            opt_tps.append(tokens_per_s_per_chip(
                chip, n_params, v.weight_bits, kv_bytes_per_token, chips)
                * chips)
    opt_vi = np.asarray(opt_vi, np.int32)             # (K,)
    opt_chips = np.asarray(opt_chips, float)
    opt_tps = np.asarray(opt_tps, float)
    opt_prep = np.asarray([variants[v].prep_kg for v in opt_vi], float)
    return opt_vi, opt_chips, opt_tps, opt_prep


def plan_grid(*, chip: ServeChip, n_params: float,
              kv_bytes_per_token: float,
              lifetimes_days: np.ndarray, qps_grid: np.ndarray,
              chips_options: Sequence[int] = (8, 16, 32, 64, 128, 256),
              intensity: float = 0.367,
              variants: Optional[Sequence[ServeVariant]] = None) -> Dict:
    """For every (lifetime, qps) cell pick (variant, chips) minimizing total
    carbon subject to meeting qps. Returns argmin maps + totals.

    One (lifetime, qps, option) broadcast: the per-option anchors (prep
    carbon, chips, tokens/s) are vectors, embodied carbon broadcasts over
    lifetimes, operational over lifetime x qps, infeasible options mask
    to +inf, and the option axis argmin takes the first minimum.
    `variants` defaults to `serve_variants(chip)`.
    """
    if variants is None:
        variants = serve_variants(chip)
    opt_vi, opt_chips, opt_tps, opt_prep = plan_options(
        chip, n_params, kv_bytes_per_token, chips_options, variants)
    days = np.asarray(lifetimes_days, float)          # (nl,)
    qps = np.asarray(qps_grid, float)                 # (nq,)

    feasible = opt_tps[None, None, :] >= qps[None, :, None]
    # amortize 3y chip life
    emb = (opt_chips[None, None, :] * chip.embodied_kg
           * np.minimum(days / (3 * 365.0), 1.0)[:, None, None])
    # energy: chips run at utilization qps/tps — divide only where the
    # option is feasible (masked divide keeps inf/NaN qps demands from
    # raising spurious warnings; infeasible cells mask to +inf below
    # regardless, so feasible cells are bit-identical to the plain form)
    util = np.zeros(feasible.shape)
    np.divide(np.broadcast_to(qps[None, :, None], feasible.shape),
              np.broadcast_to(opt_tps[None, None, :], feasible.shape),
              out=util, where=feasible)
    kwh = (opt_chips[None, None, :] * chip.power_w * PUE * util
           * days[:, None, None] * 24.0 / 1000.0)
    total = opt_prep[None, None, :] + emb + kwh * intensity
    total = np.where(feasible, total, np.inf)         # (nl, nq, K)

    k = np.argmin(total, axis=2)                      # first min wins
    best_kg = np.take_along_axis(total, k[..., None], axis=2)[..., 0]
    met = np.isfinite(best_kg)
    best = np.where(met, opt_vi[k], -1).astype(np.int32)
    best_chips = np.where(met, opt_chips[k], 0).astype(np.int32)
    return {"variant_idx": best, "chips": best_chips, "total_kg": best_kg,
            "variants": [v.name for v in variants]}
