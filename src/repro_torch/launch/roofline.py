"""Roofline terms of a dry-run cell on the NVIDIA H100 (a port of the
reference's `launch/roofline.py`, whose constants are another chip's):

  compute term    = FLOPs a device / the card's bfloat16 dense peak
  memory term     = bytes a device / the card's HBM rate
  collective term = collective bytes a device / the link's rate

The card is the one this port is measured on: NVIDIA H100 80GB HBM3
(SXM) at its full 700 W power limit, 989e12 bfloat16 dense FLOP/s and
3.35e12 HBM bytes/s (NVIDIA's data sheet); a card set to a lower power
limit runs slower under load. Links are a DGX H100's: NVLink 4 at 450e9
bytes/s a direction a card inside an 8-card node, and 400 Gb/s NDR
InfiniBand (50e9 bytes/s a card) between nodes. A mesh axis pays its
slowest link: one whose ranks span nodes pays InfiniBand.

The FLOPs, bytes and collective bytes a device come from
`launch/op_analysis.py`. `chip_smoke.py` takes its bounds' peaks from
here.
"""
from __future__ import annotations

import math
from typing import Dict

CARD = "NVIDIA H100 80GB HBM3"
POWER_LIMIT_W = 700.0
BF16_OPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80 * 2**30           # what a device may hold, to `fits`
NVLINK_BYTES_PER_S = 450e9
IB_BYTES_PER_S = 50e9
CARDS_PER_NODE = 8


def axis_link_bytes_per_s(shape: Dict[str, int], axis: str) -> float:
    """The link rate a collective over `axis` of a mesh of `shape`
    ({axis: size}, ranks laid out in C order, CARDS_PER_NODE a node)
    pays: NVLink where its ranks share a node, else InfiniBand."""
    names = list(shape)
    stride = math.prod(shape[a] for a in names[names.index(axis) + 1:])
    nodes = {i * stride // CARDS_PER_NODE for i in range(shape[axis])}
    return NVLINK_BYTES_PER_S if len(nodes) == 1 else IB_BYTES_PER_S


def card() -> Dict:
    """The constants a roofline here uses, with the card's name."""
    return {"name": CARD, "power_limit_w": POWER_LIMIT_W,
            "bf16_ops_per_s": BF16_OPS_PER_S,
            "hbm_bytes_per_s": HBM_BYTES_PER_S,
            "nvlink_bytes_per_s": NVLINK_BYTES_PER_S,
            "ib_bytes_per_s": IB_BYTES_PER_S}


def roofline_terms(result: Dict, n_chips: int,
                   link_bytes_per_s: float = None) -> Dict:
    """Three terms (seconds) + bottleneck + usefulness ratio.

    `result` must contain 'hlo' (`op_analysis.analyze`'s keys) and
    'model_flops'. `link_bytes_per_s`: the collectives' link (by default
    NVLink up to one node's cards, else InfiniBand)."""
    if link_bytes_per_s is None:
        link_bytes_per_s = (NVLINK_BYTES_PER_S if n_chips <= CARDS_PER_NODE
                            else IB_BYTES_PER_S)
    h = result.get("hlo", {})
    flops_dev = float(h.get("flops_per_device", 0.0))
    bytes_dev = float(h.get("bytes_per_device", 0.0))
    coll_dev = float(h.get("collective_bytes_per_device", 0.0))

    terms = {"compute_s": flops_dev / BF16_OPS_PER_S,
             "memory_s": bytes_dev / HBM_BYTES_PER_S,
             "collective_s": coll_dev / link_bytes_per_s}
    dom = max(terms, key=terms.get)
    mf = float(result.get("model_flops", 0.0))
    flops_global = flops_dev * n_chips
    bound = max(max(terms.values()), 1e-30)
    # the kind's ideal step over the bound step: train and prefill are
    # compute-ideal (MFU-style); decode is memory-ideal, every step
    # streaming at least the weights and the batch's decode state
    ideal_s = mf / (n_chips * BF16_OPS_PER_S)
    if result.get("kind") == "decode":
        floor_bytes = (float(result.get("param_bytes", 0))
                       + float(result.get("cache_bytes", 0))) / n_chips
        ideal_s = max(ideal_s, floor_bytes / HBM_BYTES_PER_S)
    return {
        **terms,
        "bottleneck": dom,
        "model_flops": mf,
        "hlo_flops": flops_global,
        "useful_ratio": (mf / flops_global) if flops_global else 0.0,
        "bound_step_s": bound,
        "ideal_step_s": ideal_s,
        "roofline_fraction": ideal_s / bound,
        "link_bytes_per_s": link_bytes_per_s,
        "card": card(),
    }
