"""The port's dry run on fake tensors (`launch/{op_analysis,roofline,
dryrun}.py`, `models/model.py`'s counts) without a card: `model_flops`
and `active_params` against the reference's for every config and cell,
the roofline's arithmetic and decode floor at the H100's constants (the
reference's `tests/test_hlo_analysis.py` cases), the op counter's closed
forms, and one train, one prefill and one decode cell through the CLI.
"""
import json

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs.base import SHAPES_BY_NAME as REF_SHAPES
from repro.configs.registry import get_config as ref_get_config
from repro.models import model as rmodel
from repro_torch.configs.base import SHAPES_BY_NAME
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.launch import dryrun
from repro_torch.launch import op_analysis as OA
from repro_torch.launch import roofline as RF
from repro_torch.models import model as pmodel


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_active_params_equal_the_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    n = 1_000_003_007 * (3 if cfg.moe else 1)
    assert pmodel.active_params(cfg, n) == rmodel.active_params(rcfg, n)
    for name, shape in SHAPES_BY_NAME.items():
        assert pmodel.model_flops(cfg, shape, n) == rmodel.model_flops(
            rcfg, REF_SHAPES[name], n)


def test_roofline_terms_arithmetic():
    res = {"hlo": {"flops_per_device": RF.BF16_OPS_PER_S,   # 1 s compute
                   "bytes_per_device": RF.HBM_BYTES_PER_S / 2,  # 0.5 s
                   "collective_bytes_per_device": RF.IB_BYTES_PER_S / 4},
           "model_flops": RF.BF16_OPS_PER_S * 256 * 0.25,   # 0.25 s ideal
           "kind": "train"}
    r = RF.roofline_terms(res, 256)
    assert r["bottleneck"] == "compute_s"
    np.testing.assert_allclose(r["bound_step_s"], 1.0)
    np.testing.assert_allclose(r["collective_s"], 0.25)
    np.testing.assert_allclose(r["roofline_fraction"], 0.25)
    np.testing.assert_allclose(r["useful_ratio"], 0.25)
    assert r["card"]["name"] == "NVIDIA H100 80GB HBM3"
    assert r["card"]["power_limit_w"] == 700.0
    assert (RF.BF16_OPS_PER_S, RF.HBM_BYTES_PER_S) == (989e12, 3.35e12)


def test_decode_fraction_uses_memory_floor():
    res = {"hlo": {"flops_per_device": 1e6,
                   "bytes_per_device": RF.HBM_BYTES_PER_S,  # 1 s memory
                   "collective_bytes_per_device": 0.0},
           "model_flops": 1e6,
           "param_bytes": RF.HBM_BYTES_PER_S * 64,          # 0.25 s floor
           "cache_bytes": 0,
           "kind": "decode"}
    r = RF.roofline_terms(res, 256)
    np.testing.assert_allclose(r["roofline_fraction"], 0.25)


def test_an_axis_pays_its_slowest_link():
    """Ranks in C order, 8 cards a node: (16, 16)'s data axis strides 16
    ranks (InfiniBand); a (2, 4) mesh's model axis stays in a node."""
    assert RF.axis_link_bytes_per_s({"data": 16, "model": 16}, "data") == \
        RF.IB_BYTES_PER_S
    assert RF.axis_link_bytes_per_s({"data": 16, "model": 16}, "model") == \
        RF.IB_BYTES_PER_S
    assert RF.axis_link_bytes_per_s({"data": 2, "model": 4}, "model") == \
        RF.NVLINK_BYTES_PER_S
    assert RF.axis_link_bytes_per_s({"data": 2, "model": 4}, "data") == \
        RF.NVLINK_BYTES_PER_S


@pytest.mark.parametrize("n", [1, 3])
def test_op_counter_closed_forms(n):
    """n matmuls of (M, K) x (K, N): 2 M N K FLOPs and (MK + KN + MN) x 4
    bytes each; a view moves nothing; a state tensor's bytes count at its
    share, per device."""
    m, k, nn = 64, 48, 80
    with FakeTensorMode() as mode:
        a = torch.empty((m, k))
        w = torch.empty((k, nn))
    counter = OA.OpCounter({OA._key(w): 0.25})
    with mode, counter:
        for _ in range(n):
            (a @ w).t()
    assert counter.flops == n * 2 * m * nn * k
    assert counter.bytes == n * (m * k + m * nn) * 4
    assert counter.state_bytes == n * k * nn * 4 * 0.25
    assert counter.ops["mm"] == n and counter.ops["t"] == n
    h = OA.analyze(counter, 4, allreduce_bytes=100.0)
    assert h["flops_per_device"] == counter.flops / 4
    assert h["bytes_per_device"] == counter.bytes / 4 + counter.state_bytes
    assert h["collective_per_op"]["all-reduce"] == 200.0
    assert h["collective_counts"]["all-reduce"] == 1
    assert h["unknown_trip_counts"] == 0


@pytest.mark.parametrize("shape,multi_pod", [("train_4k", False),
                                             ("prefill_32k", False),
                                             ("decode_32k", True)])
def test_dryrun_cell_writes_its_json(tmp_path, shape, multi_pod):
    """Whisper-tiny's cells through the CLI: positive terms, the mesh,
    per-device memory that fits, the H100 beside its roofline."""
    argv = ["--arch", "whisper-tiny", "--shape", shape, "--out",
            str(tmp_path)] + (["--multi-pod"] if multi_pod else [])
    dryrun.main(argv)
    tag = f"whisper-tiny__{shape}__{'pod2' if multi_pod else 'pod1'}"
    res = json.loads((tmp_path / f"{tag}.json").read_text())
    assert res["status"] == "ok", res.get("error")
    assert res["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert res["n_params"] == 61153536
    h, rf = res["hlo"], res["roofline"]
    assert h["flops_per_device"] > 0 and h["bytes_per_device"] > 0
    assert rf["compute_s"] > 0 and rf["memory_s"] > 0
    assert rf["card"]["name"] == "NVIDIA H100 80GB HBM3"
    assert res["memory"]["fits"] and res["memory"]["param_bytes"] > 0
    assert res["kind"] == SHAPES_BY_NAME[shape].kind
    if shape == "train_4k":
        assert h["collective_counts"]["all-reduce"] == 1
        assert rf["collective_s"] > 0 and res["memory"]["opt_bytes"] > 0
    if shape == "decode_32k":
        assert res["cache_bytes"] > 0 and res["memory"]["cache_bytes"] > 0


def test_long_context_skips_attention_archs():
    res = dryrun.lower_cell("qwen2-1.5b", "long_500k")
    assert res["status"] == "skip"
