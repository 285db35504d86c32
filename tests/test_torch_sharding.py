"""The port's sharding rules (`distributed/sharding.py`) against the
reference's `distributed/sharding.py`, leaf for leaf, with no process
group: every parameter of all ten configs at full size (the reference's
`abstract_params`, the port's fake-tensor parameters), on six meshes;
AdamW's m and v and Adafactor's stacked `vs`, with `zero1` on and off;
the batch of every cell, the `decode_32k` cache, and the fleet's lane,
stage and bank layouts. The port's specs are the reference's split at
the stacked layer axes (`ParamSpec`, `CachePart`), so each is compared
with its reference leaf's spec, stacked part included. Also the abstract
parameter count against the reference's `count_params_abstract`.
"""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs.base import SHAPES_BY_NAME as REF_SHAPES
from repro.configs.registry import get_config as ref_get_config
from repro.distributed import sharding as rs
from repro.models.model import build_model as ref_build_model
from repro.models.model import count_params_abstract as ref_count
from repro.models.model import input_specs as ref_input_specs
from repro.optim import optimizers as ropt
from repro_torch import convert
from repro_torch.configs.base import SHAPES_BY_NAME
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.distributed import sharding as ps
from repro_torch.flexibits.iss import ISSState, PackedState
from repro_torch.models.model import build_model, input_specs
from repro_torch.optim import optimizers as popt

MESHES = [(("data", "model"), (1, 1)), (("data", "model"), (1, 2)),
          (("data", "model"), (2, 4)), (("data", "model"), (4, 4)),
          (("data", "model"), (16, 16)),
          (("pod", "data", "model"), (2, 16, 16))]


def _meshes():
    return [(rs.abstract_mesh(n, s), ps.AbstractMesh(n, s)) for n, s in
            MESHES]


@functools.lru_cache(maxsize=None)
def _abstract(arch):
    """(the reference's abstract parameters, the port's fake parameters
    as {name: tensor}, the fake mode they belong to), once an arch."""
    mode = FakeTensorMode()
    params = build_model(get_config(arch)).abstract_params(fake_mode=mode)
    return (ref_build_model(ref_get_config(arch)).abstract_params(),
            dict(params.named_parameters()), mode)


def _ref_specs(tree):
    """{path of keys: spec tuple} of a tree of NamedShardings."""
    return {tuple(k.key for k in path): tuple(s.spec) for path, s in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _check_params(psh, rsh, leaves, prefix=()):
    """Every reference leaf's spec equals each of its port names' stack
    and own specs joined."""
    want = _ref_specs(rsh)
    n = 0
    for path, (names, stack) in leaves.items():
        for name in names:
            got = psh[name]
            assert len(got.stack) == len(stack), (path, name)
            assert got.stack + got.spec == want[prefix + path], (path, name)
            n += 1
    assert n == len(psh)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(arch):
    ref_abs, named, _ = _abstract(arch)
    cfg = get_config(arch)
    leaves = convert.reference_leaves(named, cfg)
    assert sum(len(v[0]) for v in leaves.values()) == len(named)
    for rmesh, pmesh in _meshes():
        _check_params(ps.param_shardings(named, cfg, pmesh),
                      rs.param_shardings(ref_abs, rmesh), leaves)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_parameter_count_equals_the_reference(arch):
    _, named, _ = _abstract(arch)
    assert sum(p.numel() for p in named.values()) == ref_count(
        ref_build_model(ref_get_config(arch)))


def test_shared_expert_rule_shards_the_stacked_layer_axis():
    """The reference's expert rule reads the stacked shared expert (L, D,
    F) as (E, D, F): at a model axis of 2, Qwen2-MoE's 24 layers divide,
    so `shared/wi` is split over its layers; at 16 they do not, and F is."""
    _, named, _ = _abstract("qwen2-moe-a2.7b")
    cfg = get_config("qwen2-moe-a2.7b")
    name = "layers.0.moe.shared.wi"
    at = {s: ps.param_shardings(named, cfg, ps.AbstractMesh(
        ("data", "model"), s))[name] for s in ((1, 2), (16, 16))}
    assert at[(1, 2)] == ps.ParamSpec(("model",), (None, None))
    assert at[(16, 16)] == ps.ParamSpec((None,), (None, "model"))
    rsh = rs.param_shardings(_abstract("qwen2-moe-a2.7b")[0],
                             rs.abstract_mesh(("data", "model"), (1, 2)))
    assert tuple(rsh["moe_layers"]["moe"]["shared"]["wi"].spec) == (
        "model", None, None)


@pytest.mark.parametrize("zero1", [False, True], ids=["plain", "zero1"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_optimizer_state_specs_equal_the_reference(arch, zero1):
    """AdamW's m and v under the port's names, and Adafactor's stacked
    `vs` under the reference's paths, with and without ZeRO-1."""
    ref_abs, named, mode = _abstract(arch)
    cfg = get_config(arch)
    leaves = convert.reference_leaves(named, cfg)
    with mode:
        adamw = popt.adamw_init(named)
        ada = popt.adafactor_init(named, leaves=leaves)
    r_adamw = jax.eval_shape(ropt.adamw_init, ref_abs)
    r_ada = jax.eval_shape(ropt.adafactor_init, ref_abs)
    for rmesh, pmesh in _meshes():
        got = ps.opt_shardings(adamw, cfg, pmesh, zero1=zero1)
        want = rs.opt_shardings(r_adamw, rmesh, zero1=zero1)
        assert got["step"] == ps.ParamSpec((), ())
        for k in ("m", "v"):
            _check_params(got[k], want[k], leaves)
        got = ps.opt_shardings(ada, cfg, pmesh, zero1=zero1)
        want = _ref_specs(rs.opt_shardings(r_ada, rmesh, zero1=zero1))

        def walk(path, tree):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(path + (k,), v)
                else:
                    assert v.stack == () and v.spec == want[path + (k,)], \
                        path + (k,)
        walk(("vs",), got["vs"])
        assert len(want) == 1 + sum(
            len(v) for v in jax.tree.leaves(
                got["vs"], is_leaf=lambda x: isinstance(x, dict) and all(
                    isinstance(y, ps.ParamSpec) for y in x.values())))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_equal_the_reference(arch):
    """Every cell's batch (`input_specs`' shapes and dtypes equal the
    reference's), and the `decode_32k` cache, each of the reference's
    cache leaves against the port leaf's part that holds its layers."""
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for name, shape in SHAPES_BY_NAME.items():
        got, want = input_specs(cfg, shape), ref_input_specs(
            rcfg, REF_SHAPES[name])
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in got.items()} == {
            k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
        assert all(v.device.type == "meta" for v in got.values())
        for rmesh, pmesh in _meshes():
            assert ps.batch_shardings(got, pmesh) == {
                k: tuple(v.spec) for k, v in
                rs.batch_shardings(want, rmesh).items()}
    shape = SHAPES_BY_NAME["decode_32k"]
    _, _, mode = _abstract(arch)
    with mode:
        cache = build_model(cfg).init_cache(shape.global_batch,
                                            shape.seq_len, device="cpu")
    rcache = jax.eval_shape(lambda: ref_build_model(rcfg).init_cache(
        shape.global_batch, shape.seq_len))
    where = convert.reference_cache_leaves(cache, cfg)
    for rmesh, pmesh in _meshes():
        got = ps.cache_shardings(cache, cfg, pmesh)
        want = _ref_specs(rs.cache_shardings(rcache, rmesh))
        assert set(want) == set(where)
        for path, (key, start, stop, stack) in where.items():
            part, = [p for p in got[key] if (p.start, p.stop) == (start,
                                                                   stop)]
            assert len(part.stack) == len(stack)
            assert part.stack + part.spec == want[path], path
        assert sum(p.stop - p.start for k in got for p in got[k]) == sum(
            v.shape[0] for v in cache.values())


def test_fleet_lane_stage_and_bank_specs_equal_the_reference():
    lanes = ISSState(*(torch.zeros((8,) + (4,) * (i % 3), dtype=torch.int32)
                       for i in range(len(ISSState._fields))))
    packed = PackedState(lanes, torch.zeros(8, dtype=torch.int32),
                         torch.zeros(8, dtype=torch.int32))
    stage = {"regs": torch.zeros((4, 2, 16)), "pc": torch.zeros((4, 2))}
    bank = {"bank": torch.zeros((3, 64)), "clen": torch.zeros((3,))}

    def ref(tree):
        return jax.tree.map(lambda t: jnp.zeros(t.shape), tree,
                            is_leaf=lambda t: isinstance(t, torch.Tensor))

    def flat(tree):
        return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, tuple)
                               and not hasattr(x, "_fields"))
    for rmesh, pmesh in _meshes():
        for fn in ("lane_specs", "stage_specs", "bank_specs"):
            for tree in (packed, stage, bank):
                got = getattr(ps, fn)(pmesh, tree)
                want = getattr(rs, fn)(rmesh, ref(tree))
                assert type(got) is type(tree)
                assert flat(got) == [tuple(s) for s in jax.tree.leaves(
                    want, is_leaf=lambda x: isinstance(
                        x, jax.sharding.PartitionSpec))], fn


def test_distribute_keeps_unsplit_tensors_and_refuses_split_layers():
    """A tensor whose spec names only axes of size 1 stays the tensor
    itself; a stacked layer index split over an axis of size > 1 needs
    ROADMAP.md item 13g."""
    t = torch.ones(4, 2)
    spec = ps.ParamSpec(("model",), (None, "model"))
    one = ps.AbstractMesh(("data", "model"), (1, 1))
    assert ps.distribute({"w": t}, {"w": spec}, one)["w"] is t
    two = ps.AbstractMesh(("data", "model"), (1, 2))
    with pytest.raises(NotImplementedError, match="13g"):
        ps.distribute({"w": t}, {"w": spec}, two)
