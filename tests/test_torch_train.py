"""The port's training path on the CPU against the reference: the data
pipeline, the optimizers and the schedule, the three families' losses
and gradients, one `make_train_step` step, the checkpointed train loop
and the optimizer-state converters.

The reference runs as `_torch_lm_ref` runs it: parameters from its own
`init_params` (the leaves it initialises to zeros drawn at random, so
each moves the loss), carried to the port by `convert`, its calls under
an Auto-axis mesh. Tolerances: float32 1e-4 (the two differ only in the
order of sums, the chunking of attention and the SSD scan, and XLA's
fusion of the optimizers' elementwise chains). The pipeline is held
element for element, the port's resumed train loop bit for bit to its
own uninterrupted run (the reference's `test_preemption_resume_exact`
fails on this tree, so it cannot witness a resume).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_ref import auto_mesh, ref_params, to_np
from _torch_parity import one_torch_thread  # noqa: F401
from repro.configs.registry import get_smoke_config as ref_smoke_config
from repro.data import pipeline as rpipe
from repro.distributed.meshctx import mesh_context
from repro.launch import steps as rsteps
from repro.launch import train as rtrain
from repro.models.model import build_model as ref_build_model
from repro.optim import optimizers as ropt
from repro.optim import schedule as rsched
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.data import pipeline as ppipe
from repro_torch.distributed import checkpoint as pckpt
from repro_torch.launch import steps as psteps
from repro_torch.launch import train as ptrain
from repro_torch.models.model import build_model
from repro_torch.optim import optimizers as popt
from repro_torch.optim import schedule as psched

TOL = dict(rtol=1e-4, atol=1e-4)
TO_TORCH = {"dense": convert.decoder_params_to_torch,
            "hybrid": convert.hybrid_params_to_torch,
            "ssm": convert.ssm_params_to_torch}
# arch, sequence length (the SSM families' smoke chunk is 32), config
# overrides: the smoke config; two attention tiles; a padded vocabulary
LOSS_CASES = [("qwen2-1.5b", 16, {}), ("qwen2-1.5b", 16, {"attn_chunk": 8}),
              ("qwen2-1.5b", 16, {"vocab": 250}), ("zamba2-7b", 64, {}),
              ("mamba2-1.3b", 64, {})]


def _configs(arch, **kw):
    kw = dict(dtype="float32", **kw)
    return (ref_smoke_config(arch).replace(**kw),
            registry.get_smoke_config(arch).replace(**kw))


def _port_params(pnp, cfg):
    return TO_TORCH[cfg.family](pnp, cfg, "cpu").requires_grad_(True)


def _batch(vocab, b, l, seed=0, masked=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, l + 1)).astype(np.int32)
    mask = np.ones((b, l), np.float32)
    if masked:
        mask[:, : l // 4] = 0.0
        mask[0, -1] = 0.5
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:], "mask": mask}


def _close_tree(got, want, **tol):
    for k, w in want.items():
        if isinstance(w, dict):
            _close_tree(got[k], w, **tol)
        else:
            np.testing.assert_allclose(got[k], to_np(w), err_msg=k,
                                       **(tol or TOL))


# ------------------------------------------------------------- pipeline

@pytest.mark.parametrize("n_hosts", [1, 2])
def test_host_batch_equals_the_reference(n_hosts):
    dcfg = dict(vocab=1000, seq_len=33, global_batch=4, seed=7)
    for step in (0, 1, 5):
        for host in range(n_hosts):
            want = rpipe.host_batch(rpipe.DataConfig(**dcfg), step, host,
                                    n_hosts)
            got = ppipe.host_batch(ppipe.DataConfig(**dcfg), step, host,
                                   n_hosts)
            assert want.keys() == got.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
    it = ppipe.stream(ppipe.DataConfig(**dcfg), start_step=3)
    np.testing.assert_array_equal(next(it)["tokens"], rpipe.host_batch(
        rpipe.DataConfig(**dcfg), 3)["tokens"])


# ----------------------------------------------------------- optimizers

def _leaves(seed):
    """A flat dict of leaves: factored (2-D, 3-D) and unfactored (1-D, a
    (n, 1) column, a scalar-like (1, n) row) shapes."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "w3": (3, 4, 5), "b": (7,), "col": (4, 1),
              "row": (1, 6)}
    return {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}


def _torch(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def test_clip_by_norm_equals_the_reference():
    g = _leaves(0)
    for max_norm in (0.5, 1e3):
        want, wn = ropt.clip_by_norm({k: jnp.asarray(v) for k, v in
                                      g.items()}, max_norm)
        got, gn = popt.clip_by_norm(_torch(g), max_norm)
        np.testing.assert_allclose(float(gn), float(wn), rtol=1e-6)
        _close_tree({k: v.numpy() for k, v in got.items()}, want)


def test_cosine_schedule_equals_the_reference():
    kw = dict(peak_lr=1e-3, warmup=10, total=100, min_frac=0.1)
    for step in (0, 1, 9, 10, 11, 50, 99, 100, 150):
        want = rsched.cosine_schedule(jnp.int32(step), **kw)
        got = psched.cosine_schedule(step, **kw)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(float(psched.cosine_schedule(7)),
                               float(rsched.cosine_schedule(7)), rtol=1e-6)


@pytest.mark.parametrize("master", [False, True])
def test_adamw_update_equals_the_reference_over_steps(master):
    p = _leaves(1)
    rp = {k: jnp.asarray(v) for k, v in p.items()}
    rstate = ropt.adamw_init(rp, master=master)
    tp = _torch(p)
    tstate = popt.adamw_init(tp, master=master)
    assert ("master" in tstate) == master == ("master" in rstate)
    if master:
        _close_tree({k: v.numpy() for k, v in tstate["master"].items()},
                    rstate["master"])
    for step in range(4):
        g = _leaves(10 + step)
        lr = 1e-2 * (step + 1)
        rp, rstate = ropt.adamw_update(rp, {k: jnp.asarray(v) for k, v in
                                            g.items()}, rstate, lr)
        tp, tstate = popt.adamw_update(tp, _torch(g), tstate, lr)
        # the reference's update drops the master copy; so does the port
        assert set(tstate) == set(rstate) == {"step", "m", "v"}
        assert int(tstate["step"]) == int(rstate["step"]) == step + 1
        _close_tree({k: v.numpy() for k, v in tp.items()}, rp)
        for part in ("m", "v"):
            _close_tree({k: v.numpy() for k, v in tstate[part].items()},
                        rstate[part])


def test_adamw_updates_bfloat16_parameters_directly():
    """bfloat16 parameters, float32 m and v: the parameter is updated from
    its own bfloat16 value in float32 and rounded once, as the
    reference's."""
    p = _leaves(2)
    rp = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in p.items()}
    tp = {k: torch.from_numpy(np.array(to_np(v))).to(torch.bfloat16)
          for k, v in rp.items()}
    rstate, tstate = ropt.adamw_init(rp), popt.adamw_init(tp)
    for step in range(3):
        g = _leaves(20 + step)
        rp, rstate = ropt.adamw_update(rp, {k: jnp.asarray(v) for k, v in
                                            g.items()}, rstate, 0.05)
        tp, tstate = popt.adamw_update(tp, _torch(g), tstate, 0.05)
    for k in p:
        assert tp[k].dtype == torch.bfloat16
        # one bfloat16 step where float32 sums round to either side
        np.testing.assert_allclose(to_np(tp[k]), to_np(rp[k]), rtol=1e-2,
                                   atol=1e-2)
        np.testing.assert_allclose(tstate["v"][k].numpy(),
                                   to_np(rstate["v"][k]), **TOL)


def test_adafactor_update_equals_the_reference_over_steps():
    p = _leaves(3)
    assert {k for k, v in p.items() if popt._factored(v.shape)} == \
        {k for k, v in p.items() if ropt._factored(v.shape)} == {"w", "w3"}
    rp = {k: jnp.asarray(v) for k, v in p.items()}
    rstate = ropt.adafactor_init(rp)
    tp = _torch(p)
    tstate = popt.adafactor_init(tp)
    for step in range(4):
        g = _leaves(30 + step)
        kw = dict(wd=0.01, clip_thresh=0.5 if step % 2 else 1.0)
        rp, rstate = ropt.adafactor_update(rp, {k: jnp.asarray(v) for k, v
                                                in g.items()}, rstate, 0.02,
                                           **kw)
        tp, tstate = popt.adafactor_update(tp, _torch(g), tstate, 0.02, **kw)
        _close_tree({k: v.numpy() for k, v in tp.items()}, rp)
        got = convert.adafactor_state_to_numpy(tstate)
        assert int(got["step"]) == step + 1
        _close_tree(got["vs"], rstate["vs"])
    # the converters carry the reference's state across and back
    back = convert.adafactor_state_to_numpy(convert.adafactor_state_to_torch(
        jax.tree.map(to_np, rstate), "cpu"))
    _close_tree(back["vs"], rstate["vs"], rtol=0, atol=0)


def test_make_optimizer_names():
    assert popt.make_optimizer("adamw") == (popt.adamw_init,
                                            popt.adamw_update)
    assert popt.make_optimizer("adafactor") == (popt.adafactor_init,
                                                popt.adafactor_update)
    with pytest.raises(ValueError):
        popt.make_optimizer("sgd")


# ---------------------------------------------------------------- losses

@pytest.mark.parametrize("arch,seq,kw", LOSS_CASES)
def test_loss_and_every_gradient_equal_the_reference(arch, seq, kw):
    rcfg, cfg = _configs(arch, **kw)
    params, pnp = ref_params(rcfg, perturb=True)
    bt = _batch(cfg.vocab, 2, seq, masked=True)
    rm = ref_build_model(rcfg)
    with mesh_context(auto_mesh()):
        (wl, wm), wg = jax.jit(jax.value_and_grad(rm.loss_fn, has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in bt.items()})
    model = build_model(cfg)
    tp = _port_params(pnp, cfg)
    loss, metrics = model.loss_fn(tp, {k: torch.as_tensor(v)
                                       for k, v in bt.items()})
    assert set(metrics) == set(wm) == {"xent"}
    np.testing.assert_allclose(float(loss.detach()), float(wl), **TOL)
    named = dict(tp.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss,
                                                list(named.values()))))
    _close_tree(convert.lm_params_to_numpy(grads, cfg), wg)


def test_remat_changes_no_gradient():
    """`cfg.remat` recomputes each layer in the backward: the loss and
    the gradients equal the run without it, bit for bit."""
    out = []
    for remat in (True, False):
        rcfg, cfg = _configs("zamba2-7b", remat=remat)
        _, pnp = ref_params(rcfg, perturb=True)
        tp = _port_params(pnp, cfg)
        bt = {k: torch.as_tensor(v) for k, v in
              _batch(cfg.vocab, 2, 64).items()}
        loss, _ = build_model(cfg).loss_fn(tp, bt)
        out.append([loss] + list(torch.autograd.grad(
            loss, list(tp.parameters()))))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_parameters_are_frozen_unless_trainable():
    cfg = registry.get_smoke_config("qwen2-1.5b")
    model = build_model(cfg)
    g = torch.Generator().manual_seed(0)
    assert not any(p.requires_grad for p in
                   model.init_params(g, "cpu").parameters())
    assert all(p.requires_grad for p in
               model.init_params(g, "cpu", trainable=True).parameters())


# ------------------------------------------------------------ train step

# (grad_accum, arch, sequence length): the SSM families' smoke chunk is
# 32, so 64 steps run two chunks of the scan
STEP_CASES = [(1, "qwen2-1.5b", 16), (2, "qwen2-1.5b", 16),
              (1, "mamba2-1.3b", 64), (2, "mamba2-1.3b", 64),
              (1, "zamba2-7b", 64), (2, "zamba2-7b", 64)]


@pytest.mark.parametrize(
    "grad_accum,arch,seq", STEP_CASES,
    ids=[str(ga) if arch == "qwen2-1.5b" else f"{arch}-{ga}"
         for ga, arch, _ in STEP_CASES])
def test_train_step_equals_the_reference(grad_accum, arch, seq):
    """One step from a nonzero AdamW state (carried by the converters):
    parameters, m, v and the metrics."""
    rcfg, cfg = _configs(arch)
    params, pnp = ref_params(rcfg, perturb=True)
    rng = np.random.default_rng(5)
    m = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32)
                     * 1e-2, pnp)
    v = jax.tree.map(lambda x: rng.uniform(size=x.shape).astype(np.float32)
                     * 1e-4, pnp)
    rstate = {"step": jnp.int32(3), "m": jax.tree.map(jnp.asarray, m),
              "v": jax.tree.map(jnp.asarray, v)}
    bt = _batch(cfg.vocab, 4, seq, seed=1)
    lr_kwargs = {"warmup": 2, "total": 20, "peak_lr": 1e-2}
    step = 4
    rm = ref_build_model(rcfg)
    _, rstep = rsteps.make_train_step(rm, grad_accum=grad_accum,
                                      lr_kwargs=lr_kwargs)
    with mesh_context(auto_mesh()):
        wp, wstate, wmet = jax.jit(rstep)(
            params, rstate, {k: jnp.asarray(x) for k, x in bt.items()},
            jnp.int32(step))
    model = build_model(cfg)
    opt_init, pstep = psteps.make_train_step(model, grad_accum=grad_accum,
                                             lr_kwargs=lr_kwargs)
    tp = _port_params(pnp, cfg)
    tstate = convert.adamw_state_to_torch(
        {"step": 3, "m": m, "v": v}, cfg, "cpu")
    assert set(opt_init(tp)) == {"step", "m", "v"}
    tp, tstate, met = pstep(tp, tstate, {k: torch.as_tensor(x)
                                         for k, x in bt.items()}, step)
    assert set(met) == set(wmet)
    for k in met:
        np.testing.assert_allclose(float(met[k]), float(wmet[k]), **TOL)
    _close_tree(convert.lm_params_to_numpy(dict(tp.named_parameters()),
                                           cfg), wp)
    got = convert.adamw_state_to_numpy(tstate, cfg)
    assert int(got["step"]) == int(wstate["step"]) == 4
    _close_tree(got["m"], wstate["m"])
    _close_tree(got["v"], wstate["v"])


def test_train_step_refuses_a_batch_grad_accum_does_not_split():
    """The reference's reshape into micro-batches raises; so does the
    port, rather than drop the remainder."""
    cfg = registry.get_smoke_config("qwen2-1.5b").replace(dtype="float32")
    model = build_model(cfg)
    opt_init, step = psteps.make_train_step(model, grad_accum=2)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu",
                               trainable=True)
    bt = {k: torch.as_tensor(v) for k, v in _batch(cfg.vocab, 3, 8).items()}
    with pytest.raises(ValueError, match="grad_accum = 2"):
        step(params, opt_init(params), bt, 0)


def test_step_builders_call_the_model():
    cfg = registry.get_smoke_config("qwen2-1.5b").replace(dtype="float32")
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 8))
    with torch.inference_mode():
        lp, cache = psteps.make_prefill_step(model, 12)(params,
                                                        {"tokens": toks})
        ld, _ = psteps.make_decode_step(model)(params, cache, toks[:, :1], 8)
        want, _ = model.prefill_fn(params, {"tokens": toks}, 12)
    assert torch.equal(lp, want) and ld.shape == (2, 1, 256)


# ------------------------------------------------------------ converters

@pytest.mark.parametrize("arch", ["qwen2-1.5b", "zamba2-7b", "mamba2-1.3b"])
def test_lm_params_to_numpy_inverts_the_converters(arch):
    rcfg, cfg = _configs(arch)
    _, pnp = ref_params(rcfg, perturb=True)
    back = convert.lm_params_to_numpy(
        dict(TO_TORCH[cfg.family](pnp, cfg, "cpu").named_parameters()), cfg)
    assert jax.tree.structure(back) == jax.tree.structure(pnp)
    _close_tree(back, pnp, rtol=0, atol=0)
    state = {"step": 7, "m": pnp, "v": jax.tree.map(np.abs, pnp)}
    got = convert.adamw_state_to_numpy(
        convert.adamw_state_to_torch(state, cfg, "cpu"), cfg)
    assert int(got["step"]) == 7
    _close_tree(got["m"], state["m"], rtol=0, atol=0)
    _close_tree(got["v"], state["v"], rtol=0, atol=0)


# ------------------------------------------------------------ train loop

def test_train_loop_resumes_bit_for_bit(tmp_path):
    """4 steps at grad_accum 2 in one run, against 2 steps, a checkpoint,
    and a new `train_loop` that resumes from it to 4: the losses of steps
    2-3 and every parameter and optimizer leaf equal bit for bit."""
    cfg = registry.get_smoke_config("qwen2-1.5b").replace(dtype="float32")
    kw = dict(cfg=cfg, steps=4, batch=4, seq=16, grad_accum=2,
              lr_kwargs={"warmup": 1}, device="cpu", log=lambda *a: None)
    full = ptrain.train_loop(ckpt_dir="", **kw)
    d = str(tmp_path / "ckpt")
    first = ptrain.train_loop(ckpt_dir=d, **dict(kw, steps=2))
    assert first["losses"] == full["losses"][:2]
    assert pckpt.latest_step(d) == 2
    logs = []
    resumed = ptrain.train_loop(ckpt_dir=d, **dict(kw, log=logs.append))
    assert logs[0] == "[train] resumed from step 2"
    assert resumed["losses"] == full["losses"][2:]
    for (k, a), b in zip(full["params"].named_parameters(),
                         resumed["params"].parameters()):
        assert torch.equal(a, b), k
    for part in ("m", "v"):
        for k, a in full["opt_state"][part].items():
            assert torch.equal(a, resumed["opt_state"][part][k]), k
    assert int(resumed["opt_state"]["step"]) == 4
    # the checkpoint is one flat dict: params/, opt/ and step
    tree, step = pckpt.restore(d, ptrain.flat_state(
        resumed["params"], resumed["opt_state"], 0))
    assert step == 4 and int(tree["step"]) == 4
    assert {k.split("/")[0] for k in tree} == {"params", "opt", "step"}


def test_train_loop_loss_falls_and_matches_the_reference_data():
    cfg = registry.get_smoke_config("qwen2-1.5b").replace(dtype="float32")
    out = ptrain.train_loop(cfg=cfg, steps=12, batch=4, seq=16, ckpt_dir="",
                            lr_kwargs={"warmup": 1, "peak_lr": 3e-3},
                            device="cpu", log=lambda *a: None)
    assert len(out["losses"]) == 12 and np.all(np.isfinite(out["losses"]))
    assert out["losses"][-1] < out["losses"][0]
    assert len(out["dts"]) == 12


def test_straggler_watchdog_equals_the_reference():
    ts = [1.0, 1.1, 0.9, 1.0, 5.0, 1.0, 3.0]
    want, got = rtrain.StragglerWatchdog(), ptrain.StragglerWatchdog()
    assert [want.observe(i, t) for i, t in enumerate(ts)] == \
        [got.observe(i, t) for i, t in enumerate(ts)]
    assert got.flagged == want.flagged == [(4, 5.0), (6, 3.0)]


def test_train_cli_refuses_the_production_mesh():
    """Without 256 ranks the production mesh cannot train: the error
    says so and names ROADMAP.md item 13g. The dense family's model axis
    of 16 is tensor parallelism, which is ported; an SSM's is not, and
    the error says that too."""
    with pytest.raises(NotImplementedError,
                       match="needs 256 ranks.*13g") as e:
        ptrain.main(["--production-mesh", "--smoke", "--device", "cpu"])
    assert "model axis" not in str(e.value)
    with pytest.raises(NotImplementedError,
                       match="needs 256 ranks.*model axis of 16.*13g"):
        ptrain.main(["--production-mesh", "--smoke", "--device", "cpu",
                     "--arch", "mamba2-1.3b"])
