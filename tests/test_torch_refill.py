"""The resident loop's refill pieces against the reference: the staged->
lane assignment (`refill_take`), the swap (`refill_lanes`, the plain
version of the `iss_refill` kernel) against the reference's jnp swap and
its Pallas `iss_refill` kernel (interpret mode), and the whole retire/
refill op (`engine.retire_refill`) against the reference's compiled
`_resident_refill_runner` at one shard, stats block included."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from _torch_parity import one_torch_thread  # noqa: F401
from repro.fleet import engine as reng
from repro.flexibits import iss as riss
from repro.kernels.iss_stepper import iss_refill as ref_iss_refill
from repro_torch import convert
from repro_torch.fleet import engine
from repro_torch.flexibits import iss
from repro_torch.kernels import iss_stepper


def _jnp_packed(st):
    return riss.PackedState(
        lanes=riss.ISSState(*(jnp.asarray(x) for x in st.lanes)),
        prog_id=jnp.asarray(st.prog_id), max_steps=jnp.asarray(st.max_steps))


def _random_pool(rng, n, m, n_progs):
    st = tp.soup_state(rng, n, m, n_progs)
    return st._replace(
        lanes=st.lanes._replace(
            pc=rng.integers(0, 64, n).astype(np.int32),
            n_instr=rng.integers(0, 60, n).astype(np.int32),
            n_two_stage=rng.integers(0, 20, n).astype(np.int32),
            mix=rng.integers(0, 9, (n, 8)).astype(np.int32),
            n_cycles=rng.integers(0, 999, n).astype(np.int32)),
        max_steps=rng.integers(1, 99, n).astype(np.int32))


@pytest.mark.parametrize("seed", range(4))
def test_refill_take_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    free = rng.random(n) < rng.random()
    for n_staged in (0, 1, int(rng.integers(0, n + 1)), n, n + 5):
        want = riss.refill_take(jnp.asarray(free),
                                jnp.asarray(n_staged, jnp.int32))
        got = iss.refill_take(torch.from_numpy(free),
                              torch.tensor([n_staged], dtype=torch.int32))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", range(3))
def test_refill_swap_matches_reference_jnp_and_kernel(seed):
    """Random pool, random free set, staged batches smaller and larger
    than the free set: the port's swap (plain, and its wrapper on the
    CPU) equals the reference's jnp swap and its Pallas kernel,
    un-taken lanes included."""
    rng = np.random.default_rng(100 + seed)
    n, m, rows = 24, 20, 24
    st = _random_pool(rng, n, m, 4)
    free = rng.random(n) < 0.6
    smem = rng.integers(-99, 99, (rows, m)).astype(np.int32)
    sprog = rng.integers(0, 4, rows).astype(np.int32)
    sms = rng.integers(1, 99, rows).astype(np.int32)
    for n_staged in (3, rows):
        take, src = riss.refill_take(jnp.asarray(free),
                                     jnp.asarray(n_staged, jnp.int32))
        ref_j = riss.refill_lanes(_jnp_packed(st), take, src,
                                  jnp.asarray(smem), jnp.asarray(sprog),
                                  jnp.asarray(sms))
        ref_k = jax.jit(lambda *xs: ref_iss_refill(*xs, lane_tile=8))(
            _jnp_packed(st), take, src, jnp.asarray(smem),
            jnp.asarray(sprog), jnp.asarray(sms))
        args = (torch.from_numpy(np.array(take)),
                torch.from_numpy(np.array(src)), torch.from_numpy(smem),
                torch.from_numpy(sprog), torch.from_numpy(sms))
        plain = iss.refill_lanes(convert.packed_to_torch(st, "cpu"), *args)
        wrapped = iss_stepper.iss_refill(convert.packed_to_torch(st, "cpu"),
                                         *args, device="cpu")
        for name, got in (("plain", plain), ("wrapper", wrapped)):
            got = convert.packed_to_numpy(got)
            tp.assert_packed_equal(ref_j, got, f"{name} vs jnp")
            tp.assert_packed_equal(ref_k, got, f"{name} vs kernel")


@pytest.mark.parametrize("keep_state", [False, True])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_retire_refill_op_matches_reference_runner(keep_state, use_pallas):
    """One retire/refill on a random pool: new lane state, item slots,
    every accumulator row, the per-group mix sums and the stats block
    [retired, taken, max step delta, active lanes per group] equal the
    reference's op."""
    rng = np.random.default_rng(7 + 2 * keep_state + use_pallas)
    n, m, n_groups, cap = 24, 16, 3, 40
    st = _random_pool(rng, n, m, n_groups)
    st = st._replace(lanes=st.lanes._replace(
        halted=rng.random(n) < 0.4))
    slot = np.full(n, -1, np.int32)
    occupied = rng.random(n) < 0.75
    slot[occupied] = rng.permutation(cap)[:occupied.sum()]
    acc = reng.ResidentAcc(
        n_instr=rng.integers(0, 50, cap).astype(np.int32),
        n_two=rng.integers(0, 50, cap).astype(np.int32),
        n_cycles=rng.integers(0, 500, cap).astype(np.int32),
        halted=rng.random(cap) < 0.5,
        out=rng.integers(-9, 9, cap).astype(np.int32),
        mix_g=rng.integers(0, 99, (1, n_groups, 8)).astype(np.int32),
        prev_instr=rng.integers(0, 30, n).astype(np.int32),
        mems=rng.integers(-9, 9, (cap, m)).astype(np.int32)
        if keep_state else None,
        regs=rng.integers(-9, 9, (cap, 16)).astype(np.int32)
        if keep_state else None,
        pc=rng.integers(0, 9, cap).astype(np.int32) if keep_state else None,
        mix_items=rng.integers(0, 9, (cap, 8)).astype(np.int32)
        if keep_state else None)
    staged = (rng.integers(-99, 99, (n, m)).astype(np.int32),
              rng.integers(0, n_groups, n).astype(np.int32),
              rng.integers(1, 99, n).astype(np.int32),
              rng.integers(0, cap, n).astype(np.int32))
    n_staged = np.array([9], np.int32)
    out_addr = np.array([-1, 3, m - 1], np.int32)

    fn = reng._resident_refill_runner(None, m, n_groups, keep_state,
                                      use_pallas)
    r_state, r_slot, r_acc, r_stats = fn(
        _jnp_packed(st), jnp.asarray(slot),
        jax.tree.map(jnp.asarray, acc),
        *(jnp.asarray(x)[None] for x in staged), jnp.asarray(n_staged),
        jnp.asarray(out_addr))

    t = torch.from_numpy
    p_state, p_slot, p_acc, p_stats = engine.retire_refill(
        convert.packed_to_torch(st, "cpu"), t(slot.copy()),
        convert.acc_to_torch(acc, "cpu"), *(t(x) for x in staged),
        t(n_staged), t(out_addr), n_groups, device="cpu")

    tp.assert_packed_equal(r_state, convert.packed_to_numpy(p_state),
                           "state")
    np.testing.assert_array_equal(p_slot.numpy(), np.asarray(r_slot))
    np.testing.assert_array_equal(p_stats.numpy(), np.asarray(r_stats)[0])
    got = convert.acc_to_numpy(p_acc)
    for f in reng.ResidentAcc._fields:
        a, b = getattr(r_acc, f), getattr(got, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(b, np.asarray(a), err_msg=f)
