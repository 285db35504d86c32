"""The port's plain lane stepper (`repro_torch.flexibits.iss`) against the
reference's: its XLA stepper `iss.run_segment_lanes_banked` and its
Pallas kernel `iss_stepper.iss_segment_banked` (interpret mode), over the
full lane state (regs, pc, mem, halted, n_instr, n_two_stage, mix,
n_cycles), bit for bit."""
import numpy as np
import pytest
import torch

import _torch_parity as tp
from _torch_parity import one_torch_thread  # noqa: F401
from repro.flexibench.base import all_workloads as ref_workloads
from repro.flexibits import iss as riss
from repro_torch import _u32, convert
from repro_torch.flexibits import iss

U = np.uint32


def _plain_segment(bank, clen, state, seg_steps, mem_len, cost,
                   subset=None):
    t = torch.from_numpy
    out = iss.run_segment_lanes_banked(
        t(bank), t(clen), convert.packed_to_torch(state, "cpu"), seg_steps,
        subset, t(mem_len), None if cost is None else t(cost))
    return convert.packed_to_numpy(out)


def test_u32_helpers_match_uint32_arithmetic():
    rng = np.random.default_rng(0)
    a = rng.integers(-2**31, 2**31, 4096).astype(np.int32)
    b = rng.integers(-2**31, 2**31, 4096).astype(np.int32)
    sh = rng.integers(0, 32, 4096).astype(np.int32)
    ta, tb, ts = torch.from_numpy(a), torch.from_numpy(b), \
        torch.from_numpy(sh)
    au, bu = a.view(U), b.view(U)
    with np.errstate(over="ignore"):
        cases = {
            "wadd": (_u32.wadd(ta, tb), (au + bu).view(np.int32)),
            "wsub": (_u32.wsub(ta, tb), (au - bu).view(np.int32)),
            "wmul": (_u32.wmul(ta, tb), (au * bu).view(np.int32)),
            "srl": (_u32.srl(ta, ts), (au >> sh.view(U)).view(np.int32)),
            "sll": (_u32.sll(ta, ts), (au << sh.view(U)).view(np.int32)),
            "ult": (_u32.ult(ta, tb), au < bu),
            "uge": (_u32.uge(ta, tb), au >= bu),
            "sx12": (_u32.sx(ta & 0xFFF, 12),
                     ((a & 0xFFF) << 20) >> 20),
        }
    for name, (got, want) in cases.items():
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    # torch's >> on int32 is arithmetic: exactly why srl exists
    assert int(torch.tensor([-1], dtype=torch.int32)[0] >> 1) == -1


def test_pack_fetch_and_subset_match_reference():
    ws = ref_workloads()
    codes = [w.program.code for w in ws]
    bank, clen = iss.pack_programs(codes)
    rbank, rclen = riss.pack_programs(codes)
    np.testing.assert_array_equal(bank, rbank)
    np.testing.assert_array_equal(clen, rclen)
    for c in codes:
        assert iss.opcode_subset(c) == riss.opcode_subset(c)
    # per-program pc clamp, including a negative pc (a huge address)
    rng = np.random.default_rng(1)
    pid = rng.integers(0, len(ws), 512).astype(np.int32)
    pc = rng.integers(-2**31, 2**31, 512).astype(np.int32)
    pc[:256] = rng.integers(0, 2200 * 4, 256)
    import jax.numpy as jnp
    want = np.asarray(riss.fetch_banked(jnp.asarray(bank), jnp.asarray(clen),
                                        jnp.asarray(pid), jnp.asarray(pc)))
    got = iss.fetch_banked(torch.from_numpy(bank), torch.from_numpy(clen),
                           torch.from_numpy(pid), torch.from_numpy(pc))
    np.testing.assert_array_equal(got.numpy(), want.view(np.int32))


def test_plain_step_matches_reference_on_one_step_soups():
    """One step of random RV32E words on random lanes whose registers
    point at memory in and past range (the stepper soup idiom), with the
    pool width as every lane's bound: both reference steppers agree with
    each other here, and the port with both."""
    rng = np.random.default_rng(5)
    bank, clen = tp.soup_bank(rng, 16, 8, 32)
    st = tp.soup_state(rng, 64, 32, 16)
    regs = np.abs(st.lanes.regs.astype(np.int64)) % (32 * 8)
    regs[:, 0] = 0
    st = st._replace(lanes=st.lanes._replace(regs=regs.astype(np.int32)))
    mlen = np.full(16, 32, np.int32)
    for timing in (False, True):
        cost = tp.soup_cost(rng, 16) if timing else None
        got = _plain_segment(bank, clen, st, 1, mlen, cost)
        for kind in ("xla", "pallas"):
            ref = tp.ref_segment(kind, bank, clen, st, 1, mlen, cost)
            tp.assert_packed_equal(ref, got, f"{kind} timing={timing}")


@pytest.mark.parametrize("timing", [False, True])
def test_plain_segment_matches_reference_kernel_on_soups(timing):
    """Random programs (odd f3/f7 fields and some opcodes outside RV32E
    included) on random lanes with mixed per-program memory bounds,
    three segments of 64 steps, against the Pallas kernel the CUDA
    kernel replaces. (The reference's XLA stepper differs from its own
    kernel at two memory edges that random code reaches: a store to a
    negative word index wraps to the end of the row, and a load past
    the lane's bound writes the clamped word into the pad; the kernel,
    and the port, do neither.)"""
    rng = np.random.default_rng(11 + timing)
    bank, clen = tp.soup_bank(rng, 6, 24, 48)
    mlen = rng.integers(8, 49, 6).astype(np.int32)
    cost = tp.soup_cost(rng, 6) if timing else None
    st = ref = tp.soup_state(rng, 48, 48, 6)
    for k in range(3):
        ref = tp.ref_segment("pallas", bank, clen, ref, 64, mlen, cost)
        st = _plain_segment(bank, clen, st, 64, mlen, cost)
        tp.assert_packed_equal(ref, st, f"segment {k}")
    assert st.lanes.n_instr.sum() > 48 * 20     # the soups really ran


@pytest.mark.parametrize("timing", [False, True])
def test_plain_segment_matches_reference_on_workloads(timing):
    """All 11 FlexiBench workloads in one pool (mixed memory bounds,
    dynamic cost rows of SERV/QERV/HERV), three segments of 128 steps,
    against both reference steppers, with the bank's union text subset
    as the reference engine uses it."""
    bank, clen, mlen, cost, st = tp.workload_pool(22, seed=3)
    cost = cost if timing else None
    sub = frozenset().union(*(iss.opcode_subset(r[:n])
                              for r, n in zip(bank, clen)))
    x = p = st
    for k in range(3):
        x = tp.ref_segment("xla", bank, clen, x, 128, mlen, cost, sub)
        p = tp.ref_segment("pallas", bank, clen, p, 128, mlen, cost, sub)
        st = _plain_segment(bank, clen, st, 128, mlen, cost, sub)
        tp.assert_packed_equal(x, st, f"xla segment {k}")
        tp.assert_packed_equal(p, st, f"pallas segment {k}")
