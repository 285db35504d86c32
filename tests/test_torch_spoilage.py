"""The port's Fig. 6 spoilage variants (`flexibench/spoilage_algos.py`)
against the reference's: every variant's program, memory layout, step
budget, reference function and data set equal, and the short variants
(LR, DT-Small, DT-Large) run through the port's `iss_segment` on the CPU
(the kernel's plain version) with the reference function's outputs and
the reference PyISS's retirement counts. KNN and MLP retire 17k-1.9M
instructions an input, too long for the plain stepper here: chip_smoke.py
phase 19(a) runs all six through the kernel on the card."""
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread, spoilage_memory  # noqa: F401
from repro.flexibench import spoilage_algos as rsa
from repro.flexibits.pyiss import PyISS
from repro_torch.flexibench import spoilage_algos as psa
from repro_torch.flexibits import iss
from repro_torch.kernels import iss_stepper

NAMES = ("LR", "DT-Small", "DT-Large", "KNN-Small", "KNN-Large", "MLP")


def _by_name(mod):
    return {a.name: a for a in mod.all_algos()}


_REF, _PORT = _by_name(rsa), _by_name(psa)


def test_dataset_equals_reference():
    for seed, n in ((3, 1), (99, 4000), (5, 2000)):
        a = rsa.gen_dataset(np.random.default_rng(seed), n)
        b = psa.gen_dataset(np.random.default_rng(seed), n)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(rsa.MEANS, psa.MEANS)
    np.testing.assert_array_equal(rsa.CLASS_SIGMA, psa.CLASS_SIGMA)


@pytest.mark.parametrize("name", NAMES)
def test_variant_equals_reference(name):
    r, p = _REF[name], _PORT[name]
    np.testing.assert_array_equal(np.asarray(r.program.code),
                                  np.asarray(p.program.code))
    np.testing.assert_array_equal(np.asarray(r.program.ro_words),
                                  np.asarray(p.program.ro_words))
    for f in ("out_addr", "mem_words", "max_steps", "vm_reserved_bytes"):
        assert getattr(r, f) == getattr(p, f), f
    assert r.program.ro_base == p.program.ro_base
    x, _ = rsa.gen_dataset(np.random.default_rng(17), 200)
    want = r.ref(x)
    got = p.ref(x)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,n,seg_steps", [("LR", 6, 2048),
                                              ("DT-Small", 64, 128),
                                              ("DT-Large", 64, 256)])
def test_variant_runs_through_the_segment_plain_version(name, n, seg_steps):
    algo = _PORT[name]
    x, y = psa.gen_dataset(np.random.default_rng(23), n)
    mems = spoilage_memory(algo, x)
    sims = [PyISS(_REF[name].program.code, mems.shape[1], m.copy())
            .run(algo.max_steps) for m in mems]
    code = torch.as_tensor(np.asarray(algo.program.code).view(np.int32))
    state = iss.fresh_lanes(torch.as_tensor(mems))
    iss_stepper.reset_counts()
    segs = 0
    while not bool(state.halted.all()):
        state = iss_stepper.iss_segment(code, state, seg_steps=seg_steps,
                                        max_steps=algo.max_steps,
                                        device="cpu")
        segs += 1
        assert segs < 16, f"{name} did not halt"
    assert iss_stepper.iss_segment_banked.plain_calls == segs
    assert iss_stepper.iss_segment_banked.launches == 0
    out = state.mem[:, algo.out_addr].numpy()
    np.testing.assert_array_equal(out, algo.ref(x))
    np.testing.assert_array_equal(state.n_instr.numpy(),
                                  [s.n_instr for s in sims])
    np.testing.assert_array_equal(state.n_two_stage.numpy(),
                                  [s.n_two_stage for s in sims])
    assert all(s.halted for s in sims)
    assert (out == y).mean() > 0.5
