"""The port's threefry2x32 (`repro_torch/prng.py`) against `jax.random`.

Keys, `fold_in` and float32/float64 uniforms must equal JAX's bit for
bit. The key depends on JAX's x64 flag (an int32 seed without it, an
int64 seed with it), so float32 draws are compared with x64 off and
float64 draws under `jax.enable_x64(True)`, as the reference's sweeps
run them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import prng

SEEDS = (0, 3, 7, 2 ** 32 + 5)
N_CELLS = 4096


def _key_words(key) -> tuple:
    return tuple(int(v) for v in np.asarray(jax.random.key_data(key)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
def test_keys_fold_in_and_uniforms_equal_jax(seed, x64):
    jdt, tdt = (jnp.float64, torch.float64) if x64 else \
        (jnp.float32, torch.float32)
    it = np.int64 if x64 else np.int32
    with jax.enable_x64(x64):
        key = jax.random.PRNGKey(seed)
        assert _key_words(key) == prng.prng_key(seed, x64)
        cells = jnp.arange(N_CELLS, dtype=jnp.int32)
        ck = np.asarray(jax.vmap(lambda i: jax.random.fold_in(key, i))(
            cells)).astype(np.int64)
        w0, w1 = prng.fold_in(prng.prng_key(seed, x64),
                              torch.arange(N_CELLS, dtype=torch.int32))
        np.testing.assert_array_equal(ck[:, 0], w0.numpy())
        np.testing.assert_array_equal(ck[:, 1], w1.numpy())
        for draws in (1, 7, 64):
            want = np.asarray(jax.vmap(
                lambda k: jax.random.uniform(k, (draws, 2), jdt))(
                    jnp.asarray(ck.astype(np.uint32))))
            got = prng.uniform((w0, w1), 2 * draws, tdt).reshape(
                N_CELLS, draws, 2).numpy()
            np.testing.assert_array_equal(want.view(it), got.view(it),
                                          err_msg=f"draws {draws}")
            assert (got >= 0).all() and (got < 1).all()


def test_prng_key_follows_the_seed_width():
    """Without x64 the seed is an int32 (wrapped); with it, an int64
    split into two words."""
    assert prng.prng_key(2 ** 32 + 5, x64=False) == (0, 5)
    assert prng.prng_key(2 ** 32 + 5, x64=True) == (1, 5)
    assert prng.prng_key(-1, x64=False) == (0, 0xFFFFFFFF)
    with jax.enable_x64(False):
        assert _key_words(jax.random.PRNGKey(-1)) == (0, 0xFFFFFFFF)
    with jax.enable_x64(True):
        assert _key_words(jax.random.PRNGKey(-1)) == \
            prng.prng_key(-1, x64=True)


def test_threefry_known_answer():
    """The Threefry-2x32 (20 rounds) test vector of the Random123
    library, which JAX's own tests use."""
    x0, x1 = prng.threefry2x32(0x13198A2E, 0x03707344, 0x243F6A88,
                               0x85A308D3)
    assert (int(x0), int(x1)) == (0xC4923A9C, 0x483DF7A0)


def test_uniform_rejects_other_dtypes():
    key = prng.fold_in((0, 1), torch.arange(3))
    with pytest.raises(ValueError, match="float32 or float64"):
        prng.uniform(key, 4, torch.float16)
