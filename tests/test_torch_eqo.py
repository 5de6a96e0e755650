"""The port's threefry (``repro_torch.core.prng``) and queue-occupancy
estimator (``repro_torch.core.eqo``) on the CPU, held against ``jax.random``
and ``repro.core.simulate_eqo``.

* the random bits, uniforms and Bernoulli draws equal JAX's bit for bit
  (32-bit mode, ``jax_threefry_partitionable`` on, as this JAX runs), for
  seeds that need the key's modulo (2**31 + 5, -1) and for odd lengths;
* ``simulate_eqo`` gives the reference's ``err_max_bytes`` exactly and its
  ``err_mean_bytes`` within 2e-3 relative: the port sums the error exactly
  (float64, every term a multiple of 1/8 byte) where the reference
  accumulates it in float32 over up to 10**5 ticks, which drifts by 1e-5 to
  1.3e-3 relative;
* Fig. 12's two properties, as ``tests/test_system.py`` checks them on the
  reference.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import simulate_eqo as R_eqo  # noqa: E402
from repro_torch.core import prng, simulate_eqo  # noqa: E402
from torch_parity import release_compiled_programs  # noqa: E402, F401

SEEDS = [0, 1, 3, 2 ** 31 + 5]
SHAPES = [(1,), (7,), (782,), (1025,)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"n{s[0]}")
@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_bits_uniform_bernoulli_equal_jax(seed, shape):
    key = jax.random.PRNGKey(seed)
    qkey = prng.prng_key(seed)
    assert qkey == tuple(int(k) for k in np.asarray(key))
    bits = prng.random_bits(qkey, shape)
    assert bits.dtype == torch.int64 and tuple(bits.shape) == shape
    np.testing.assert_array_equal(
        bits.numpy(), np.asarray(jax.random.bits(key, shape)).astype(np.int64))
    u = prng.uniform(qkey, shape)
    assert u.dtype == torch.float32
    np.testing.assert_array_equal(
        u.numpy().view(np.int32),
        np.asarray(jax.random.uniform(key, shape)).view(np.int32))
    np.testing.assert_array_equal(
        prng.bernoulli(qkey, 0.5, shape).numpy(),
        np.asarray(jax.random.bernoulli(key, 0.5, shape)))


def test_threefry_keys_and_shapes_of_any_rank():
    """A negative seed wraps as JAX's does in 32-bit mode, and a 2-d shape
    takes its bits in row-major order of the flat counter."""
    for seed in (-1, 2 ** 32 + 7):
        assert prng.prng_key(seed) == tuple(
            int(k) for k in np.asarray(jax.random.PRNGKey(seed)))
    key = jax.random.PRNGKey(5)
    np.testing.assert_array_equal(
        prng.random_bits(prng.prng_key(5), (3, 5)).numpy(),
        np.asarray(jax.random.bits(key, (3, 5))).astype(np.int64))
    np.testing.assert_array_equal(
        prng.bernoulli(prng.prng_key(5), 0.3, (4, 9)).numpy(),
        np.asarray(jax.random.bernoulli(key, 0.3, (4, 9))))


@pytest.mark.parametrize("interval", [25, 50, 800])
def test_simulate_eqo_matches_reference(interval):
    """``err_max_bytes`` equal; ``err_mean_bytes`` within 2e-3 relative,
    the reference's float32 accumulation of the error's sum."""
    want = R_eqo(interval, total_ns=100_000)
    got = simulate_eqo(interval, total_ns=100_000, device="cpu")
    assert got.keys() == want.keys()
    assert got["update_interval_ns"] == interval
    assert got["err_max_bytes"] == want["err_max_bytes"]
    assert got["err_mean_bytes"] == pytest.approx(want["err_mean_bytes"],
                                                  rel=2e-3)


def test_simulate_eqo_other_seed_and_rate_match_reference():
    want = R_eqo(400, total_ns=30_000, link_gbps=40, seed=3)
    got = simulate_eqo(400, total_ns=30_000, link_gbps=40, seed=3,
                       device="cpu")
    assert got["err_max_bytes"] == want["err_max_bytes"]
    assert got["err_mean_bytes"] == pytest.approx(want["err_mean_bytes"],
                                                  rel=2e-3)


def test_eqo_error_under_half_mtu_at_50ns():
    """Fig. 12: a 50 ns update interval keeps the estimation error sub-MTU
    and the error grows with the update interval."""
    r50 = simulate_eqo(50, total_ns=100_000, device="cpu")
    r800 = simulate_eqo(800, total_ns=100_000, device="cpu")
    assert r50["err_max_bytes"] <= 750
    assert r50["err_max_bytes"] < r800["err_max_bytes"]
