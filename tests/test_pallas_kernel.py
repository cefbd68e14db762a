"""Pallas-Triton celerite kernel (interpret mode on CPU) against the
XLA batched scan: f64 to 1e-12 relative, f32 within the mixed-precision
bound."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mind_the_gaps_tpu.kernels import DampedRandomWalk, Lorentzian, RealTerm, SHOTerm
from mind_the_gaps_tpu.ops.pallas_celerite import launch_config, pallas_log_likelihood
from mind_the_gaps_tpu.solver.batched import batched_log_likelihood


def _data(n=300, seed=0):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(2.0, 8.0, n))
    y = rng.normal(0.0, 2.0, n)
    diag = np.full(n, 0.09)
    return t, y, diag


def _thetas(kernel, batch, seed, dtype=None):
    theta0 = kernel.get_parameter_vector()
    th = theta0 + 0.05 * np.asarray(jax.random.normal(jax.random.key(seed), (batch, len(theta0))))
    return jnp.asarray(th, dtype=dtype)


def _check(kernel, with_mean=False, batch=48):
    t, y, diag = _data()
    co = jax.vmap(kernel.coefficients)(_thetas(kernel, batch, 1))
    mean = jnp.full((batch,), float(np.mean(y))) if with_mean else None
    ref = np.asarray(batched_log_likelihood(co, t, y, diag, mean=mean))
    pal = np.asarray(pallas_log_likelihood(co, t, y, diag, mean=mean, interpret=True))
    np.testing.assert_allclose(pal, ref, rtol=1e-12)


def test_pallas_drw_lorentzian():
    _check(DampedRandomWalk(1.0, -3.0) + Lorentzian(-1.0, 2.0, -2.0))


def test_pallas_real_only():
    _check(DampedRandomWalk(1.0, -3.0) + RealTerm(0.0, -1.0))


def test_pallas_complex_only():
    _check(SHOTerm(0.5, 1.0, -2.5) + Lorentzian(-1.0, 2.0, -2.0))


def test_pallas_with_mean():
    _check(DampedRandomWalk(1.0, -3.0), with_mean=True)


def test_pallas_f32():
    t, y, diag = _data()
    kernel = DampedRandomWalk(1.0, -3.0) + Lorentzian(-1.0, 2.0, -2.0)
    co = jax.vmap(kernel.coefficients)(_thetas(kernel, 64, 2, jnp.float32))
    ref = np.asarray(batched_log_likelihood(co, t, y.astype(np.float32), diag.astype(np.float32)))
    pal = np.asarray(
        pallas_log_likelihood(co, t, y.astype(np.float32), diag.astype(np.float32), interpret=True)
    )
    np.testing.assert_allclose(pal, ref, rtol=1e-5, atol=1e-3)


_MULTI_TERM = {
    "R5_two_complex_pairs": DampedRandomWalk(log_S0=1.0, log_omega0=-3.0)
    + Lorentzian(log_S0=-1.0, log_Q=2.0, log_omega0=-2.0)
    + Lorentzian(log_S0=-0.5, log_Q=1.0, log_omega0=-1.0),
    "R6_two_real_two_complex": RealTerm(0.5, -1.0) + RealTerm(-0.5, -2.0)
    + Lorentzian(-1.0, 2.0, -2.0) + Lorentzian(-0.5, 1.0, -1.0),
}


@pytest.mark.parametrize("name", sorted(_MULTI_TERM))
def test_pallas_multi_term_structures(name):
    """Off-diagonal complex-complex and real-complex blocks of the packed
    S update (R=5 and R=6) match the scan in f64."""
    _check(_MULTI_TERM[name], batch=16)


def test_pallas_not_positive_definite_is_minus_inf():
    """A negative-amplitude term makes K indefinite: -inf like the scan."""
    t, y, diag = _data(n=64)
    kernel = DampedRandomWalk(1.0, -3.0)
    co = jax.vmap(kernel.coefficients)(_thetas(kernel, 4, 3))
    ar = co[0].at[1].set(-50.0)
    co = (ar,) + tuple(co[1:])
    ref = np.asarray(batched_log_likelihood(co, t, y, diag))
    pal = np.asarray(pallas_log_likelihood(co, t, y, diag, interpret=True))
    assert np.isneginf(ref[1]) and np.isneginf(pal[1])
    np.testing.assert_allclose(pal[[0, 2, 3]], ref[[0, 2, 3]], rtol=1e-12)


@pytest.mark.parametrize("batch,expect", [(1, 1), (3, 4), (16, 16), (17, 32), (3072, 32)])
def test_launch_config_powers_of_two(batch, expect):
    """Triton needs power-of-two blocks: small batches take one block of
    the next power of two, large ones 32-lane single-warp blocks."""
    block, warps = launch_config(batch)
    assert block == expect and warps == 1
    assert block & (block - 1) == 0
