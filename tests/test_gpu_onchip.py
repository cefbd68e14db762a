"""On-card parity gate for the compiled Pallas-Triton kernel.

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu_onchip.py

The CPU suite runs the kernel through the Pallas interpreter and
cross-lowers it for CUDA; only a card runs what Triton and ptxas make of
it.  These tests compare the compiled kernel with the f64 XLA scan (the
dense-Cholesky-validated tier).  chip_smoke.py runs them; elsewhere they
skip (tests/conftest.py, ``_gpu_only``).
"""
from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.gpu


def _problem(n_points, seed=0):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(2.0, 8.0, n_points))
    y = rng.normal(0.0, 2.0, n_points)
    diag = np.full(n_points, 0.09)
    return t, y, diag


def _thetas(kernel, batch, seed):
    theta0 = kernel.get_parameter_vector()
    return jnp.asarray(
        theta0 + 0.05 * np.asarray(jax.random.normal(jax.random.key(seed), (batch, len(theta0))))
    )


@pytest.mark.parametrize("batch", [16, 3072])
def test_shared_kernel_matches_f64_scan_onchip(batch):
    """Shared data, the observed fit's 16 lanes and a bootstrap-sized
    batch: f32 within 0.5 of the f64 scan, f64 to 1e-8 relative."""
    from mind_the_gaps_tpu.kernels import DampedRandomWalk, Lorentzian
    from mind_the_gaps_tpu.ops import pallas_log_likelihood
    from mind_the_gaps_tpu.solver.batched import batched_log_likelihood

    kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0) + Lorentzian(
        log_S0=-1.0, log_Q=2.0, log_omega0=-2.0
    )
    t, y, diag = _problem(2048)
    c64 = jax.vmap(kernel.coefficients)(_thetas(kernel, batch, 7))
    ll_ref = np.asarray(batched_log_likelihood(c64, t, y, diag))
    ll64 = np.asarray(jax.jit(lambda c: pallas_log_likelihood(c, t, y, diag))(c64))
    c32 = jax.tree.map(lambda x: x.astype(jnp.float32), c64)
    ll32 = np.asarray(
        jax.jit(lambda c: pallas_log_likelihood(c, t, y.astype(np.float32), diag.astype(np.float32)))(c32)
    )
    assert np.all(np.isfinite(ll_ref))
    assert np.max(np.abs(ll32 - ll_ref)) < 0.5
    np.testing.assert_allclose(ll64, ll_ref, rtol=1e-8)


def test_real_only_kernel_onchip():
    """A real-terms-only structure (Jc=0) compiles and computes."""
    from mind_the_gaps_tpu.kernels import DampedRandomWalk
    from mind_the_gaps_tpu.ops import pallas_log_likelihood
    from mind_the_gaps_tpu.solver.batched import batched_log_likelihood

    kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0)
    t, y, diag = _problem(1024)
    c64 = jax.vmap(kernel.coefficients)(_thetas(kernel, 128, 8))
    ll_ref = np.asarray(batched_log_likelihood(c64, t, y, diag))
    ll64 = np.asarray(jax.jit(lambda c: pallas_log_likelihood(c, t, y, diag))(c64))
    np.testing.assert_allclose(ll64, ll_ref, rtol=1e-8)


def test_grouped_mode_matches_f64_scan_onchip():
    """Grouped (per-sim data) mode: B = G*repeats lanes, lane b solves
    against series b // repeats — the bootstrap-refit layout."""
    from mind_the_gaps_tpu.kernels import DampedRandomWalk, Lorentzian
    from mind_the_gaps_tpu.ops import pallas_log_likelihood
    from mind_the_gaps_tpu.solver.batched import batched_log_likelihood

    kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0) + Lorentzian(
        log_S0=-1.0, log_Q=2.0, log_omega0=-2.0
    )
    n_points, groups, repeats = 1024, 16, 6
    t, _, diag = _problem(n_points)
    ys = np.random.default_rng(3).normal(0.0, 2.0, (groups, n_points))
    c64 = jax.vmap(kernel.coefficients)(_thetas(kernel, groups * repeats, 9))
    ys_rep = np.repeat(ys, repeats, axis=0)
    ll_ref = np.asarray(batched_log_likelihood(c64, t, ys_rep, np.broadcast_to(diag, ys_rep.shape)))
    c32 = jax.tree.map(lambda x: x.astype(jnp.float32), c64)
    ll32 = np.asarray(
        jax.jit(lambda c, ysg: pallas_log_likelihood(c, t, ysg, jnp.asarray(diag, jnp.float32), repeats=repeats))(
            c32, jnp.asarray(ys, jnp.float32)
        )
    )
    assert np.max(np.abs(ll32 - ll_ref)) < 0.5


def test_sampler_segment_onchip():
    """One sampler run through the f32 kernel segment program
    (derive_posteriors fast path): finite chains, and the reported
    maximum is the f64 recompute at the maximizing parameters."""
    import warnings

    from mind_the_gaps_tpu import GappyLightcurve
    from mind_the_gaps_tpu.gpmodelling import GPModelling
    from mind_the_gaps_tpu.kernels import DampedRandomWalk
    from mind_the_gaps_tpu.solver import log_likelihood

    t, y, diag = _problem(512, seed=5)
    lc = GappyLightcurve(t, y + 10.0, np.sqrt(diag))
    kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)])
    gp = GPModelling(lc, kernel)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gp.derive_posteriors(
            fit=False, converge=False, max_steps=100, convergence_steps=50,
            walkers=8, seed=4, fast=True,
        )
    assert np.all(np.isfinite(np.asarray(gp.loglikelihoods)))
    theta_best = jnp.asarray(np.asarray(gp.max_parameters), dtype=jnp.float64)
    ll_ref = float(
        log_likelihood(
            kernel.coefficients(theta_best),
            jnp.asarray(t), jnp.asarray(y + 10.0 - np.mean(y + 10.0)),
            jnp.asarray((np.sqrt(diag) + 1e-12) ** 2),
        )
    )
    assert abs(float(gp.max_loglikelihood) - ll_ref) < 1e-5


def test_rank_permutation_keysort_exact_onchip():
    """`_apply_rank_permutation` (the i32-keyed sort_key_val that
    replaces the E13 loop's final f64 scatter) stays BIT-identical to
    the scatter on the card."""
    from mind_the_gaps_tpu.simulator.core import _apply_rank_permutation

    kk = jax.random.key(13)
    order = jax.vmap(lambda k1: jax.random.permutation(k1, 8192))(
        jax.random.split(kk, 8)
    ).astype(jnp.int32)
    draws = jnp.exp(2.0 + 0.7 * jax.random.normal(kk, (8, 8192), dtype=jnp.float64))
    ref = np.asarray(
        jax.jit(jax.vmap(lambda o, sd: jnp.zeros_like(sd).at[o].set(sd)))(order, draws)
    )
    out = np.asarray(jax.jit(_apply_rank_permutation)(order, draws))
    np.testing.assert_array_equal(out, ref)
