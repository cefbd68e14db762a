"""GPModelling + sampler tests.

Covers the reference's gpmodelling_test.py (spread_walkers semantics) and
adds the likelihood/posterior coverage the reference lacks (SURVEY.md §4):
- the vectorized stretch-move sampler reproduces a known Gaussian target,
- the MAP fit recovers DRW parameters on simulated data,
- derive_posteriors produces finite, bounded samples whose
  max-loglikelihood beats the initial guess,
- generate_from_posteriors returns lightcurves with the right shapes and
  statistics.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mind_the_gaps_tpu import GappyLightcurve
from mind_the_gaps_tpu.gpmodelling import GPModelling
from mind_the_gaps_tpu.kernels import DampedRandomWalk, Lorentzian
from mind_the_gaps_tpu.sampler import integrated_autocorr_time, sample_ensemble


# ------------------------------------------------------------------ #
# sampler correctness on a known target
# ------------------------------------------------------------------ #
def test_stretch_move_gaussian_target():
    """The ensemble must sample a correlated 2-D Gaussian correctly."""
    cov = np.array([[2.0, 0.8], [0.8, 1.0]])
    icov = jnp.asarray(np.linalg.inv(cov))
    mu = jnp.asarray([1.0, -2.0])

    def logp(theta):  # (W, D) -> (W,)
        d = theta - mu
        return -0.5 * jnp.einsum("wi,ij,wj->w", d, icov, d)

    w = 64
    rng = np.random.default_rng(0)
    init = rng.normal(0, 0.1, (w, 2)) + np.array([1.0, -2.0])
    chain, lps, acc, _ = sample_ensemble(jax.random.key(1), logp, jnp.asarray(init), 4000)
    chain = np.asarray(chain[500:])  # burn-in
    flat = chain.reshape(-1, 2)
    assert 0.2 < float(acc) < 0.8
    np.testing.assert_allclose(flat.mean(axis=0), [1.0, -2.0], atol=0.05)
    np.testing.assert_allclose(np.cov(flat.T), cov, atol=0.15)


def test_autocorr_time_reasonable():
    """tau of an AR(1) chain should match the analytic value
    tau = (1+phi)/(1-phi)."""
    rng = np.random.default_rng(3)
    phi = 0.9
    n, w = 20000, 8
    x = np.zeros((n, w))
    eps = rng.normal(size=(n, w))
    for i in range(1, n):
        x[i] = phi * x[i - 1] + eps[i]
    tau = np.asarray(integrated_autocorr_time(jnp.asarray(x[..., None])))
    expected = (1 + phi) / (1 - phi)  # = 19
    np.testing.assert_allclose(tau[0], expected, rtol=0.25)


# ------------------------------------------------------------------ #
# spread_walkers (reference tests/gpmodelling_test.py)
# ------------------------------------------------------------------ #
def _make_model():
    lor_params = [10, 5, -5]
    drw_params = [5.0, 10.0]
    bounds_drw = [(4.0, 6.0), (8.0, 12.0)]
    bounds_lor = [(5, 15), (1, 6), (-7, -1)]
    kernel = DampedRandomWalk(*drw_params, bounds=bounds_drw) + Lorentzian(*lor_params, bounds=bounds_lor)
    lc = GappyLightcurve(np.arange(100.0), np.arange(100.0), np.arange(100.0))
    return GPModelling(lc, kernel), drw_params + lor_params, bounds_drw + bounds_lor


def test_parameters_within_bounds():
    gpmodel, parameters, bounds = _make_model()
    for percent, attempts in [(0.1, 100), (0.9, 2)]:
        samples = gpmodel.spread_walkers(100, parameters, bounds, percent=percent, max_attempts=attempts)
        for i, sample in enumerate(samples.T):
            assert np.all((bounds[i][0] <= sample) & (sample <= bounds[i][1]))


def test_infinite_bounds():
    gpmodel, parameters, _ = _make_model()
    bounds = [(None, None), (8.0, 12.0), (5, 15), (1, 6), (-7, -1)]
    samples = gpmodel.spread_walkers(100, parameters, bounds, percent=0.1, max_attempts=50)
    assert np.all(np.isfinite(samples[:, 0]))
    for bounds_i, sample in zip(bounds[1:], samples.T[1:]):
        assert np.all((bounds_i[0] <= sample) & (sample <= bounds_i[1]))


def test_zero_percent():
    gpmodel, parameters, bounds = _make_model()
    samples = gpmodel.spread_walkers(100, parameters, bounds, percent=0, max_attempts=50)
    np.testing.assert_array_equal(samples, np.array([parameters] * 100, dtype=float))


def test_max_attempts_clamping():
    gpmodel, parameters, _ = _make_model()
    bounds = [(p - 0.01, p + 0.01) for p in parameters]
    samples = gpmodel.spread_walkers(100, parameters, bounds, percent=0, max_attempts=50)
    for i, sample in enumerate(samples.T):
        assert np.all(sample == parameters[i])


# ------------------------------------------------------------------ #
# end-to-end inference on simulated DRW data
# ------------------------------------------------------------------ #
@pytest.fixture(scope="module")
def drw_lightcurve():
    """Simulate a DRW lightcurve directly from the exact GP (Cholesky of
    the dense covariance) so the ground truth is unambiguous."""
    rng = np.random.default_rng(7)
    n = 400
    t = np.cumsum(rng.uniform(2.0, 8.0, n))  # irregular, min gap 2
    true = DampedRandomWalk(log_S0=np.log(4.0), log_omega0=np.log(0.05))
    tau = np.abs(t[:, None] - t[None, :])
    K = np.array(true.covariance(tau))
    yerr = np.full(n, 0.3)
    K += np.diag(yerr**2)
    y = 10.0 + np.linalg.cholesky(K) @ rng.normal(size=n)
    return GappyLightcurve(t, y, yerr, exposures=1.0), (np.log(4.0), np.log(0.05))


def test_fit_recovers_drw(drw_lightcurve):
    lc, (ls0, lw0) = drw_lightcurve
    kernel = DampedRandomWalk(log_S0=0.0, log_omega0=-2.0, bounds=[(-5, 10), (-8, 2)])
    gp = GPModelling(lc, kernel)
    sol = gp.fit()
    assert sol.success
    # MAP within a reasonable neighborhood of the truth
    assert abs(sol.x[0] - ls0) < 1.0
    assert abs(sol.x[1] - lw0) < 1.0
    # and the likelihood at MAP beats the truth slightly (it's the MLE)
    ll_map = -gp._neg_log_like(sol.x)
    ll_true = -gp._neg_log_like([ls0, lw0])
    assert ll_map >= ll_true - 1e-6


def test_derive_posteriors_seeded_is_deterministic(drw_lightcurve):
    """A seeded run must reproduce exactly — including the walker-ball
    initialization, which the reference draws from the GLOBAL numpy RNG
    (gpmodelling.py:307; our spread_walkers gets a seed-derived
    Generator from derive_posteriors instead)."""
    lc, _ = drw_lightcurve
    kernel = DampedRandomWalk(log_S0=0.0, log_omega0=-2.0, bounds=[(-5, 10), (-8, 2)])
    chains = []
    for _ in range(2):
        np.random.seed()  # scramble the global RNG between runs
        gp = GPModelling(lc, kernel)
        gp.derive_posteriors(max_steps=200, convergence_steps=100, walkers=8, seed=13, fit=False)
        chains.append(np.asarray(gp.mcmc_samples))
    np.testing.assert_array_equal(chains[0], chains[1])


def test_derive_posteriors_multi_chain(drw_lightcurve):
    """chains=C runs C independent ensembles in one batch: pooled
    samples, sane posteriors, deterministic under a seed, and the
    chains stay statistically consistent with each other."""
    lc, (ls0, lw0) = drw_lightcurve
    # NOTE nonzero start: std = |theta|*percent, so a 0.0 parameter with
    # fit=False makes a zero-width walker ball the affine-invariant move
    # can never leave (emcee shares this degeneracy)
    kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-2.0, bounds=[(-5, 10), (-8, 2)])
    gp = GPModelling(lc, kernel)
    gp.derive_posteriors(max_steps=600, convergence_steps=200, walkers=8,
                         chains=4, seed=11, fit=False)
    samples = gp.mcmc_samples
    assert samples.shape[1] == 2 and len(samples) > 100
    assert np.all(np.isfinite(gp.loglikelihoods))
    assert abs(gp.median_parameters[0] - ls0) < 1.5
    assert abs(gp.median_parameters[1] - lw0) < 1.5
    # pooled walkers = chains * walkers
    assert gp.get_rstat(burnin=100).shape == (32, 2)

    # per-ensemble medians agree within a loose tolerance (independent
    # chains exploring the same posterior)
    chain = gp.sampler.get_chain(discard=200)  # (steps, 32, 2)
    per_chain_med = np.median(chain.reshape(chain.shape[0], 4, 8, 2), axis=(0, 2))
    assert np.all(np.ptp(per_chain_med, axis=0) < 2.0)

    gp2 = GPModelling(lc, kernel)
    gp2.derive_posteriors(max_steps=600, convergence_steps=200, walkers=8,
                          chains=4, seed=11, fit=False)
    np.testing.assert_array_equal(samples, gp2.mcmc_samples)

    with pytest.raises(ValueError, match="chains, walkers, ndim"):
        gp.derive_posteriors(initial_chain_params=np.zeros((8, 2)), chains=4)


def test_derive_posteriors_and_generate(drw_lightcurve):
    lc, (ls0, lw0) = drw_lightcurve
    kernel = DampedRandomWalk(log_S0=0.0, log_omega0=-2.0, bounds=[(-5, 10), (-8, 2)])
    gp = GPModelling(lc, kernel)
    gp.derive_posteriors(max_steps=1000, convergence_steps=250, walkers=16, seed=11)
    samples = gp.mcmc_samples
    assert samples.shape[1] == 2
    assert len(samples) > 50
    assert np.all(np.isfinite(gp.loglikelihoods))
    # posterior concentrates near truth
    med = gp.median_parameters
    assert abs(med[0] - ls0) < 1.0
    assert abs(med[1] - lw0) < 1.0
    assert gp.max_loglikelihood >= np.median(gp.loglikelihoods)
    # properties
    assert gp.k == 2
    assert len(gp.autocorr) >= 1
    assert gp.get_rstat(burnin=100).shape == (16, 2)

    # posterior-predictive generation (batched)
    lcs = gp.generate_from_posteriors(nsims=8, pdf="Gaussian", sigma_noise=0.3, extension_factor=2)
    assert len(lcs) == 8
    for sim in lcs:
        assert sim.n == lc.n
        assert np.all(np.isfinite(sim.y))
        assert np.all(sim.dy > 0)
    means = [sim.y.mean() for sim in lcs]
    np.testing.assert_allclose(np.mean(means), lc.y.mean(), rtol=0.25)


def test_standarized_residuals(drw_lightcurve):
    """Exact parity with the celerite predict-based formula
    (reference gpmodelling.py:353-370): res = (y - mu)/sqrt(var) with
    mu = m + K_s K^{-1} (y - m) and var = k(0) - K_s K^{-1} K_s diag."""
    lc, (ls0, lw0) = drw_lightcurve
    kernel = DampedRandomWalk(log_S0=ls0, log_omega0=lw0)
    gp = GPModelling(lc, kernel)
    res = gp.standarized_residuals()

    t, y, yerr = lc.times, lc.y, lc.dy
    tau = np.abs(t[:, None] - t[None, :])
    Ks = np.array(kernel.covariance(tau))
    K = Ks + np.diag((yerr + 1e-12) ** 2)
    m = lc.mean
    mu = m + Ks @ np.linalg.solve(K, y - m)
    var = float(kernel.variance()) - np.einsum("ij,jk,ik->i", Ks, np.linalg.inv(K), Ks)
    ref = (y - mu) / np.sqrt(var)
    np.testing.assert_allclose(res, ref, rtol=1e-6, atol=1e-9)


def test_mean_models_build():
    rng = np.random.default_rng(1)
    t = np.sort(rng.uniform(0, 100, 50))
    y = rng.normal(5, 1, 50)
    lc = GappyLightcurve(t, y, np.full(50, 0.2))
    kernel = DampedRandomWalk(0.0, -2.0, bounds=[(-5, 5), (-6, 1)])
    for mm, extra in [(None, 0), ("constant", 1), ("linear", 2), ("gaussian", 3)]:
        gp = GPModelling(lc, kernel, mean_model=mm)
        assert gp.k == 2 + extra
        assert np.isfinite(gp._log_probability(gp.initial_params)) or mm == "gaussian"
    with pytest.raises(ValueError):
        GPModelling(lc, kernel, mean_model="quadratic")


def test_predict_at_new_points(drw_lightcurve):
    """GPModelling.predict at arbitrary points: matches the dense GP
    formulas and interpolates sensibly."""
    lc, (ls0, lw0) = drw_lightcurve
    kernel = DampedRandomWalk(log_S0=ls0, log_omega0=lw0)
    gp = GPModelling(lc, kernel)

    t_pred = np.linspace(lc.times[10], lc.times[40], 37)
    mu, var = gp.predict(t_pred)
    assert mu.shape == (37,) and var.shape == (37,)
    assert np.all(var > 0)

    # dense ground truth
    tau_tt = np.abs(lc.times[:, None] - lc.times[None, :])
    K = np.array(kernel.covariance(tau_tt)) + np.diag((lc.dy + 1e-12) ** 2)
    tau_st = np.abs(t_pred[:, None] - lc.times[None, :])
    Ks = np.array(kernel.covariance(tau_st))
    m = lc.mean
    mu_ref = m + Ks @ np.linalg.solve(K, lc.y - m)
    var_ref = float(kernel.variance()) - np.einsum("ij,jk,ik->i", Ks, np.linalg.inv(K), Ks)
    np.testing.assert_allclose(mu, mu_ref, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(var, var_ref, rtol=1e-5, atol=1e-8)

    # default (training points) agrees with standarized_residuals pieces
    mu_train, var_train = gp.predict()
    assert mu_train.shape == (lc.n,)


# ------------------------------------------------------------------ #
# GPU-kernel fast sampler path: parity for every mean model
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("mean_model", [None, "constant", "linear", "gaussian"])
def test_fast_logprob_matches_batch(drw_lightcurve, mean_model, interpret_kernels):
    """The f32 kernel log-prob (interpret mode on CPU) must track the f64
    XLA batched log-prob for all mean models — the contract behind
    derive_posteriors' auto fast path on a GPU."""
    lc, (ls0, lw0) = drw_lightcurve
    kernel = DampedRandomWalk(log_S0=ls0, log_omega0=lw0, bounds=[(-5, 10), (-8, 2)])
    gp = GPModelling(lc, kernel, mean_model=mean_model)
    rng = np.random.default_rng(11)
    thetas = gp.initial_params[None, :] * (
        1.0 + 0.03 * rng.standard_normal((8, gp.k))
    )
    ref = np.asarray(gp._logprob_batch(jnp.asarray(thetas)))
    fast = np.asarray(gp._logprob_batch_fast(jnp.asarray(thetas)))
    finite = np.isfinite(ref)
    # f32 vs f64 over a 400-step recursion: sub-0.05 absolute agreement
    np.testing.assert_allclose(fast[finite], ref[finite], rtol=1e-4, atol=5e-2)
    assert np.array_equal(np.isfinite(fast), finite)


def test_derive_posteriors_fast_linear_mean(drw_lightcurve, interpret_kernels):
    """derive_posteriors(fast=True) runs end-to-end with a fitted mean."""
    lc, (ls0, lw0) = drw_lightcurve
    kernel = DampedRandomWalk(log_S0=ls0, log_omega0=lw0, bounds=[(-5, 10), (-8, 2)])
    gp = GPModelling(lc, kernel, mean_model="linear")
    gp.derive_posteriors(fit=False, converge=False, max_steps=30,
                         convergence_steps=30, walkers=8, seed=3, fast=True)
    assert np.all(np.isfinite(gp.loglikelihoods))
    assert gp.mcmc_samples.shape[1] == gp.k


def test_precompile_sampler_matches_runtime_program(drw_lightcurve, interpret_kernels):
    """precompile_sampler must compile the EXACT program derive_posteriors
    then dispatches (same signature incl. the fast path's f32 buffers) —
    a dtype/shape mismatch would silently compile a program the run never
    uses and pay the full segment compile again at runtime."""
    from concurrent.futures import ThreadPoolExecutor

    lc, (ls0, lw0) = drw_lightcurve
    for fast in (False, True):
        kernel = DampedRandomWalk(log_S0=ls0, log_omega0=lw0, bounds=[(-5, 10), (-8, 2)])
        gp = GPModelling(lc, kernel)
        with ThreadPoolExecutor(1) as pool:
            fut = gp.precompile_sampler(pool, max_steps=60, convergence_steps=30,
                                        walkers=8, fast=fast)
            fut.result()
        assert len(gp._segment_execs) == 1, "precompile produced no usable program"
        (sig,) = gp._segment_execs
        gp.derive_posteriors(fit=False, converge=False, max_steps=60,
                             convergence_steps=30, walkers=8, seed=5, fast=fast)
        assert list(gp._segment_execs) == [sig], (
            f"derive_posteriors(fast={fast}) compiled a second segment program: "
            f"{list(gp._segment_execs)}"
        )
        # the f64 recompute executable is memoized too (fast path only)
        if fast:
            assert list(gp._recompute_execs) == [4096]


def test_fit_device_matches_scipy(drw_lightcurve):
    """The on-device projected L-BFGS must land on the same MAP point as
    the host scipy L-BFGS-B (smooth interior optimum)."""
    lc, (ls0, lw0) = drw_lightcurve
    kernel = DampedRandomWalk(log_S0=0.0, log_omega0=-2.0, bounds=[(-5, 10), (-8, 2)])
    gp = GPModelling(lc, kernel)
    sol = gp.fit()
    params_dev, nll_dev = gp.fit_device()
    assert np.isfinite(nll_dev)
    # same optimum at the likelihood level (parameter-space may be flat)
    assert abs(nll_dev - sol.fun) < 1e-3, (nll_dev, sol.fun)
    np.testing.assert_allclose(params_dev, sol.x, rtol=0.05, atol=0.05)


def test_chainresult_autocorr_tol_honored():
    """get_autocorr_time(tol>0) raises when the chain is shorter than
    tol autocorrelation times (emcee semantics; tol=0 never raises)."""
    import pytest as _pytest

    from mind_the_gaps_tpu.gpmodelling import ChainResult

    rng = np.random.default_rng(0)
    chain = rng.normal(size=(60, 8, 2))  # white noise: tau ~ 1
    cr = ChainResult(chain, rng.normal(size=(60, 8)))
    tau = cr.get_autocorr_time()  # tol=0: fine on a short chain
    assert tau.shape == (2,)
    with _pytest.raises(RuntimeError, match="autocorrelation time"):
        cr.get_autocorr_time(tol=1000)


def test_chainresult_autocorr_raises_emcee_compatible_error():
    """The tol>0 failure is an emcee-compatible AutocorrError carrying
    the tau estimate on .tau (reference surfaces emcee.autocorr.
    AutocorrError via get_autocorr_time, gpmodelling.py:256)."""
    import pytest as _pytest

    from mind_the_gaps_tpu import AutocorrError as exported
    from mind_the_gaps_tpu.gpmodelling import AutocorrError, ChainResult

    assert exported is AutocorrError
    rng = np.random.default_rng(1)
    cr = ChainResult(rng.normal(size=(60, 8, 2)), rng.normal(size=(60, 8)))
    with _pytest.raises(AutocorrError) as ei:
        cr.get_autocorr_time(tol=1000)
    assert np.asarray(ei.value.tau).shape == (2,)
    try:  # when emcee is present, user `except emcee...AutocorrError` works
        from emcee.autocorr import AutocorrError as EmceeErr
    except Exception:
        pass
    else:
        assert issubclass(AutocorrError, EmceeErr)


def test_masked_autocorr_matches_host_estimator():
    """The device-side masked tau (fixed-size buffer, n_valid prefix)
    must match the host estimator on the same prefix — it drives the
    derive_posteriors convergence policy."""
    import jax.numpy as jnp

    from mind_the_gaps_tpu.sampler.autocorr import (
        integrated_autocorr_time_masked,
        integrated_autocorr_time_np,
    )

    rng = np.random.default_rng(3)
    # AR(1) chains with different correlation per parameter
    n, w, d = 700, 10, 3
    x = np.zeros((n, w, d))
    for j, a in enumerate([0.2, 0.7, 0.9]):
        e = rng.normal(size=(n, w))
        for i in range(1, n):
            x[i, :, j] = a * x[i - 1, :, j] + e[i]
    for n_valid in (256, 500, 700):
        buf = np.zeros((n, w, d))
        buf[:n_valid] = x[:n_valid]
        ref = integrated_autocorr_time_np(x[:n_valid])
        got = np.asarray(
            integrated_autocorr_time_masked(jnp.asarray(buf), jnp.asarray(n_valid, dtype=jnp.int32))
        )
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-6)


def test_masked_autocorr_dead_walker():
    """A constant (stuck) walker must not poison tau with NaN in either
    estimator tier."""
    import jax.numpy as jnp

    from mind_the_gaps_tpu.sampler.autocorr import (
        integrated_autocorr_time_masked,
        integrated_autocorr_time_np,
    )

    rng = np.random.default_rng(5)
    x = rng.normal(size=(200, 6, 2))
    x[:, 2, :] = 1.234  # stuck walker
    ref = integrated_autocorr_time_np(x[:150])
    buf = np.zeros_like(x)
    buf[:150] = x[:150]
    got = np.asarray(
        integrated_autocorr_time_masked(jnp.asarray(buf), jnp.asarray(150, dtype=jnp.int32))
    )
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, rtol=2e-4)
