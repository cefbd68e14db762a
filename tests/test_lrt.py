"""End-to-end Protassov LRT pipeline tests (tiny sizes).

The statistical contract: under the null (data generated by the null
model), the observed T statistic should be unexceptional within the
simulated T distribution (p-value not extreme), and the batched refits
must produce finite max-loglikelihoods that beat the initial guess."""
import numpy as np
import pytest

import jax

from mind_the_gaps_tpu import GappyLightcurve
from mind_the_gaps_tpu.kernels import DampedRandomWalk, Lorentzian
from mind_the_gaps_tpu.lrt import (
    fit_lightcurves_batch,
    percentile_of_score,
    protassov_lrt,
)


def _drw_lc(seed=7, n=200):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(2.0, 8.0, n))
    true = DampedRandomWalk(log_S0=np.log(4.0), log_omega0=np.log(0.05))
    tau = np.abs(t[:, None] - t[None, :])
    K = np.array(true.covariance(tau)) + np.diag(np.full(n, 0.09))
    y = 10.0 + np.linalg.cholesky(K) @ rng.normal(size=n)
    return GappyLightcurve(t, y, np.full(n, 0.3), exposures=1.0)


def test_protassov_lrt_seeded_is_deterministic():
    """Two seeded runs must agree exactly — observed fits (seeded
    walker balls), generation, bootstrap refits and T statistics."""
    lc = _drw_lc(seed=9, n=96)
    null_kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)])
    alt_kernel = null_kernel + Lorentzian(
        log_S0=-1.0, log_Q=2.0, log_omega0=-2.0, bounds=[(-8, 5), (0, 6), (-5, 0)]
    )
    results = []
    for _ in range(2):
        np.random.seed()  # scramble the global RNG between runs
        results.append(
            protassov_lrt(
                lc, null_kernel, alt_kernel, nsims=8, seed=21,
                observed_max_steps=150, observed_walkers=8,
                sim_max_steps=40, sim_walkers=8, chunk=8,
            )
        )
    a, b = results
    assert a.t_obs == b.t_obs
    assert a.p_value == b.p_value
    np.testing.assert_array_equal(a.t_dist, b.t_dist)
    assert a.t_obs_posterior == b.t_obs_posterior


def test_percentile_of_score_matches_scipy():
    from scipy.stats import percentileofscore

    rng = np.random.default_rng(0)
    dist = rng.normal(size=500)
    for score in [-2.0, 0.0, dist[3], 2.5]:
        np.testing.assert_allclose(
            percentile_of_score(dist, score), percentileofscore(dist, score), atol=1e-10
        )


def test_fit_lightcurves_batch():
    lc = _drw_lc()
    kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)])
    rng = np.random.default_rng(1)
    # four "simulated" lightcurves = noisy copies of the observation
    ys = lc.y[None, :] + rng.normal(0, 0.3, (4, lc.n))
    dys = np.full((4, lc.n), 0.3)
    theta0 = np.array([np.log(4.0), np.log(0.05)])
    lls, xs = fit_lightcurves_batch(
        jax.random.key(2), kernel, lc.times, ys, dys, theta0, walkers=8, n_steps=100
    )
    assert lls.shape == (4,)
    assert xs.shape == (4, 2)
    assert np.all(np.isfinite(lls))
    # chains should improve on (or match) the starting point
    from mind_the_gaps_tpu.solver import log_likelihood as ll_fn
    import jax.numpy as jnp

    for b in range(4):
        ll_start = float(
            ll_fn(
                kernel.coefficients(jnp.asarray(theta0)),
                lc.times,
                ys[b] - ys[b].mean(),
                (dys[b] + 1e-12) ** 2,
            )
        )
        assert lls[b] >= ll_start - 1e-9


def test_per_row_theta0_semantics():
    """Per-row starting points (the round-6 calibration fix): (B, D)
    theta0 with identical rows must reproduce the shared-(D,) run
    bitwise, and genuinely different rows must steer their own row's
    chains (same data, different start -> different explored maximum
    for a short budget)."""
    lc = _drw_lc()
    kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)])
    rng = np.random.default_rng(3)
    ys = lc.y[None, :] + rng.normal(0, 0.3, (4, lc.n))
    dys = np.full((4, lc.n), 0.3)
    theta0 = np.array([np.log(4.0), np.log(0.05)])

    common = dict(walkers=8, n_steps=30, use_mesh=False)
    lls_shared, xs_shared = fit_lightcurves_batch(
        jax.random.key(5), kernel, lc.times, ys, dys, theta0, **common
    )
    lls_rows, xs_rows = fit_lightcurves_batch(
        jax.random.key(5), kernel, lc.times, ys, dys,
        np.broadcast_to(theta0, (4, 2)).copy(), **common
    )
    np.testing.assert_array_equal(lls_shared, lls_rows)
    np.testing.assert_array_equal(xs_shared, xs_rows)

    rows = np.broadcast_to(theta0, (4, 2)).copy()
    rows[2] = [np.log(0.05), np.log(0.4)]  # a far-away start for row 2 only
    lls_mixed, _ = fit_lightcurves_batch(
        jax.random.key(5), kernel, lc.times, ys, dys, rows, **common
    )
    assert lls_mixed[2] != lls_rows[2], "row 2's start did not affect row 2"
    np.testing.assert_array_equal(lls_mixed[[0, 1, 3]], lls_rows[[0, 1, 3]])


def test_alt_theta0_rows_embedding():
    """_alt_theta0_rows embeds null rows into a nesting alternative and
    falls back to the alternative's own vector otherwise."""
    from mind_the_gaps_tpu.lrt import _alt_theta0_rows
    from mind_the_gaps_tpu.kernels import Lorentzian

    null_k = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0)
    alt_k = DampedRandomWalk(log_S0=0.5, log_omega0=-2.0) + Lorentzian(
        log_S0=-1.0, log_Q=2.0, log_omega0=-2.0
    )
    null_rows = np.array([[0.1, -3.5], [0.2, -2.5]])
    rows = _alt_theta0_rows(null_k, alt_k, null_rows)
    assert rows.shape == (2, 5)
    np.testing.assert_array_equal(rows[:, :2], null_rows)
    np.testing.assert_array_equal(rows[:, 2:], np.broadcast_to([-1.0, 2.0, -2.0], (2, 3)))

    # non-nesting alternative: fully data-independent rows
    alt_k2 = Lorentzian(log_S0=-1.0, log_Q=2.0, log_omega0=-2.0)
    rows2 = _alt_theta0_rows(null_k, alt_k2, null_rows)
    np.testing.assert_array_equal(rows2, np.broadcast_to([-1.0, 2.0, -2.0], (2, 3)))


def test_early_stop_patience_at_budget_is_exact():
    """early_stop with patience >= n_steps runs the full budget and is
    bit-identical to the fixed scan path (both derive per-step keys via
    fold_in(k_run, step))."""
    lc = _drw_lc(seed=3, n=120)
    kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)])
    rng = np.random.default_rng(4)
    ys = lc.y[None, :] + rng.normal(0, 0.3, (3, lc.n))
    dys = np.full((3, lc.n), 0.3)
    theta0 = np.array([np.log(4.0), np.log(0.05)])
    common = dict(walkers=8, n_steps=60)
    lls_scan, xs_scan = fit_lightcurves_batch(
        jax.random.key(5), kernel, lc.times, ys, dys, theta0, **common
    )
    lls_es, xs_es = fit_lightcurves_batch(
        jax.random.key(5), kernel, lc.times, ys, dys, theta0,
        early_stop=(0.01, 60), **common
    )
    np.testing.assert_array_equal(lls_scan, lls_es)
    np.testing.assert_array_equal(xs_scan, xs_es)


def test_early_stop_plateau_rule_loses_little():
    """An aggressive plateau rule must stop early (same chains, fewer
    steps -> best loglike can only be <= the full run's) and the deficit
    at a plateau is bounded by the improvements it forfeits."""
    lc = _drw_lc(seed=6, n=120)
    kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)])
    rng = np.random.default_rng(8)
    ys = lc.y[None, :] + rng.normal(0, 0.3, (4, lc.n))
    dys = np.full((4, lc.n), 0.3)
    theta0 = np.array([np.log(4.0), np.log(0.05)])
    common = dict(walkers=8, n_steps=400)
    lls_full, _ = fit_lightcurves_batch(
        jax.random.key(7), kernel, lc.times, ys, dys, theta0, **common
    )
    lls_es, _ = fit_lightcurves_batch(
        jax.random.key(7), kernel, lc.times, ys, dys, theta0,
        early_stop=(0.05, 40), **common
    )
    # identical chains up to the stop step
    assert np.all(lls_es <= lls_full + 1e-12)
    # the forfeited tail of a plateaued chain is small
    assert np.all(lls_full - lls_es < 1.0)
    # deterministic
    lls_es2, _ = fit_lightcurves_batch(
        jax.random.key(7), kernel, lc.times, ys, dys, theta0,
        early_stop=(0.05, 40), **common
    )
    np.testing.assert_array_equal(lls_es, lls_es2)


def test_pallas_kernel_path_matches_xla(interpret_kernels):
    """The kernel path (backend="pallas", run by the Pallas interpreter
    here) drives the same chains as the XLA scan: same RNG stream, same
    f32 likelihoods to rounding."""
    lc = _drw_lc(seed=3, n=120)
    kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)])
    rng = np.random.default_rng(5)
    ys = lc.y[None, :] + rng.normal(0, 0.3, (2, lc.n))
    dys = np.full((2, lc.n), 0.3)
    theta0 = np.array([np.log(4.0), np.log(0.05)])
    common = dict(walkers=8, n_steps=50, use_mesh=False, dtype=np.float32)
    lls_p, xs_p = fit_lightcurves_batch(
        jax.random.key(2), kernel, lc.times, ys, dys, theta0, backend="pallas", **common
    )
    lls_x, xs_x = fit_lightcurves_batch(
        jax.random.key(2), kernel, lc.times, ys, dys, theta0, backend="xla", **common
    )
    np.testing.assert_allclose(lls_p, lls_x, rtol=1e-5)
    np.testing.assert_allclose(xs_p, xs_x, rtol=1e-4, atol=1e-4)


def test_pallas_kernel_path_raises_off_gpu():
    """Off a GPU the kernel path fails loudly: no silent switch to the
    scan, and no automatic interpret mode."""
    lc = _drw_lc(seed=3, n=40)
    kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)])
    theta0 = np.array([np.log(4.0), np.log(0.05)])
    assert jax.default_backend() == "cpu"
    with pytest.raises(Exception, match="(?i)interpret|cpu|triton|platform"):
        fit_lightcurves_batch(
            jax.random.key(2), kernel, lc.times, lc.y[None, :], lc.dy[None, :], theta0,
            walkers=8, n_steps=5, use_mesh=False, dtype=np.float32, backend="pallas",
        )


def test_auto_backend_is_xla_off_gpu():
    """backend="auto" reads ops.gpu_kernel_available(): the scan on CPU."""
    from mind_the_gaps_tpu.lrt import _ChunkFitter
    from mind_the_gaps_tpu.ops import gpu_kernel_available

    lc = _drw_lc(seed=3, n=40)
    kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)])
    assert not gpu_kernel_available()
    fitter = _ChunkFitter(kernel, lc.times, kernel.get_parameter_vector(), dtype=np.float32)
    assert not fitter.use_pallas
    with pytest.raises(ValueError, match="unknown backend"):
        _ChunkFitter(kernel, lc.times, kernel.get_parameter_vector(), backend="mosaic")


def test_runner_runtime_errors_propagate(monkeypatch):
    """An error from the (successfully compiled) kernel runner must
    surface, not be silently retried on XLA."""
    import mind_the_gaps_tpu.lrt as lrt_mod

    class FakeLowered:
        def compile(self):
            def boom(*args):
                raise FloatingPointError("runtime boom")

            return boom

    class FakeRunner:
        def lower(self, *args, **kwargs):
            return FakeLowered()

        def __call__(self, *args):
            raise FloatingPointError("runtime boom")

    real_make = lrt_mod._make_batched_max_loglike

    def fake_make(kernel, t, n_steps, walkers, a=2.0, dtype=None, backend="xla", **kwargs):
        if backend == "pallas":
            return FakeRunner()
        return real_make(kernel, t, n_steps, walkers, a=a, dtype=dtype, backend=backend, **kwargs)

    monkeypatch.setattr(lrt_mod, "_make_batched_max_loglike", fake_make)

    lc = _drw_lc(seed=3, n=80)
    kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)])
    theta0 = np.array([np.log(4.0), np.log(0.05)])
    try:
        fit_lightcurves_batch(
            jax.random.key(2), kernel, lc.times, lc.y[None, :], lc.dy[None, :], theta0,
            walkers=8, n_steps=50, use_mesh=False, dtype=np.float32, backend="pallas",
        )
    except FloatingPointError as exc:
        assert "runtime boom" in str(exc)
    else:
        raise AssertionError("runtime error from the runner was swallowed")


def test_protassov_lrt_lognormal_end_to_end():
    """The non-Gaussian (E13 lognormal) bootstrap chain — generation,
    noise, grouped refits, p-value — through the public pipeline
    (reference tutorial_ppp.ipynb pdf option / gpmodelling.py:478-539)."""
    lc = _drw_lc(seed=11, n=100)
    null_kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)])
    alt_kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)]) + Lorentzian(
        log_S0=-1.0, log_Q=2.0, log_omega0=-2.0, bounds=[(-8, 5), (0, 6), (-5, 0)]
    )
    res = protassov_lrt(
        lc,
        null_kernel,
        alt_kernel,
        nsims=8,
        pdf="Lognormal",
        observed_max_steps=400,
        observed_walkers=16,
        sim_max_steps=100,
        sim_walkers=8,
        seed=5,
        keep_simulations=True,
    )
    assert res.t_dist.shape == (8,)
    assert np.all(np.isfinite(res.t_dist))
    assert 0.0 <= res.p_value <= 1.0
    # the simulated lightcurves actually went through the lognormal
    # pdf-adjustment + noise path: strictly positive-skewed rates
    assert res.sim_rates.shape == (8, lc.n)
    assert np.all(np.isfinite(res.sim_rates))


def test_protassov_lrt_null_is_unexceptional():
    lc = _drw_lc(seed=42, n=150)
    null_kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)])
    alt_kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)]) + Lorentzian(
        log_S0=-1.0, log_Q=2.0, log_omega0=-2.0, bounds=[(-8, 5), (0, 6), (-5, 0)]
    )
    res = protassov_lrt(
        lc,
        null_kernel,
        alt_kernel,
        nsims=16,
        observed_max_steps=600,
        observed_walkers=16,
        sim_max_steps=150,
        sim_walkers=8,
        seed=3,
    )
    assert res.t_dist.shape == (16,)
    assert np.all(np.isfinite(res.t_dist))
    # alternative nests the null: T >= 0 up to MCMC noise
    assert res.t_obs > -2.0
    assert np.mean(res.t_dist > -2.0) > 0.8
    assert 0.0 <= res.p_value <= 1.0

    # calibration with MATCHED estimators: recompute the observed T with
    # the same short-chain fitter used for the simulations (the raw
    # pipeline shares the reference's long-vs-short chain asymmetry,
    # which biases T_obs high at small step counts)
    from mind_the_gaps_tpu.lrt import fit_lightcurves_batch, percentile_of_score
    import jax as _jax

    ll0, _ = fit_lightcurves_batch(
        _jax.random.key(9), null_kernel, lc.times, lc.y[None, :], lc.dy[None, :],
        res.null_model.max_parameters[: null_kernel.ndim], walkers=8, n_steps=150,
    )
    ll1, _ = fit_lightcurves_batch(
        _jax.random.key(10), alt_kernel, lc.times, lc.y[None, :], lc.dy[None, :],
        res.alt_model.max_parameters[: alt_kernel.ndim], walkers=8, n_steps=150,
    )
    t_obs_matched = -2.0 * (float(ll0[0]) - float(ll1[0]))
    p_matched = 1.0 - percentile_of_score(res.t_dist, t_obs_matched) / 100.0
    # data generated under the null: matched-estimator p is not extreme
    assert p_matched > 0.05


def test_fit_lightcurves_batch_shard_map():
    """The explicit shard_map SPMD path must run partitioned over the
    8-device test mesh, give finite improving max-loglikes, and agree
    with the GSPMD path at the ensemble level (different per-shard RNG
    streams, same statistics)."""
    lc = _drw_lc()
    kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)])
    rng = np.random.default_rng(2)
    B = 16
    ys = lc.y[None, :] + rng.normal(0, 0.3, (B, lc.n))
    dys = np.full((B, lc.n), 0.3)
    theta0 = np.array([np.log(4.0), np.log(0.05)])

    lls_sm, xs_sm = fit_lightcurves_batch(
        jax.random.key(3), kernel, lc.times, ys, dys, theta0,
        walkers=8, n_steps=150, spmd="shard_map",
    )
    lls_g, _ = fit_lightcurves_batch(
        jax.random.key(3), kernel, lc.times, ys, dys, theta0,
        walkers=8, n_steps=150,
    )
    assert lls_sm.shape == (B,) and xs_sm.shape == (B, 2)
    assert np.all(np.isfinite(lls_sm))
    # same short-MCMC max-loglike estimator, so per-lightcurve agreement
    # should be tight even with different RNG streams
    np.testing.assert_allclose(lls_sm, lls_g, rtol=0.05, atol=2.0)


def test_protassov_lrt_uniform_pdf():
    """The Uniform flux-PDF option also runs end to end (the reference's
    third pdf choice, stats.create_uniform_distribution)."""
    lc = _drw_lc(seed=13, n=80)
    null_kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)])
    alt_kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)]) + Lorentzian(
        log_S0=-1.0, log_Q=2.0, log_omega0=-2.0, bounds=[(-8, 5), (0, 6), (-5, 0)]
    )
    res = protassov_lrt(
        lc, null_kernel, alt_kernel, nsims=4, pdf="Uniform",
        observed_max_steps=200, observed_walkers=8, sim_max_steps=60,
        sim_walkers=8, seed=6,
    )
    assert res.t_dist.shape == (4,)
    assert np.all(np.isfinite(res.t_dist))
    assert 0.0 <= res.p_value <= 1.0


def test_f64_refinement_matches_direct_f64():
    """loglikes_f64_at must reproduce the exact f64 log-posterior of the
    bootstrap model (per-lc constant mean, jitter, flat prior) at the
    f32-explored optima to 1e-6 — the T statistics are then f64-exact."""
    import jax.numpy as jnp

    from mind_the_gaps_tpu.lrt import loglikes_f64_at
    from mind_the_gaps_tpu.solver import log_likelihood as ll_fn

    lc = _drw_lc(seed=3, n=150)
    kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)])
    rng = np.random.default_rng(4)
    ys = lc.y[None, :] + rng.normal(0, 0.3, (5, lc.n))
    dys = np.full((5, lc.n), 0.3)
    theta0 = np.array([np.log(4.0), np.log(0.05)])
    lls32, xs = fit_lightcurves_batch(
        jax.random.key(5), kernel, lc.times, ys, dys, theta0,
        walkers=8, n_steps=60, dtype=jnp.float32,
    )
    refined = loglikes_f64_at(kernel, lc.times, ys, dys, xs)
    # direct f64 evaluation, one lightcurve at a time via the parity solver
    for b in range(5):
        th = jnp.asarray(xs[b], dtype=jnp.float64)
        resid = jnp.asarray(ys[b] - ys[b].mean(), dtype=jnp.float64)
        diag = jnp.asarray((dys[b] + 1e-12) ** 2, dtype=jnp.float64) + kernel.jitter(th)
        direct = float(ll_fn(kernel.coefficients(th), jnp.asarray(lc.times), resid, diag))
        np.testing.assert_allclose(refined[b], direct, rtol=1e-9, atol=1e-6)
        # and the refinement corrects genuine f32 rounding, staying close
        assert abs(refined[b] - float(lls32[b])) < 0.2


def test_device_pipeline_chunk_edges():
    """The device-resident LRT pipeline must handle every chunk layout:
    nsims a multiple of chunk (obs rides an obs-only final chunk),
    ragged final chunk (obs appended to it), and single-chunk runs."""
    lc = _drw_lc(seed=9, n=80)
    null_kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)])
    alt_kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)]) + Lorentzian(
        log_S0=-1.0, log_Q=2.0, log_omega0=-2.0, bounds=[(-8, 5), (0, 6), (-5, 0)]
    )
    from mind_the_gaps_tpu.gpmodelling import GPModelling

    null_model = GPModelling(lc, null_kernel)
    null_model.derive_posteriors(max_steps=300, walkers=12, seed=21, converge=False)
    alt_model = GPModelling(lc, alt_kernel)
    alt_model.derive_posteriors(max_steps=300, walkers=12, seed=22, converge=False)

    for nsims, chunk in [(8, 4), (6, 4), (5, 16)]:
        res = protassov_lrt(
            lc, null_kernel, alt_kernel, nsims=nsims, chunk=chunk, seed=3,
            null_model=null_model, alt_model=alt_model,
            sim_max_steps=60, sim_walkers=8, sigma_noise=0.3,
        )
        assert res.t_dist.shape == (nsims,), (nsims, chunk, res.t_dist.shape)
        assert np.all(np.isfinite(res.t_dist))
        assert np.isfinite(res.t_obs)
        assert 0.0 <= res.p_value <= 1.0
        assert res.sim_rates is None  # device pipeline keeps sims on device


def test_checkpoint_resume_reproduces_full_run(tmp_path):
    """An interrupted bootstrap resumed from its checkpoint must produce
    EXACTLY the uninterrupted result (chunk RNG keys are precomputed),
    and a config change must invalidate the file with a warning."""
    import warnings as _warnings

    from mind_the_gaps_tpu.gpmodelling import GPModelling

    lc = _drw_lc(seed=13, n=80)
    null_kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)])
    alt_kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)]) + Lorentzian(
        log_S0=-1.0, log_Q=2.0, log_omega0=-2.0, bounds=[(-8, 5), (0, 6), (-5, 0)]
    )
    null_model = GPModelling(lc, null_kernel)
    null_model.derive_posteriors(max_steps=300, walkers=12, seed=31, converge=False)
    alt_model = GPModelling(lc, alt_kernel)
    alt_model.derive_posteriors(max_steps=300, walkers=12, seed=32, converge=False)

    common = dict(
        nsims=8, chunk=4, seed=5, null_model=null_model, alt_model=alt_model,
        sim_max_steps=60, sim_walkers=8, sigma_noise=0.3,
    )
    ckpt = str(tmp_path / "boot.npz")
    full = protassov_lrt(lc, null_kernel, alt_kernel, **common)
    res1 = protassov_lrt(lc, null_kernel, alt_kernel, checkpoint=ckpt, **common)
    np.testing.assert_array_equal(res1.t_dist, full.t_dist)

    # simulate an interruption: rewind the file to 1 completed chunk
    d = dict(np.load(ckpt))
    np.savez(ckpt + ".tmp.npz", config_crc=d["config_crc"], chunks_done=np.int64(1),
             null_done=d["null_done"][:4], alt_done=d["alt_done"][:4])
    import os
    os.replace(ckpt + ".tmp.npz", ckpt)
    res2 = protassov_lrt(lc, null_kernel, alt_kernel, checkpoint=ckpt, **common)
    np.testing.assert_array_equal(res2.t_dist, full.t_dist)
    assert res2.p_value == full.p_value

    # a config change must not silently reuse the checkpoint — including
    # inputs that only affect the simulations (sigma_noise), not just
    # the RNG seed
    for change in ({"seed": 6}, {"sigma_noise": 0.5}):
        other = dict(common)
        other.update(change)
        with _warnings.catch_warnings(record=True) as rec:
            _warnings.simplefilter("always")
            res3 = protassov_lrt(lc, null_kernel, alt_kernel, checkpoint=ckpt, **other)
        assert any("different" in str(w.message) for w in rec), change
        assert np.isfinite(res3.t_dist).all()
