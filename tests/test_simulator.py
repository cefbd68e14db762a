"""Simulator tests (rebuild of reference tests/simulator_test.py, with the
ensembles batched through simulate_batch for speed).

The statistical contracts checked (same as the reference):
- TK95 slope recovery, PSD normalization (integral == rms^2),
- ensemble mean/variance == PSD inputs,
- deterministic downsampling against hand-computed index windows,
- segment cutting preserves duration/sampling,
- E13-adjusted series match the target PDF moments,
- noise models: Poisson/Gaussian statistics, Kraft low-count handling.
"""
import zlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mind_the_gaps_tpu.fitting import fit_psd_powerlaw
from mind_the_gaps_tpu.models import psd_models
from mind_the_gaps_tpu.simulator import (
    GaussianNoise,
    KraftNoise,
    PoissonNoise,
    RegularLightcurve,
    Simulator,
    cut_random_segment,
)


def power_spectrum(timestamps, rate):
    dt = np.mean(np.diff(timestamps))
    freqs = np.fft.rfftfreq(len(timestamps), dt)
    if len(freqs) % 2 == 0:
        pow_spec = (np.absolute(np.fft.rfft(rate)[1:-1])) ** 2
        frequencies = freqs[1:-1]
    else:
        pow_spec = (np.absolute(np.fft.rfft(rate)[1:])) ** 2
        frequencies = freqs[1:]
    return frequencies, pow_spec


def _batch(simu, nsims, seed=0):
    psd_vals = np.asarray(simu._psd_values())
    batch = jnp.broadcast_to(jnp.asarray(psd_vals), (nsims, len(psd_vals)))
    rates = simu.simulate_batch(jax.random.key(seed), batch)
    return np.asarray(rates)


def test_slope_TK95():
    dt = 0.5
    points = 500
    timestamps = np.arange(0, points, dt) + dt / 2
    input_beta = 1
    psd_model = psd_models.PowerLaw(amplitude=1, alpha=input_beta)
    simu = Simulator(psd_model, timestamps, dt, 0, aliasing_factor=1, extension_factor=1.05)
    rates = _batch(simu, 120, seed=1)
    slopes = []
    for rate in rates:
        frequencies, pow_spec = power_spectrum(timestamps, rate)
        psd_slope, err, _, _ = fit_psd_powerlaw(frequencies, pow_spec)
        slopes.append(psd_slope)
    err = np.abs(np.std(slopes))
    assert abs(-input_beta - np.mean(slopes)) < err


def test_slope_and_mean_E13():
    dt = 0.5
    points = 500
    timestamps = np.arange(0, points, dt) + dt / 2
    input_beta = 1
    input_mean = 100
    psd_model = psd_models.PowerLaw(amplitude=1, alpha=input_beta)
    simu = Simulator(
        psd_model, timestamps, dt, input_mean, "Lognormal", extension_factor=1.05, aliasing_factor=1
    )
    rates = _batch(simu, 100, seed=2)
    slopes, means = [], []
    for rate in rates:
        frequencies, pow_spec = power_spectrum(timestamps, rate)
        psd_slope, err, _, _ = fit_psd_powerlaw(frequencies, pow_spec)
        slopes.append(psd_slope)
        means.append(np.mean(rate))
    assert abs(-input_beta - np.mean(slopes)) < 3 * np.std(slopes)
    assert abs(input_mean - np.mean(means)) < 3 * np.std(means)


def test_powerspectrum_normalization():
    """Integral of the normalized power spectrum == fractional rms^2
    (the critical celerite normalization contract,
    reference simulator_test.py:137-153)."""
    psd_model = psd_models.PowerLaw(amplitude=1e-10, alpha=1)
    exposures = 0.8
    times = np.arange(0, 1000, exposures)
    mean = 10000
    simu = Simulator(psd_model, times, exposures, mean, "Gaussian", extension_factor=1.05, aliasing_factor=8)
    lc = simu.simulate_regularly_sampled()
    freqs = np.fft.rfftfreq(lc.n, lc.dt)
    pow_spec = (np.absolute(np.fft.rfft(lc.countrate)[1:])) ** 2
    frequencies = freqs[1:]
    pow_spec *= 2 * lc.dt / np.mean(lc.countrate) ** 2 / lc.n
    integral = np.median(np.diff(frequencies)) * np.sum(pow_spec)
    rms = np.var(lc.countrate) / np.mean(lc.countrate) ** 2
    np.testing.assert_allclose(integral, rms, atol=0.1)


def test_std_mean_and_variance_TK95():
    dt = 1
    timestamps = np.arange(0, 8500, dt)
    variance = 10
    psd_model = psd_models.BendingPowerlaw(S0=variance, omega0=np.exp(-3))
    mean = 1
    simu = Simulator(psd_model, timestamps, dt, mean, "Gaussian", extension_factor=1.05, aliasing_factor=1)
    rates = _batch(simu, 100, seed=3)
    vars_, means = rates.var(axis=1), rates.mean(axis=1)
    assert abs(variance - np.mean(vars_)) < np.std(vars_)
    assert abs(mean - np.mean(means)) < np.std(means)


def test_std_mean_and_variance_E13():
    dt = 1
    # 4500-sample span x 64 sims (was 8500 x 100): the span still covers
    # ~220 bend timescales so the per-sim variance estimate is unbiased,
    # and the seeded margins are 0.23 (variance) / 0.00 (mean) vs the
    # < 1-std assertion — measured 27 s vs 61 s
    timestamps = np.arange(0, 4500, dt)
    variance = 10
    psd_model = psd_models.BendingPowerlaw(S0=variance, omega0=np.exp(-3))
    mean = 10
    simu = Simulator(
        psd_model, timestamps, dt, mean, "Lognormal", extension_factor=1.05, aliasing_factor=1, max_iter=600
    )
    rates = _batch(simu, 64, seed=4)
    vars_, means = rates.var(axis=1), rates.mean(axis=1)
    assert abs(variance - np.mean(vars_)) < np.std(vars_)
    assert abs(mean - np.mean(means)) < np.std(means)


# ------------------------------------------------------------------ #
# deterministic downsampling (reference simulator_test.py:192-253)
# ------------------------------------------------------------------ #
@pytest.mark.parametrize(
    "exposures,idxstrue",
    [
        (0.5, [[3, 4, 5, 6, 7], [23, 24, 25, 26, 27], [43, 44, 45, 46, 47], [63, 64, 65, 66, 67]]),
        (0.6, [[2, 3, 4, 5, 6, 7, 8], [22, 23, 24, 25, 26, 27, 28], [42, 43, 44, 45, 46, 47, 48], [62, 63, 64, 65, 66, 67, 68]]),
        (0.1, [[5], [25], [45], [65]]),
    ],
)
def test_downsampling(exposures, idxstrue):
    timestamps = np.append(np.arange(1, 3.1, 2), np.arange(5, 7.1, 2))
    dt = 0.1
    times = np.arange(0.5, 10.1, dt)
    counts = np.linspace(5, 20, len(times))
    countrates = counts / exposures

    lc = RegularLightcurve(times, countrates, dt=dt)
    psd_model = psd_models.PowerLaw(amplitude=10, alpha=2)
    simu = Simulator(psd_model, timestamps, exposures, 0, extension_factor=1.0, aliasing_factor=1)
    truerates = [np.mean(countrates[idx[0] : idx[-1] + 1]) for idx in idxstrue]
    downsampled = simu.downsample(lc)
    np.testing.assert_allclose(truerates, downsampled)


def test_static_windows_match_host_downsample():
    """The precomputed static index windows used in the batched pipeline
    must reproduce the host downsample on the canonical segment grid."""
    rng = np.random.default_rng(5)
    timestamps = np.sort(rng.uniform(0, 300, 40))
    timestamps = timestamps[np.concatenate([[True], np.diff(timestamps) > 3.0])]
    exposures = 1.0
    psd_model = psd_models.PowerLaw(amplitude=10, alpha=1)
    simu = Simulator(psd_model, timestamps, exposures, 5.0, extension_factor=2.0)
    # canonical segment
    seg_times = simu._seg_times
    seg_rates = rng.normal(5.0, 1.0, len(seg_times))
    host = simu.downsample(RegularLightcurve(seg_times, seg_rates, dt=simu.sim_dt))
    from mind_the_gaps_tpu.simulator.core import downsample_cumsum

    fast = np.asarray(
        downsample_cumsum(jnp.asarray(seg_rates), jnp.asarray(simu._win_starts), jnp.asarray(simu._win_ends))
    )
    np.testing.assert_allclose(fast, host, rtol=1e-12)


# ------------------------------------------------------------------ #
# segment cutting (reference simulator_test.py:255-304)
# ------------------------------------------------------------------ #
def test_evenly_lc_duration():
    input_beta = 1
    mean = 0.5
    psd_model = psd_models.PowerLaw(amplitude=1, alpha=input_beta)
    for sim_dt in [0.01]:
        timestamps = np.arange(0, 10, sim_dt)
        simu = Simulator(psd_model, timestamps, sim_dt, mean, extension_factor=50)
        lc = simu.simulate_regularly_sampled()
        duration = timestamps[-1] - timestamps[0]
        lc_cut = cut_random_segment(lc, duration)
        duration_cut = (lc_cut.time[-1] - lc_cut.dt / 2) - (lc_cut.time[0] + lc_cut.dt / 2)
        np.testing.assert_allclose(duration_cut, duration, atol=sim_dt)


def test_lc_sampling():
    input_beta = 1
    mean = 0.5
    psd_model = psd_models.PowerLaw(amplitude=1, alpha=input_beta)
    for dt in [0.1, 1]:
        timestamps = np.arange(0, 10, dt)
        simu = Simulator(psd_model, timestamps, dt, mean, extension_factor=50, aliasing_factor=1)
        lc = simu.simulate_regularly_sampled()
        duration = timestamps[-1] - timestamps[0]
        lc_cut = cut_random_segment(lc, duration)
        assert lc_cut.dt == dt


# ------------------------------------------------------------------ #
# E13 PDF adjustment (reference simulator_test.py:375-455, smaller N)
# ------------------------------------------------------------------ #
class TestPDF:
    dt = 1.0
    npoints = 2**17
    inputmean = 10.0

    def _setup(self, pdf_type, seed):
        timestamps = np.arange(0, self.npoints, self.dt)
        omega = 2 * np.pi / 1000
        psd_model = psd_models.BendingPowerlaw(S0=10, omega0=omega)
        simu = Simulator(
            psd_model, timestamps, self.dt, self.inputmean, pdf_type,
            extension_factor=1.05, aliasing_factor=1, max_iter=1000,
            random_state=seed,
        )
        lc = simu.simulate_regularly_sampled()
        segment = cut_random_segment(lc, simu.sim_duration)
        return simu, segment

    def test_pdf_lognormal(self):
        simu, segment = self._setup("Lognormal", 10)
        inputvar = np.var(segment.countrate)
        adjusted = simu.simulator.adjust_pdf(segment).countrate
        x = adjusted
        # moment check against the moment-matched lognormal target
        np.testing.assert_allclose(np.mean(x), self.inputmean, atol=0.15)
        np.testing.assert_allclose(np.var(x), inputvar, rtol=0.05)
        assert np.all(x > 0)
        # lognormality: skewness of log(x) should be ~0
        logx = np.log(x)
        skew = np.mean((logx - logx.mean()) ** 3) / logx.std() ** 3
        assert abs(skew) < 0.2

    def test_pdf_uniform(self):
        simu, segment = self._setup("Uniform", 11)
        inputvar = np.var(segment.countrate)
        x = simu.simulator.adjust_pdf(segment).countrate
        np.testing.assert_allclose(np.mean(x), self.inputmean, atol=0.1)
        np.testing.assert_allclose(np.var(x), inputvar, rtol=0.1)
        # uniformity: bounded support, flat histogram -> kurtosis ~ 1.8
        kurt = np.mean((x - x.mean()) ** 4) / x.var() ** 2
        np.testing.assert_allclose(kurt, 1.8, atol=0.15)

    def test_pdf_gaussian_noop(self):
        simu, segment = self._setup("Gaussian", 12)
        adjusted = simu.simulator.adjust_pdf(segment)
        np.testing.assert_array_equal(adjusted.countrate, segment.countrate)


# ------------------------------------------------------------------ #
# noise models
# ------------------------------------------------------------------ #
def test_poisson_noise_stats():
    n = 20000
    exposures = np.full(n, 100.0)
    rates = np.full(n, 2.0)
    noise = PoissonNoise(exposures)
    noise.seed(0)
    noisy, dy = noise.add_noise(rates)
    np.testing.assert_allclose(np.mean(noisy), 2.0, atol=0.01)
    # var of counts = 200 -> var of rate = 200/100^2 = 0.02
    np.testing.assert_allclose(np.var(noisy), 0.02, rtol=0.05)
    np.testing.assert_allclose(np.mean(dy), np.sqrt(200) / 100, rtol=0.01)


def test_gaussian_noise_stats():
    n = 20000
    noise = GaussianNoise(np.ones(n), sigma_noise=0.5)
    noise.seed(1)
    noisy, dy = noise.add_noise(np.full(n, 3.0))
    np.testing.assert_allclose(np.std(noisy), 0.5, rtol=0.05)
    np.testing.assert_array_equal(dy, 0.5)


def test_kraft_noise_low_counts():
    """Low-count bins get Kraft medians and HPD errors; high-count bins
    keep the frequentist treatment."""
    n = 1000
    exposures = np.full(n, 1.0)
    bkg_counts = np.full(n, 1.0)
    noise = KraftNoise(exposures, bkg_counts, np.full(n, 0.1))
    noise.seed(2)
    rates = np.full(n, 3.0)  # few counts -> mostly Kraft bins
    noisy, dy = noise.add_noise(rates)
    assert np.all(np.isfinite(noisy)) and np.all(np.isfinite(dy))
    assert np.all(noisy >= 0)  # Kraft medians are nonnegative
    # the posterior median is biased high at low counts (mean ~ N+1-B);
    # the reference's scipy/astropy path has the same property
    np.testing.assert_allclose(np.mean(noisy), 3.7, atol=0.5)

    # high-count: identical to PoissonNoise
    noise_hi = KraftNoise(exposures, bkg_counts, np.full(n, 0.1))
    noise_hi.seed(3)
    poiss = PoissonNoise(exposures, bkg_counts, np.full(n, 0.1))
    poiss.seed(3)
    hi_rates = np.full(n, 100.0)
    n1, d1 = noise_hi.add_noise(hi_rates)
    n2, d2 = poiss.add_noise(hi_rates)
    np.testing.assert_allclose(n1, n2)
    np.testing.assert_allclose(d1, d2)


def test_simulator_validation():
    psd = psd_models.PowerLaw()
    times = np.arange(0, 10, 1.0)
    with pytest.raises(ValueError):
        Simulator(psd, times, 1.0, 0.0, extension_factor=0.5)
    with pytest.raises(ValueError):
        Simulator(psd, times, 1.0, 0.0, epsilon=0.5)
    with pytest.raises(ValueError):
        Simulator(psd, times, 0.0, 0.0)
    with pytest.raises(ValueError):
        Simulator(psd, times, 1.0, 0.0, pdf="weibull")
    with pytest.raises(ValueError):
        Simulator(psd, times, 5.0, 0.0)  # spacing below exposure time


def test_batched_matches_single_statistics():
    """simulate_batch and generate_lightcurve draw from the same law."""
    timestamps = np.arange(0, 2000, 1.0)
    psd_model = psd_models.BendingPowerlaw(S0=5.0, omega0=np.exp(-3))
    simu = Simulator(psd_model, timestamps, 1.0, 7.0, "Gaussian", extension_factor=1.05,
                     aliasing_factor=1, random_state=42)
    batched = _batch(simu, 64, seed=7)
    singles = np.array([simu.generate_lightcurve() for _ in range(16)])
    assert batched.shape == (64, len(timestamps))
    np.testing.assert_allclose(batched.mean(), singles.mean(), atol=0.5)
    np.testing.assert_allclose(batched.std(), singles.std(), rtol=0.25)


def test_generate_batch_with_kraft_noise():
    """The posterior-predictive batch path must work with the Kraft
    (low-count Bayesian) noise model selected via background rates."""
    import jax

    rng = np.random.default_rng(8)
    n = 60
    times = np.cumsum(rng.uniform(40.0, 80.0, n))
    psd_model = psd_models.BendingPowerlaw(S0=0.001, omega0=0.01)
    bkg_rate = np.full(n, 0.05)
    sim = Simulator(
        psd_model, times, 10.0, 0.5, "Gaussian",
        bkg_rate=bkg_rate, bkg_rate_err=np.full(n, 0.01),
        extension_factor=2, random_state=1,
    )
    assert sim.noise.name == "Kraft"
    psd_vals = np.asarray(sim._psd_values())
    batch = jnp.broadcast_to(jnp.asarray(psd_vals), (6, len(psd_vals)))
    rates = sim.simulate_batch(jax.random.key(0), batch)
    noisy, dy = sim.add_noise_batch(jax.random.key(1), rates)
    noisy, dy = np.asarray(noisy), np.asarray(dy)
    assert noisy.shape == (6, n)
    assert np.all(np.isfinite(noisy)) and np.all(np.isfinite(dy))
    assert np.all(dy > 0)


# (the two-phase phase1_iters straggler-compaction path and its
# bit-identity test were removed in round 3: measured slower than the
# single-phase path on this runtime — see Simulator.simulate_batch)


# ---------------------------------------------------------------------- #
# bend-frequency recovery from simulated periodograms
# (reference simulator_test.py:89-136, ensembles batched for speed)
# ---------------------------------------------------------------------- #
def _recover_bend_omegas(simu, times, nsims, seed, variance, bendscale):
    """Fit a BendingPowerlaw to each simulated periodogram by minimizing
    the Whittle S statistic (reference simulator_test.py:35-38) and
    return the recovered bend angular frequencies."""
    from scipy.optimize import minimize

    from mind_the_gaps_tpu.fitting import s_statistic

    omega0 = 2 * np.pi / bendscale
    rates = _batch(simu, nsims, seed=seed)
    bnds = ((1e-5, 1e5), (omega0 / 100, omega0 * 100))
    omegas = []
    for rate in rates:
        freqs, powers = power_spectrum(times, rate)

        def model_fit(params):
            model = np.asarray(psd_models.BendingPowerlaw(params[0], params[1])(freqs))
            return s_statistic(powers, model)

        res = minimize(model_fit, [variance, 1 / bendscale], bounds=bnds, method="L-BFGS-B")
        omegas.append(res.x[1] * 2 * np.pi)
    return np.asarray(omegas), omega0


def test_powerspec_bendingpowerlaw_TK95():
    """The bend frequency is recovered from an ensemble of TK95 simulated
    periodograms via S-stat minimization (reference simulator_test.py:89-111)."""
    times = np.arange(0.5, 1000.0, 1.0)
    variance, bendscale = 100.0, 20.0
    psd_model = psd_models.BendingPowerlaw(S0=variance, omega0=2 * np.pi / bendscale)
    simu = Simulator(psd_model, times, 0.2, 10, "Gaussian", extension_factor=1.0, aliasing_factor=2)
    omegas, omega0 = _recover_bend_omegas(simu, times, 200, zlib.crc32(b"bend_tk95"), variance, bendscale)
    assert abs(np.mean(omegas) - omega0) < np.std(omegas)


def test_powerspec_bendingpowerlaw_E13():
    """Same recovery through the E13 (lognormal) adjustment
    (reference simulator_test.py:113-136)."""
    times = np.arange(0.5, 1000.0, 1.0)
    variance, bendscale = 100.0, 20.0
    psd_model = psd_models.BendingPowerlaw(S0=variance, omega0=2 * np.pi / bendscale)
    # exposures 0.5 (sim_dt 0.25, E13 cut 4000 vs 10000 at the reference's
    # 0.2) and 64 sims: the fine grid still resolves the bend (omega0 =
    # 0.31 rad vs Nyquist 12.6) and the seeded recovery passes with
    # margin |mean - omega0| / std = 0.76 — measured 80 s vs 304 s on
    # the CI host
    simu = Simulator(
        psd_model, times, 0.5, 10, "Lognormal", extension_factor=1.0, aliasing_factor=2, max_iter=600
    )
    omegas, omega0 = _recover_bend_omegas(simu, times, 64, zlib.crc32(b"bend_e13"), variance, bendscale)
    assert abs(np.mean(omegas) - omega0) < np.std(omegas)


# ---------------------------------------------------------------------- #
# seeded ensemble mean/variance regressions
# (reference simulator_test.py:306-374; seeded — the reference passes its
# tight deltas at np.random.seed(100), these at the crc32 seeds below)
# ---------------------------------------------------------------------- #
class TestRegularlySampledBendingPowerlaw:
    variance = 1.0
    inputmean = 100.0

    @classmethod
    def setup_class(cls):
        omega0 = 2 * np.pi / 200.0
        exposures = 0.2
        times = np.arange(0, 20000, exposures)
        psd_model = psd_models.BendingPowerlaw(S0=cls.variance, omega0=omega0)
        simu = Simulator(
            psd_model, times, exposures, cls.inputmean, "Gaussian",
            extension_factor=1.05, aliasing_factor=1,
            random_state=zlib.crc32(b"regular_bpl"),
        )
        means, variances = [], []
        for _ in range(100):
            lc = simu.simulate_regularly_sampled()
            means.append(np.mean(lc.countrate))
            variances.append(np.var(lc.countrate))
        cls.outputmean = np.mean(means)
        cls.outputvariance = np.mean(variances)

    def test_mean(self):
        assert abs(self.outputmean - self.inputmean) < 0.01

    def test_variance(self):
        assert abs(self.outputvariance - self.variance) < 0.02


class TestRegularlySampledLorentzian:
    variance = 1.0
    inputmean = 100.0

    @classmethod
    def setup_class(cls):
        omega0 = 2 * np.pi / 200.0
        exposures = 0.2
        times = np.arange(0, 50000, exposures)
        psd_model = psd_models.Lorentzian(S0=cls.variance, omega0=omega0, Q=10)
        simu = Simulator(
            psd_model, times, exposures, cls.inputmean, "Gaussian",
            extension_factor=1.05, aliasing_factor=1,
            random_state=zlib.crc32(b"regular_lor"),
        )
        means, variances = [], []
        for _ in range(100):
            lc = simu.simulate_regularly_sampled()
            means.append(np.mean(lc.countrate))
            variances.append(np.var(lc.countrate))
        cls.outputmean = np.mean(means)
        cls.outputvariance = np.mean(variances)

    def test_mean(self):
        assert abs(self.outputmean - self.inputmean) < 0.01

    def test_variance(self):
        assert abs(self.outputvariance - self.variance) < 0.02


def test_lognormal_generator_precompiles_psd_only():
    """The non-Gaussian device generator's LRT entry hook compiles only
    the batched PSD program (B given) and is a no-op without a batch."""
    from concurrent.futures import ThreadPoolExecutor

    from mind_the_gaps_tpu import GappyLightcurve
    from mind_the_gaps_tpu.gpmodelling import GPModelling
    from mind_the_gaps_tpu.kernels import DampedRandomWalk

    timestamps = np.arange(0, 2000, 1.0)
    rng = np.random.default_rng(3)
    lc = GappyLightcurve(
        timestamps, rng.normal(7.0, 1.0, len(timestamps)),
        np.full(len(timestamps), 0.3), exposures=1.0,
    )
    model = GPModelling(lc, DampedRandomWalk(log_S0=1.0, log_omega0=-3.0))
    gen = model.make_device_generator("Lognormal")
    with ThreadPoolExecutor(1) as ex:
        assert gen.precompile(ex) == []
        futs = gen.precompile(ex, B=4)
        assert len(futs) == 1
        futs[0].result(timeout=300)


def test_simulate_batch_lognormal_chunks_match_one_chunk():
    """E13 generation in several lock-step chunks (ragged last chunk)
    gives the rows that one whole-batch chunk gives: each row's loop
    freezes on its own convergence test."""
    times = np.arange(0, 600, 1.0)
    psd_model = psd_models.BendingPowerlaw(S0=5.0, omega0=np.exp(-3))
    simu = Simulator(
        psd_model, times, 1.0, 7.0, "Lognormal", extension_factor=1.05,
        aliasing_factor=1, random_state=7,
    )
    psd_b = np.tile(np.asarray(simu._psd_values())[None], (5, 1))
    whole = np.asarray(simu.simulate_batch(jax.random.key(0), psd_b, chunk=8))
    parts = np.asarray(simu.simulate_batch(jax.random.key(0), psd_b, chunk=2))
    assert whole.shape == (5, len(times))
    assert np.all(np.isfinite(whole)) and np.all(whole > 0)
    np.testing.assert_allclose(parts, whole, rtol=1e-12)


def test_simulate_batch_nonconvergence_diagnostic():
    """The batched E13 path must surface
    sims that hit max_iter (the reference warns per lightcurve,
    simulator.py:126-127) instead of clamping silently."""
    times = np.arange(0, 600, 1.0)
    psd_model = psd_models.BendingPowerlaw(S0=5.0, omega0=np.exp(-3))
    simu = Simulator(
        psd_model, times, 1.0, 7.0, "Lognormal", extension_factor=1.05,
        aliasing_factor=1, random_state=11, max_iter=1,
    )
    psd_b = np.tile(np.asarray(simu._psd_values())[None], (4, 1))
    with pytest.warns(UserWarning, match="4 simulated lightcurve\\(s\\) did not converge"):
        simu.simulate_batch(jax.random.key(1), psd_b)
    # the counter resets after each report
    assert simu.report_nonconverged(warn=False) == 0

    # warn_nonconverged=False defers: the count accumulates device-side
    # and is surfaced by an explicit report (the LRT's end-of-bootstrap
    # fetch)
    simu.simulate_batch(jax.random.key(2), psd_b, warn_nonconverged=False)
    simu.simulate_batch(jax.random.key(3), psd_b, warn_nonconverged=False)
    with pytest.warns(UserWarning, match="8 simulated lightcurve"):
        assert simu.report_nonconverged() == 8

    # the single-lightcurve API keeps the reference's per-lc warning
    with pytest.warns(UserWarning, match="did not converge after 1 iterations"):
        simu.generate_lightcurve()
