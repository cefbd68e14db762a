"""Statistics library: distributions, periodogram likelihoods, information
criteria, and the Kraft+1991 Poisson-with-background posterior.

Rebuild of reference mind_the_gaps/stats.py:10-195 with two tiers:
- host tier (numpy/scipy): scipy-compatible distribution factories used at
  API level (create_log_normal, create_uniform_distribution, kraft_pdf);
- device tier (JAX): batched samplers and the Kraft posterior
  median/HPD-interval solved with regularized incomplete gamma functions +
  fixed-iteration bisection, so thousands of noise draws vectorize on device
  (the reference computes these in a per-bin Python loop,
  noise_models.py:140-146).
"""
from __future__ import annotations


import numpy as np
from scipy import special, stats
from scipy.optimize import minimize
from scipy.stats import lognorm, uniform

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaincc, gammaln

__all__ = [
    "kraft_pdf",
    "lognormal",
    "chi_cov",
    "chi_log_likehood",
    "chi_log_likehood_nonyq",
    "chi_square",
    "chi_square_N",
    "create_log_normal",
    "create_uniform_distribution",
    "fit_N",
    "bic",
    "aic",
    "aicc",
    "sample_pdf",
    "kraft_posterior_median",
    "kraft_hpd_interval",
]


# ---------------------------------------------------------------------- #
# host tier: scipy-compatible distributions (reference stats.py:10-29)
# ---------------------------------------------------------------------- #
class kraft_pdf(stats.rv_continuous):
    """Kraft, Burrows & Nousek (1991) posterior for a source with N total
    observed counts and known background B:
    f(x) = C e^{-(x+B)} (x+B)^N / N!, x >= 0."""

    def _argcheck(self, N, B):
        return (N >= 0) and (B >= 0)

    def _pdf(self, x, N, B):
        n = np.arange(N + 1)
        C = (np.sum(np.exp(-B) * B**n / special.factorial(n))) ** -1
        return C * np.exp(-x - B) * (x + B) ** N / special.factorial(N)


class lognormal(stats.rv_continuous):
    """Log-normal parameterized by (center, sigma) of log-flux."""

    def _argcheck(self, center, sigma):
        return sigma >= 0

    def _pdf(self, x, center, sigma):
        return (
            1.0
            / (sigma * x * np.sqrt(2 * np.pi))
            * np.exp(-((np.log(x) - center) ** 2) / (2 * sigma**2))
        )


def create_log_normal(mean, std):
    """Moment-matched scipy lognorm with the given mean and std
    (reference stats.py:116-130)."""
    var = std**2
    mu = np.log((mean**2) / np.sqrt(var + mean**2))
    sigma = np.sqrt(np.log(var / (mean**2) + 1))
    return lognorm(sigma, scale=np.exp(mu))


def create_uniform_distribution(mean, std):
    """Moment-matched scipy uniform with the given mean and std
    (reference stats.py:132-147)."""
    var = std**2
    b = np.sqrt(3 * var) + mean
    a = 2 * mean - b
    return uniform(loc=a, scale=b - a)


# ---------------------------------------------------------------------- #
# device tier: batched samplers for the E13 PDF draw
# ---------------------------------------------------------------------- #
def sample_pdf(key, pdf: str, mean, std, shape):
    """Draw moment-matched samples of the given flux PDF on device.

    pdf: 'gaussian' | 'lognormal' | 'uniform', matched in mean/std to the
    host factories above.  mean/std may be traced scalars (per-simulation).
    """
    pdf = pdf.lower()
    if pdf == "gaussian":
        return mean + std * jax.random.normal(key, shape)
    if pdf == "lognormal":
        var = std**2
        mu = jnp.log(mean**2 / jnp.sqrt(var + mean**2))
        sigma = jnp.sqrt(jnp.log(var / mean**2 + 1.0))
        return jnp.exp(mu + sigma * jax.random.normal(key, shape))
    if pdf == "uniform":
        b = jnp.sqrt(3.0) * std + mean
        a = 2.0 * mean - b
        return a + (b - a) * jax.random.uniform(key, shape)
    raise ValueError("pdf must be one of 'gaussian', 'lognormal', 'uniform'")


# ---------------------------------------------------------------------- #
# periodogram fit statistics (reference stats.py:44-113)
# ---------------------------------------------------------------------- #
def chi_cov(powers_data, model_powers=None, inv_cov=None):
    """Uttley+2002 chi^2 with full covariance."""
    d = jnp.asarray(powers_data) - jnp.asarray(model_powers)
    return d @ jnp.asarray(inv_cov) @ d


def chi_log_likehood_nonyq(powers_data, model_pows=None):
    """Whittle statistic, Vaughan+2005 Eq. A.3 / Emmanoulopoulos+2013 A11,
    excluding the Nyquist term."""
    powers_data = jnp.asarray(powers_data)
    model_pows = jnp.asarray(model_pows)
    return 2.0 * jnp.sum(jnp.log(model_pows) + powers_data / model_pows)


def chi_log_likehood(powers_data, model_pows=None, nyquist=False):
    """Whittle statistic; if ``nyquist`` the last frequency gets the
    chi^2_1 (real-valued Nyquist) contribution."""
    powers_data = jnp.asarray(powers_data)
    model_pows = jnp.asarray(model_pows)
    if nyquist:
        ll = chi_log_likehood_nonyq(powers_data[:-1], model_pows[:-1])
        return ll + jnp.log(jnp.pi * powers_data[-1] * model_pows[-1]) + 2.0 * powers_data[-1] / model_pows[-1]
    return chi_log_likehood_nonyq(powers_data, model_pows)


def chi_square(powers_data, model_powers=None, sigmas=None):
    """Uttley+2002 chi^2 with per-frequency uncertainties."""
    return jnp.sum(((jnp.asarray(model_powers) - jnp.asarray(powers_data)) / jnp.asarray(sigmas)) ** 2)


def fit_N(loglikehood, log_like_args=()):
    """Minimize a normalization for the given statistic (host-side BFGS,
    reference stats.py:31-42)."""
    res = minimize(loglikehood, 1, args=log_like_args, method="BFGS")
    return res.x


def chi_square_N(powers_data, model_power=None, std_power=None):
    """Chi-square at the best-fit normalization.

    WARNING: reproduces the reference's broken call signature verbatim
    (reference stats.py:108-113): ``chi_square`` takes
    (powers_data, model_powers, sigmas), so passing the fitted
    normalization N as the first positional argument — as both the
    reference and this parity port do — mismatches the argument order.
    Kept bug-for-bug for parity; do not use in new code."""
    N = fit_N(chi_square, (powers_data, model_power, std_power))
    return chi_square(N, powers_data, model_power, std_power)


# ---------------------------------------------------------------------- #
# information criteria (reference stats.py:155-195)
# ---------------------------------------------------------------------- #
def bic(loglikehood, n, k):
    """Bayesian Information Criterion."""
    return -2.0 * loglikehood + k * np.log(n)


def aic(loglikehood, k):
    """Akaike Information Criterion."""
    return 2 * k - 2 * loglikehood


def aicc(loglikehood, n, k):
    """AIC corrected for finite sample size."""
    return aic(loglikehood, k) + 2 * k * (k + 1) / (n - k - 1)


# ---------------------------------------------------------------------- #
# device tier: Kraft+91 posterior quantities, batched
# ---------------------------------------------------------------------- #
# The posterior CDF has a closed form in regularized upper incomplete
# gamma functions Q(s, x) = Gamma(s, x)/Gamma(s):
#   CDF(x | N, B) = 1 - Q(N+1, x+B) / Q(N+1, B)
# (the normalization sum_{n<=N} e^{-B} B^n/n! equals Q(N+1, B)).


def _kraft_cdf(x, N, B):
    qB = gammaincc(N + 1.0, B)
    return 1.0 - gammaincc(N + 1.0, x + B) / qB


def _kraft_log_pdf(x, N, B):
    qB = gammaincc(N + 1.0, B)
    # N * log(x+B) with the N = 0 convention 0*log(0) = 0 (pdf = C e^-x)
    log_term = jnp.where(N > 0, N * jnp.log(jnp.maximum(x + B, 1e-300)), 0.0)
    return -(x + B) + log_term - gammaln(N + 1.0) - jnp.log(qB)


def _bisect(f, lo, hi, iters=70):
    """Vectorized fixed-iteration bisection for f increasing in x; solves
    f(x) = 0 on [lo, hi]."""

    def body(_, state):
        lo, hi = state
        mid = 0.5 * (lo + hi)
        below = f(mid) < 0.0
        return jnp.where(below, mid, lo), jnp.where(below, hi, mid)

    lo, hi = jax.lax.fori_loop(0, iters, body, (lo, hi))
    return 0.5 * (lo + hi)


from functools import partial as _partial


@_partial(jax.jit, static_argnames=("upper",))
def kraft_posterior_median(N, B, upper=200.0):
    """Median of the Kraft posterior; batched over (N, B) arrays.

    Matches ``kraft_pdf(a=0, b=35)(N, B).median()`` used by the reference's
    KraftNoise (noise_models.py:140-143) to ~1e-10.
    """
    N = jnp.asarray(N, dtype=jnp.float64)
    B = jnp.asarray(B, dtype=jnp.float64)
    lo = jnp.zeros_like(N)
    hi = jnp.full_like(N, upper)
    return _bisect(lambda x: _kraft_cdf(x, N, B) - 0.5, lo, hi)


@_partial(jax.jit, static_argnames=("cl", "upper", "level_iters"))
def kraft_hpd_interval(N, B, cl=0.68, upper=200.0, level_iters=60):
    """Highest-posterior-density (minimal-width) interval of the Kraft
    posterior at confidence ``cl`` — the 'kraft-burrows-nousek' interval
    of astropy.stats.poisson_conf_interval used at reference
    noise_models.py:144-146.  Batched over (N, B).

    Algorithm: the posterior is unimodal with mode at max(N - B, 0);
    bisect on the density level lambda, where for each level the interval
    endpoints a(levels) <= mode <= b(level) are themselves found by inner
    bisection (a = 0 when pdf(0) < lambda, the upper-limit case).
    """
    N = jnp.asarray(N, dtype=jnp.float64)
    B = jnp.asarray(B, dtype=jnp.float64)
    mode = jnp.maximum(N - B, 0.0)
    log_pmax = _kraft_log_pdf(mode, N, B)
    log_p0 = _kraft_log_pdf(jnp.zeros_like(mode), N, B)

    def interval_mass(log_lam):
        # a: on [0, mode] pdf is increasing; pdf(a) = lam (or a = 0)
        a = _bisect(
            lambda x: _kraft_log_pdf(x, N, B) - log_lam,
            jnp.zeros_like(mode),
            mode,
        )
        a = jnp.where(log_p0 >= log_lam, 0.0, a)
        # b: on [mode, upper] pdf is decreasing; pdf(b) = lam
        b = _bisect(
            lambda x: log_lam - _kraft_log_pdf(x, N, B),
            mode,
            jnp.full_like(mode, upper),
        )
        return _kraft_cdf(b, N, B) - _kraft_cdf(a, N, B), a, b

    # bisect the level: mass(lambda) decreases as lambda increases
    lo = log_pmax - 60.0  # level -> 0: mass -> 1
    hi = log_pmax

    def body(_, state):
        lo, hi = state
        mid = 0.5 * (lo + hi)
        mass, _, _ = interval_mass(mid)
        too_small = mass < cl  # level too high -> decrease
        return jnp.where(too_small, lo, mid), jnp.where(too_small, mid, hi)

    lo, hi = jax.lax.fori_loop(0, level_iters, body, (lo, hi))
    _, a, b = interval_mass(0.5 * (lo + hi))
    return a, b


def neg_log_like(params, y, gp):
    """Kept for API parity with reference stats.py:149 (marked 'remove
    eventually' there)."""
    gp.set_parameter_vector(params)
    return -gp.log_likelihood(y)
