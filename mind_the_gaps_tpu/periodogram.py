"""Lomb-Scargle periodogram on device.

The reference's workflow and notebooks (docs/workflow.md step 1,
lomb_scargle_biases.ipynb) use astropy's LombScargle / nifty-ls for the
initial frequency-domain look at the data.  Here the generalized
(floating-mean) Lomb-Scargle of Zechmeister & Kuerster (2009) is written
as dense trig matrices: all frequencies evaluate as a handful of
(F, N) x (N,) contractions (and trivially vmap over batches of
lightcurves).
"""
from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["lomb_scargle", "autofrequency", "ls_false_alarm_level"]


def autofrequency(times, samples_per_peak: int = 5, nyquist_factor: int = 5, maximum_frequency=None):
    """Heuristic frequency grid (astropy-compatible defaults)."""
    times = np.asarray(times)
    baseline = times.max() - times.min()
    n = len(times)
    df = 1.0 / baseline / samples_per_peak
    if maximum_frequency is None:
        avg_nyquist = 0.5 * n / baseline
        maximum_frequency = nyquist_factor * avg_nyquist
    nf = int(np.floor(maximum_frequency / df))
    return df * (1 + np.arange(nf))


@partial(jax.jit, static_argnames=("normalization", "fit_mean", "center_data"))
def lomb_scargle(
    times,
    y,
    frequencies,
    dy=None,
    normalization: str = "standard",
    fit_mean: bool = True,
    center_data: bool = True,
):
    """Generalized Lomb-Scargle power at the given frequencies (in 1/time
    units, NOT angular).

    normalization: 'standard' (0..1), 'model', 'log', or 'psd'.
    """
    t = jnp.asarray(times)
    y = jnp.asarray(y, dtype=t.dtype)
    f = jnp.asarray(frequencies, dtype=t.dtype)

    if dy is None:
        w = jnp.ones_like(y)
    else:
        w = 1.0 / jnp.asarray(dy, dtype=t.dtype) ** 2
    w = w / jnp.sum(w)

    if center_data or fit_mean:
        ymean = jnp.sum(w * y)
        yc = y - ymean
    else:
        yc = y

    omega = 2.0 * jnp.pi * f  # (F,)
    theta = omega[:, None] * t[None, :]  # (F, N)
    cos = jnp.cos(theta)
    sin = jnp.sin(theta)

    # weighted sums as matmuls (MXU): (F, N) @ (N,)
    wy = w * yc
    S = sin @ w
    C = cos @ w
    Sy = sin @ wy
    Cy = cos @ wy
    # double-angle sums for SS/CC/CS
    CC = (cos * cos) @ w
    CS = (cos * sin) @ w
    SS = 1.0 - CC

    if fit_mean:
        CC = CC - C * C
        SS = SS - S * S
        CS = CS - C * S
        Cy = Cy  # yc is already weighted-mean-centered
        Sy = Sy

    # tan(2 omega tau)-free solution of the 2x2 normal equations
    det = CC * SS - CS * CS
    det = jnp.where(det <= 0, jnp.finfo(t.dtype).tiny, det)
    yy = jnp.sum(w * yc * yc)
    p = (SS * Cy * Cy + CC * Sy * Sy - 2.0 * CS * Cy * Sy) / (yy * det)

    if normalization == "standard":
        power = p
    elif normalization == "model":
        power = p / (1.0 - p)
    elif normalization == "log":
        power = -jnp.log(1.0 - p)
    elif normalization == "psd":
        w_total = y.shape[0] if dy is None else jnp.sum(1.0 / jnp.asarray(dy, dtype=t.dtype) ** 2)
        power = 0.5 * p * yy * w_total
    else:
        raise ValueError(f"unknown normalization {normalization!r}")
    return power


def ls_false_alarm_level(p_fal, n_points, frequencies, times, method: str = "baluev"):
    """False-alarm power threshold (Baluev 2008 aliasing-free upper
    bound), matching astropy's 'baluev' method for the standard
    normalization."""
    times = np.asarray(times)
    fmax = np.max(np.asarray(frequencies))
    n = n_points
    # Baluev 2008: effective bandwidth W = fmax * Teff, Teff = sqrt(4 pi var(t))
    teff = np.sqrt(4 * np.pi * np.var(times))
    W = fmax * teff

    def fap(z):
        # single-frequency FAP for the standard normalization
        p_single = (1 - z) ** ((n - 3) / 2)
        tau = W * np.sqrt(z) * (1 - z) ** ((n - 4) / 2)
        return 1 - (1 - p_single) * np.exp(-tau)

    # solve fap(z) = p_fal by bisection (fap is decreasing in z)
    lo, hi = 1e-10, 1 - 1e-10
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if fap(mid) > p_fal:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)
