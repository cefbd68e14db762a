"""Integrated autocorrelation time, on device.

Same estimator emcee's ``get_autocorr_time(tol=0)`` uses (reference
convergence loop, gpmodelling.py:250-263): per-walker FFT
autocorrelation, averaged across walkers, tau = 2*cumsum(rho)-1 with
Sokal's automated windowing (c = 5).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

__all__ = [
    "integrated_autocorr_time",
    "integrated_autocorr_time_masked",
    "integrated_autocorr_time_np",
    "autocorr_function",
]


def _next_pow_two(n: int) -> int:
    i = 1
    while i < n:
        i <<= 1
    return i


def autocorr_function(x):
    """Normalized autocorrelation of a 1-D series via FFT.

    Computed in float32 (complex64 FFTs): tau estimation needs no more
    precision.
    """
    n = x.shape[0]
    m = 2 * _next_pow_two(n)
    xc = (x - jnp.mean(x)).astype(jnp.float32)
    f = jnp.fft.fft(xc, n=m)
    acf = jnp.fft.ifft(f * jnp.conj(f))[:n].real
    acf = acf.astype(x.dtype)
    return acf / acf[0]


def integrated_autocorr_time_np(chain, c: float = 5.0):
    """Host (numpy) version of integrated_autocorr_time.

    The convergence loop calls this every ``convergence_steps`` on a
    chain whose length keeps growing — on device that would recompile
    for every new length, and the arrays are tiny anyway.
    """
    import numpy as np

    chain = np.asarray(chain)
    n, w, d = chain.shape
    m = 2 * _next_pow_two(n)
    x = chain - chain.mean(axis=0, keepdims=True)
    f = np.fft.fft(x, n=m, axis=0)
    acf = np.fft.ifft(f * np.conj(f), axis=0)[:n].real
    # constant (stuck) walkers have acf[0] == 0; treat them as maximally
    # correlated (acf = 1 at all lags -> huge tau, blocks convergence)
    # instead of propagating NaN into the convergence logic
    norm = acf[:1].copy()
    dead = ~(norm > 0)  # (1, w, d)
    norm[dead] = 1.0
    acf = acf / norm
    acf = np.where(np.broadcast_to(dead, acf.shape), 1.0, acf)
    rho = acf.mean(axis=1)  # (n, d)
    taus = 2.0 * np.cumsum(rho, axis=0) - 1.0
    out = np.empty(d)
    ms = np.arange(n)
    for j in range(d):
        crossed = ms >= c * taus[:, j]
        window = int(np.argmax(crossed)) if crossed.any() else n - 1
        out[j] = taus[window, j]
    return out


@partial(jax.jit, static_argnames=("c",))
def integrated_autocorr_time_masked(chain_buf, n_valid, c: float = 5.0):
    """tau over the first ``n_valid`` steps of a fixed-size chain buffer.

    The device-side engine of the derive_posteriors convergence loop:
    the chain lives in a preallocated (max_steps, W, D) buffer, so this
    compiles ONCE per run and each convergence check is a single device
    call with a (D,)-scalar fetch — instead of re-fetching the growing
    chain and re-running the host FFT estimator every segment
    (O(segments^2) host work, the round-2 bottleneck).

    Exactly the emcee tol=0 estimator (same as
    ``integrated_autocorr_time_np`` on ``chain_buf[:n_valid]``): rows
    >= n_valid are masked out of the mean, zero-padded into the FFT
    (the 2*next_pow2(S) transform length keeps every lag < S exact),
    and excluded from the window search.
    """
    s, w, d = chain_buf.shape
    idx = jnp.arange(s)
    valid = idx < n_valid
    mask = valid[:, None, None]
    nv = n_valid.astype(chain_buf.dtype) if hasattr(n_valid, "astype") else jnp.asarray(
        n_valid, dtype=chain_buf.dtype
    )
    xmean = jnp.sum(jnp.where(mask, chain_buf, 0.0), axis=0) / nv
    x = jnp.where(mask, chain_buf - xmean[None], 0.0).astype(jnp.float32)
    m = 2 * _next_pow_two(s)
    f = jnp.fft.fft(x, n=m, axis=0)
    # the whole tau pipeline stays float32: the estimate drives a
    # convergence heuristic and needs no more precision
    acf = jnp.fft.ifft(f * jnp.conj(f), axis=0)[:s].real
    norm = acf[:1]
    dead = ~(norm > 0)  # constant (stuck) walkers: treat as fully correlated
    acf = jnp.where(dead, 1.0, acf / jnp.where(dead, 1.0, norm))
    rho = jnp.mean(acf, axis=1)  # (s, d)
    taus = 2.0 * jnp.cumsum(rho, axis=0) - 1.0

    def pick(tj):  # tj: (s,)
        crossed = (idx >= c * tj) & valid
        window = jnp.where(jnp.any(crossed), jnp.argmax(crossed), n_valid - 1)
        return tj[window]

    return jax.vmap(pick, in_axes=1)(taus).astype(chain_buf.dtype)


@partial(jax.jit, static_argnames=("c",))
def integrated_autocorr_time(chain, c: float = 5.0):
    """tau for each parameter from a (n_steps, n_walkers, ndim) chain.

    Matches emcee.autocorr.integrated_time with tol=0: walker-averaged
    autocorrelation function, taus = 2*cumsum(rho)-1, window = first M
    with M >= c*tau_M (else argmax fallback).
    """
    n, w, d = chain.shape

    def per_param(x):  # x: (n, w)
        rho = jax.vmap(autocorr_function, in_axes=1, out_axes=1)(x)  # (n, w)
        # f32 cumsum: see integrated_autocorr_time_masked
        f = jnp.mean(rho, axis=1).astype(jnp.float32)
        taus = (2.0 * jnp.cumsum(f) - 1.0).astype(x.dtype)
        m = jnp.arange(n)
        crossed = m >= c * taus
        # first index where window criterion holds; argmax of bool gives it
        any_cross = jnp.any(crossed)
        window = jnp.where(any_cross, jnp.argmax(crossed), n - 1)
        return taus[window]

    return jax.vmap(per_param, in_axes=2)(chain)
