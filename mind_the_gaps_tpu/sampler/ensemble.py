"""Affine-invariant ensemble sampler (Goodman & Weare 2010 stretch move),
fully vectorized.

emcee-compatible algorithm (the reference pins emcee==3.1.4 and drives it
at gpmodelling.py:247-248): complementary-half ("red-black") updates with
the stretch proposal

    z ~ g(z) prop. 1/sqrt(z) on [1/a, a]   (a = 2)
    Y = X_j + z (X_k - X_j),  accept with prob min(1, z^(d-1) e^(dlogp))

but expressed as a ``lax.scan`` over steps whose body evaluates the
log-probability of *half the ensemble at once* (vmap), so each MCMC
step is one batched likelihood kernel.  vmap over an outer batch
axis runs thousands of independent ensembles (one per bootstrap
lightcurve) in lock-step — the design replacing the reference's process
pool.
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp

__all__ = ["sample_ensemble", "run_ensemble"]


def _stretch_half(key, active, passive, logp_active, log_prob_fn, a):
    """One stretch-move update of ``active`` against ``passive``.

    active: (W, D), passive: (Wp, D), logp_active: (W,)
    """
    w = active.shape[0]
    d = active.shape[1]
    k_z, k_pick, k_acc = jax.random.split(key, 3)
    u = jax.random.uniform(k_z, (w,), dtype=active.dtype)
    z = ((a - 1.0) * u + 1.0) ** 2 / a
    picks = jax.random.randint(k_pick, (w,), 0, passive.shape[0])
    partners = passive[picks]
    proposal = partners + z[:, None] * (active - partners)
    logp_new = log_prob_fn(proposal)
    log_accept = (d - 1.0) * jnp.log(z) + logp_new - logp_active
    accept = jnp.log(jax.random.uniform(k_acc, (w,), dtype=active.dtype)) < log_accept
    new_active = jnp.where(accept[:, None], proposal, active)
    new_logp = jnp.where(accept, logp_new, logp_active)
    return new_active, new_logp, accept


def sample_ensemble_impl(
    key,
    log_prob_fn: Callable,
    initial_state,
    n_steps: int,
    a: float = 2.0,
):
    """Run the ensemble for ``n_steps``.

    Parameters
    ----------
    log_prob_fn : (W, D) -> (W,), mapped over walkers (already vmapped or
        naturally batched).
    initial_state : (W, D) walker positions, W even.

    Returns
    -------
    chain : (n_steps, W, D)
    log_probs : (n_steps, W)
    accept_frac : scalar acceptance fraction
    final_state : (W, D)
    """
    initial_state = jnp.asarray(initial_state)
    w = initial_state.shape[0]
    half = w // 2
    if 2 * half != w:
        raise ValueError("number of walkers must be even")

    logp0 = log_prob_fn(initial_state)

    def step(carry, key):
        state, logp = carry
        k1, k2 = jax.random.split(key)
        first, second = state[:half], state[half:]
        lp1, lp2 = logp[:half], logp[half:]
        first, lp1, acc1 = _stretch_half(k1, first, second, lp1, log_prob_fn, a)
        second, lp2, acc2 = _stretch_half(k2, second, first, lp2, log_prob_fn, a)
        state = jnp.concatenate([first, second])
        logp = jnp.concatenate([lp1, lp2])
        n_acc = jnp.sum(acc1) + jnp.sum(acc2)
        return (state, logp), (state, logp, n_acc)

    keys = jax.random.split(key, n_steps)
    (final, _), (chain, log_probs, n_accs) = jax.lax.scan(step, (initial_state, logp0), keys)
    accept_frac = jnp.sum(n_accs) / (n_steps * w)
    return chain, log_probs, accept_frac, final


sample_ensemble = partial(jax.jit, static_argnames=("log_prob_fn", "n_steps", "a"))(
    sample_ensemble_impl
)


def sample_ensemble_grouped(key, log_prob_fn, initial_state, n_steps, a=2.0):
    """``C`` INDEPENDENT stretch-move ensembles advancing in lock-step.

    initial_state: (C, W, D).  Each ensemble proposes only within its own
    complementary halves (identical statistics to ``C`` separate
    sample_ensemble runs), but every half-update evaluates ONE
    (C*W/2, D) batched log-probability — the likelihood kernel's time
    per step is set by the serial recursion, not the lane count, so the
    extra chains cost little wall-clock.

    log_prob_fn: (B, D) -> (B,) for any B (the instance log-prob
    batchers pad internally).

    Returns (chain (n_steps, C, W, D), log_probs (n_steps, C, W),
    accept_frac scalar, final_state (C, W, D)).
    """
    initial_state = jnp.asarray(initial_state)
    c, w, d = initial_state.shape
    half = w // 2
    if 2 * half != w:
        raise ValueError("number of walkers must be even")

    def lp(x):  # (C, half, D) -> (C, half)
        return log_prob_fn(x.reshape(c * half, d)).reshape(c, half)

    def half_update(key, active, passive, logp_active):
        # active/passive: (C, half, D); logp_active: (C, half)
        k_z, k_pick, k_acc = jax.random.split(key, 3)
        u = jax.random.uniform(k_z, (c, half), dtype=initial_state.dtype)
        z = ((a - 1.0) * u + 1.0) ** 2 / a
        picks = jax.random.randint(k_pick, (c, half), 0, half)
        partners = jnp.take_along_axis(passive, picks[..., None], axis=1)
        proposal = partners + z[..., None] * (active - partners)
        logp_new = lp(proposal)
        log_accept = (d - 1.0) * jnp.log(z) + logp_new - logp_active
        accept = jnp.log(jax.random.uniform(k_acc, (c, half), dtype=initial_state.dtype)) < log_accept
        new_active = jnp.where(accept[..., None], proposal, active)
        new_logp = jnp.where(accept, logp_new, logp_active)
        return new_active, new_logp, accept

    logp0 = jnp.concatenate(
        [lp(initial_state[:, :half]), lp(initial_state[:, half:])], axis=1
    )

    def step(carry, key):
        state, logp = carry
        k1, k2 = jax.random.split(key)
        first, second = state[:, :half], state[:, half:]
        lp1, lp2 = logp[:, :half], logp[:, half:]
        first, lp1, acc1 = half_update(k1, first, second, lp1)
        second, lp2, acc2 = half_update(k2, second, first, lp2)
        state = jnp.concatenate([first, second], axis=1)
        logp = jnp.concatenate([lp1, lp2], axis=1)
        n_acc = jnp.sum(acc1) + jnp.sum(acc2)
        return (state, logp), (state, logp, n_acc)

    keys = jax.random.split(key, n_steps)
    (final, _), (chain, log_probs, n_accs) = jax.lax.scan(step, (initial_state, logp0), keys)
    accept_frac = jnp.sum(n_accs) / (n_steps * c * w)
    return chain, log_probs, accept_frac, final


def run_ensemble(key, log_prob_fn, initial_state, n_steps, a=2.0):
    """Convenience alias of sample_ensemble (API stability)."""
    return sample_ensemble(key, log_prob_fn, initial_state, n_steps, a=a)


def max_loglike_ensemble_impl(key, log_prob_fn, initial_state, n_steps, a=2.0):
    """Stretch-move run that records only the running maximum log-prob
    (and the position attaining it) — O(W D) memory instead of
    O(n_steps W D).  This is the inner engine of the batched LRT
    bootstrap, where only max-likelihoods matter (SURVEY.md §3.4 step 5:
    the T statistic uses the best log-likelihood of each short chain)."""
    initial_state = jnp.asarray(initial_state)
    w = initial_state.shape[0]
    half = w // 2

    logp0 = log_prob_fn(initial_state)

    def step(carry, key):
        state, logp, best_lp, best_x = carry
        k1, k2 = jax.random.split(key)
        first, second = state[:half], state[half:]
        lp1, lp2 = logp[:half], logp[half:]
        first, lp1, _ = _stretch_half(k1, first, second, lp1, log_prob_fn, a)
        second, lp2, _ = _stretch_half(k2, second, first, lp2, log_prob_fn, a)
        state = jnp.concatenate([first, second])
        logp = jnp.concatenate([lp1, lp2])
        i = jnp.argmax(logp)
        better = logp[i] > best_lp
        best_lp = jnp.where(better, logp[i], best_lp)
        best_x = jnp.where(better, state[i], best_x)
        return (state, logp, best_lp, best_x), None

    i0 = jnp.argmax(logp0)
    init = (initial_state, logp0, logp0[i0], initial_state[i0])
    keys = jax.random.split(key, n_steps)
    (state, logp, best_lp, best_x), _ = jax.lax.scan(step, init, keys)
    return best_lp, best_x, state, logp
