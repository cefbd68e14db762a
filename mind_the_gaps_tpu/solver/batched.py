"""Batch-native celerite log-likelihood (the XLA scan form).

The portable batched solver and the reference the GPU kernel
(ops/pallas_celerite.py) is tested against.  Design decisions versus the
vmapped single-element scan (semiseparable.py):

1. **Batch axis last.**  Every carry is (R, B) / (R, R, B): the batch is
   the contiguous, vectorized dimension and the tiny celerite rank R the
   outer one, so each scan step is a handful of wide elementwise ops
   instead of many tiny per-walker ones.

2. **Local-phase (rotation-propagator) form.**  The textbook celerite
   generators carry cos(d t_n)/sin(d t_n) with *absolute* times — at
   t ~ 1e4-1e8 those phases destroy float32 (and erode float64).  Here
   the complex-pair columns use constant generator rows
   u = [a, b], v = [1, 0] and fold the oscillation into the inter-step
   propagator P_n = exp(-c dt_n) Rot(d dt_n) (a 2x2 rotation-decay
   block), so every trig argument is a small inter-sample gap.  The
   LDL^T recursion is unchanged in shape with S <- P S P^T (the
   square-root-Kalman identity):

       S_n = P_n [S_{n-1} + D_{n-1} w w^T] P_n^T
       D_n = A_n - u^T S_n u,   w_n = (v - S_n u)/D_n
       f_n = P_n (f_{n-1} + w_{n-1} z_{n-1}),  z_n = r_n - u^T f_n

3. **Generators computed in-step** (a few transcendentals on (J, B)
   vectors) instead of materializing (N, R, B) arrays — at bootstrap
   scale those would be ~4 GB streamed from HBM every sweep.

4. **Kahan-compensated accumulators** for the quadratic form and
   log-determinant, so the float32 path keeps the final log-likelihood
   to ~1e-3 over 10^4-step sums (needed for mixed-precision MCMC).

Data may be shared across the batch (y: (N,)), per-group
(y: (G, N) with ``repeats`` walkers per group — the bootstrap layout),
or fully per-element (y: (B, N) with repeats=1).
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

__all__ = ["batched_log_likelihood", "batched_log_prob_fn"]


@partial(jax.jit, static_argnames=("repeats", "unroll"))
def batched_log_likelihood(
    coeffs, t, y, diag, mean=None, repeats: int = 1, unroll: int = 1, extra_diag=None
):
    """log N(y | mean, K(theta_b)) for a batch of B parameter draws.

    Parameters
    ----------
    coeffs : Coefficients with leading batch dim B on each field; their
        dtype selects the compute precision (f64 for parity, f32 for the
        fast bootstrap path).
    t : (N,) shared, sorted timestamps (always consumed as f64 for the
        gap computation, then cast).
    y : (N,) shared data, or (G, N) per-group data with B = G*repeats
        (element b uses group b // repeats), or (B, N).
    diag : same shapes as y; per-point noise variance.
    mean : optional per-element mean: (B,) scalar-per-element or (B, N).
    repeats : walkers per data group when y/diag are (G, N).
    extra_diag : optional (B,) additive diagonal (jitter), kept separate
        so per-group diag arrays need not be expanded.

    Returns (B,) log-likelihoods, -inf where K(theta_b) is not positive
    definite.
    """
    ar, cr, ac, bc, cc, dc = coeffs
    B = ar.shape[0]
    dtype = ar.dtype
    t64 = jnp.asarray(t, dtype=jnp.result_type(t, jnp.float32))
    N = t64.shape[0]
    dt = jnp.diff(t64, prepend=t64[:1]).astype(dtype)  # small gaps: safe to cast

    Jr, Jc = ar.shape[1], ac.shape[1]
    R = Jr + 2 * Jc
    arT, crT = ar.T, cr.T  # (J, B)
    acT, bcT, ccT, dcT = ac.T, bc.T, cc.T, dc.T
    k0 = jnp.sum(ar, axis=1) + jnp.sum(ac, axis=1)  # (B,)
    if extra_diag is not None:
        k0 = k0 + jnp.asarray(extra_diag, dtype=dtype)

    # constant generator rows (R, B)
    parts_u, parts_v = [], []
    if Jr:
        parts_u.append(arT)
        parts_v.append(jnp.ones_like(arT))
    if Jc:
        zeros = jnp.zeros_like(acT)
        ones = jnp.ones_like(acT)
        parts_u.append(jnp.concatenate([acT[:, None], bcT[:, None]], 1).reshape(2 * Jc, B))
        parts_v.append(jnp.concatenate([ones[:, None], zeros[:, None]], 1).reshape(2 * Jc, B))
    u = jnp.concatenate(parts_u, 0) if len(parts_u) > 1 else parts_u[0]
    v = jnp.concatenate(parts_v, 0) if len(parts_v) > 1 else parts_v[0]

    # --- per-element data rows ------------------------------------- #
    y = jnp.asarray(y, dtype=dtype)
    diag = jnp.asarray(diag, dtype=dtype)
    shared_y = y.ndim == 1
    shared_d = diag.ndim == 1
    if not shared_y and y.shape[0] * repeats != B and y.shape[0] != B:
        raise ValueError("y batch dim must be B or B // repeats")

    def expand(row):
        if row.ndim == 0:
            return jnp.broadcast_to(row, (B,))
        if row.shape[0] == B:
            return row
        return jnp.repeat(row, repeats)

    mean_is_full = mean is not None and jnp.ndim(mean) == 2

    def data_row(y_n, d_n, m_n):
        r = expand(y_n)
        if mean is not None:
            r = r - (expand(m_n) if mean_is_full else jnp.asarray(mean, dtype=dtype))
        a = expand(d_n) + k0
        return r, a

    ys_rows = y if shared_y else y.T
    d_rows = diag if shared_d else diag.T
    m_rows = (
        jnp.zeros((N,), dtype=dtype)
        if mean is None or not mean_is_full
        else jnp.asarray(mean, dtype=dtype).T
    )

    # --- propagator application ------------------------------------- #
    def prop(dt_n):
        """Per-step propagator pieces: (er (Jr,B)), (ec, cos, sin (Jc,B))."""
        er = jnp.exp(-crT * dt_n) if Jr else None
        if Jc:
            ec = jnp.exp(-ccT * dt_n)
            arg = dcT * dt_n
            return er, ec * jnp.cos(arg), ec * jnp.sin(arg)
        return er, None, None

    def apply_P_vec(x, er, ecc, ecs):
        """P @ x for x (R, B') with any trailing batch size B'."""
        bp = x.shape[-1]
        outs = []
        if Jr:
            outs.append(er * x[:Jr])
        if Jc:
            xc = x[Jr:].reshape(Jc, 2, bp)
            x1, x2 = xc[:, 0], xc[:, 1]
            y1 = ecc * x1 - ecs * x2
            y2 = ecs * x1 + ecc * x2
            outs.append(jnp.concatenate([y1[:, None], y2[:, None]], 1).reshape(2 * Jc, bp))
        return jnp.concatenate(outs, 0) if len(outs) > 1 else outs[0]

    def _widen(x, j, k):
        """(j, B) -> (j, k*B) by broadcasting along the middle axis."""
        return jnp.broadcast_to(x[:, None, :], (j, k, B)).reshape(j, k * B)

    def apply_P_mat(S, er, ecc, ecs):
        """P @ S @ P^T for S (R, R, B): rotate rows, then columns."""
        er_k = None if er is None else _widen(er, Jr, R)
        ecc_k = None if ecc is None else _widen(ecc, Jc, R)
        ecs_k = None if ecs is None else _widen(ecs, Jc, R)
        S = apply_P_vec(S.reshape(R, R * B), er_k, ecc_k, ecs_k).reshape(R, R, B)
        St = jnp.swapaxes(S, 0, 1)
        St = apply_P_vec(St.reshape(R, R * B), er_k, ecc_k, ecs_k).reshape(R, R, B)
        return jnp.swapaxes(St, 0, 1)

    # --- step 0 ------------------------------------------------------ #
    r0, A0 = data_row(ys_rows[0], d_rows[0], m_rows[0])
    D0 = A0
    W0 = v / D0
    z0 = r0
    zero = jnp.zeros_like(D0)
    init = (
        jnp.zeros((R, R, B), dtype=dtype),
        D0,
        W0,
        jnp.zeros((R, B), dtype=dtype),
        z0,
        jnp.log(jnp.abs(D0)),
        zero,  # logdet compensation
        z0 * z0 / D0,
        zero,  # quad compensation
        D0 > 0.0,
    )

    def kahan_add(s, c, x):
        yk = x - c
        tk = s + yk
        c = (tk - s) - yk
        return tk, c

    def step(carry, inp):
        S, D_prev, W_prev, f_prev, z_prev, logdet, lc_, quad, qc_, ok = carry
        dt_n, y_n, d_n, m_n = inp
        er, ecc, ecs = prop(dt_n)
        rn, An = data_row(y_n, d_n, m_n)
        S = S + D_prev * W_prev[:, None, :] * W_prev[None, :, :]
        S = apply_P_mat(S, er, ecc, ecs)
        Su = jnp.sum(S * u[None, :, :], axis=1)  # (R, B)
        D = An - jnp.sum(u * Su, axis=0)
        W = (v - Su) / D
        f = apply_P_vec(f_prev + W_prev * z_prev, er, ecc, ecs)
        z = rn - jnp.sum(u * f, axis=0)
        logdet, lc_ = kahan_add(logdet, lc_, jnp.log(jnp.abs(D)))
        quad, qc_ = kahan_add(quad, qc_, z * z / D)
        return (S, D, W, f, z, logdet, lc_, quad, qc_, ok & (D > 0.0)), None

    (_, _, _, _, _, logdet, _, quad, _, ok), _ = jax.lax.scan(
        step, init, (dt[1:], ys_rows[1:], d_rows[1:], m_rows[1:]), unroll=unroll
    )
    ll = -0.5 * (quad + logdet + N * math.log(2.0 * math.pi))
    return jnp.where(ok, ll, -jnp.inf)


def batched_log_prob_fn(kernel, t, y, diag, subtract_mean: bool = True, repeats: int = 1, dtype=None):
    """Build thetas (B, D) -> log-probs (B,): flat prior within bounds +
    batched likelihood (the sampler inner loop).

    y/diag: (N,) shared or (G, N) per-group with B = G*repeats.
    When ``subtract_mean``, each element's constant mean is the mean of
    its own data (the reference's default unfitted ConstantModel).
    ``dtype`` selects the solver precision (default: x64 default).
    """
    t = jnp.asarray(t)
    y = jnp.asarray(y, dtype=dtype)
    diag = jnp.asarray(diag, dtype=dtype)
    if subtract_mean:
        data_means = jnp.mean(y) if y.ndim == 1 else jnp.mean(y, axis=1)

    def log_prob(thetas):
        B = thetas.shape[0]
        if dtype is not None:
            thetas = thetas.astype(dtype)
        coeffs = jax.vmap(kernel.coefficients)(thetas)
        lp = jax.vmap(kernel.log_prior)(thetas)
        jitter = jax.vmap(kernel.jitter)(thetas)
        mean = None
        if subtract_mean:
            if y.ndim == 1:
                mean = jnp.broadcast_to(data_means, (B,))
            else:
                mean = jnp.repeat(data_means, repeats)
        ll = batched_log_likelihood(
            coeffs, t, y, diag,
            mean=mean,
            repeats=(repeats if (y.ndim > 1 or diag.ndim > 1) else 1),
            extra_diag=jitter,
        )
        return jnp.where(jnp.isfinite(lp), lp + ll, -jnp.inf)

    return log_prob
