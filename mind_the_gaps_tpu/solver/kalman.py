"""Parallel-in-time celerite likelihood via an associative Kalman scan.

The celerite GP is equivalent to a stationary linear-Gaussian state-space
model (one 1-D OU block per real term, one 2-D rotation-decay block per
complex pair):

    x_k = Phi_k x_{k-1} + q_k,   q_k ~ N(0, Q_k = V - Phi_k V Phi_k^T)
    y_k = H x_k + eps_k,         eps_k ~ N(0, diag_k)

with Phi_k = exp(-c dt) Rot(d dt) per block, stationary V = a for real
terms and [[a, -b], [-b, a]] for complex pairs, H picking the first
component of each block (then Cov(y_n, y_m) = H Phi_{n<-m} V H^T =
k(t_n - t_m) exactly).

The batched scan solver (solver/batched.py) is work-optimal when the
batch carries the parallelism; this module instead parallelizes over the
*time* axis: the Kalman filter is expressed with the associative
five-tuple elements of Sarkka & Garcia-Fernandez (2021, "Temporal
Parallelization of Bayesian Smoothers"), so one lightcurve's likelihood
evaluates in O(log N) depth via ``jax.lax.associative_scan`` — the right
tool for low-latency single fits and gradient evaluations.

Both a sequential reference filter and the parallel version are
provided; both match the semiseparable solver at f64 parity levels.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

__all__ = [
    "state_space_matrices",
    "kalman_log_likelihood",
    "parallel_kalman_log_likelihood",
]


def state_space_matrices(coeffs, t):
    """Build per-step transition matrices Phi (N, p, p), the stationary
    covariance V (p, p) and the observation row H (p,)."""
    ar, cr, ac, bc, cc, dc = coeffs
    t = jnp.asarray(t)
    dt = jnp.diff(t, prepend=t[:1])  # dt[0] = 0 -> Phi_0 = I-ish (unused)
    N = t.shape[0]
    Jr, Jc = ar.shape[0], ac.shape[0]
    p = Jr + 2 * Jc
    dtype = ar.dtype

    Phi = jnp.zeros((N, p, p), dtype=dtype)
    V = jnp.zeros((p, p), dtype=dtype)
    H = jnp.zeros((p,), dtype=dtype)

    for j in range(Jr):
        phi = jnp.exp(-cr[j] * dt)
        Phi = Phi.at[:, j, j].set(phi)
        V = V.at[j, j].set(ar[j])
        H = H.at[j].set(1.0)
    for j in range(Jc):
        i0 = Jr + 2 * j
        e = jnp.exp(-cc[j] * dt)
        cth = jnp.cos(dc[j] * dt)
        sth = jnp.sin(dc[j] * dt)
        Phi = Phi.at[:, i0, i0].set(e * cth)
        Phi = Phi.at[:, i0, i0 + 1].set(-e * sth)
        Phi = Phi.at[:, i0 + 1, i0].set(e * sth)
        Phi = Phi.at[:, i0 + 1, i0 + 1].set(e * cth)
        V = V.at[i0, i0].set(ac[j])
        V = V.at[i0, i0 + 1].set(-bc[j])
        V = V.at[i0 + 1, i0].set(-bc[j])
        V = V.at[i0 + 1, i0 + 1].set(ac[j])
        H = H.at[i0].set(1.0)
    return Phi, V, H


def _loglike_terms(v, s):
    return -0.5 * (jnp.log(2.0 * jnp.pi * s) + v * v / s)


def kalman_log_likelihood(coeffs, t, y, diag, mean=0.0):
    """Sequential Kalman filter log-likelihood (reference for the
    parallel version; same O(N) cost class as the celerite scan)."""
    Phi, V, H = state_space_matrices(coeffs, t)
    r = jnp.asarray(y) - mean
    Rn = jnp.broadcast_to(jnp.asarray(diag), r.shape)
    Q = V[None] - Phi @ V @ jnp.swapaxes(Phi, 1, 2)

    def step(carry, inp):
        m, P = carry
        Phi_k, Q_k, y_k, R_k = inp
        m_pred = Phi_k @ m
        P_pred = Phi_k @ P @ Phi_k.T + Q_k
        v = y_k - H @ m_pred
        s = H @ P_pred @ H + R_k
        K = (P_pred @ H) / s
        m_new = m_pred + K * v
        P_new = P_pred - jnp.outer(K, K) * s
        return (m_new, P_new), _loglike_terms(v, s)

    p = H.shape[0]
    m0 = jnp.zeros((p,), dtype=Phi.dtype)
    # first step: predictive = stationary prior
    v0 = r[0]
    s0 = H @ V @ H + Rn[0]
    K0 = (V @ H) / s0
    m1 = K0 * v0
    P1 = V - jnp.outer(K0, K0) * s0
    (_, _), terms = jax.lax.scan(step, (m1, P1), (Phi[1:], Q[1:], r[1:], Rn[1:]))
    return _loglike_terms(v0, s0) + jnp.sum(terms)


def _filter_elements(Phi, Q, H, r, Rn, V):
    """Initialize the associative elements (A, b, C, eta, J) of
    Sarkka & Garcia-Fernandez (2021), Lemma 8."""
    N, p, _ = Phi.shape
    # generic elements for k >= 1 (0-based: indices 1..N-1)
    S = jnp.einsum("i,nij,j->n", H, Q, H) + Rn  # (N,)
    QH = Q @ H  # (N, p)
    K = QH / S[:, None]
    I = jnp.eye(p, dtype=Phi.dtype)
    ImKH = I[None] - K[:, :, None] * H[None, None, :]
    A = ImKH @ Phi
    b = K * r[:, None]
    C = ImKH @ Q
    PhiTH = jnp.einsum("nji,j->ni", Phi, H)  # Phi^T H
    eta = PhiTH * (r / S)[:, None]
    J = PhiTH[:, :, None] * PhiTH[:, None, :] / S[:, None, None]

    # first element: full update from the stationary prior
    s0 = H @ V @ H + Rn[0]
    K0 = (V @ H) / s0
    A0 = jnp.zeros((p, p), dtype=Phi.dtype)
    b0 = K0 * r[0]
    C0 = V - jnp.outer(K0, K0) * s0
    eta0 = jnp.zeros((p,), dtype=Phi.dtype)
    J0 = jnp.zeros((p, p), dtype=Phi.dtype)

    A = A.at[0].set(A0)
    b = b.at[0].set(b0)
    C = C.at[0].set(C0)
    eta = eta.at[0].set(eta0)
    J = J.at[0].set(J0)
    return A, b, C, eta, J


def _small_inv(M):
    """Batched inverse of small (p <= 6) matrices in closed form.

    ``jnp.linalg.inv`` lowers to a batched LU with poor occupancy at
    these sizes; the celerite state dimension is tiny (p = Jr + 2 Jc,
    typically 2-6), where the adjugate is exact and maps to a handful of
    batched matmuls.  p = 1, 2
    use the direct formulas; 3 <= p <= 6 uses the Faddeev-LeVerrier
    recursion (adjugate and determinant in p matrix products — fine
    numerically at these sizes, including float32); larger p falls back
    to linalg.inv.
    """
    p = M.shape[-1]
    if p == 1:
        return 1.0 / M
    if p == 2:
        a = M[..., 0, 0]
        b = M[..., 0, 1]
        c = M[..., 1, 0]
        d = M[..., 1, 1]
        det = a * d - b * c
        row0 = jnp.stack([d, -b], axis=-1)
        row1 = jnp.stack([-c, a], axis=-1)
        return jnp.stack([row0, row1], axis=-2) / det[..., None, None]
    if p > 6:
        return jnp.linalg.inv(M)
    I = jnp.broadcast_to(jnp.eye(p, dtype=M.dtype), M.shape)
    # N_1 = I, c_1 = tr M;  N_k = M N_{k-1} - c_{k-1} I,
    # c_k = tr(M N_k)/k;  then M^{-1} = N_p / c_p (det = +/- c_p).
    Nk = I
    ck = jnp.trace(M, axis1=-2, axis2=-1)
    for k in range(2, p + 1):
        Nk = M @ Nk - ck[..., None, None] * I
        ck = jnp.einsum("...ij,...ji->...", M, Nk) / k
    return Nk / ck[..., None, None]


def _combine(elem_i, elem_j):
    """Associative composition (i earlier, j later), vectorized over the
    leading scan axis."""
    Ai, bi, Ci, etai, Ji = elem_i
    Aj, bj, Cj, etaj, Jj = elem_j
    p = Ai.shape[-1]
    I = jnp.eye(p, dtype=Ai.dtype)
    M = I[None] + Ci @ Jj  # (..., p, p)
    Minv = _small_inv(M)
    AjM = Aj @ Minv
    A = AjM @ Ai
    b = (AjM @ (bi + jnp.einsum("...ij,...j->...i", Ci, etaj))[..., None])[..., 0] + bj
    C = AjM @ Ci @ jnp.swapaxes(Aj, -1, -2) + Cj
    # (I + Jj Ci)^{-1} = Minv^T for symmetric Ci, Jj
    NinvT = jnp.swapaxes(Minv, -1, -2)
    AiT = jnp.swapaxes(Ai, -1, -2)
    eta = (
        jnp.einsum("...ij,...j->...i", AiT @ NinvT, etaj - jnp.einsum("...ij,...j->...i", Jj, bi))
        + etai
    )
    J = AiT @ NinvT @ Jj @ Ai + Ji
    return A, b, C, eta, J


@partial(jax.jit)
def parallel_kalman_log_likelihood(coeffs, t, y, diag, mean=0.0):
    """Log-likelihood with O(log N) depth: associative scan of the
    filtering elements, then all per-step innovation terms in parallel."""
    Phi, V, H = state_space_matrices(coeffs, t)
    r = jnp.asarray(y) - mean
    Rn = jnp.broadcast_to(jnp.asarray(diag), r.shape)
    Q = V[None] - Phi @ V @ jnp.swapaxes(Phi, 1, 2)

    elems = _filter_elements(Phi, Q, H, r, Rn, V)
    A, b, C, eta, J = jax.lax.associative_scan(_combine, elems)
    # filtered means/covs: m_k|k = b_k, P_k|k = C_k (prior m0 = 0)
    m_f = b
    P_f = C

    # innovation terms: k = 0 from the stationary prior, k >= 1 from the
    # previous filtered state
    m_pred = jnp.einsum("nij,nj->ni", Phi[1:], m_f[:-1])
    P_pred = Phi[1:] @ P_f[:-1] @ jnp.swapaxes(Phi[1:], 1, 2) + Q[1:]
    v = r[1:] - m_pred @ H
    s = jnp.einsum("i,nij,j->n", H, P_pred, H) + Rn[1:]
    ll = jnp.sum(_loglike_terms(v, s))
    s0 = H @ V @ H + Rn[0]
    ll = ll + _loglike_terms(r[0], s0)
    ok = jnp.all(s > 0.0) & (s0 > 0.0)
    return jnp.where(ok, ll, -jnp.inf)
