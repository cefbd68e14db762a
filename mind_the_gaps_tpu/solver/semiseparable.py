"""O(N R^2) celerite semiseparable Cholesky factorization in pure JAX.

The celerite covariance matrix

    K_nm = delta_nm (yerr_n^2 + jitter) + k(|t_n - t_m|),
    k(tau) = sum_r a_r e^{-c_r tau}
           + sum_c e^{-c_c tau} (a_c cos(d_c tau) + b_c sin(d_c tau))

is (R = Jr + 2 Jc)-semiseparable: K = diag(A) + tril(U Wt) + triu(W Ut)
with exponential inter-step decay factors P.  Its LDL^T Cholesky factor
follows a first-order recursion in n (Foreman-Mackey et al. 2017, Sec. 5;
"Scalable backpropagation for Gaussian Processes using celerite"), which we
express as ``jax.lax.scan`` over the time axis:

- work-efficient O(N R^2) per likelihood, exactly what the hardware needs
  when the batch axis (walkers x bootstrap simulations) carries the
  parallelism: each scan step is a fully-vectorized op across the
  batch, so thousands of likelihoods advance in lock-step per time step.
- reverse-mode differentiable out of the box (scan transposes to the
  O(N) adjoint recursion of the celerite backprop paper).

Numerical notes:
- float64 throughout (all ops here are elementwise/small-R
  contractions) — required for the 1e-8 parity contract with celerite
  (BASELINE.md).
- times are shifted by t[0] before building trig arguments: k depends
  only on differences, and small arguments keep cos/sin fully accurate.
- a non-positive pivot D_n (covariance not PD for these parameters) makes
  the log-likelihood -inf instead of raising, which composes with vmap and
  matches how a failed celerite factorization is treated by samplers.

Replaces: celerite's C++/Eigen solver used at reference gpmodelling.py:51-54,
152-169, 366.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = [
    "CeleriteMatrices",
    "build_matrices",
    "factor",
    "log_likelihood",
    "solve",
    "predict_mean",
    "predict",
]


class CeleriteMatrices(NamedTuple):
    """Semiseparable representation of K.

    U, V: (N, R) generator matrices; P: (N, R) decay factors between
    consecutive points (row 0 is ones); A: (N,) diagonal of K.
    """

    U: jnp.ndarray
    V: jnp.ndarray
    P: jnp.ndarray
    A: jnp.ndarray


def build_matrices(coeffs, t, diag) -> CeleriteMatrices:
    """Assemble U, V, P, A from celerite coefficients.

    Parameters
    ----------
    coeffs : kernels.Coefficients (ar, cr, ac, bc, cc, dc)
    t : (N,) sorted timestamps
    diag : (N,) per-point variance to add to the diagonal
        (yerr^2 + jitter, cf. reference gpmodelling.py:54 which calls
        gp.compute(times, dy + 1e-12) => diag = (dy + 1e-12)^2).
    """
    ar, cr, ac, bc, cc, dc = coeffs
    dtype = ar.dtype
    t = jnp.asarray(t)
    tc = (t - t[0]).astype(dtype)  # shift-invariant; keeps trig args small
    dt = jnp.diff(t, prepend=t[:1]).astype(dtype)  # dt[0] = 0 -> P row 0 = 1

    blocks_U, blocks_V, blocks_P = [], [], []
    if ar.shape[0]:
        ones = jnp.ones_like(tc)[:, None]
        blocks_U.append(ar[None, :] * ones)
        blocks_V.append(jnp.broadcast_to(ones, (tc.shape[0], ar.shape[0])))
        blocks_P.append(jnp.exp(-cr[None, :] * dt[:, None]))
    if ac.shape[0]:
        arg = dc[None, :] * tc[:, None]
        cos, sin = jnp.cos(arg), jnp.sin(arg)
        U1 = ac[None, :] * cos + bc[None, :] * sin
        U2 = ac[None, :] * sin - bc[None, :] * cos
        Pc = jnp.exp(-cc[None, :] * dt[:, None])
        # interleave the (cos, sin) column pairs per complex term
        N, Jc = cos.shape
        blocks_U.append(jnp.stack([U1, U2], axis=-1).reshape(N, 2 * Jc))
        blocks_V.append(jnp.stack([cos, sin], axis=-1).reshape(N, 2 * Jc))
        blocks_P.append(jnp.stack([Pc, Pc], axis=-1).reshape(N, 2 * Jc))

    U = jnp.concatenate(blocks_U, axis=1)
    V = jnp.concatenate(blocks_V, axis=1)
    P = jnp.concatenate(blocks_P, axis=1)
    A = jnp.asarray(diag, dtype=dtype) + jnp.sum(ar) + jnp.sum(ac)
    A = jnp.broadcast_to(A, tc.shape) if A.ndim == 0 else A
    return CeleriteMatrices(U, V, P, A)


def factor(m: CeleriteMatrices):
    """LDL^T factorization: returns (D, W, ok).

    D: (N,) pivots; W: (N, R) such that L = I + tril_strict(U W^T with P
    decay); ok: scalar bool, True iff all pivots are positive.
    """
    U, V, P, A = m
    R = U.shape[1]

    D0 = A[0]
    W0 = V[0] / D0
    S0 = jnp.zeros((R, R), dtype=U.dtype)

    def step(carry, inp):
        S, D_prev, W_prev = carry
        Un, Vn, Pn, An = inp
        S = (Pn[:, None] * Pn[None, :]) * (S + D_prev * jnp.outer(W_prev, W_prev))
        SU = S @ Un
        D = An - Un @ SU
        W = (Vn - SU) / D
        return (S, D, W), (D, W)

    (_, _, _), (D_rest, W_rest) = jax.lax.scan(
        step, (S0, D0, W0), (U[1:], V[1:], P[1:], A[1:])
    )
    D = jnp.concatenate([D0[None], D_rest])
    W = jnp.concatenate([W0[None], W_rest])
    ok = jnp.all(D > 0.0)
    return D, W, ok


def log_likelihood(coeffs, t, y, diag, mean=0.0):
    """Gaussian log-likelihood with a single fused scan.

    Fuses the factorization with the forward substitution L z = r so only
    scalars + R-vectors are carried — minimal HBM traffic for large
    (walkers x sims) batches.  Returns -inf when K is not positive
    definite for these coefficients.
    """
    m = build_matrices(coeffs, t, diag)
    U, V, P, A = m
    r = (jnp.asarray(y) - mean).astype(U.dtype)
    R = U.shape[1]

    D0 = A[0]
    W0 = V[0] / D0
    z0 = r[0]
    init = (
        jnp.zeros((R, R), dtype=U.dtype),  # S
        D0,
        W0,
        jnp.zeros((R,), dtype=U.dtype),  # f (forward substitution state)
        z0,
        jnp.log(jnp.abs(D0)),  # sum log D
        z0 * z0 / D0,  # quadratic form
        D0 > 0.0,  # positive-definite flag
    )

    def step(carry, inp):
        S, D_prev, W_prev, f_prev, z_prev, logdet, quad, ok = carry
        Un, Vn, Pn, An, rn = inp
        S = (Pn[:, None] * Pn[None, :]) * (S + D_prev * jnp.outer(W_prev, W_prev))
        SU = S @ Un
        D = An - Un @ SU
        W = (Vn - SU) / D
        f = Pn * (f_prev + W_prev * z_prev)
        z = rn - Un @ f
        logdet = logdet + jnp.log(jnp.abs(D))
        quad = quad + z * z / D
        ok = ok & (D > 0.0)
        return (S, D, W, f, z, logdet, quad, ok), None

    (_, _, _, _, _, logdet, quad, ok), _ = jax.lax.scan(
        step, init, (U[1:], V[1:], P[1:], A[1:], r[1:])
    )
    n = r.shape[0]
    ll = -0.5 * (quad + logdet + n * math.log(2.0 * math.pi))
    return jnp.where(ok, ll, -jnp.inf)


def solve(m: CeleriteMatrices, D, W, b):
    """Solve K x = b given the factorization (D, W): forward then backward
    substitution, each an O(N R) scan."""
    U, V, P, A = m
    R = U.shape[1]

    # forward: L z = b
    def fwd(carry, inp):
        f_prev, z_prev, W_prev = carry
        Un, Pn, Wn, bn = inp
        f = Pn * (f_prev + W_prev * z_prev)
        z = bn - Un @ f
        return (f, z, Wn), z

    z0 = b[0]
    (_, _, _), z_rest = jax.lax.scan(
        fwd,
        (jnp.zeros((R,), dtype=U.dtype), z0, W[0]),
        (U[1:], P[1:], W[1:], b[1:]),
    )
    z = jnp.concatenate([z0[None], z_rest])
    zd = z / D

    # backward: L^T x = z / D
    def bwd(carry, inp):
        g_prev, x_prev, U_prev = carry
        Wn, Pn1, Un, zdn = inp
        g = Pn1 * (g_prev + U_prev * x_prev)
        x = zdn - Wn @ g
        return (g, x, Un), x

    xN = zd[-1]
    (_, _, _), x_rest = jax.lax.scan(
        bwd,
        (jnp.zeros((R,), dtype=U.dtype), xN, U[-1]),
        (W[:-1][::-1], P[1:][::-1], U[:-1][::-1], zd[:-1][::-1]),
    )
    return jnp.concatenate([xN[None], x_rest])[::-1]


def predict_mean(coeffs, t, y, diag, jitter=0.0, mean=0.0):
    """GP predictive mean at the training points.

    With K = K_s + diag(s) (s = yerr^2 + jitter; K_s the noiseless kernel
    matrix): mu = mean + K_s K^{-1} r = y - s * (K^{-1} r).  O(N R^2).
    """
    m = build_matrices(coeffs, t, diag)
    D, W, _ = factor(m)
    r = jnp.asarray(y) - mean
    alpha = solve(m, D, W, r)
    s = jnp.asarray(diag)
    return jnp.asarray(y) - s * alpha


def inverse_diag(m: CeleriteMatrices, D, W):
    """diag(K^{-1}) in O(N R^2) via a backward selected-inverse scan.

    With L = I + strict-lower semiseparable (generators U, W, diagonal
    decay P), the columns of L^{-1} follow the linear recursion
    f_{k+1} = M_{k+1} f_k with M_k = P_k (I - w_{k-1} u_{k-1}^T), so

      diag(K^{-1})_n = 1/D_n + (P_{n+1} w_n)^T H_{n+1} (P_{n+1} w_n),
      H_k = u_k u_k^T / D_k + M_{k+1}^T H_{k+1} M_{k+1}

    accumulated by one backward scan (the semiseparable analogue of the
    Takahashi selected-inverse equations).
    """
    U, V, P, A = m
    R = U.shape[1]
    N = U.shape[0]

    lam_last = jnp.outer(U[-1], U[-1]) / D[-1]

    def bwd(H, inp):
        # step for n (from N-2 down to 0): carry H = H_{n+1}
        Un, Wn, Pn1, Dn = inp
        HP = (Pn1[:, None] * Pn1[None, :]) * H  # P_{n+1}^T H P_{n+1} (P diagonal)
        g = Wn @ HP @ Wn  # w_n^T HP w_n
        IW = jnp.eye(R, dtype=U.dtype) - jnp.outer(Un, Wn)  # (I - u w^T)^T = I - w u^T transposed below
        # H_n = Lambda_n + (I - u_n w_n^T) HP (I - w_n u_n^T)
        Hn = jnp.outer(Un, Un) / Dn + IW @ HP @ IW.T
        return Hn, g

    inputs = (U[:-1][::-1], W[:-1][::-1], P[1:][::-1], D[:-1][::-1])
    _, gs = jax.lax.scan(bwd, lam_last, inputs)
    g = jnp.concatenate([gs[::-1], jnp.zeros((1,), dtype=U.dtype)])
    return 1.0 / D + g


def _test_point_generators(coeffs, t0, s):
    """Generator rows U(s), V(s) and the per-channel decay rate vector at
    an arbitrary time s (same absolute-phase convention and column order
    as build_matrices)."""
    ar, cr, ac, bc, cc, dc = coeffs
    sc = s - t0
    parts_u, parts_v, parts_c = [], [], []
    if ar.shape[0]:
        parts_u.append(ar)
        parts_v.append(jnp.ones_like(ar))
        parts_c.append(cr)
    if ac.shape[0]:
        arg = dc * sc
        cos, sin = jnp.cos(arg), jnp.sin(arg)
        u1 = ac * cos + bc * sin
        u2 = ac * sin - bc * cos
        parts_u.append(jnp.stack([u1, u2], axis=-1).reshape(2 * ac.shape[0]))
        parts_v.append(jnp.stack([cos, sin], axis=-1).reshape(2 * ac.shape[0]))
        parts_c.append(jnp.stack([cc, cc], axis=-1).reshape(2 * ac.shape[0]))
    u = jnp.concatenate(parts_u) if len(parts_u) > 1 else parts_u[0]
    v = jnp.concatenate(parts_v) if len(parts_v) > 1 else parts_v[0]
    cvec = jnp.concatenate(parts_c) if len(parts_c) > 1 else parts_c[0]
    return u, v, cvec


def _predict_tables(m: CeleriteMatrices, D, W, alpha):
    """Per-gap R x R quadratic-form tables for O(R^2)-per-point GP
    prediction (the selected-inverse generalization of ``inverse_diag``).

    With the Cholesky K = L D L^T and a test point s in gap p
    (t_p <= s < t_{p+1}), the cross-covariance splits as
    ks = G^(p) a + H^(p) c with R-vectors a = phi_s * U(s) (decay from
    t_p) and c = psi_s * V(s) (decay to t_{p+1}), G rows n<=p carrying
    decayed V_n and H rows n>p carrying decayed U_n.  Then

        ks^T K^-1 ks = a^T A_p a + 2 a^T B_p c + c^T C_p c
        ks^T K^-1 r  = a^T g_p + c^T h_p

    where all tables depend on p only.  Forward scan (states Phi/Ahat:
    the substitution L^-1 G of the self-anchored V rows, re-anchored by
    the gap decay each step) gives A_p = Ahat_p + Psi_{p+1}^T H_{p+1}
    Psi_{p+1}; the backward scan propagates the ``inverse_diag`` H matrix
    together with C (the L^-1 H quadratic form) and the coupling J, which
    also yields B_p = -Psi_{p+1}^T J_p^T.  O(N R^3) total, O(R^2) per
    query — replaces the M independent O(N R^2) solves.

    Returns (A, B, C, g, h): arrays indexed by p = 0..N, shapes
    (N+1, R, R) x3 and (N+1, R) x2.
    """
    U, V, P, A_ = m
    N, R = U.shape
    dtype = U.dtype
    eye = jnp.eye(R, dtype=dtype)
    # P_{n+1} aligned with row n (ones past the last row)
    P1 = jnp.concatenate([P[1:], jnp.ones((1, R), dtype=dtype)])

    # ---- forward: Ahat_p, Psi_{p+1}, g_p for p = 1..N ----------------- #
    def fwd(carry, inp):
        Phi, Ahat, g = carry
        Un, Vn, Wn, Pn, Pn1, Dn, an = inp
        zeta = Vn - Phi.T @ Un
        Ahat = (Pn[:, None] * Pn[None, :]) * Ahat + jnp.outer(zeta, zeta) / Dn
        g = Pn * g + Vn * an
        Psi = Pn1[:, None] * (Phi + jnp.outer(Wn, zeta))
        Phi_next = Psi * Pn1[None, :]
        return (Phi_next, Ahat, g), (Ahat, Psi, g)

    init = (jnp.zeros((R, R), dtype), jnp.zeros((R, R), dtype), jnp.zeros((R,), dtype))
    _, (Ahat, Psi, g_all) = jax.lax.scan(fwd, init, (U, V, W, P, P1, D, alpha))

    # ---- backward: H_{k+1}, C_{k-1}, J_{k-1}, h_{k-1} for k = N..1 ---- #
    def bwd(carry, inp):
        Hn, C, J, h = carry  # Hn = H_{k+1}, C = C_k, J = J_k, h = h_k
        Un, Wn, Pn1, Dn, an = inp
        Lam = jnp.outer(Un, Un) / Dn
        M = Pn1[:, None] * (eye - jnp.outer(Wn, Un))
        Th = Pn1[:, None] * jnp.outer(Wn, Un)
        cross = -(Pn1[:, None] * (J @ Th))
        C_prev = Lam + (Pn1[:, None] * Pn1[None, :]) * C + cross + cross.T + Th.T @ Hn @ Th
        J_prev = Lam + Pn1[:, None] * (J @ M) - Th.T @ Hn @ M
        H_k = Lam + M.T @ Hn @ M
        h_prev = Un * an + Pn1 * h
        return (H_k, C_prev, J_prev, h_prev), (Hn, C_prev, J_prev, h_prev)

    zero_m = jnp.zeros((R, R), dtype)
    initb = (zero_m, zero_m, zero_m, jnp.zeros((R,), dtype))
    inputs_rev = (U[::-1], W[::-1], P1[::-1], D[::-1], alpha[::-1])
    _, (Hn1_r, C_r, J_r, h_r) = jax.lax.scan(bwd, initb, inputs_rev)
    Hn1 = Hn1_r[::-1]  # Hn1[k-1] = H_{k+1}, aligned with row k (1-based)
    C_low = C_r[::-1]  # C_low[k-1] = C_{k-1}
    J_low = J_r[::-1]  # J_low[k-1] = J_{k-1}
    h_low = h_r[::-1]  # h_low[k-1] = h_{k-1}

    # assemble per-gap tables indexed by p = 0..N
    A_tail = jnp.einsum("nij,njk,nkl->nil", jnp.swapaxes(Psi, 1, 2), Hn1, Psi)
    A_full = Ahat + A_tail  # index n-1 <-> p = n
    J_full = jnp.concatenate([J_low[1:], zero_m[None]])  # J_p for p = 1..N
    B_full = -jnp.einsum("nij,nkj->nik", jnp.swapaxes(Psi, 1, 2), J_full)

    A = jnp.concatenate([zero_m[None], A_full])
    B = jnp.concatenate([zero_m[None], B_full])
    C = jnp.concatenate([C_low, zero_m[None]])
    g = jnp.concatenate([jnp.zeros((1, R), dtype), g_all])
    h = jnp.concatenate([h_low, jnp.zeros((1, R), dtype)])
    return A, B, C, g, h


def predict_at(coeffs, t, y, diag, t_pred, mean=0.0, return_var: bool = True):
    """GP predictive mean (and variance) at arbitrary test points —
    the celerite ``gp.predict(y, t_pred)`` used for plotting model curves
    in the reference's notebooks (reference gpmodelling.py:366).

    Both mean and variance run through the per-gap quadratic-form tables
    of ``_predict_tables``: O((N + M) R^2) total instead of one O(N R^2)
    solve per test point."""
    t = jnp.asarray(t)
    t_pred = jnp.asarray(t_pred)
    m = build_matrices(coeffs, t, diag)
    D, W, _ = factor(m)
    r = jnp.asarray(y) - mean
    alpha = solve(m, D, W, r)
    dtype = m.U.dtype

    A, B, C, g, h = _predict_tables(m, D, W, alpha)

    ar, cr, ac, bc, cc, dc = coeffs
    k0 = jnp.sum(ar) + jnp.sum(ac) if (ar.shape[0] or ac.shape[0]) else jnp.zeros((), dtype)
    N = t.shape[0]
    t0 = t[0]

    def one(s):
        p = jnp.searchsorted(t, s, side="right")  # 0..N
        u_s, v_s, cvec = _test_point_generators(coeffs, t0, s)
        gap_lo = jnp.where(p >= 1, s - t[jnp.clip(p - 1, 0, N - 1)], 0.0)
        gap_hi = jnp.where(p <= N - 1, t[jnp.clip(p, 0, N - 1)] - s, 0.0)
        a = jnp.exp(-cvec * gap_lo.astype(dtype)) * u_s
        c = jnp.exp(-cvec * gap_hi.astype(dtype)) * v_s
        mu = a @ g[p] + c @ h[p]
        if not return_var:
            return mu
        q = a @ (A[p] @ a) + 2.0 * a @ (B[p] @ c) + c @ (C[p] @ c)
        return mu, k0 - q

    out = jax.vmap(one)(t_pred)
    if not return_var:
        return out + mean
    mu, var = out
    return mu + mean, var


def predict(coeffs, t, y, diag, mean=0.0):
    """Predictive mean and variance at the training points, all O(N R^2).

    var_n = s_n - s_n^2 (K^{-1})_{nn}  with s_n the per-point noise
    variance (diag argument) — the identity behind celerite's
    predict(return_var=True) at the training points (used by the
    reference's standarized_residuals, gpmodelling.py:353-370).
    """
    m = build_matrices(coeffs, t, diag)
    D, W, _ = factor(m)
    r = jnp.asarray(y) - mean
    alpha = solve(m, D, W, r)
    s = jnp.asarray(diag)
    mu = jnp.asarray(y) - s * alpha
    Kinv_diag = inverse_diag(m, D, W)
    var = s - s**2 * Kinv_diag
    return mu, var
