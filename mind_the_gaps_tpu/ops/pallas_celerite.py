"""Pallas-Triton GPU kernel for the batched celerite log-likelihood.

XLA runs ``solver/batched.py``'s ``lax.scan`` over the N time steps as a
device loop: at least one kernel launch per step, and no fusion across
steps.  The recursion is serial in time but independent across the
batch, so this kernel gives every batch lane (one likelihood) its own
thread and runs the whole N-step loop inside ONE launch:

- grid over blocks of ``block`` lanes (a power of two, as Triton
  requires); each block runs ``lax.fori_loop(1, N, ...)``;
- the recursion state rides the loop carry (registers): the packed
  symmetric S (R(R+1)/2 rows), W and f (R rows each), D, z, the
  Kahan-compensated log-determinant and quadratic-form accumulators and
  the running minimum pivot — about 25 values per lane at R=3, ~60 at
  R=8; no shared memory;
- ``t`` is shared; each lane gathers its own data column by group index
  from the time-major (N, G) series (``y[n, lane // repeats]``), so
  neighbouring lanes read neighbouring addresses;
- the next step's data is loaded one iteration ahead (carried), so the
  gather latency overlaps the current step's arithmetic.

Same math as solver/batched.py: local-phase rotation propagators
P_n = exp(-c dt_n) Rot(d dt_n), the packed update S <- P (S + D w w^T)
P^T, and Kahan sums.  float32 and float64 both lower (the card computes
f64 natively); the f64 kernel matches the XLA scan to ~1e-12.

``interpret`` runs the kernel through the Pallas interpreter on any
backend — the tests' route; production callers never pass it.  Off a
GPU a non-interpreted call fails at lowering.
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

__all__ = ["pallas_log_likelihood", "launch_config"]

# Tests flip this (monkeypatch) to drive the production call sites
# through the Pallas interpreter on the CPU; nothing else sets it.
_INTERPRET = False


def launch_config(batch: int):
    """(block, num_warps) for a ``batch``-lane call.

    Each lane is one serial N-step chain, so a warp's time per step is
    set by the recursion's dependent-latency chain, not by throughput:
    one lane per thread, one warp per block, and blocks spread over the
    SMs.  Small batches (a 32-walker observed fit half-updates 16 lanes)
    take a single block of the next power of two."""
    block = min(32, max(1, 1 << (max(batch, 1) - 1).bit_length()))
    return block, 1


def _make_kernel(Jr: int, Jc: int, N: int, mode: str, repeats: int, B: int, dtype, block: int):
    """Kernel body for one static term structure and data layout.

    ``mode``: "shared" (y/diag (N,)), "grouped" (time-major (N, G),
    lane b reads column b // repeats) or "element" (time-major (N, B))."""
    R = Jr + 2 * Jc
    pidx = {}
    for i in range(R):
        for j in range(i, R):
            pidx[(i, j)] = len(pidx)
    nS = len(pidx)

    def sidx(i, j):
        return pidx[(i, j)] if i <= j else pidx[(j, i)]

    # static row structure: ("r", term) real rows, ("c", pair, 0/1) complex
    row_kind = [("r", i) for i in range(Jr)] + [("c", k, p) for k in range(Jc) for p in (0, 1)]
    n_coef = 2 * Jr + 4 * Jc
    log2pi = math.log(2.0 * math.pi)

    def kernel(dt_ref, y_ref, d_ref, *refs):
        coef_refs = refs[:n_coef]
        mean_ref, jit_ref, out_ref = refs[n_coef:]
        ar = [coef_refs[i][...] for i in range(Jr)]
        cr = [coef_refs[Jr + i][...] for i in range(Jr)]
        o = 2 * Jr
        ac = [coef_refs[o + k][...] for k in range(Jc)]
        bc = [coef_refs[o + Jc + k][...] for k in range(Jc)]
        cc = [coef_refs[o + 2 * Jc + k][...] for k in range(Jc)]
        dc = [coef_refs[o + 3 * Jc + k][...] for k in range(Jc)]
        mean = mean_ref[...]

        if mode == "shared":
            col = None
        else:
            lane = pl.program_id(0) * block + jnp.arange(block, dtype=jnp.int32)
            lane = jnp.minimum(lane, B - 1)  # padded lanes re-read the last column
            col = lane // repeats if mode == "grouped" else lane

        def data(n):
            """(dt_n, r_n, diag_n) for step n; r/diag are (block,) rows."""
            if col is None:
                y_n = jnp.broadcast_to(y_ref[n], (block,))
                d_n = jnp.broadcast_to(d_ref[n], (block,))
            else:
                y_n = y_ref[n, col]
                d_n = d_ref[n, col]
            return dt_ref[n], y_n - mean, d_n

        k0 = jit_ref[...]
        for a in ar + ac:
            k0 = k0 + a
        u = ar + [x for k in range(Jc) for x in (ac[k], bc[k])]
        one = jnp.ones((block,), dtype)
        zero = jnp.zeros((block,), dtype)
        v = [one] * Jr + [x for _ in range(Jc) for x in (one, zero)]

        _, r0, d0 = data(0)
        A0 = d0 + k0
        inv0 = 1.0 / A0
        st0 = (
            (zero,) * nS
            + tuple(vi * inv0 for vi in v)  # W
            + (zero,) * R  # f
            + (A0, r0, jnp.log(jnp.abs(A0)), zero, r0 * r0 * inv0, zero, A0)
        )
        nxt0 = data(jnp.int32(1)) if N > 1 else data(0)

        def step(n, carry):
            st, (dt_n, rn, dn) = carry
            # prefetch step n+1 (clamped on the last step)
            nxt = data(jnp.minimum(n + 1, N - 1))
            s_prev = st[:nS]
            W = st[nS : nS + R]
            f = st[nS + R : nS + 2 * R]
            D_prev, z_prev, logdet, lc_, quad, qc_, dmin = st[nS + 2 * R :]

            er = [jnp.exp(-cr[i] * dt_n) for i in range(Jr)]
            Cv, Sv = [], []
            for k in range(Jc):
                e = jnp.exp(-cc[k] * dt_n)
                arg = dc[k] * dt_n
                Cv.append(e * jnp.cos(arg))
                Sv.append(e * jnp.sin(arg))

            def rot(i, get):
                """Row i of P @ x for a column accessor get(row)."""
                kind = row_kind[i]
                if kind[0] == "r":
                    return er[kind[1]] * get(i)
                k, p = kind[1], kind[2]
                a = Jr + 2 * k
                if p == 0:
                    return Cv[k] * get(a) - Sv[k] * get(a + 1)
                return Sv[k] * get(a) + Cv[k] * get(a + 1)

            # M = S + D_prev W W^T (packed), T = P M, S' = T P^T (upper)
            m = {}
            for i in range(R):
                for j in range(i, R):
                    m[(i, j)] = s_prev[pidx[(i, j)]] + D_prev * W[i] * W[j]
            T = {}
            for i in range(R):
                for j in range(R):
                    T[(i, j)] = rot(i, lambda q, j=j: m[(q, j)] if q <= j else m[(j, q)])
            s_new = [None] * nS
            for i in range(R):
                for j in range(i, R):
                    s_new[pidx[(i, j)]] = rot(j, lambda q, i=i: T[(i, q)])

            Su = []
            for i in range(R):
                acc = s_new[sidx(i, 0)] * u[0]
                for j in range(1, R):
                    acc = acc + s_new[sidx(i, j)] * u[j]
                Su.append(acc)
            uSu = Su[0] * u[0]
            for i in range(1, R):
                uSu = uSu + Su[i] * u[i]
            D = dn + k0 - uSu
            Dinv = 1.0 / D
            W_new = [(v[i] - Su[i]) * Dinv for i in range(R)]

            g = [f[i] + W[i] * z_prev for i in range(R)]
            f_new = [rot(i, lambda q: g[q]) for i in range(R)]
            uf = u[0] * f_new[0]
            for i in range(1, R):
                uf = uf + u[i] * f_new[i]
            z = rn - uf

            x1 = jnp.log(jnp.abs(D)) - lc_
            t1 = logdet + x1
            x2 = z * z * Dinv - qc_
            t2 = quad + x2
            st = (
                tuple(s_new) + tuple(W_new) + tuple(f_new)
                + (D, z, t1, (t1 - logdet) - x1, t2, (t2 - quad) - x2, jnp.minimum(dmin, D))
            )
            return st, nxt

        st, _ = jax.lax.fori_loop(jnp.int32(1), jnp.int32(N), step, (st0, nxt0))
        logdet, quad, dmin = st[nS + 2 * R + 2], st[nS + 2 * R + 4], st[-1]
        ll = -0.5 * (quad + logdet + N * log2pi)
        # D <= 0 (or NaN) anywhere: K is not positive definite
        out_ref[...] = jnp.where(dmin > 0.0, ll, -jnp.inf)

    return kernel


def pallas_log_likelihood(
    coeffs, t, y, diag, mean=None, repeats: int = 1, extra_diag=None,
    mesh=None, interpret=None,
):
    """Batched log N(y | mean, K(theta_b)) through the GPU kernel.

    Same contract as ``solver.batched.batched_log_likelihood``:
    coeffs with leading batch dim B (their dtype selects the precision);
    y/diag shared (N,), per-group (G, N) with B = G*repeats, or
    per-element (B, N); optional per-element ``mean`` and
    ``extra_diag`` (B,).  Returns (B,) log-likelihoods, -inf where
    K(theta_b) is not positive definite.

    ``mesh``: split the batch over a device mesh with ``shard_map`` —
    a ``pallas_call`` is opaque to XLA's SPMD partitioner, which would
    otherwise gather a batch-sharded input and run the whole batch on
    every device.  Grouped data needs G divisible by the mesh size;
    shared and per-element batches are edge-padded to a multiple.
    """
    if interpret is None:
        interpret = _INTERPRET
    run = partial(_pallas_ll, repeats=repeats, interpret=bool(interpret))
    B = coeffs[0].shape[0]
    dtype = coeffs[0].dtype
    mean = jnp.zeros((B,), dtype) if mean is None else jnp.broadcast_to(jnp.asarray(mean, dtype), (B,))
    extra_diag = (
        jnp.zeros((B,), dtype) if extra_diag is None
        else jnp.broadcast_to(jnp.asarray(extra_diag, dtype), (B,))
    )
    if mesh is None or mesh.size == 1:
        return run(coeffs, t, y, diag, mean, extra_diag)

    from jax.sharding import PartitionSpec as P

    ax = tuple(mesh.axis_names)
    n = mesh.size
    y = jnp.asarray(y)
    diag = jnp.asarray(diag)
    rows = [a.shape[0] for a in (y, diag) if a.ndim == 2]
    grouped = bool(rows) and rows[0] != B
    if grouped:
        G = rows[0]
        if G % n:
            raise ValueError(f"grouped data: {G} groups do not split over {n} devices")
        pad = 0
    else:
        pad = (-B) % n

    def edge(x):
        x = jnp.asarray(x)
        return jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1), mode="edge") if pad else x

    coeffs = jax.tree.map(edge, tuple(coeffs))
    mean, extra_diag = edge(mean), edge(extra_diag)
    if not grouped:
        y = edge(y) if y.ndim == 2 else y
        diag = edge(diag) if diag.ndim == 2 else diag
    batch = P(ax)
    out = jax.shard_map(
        run,
        mesh=mesh,
        in_specs=(
            jax.tree.map(lambda _: batch, coeffs), P(),
            batch if y.ndim == 2 else P(), batch if diag.ndim == 2 else P(),
            batch, batch,
        ),
        out_specs=batch,
        check_vma=False,
    )(coeffs, t, y, diag, mean, extra_diag)
    return out[:B]


@partial(jax.jit, static_argnames=("repeats", "interpret"))
def _pallas_ll(coeffs, t, y, diag, mean, extra_diag, *, repeats, interpret):
    ar, cr, ac, bc, cc, dc = coeffs
    B = ar.shape[0]
    dtype = ar.dtype
    Jr, Jc = ar.shape[1], ac.shape[1]
    y = jnp.asarray(y, dtype=dtype)
    diag = jnp.asarray(diag, dtype=dtype)
    if y.ndim == 1 and diag.ndim == 1:
        mode = "shared"
    else:
        if y.ndim == 1:
            y = jnp.broadcast_to(y, diag.shape)
        if diag.ndim == 1:
            diag = jnp.broadcast_to(diag, y.shape)
        G = y.shape[0]
        if G == B:
            mode, repeats = "element", 1
        elif G * repeats == B:
            mode = "grouped"
        else:
            raise ValueError("y batch dim must be B or B // repeats")
    # time-major data: lane b reads column b // repeats of row n, so a
    # warp's gather touches neighbouring addresses
    if mode != "shared":
        y, diag = y.T, diag.T
    t = jnp.asarray(t, dtype=jnp.result_type(t, jnp.float32))
    N = t.shape[0]
    dt = jnp.diff(t, prepend=t[:1]).astype(dtype)  # small gaps: safe to cast

    block, num_warps = launch_config(B)
    n_blocks = -(-B // block)
    b_pad = n_blocks * block

    def lanes(x):
        """(B,) per-lane vector, edge-padded to the block multiple."""
        x = jnp.asarray(x, dtype=dtype)
        return jnp.pad(x, (0, b_pad - B), mode="edge") if b_pad != B else x

    rows = [ar[:, i] for i in range(Jr)] + [cr[:, i] for i in range(Jr)]
    for c in (ac, bc, cc, dc):
        rows += [c[:, k] for k in range(Jc)]
    lane_args = [lanes(r) for r in rows] + [lanes(mean), lanes(extra_diag)]

    whole = pl.BlockSpec(memory_space=pl.ANY)
    per_lane = pl.BlockSpec((block,), lambda i: (i,))
    kernel = _make_kernel(Jr, Jc, N, mode, repeats, B, dtype, block)
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((b_pad,), dtype),
        grid=(n_blocks,),
        in_specs=[whole, whole, whole] + [per_lane] * len(lane_args),
        out_specs=per_lane,
        compiler_params=pl_triton.CompilerParams(num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name="celerite_loglike",
    )(dt, y, diag, *lane_args)
    return out[:B]
