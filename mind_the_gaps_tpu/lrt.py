"""The Protassov et al. (2002) posterior-predictive likelihood-ratio test,
fully batched.

The reference leaves this pipeline to notebooks
(docs/notebooks/tutorial_ppp.ipynb; call stack in SURVEY.md §3.4):

1. fit the null and alternative GP models to the observed lightcurve
   (MCMC posteriors),
2. simulate ``nsims`` synthetic lightcurves from the null posteriors,
3. re-fit BOTH models to every synthetic lightcurve and record each
   fit's maximum log-likelihood,
4. T = -2 (logL_null - logL_alt); the p-value is the tail fraction of
   the simulated T distribution at the observed T (the reference
   notebook's percentileofscore convention: a reported p of exactly 0
   means T_obs exceeded every simulated T, i.e. p < 1/nsims — the
   +1-corrected Monte Carlo estimate would be 1/(nsims+1)).

Step 3 — the reference's wall-clock killer, run one process per
lightcurve — is here one jitted program: (nsims x walkers) stretch-move
chains advance in lock-step, each step evaluating the O(N) scan
likelihood for every (simulation, walker) pair at once, sharded over the
device mesh on the simulation axis.  Only the running max log-likelihood
is kept (O(1) memory in steps).
"""
from __future__ import annotations

import os
import time
import warnings
import zlib
from dataclasses import dataclass, field
from functools import partial
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from mind_the_gaps_tpu.gpmodelling import GEN_CHUNK, GPModelling
from mind_the_gaps_tpu.lightcurves import GappyLightcurve
from mind_the_gaps_tpu.ops import gpu_kernel_available
from mind_the_gaps_tpu.parallel import default_mesh, shard_batch

__all__ = [
    "LRTResult",
    "protassov_lrt",
    "fit_lightcurves_batch",
    "loglikes_f64_at",
    "percentile_of_score",
]


def loglikes_f64_at(kernel, times, ys, dys, thetas, chunk: int = 4096):
    """Exact float64 log-posteriors of ``kernel`` at per-lightcurve
    parameters: one batched XLA scan per fixed-shape chunk.

    The T statistics of the fast bootstrap are made f64-exact this way:
    ``fit_lightcurves_batch`` explores in f32 (through the GPU kernel),
    then the (B, D) returned ``best_x`` are re-evaluated here (same
    model as the fitter: per-lightcurve constant mean = mean of its own
    data, flat prior within bounds — reference gpmodelling.py:83-87).
    Chunks are padded to one shape so a 10k-sim refinement is a handful
    of device calls reusing one executable.
    """
    ys = np.asarray(ys, dtype=np.float64)
    dys = np.asarray(dys, dtype=np.float64)
    diags = (dys + 1e-12) ** 2
    thetas = np.asarray(thetas, dtype=np.float64)
    t64 = jnp.asarray(times, dtype=jnp.float64)
    B = ys.shape[0]
    chunk = min(chunk, max(B, 1))
    out = []
    for start in range(0, B, chunk):
        yb, db, xb = ys[start : start + chunk], diags[start : start + chunk], thetas[start : start + chunk]
        nb = yb.shape[0]
        yb, db, xb = _pad_cyclic([yb, db, xb], chunk - nb)
        ll = _f64_logprob_chunk(jnp.asarray(xb), t64, jnp.asarray(yb), jnp.asarray(db), kernel=kernel)
        out.append(np.asarray(ll)[:nb])
    return np.concatenate(out) if out else np.empty((0,))


@partial(jax.jit, static_argnames=("kernel",))
def _f64_logprob_chunk(thetas, t, ys, diags, *, kernel):
    from mind_the_gaps_tpu.solver.batched import batched_log_likelihood

    coeffs = jax.vmap(kernel.coefficients)(thetas)
    lp = jax.vmap(kernel.log_prior)(thetas)
    jitter = jax.vmap(kernel.jitter)(thetas)
    means = jnp.mean(ys, axis=1)
    ll = batched_log_likelihood(coeffs, t, ys, diags, mean=means, repeats=1, extra_diag=jitter)
    return jnp.where(jnp.isfinite(lp), lp + ll, -jnp.inf)


@partial(jax.jit, static_argnames=("kernel",))
def _f64_logprob_chunk_from_dy(thetas, t, ys, dys, *, kernel):
    """Device-array variant: takes raw errors, squares on device, casts
    the f32-explored thetas to f64 — one fused program per chunk shape."""
    thetas = jnp.asarray(thetas, dtype=jnp.float64)
    ys = jnp.asarray(ys, dtype=jnp.float64)
    diags = (jnp.asarray(dys, dtype=jnp.float64) + 1e-12) ** 2
    return _f64_logprob_chunk(thetas, t, ys, diags, kernel=kernel)


_square_err = jax.jit(lambda d: (d + 1e-12) ** 2)

# generation stays capped at this batch regardless of the fit chunk: the
# PSD batch alone is ~1 GB f64 at large B.  Shared with
# generate_batch_from_posteriors so the host and device LRT paths split
# their generation keys at the same boundaries (same sims per seed).
_GEN_CAP = GEN_CHUNK


def _kernel_sig(kernel) -> str:
    """Stable description of a kernel's traced structure: term classes,
    parameter names, prior bounds (program_cache.py keying)."""
    return repr((
        [type(tm).__name__ for tm in kernel.terms],
        kernel.get_parameter_names(),
        [(None if b[0] is None else float(b[0]), None if b[1] is None else float(b[1]))
         for b in kernel.get_parameter_bounds()],
    ))


def _alt_theta0_rows(null_kernel, alt_kernel, null_rows: np.ndarray) -> np.ndarray:
    """Per-row starting points for the ALTERNATIVE kernel's refits.

    When the alternative nests the null (its leading terms are the
    null's term classes — the standard LRT construction, e.g. DRW vs
    DRW+Lorentzian), each row embeds its null starting draw in the
    shared leading dimensions and takes the extra (e.g. QPO) dimensions
    from the alternative kernel's construction-time parameters — a
    data-independent, row-symmetric start for the dimensions the null
    cannot inform.  Without nesting, every row starts at the
    alternative's construction-time vector (fully data-independent).
    """
    alt_init = np.asarray(alt_kernel.get_parameter_vector(), dtype=np.float64)
    B = null_rows.shape[0]
    null_types = [type(t) for t in null_kernel.terms]
    alt_types = [type(t) for t in alt_kernel.terms]
    d_null = null_kernel.ndim
    nests = (
        len(alt_types) >= len(null_types)
        and alt_types[: len(null_types)] == null_types
        and sum(t.ndim for t in alt_kernel.terms[: len(null_types)]) == d_null
    )
    rows = np.broadcast_to(alt_init, (B, alt_init.shape[0])).copy()
    if nests:
        rows[:, :d_null] = null_rows[:, :d_null]
    return rows


def _pad_cyclic(arrs, rem: int):
    """Cyclically pad each (nb, ...) array by ``rem`` rows (rem may
    exceed nb); numpy stays numpy, device arrays stay on device."""
    if rem <= 0:
        return list(arrs)
    nb = arrs[0].shape[0]
    pidx = np.arange(rem) % nb
    return [
        np.concatenate([a, a[pidx]])
        if isinstance(a, np.ndarray)
        else jnp.concatenate([a, a[pidx]])
        for a in arrs
    ]


def percentile_of_score(dist, score) -> float:
    """scipy.stats.percentileofscore(kind='rank') equivalent."""
    dist = np.asarray(dist)
    n = len(dist)
    left = np.count_nonzero(dist < score)
    right = np.count_nonzero(dist <= score)
    return (left + right + (1 if right > left else 0)) * 50.0 / n


@dataclass
class LRTResult:
    t_obs: float
    t_dist: np.ndarray
    p_value: float
    null_model: GPModelling
    alt_model: GPModelling
    null_sim_loglikes: np.ndarray
    alt_sim_loglikes: np.ndarray
    t_obs_posterior: float = None
    p_value_posterior: float = None
    sim_rates: np.ndarray = field(repr=False, default=None)
    sim_dy: np.ndarray = field(repr=False, default=None)


def _make_batched_max_loglike(kernel, t, n_steps: int, walkers: int, a: float = 2.0, dtype=None, backend: str = "xla", mesh=None, axis_name: str = "batch", early_stop=None, kernel_mesh=None):
    """Build the jitted grouped-batch short-MCMC max-loglikelihood program
    for one kernel over fixed timestamps.

    Per simulated lightcurve the model is GPModelling(lc, kernel) with the
    default constant (unfitted) mean = mean(y) — exactly what the
    reference's bootstrap loop constructs (tutorial_ppp.ipynb; SURVEY.md
    §3.4 step 5).

    Layout: all (G simulations x W walkers) stretch-move chains advance
    in lock-step; every half-ensemble update evaluates one
    (G*W/2)-element batched likelihood — through the GPU kernel
    (``backend="pallas"``, ops/pallas_celerite.py) or the XLA scan
    (solver/batched.py).

    ``mesh``: run the whole program per shard under ``shard_map``.
    ``kernel_mesh``: the GSPMD form — the program is partitioned by XLA
    from its sharded inputs, and only the (opaque) kernel call is split
    over this mesh by ``shard_map``.

    ``early_stop``: optional ``(tol, patience)``.  When set, the step
    loop is a device-side ``while_loop`` that stops once NO lightcurve
    in the batch has improved its running best log-likelihood by more
    than ``tol`` for ``patience`` consecutive steps (lock-step over the
    batch; under shard_map each device stops independently).  Per-step
    RNG keys are ``fold_in(k_run, step)`` on both paths, so a run with
    ``patience >= n_steps`` is bit-identical to the fixed-budget scan.
    On the production scenario (512 sims x 16 walkers, N=5k) the DRW
    null's best loglike stops improving by >0.01 after step ~76
    worst-case — a (0.01, 50) rule stops at step ~126 with worst
    best-loglike error 0.008, far below the f32 noise floor (~0.1,
    test_mixed_precision) — while the DRW+QPO alternative keeps
    improving and runs its full budget.
    """
    from mind_the_gaps_tpu.solver.batched import batched_log_prob_fn

    nk = kernel.ndim
    t = jnp.asarray(t)
    lo = jnp.asarray([b[0] for b in kernel.get_parameter_bounds()])
    hi = jnp.asarray([b[1] for b in kernel.get_parameter_bounds()])
    half = walkers // 2
    if 2 * half != walkers:
        raise ValueError("walkers must be even")

    def batched_core(key, ys, diags, theta0, percent):
        G = ys.shape[0]
        if backend == "pallas":
            from mind_the_gaps_tpu.ops import pallas_log_likelihood

            ys_c = jnp.asarray(ys, dtype=dtype) if dtype is not None else jnp.asarray(ys)
            diags_c = jnp.asarray(diags, dtype=dtype) if dtype is not None else jnp.asarray(diags)
            data_means = jnp.mean(ys_c, axis=1)
            mean_b = jnp.repeat(data_means, half)

            def log_prob_half(thetas):  # (G*half, D) -> (G*half,)
                if dtype is not None:
                    thetas = thetas.astype(dtype)
                coeffs = jax.vmap(kernel.coefficients)(thetas)
                lp = jax.vmap(kernel.log_prior)(thetas)
                jitter = jax.vmap(kernel.jitter)(thetas)
                ll = pallas_log_likelihood(
                    coeffs, t, ys_c, diags_c, mean=mean_b, repeats=half,
                    extra_diag=jitter, mesh=kernel_mesh,
                )
                return jnp.where(jnp.isfinite(lp), lp + ll, -jnp.inf)
        else:
            log_prob_half = batched_log_prob_fn(kernel, t, ys, diags, repeats=half, dtype=dtype)

        def lp_eval(thetas_gwd):  # (G, half, D) -> (G, half)
            return log_prob_half(thetas_gwd.reshape(G * half, nk)).reshape(G, half)

        k_init, k_run = jax.random.split(key)
        if dtype is not None:
            theta0_ = theta0.astype(dtype)
        else:
            theta0_ = theta0
        # theta0 may be (D,) — one starting point for every lightcurve —
        # or (G, D) with a PER-ROW starting point.  Per-row starts are
        # the calibration-critical form: protassov_lrt starts each sim's
        # refit at its own generating posterior draw and the observed
        # row at an independent posterior draw, so no row's chain starts
        # closer to its own optimum than any other's (a shared
        # observed-MAP start privileged the observed row and made the
        # matched-estimator p-values anti-conservative in a lognormal
        # calibration run).
        base = theta0_[:, None, :] if theta0_.ndim == 2 else theta0_
        std = jnp.abs(base) * percent
        init = base + std * jax.random.normal(k_init, (G, walkers, nk), dtype=theta0_.dtype)
        # clip into bounds (the reference resamples/clamps; a clip to the
        # 5%-inset bound has the same effect for chain initialization)
        span_lo = jnp.where(jnp.isfinite(lo), lo + 0.05 * jnp.abs(lo), -jnp.inf)
        span_hi = jnp.where(jnp.isfinite(hi), hi - 0.05 * jnp.abs(hi), jnp.inf)
        init = jnp.clip(init, span_lo.astype(init.dtype), span_hi.astype(init.dtype))

        def half_update(key, active, passive, logp_active):
            # active/passive: (G, half, D); logp_active: (G, half)
            k_z, k_pick, k_acc = jax.random.split(key, 3)
            u = jax.random.uniform(k_z, (G, half), dtype=init.dtype)
            z = ((a - 1.0) * u + 1.0) ** 2 / a
            picks = jax.random.randint(k_pick, (G, half), 0, half)
            partners = jnp.take_along_axis(passive, picks[..., None], axis=1)
            proposal = partners + z[..., None] * (active - partners)
            logp_new = lp_eval(proposal)
            log_accept = (nk - 1.0) * jnp.log(z) + logp_new - logp_active
            accept = jnp.log(jax.random.uniform(k_acc, (G, half), dtype=init.dtype)) < log_accept
            new_active = jnp.where(accept[..., None], proposal, active)
            new_logp = jnp.where(accept, logp_new, logp_active)
            return new_active, new_logp

        logp0 = jnp.concatenate(
            [lp_eval(init[:, :half]), lp_eval(init[:, half:])], axis=1
        )

        def advance(state, logp, best_lp, best_x, step_i):
            key = jax.random.fold_in(k_run, step_i)
            k1, k2 = jax.random.split(key)
            first, second = state[:, :half], state[:, half:]
            lp1, lp2 = logp[:, :half], logp[:, half:]
            first, lp1 = half_update(k1, first, second, lp1)
            second, lp2 = half_update(k2, second, first, lp2)
            state = jnp.concatenate([first, second], axis=1)
            logp = jnp.concatenate([lp1, lp2], axis=1)
            i = jnp.argmax(logp, axis=1)  # (G,)
            cand_lp = jnp.take_along_axis(logp, i[:, None], axis=1)[:, 0]
            cand_x = jnp.take_along_axis(state, i[:, None, None], axis=1)[:, 0]
            better = cand_lp > best_lp
            new_best_lp = jnp.where(better, cand_lp, best_lp)
            new_best_x = jnp.where(better[:, None], cand_x, best_x)
            return state, logp, new_best_lp, new_best_x, cand_lp

        i0 = jnp.argmax(logp0, axis=1)
        best_lp0 = jnp.take_along_axis(logp0, i0[:, None], axis=1)[:, 0]
        best_x0 = jnp.take_along_axis(init, i0[:, None, None], axis=1)[:, 0]
        carry0 = (init, logp0, best_lp0, best_x0)

        if early_stop is None:
            def step(carry, step_i):
                state, logp, best_lp, best_x = carry
                state, logp, best_lp, best_x, _ = advance(
                    state, logp, best_lp, best_x, step_i
                )
                return (state, logp, best_lp, best_x), None

            (state, logp, best_lp, best_x), _ = jax.lax.scan(
                step, carry0, jnp.arange(n_steps, dtype=jnp.int32)
            )
            return best_lp, best_x

        tol, patience = early_stop
        tol = jnp.asarray(tol, dtype=init.dtype)

        def cond(carry):
            _, _, _, _, last_imp, step_i = carry
            return jnp.logical_and(
                step_i < n_steps, step_i - last_imp < patience
            )

        def body(carry):
            state, logp, best_lp, best_x, last_imp, step_i = carry
            state, logp, new_best_lp, best_x, cand_lp = advance(
                state, logp, best_lp, best_x, step_i
            )
            improved = jnp.any(cand_lp > best_lp + tol)
            last_imp = jnp.where(improved, step_i, last_imp)
            return state, logp, new_best_lp, best_x, last_imp, step_i + 1

        zero = jnp.int32(0)
        _, _, best_lp, best_x, _, _ = jax.lax.while_loop(
            cond, body, carry0 + (zero - 1, zero)
        )
        return best_lp, best_x

    if mesh is None:
        return jax.jit(batched_core)

    # Explicit SPMD expression: shard_map over the simulation axis.  Each
    # device runs batched_core on ITS shard of the (G, N) data with a
    # per-shard RNG stream (fold_in of the mesh position), and no
    # collectives at all — the multi-host-safe form of the bootstrap
    # (each process feeds its local shard of a global array).  The body
    # is collective-free, so the varying-manual-axes check is disabled:
    # the solver initializes scan carries from (batch-constant) zeros,
    # which the VMA tracker would otherwise reject as unvarying-in /
    # varying-out.
    from jax.sharding import PartitionSpec as P

    def sharded(key, ys, diags, theta0, percent):
        def local(key, ys_l, diags_l, theta0, percent):
            key = jax.random.fold_in(key, jax.lax.axis_index(axis_name))
            return batched_core(key, ys_l, diags_l, theta0, percent)

        # per-row (G, D) starting points shard with the batch; a shared
        # (D,) vector is replicated
        th_spec = P(axis_name) if jnp.ndim(theta0) == 2 else P()
        return jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(), P(axis_name), P(axis_name), th_spec, P()),
            out_specs=(P(axis_name), P(axis_name)),
            check_vma=False,
        )(key, ys, diags, theta0, percent)

    return jax.jit(sharded)


class _ChunkFitter:
    """Reusable short-MCMC chunk fitter for one kernel over fixed times.

    Owns the jitted grouped-batch runner and the chunk padding rules, so
    both the host-array API (``fit_lightcurves_batch``) and the
    device-resident LRT pipeline (``protassov_lrt``) drive identical
    programs.  Inputs to ``fit_chunk`` may be numpy arrays or device
    arrays — device arrays are padded with jnp ops and never round-trip
    the host.

    ``backend``: "pallas" (the GPU kernel), "xla" (the scan), or "auto"
    — the kernel wherever ``ops.gpu_kernel_available()`` says it runs.
    A kernel failure is an error, never a silent switch to the scan.

    ``precompile_async`` starts the chunk program's AOT compile on a
    worker thread, so the null and alternative fitters' compiles overlap
    each other and the observed fits instead of serializing.
    """

    def __init__(
        self, kernel, times, theta0, walkers=12, n_steps=500, percent=0.1,
        chunk=512, dtype=None, backend="auto", spmd="gspmd", use_mesh=True,
        early_stop=None, per_row_start=False,
    ):
        self.chunk = chunk
        self.percent = percent
        self.n_points = int(np.shape(times)[0])
        self.theta0 = jnp.asarray(theta0, dtype=jnp.float64)
        # per_row_start: fit_chunk takes a (nb, D) per-row starting-point
        # array (padded alongside the data) instead of one shared vector
        # — the calibration-critical form (see _make_batched_max_loglike)
        self.per_row_start = bool(per_row_start)
        self.ndim = int(np.shape(theta0)[-1])
        if backend not in ("auto", "pallas", "xla"):
            raise ValueError(f"unknown backend {backend!r}")
        use_pallas = backend == "pallas" or (backend == "auto" and gpu_kernel_available())
        self.use_pallas = use_pallas
        self.n_dev = len(jax.devices())
        self.mesh = default_mesh() if (use_mesh and self.n_dev > 1) else None
        sm_mesh = self.mesh if (spmd == "shard_map" and self.mesh is not None) else None
        self.runner = _make_batched_max_loglike(
            kernel, times, n_steps, walkers, dtype=dtype,
            backend="pallas" if use_pallas else "xla", mesh=sm_mesh,
            early_stop=early_stop,
            kernel_mesh=self.mesh if (use_pallas and sm_mesh is None) else None,
        )
        self._execs = {}
        self._pending = None
        # on-disk exported-program key (program_cache.py): everything the
        # runner closes over — times (a trace constant), kernel structure
        # and bounds, and the static chain config.  theta0/percent/data
        # are runtime arguments.
        import hashlib

        h = hashlib.sha256(np.asarray(times, dtype=np.float64).tobytes())
        h.update(_kernel_sig(kernel).encode())
        self._prog_sig = (
            f"chunk_fitter|{h.hexdigest()}|w={walkers}|s={n_steps}|"
            f"es={early_stop}|dt={None if dtype is None else jnp.dtype(dtype).name}"
            f"|perrow={self.per_row_start}"
        )

    def _theta0_for(self, rows: int, th_rows=None):
        """The runner's theta0 argument for a ``rows``-row padded chunk."""
        if not self.per_row_start:
            return self.theta0
        if th_rows is None:
            # aval for precompiles
            return jax.ShapeDtypeStruct((rows, self.ndim), jnp.float64)
        th = jnp.asarray(th_rows, dtype=jnp.float64)
        (th,) = _pad_cyclic([th], rows - th.shape[0])
        if self.mesh is not None:
            th = shard_batch(jnp.asarray(th), self.mesh)
        return jnp.asarray(th)

    def _lowered_runner(self, key, yb_j, db_j, th0):
        """Lowered(-like) runner program.  XLA-scan programs go through
        the exported-program tier (program_cache.py; the mesh topology
        joins the signature); kernel programs are lowered directly —
        ``jax.export`` refuses the Triton custom call."""
        args = (key, yb_j, db_j, th0, self.percent)
        if self.use_pallas:
            return self.runner.lower(*args)
        from mind_the_gaps_tpu.program_cache import lower_via_cache

        sig = self._prog_sig
        if self.mesh is not None:
            sig += f"|mesh={tuple(self.mesh.shape.items())}"
        return lower_via_cache(sig, self.runner, args)

    def pad_rows(self, nb: int, total: Optional[int] = None) -> int:
        """Rows of cyclic padding for a chunk of nb lightcurves.

        On the kernel path a ragged last chunk of a multi-chunk run is
        padded up to the full chunk size, so the whole bootstrap reuses
        ONE compiled executable (a second program shape costs a compile,
        more than the padded rows cost the kernel).  On the scan path
        only the mesh alignment applies — padding a 1-row remainder to
        512 rows of 500-step MCMC would nearly double the work.
        """
        align = self.n_dev if self.mesh is not None else 1
        if (
            self.use_pallas
            and (total or nb) > self.chunk
            and nb < self.chunk
            and self.chunk % align == 0
        ):
            return self.chunk - nb
        return (-nb) % align

    def _prep(self, yb, db, total: Optional[int]):
        yb, db = _pad_cyclic([yb, db], self.pad_rows(yb.shape[0], total))
        if self.mesh is not None:
            yb = shard_batch(jnp.asarray(yb), self.mesh)
            db = shard_batch(jnp.asarray(db), self.mesh)
        return jnp.asarray(yb), jnp.asarray(db)

    def _exec_for(self, key, yb_j, db_j, th0):
        """AOT executable for this input shape/dtype, memoized — every
        chunk of a run reuses one in-memory executable."""
        sig = (yb_j.shape, str(yb_j.dtype))
        ex = self._execs.get(sig)
        if ex is None:
            ex = self._lowered_runner(key, yb_j, db_j, th0).compile()
            self._execs[sig] = ex
        return ex

    def precompile_async(self, executor, total: Optional[int] = None):
        """Start the canonical full-chunk AOT compile on a worker thread.

        The chunk programs are the LRT's largest cold-start compiles;
        compiling the null and alternative fitters concurrently (and
        overlapping the generation program's compile in the main thread)
        hides most of it.  ``fit_chunk`` joins the pending compile
        before running, so worker-thread errors surface at the call
        site.

        The trace/lower step runs on the CALLING thread: tracing embeds
        global-order-dependent symbol names in the module, so programs
        traced concurrently hash to irreproducible persistent-cache keys
        (gpmodelling._segment_lower has the full story).  Only the
        backend compile goes to the worker."""
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32

        nb = min(self.chunk, max(int(total or self.chunk), 1))
        if self.mesh is None:
            # avals only: lowering needs no real buffers
            rows = nb + self.pad_rows(nb, total)
            yb_j = jax.ShapeDtypeStruct((rows, self.n_points), dtype)
            db_j = jax.ShapeDtypeStruct((rows, self.n_points), dtype)
            th0 = self._theta0_for(rows)
            key = jax.eval_shape(lambda: jax.random.key(0))
        else:
            yb = np.zeros((nb, self.n_points), dtype=dtype)
            db = np.ones((nb, self.n_points), dtype=dtype)
            yb_j, db_j = self._prep(yb, db, total)
            th0 = (
                self._theta0_for(yb_j.shape[0], np.zeros((yb_j.shape[0], self.ndim)))
                if self.per_row_start
                else self.theta0
            )
            key = jax.random.key(0)
        sig = (yb_j.shape, str(yb_j.dtype))
        lowered = self._lowered_runner(key, yb_j, db_j, th0)

        def work():
            if sig not in self._execs:
                self._execs[sig] = lowered.compile()

        self._pending = executor.submit(work)

    def fit_chunk(self, key, yb, db, total: Optional[int] = None, theta0_rows=None):
        """(nb, N) data + VARIANCE diagonal -> (lls (nb,), xs (nb, D)).

        ``theta0_rows``: per-row (nb, D) starting points, required when
        the fitter was built with ``per_row_start=True`` (padded
        cyclically alongside the data so padded rows restart their source
        row's chain)."""
        nb = yb.shape[0]
        yb_j, db_j = self._prep(yb, db, total)
        if self.per_row_start:
            if theta0_rows is None:
                raise ValueError("per_row_start fitter needs theta0_rows")
            th0 = self._theta0_for(yb_j.shape[0], theta0_rows)
        else:
            th0 = self.theta0
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()
        exec_fn = self._exec_for(key, yb_j, db_j, th0)
        lls, xs = exec_fn(key, yb_j, db_j, th0, self.percent)
        return lls[:nb], xs[:nb]


def fit_lightcurves_batch(
    key,
    kernel,
    times,
    ys,
    dys,
    theta0,
    walkers: int = 12,
    n_steps: int = 500,
    percent: float = 0.1,
    chunk: int = 512,
    use_mesh: bool = True,
    dtype=None,
    backend: str = "auto",
    spmd: str = "gspmd",
    early_stop=None,
):
    """Max log-likelihood of ``kernel`` fit to each of B lightcurves
    sharing ``times``: short ensemble MCMC per lightcurve, batched.

    ``theta0``: (D,) shared starting point, or (B, D) PER-ROW starting
    points (each lightcurve's chains start at its own row — required for
    a row-symmetric matched estimator, see ``_make_batched_max_loglike``).

    ``spmd``: how the simulation axis parallelizes over the mesh —
    "gspmd" (default) shards the inputs and lets XLA partition the jitted
    program; "shard_map" uses the explicit per-device program (per-shard
    RNG streams, multi-host-safe).

    ``early_stop``: optional ``(tol, patience)`` on-device plateau rule —
    see ``_make_batched_max_loglike``.  ``None`` runs the full fixed
    ``n_steps`` budget.

    Returns (best_loglikes (B,), best_params (B, D)).
    """
    ys = np.asarray(ys, dtype=np.float64)
    dys = np.asarray(dys, dtype=np.float64)
    diags = (dys + 1e-12) ** 2
    B = ys.shape[0]

    theta0 = np.asarray(theta0, dtype=np.float64)
    per_row = theta0.ndim == 2
    if per_row and theta0.shape[0] != B:
        raise ValueError("per-row theta0 must have one row per lightcurve")
    fitter = _ChunkFitter(
        kernel, times, theta0[0] if per_row else theta0,
        walkers=walkers, n_steps=n_steps, percent=percent,
        chunk=chunk, dtype=dtype, backend=backend, spmd=spmd, use_mesh=use_mesh,
        early_stop=early_stop, per_row_start=per_row,
    )
    best_lls, best_xs = [], []
    for start in range(0, B, chunk):
        key, sub = jax.random.split(key)
        lls, xs = fitter.fit_chunk(
            sub, ys[start : start + chunk], diags[start : start + chunk], total=B,
            theta0_rows=theta0[start : start + chunk] if per_row else None,
        )
        lls.block_until_ready()
        best_lls.append(np.asarray(lls))
        best_xs.append(np.asarray(xs))
    return np.concatenate(best_lls), np.concatenate(best_xs)


def protassov_lrt(
    lightcurve: GappyLightcurve,
    null_kernel,
    alt_kernel,
    nsims: int = 1000,
    pdf: str = "Gaussian",
    sigma_noise=None,
    extension_factor: int = 2,
    observed_max_steps: int = 10000,
    observed_walkers: int = 32,
    sim_max_steps: int = 500,
    sim_walkers: int = 12,
    sim_dtype="float32",
    chunk: int = 512,
    seed: int = 0,
    fit_observed: bool = True,
    null_model: Optional[GPModelling] = None,
    alt_model: Optional[GPModelling] = None,
    progress: bool = False,
    matched_estimator: bool = True,
    observed_fast: Optional[bool] = None,
    keep_simulations: bool = False,
    checkpoint: Optional[str] = None,
    sim_early_stop=(0.01, 50),
) -> LRTResult:
    """Run the full Protassov LRT (SURVEY.md §3.4) end to end.

    Pass pre-fit ``null_model``/``alt_model`` (with posteriors derived) to
    skip step 1.  ``nsims`` must be >= 1.

    ``checkpoint``: optional .npz path for the bootstrap stage (the
    reference's script workflow persists intermediates between stages,
    docs/workflow.md:43-92).  Per-chunk results are written after every
    chunk; an interrupted run resumes from the last completed chunk and
    reproduces the uninterrupted result EXACTLY (every chunk's RNG keys
    are precomputed from the seed, so chunks are independent).  The file
    records a config checksum — posterior samples, data, and bootstrap
    settings — and is ignored with a warning on mismatch.  Only the
    device pipeline checkpoints (ignored under ``keep_simulations``).

    ``keep_simulations`` (default False): materialize every simulated
    lightcurve on the host and return them in ``LRTResult.sim_rates`` /
    ``sim_dy``.  The default runs the device-resident pipeline instead:
    each chunk of simulations is generated on device and fed straight to
    the fitters, so the (nsims, n) arrays never cross the host boundary
    (at 10k sims that round trip is ~0.8 GB of f64 each way).

    ``matched_estimator`` (default True): compute the observed T with the
    SAME short-chain fitter used for the simulations.  The reference
    compares a long-chain observed maximum against short-chain simulated
    maxima (50,000 vs 500 steps in its tutorial), which biases T_obs high
    and makes the p-value anti-conservative; the matched estimator is
    calibrated (examples/validation_pvalue_calibration.py).  The
    posterior-chain T and its p-value are still reported as
    ``t_obs_posterior`` / ``p_value_posterior`` for reference parity.

    ``sim_walkers`` (default 12) matches the reference's refit ensembles
    (derive_posteriors walkers=12, reference gpmodelling.py:204; the
    tutorial notebooks use nwalkers=12), and the calibration and
    detection-power studies (examples/validation_*.py) run at 12.

    ``sim_early_stop`` (default ``(tol=0.01, patience=50)``): on-device
    plateau rule for the short-chain refits — each chunk's step loop
    stops once no lightcurve improved its best log-likelihood by more
    than ``tol`` for ``patience`` consecutive steps, bounded by
    ``sim_max_steps``.  Measured on the production scenario the DRW null
    chunk stops near step ~130 (worst best-loglike deficit 0.008, below
    the f32 noise floor) while the DRW+QPO alternative runs its full
    budget.  The observed
    matched-estimator fit rides the same program, so T_obs and T_dist
    use identical estimators.  Pass ``None`` for the reference's fixed
    500-step budget.
    """
    if nsims < 1:
        raise ValueError("nsims must be >= 1 (the p-value is the tail fraction of the simulated T distribution)")
    t_start = time.monotonic()

    def _mark(msg):
        if progress:
            print(f"[lrt +{time.monotonic() - t_start:7.1f}s] {msg}", flush=True)

    key = jax.random.key(seed)
    sim_dtype = None if sim_dtype is None else jnp.dtype(sim_dtype)
    refine_f64 = sim_dtype is not None and sim_dtype != jnp.dtype(np.float64)
    # observed fits use the mesh too when one is available (the
    # reference's walker Pool, gpmodelling.py:245): derive_posteriors'
    # mesh mode shards the walker axis and is bit-identical to the
    # single-device run (sharding-invariant RNG); it gates itself off
    # when the walker count does not divide the device count.
    obs_mesh = default_mesh() if len(jax.devices()) > 1 else None
    if obs_mesh is not None and observed_walkers % obs_mesh.size != 0:
        obs_mesh = None  # derive_posteriors would gate it off anyway
    dy_obs = np.asarray(
        lightcurve.dy if lightcurve.dy is not None else np.zeros(lightcurve.n),
        dtype=np.float64,
    )
    need_null = null_model is None
    need_alt = alt_model is None
    if need_null:
        null_model = GPModelling(lightcurve, null_kernel)
    if need_alt:
        alt_model = GPModelling(lightcurve, alt_kernel)

    # Fire ALL the device pipeline's cold compiles NOW, before any
    # sampling: every program of the bootstrap stage (chunk fitters,
    # generator, f64 refiners, the observed fits' f64 recompute) is
    # fully determined by SHAPES known at entry, so the backend compiles
    # run on a thread pool WHILE the observed fits sample instead of
    # serializing after them.  The
    # fitters are built with a placeholder theta0 — the starting point
    # is a runtime argument, not part of the compiled program — and
    # repointed at the observed MAP estimates below.
    fitter_null = fitter_alt = gen = None
    if not keep_simulations:
        from concurrent.futures import ThreadPoolExecutor

        _mark("models built")
        fitter_null = _ChunkFitter(
            null_kernel, lightcurve.times, null_kernel.get_parameter_vector(),
            walkers=sim_walkers, n_steps=sim_max_steps, chunk=chunk, dtype=sim_dtype,
            early_stop=sim_early_stop, per_row_start=True,
        )
        fitter_alt = _ChunkFitter(
            alt_kernel, lightcurve.times, alt_kernel.get_parameter_vector(),
            walkers=sim_walkers, n_steps=sim_max_steps, chunk=chunk, dtype=sim_dtype,
            early_stop=sim_early_stop, per_row_start=True,
        )
        n_rows = nsims + (1 if matched_estimator else 0)
        gen = null_model.make_device_generator(
            pdf, extension_factor=extension_factor, sigma_noise=sigma_noise
        )
        _mark("fitters+generator built")
        pre_pool = ThreadPoolExecutor(8)
        fitter_null.precompile_async(pre_pool, n_rows)
        fitter_alt.precompile_async(pre_pool, n_rows)
        _mark("fitter precompiles submitted")
        n_pts = int(lightcurve.n)
        t64_pre = jnp.asarray(lightcurve.times, dtype=jnp.float64)
        _mark("t64 device put done")
        # Every precompile below LOWERS on this (main) thread and only
        # submits the backend compile to the pool: concurrent tracing
        # embeds racy symbol names in the modules, which makes the
        # persistent-cache keys irreproducible across processes — every
        # "warm" run was recompiling all of these (~25-40 s) until the
        # lowers were serialized (gpmodelling._segment_lower).
        if pdf.lower() == "gaussian":
            # the E13 generator is a host-chunked loop, not one program;
            # only the fused Gaussian pipeline precompiles as a unit.
            # The dummy thetas carry the same sharding the real chunks
            # will (sharding is part of the compiled signature).
            gen_b = min(nsims, chunk, _GEN_CAP)
            if fitter_null.mesh is not None and gen_b % fitter_null.n_dev == 0:
                th = shard_batch(jnp.zeros((gen_b, null_model._ndim), dtype=jnp.float64), fitter_null.mesh)
                k_aval = jax.random.key(0)
            else:
                th = jax.ShapeDtypeStruct((gen_b, null_model._ndim), jnp.float64)
                k_aval = jax.eval_shape(lambda: jax.random.key(0))
            try:
                gen_lowered = gen.lower(k_aval, k_aval, th)
            except Exception:
                gen_lowered = None
            if gen_lowered is not None:
                pre_pool.submit(gen_lowered.compile)
            _mark("gen lowered")
        else:
            # non-Gaussian: start the batched PSD program's compile now
            # (the host-chunked E13 loop around it re-dispatches per
            # chunk).  The mesh rides along so the PSD dummy carries the
            # sharding the real batch-sharded theta chunks will have.
            gen.precompile(
                pre_pool, B=min(nsims, chunk, _GEN_CAP), mesh=fitter_null.mesh
            )
            _mark("gen lowered")
        if refine_f64:
            n_chunks_pre = -(-n_rows // chunk)
            nb_last = n_rows - (n_chunks_pre - 1) * chunk
            rows = (
                chunk
                if n_chunks_pre > 1
                else nb_last + fitter_null.pad_rows(nb_last, n_rows)
            )

            def _lower_refine(kern, d):
                if fitter_null.mesh is None:
                    # avals only — no dummy device buffers
                    th = jax.ShapeDtypeStruct((rows, d), sim_dtype)
                    ys = jax.ShapeDtypeStruct((rows, n_pts), jnp.float64)
                    ds = jax.ShapeDtypeStruct((rows, n_pts), jnp.float64)
                    return _f64_logprob_chunk_from_dy.lower(th, t64_pre, ys, ds, kernel=kern)
                th = jnp.zeros((rows, d), dtype=sim_dtype)
                ys = jnp.zeros((rows, n_pts), dtype=jnp.float64)
                ds = jnp.zeros((rows, n_pts), dtype=jnp.float64)
                if fitter_null.mesh is not None and rows % fitter_null.n_dev == 0:
                    # match the runtime sharding (the generated rates and
                    # fitted thetas arrive batch-sharded) — an unsharded
                    # dummy would seed a jit specialization the real call
                    # never hits
                    th = shard_batch(th, fitter_null.mesh)
                    ys = shard_batch(ys, fitter_null.mesh)
                    ds = shard_batch(ds, fitter_null.mesh)
                # NOT export-cached: the chunk loop re-dispatches this as
                # a jit call, which must reuse THIS trace in-process — an
                # export wrapper here would leave the runtime dispatch
                # compiling the direct program from scratch.
                return _f64_logprob_chunk_from_dy.lower(th, t64_pre, ys, ds, kernel=kern)

            for kern, d in ((null_kernel, null_kernel.ndim), (alt_kernel, alt_kernel.ndim)):
                try:
                    refine_lowered = _lower_refine(kern, d)
                except Exception:
                    refine_lowered = None
                if refine_lowered is not None:
                    pre_pool.submit(refine_lowered.compile)
            _mark("refine lowered")
        if observed_fast is True or (observed_fast is None and gpu_kernel_available()):
            # derive_posteriors' end-of-run f64 recompute (one padded
            # 4096-row program per model on the fast path)
            if need_null:
                null_model.precompile_recompute(pre_pool)
            if need_alt:
                alt_model.precompile_recompute(pre_pool)
            _mark("recompute lowered")
        # the observed-fit segment programs: start their compiles now so
        # they overlap the MAP fits and the bootstrap-program compiles
        for model, need in ((null_model, need_null), (alt_model, need_alt)):
            if need:
                model.precompile_sampler(
                    pre_pool, max_steps=observed_max_steps,
                    walkers=observed_walkers, fast=observed_fast, mesh=obs_mesh,
                )
                _mark("sampler segment lowered")
                if fit_observed:
                    # the MAP objective was lowered at construction;
                    # its XLA-CPU compile (~10 s, not reloadable from
                    # the cache on this runtime) overlaps everything too
                    model.precompile_fit(pre_pool)
        pre_pool.shutdown(wait=False)
        _mark("cold compiles submitted")

    # 1. observed fits.  When both models need deriving they run on two
    # threads: the two segment programs' compiles — the largest
    # remaining truly-cold cost — then overlap, and so do each model's
    # per-segment device executions (the convergence loop's host check
    # otherwise serializes two independent chains).  Results are
    # identical to the sequential order: each model owns its RNG stream
    # (seed+101 / seed+102).
    obs_kwargs = dict(
        fit=fit_observed, max_steps=observed_max_steps, walkers=observed_walkers,
        progress=progress, fast=observed_fast, mesh=obs_mesh,
    )
    if need_null and need_alt:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(2) as pool:
            f_null = pool.submit(null_model.derive_posteriors, seed=seed + 101, **obs_kwargs)
            f_alt = pool.submit(alt_model.derive_posteriors, seed=seed + 102, **obs_kwargs)
            f_null.result()
            f_alt.result()
    elif need_null:
        null_model.derive_posteriors(seed=seed + 101, **obs_kwargs)
    elif need_alt:
        alt_model.derive_posteriors(seed=seed + 102, **obs_kwargs)

    _mark("observed fits done")
    t_obs = -2.0 * (null_model.max_loglikelihood - alt_model.max_loglikelihood)

    # 2+3. posterior-predictive simulation + refits.  The matched-
    # estimator observed fit rides IN the same batch as the simulations,
    # so the whole LRT compiles exactly one short-MCMC program shape per
    # kernel — round 2 pushed the single observed lightcurve through its
    # own G-padded program, a whole extra compile for B=1.
    key, k_null, k_alt = jax.random.split(key, 3)
    theta0_null = null_model.max_parameters[: null_kernel.ndim]
    theta0_alt = alt_model.max_parameters[: alt_kernel.ndim]
    sim_rates = sim_dy = None

    if keep_simulations:
        if checkpoint is not None:
            warnings.warn("checkpoint is only supported by the device pipeline; ignored with keep_simulations=True")
        # host-array path: materialize every simulation on the host
        # (returned in LRTResult.sim_rates/sim_dy)
        sim_rates, sim_dy = null_model.generate_batch_from_posteriors(
            nsims, pdf=pdf, extension_factor=extension_factor,
            sigma_noise=sigma_noise, seed=seed + 1,
        )
        # per-row refit starts (see the device pipeline below for the
        # rationale): replicate generate_batch_from_posteriors' draw
        # stream to recover each sim's generating posterior draw
        k0_h = jax.random.key(seed + 1)
        _, k_pick_h, _, _ = jax.random.split(k0_h, 4)
        n_samp = len(null_model.mcmc_samples)
        idx_h = np.asarray(jax.random.randint(k_pick_h, (nsims,), 0, n_samp))
        sim_starts = np.asarray(null_model.mcmc_samples)[idx_h][:, : null_kernel.ndim]
        obs_start_h = np.asarray(null_model.mcmc_samples)[
            int(np.asarray(jax.random.randint(jax.random.fold_in(k_pick_h, 1), (), 0, n_samp)))
        ][None, : null_kernel.ndim]
        if matched_estimator:
            fit_rates = np.concatenate([np.asarray(lightcurve.y)[None, :], sim_rates])
            fit_dy = np.concatenate([dy_obs[None, :], sim_dy])
            null_starts_h = np.concatenate([obs_start_h, sim_starts])
        else:
            fit_rates, fit_dy = sim_rates, sim_dy
            null_starts_h = sim_starts
        null_lls, null_xs = fit_lightcurves_batch(
            k_null, null_kernel, lightcurve.times, fit_rates, fit_dy, null_starts_h,
            walkers=sim_walkers, n_steps=sim_max_steps, chunk=chunk, dtype=sim_dtype,
            early_stop=sim_early_stop,
        )
        alt_lls, alt_xs = fit_lightcurves_batch(
            k_alt, alt_kernel, lightcurve.times, fit_rates, fit_dy,
            _alt_theta0_rows(null_kernel, alt_kernel, null_starts_h),
            walkers=sim_walkers, n_steps=sim_max_steps, chunk=chunk, dtype=sim_dtype,
            early_stop=sim_early_stop,
        )
        if refine_f64:
            # f64-exact T statistics: re-evaluate the f32-explored
            # optima with the batched f64 scan instead of casting
            null_lls = loglikes_f64_at(null_kernel, lightcurve.times, fit_rates, fit_dy, null_xs)
            alt_lls = loglikes_f64_at(alt_kernel, lightcurve.times, fit_rates, fit_dy, alt_xs)
        null_lls = null_lls.astype(np.float64)
        alt_lls = alt_lls.astype(np.float64)
        if matched_estimator:
            ll0_obs, ll1_obs = null_lls[0], alt_lls[0]
            null_lls, alt_lls = null_lls[1:], alt_lls[1:]
    else:
        # device-resident pipeline (default): each chunk of simulations
        # is generated on device and fed STRAIGHT to both fitters (and
        # the f64 re-evaluation) without crossing to the host — only the
        # (chunk,)-sized results are fetched.  The host round trip of
        # the full (nsims, n) arrays cost ~1/3 of the round-2 10k-sim
        # LRT wall-clock.  The RNG stream matches the host path (same
        # draw keys, same per-chunk generation keys for full chunks).
        k0 = jax.random.key(seed + 1)
        _, k_pick, k_sim, k_noise = jax.random.split(k0, 4)
        n_samples = len(null_model.mcmc_samples)
        idx = np.asarray(jax.random.randint(k_pick, (nsims,), 0, n_samples))
        param_samples = np.asarray(null_model.mcmc_samples)[idx]

        # Per-row refit starting points (calibration-critical, round 6):
        # each sim's chains start at the posterior draw that GENERATED it
        # and the observed row's at an INDEPENDENT posterior draw — under
        # the null these start→optimum relations are exchangeable, so the
        # matched estimator stays unbiased.  (Starting every row at the
        # observed MAP let the observed row start at its own optimum
        # while sims started at a foreign point; with the alternative
        # refits not fully converged in their budget that privileged
        # T_obs and made lognormal p-values anti-conservative: KS p=0.003
        # in a lognormal calibration run.)
        # The alternative's extra dimensions start at its construction
        # parameters for EVERY row (_alt_theta0_rows).
        idx_obs = int(np.asarray(
            jax.random.randint(jax.random.fold_in(k_pick, 1), (), 0, n_samples)
        ))
        obs_start = np.asarray(null_model.mcmc_samples)[idx_obs][None, :]
        null_starts = param_samples  # (nsims, D_null)
        n_rows = nsims + (1 if matched_estimator else 0)
        obs_y = jnp.asarray(np.asarray(lightcurve.y, dtype=np.float64))[None, :]
        obs_dy = jnp.asarray(dy_obs)[None, :]
        t64 = jnp.asarray(lightcurve.times, dtype=jnp.float64)

        n_chunks = -(-n_rows // chunk)
        n_gen = -(-nsims // chunk)  # nsims >= 1 is enforced at entry
        k_sims = jax.random.split(k_sim, n_gen)
        k_noises = jax.random.split(k_noise, n_gen)
        k_fit = jax.random.split(jax.random.fold_in(key, 7), 2 * n_chunks)

        def gen_capped(ks, kn, thetas_c):
            # keep every generation dispatch <= _GEN_CAP rows even when
            # the FIT chunk is larger (see _GEN_CAP)
            b = thetas_c.shape[0]
            if b <= _GEN_CAP:
                return gen(ks, kn, thetas_c)
            sub_ks = jax.random.split(ks, -(-b // _GEN_CAP))
            sub_kn = jax.random.split(kn, len(sub_ks))
            parts = [
                gen(sub_ks[i], sub_kn[i], thetas_c[s : s + _GEN_CAP])
                for i, s in enumerate(range(0, b, _GEN_CAP))
            ]
            return (
                jnp.concatenate([p[0] for p in parts]),
                jnp.concatenate([p[1] for p in parts]),
            )

        chunks_done = 0
        null_parts, alt_parts = [], []
        ckpt_crc = None
        if checkpoint is not None:
            # the checksum must cover EVERY input that changes the
            # per-chunk results: data (times/y/dy), the null posterior
            # draws, both kernels' starting points and bounds, and the
            # bootstrap settings (incl. sigma_noise) — anything missing
            # here would let a stale checkpoint resume silently
            h = zlib.crc32(np.asarray(lightcurve.times, dtype=np.float64).tobytes())
            h = zlib.crc32(np.asarray(lightcurve.y, dtype=np.float64).tobytes(), h)
            h = zlib.crc32(dy_obs.tobytes(), h)
            h = zlib.crc32(np.ascontiguousarray(param_samples, dtype=np.float64).tobytes(), h)
            for arr in (
                theta0_null,
                theta0_alt,
                np.asarray(
                    [(float(lo), float(hi)) for lo, hi in null_kernel.get_parameter_bounds()]
                ),
                np.asarray(
                    [(float(lo), float(hi)) for lo, hi in alt_kernel.get_parameter_bounds()]
                ),
            ):
                h = zlib.crc32(np.ascontiguousarray(arr, dtype=np.float64).tobytes(), h)
            h = zlib.crc32(
                repr(
                    (nsims, chunk, seed, sim_walkers, sim_max_steps, str(sim_dtype),
                     pdf.lower(), matched_estimator, extension_factor,
                     None if sigma_noise is None else float(np.mean(sigma_noise)),
                     None if sim_early_stop is None
                     else (float(sim_early_stop[0]), int(sim_early_stop[1])),
                     "per-row-starts-v2")  # round-6 refit start policy
                ).encode(),
                h,
            )
            ckpt_crc = h
            if os.path.exists(checkpoint):
                try:
                    d = np.load(checkpoint)
                    if int(d["config_crc"]) == ckpt_crc:
                        chunks_done = int(d["chunks_done"])
                        null_parts = [np.asarray(d["null_done"], dtype=np.float64)]
                        alt_parts = [np.asarray(d["alt_done"], dtype=np.float64)]
                        if progress:
                            print(f"resuming bootstrap from chunk {chunks_done}/{n_chunks}")
                    else:
                        warnings.warn(
                            f"checkpoint {checkpoint} was written for a different "
                            "LRT configuration; recomputing from scratch"
                        )
                except Exception as exc:
                    warnings.warn(f"unreadable checkpoint {checkpoint} ({exc}); recomputing")

        for ci in range(n_chunks):
            if ci < chunks_done:
                continue
            s0 = ci * chunk
            count = max(0, min((ci + 1) * chunk, nsims) - s0)
            if count:
                thetas_c = param_samples[s0 : s0 + count]
                if n_chunks > 1 and count < chunk:
                    # pad the generation batch to the full chunk so the
                    # generation program keeps ONE shape; slice after
                    pidx = np.arange(chunk - count) % count
                    thetas_c = np.concatenate([thetas_c, thetas_c[pidx]])
                if (
                    fitter_null.mesh is not None
                    and thetas_c.shape[0] % fitter_null.n_dev == 0
                ):
                    # shard the GENERATION over the mesh too (roadmap:
                    # the sims were generated replicated-ish and only
                    # resharded at the fitter boundary) — the parameter
                    # draws go in batch-sharded, so XLA partitions the
                    # whole FFT/noise pipeline per device and the rates
                    # arrive at the fitters already distributed
                    thetas_c = shard_batch(jnp.asarray(thetas_c), fitter_null.mesh)
                rates, dys = gen_capped(k_sims[ci], k_noises[ci], thetas_c)
                if rates.shape[0] != count:
                    rates, dys = rates[:count], dys[:count]
                if matched_estimator and ci == n_chunks - 1:
                    rates = jnp.concatenate([rates, obs_y.astype(rates.dtype)])
                    dys = jnp.concatenate([dys, obs_dy.astype(dys.dtype)])
            else:  # an obs-only final chunk (nsims a multiple of chunk)
                rates, dys = obs_y, obs_dy
            nb = rates.shape[0]
            # per-row starts aligned with this chunk's rows (see above);
            # the generating draws may carry fitted-mean columns — the
            # refit model is kernel-only with an unfitted constant mean
            starts_c = null_starts[s0 : s0 + count, : null_kernel.ndim]
            if matched_estimator and ci == n_chunks - 1:
                starts_c = np.concatenate([starts_c, obs_start[:, : null_kernel.ndim]])
            diag = _square_err(dys)
            nl, nx = fitter_null.fit_chunk(
                k_fit[2 * ci], rates, diag, total=n_rows, theta0_rows=starts_c
            )
            al, ax = fitter_alt.fit_chunk(
                k_fit[2 * ci + 1], rates, diag, total=n_rows,
                theta0_rows=_alt_theta0_rows(null_kernel, alt_kernel, starts_c),
            )
            if refine_f64:
                rem = fitter_null.pad_rows(nb, n_rows)
                rates_p, dys_p, nx, ax = _pad_cyclic([rates, dys, nx, ax], rem)
                nl = _f64_logprob_chunk_from_dy(nx, t64, rates_p, dys_p, kernel=null_kernel)[:nb]
                al = _f64_logprob_chunk_from_dy(ax, t64, rates_p, dys_p, kernel=alt_kernel)[:nb]
            if checkpoint is not None:
                # checkpointing trades the deferred-fetch pipelining for
                # durability: sync this chunk's (tiny) results and
                # atomically rewrite the running file
                null_parts.append(np.asarray(nl, dtype=np.float64))
                alt_parts.append(np.asarray(al, dtype=np.float64))
                tmp = checkpoint + ".tmp.npz"
                np.savez(
                    tmp,
                    config_crc=np.int64(ckpt_crc),
                    chunks_done=np.int64(ci + 1),
                    null_done=np.concatenate(null_parts),
                    alt_done=np.concatenate(alt_parts),
                )
                os.replace(tmp, checkpoint)
            else:
                # keep results on device: fetching here would sync the
                # pipeline every chunk; deferring lets the device queue
                # run generation/fits/refinement back to back
                null_parts.append(nl)
                alt_parts.append(al)
            _mark(f"bootstrap chunk {ci + 1}/{n_chunks} dispatched")
        null_lls = np.concatenate([np.asarray(x, dtype=np.float64) for x in null_parts])
        alt_lls = np.concatenate([np.asarray(x, dtype=np.float64) for x in alt_parts])
        if matched_estimator:
            ll0_obs, ll1_obs = null_lls[-1], alt_lls[-1]
            null_lls, alt_lls = null_lls[:-1], alt_lls[:-1]
        # one end-of-run fetch of the E13 non-convergence count (the
        # device queue is drained by now); warns like the reference's
        # per-lightcurve message (simulator.py:126-127)
        gen.report_nonconverged()
        _mark("bootstrap results fetched")

    # 4. T distribution and p-values (reference nb: percentileofscore)
    t_dist = -2.0 * (null_lls - alt_lls)
    p_posterior = 1.0 - percentile_of_score(t_dist, t_obs) / 100.0

    if matched_estimator:
        t_obs_matched = -2.0 * (float(ll0_obs) - float(ll1_obs))
        p_value = 1.0 - percentile_of_score(t_dist, t_obs_matched) / 100.0
        t_main = t_obs_matched
    else:
        p_value = p_posterior
        t_main = float(t_obs)

    return LRTResult(
        t_obs=float(t_main),
        t_dist=t_dist,
        p_value=float(p_value),
        null_model=null_model,
        alt_model=alt_model,
        null_sim_loglikes=null_lls,
        alt_sim_loglikes=alt_lls,
        t_obs_posterior=float(t_obs),
        p_value_posterior=float(p_posterior),
        sim_rates=sim_rates,
        sim_dy=sim_dy,
    )
