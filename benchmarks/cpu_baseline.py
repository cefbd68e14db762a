"""Measured CPU baseline for the celerite+emcee reference pipeline.

The reference publishes no timings (BASELINE.md), and celerite itself is
not installable here, so round 2's bench.py *estimated* the CPU pipeline
at 8,000 evals/s from celerite's published scaling figure.  This script
replaces the estimate with a measurement on real hardware:

1. **Compiled celerite-equivalent solver, single core** — the XLA-CPU
   jitted f64 fused-scan log-likelihood (solver/semiseparable.py), the
   same O(N R^2) recursion celerite's C++/Eigen solver runs
   (Foreman-Mackey+17 §5; reference gpmodelling.py:152 calls it per
   MCMC step).  Measured per-evaluation latency at N=5k with the
   DRW+Lorentzian (null+QPO) kernel.
2. **Pure-numpy Python-loop recursion** — the same recursion without a
   compiler, as a floor showing the compiled proxy is *generous* to the
   baseline (a numpy reimplementation of the reference without celerite
   would be far slower).
3. The 12-core pipeline rate = single-core rate x 12 (the reference's
   typical core count, gpmodelling.py:204/tutorials; its Pool
   parallelism is embarrassingly parallel across walkers/sims, so
   linear scaling is again generous — pickling overhead is ignored).

The measured number is recorded in BASELINE.md and hard-coded (with
provenance) as CPU_PIPELINE_BASELINE_EVALS_PER_SEC in bench.py, because
bench.py itself runs on the GPU host.

Run: python benchmarks/cpu_baseline.py   (prints one JSON line)
"""
from __future__ import annotations

import json
import time

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

REFERENCE_CORES = 12
CELERITE_PUBLISHED_EVALS_PER_SEC_PER_CORE = 670.0  # ~1.5 ms at N~5k, J~2-4 (FM+17 fig. scaling)


import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mind_the_gaps_tpu.solver.numpy_ref import numpy_log_likelihood as numpy_celerite_loglike  # noqa: E402


def main():
    from mind_the_gaps_tpu.kernels import DampedRandomWalk, Lorentzian
    from mind_the_gaps_tpu.solver import log_likelihood as solver_ll

    n_points = 5000
    rng = np.random.default_rng(0)
    t = np.cumsum(rng.uniform(2.0, 8.0, n_points))
    y = rng.normal(0.0, 2.0, n_points)
    diag = np.full(n_points, 0.09)

    kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0) + Lorentzian(
        log_S0=-1.0, log_Q=2.0, log_omega0=-2.0
    )
    theta0 = kernel.get_parameter_vector()
    t_j, y_j, d_j = jnp.asarray(t), jnp.asarray(y), jnp.asarray(diag)

    @jax.jit
    def eval_one(theta):
        return solver_ll(kernel.coefficients(theta), t_j, y_j, d_j)

    # parity: the numpy recursion must agree with the validated solver
    ll_np = numpy_celerite_loglike(kernel.coefficients(jnp.asarray(theta0)), t, y, diag)
    ll_jx = float(eval_one(jnp.asarray(theta0)))
    assert abs(ll_np - ll_jx) < 1e-6 * abs(ll_jx), (ll_np, ll_jx)

    # --- compiled solver single-core latency -------------------------- #
    thetas = [jnp.asarray(theta0 + 0.03 * rng.standard_normal(len(theta0))) for _ in range(60)]
    for th in thetas[:5]:
        float(eval_one(th))  # warmup
    start = time.perf_counter()
    acc = 0.0
    for th in thetas:
        acc += float(eval_one(th))
    compiled_latency = (time.perf_counter() - start) / len(thetas)

    # --- numpy-loop latency (floor) ----------------------------------- #
    co = kernel.coefficients(jnp.asarray(theta0))
    start = time.perf_counter()
    reps = 3
    for _ in range(reps):
        numpy_celerite_loglike(co, t, y, diag)
    numpy_latency = (time.perf_counter() - start) / reps

    per_core = 1.0 / compiled_latency
    # be generous to the baseline: never rate the reference below
    # celerite's published per-core figure
    per_core_baseline = max(per_core, CELERITE_PUBLISHED_EVALS_PER_SEC_PER_CORE)
    pipeline = per_core_baseline * REFERENCE_CORES
    total_evals_10k = 10_000 * 2 * 16 * 500  # sims x models x walkers x steps

    print(
        json.dumps(
            {
                "metric": "CPU celerite-pipeline baseline (measured)",
                "value": round(pipeline, 1),
                "unit": "evals/s (12-core-equivalent)",
                "compiled_latency_ms": round(compiled_latency * 1e3, 3),
                "compiled_evals_per_sec_per_core": round(per_core, 1),
                "numpy_loop_latency_ms": round(numpy_latency * 1e3, 1),
                "celerite_published_per_core": CELERITE_PUBLISHED_EVALS_PER_SEC_PER_CORE,
                "bootstrap_10k_seconds_at_this_rate": round(total_evals_10k / pipeline, 1),
                "n_points": n_points,
            }
        )
    )


if __name__ == "__main__":
    main()
