"""The GPU likelihood kernel against what XLA makes of the scan.

Three measurements, each for the Pallas-Triton kernel
(ops/pallas_celerite.py) and for ``solver.batched.batched_log_likelihood``
compiled by XLA (scan ``unroll`` 1 and 8):

- one bootstrap half-update: 512 sims x 12 walkers / 2 = 3,072 lanes,
  N=5,000, DRW+Lorentzian, f32;
- a 65,536-lane sweep of the same problem (8 lanes per data row);
- one full null+alt chunk refit (``fit_lightcurves_batch``: 512 sims,
  12 walkers, 500 steps, the LRT's default early stop).

    python benchmarks/kernel_vs_xla.py            # all three, both backends

Prints one JSON line.  Needs a GPU.  chip_smoke.py reuses the functions
(the chunk refit there for the kernel alone).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _kernel():
    from mind_the_gaps_tpu.kernels import DampedRandomWalk, Lorentzian

    return DampedRandomWalk(log_S0=1.0, log_omega0=-3.0) + Lorentzian(
        log_S0=-1.0, log_Q=2.0, log_omega0=-2.0
    )


def _timed(fn, *args, reps=5):
    """(compile + first call seconds, median seconds of ``reps`` calls)."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return first, float(np.median(times))


def likelihood_batch(lanes: int, n_points: int = 5000, repeats: int = 6, unrolls=(1, 8), reps=5):
    """Time one ``lanes``-lane grouped f32 likelihood batch (``repeats``
    walkers per data row) through the kernel and the XLA scan."""
    import jax
    import jax.numpy as jnp

    from mind_the_gaps_tpu.ops import pallas_log_likelihood
    from mind_the_gaps_tpu.solver.batched import batched_log_likelihood

    if lanes % repeats:
        raise ValueError(f"{lanes} lanes do not split into groups of {repeats}")
    kernel = _kernel()
    rng = np.random.default_rng(0)
    groups = lanes // repeats
    t = np.cumsum(rng.uniform(2.0, 8.0, n_points))
    ys = jnp.asarray(rng.normal(10.0, 2.0, (groups, n_points)), jnp.float32)
    ds = jnp.full((groups, n_points), 0.09, jnp.float32)
    theta0 = kernel.get_parameter_vector()
    th = jnp.asarray(theta0 + 0.05 * rng.normal(size=(lanes, theta0.size)), jnp.float32)
    coeffs = jax.vmap(kernel.coefficients)(th)
    means = jnp.repeat(jnp.mean(ys, axis=1), repeats)

    out = {"lanes": lanes, "n_points": n_points}
    kern = jax.jit(lambda c, y, d, m: pallas_log_likelihood(c, t, y, d, mean=m, repeats=repeats))
    first, med = _timed(kern, coeffs, ys, ds, means, reps=reps)
    out["kernel_ms"] = med * 1e3
    out["kernel_first_call_s"] = first
    for u in unrolls:
        xla = jax.jit(
            lambda c, y, d, m, u=u: batched_log_likelihood(c, t, y, d, mean=m, repeats=repeats, unroll=u)
        )
        first, med = _timed(xla, coeffs, ys, ds, means, reps=max(2, reps // 2))
        out[f"xla_unroll{u}_ms"] = med * 1e3
        out[f"xla_unroll{u}_first_call_s"] = first
    return out


def chunk_refit(backends=("pallas", "xla"), sims: int = 512, n_points: int = 5000, walkers: int = 12,
                steps: int = 500, seed: int = 0):
    """Wall seconds of one null + alternative chunk refit per backend
    (compiled first, timed on a second key), and the compiled chunk
    programs' memory analysis for the first backend."""
    import warnings

    import jax

    from mind_the_gaps_tpu.kernels import DampedRandomWalk
    from mind_the_gaps_tpu.lrt import _ChunkFitter

    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(2.0, 8.0, n_points))
    ys = 10.0 + rng.normal(0.0, 1.0, (sims, n_points))
    diags = np.full((sims, n_points), 0.09)
    null = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)])
    alt = _kernel()
    out = {"sims": sims, "walkers": walkers, "steps": steps}
    for backend in backends:
        total = 0.0
        for name, kern in (("null", null), ("alt", alt)):
            fitter = _ChunkFitter(
                kern, t, kern.get_parameter_vector(), walkers=walkers, n_steps=steps,
                chunk=sims, dtype="float32", backend=backend, use_mesh=False,
                early_stop=(0.01, 50),
            )
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                t0 = time.perf_counter()
                lls, _ = fitter.fit_chunk(jax.random.key(1), ys, diags)
                lls.block_until_ready()
                first = time.perf_counter() - t0
                t0 = time.perf_counter()
                lls, _ = fitter.fit_chunk(jax.random.key(2), ys, diags)
                lls.block_until_ready()
                dt = time.perf_counter() - t0
            if not np.all(np.isfinite(np.asarray(lls))):
                raise RuntimeError(f"{backend} {name} refit gave non-finite loglikes")
            out[f"{backend}_{name}_s"] = dt
            out[f"{backend}_{name}_first_call_s"] = first
            total += dt
            if backend == backends[0]:
                (ex,) = fitter._execs.values()
                out[f"memory_analysis_{name}"] = str(ex.memory_analysis())
        out[f"{backend}_null_plus_alt_s"] = total
    return out


def main():
    import jax

    from mind_the_gaps_tpu.ops import gpu_kernel_available

    if not gpu_kernel_available():
        raise SystemExit(f"needs a GPU; JAX's default backend is {jax.default_backend()!r}")
    record = {
        "device": {"platform": jax.devices()[0].platform, "kind": jax.devices()[0].device_kind,
                   "nvidia_smi": subprocess.run(
                       ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60,
                   ).stdout.strip()},
        "half_update": likelihood_batch(3072),
        "sweep_65536": likelihood_batch(65536, repeats=8, unrolls=(1,), reps=3),
        "chunk_refit": chunk_refit(),
    }
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
