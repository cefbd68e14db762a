"""Benchmark: batched GP log-likelihood throughput at N=5000, plus the
LRT-bootstrap wall-clock, on one GPU.

Primary metric (BASELINE.md): GP log-likelihood evaluations/sec at
N = 5k points with a DRW+Lorentzian (null+QPO) kernel — the kernel every
MCMC step of the LRT bootstrap executes, batched over
(simulations x walkers).  The measured path is the production f32 GPU
kernel (ops/pallas_celerite.py: local-phase rotation form + Kahan
accumulation); the run first checks it against the f64 XLA scan on a
small batch and refuses to report if they disagree by more than 0.5.

Further keys on the same JSON line: one production bootstrap chunk
(512 simulated lightcurves x 12 walkers x 500 steps, refit with BOTH the
DRW null and the DRW+QPO alternative; ``bootstrap_10k_seconds`` is that
time scaled by 10000/512 and says so), a 4000-step observed fit, the
lognormal (E13) generation rate, and one measured 512-sim LRT.

Every record names the device it ran on.  There is no CPU fallback:
without a GPU the script exits non-zero.  Rebuilding this benchmark
around per-deployment cells is open work (ROADMAP queue 1 #1).

vs_baseline: the reference publishes no numbers (BASELINE.md), so the
denominator is MEASURED by benchmarks/cpu_baseline.py: the compiled
celerite-equivalent XLA-CPU f64 scan at N=5k, DRW+QPO, one core
(88.1 evals/s), floored at celerite's published ~670 evals/s/core,
x the reference's typical 12 cores -> 8,040 evals/s.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

# benchmarks/cpu_baseline.py: max(88.1 measured, 670 published)
# evals/s/core x 12 cores
CPU_PIPELINE_BASELINE_EVALS_PER_SEC = 8_040.0
_T0 = time.monotonic()


def _mark(msg: str) -> None:
    """Phase marker on stderr (stdout carries ONLY the JSON line)."""
    print(f"[bench +{time.monotonic() - _T0:6.1f}s] {msg}", file=sys.stderr, flush=True)


def _device_record() -> dict:
    """The device the numbers were taken on; fails without a GPU."""
    from mind_the_gaps_tpu.ops import gpu_kernel_available

    if not gpu_kernel_available():
        raise SystemExit(f"bench.py needs a GPU; JAX's default backend is {jax.default_backend()!r}")
    dev = jax.devices()[0]
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        smi = "unknown"
    return {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()), "nvidia_smi": smi,
    }


def main():
    device = _device_record()
    from mind_the_gaps_tpu.kernels import DampedRandomWalk, Lorentzian
    from mind_the_gaps_tpu.ops import pallas_log_likelihood
    from mind_the_gaps_tpu.solver.batched import batched_log_likelihood

    n_points = 5000
    rng = np.random.default_rng(0)
    t = np.cumsum(rng.uniform(2.0, 8.0, n_points))
    y = rng.normal(0.0, 2.0, n_points)
    diag = np.full(n_points, 0.09)

    kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0) + Lorentzian(
        log_S0=-1.0, log_Q=2.0, log_omega0=-2.0
    )
    theta0 = kernel.get_parameter_vector()
    batch = 65536
    dtype = jnp.float32
    t64, y64, d64 = jnp.asarray(t), jnp.asarray(y), jnp.asarray(diag)
    yy, dd = jnp.asarray(y, dtype=dtype), jnp.asarray(diag, dtype=dtype)

    @jax.jit
    def ref64(th):
        return batched_log_likelihood(jax.vmap(kernel.coefficients)(th), t64, y64, d64)

    @jax.jit
    def sweep(th):
        return pallas_log_likelihood(jax.vmap(kernel.coefficients)(th), t64, yy, dd)

    # --- correctness gate: the f32 kernel must track the f64 scan ---- #
    thetas_check = jnp.asarray(
        theta0 + 0.05 * np.asarray(jax.random.normal(jax.random.key(7), (64, len(theta0))))
    )
    ll64 = np.asarray(ref64(thetas_check))
    ll32 = np.asarray(sweep(thetas_check.astype(dtype)))
    max_err = float(np.max(np.abs(ll64 - ll32)))
    if not np.all(np.isfinite(ll64)) or max_err > 0.5:
        raise SystemExit(f"f32 kernel / f64 scan mismatch: {max_err}")
    _mark(f"f32 kernel vs f64 scan: max |dlogL| {max_err:.3g}")

    reps = 4
    inputs = [
        jnp.asarray(theta0, dtype=dtype)
        + 0.05 * jax.random.normal(jax.random.key(100 + r), (batch, len(theta0)), dtype=dtype)
        for r in range(reps)
    ]
    sweep(inputs[0]).block_until_ready()  # compile + warmup
    start = time.perf_counter()
    outs = [sweep(th) for th in inputs]
    jax.block_until_ready(outs)
    elapsed = time.perf_counter() - start
    evals_per_sec = batch * reps / elapsed
    _mark("sweep timed")

    record = {
        "metric": "GP loglike evals/sec (N=5k, DRW+QPO kernel, f32 GPU kernel, f64-checked)",
        "value": round(evals_per_sec, 1),
        "unit": "evals/s",
        "vs_baseline": round(evals_per_sec / CPU_PIPELINE_BASELINE_EVALS_PER_SEC, 2),
        "f32_vs_f64_max_abs": max_err,
        "device": device,
    }
    for name, fn in [
        ("bootstrap_chunk", lambda: _bootstrap_chunk_seconds(t, y, diag)),
        ("e13_generation", _e13_generation_rate),
        ("derive_posteriors", lambda: _derive_posteriors_seconds(t, y, diag)),
        ("lrt_512", lambda: _lrt_512_measured_seconds(t)),
    ]:
        _mark(f"phase {name}: start")
        record.update(fn())
    print(json.dumps(record), flush=True)


def _bootstrap_chunk_seconds(t, y, diag, chunk_sims=512, walkers=12, n_steps=500, nsims_total=10_000):
    """Time one production bootstrap chunk (null + alternative refits) and
    scale to the 10k-sim Protassov bootstrap.

    The measured program is exactly what protassov_lrt runs per chunk
    (lrt.fit_lightcurves_batch -> _make_batched_max_loglike): grouped
    stretch-move chains, every step one (chunk*walkers/2)-element batched
    likelihood through the GPU kernel.  Warm up on one key, time another.
    """
    from mind_the_gaps_tpu.kernels import DampedRandomWalk, Lorentzian
    from mind_the_gaps_tpu.lrt import _make_batched_max_loglike

    null_kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0)
    alt_kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0) + Lorentzian(
        log_S0=-1.0, log_Q=2.0, log_omega0=-2.0
    )
    dtype = jnp.float32

    rng = np.random.default_rng(42)
    ys = (np.asarray(y)[None, :] + rng.normal(0.0, 0.3, (chunk_sims, len(y)))).astype(np.float32)
    diags = np.broadcast_to(np.asarray(diag, dtype=np.float32), ys.shape)
    ys_j, diags_j = jnp.asarray(ys), jnp.asarray(diags)
    tt = jnp.asarray(t, dtype=dtype)

    out = {
        "bootstrap_chunk_sims": chunk_sims,
        "bootstrap_walkers": walkers,
        "bootstrap_steps": n_steps,
        "bootstrap_early_stop": [0.01, 50],
        "bootstrap_scaled_from_chunk": True,
    }
    total = 0.0
    for name, kernel in (("null", null_kernel), ("alt", alt_kernel)):
        theta0 = jnp.asarray(kernel.get_parameter_vector(), dtype=dtype)
        # early_stop is protassov_lrt's production default: the chunk's
        # step loop stops once no sim improved its best loglike by >0.01
        # for 50 consecutive steps (the DRW null plateaus near step ~130;
        # the alt runs its full budget)
        runner = _make_batched_max_loglike(
            kernel, tt, n_steps, walkers, dtype=dtype, backend="pallas", early_stop=(0.01, 50),
        )
        exec_fn = runner.lower(jax.random.key(0), ys_j, diags_j, theta0, 0.1).compile()
        lls, _ = exec_fn(jax.random.key(0), ys_j, diags_j, theta0, 0.1)  # warmup
        lls.block_until_ready()
        start = time.perf_counter()
        lls, _ = exec_fn(jax.random.key(1), ys_j, diags_j, theta0, 0.1)
        lls.block_until_ready()
        elapsed = time.perf_counter() - start
        out[f"bootstrap_chunk_seconds_{name}"] = round(elapsed, 2)
        total += elapsed

    scale = nsims_total / chunk_sims
    out["bootstrap_10k_seconds"] = round(total * scale, 1)
    return out


def _derive_posteriors_seconds(t, y, diag, steps=4000, walkers=32):
    """Wall-clock of the production observed-fit sampler:
    derive_posteriors equivalent at N=5k, 32 walkers, 4000 steps (the
    convergence loop runs on device with one end-of-run chain fetch)."""
    from mind_the_gaps_tpu import GappyLightcurve, GPModelling
    from mind_the_gaps_tpu.kernels import DampedRandomWalk, Lorentzian

    lc = GappyLightcurve(np.asarray(t), np.asarray(y) + 10.0, np.sqrt(np.asarray(diag)))
    kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)]) + Lorentzian(
        log_S0=-1.0, log_Q=2.0, log_omega0=-2.0, bounds=[(-8, 5), (0, 6), (-5, 0)]
    )
    gp = GPModelling(lc, kernel)
    theta0 = np.asarray(gp.initial_params)
    init = gp.spread_walkers(walkers, theta0, np.array(gp.get_parameter_bounds(), dtype=object))
    # warmup run MUST use the same max_steps: the chain-buffer shape is
    # part of the segment program, so a different budget would push a
    # fresh compile into the timed region.
    # converge=False makes the "chains did not converge" warning expected
    # here — suppress it so the bench's JSON line stays the only output.
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gp.derive_posteriors(initial_chain_params=init, max_steps=steps, converge=False, seed=11)
        start = time.perf_counter()
        gp.derive_posteriors(initial_chain_params=init, max_steps=steps, converge=False, seed=12)
        elapsed = time.perf_counter() - start
    return {
        "derive_posteriors_4k_seconds": round(elapsed, 2),
        "derive_posteriors_steps": steps,
        "derive_posteriors_walkers": walkers,
    }


def _lrt_512_measured_seconds(t, nsims=512):
    """MEASURED end-to-end Protassov LRT wall-clock (not chunk-scaled):
    one real ``protassov_lrt`` call — observed fits (two models, 32
    walkers, up to 10k steps), 512 posterior-predictive simulations
    generated and refit with both kernels (12 walkers x 500 steps), the
    T statistic and p-value — on the benchmarks/lrt_10k.py scenario
    (DRW-true observed data at N=5k).  Complements the chunk-scaled
    ``bootstrap_10k_seconds`` with a measured pipeline number.
    """
    import warnings

    from mind_the_gaps_tpu import GappyLightcurve
    from mind_the_gaps_tpu.kernels import DampedRandomWalk, Lorentzian
    from mind_the_gaps_tpu.lrt import protassov_lrt

    t = np.asarray(t)
    n = len(t)
    # observed data = exact DRW(=OU) realization + noise, as in
    # benchmarks/lrt_10k.py:56-69, so both observed fits are well-posed
    rng = np.random.default_rng(0)
    rng.uniform(2.0, 8.0, n)  # keep the stream aligned with lrt_10k.py
    S0, w0 = np.exp(1.0), np.exp(-3.0)
    y = np.empty(n)
    y[0] = rng.normal(0.0, np.sqrt(S0))
    phi = np.exp(-w0 * np.diff(t))
    innov = rng.normal(0.0, np.sqrt(S0 * (1.0 - phi**2)))
    for i in range(1, n):
        y[i] = phi[i - 1] * y[i - 1] + innov[i - 1]
    dy = np.full(n, 0.3)
    y = y + 10.0 + rng.normal(0.0, dy)
    lc = GappyLightcurve(t, y, dy, exposures=1.0)

    null_kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)])
    alt_kernel = null_kernel + Lorentzian(
        log_S0=-1.0, log_Q=2.0, log_omega0=-2.0, bounds=[(-8, 5), (0, 6), (-5, 0)]
    )
    start = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        result = protassov_lrt(
            lc, null_kernel, alt_kernel, nsims=nsims, seed=0,
            observed_max_steps=10_000, observed_walkers=32,
            sim_max_steps=500, sim_walkers=12, chunk=512,
        )
    elapsed = time.perf_counter() - start
    return {
        "lrt_512_measured_seconds": round(elapsed, 1),
        "lrt_512_t_obs": round(float(result.t_obs), 3),
        "lrt_512_p_value": float(result.p_value),
    }


def _e13_generation_rate(n_points=500, B=256):
    """Lognormal (E13) posterior-predictive generation rate at the
    tutorial-scale segment (~6.6k fine samples -> 8192 pow2 cut):
    the non-Gaussian bootstrap's generation-side cost."""
    from mind_the_gaps_tpu.kernels import DampedRandomWalk
    from mind_the_gaps_tpu.simulator import Simulator

    rng = np.random.default_rng(0)
    t = np.cumsum(rng.uniform(4.0, 9.0, n_points))
    kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-3.0)
    theta0 = kernel.get_parameter_vector()
    sim = Simulator(
        lambda w: np.asarray(kernel.get_psd(jnp.asarray(w), jnp.asarray(theta0))),
        t, exposures=1.0, mean=10.0, pdf="lognormal", extension_factor=2, max_iter=400,
    )
    omega = jnp.asarray(sim.omega)
    thetas = theta0[None, :] + 0.15 * rng.standard_normal((B, 2))

    @jax.jit
    def psd_batch(ths):
        def one(th):
            v = kernel.get_psd(omega[1:], th)
            return jnp.concatenate([jnp.zeros((1,), v.dtype), v])
        return jax.vmap(one)(ths)

    psd_b = psd_batch(jnp.asarray(thetas))
    sim.simulate_batch(jax.random.key(1), psd_b).block_until_ready()  # compile + warmup
    start = time.perf_counter()
    sim.simulate_batch(jax.random.key(2), psd_b).block_until_ready()
    elapsed = time.perf_counter() - start
    return {"e13_lognormal_lcs_per_sec": round(B / elapsed, 1)}


if __name__ == "__main__":
    main()
