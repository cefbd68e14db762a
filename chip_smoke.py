#!/usr/bin/env python3
"""Smoke run of the main path on a GPU:  python3 chip_smoke.py

Drives the Protassov LRT of benchmarks/lrt_10k.py (N=5,000, DRW null vs
DRW+Lorentzian alternative, seed 0) through the public entry points, and
checks every result against the repo's plain f64 reference.  One
process, one card.  Phases, each printed with its wall time:

1. kernel_parity   — the Pallas-Triton kernel as compiled for the card
   vs the f64 XLA scan: f32 max |dlogL| < 0.5 (grouped 512x6 lanes at
   N=5,000, shared 16 lanes, R=6 at N=10,000); f64 relative error
   <= 1e-8 on the same shapes.
2. kernel_timing   — one bootstrap half-update (3,072 lanes) and a
   65,536-lane sweep, kernel vs XLA's scan (benchmarks/kernel_vs_xla.py).
3. lognormal       — 512 lognormal (E13) lightcurves at N=5,000 and one
   jitted ``lax.sort_key_val`` at (128, 65536) f32.
4. map_fit         — the MAP fit with its objective on the host CPU (the
   default) and on the GPU.
5. derive_posteriors — one observed fit; its reported maximum matches
   the f64 solver at the maximizing parameters.
6. lrt             — ``protassov_lrt`` with 1,023 sims (two full
   512-row chunks with the observed row): t_obs and p.
7. chunk_refit     — one null+alt 512-sim chunk refit, and the compiled
   chunk program's ``memory_analysis()``.
8. gpu_tests       — ``pytest tests/test_gpu_onchip.py -m gpu`` in this
   process.

``--devices 4`` runs only the four-card phase: the same seeded LRT on
one card and on four (each in its own child process; this process stays
off JAX), ``fit_lightcurves_batch`` with and without the mesh, and a
check that each card holds and computes only its own shard.

Exits non-zero, with no result line, when JAX finds no GPU or any phase
fails.  The last line is one JSON object naming the device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
F32_TOL = 0.5  # max |dlogL|, f32 kernel vs f64 scan (tests/test_gpu_onchip.py)
F64_RTOL = 1e-8  # the celerite parity contract
OBSERVED_MAX_STEPS = 4000
LRT_NSIMS = 1023


def _smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable: {exc}"


def _benchmarks():
    """Make benchmarks/ importable (the scenario and the timing code)."""
    path = os.path.join(HERE, "benchmarks")
    if path not in sys.path:
        sys.path.insert(0, path)


def _scenario(n_points=5000):
    _benchmarks()
    from lrt_10k import scenario

    return scenario(n_points)


# ---------------------------------------------------------------------- #
# phases: each returns a dict of results and raises on a failed check
# ---------------------------------------------------------------------- #
def kernel_parity(n_points=5000, groups=512, repeats=6, shared_lanes=16, r6_points=10000, r6_groups=64):
    import jax
    import jax.numpy as jnp

    from mind_the_gaps_tpu.kernels import DampedRandomWalk, Lorentzian, RealTerm
    from mind_the_gaps_tpu.ops import pallas_log_likelihood
    from mind_the_gaps_tpu.solver.batched import batched_log_likelihood

    drw_qpo = DampedRandomWalk(1.0, -3.0) + Lorentzian(-1.0, 2.0, -2.0)
    r6 = RealTerm(0.5, -1.0) + RealTerm(-0.5, -2.0) + Lorentzian(-1.0, 2.0, -2.0) + Lorentzian(-0.5, 1.0, -1.0)
    cases = [
        ("grouped", drw_qpo, n_points, groups, repeats),
        ("shared", drw_qpo, n_points, 0, shared_lanes),
        ("R6_grouped", r6, r6_points, r6_groups, 4),
    ]
    out = {}
    for name, kernel, n, g, reps in cases:
        rng = np.random.default_rng(len(name))
        t = np.cumsum(rng.uniform(2.0, 8.0, n))
        lanes = g * reps if g else reps
        if g:
            y = jnp.asarray(rng.normal(10.0, 2.0, (g, n)))
            d = jnp.full((g, n), 0.09)
            mean = jnp.repeat(jnp.mean(y, axis=1), reps)
            rep = reps
        else:
            y = jnp.asarray(rng.normal(10.0, 2.0, n))
            d = jnp.full((n,), 0.09)
            mean = jnp.full((lanes,), jnp.mean(y))
            rep = 1
        theta0 = kernel.get_parameter_vector()
        co = jax.vmap(kernel.coefficients)(jnp.asarray(theta0 + 0.05 * rng.normal(size=(lanes, theta0.size))))
        ref = np.asarray(jax.jit(lambda c, y, d, m: batched_log_likelihood(c, t, y, d, mean=m, repeats=rep))(co, y, d, mean))
        run = jax.jit(lambda c, y, d, m: pallas_log_likelihood(c, t, y, d, mean=m, repeats=rep))
        ll64 = np.asarray(run(co, y, d, mean))
        c32 = jax.tree.map(lambda x: x.astype(jnp.float32), co)
        ll32 = np.asarray(run(c32, y.astype(jnp.float32), d.astype(jnp.float32), mean.astype(jnp.float32)))
        if not np.all(np.isfinite(ref)):
            raise AssertionError(f"{name}: non-finite f64 reference")
        e32 = float(np.max(np.abs(ll32 - ref)))
        e64 = float(np.max(np.abs(ll64 - ref) / np.abs(ref)))
        print(f"  {name}: {lanes} lanes N={n}  f32 max|dlogL| {e32:.4g} (tol {F32_TOL})  "
              f"f64 max rel {e64:.3g} (tol {F64_RTOL})", flush=True)
        if not e32 < F32_TOL or not e64 <= F64_RTOL:
            raise AssertionError(f"{name}: kernel outside tolerance (f32 {e32}, f64 {e64})")
        out[name] = {"lanes": lanes, "n_points": n, "f32_max_abs": e32, "f64_max_rel": e64}
    return out


def kernel_timing(half_lanes=3072, sweep_lanes=65536, n_points=5000, unrolls=(1, 8)):
    _benchmarks()
    from kernel_vs_xla import likelihood_batch

    half = likelihood_batch(half_lanes, n_points=n_points, unrolls=unrolls)
    sweep = likelihood_batch(sweep_lanes, n_points=n_points, repeats=8, unrolls=unrolls[:1], reps=3)
    for name, r in (("half-update", half), ("sweep", sweep)):
        xla = "  ".join(f"xla unroll{u} {r[f'xla_unroll{u}_ms']:.3f} ms" for u in (1, 8) if f"xla_unroll{u}_ms" in r)
        print(f"  {name} {r['lanes']} lanes N={r['n_points']} f32: kernel {r['kernel_ms']:.3f} ms  {xla}", flush=True)
    return {"half_update": half, "sweep": sweep}


def lognormal(n_points=5000, sims=512, sort_shape=(128, 65536)):
    import jax
    import jax.numpy as jnp

    lc, null_kernel, _ = _scenario(n_points)
    sim = lc.get_simulator(null_kernel.get_psd, "Lognormal", extension_factor=2)
    omega = jnp.asarray(sim.omega)
    theta0 = null_kernel.get_parameter_vector()
    thetas = jnp.asarray(theta0 + 0.05 * np.random.default_rng(0).normal(size=(sims, theta0.size)))
    psd = jax.jit(jax.vmap(lambda th: jnp.concatenate([jnp.zeros((1,)), null_kernel.get_psd(omega[1:], th)])))(thetas)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # E13 non-convergence is counted below
        t0 = time.perf_counter()
        sim.simulate_batch(jax.random.key(1), psd, warn_nonconverged=False).block_until_ready()
        first = time.perf_counter() - t0
        sim.report_nonconverged(warn=False)
        t0 = time.perf_counter()
        rates = sim.simulate_batch(jax.random.key(2), psd, warn_nonconverged=False)
        rates.block_until_ready()
        dt = time.perf_counter() - t0
        nonconv = sim.report_nonconverged(warn=False)
    rates = np.asarray(rates)
    if rates.shape != (sims, lc.n) or not np.all(np.isfinite(rates)) or not np.all(rates > 0):
        raise AssertionError("lognormal generation: bad shape or non-positive/non-finite rates")

    # one E13 iteration is a c64 rfft/irfft pair and two sorts (argsort
    # + the key-sort remap); time each at the loop's lock-step shape,
    # and count the iterations of one chunk
    rows = min(sim._e13_chunk_default(), sims)
    _, iters = jax.vmap(sim._pipeline, in_axes=(0, 0, None))(
        jax.random.split(jax.random.key(4), rows), psd[:rows], jnp.float64(sim.mean)
    )
    iters = np.asarray(iters)
    keys = jax.random.normal(jax.random.key(3), sort_shape, jnp.float32)
    vals = jnp.broadcast_to(jnp.arange(sort_shape[-1], dtype=jnp.int32), sort_shape)

    def spectral(x):
        return jnp.fft.irfft(jnp.abs(jnp.fft.rfft(x, axis=-1)), n=x.shape[-1], axis=-1)

    def median_ms(fn, *args):
        jax.block_until_ready(fn(*args))
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            times.append(time.perf_counter() - t0)
        return float(np.median(times)) * 1e3

    sort_ms = median_ms(jax.jit(lambda k, v: jax.lax.sort_key_val(k, v, dimension=-1)), keys, vals)
    argsort_ms = median_ms(jax.jit(lambda k: jnp.argsort(-k, axis=-1)), keys)
    fft_ms = median_ms(jax.jit(spectral), keys)
    print(f"  E13 cut {sim._e13_cut_len}: {sims} lognormal lcs in {dt:.3f} s = {sims / dt:.1f} lcs/s "
          f"(first call {first:.1f} s; {nonconv} hit max_iter)", flush=True)
    print(f"  one {rows}-row chunk: E13 iterations mean {iters.mean():.1f}, max {iters.max()}", flush=True)
    print(f"  at {sort_shape} f32: lax.sort_key_val {sort_ms:.3f} ms, argsort {argsort_ms:.3f} ms, "
          f"rfft+irfft {fft_ms:.3f} ms", flush=True)
    return {"e13_cut": int(sim._e13_cut_len), "lcs_per_s": sims / dt, "nonconverged": nonconv,
            "iters_mean": float(iters.mean()), "iters_max": int(iters.max()),
            "sort_key_val_ms": sort_ms, "argsort_ms": argsort_ms, "fft_ms": fft_ms}


def _scipy_map(value_and_grad, x0, bounds, device=None):
    import jax
    from scipy.optimize import minimize

    def fun(x):
        xj = jax.device_put(np.asarray(x, dtype=float), device)
        v, g = value_and_grad(xj)
        v, g = float(v), np.asarray(g, dtype=float)
        if not np.isfinite(v):
            return 1e25, np.zeros_like(g)
        return v, np.where(np.isfinite(g), g, 0.0)

    return minimize(fun, np.asarray(x0, dtype=float), jac=True, method="L-BFGS-B", bounds=bounds)


def map_fit(n_points=5000):
    import jax

    from mind_the_gaps_tpu.gpmodelling import GPModelling

    lc, _, alt_kernel = _scenario(n_points)
    gp = GPModelling(lc, alt_kernel)
    gp.fit()  # compiles the (host-CPU) objective
    t0 = time.perf_counter()
    sol_cpu = gp.fit()
    t_cpu = time.perf_counter() - t0
    vg = jax.jit(jax.value_and_grad(lambda th: -gp._loglike_fn(th)))
    bounds = [(None if not np.isfinite(lo) else lo, None if not np.isfinite(hi) else hi)
              for lo, hi in ((float(b[0]), float(b[1])) for b in gp.get_parameter_bounds())]
    dev = jax.devices()[0]
    _scipy_map(vg, gp.initial_params, bounds, dev)  # compile
    t0 = time.perf_counter()
    sol_dev = _scipy_map(vg, gp.initial_params, bounds, dev)
    t_dev = time.perf_counter() - t0
    print(f"  MAP fit N={n_points}: host CPU {t_cpu:.3f} s ({sol_cpu.nfev} evals, nll {sol_cpu.fun:.6f}); "
          f"{dev.platform} {t_dev:.3f} s ({sol_dev.nfev} evals, nll {sol_dev.fun:.6f})", flush=True)
    if abs(sol_cpu.fun - sol_dev.fun) > 1e-3 * max(1.0, abs(sol_cpu.fun)):
        raise AssertionError("MAP fit on the host CPU and on the device disagree")
    return {"cpu_s": t_cpu, "cpu_evals": int(sol_cpu.nfev), "device_s": t_dev,
            "device_evals": int(sol_dev.nfev), "nll_cpu": float(sol_cpu.fun), "nll_device": float(sol_dev.fun)}


def derive_posteriors(n_points=5000, max_steps=2000, walkers=32):
    import jax.numpy as jnp

    from mind_the_gaps_tpu.gpmodelling import GPModelling
    from mind_the_gaps_tpu.solver import log_likelihood

    lc, _, alt_kernel = _scenario(n_points)
    gp = GPModelling(lc, alt_kernel)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # a bounded chain may stop unconverged
        t0 = time.perf_counter()
        gp.derive_posteriors(max_steps=max_steps, walkers=walkers, seed=1)
        dt = time.perf_counter() - t0
    lls = np.asarray(gp.loglikelihoods)
    if not np.all(np.isfinite(lls)):
        raise AssertionError("derive_posteriors: non-finite log-likelihoods")
    th = jnp.asarray(np.asarray(gp.max_parameters, dtype=np.float64))
    y = np.asarray(lc.y)
    ll_ref = float(log_likelihood(
        alt_kernel.coefficients(th), jnp.asarray(lc.times), jnp.asarray(y - y.mean()),
        jnp.asarray((np.asarray(lc.dy) + 1e-12) ** 2) + alt_kernel.jitter(th),
    ))
    err = abs(float(gp.max_loglikelihood) - ll_ref)
    print(f"  {walkers} walkers x {gp.sampler.iteration} steps in {dt:.2f} s (converged {gp.converged}); "
          f"max logL {float(gp.max_loglikelihood):.6f} vs f64 solver {ll_ref:.6f}: |d| {err:.3g} (tol 1e-5)",
          flush=True)
    if err > 1e-5:
        raise AssertionError("derive_posteriors: reported maximum is not the f64 log-likelihood")
    return {"seconds": dt, "steps": int(gp.sampler.iteration), "converged": bool(gp.converged),
            "max_loglike": float(gp.max_loglikelihood), "abs_err_vs_f64": err}


def lrt(n_points=5000, nsims=LRT_NSIMS, observed_max_steps=OBSERVED_MAX_STEPS, observed_walkers=32,
        sim_max_steps=500, chunk=512, quiet=False):
    from mind_the_gaps_tpu.lrt import protassov_lrt

    lc, null_kernel, alt_kernel = _scenario(n_points)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t0 = time.perf_counter()
        res = protassov_lrt(
            lc, null_kernel, alt_kernel, nsims=nsims, observed_max_steps=observed_max_steps,
            observed_walkers=observed_walkers, sim_max_steps=sim_max_steps, chunk=chunk, seed=0,
        )
        dt = time.perf_counter() - t0
    t_dist = np.asarray(res.t_dist)
    if t_dist.shape != (nsims,) or not np.all(np.isfinite(t_dist)) or not np.isfinite(res.t_obs):
        raise AssertionError("LRT: non-finite or misshapen T statistics")
    if not 0.0 <= res.p_value <= 1.0:
        raise AssertionError(f"LRT: p-value {res.p_value} outside [0, 1]")
    if not quiet:
        print(f"  N={n_points} nsims={nsims}: t_obs {res.t_obs:.6f}  p {res.p_value:.6f}  "
              f"(posterior-chain t_obs {res.t_obs_posterior:.4f}, p {res.p_value_posterior:.4f})  "
              f"in {dt:.2f} s", flush=True)
    return {"seconds": dt, "t_obs": float(res.t_obs), "p_value": float(res.p_value), "t_dist": t_dist.tolist()}


def chunk_refit(sims=512, n_points=5000, steps=500):
    _benchmarks()
    from kernel_vs_xla import chunk_refit as _chunk

    r = _chunk(backends=("pallas",), sims=sims, n_points=n_points, steps=steps)
    print(f"  {sims} sims x 12 walkers x <= {steps} steps: null {r['pallas_null_s']:.3f} s  "
          f"alt {r['pallas_alt_s']:.3f} s  (first calls {r['pallas_null_first_call_s']:.1f} / "
          f"{r['pallas_alt_first_call_s']:.1f} s)", flush=True)
    print(f"  alt chunk program memory: {r['memory_analysis_alt']}", flush=True)
    return r


def gpu_tests():
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider", "-p", "no:randomly",
                      os.path.join(HERE, "tests", "test_gpu_onchip.py")])
    if rc != 0:
        raise AssertionError(f"gpu-marked tests failed (pytest exit {rc})")
    return {"pytest_exit": int(rc)}


# ---------------------------------------------------------------------- #
# four cards
# ---------------------------------------------------------------------- #
FOUR_LRT = dict(nsims=LRT_NSIMS, observed_max_steps=1000)
T_ATOL = 1e-3  # per-sim T, four cards vs one (same seed)


def multi_device(n_points=5000, sims=512, steps=100, lrt_kwargs=None, backend="auto"):
    """The sharded paths on every visible device: the seeded LRT,
    fit_lightcurves_batch with and without the mesh, and the per-card
    shard check."""
    import jax

    from mind_the_gaps_tpu.lrt import _ChunkFitter, fit_lightcurves_batch

    devices = jax.devices()
    n = len(devices)
    lc, _, alt_kernel = _scenario(n_points)
    rng = np.random.default_rng(5)
    ys = np.asarray(lc.y)[None, :] + rng.normal(0.0, 0.3, (sims, lc.n))
    dys = np.full((sims, lc.n), 0.3)
    theta0 = alt_kernel.get_parameter_vector()
    common = dict(walkers=12, n_steps=steps, dtype="float32", chunk=sims, backend=backend)
    ll_mesh, _ = fit_lightcurves_batch(jax.random.key(3), alt_kernel, lc.times, ys, dys, theta0, use_mesh=True, **common)
    ll_one, _ = fit_lightcurves_batch(jax.random.key(3), alt_kernel, lc.times, ys, dys, theta0, use_mesh=False, **common)
    fit_err = float(np.max(np.abs(ll_mesh - ll_one)))
    print(f"  fit_lightcurves_batch {sims} sims: mesh ({n} devices) vs one device max|dlogL| {fit_err:.3g} "
          f"(tol {T_ATOL})", flush=True)
    if fit_err > T_ATOL:
        raise AssertionError("mesh and single-device refits disagree")

    # each device holds and computes only its own shard
    fitter = _ChunkFitter(alt_kernel, lc.times, theta0, **common, use_mesh=True)
    yb, db = fitter._prep(ys, (dys + 1e-12) ** 2, None)
    lls, _ = fitter.fit_chunk(jax.random.key(4), ys, (dys + 1e-12) ** 2)
    lls.block_until_ready()
    for name, arr, shape in (("data", yb, (sims // n, lc.n)), ("result", lls, (sims // n,))):
        shards = arr.addressable_shards
        if len(shards) != n or {s.device for s in shards} != set(devices) or any(s.data.shape != shape for s in shards):
            raise AssertionError(f"{name} is not split one shard per device: {[s.data.shape for s in shards]}")
    (ex,) = fitter._execs.values()
    hlo = ex.as_text()
    local_lanes = sims // n * 6
    calls = [l for l in hlo.splitlines() if "__gpu$xla.gpu.triton" in l or "celerite_loglike" in l and "custom-call" in l]
    if jax.default_backend() == "gpu" and (not calls or not all(f"[{local_lanes}]" in l for l in calls)):
        raise AssertionError(f"kernel calls do not run on {local_lanes} local lanes: {calls[:2]}")
    print(f"  shards: data {sims // n} sims and results {sims // n} per device on {n} devices; "
          f"{len(calls)} kernel calls on {local_lanes} local lanes each", flush=True)
    out = {"fit_mesh_vs_one_max_abs": fit_err, "devices": n, "kernel_calls": len(calls)}
    out["lrt"] = lrt(n_points=n_points, quiet=True, **(lrt_kwargs or FOUR_LRT))
    return out


def _child(phase: str) -> dict:
    """Run one four-card phase in a child process and return its JSON."""
    env = dict(os.environ)
    if phase == "lrt1":
        env["CUDA_VISIBLE_DEVICES"] = env.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", phase],
                          capture_output=True, text=True, env=env, timeout=1100)
    sys.stdout.write("".join(l + "\n" for l in proc.stdout.splitlines()[:-1]))
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-6000:])
        raise RuntimeError(f"child phase {phase} failed (exit {proc.returncode})")
    return json.loads(proc.stdout.splitlines()[-1])


def _run_child(phase: str) -> None:
    import jax

    _require_gpu(jax)
    if phase == "lrt1":
        out = {"lrt": lrt(quiet=True, **FOUR_LRT)}
    else:
        out = multi_device()
    dev = jax.devices()[0]
    out["device"] = {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}
    print(json.dumps(out), flush=True)


def four_cards() -> dict:
    t0 = time.perf_counter()
    one = _child("lrt1")
    print(f"[phase lrt_one_card] {time.perf_counter() - t0:.1f} s  t_obs {one['lrt']['t_obs']:.6f}  "
          f"p {one['lrt']['p_value']:.6f}", flush=True)
    t0 = time.perf_counter()
    four = _child("multi")
    l1, l4 = one["lrt"], four["lrt"]
    t_err = float(np.max(np.abs(np.asarray(l1["t_dist"]) - np.asarray(l4["t_dist"]))))
    print(f"[phase four_cards] {time.perf_counter() - t0:.1f} s  t_obs {l4['t_obs']:.6f}  p {l4['p_value']:.6f}  "
          f"(LRT on {four['device']['count']} cards: {l4['seconds']:.1f} s, one card {l1['seconds']:.1f} s)", flush=True)
    print(f"  four vs one card: |dt_obs| {abs(l1['t_obs'] - l4['t_obs']):.3g}  |dp| {abs(l1['p_value'] - l4['p_value']):.3g}  "
          f"max|dT| {t_err:.3g} (tol {T_ATOL} on t_obs and every T; p within 1/nsims)", flush=True)
    if abs(l1["t_obs"] - l4["t_obs"]) > T_ATOL or t_err > T_ATOL or abs(l1["p_value"] - l4["p_value"]) > 1.0 / FOUR_LRT["nsims"]:
        raise AssertionError("four-card LRT does not match the one-card LRT")
    return four["device"]


# ---------------------------------------------------------------------- #
PHASES = [
    ("kernel_parity", kernel_parity),
    ("kernel_timing", kernel_timing),
    ("lognormal", lognormal),
    ("map_fit", map_fit),
    ("derive_posteriors", derive_posteriors),
    ("lrt", lrt),
    ("chunk_refit", chunk_refit),
    ("gpu_tests", gpu_tests),
]


def _require_gpu(jax) -> None:
    if jax.default_backend() != "gpu":
        raise SystemExit(f"chip_smoke: JAX found no GPU (default backend {jax.default_backend()!r})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="4: run only the four-card phase")
    ap.add_argument("--child", choices=("lrt1", "multi"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        _run_child(args.child)
        return 0
    print(_smi(), flush=True)
    if args.devices == 4:
        device = four_cards()
    else:
        import jax

        _require_gpu(jax)
        import mind_the_gaps_tpu  # noqa: F401  (x64, compile cache)

        dev = jax.devices()[0]
        device = {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}
        print(f"device: {device}", flush=True)
        for name, fn in PHASES:
            t0 = time.perf_counter()
            print(f"[phase {name}]", flush=True)
            fn()
            print(f"[phase {name}] done in {time.perf_counter() - t0:.1f} s", flush=True)
    print(_smi(), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
