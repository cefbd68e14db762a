"""p-value calibration of the Protassov LRT pipeline.

Under the null hypothesis (data generated by the null model), the
posterior-predictive LRT p-value should be ~Uniform(0, 1).  This script
runs K independent synthetic experiments end to end — fit null + alt,
simulate from the fitted null, refit both models to every simulation
(matched short-chain estimators everywhere) — and KS-tests the resulting
p-values against uniformity.

Everything is batched: the K observed fits run as one grouped program,
and all K * nsims bootstrap refits run as one grouped program.

Run: python examples/validation_pvalue_calibration.py [--k 16 --nsims 63]
"""
import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import time

import numpy as np
from scipy.stats import kstest

import jax
import jax.numpy as jnp

from mind_the_gaps_tpu.kernels import DampedRandomWalk, Lorentzian
from mind_the_gaps_tpu.lrt import fit_lightcurves_batch
from mind_the_gaps_tpu.models import psd_models
from mind_the_gaps_tpu.simulator import Simulator


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=16, help="independent experiments")
    ap.add_argument("--nsims", type=int, default=63, help="bootstrap size per experiment")
    ap.add_argument("--n", type=int, default=400, help="lightcurve points")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--walkers", type=int, default=12)
    ap.add_argument("--f32", action="store_true", default=True)
    ap.add_argument(
        "--pdf", default="Gaussian", choices=["Gaussian", "Lognormal"],
        help="flux PDF of the truth AND of the posterior-predictive bootstrap "
             "(Lognormal exercises the E13 generation path end to end)",
    )
    ap.add_argument(
        "--no-early-stop", action="store_true",
        help="disable the production plateau rule (tol=0.01, patience=50) "
             "and run every refit for the full fixed step budget",
    )
    args = ap.parse_args()
    early_stop = None if args.no_early_stop else (0.01, 50)

    dtype = jnp.float32 if args.f32 else None
    rng = np.random.default_rng(0)
    t0_all = time.time()

    # --- common observing pattern and truth ---------------------------- #
    n = args.n
    times = np.cumsum(rng.uniform(2.0, 8.0, n))
    sigma = 0.3
    true_S0, true_w0 = 4.0, 0.05

    null_kernel = DampedRandomWalk(np.log(true_S0), np.log(true_w0), bounds=[(-5, 8), (-8, 2)])
    alt_kernel = DampedRandomWalk(np.log(true_S0), np.log(true_w0), bounds=[(-5, 8), (-8, 2)]) + Lorentzian(
        -1.0, 2.0, -1.5, bounds=[(-8, 5), (0, 6), (-5, 0)]
    )

    def check_e13_impl(s, label):
        """Report the E13 cut length the generation ran at."""
        print(f"E13 generation for {label}: cut length {getattr(s, '_e13_cut_len', None)}")

    # --- K observed datasets from the null truth ----------------------- #
    if args.pdf == "Gaussian":
        # exact GP draw (dense Cholesky): unambiguous Gaussian ground truth
        tau = np.abs(times[:, None] - times[None, :])
        K_true = np.array(null_kernel.covariance(tau)) + np.diag(np.full(n, sigma**2))
        L = np.linalg.cholesky(K_true)
        ys_obs = 10.0 + (L @ rng.normal(size=(n, args.k))).T  # (K, n)
    else:
        # lognormal-flux truth: the simulator's own E13 surrogate process
        sim_obs = Simulator(
            psd_models.BendingPowerlaw(S0=true_S0, omega0=true_w0),
            times, 1.0, 10.0, args.pdf, sigma_noise=sigma, extension_factor=2,
            random_state=11,
        )
        psd_true = np.asarray(sim_obs._psd_values())
        psd_rep = jnp.asarray(np.broadcast_to(psd_true, (args.k, len(psd_true))).copy())
        clean = sim_obs.simulate_batch(jax.random.key(40), psd_rep)
        check_e13_impl(sim_obs, "observed truth draws")
        ys_obs = np.asarray(clean) + rng.normal(0.0, sigma, (args.k, n))
    dys_obs = np.full((args.k, n), sigma)

    # --- observed fits (both models), batched over K ------------------- #
    th0_null = null_kernel.get_parameter_vector()
    th0_alt = alt_kernel.get_parameter_vector()
    ll0_obs, best_null = fit_lightcurves_batch(
        jax.random.key(1), null_kernel, times, ys_obs, dys_obs, th0_null,
        walkers=args.walkers, n_steps=args.steps, dtype=dtype,
        early_stop=early_stop,
    )
    ll1_obs, _ = fit_lightcurves_batch(
        jax.random.key(2), alt_kernel, times, ys_obs, dys_obs, th0_alt,
        walkers=args.walkers, n_steps=args.steps, dtype=dtype,
        early_stop=early_stop,
    )
    T_obs = -2.0 * (ll0_obs.astype(float) - ll1_obs.astype(float))
    print(f"observed fits done ({time.time()-t0_all:.0f}s); T_obs median {np.median(T_obs):.2f}")

    # --- simulate nsims lightcurves per dataset from the fitted nulls -- #
    sim = Simulator(
        psd_models.BendingPowerlaw(S0=true_S0, omega0=true_w0),
        times, 1.0, 10.0, args.pdf, sigma_noise=sigma, extension_factor=2,
        random_state=3,
    )
    omega = jnp.asarray(sim.omega)

    def psd_for(theta):
        vals = null_kernel.get_psd(omega[1:], jnp.asarray(theta))
        return jnp.concatenate([jnp.zeros((1,), dtype=vals.dtype), vals])

    psd_batch = jax.vmap(psd_for)(jnp.asarray(best_null, dtype=jnp.float64))  # (K, nf)
    psd_all = jnp.repeat(psd_batch, args.nsims, axis=0)  # (K*nsims, nf)
    rates = sim.simulate_batch(jax.random.key(4), psd_all)
    if args.pdf != "Gaussian":
        check_e13_impl(sim, "posterior-predictive bootstrap")
    noisy, dy_sim = sim.add_noise_batch(jax.random.key(5), rates)
    noisy = np.asarray(noisy)
    dy_sim = np.asarray(dy_sim)
    print(f"simulated {noisy.shape[0]} lightcurves ({time.time()-t0_all:.0f}s)")

    # --- bootstrap refits, batched over K*nsims ------------------------ #
    ll0_sim, _ = fit_lightcurves_batch(
        jax.random.key(6), null_kernel, times, noisy, dy_sim, th0_null,
        walkers=args.walkers, n_steps=args.steps, dtype=dtype, chunk=1024,
        early_stop=early_stop,
    )
    ll1_sim, _ = fit_lightcurves_batch(
        jax.random.key(7), alt_kernel, times, noisy, dy_sim, th0_alt,
        walkers=args.walkers, n_steps=args.steps, dtype=dtype, chunk=1024,
        early_stop=early_stop,
    )
    T_sim = (-2.0 * (ll0_sim.astype(float) - ll1_sim.astype(float))).reshape(args.k, args.nsims)
    print(f"bootstrap refits done ({time.time()-t0_all:.0f}s)")

    # --- p-values and uniformity --------------------------------------- #
    # with nsims sims, p = (1 + #{T_sim >= T_obs}) / (nsims + 1) is exact
    p = (1.0 + np.sum(T_sim >= T_obs[:, None], axis=1)) / (args.nsims + 1.0)
    ks = kstest(p, "uniform")
    print("\np-values:", np.array2string(np.sort(p), precision=3))
    print(f"KS vs Uniform(0,1): D = {ks.statistic:.3f}, p = {ks.pvalue:.3f}")
    print(f"total wall time {time.time()-t0_all:.0f}s")
    if ks.pvalue < 0.01:
        print("WARNING: calibration rejected at 1% — investigate")
    else:
        print("calibration OK (uniformity not rejected)")


if __name__ == "__main__":
    main()
