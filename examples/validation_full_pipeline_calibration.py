"""p-value calibration of the ACTUAL protassov_lrt user pipeline.

validation_pvalue_calibration.py batches K experiments through the
grouped fitter programs directly — fast, but it bypasses the user-facing
orchestration (observed MCMC fits with the f32 segment programs, MAP
fits, posterior-predictive generation from the fitted null's chains,
per-chunk bootstrap, matched-estimator plumbing).  This script runs K
COMPLETE ``protassov_lrt`` calls on independent null-true datasets —
exactly what a user executes — and KS-tests the p-values against
Uniform(0,1).

Every pipeline program takes the data series as runtime operands, so
all K experiments share one compiled program set.
Run it as the release check after changes to the observed-fit path.

``--pdf lognormal`` runs the NON-GAUSSIAN pipeline end to end: the
observed datasets are drawn from the same TK95+E13 process the
bootstrap uses (null-true lognormal flux PDF from the DRW PSD, plus
Gaussian measurement noise), so the E13 generation, the GP
quasi-likelihood fits, and the matched estimator are all exercised
through the exact user path.

Run: python examples/validation_full_pipeline_calibration.py [--k 12]
     python examples/validation_full_pipeline_calibration.py --pdf lognormal
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json
import time

import numpy as np
from scipy.stats import kstest

from mind_the_gaps_tpu import GappyLightcurve
from mind_the_gaps_tpu.kernels import DampedRandomWalk, Lorentzian
from mind_the_gaps_tpu.lrt import protassov_lrt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=12, help="independent experiments")
    ap.add_argument("--nsims", type=int, default=127)
    ap.add_argument("--n", type=int, default=400)
    ap.add_argument("--observed-max-steps", type=int, default=2000)
    ap.add_argument("--observed-walkers", type=int, default=12)
    ap.add_argument("--sim-steps", type=int, default=300)
    ap.add_argument("--pdf", choices=["gaussian", "lognormal"], default="gaussian")
    ap.add_argument(
        "--seed", type=int, default=0,
        help="experiment-batch seed: offsets the observed-data draws and the "
             "per-experiment LRT seeds, so independent batches can be pooled "
             "for a higher-K uniformity test",
    )
    args = ap.parse_args()

    rng = np.random.default_rng(args.seed)
    t0_all = time.time()

    n = args.n
    times = np.cumsum(rng.uniform(2.0, 8.0, n))
    sigma = 0.3
    true_S0, true_w0 = 4.0, 0.05
    tau = np.abs(times[:, None] - times[None, :])

    null_k0 = DampedRandomWalk(np.log(true_S0), np.log(true_w0), bounds=[(-5, 8), (-8, 2)])
    if args.pdf == "gaussian":
        # exact GP draws from the closed-form covariance
        K_true = np.array(null_k0.covariance(tau)) + np.diag(np.full(n, sigma**2))
        L = np.linalg.cholesky(K_true)

        def draw_observed():
            return 10.0 + L @ rng.normal(size=n)
    else:
        # null-true LOGNORMAL data: the same TK95+E13 process the
        # bootstrap's posterior-predictive generator runs, so observed
        # and simulated lightcurves come from one family by construction
        import jax

        from mind_the_gaps_tpu.simulator import Simulator

        theta_true = null_k0.get_parameter_vector()
        sim_obs = Simulator(
            lambda w: np.asarray(null_k0.get_psd(w, theta_true)),
            times, exposures=1.0, mean=10.0, pdf="lognormal",
            extension_factor=2, random_state=7 + args.seed,
        )

        def draw_observed():
            rates = sim_obs.generate_lightcurve()
            return rates + rng.normal(0.0, sigma, n)

    ps = []
    for k in range(args.k):
        y = draw_observed()
        lc = GappyLightcurve(times, y, np.full(n, sigma), exposures=1.0)
        null_kernel = DampedRandomWalk(np.log(true_S0), np.log(true_w0), bounds=[(-5, 8), (-8, 2)])
        alt_kernel = DampedRandomWalk(np.log(true_S0), np.log(true_w0), bounds=[(-5, 8), (-8, 2)]) + Lorentzian(
            -1.0, 2.0, -1.5, bounds=[(-8, 5), (0, 6), (-5, 0)]
        )
        res = protassov_lrt(
            lc, null_kernel, alt_kernel, nsims=args.nsims,
            seed=1000 + k + 100_000 * args.seed,
            observed_max_steps=args.observed_max_steps,
            observed_walkers=args.observed_walkers,
            sim_max_steps=args.sim_steps, chunk=args.nsims + 1,
            pdf=args.pdf,
            # the observed data carry Gaussian errors of this sigma; the
            # posterior-predictive sims must use the SAME noise model
            # (default sigma_noise=None would apply Poisson noise)
            sigma_noise=sigma,
        )
        ps.append(res.p_value)
        print(f"[{time.time()-t0_all:6.0f}s] experiment {k + 1}/{args.k}: "
              f"T_obs={res.t_obs:.2f} p={res.p_value:.3f}", flush=True)

    ps = np.asarray(ps)
    ks = kstest(ps, "uniform")
    print("\np-values:", np.array2string(np.sort(ps), precision=3))
    print(f"KS vs Uniform(0,1): D = {ks.statistic:.3f}, p = {ks.pvalue:.3f}")
    print(json.dumps({
        "metric": "full_pipeline_calibration_ks_pvalue", "value": round(float(ks.pvalue), 3),
        "k": args.k, "nsims": args.nsims, "pdf": args.pdf,
        "wall_s": round(time.time() - t0_all, 1),
    }))
    if ks.pvalue < 0.01:
        print("WARNING: calibration rejected at 1% — investigate")
    else:
        print("calibration OK (uniformity not rejected)")


if __name__ == "__main__":
    main()
