"""GP inference engine: the main user-facing API.

API-parity rebuild of reference mind_the_gaps/gpmodelling.py:23-539 on a
JAX accelerator stack:

- celerite.GP -> solver.semiseparable (jitted fused-scan likelihood),
- emcee.EnsembleSampler + multiprocessing.Pool -> sampler.ensemble
  (vectorized stretch move; one batched kernel per MCMC step),
- scipy L-BFGS-B MAP fit kept on host but driven by jax value_and_grad,
- generate_from_posteriors: the posterior-predictive lightcurve fan-out
  (reference Pool.map at :511-512) becomes one vmapped device program
  over all parameter draws.

Parameter vector convention: kernel parameters first, then mean-model
parameters when the mean is fitted.
"""
from __future__ import annotations

import threading
import warnings
from contextlib import nullcontext as _nullcontext
from functools import partial
from typing import List, Optional, Tuple

import numpy as np
from scipy.optimize import minimize

import jax
import jax.numpy as jnp

from mind_the_gaps_tpu.lightcurves import GappyLightcurve
from mind_the_gaps_tpu.models.mean_models import (
    ConstantModel,
    GaussianModel,
    LinearModel,
    MeanModel,
)
from mind_the_gaps_tpu.ops import gpu_kernel_available
from mind_the_gaps_tpu.sampler.autocorr import (
    integrated_autocorr_time,
    integrated_autocorr_time_masked,
)
from mind_the_gaps_tpu.sampler.ensemble import (
    sample_ensemble_grouped,
    sample_ensemble_impl,
)
from mind_the_gaps_tpu.solver import log_likelihood as solver_log_likelihood
from mind_the_gaps_tpu.solver import predict as solver_predict
from mind_the_gaps_tpu.solver import predict_at as solver_predict_at

__all__ = ["GPModelling", "AutocorrError"]

try:  # drop-in: user code catching emcee.autocorr.AutocorrError keeps working
    from emcee.autocorr import AutocorrError as _BaseAutocorrError

    _autocorr_bases = (_BaseAutocorrError, RuntimeError)
except Exception:  # emcee not installed (it is not a dependency here)
    _autocorr_bases = (RuntimeError,)


class AutocorrError(*_autocorr_bases):
    """Chain too short for a reliable autocorrelation-time estimate.

    emcee-compatible: the reference's ``get_autocorr_time`` surfaces
    ``emcee.autocorr.AutocorrError`` (reference gpmodelling.py:256 via
    emcee); this class carries the tau estimate on ``.tau`` like emcee's
    and subclasses it when emcee is importable.  Also a RuntimeError so
    pre-round-4 callers that caught that keep working.
    """

    def __init__(self, tau, *args, **kwargs):
        self.tau = tau
        Exception.__init__(self, *args, **kwargs)

# posterior-predictive generation batch cap: at 10k sims the PSD batch
# alone is ~1 GB f64.  lrt.py imports this so the host and device LRT
# paths split generation keys at the same boundaries.
GEN_CHUNK = 512


@partial(
    jax.jit, static_argnames=("log_prob_fn", "n_steps")
)
def _advance_segment(key, state, chain_buf, lp_buf, offset, t, y, diag, mean_c, *, log_prob_fn, n_steps):
    """One convergence-loop segment as a single device program: split the
    key, run ``n_steps`` stretch-move steps, write the segment into the
    preallocated chain/log-prob buffers, and compute the integrated
    autocorrelation time over the filled prefix.

    Fetching every segment to the host and re-running a host FFT tau
    estimator over the whole growing chain costs a round trip and an
    O(chain) transfer per segment; here the per-segment host traffic is
    one (D+1,)-scalar fetch and the chain is fetched ONCE at the end of
    the run.

    The data series (t, y, diag) and the unfitted-mean parameter vector
    enter as runtime OPERANDS, not trace constants: every dataset of a
    given length then reuses one compiled program (and one on-disk
    exported artifact) — with data baked in, each new lightcurve would
    pay the full segment compile.
    ``log_prob_fn`` is the data-as-arguments batcher
    (GPModelling._logprob_batch_d / _logprob_batch_fast_d).
    """

    batcher = log_prob_fn

    def log_prob_fn(thetas):  # noqa: F811 — bind the data operands
        return batcher(thetas, t, y, diag, mean_c)

    key, sub = jax.random.split(key)
    if state.ndim == 3:
        # (chains, walkers, D): C independent ensembles in one batch —
        # the buffers pool them as chains*walkers walkers (valid for
        # the walker-averaged tau estimator: independent chains are
        # independent walkers)
        chain, lps, acc, state = sample_ensemble_grouped(sub, log_prob_fn, state, n_steps)
        chain = chain.reshape(chain.shape[0], -1, chain.shape[-1])
        lps = lps.reshape(lps.shape[0], -1)
    else:
        chain, lps, acc, state = sample_ensemble_impl(sub, log_prob_fn, state, n_steps)
    zero = jnp.zeros((), dtype=offset.dtype)
    chain_buf = jax.lax.dynamic_update_slice(
        chain_buf, chain.astype(chain_buf.dtype), (offset, zero, zero)
    )
    lp_buf = jax.lax.dynamic_update_slice(lp_buf, lps.astype(lp_buf.dtype), (offset, zero))
    tau = integrated_autocorr_time_masked(chain_buf, offset + n_steps)
    return key, state, chain_buf, lp_buf, tau, acc


class ChainResult:
    """Minimal sampler-result shim exposing the pieces of
    emcee.EnsembleSampler the reference relies on (get_chain /
    get_log_prob with discard/thin/flat, iteration)."""

    def __init__(self, chain: np.ndarray, log_probs: np.ndarray):
        self._chain = chain  # (n_steps, walkers, ndim)
        self._log_probs = log_probs  # (n_steps, walkers)

    @property
    def iteration(self) -> int:
        return self._chain.shape[0]

    def get_chain(self, discard: int = 0, thin: int = 1, flat: bool = False):
        c = self._chain[discard::max(thin, 1)]
        if flat:
            return c.reshape(-1, c.shape[-1])
        return c

    def get_log_prob(self, discard: int = 0, thin: int = 1, flat: bool = False):
        lp = self._log_probs[discard::max(thin, 1)]
        if flat:
            return lp.reshape(-1)
        return lp

    def get_autocorr_time(self, tol: int = 0):
        """Integrated autocorrelation time per parameter.

        ``tol``: like emcee, when > 0 require the chain to be at least
        ``tol`` autocorrelation times long and raise ``AutocorrError``
        otherwise (emcee-compatible, carries ``.tau``; the reference
        always calls with tol=0, gpmodelling.py:256)."""
        tau = np.asarray(integrated_autocorr_time(jnp.asarray(self._chain)))
        if tol > 0:
            n = self._chain.shape[0]
            if np.any(tol * tau > n):
                raise AutocorrError(
                    tau,
                    "The chain is shorter than %d times the integrated "
                    "autocorrelation time for %d parameter(s). Use this estimate "
                    "with caution and run a longer chain!\n"
                    "N/%d = %.0f;\ntau: %s" % (tol, int(np.sum(tol * tau > n)), tol, n / tol, tau)
                )
        return tau


class GPModelling:
    """The interface for Gaussian Process modelling of a GappyLightcurve.

    Mirrors reference GPModelling (gpmodelling.py:23): fit(),
    derive_posteriors(), generate_from_posteriors(),
    standarized_residuals(), get_rstat() and the result properties.
    """

    meanmodels = ["linear", "constant", "gaussian"]

    def __init__(self, lightcurve: GappyLightcurve, kernel, mean_model: Optional[str] = None):
        self._lightcurve = lightcurve
        self.kernel = kernel
        meanmodel, fit_mean = self._build_mean_model(mean_model)
        self.mean_model = meanmodel
        self.fit_mean = fit_mean

        self._t = jnp.asarray(lightcurve.times)
        self._y = jnp.asarray(lightcurve.y)
        dy = lightcurve.dy if lightcurve.dy is not None else np.zeros(lightcurve.n)
        # celerite adds 1e-12 to dy before squaring (gpmodelling.py:54)
        self._diag_base = jnp.asarray((np.asarray(dy) + 1e-12) ** 2)

        self._nk = kernel.ndim
        self._nm = meanmodel.ndim if fit_mean else 0
        self._ndim = self._nk + self._nm

        if fit_mean:
            self.initial_params = np.concatenate(
                [kernel.get_parameter_vector(), meanmodel.get_parameter_vector()]
            )
        else:
            self.initial_params = kernel.get_parameter_vector()

        self._autocorr = []
        self._loglikelihoods = None
        self._mcmc_samples = None
        self._sampler = None
        self._tau = None
        self.converged = False
        self._key = jax.random.key(np.random.SeedSequence().entropy % (2**63))

        self._build_functions()
        # validate the kernel at the initial parameters (the reference's
        # gp.compute would raise here for an invalid kernel).  The check
        # runs through the COMPILE-FREE numpy recursion
        # (solver/numpy_ref.py, exact f64, ~0.26 s at N=5k): compiling
        # the MAP objective here cost ~10-12 s of XLA-CPU value_and_grad
        # compile per process — this environment's persistent cache can
        # not reload XLA:CPU executables across hosts, so every run paid
        # it at construction.  The MAP objective is traced/LOWERED here
        # (on the constructing thread, keeping persistent-cache keys
        # deterministic — see _segment_lower) and backend-compiled
        # lazily by fit() or concurrently via precompile_fit().
        th0 = jnp.asarray(self.initial_params, dtype=jnp.float64)
        if self._map_device is not None:
            th0 = jax.device_put(th0, self._map_device)
        self._nll_lowered = self._nll_and_grad.lower(th0)
        self._nll_exec = None
        self._nll_pending = None
        if not np.isfinite(self._numpy_loglike(np.asarray(self.initial_params, dtype=np.float64))):
            warnings.warn("GP log-likelihood is not finite at the initial parameters")

    def _numpy_loglike(self, theta) -> float:
        """One exact f64 log-likelihood evaluation with NO compile: tiny
        per-theta quantities evaluate eagerly on the local CPU backend
        and the O(N R^2) recursion runs in numpy."""
        from mind_the_gaps_tpu.solver.numpy_ref import numpy_log_likelihood

        theta = np.asarray(theta, dtype=np.float64)
        th_k = theta[: self._nk]
        try:
            cpu = jax.devices("cpu")[0]
        except RuntimeError:
            cpu = None
        ctx = jax.default_device(cpu) if cpu is not None else _nullcontext()
        with ctx:
            coeffs = tuple(np.asarray(c) for c in self.kernel.coefficients(jnp.asarray(th_k)))
            jitter = float(self.kernel.jitter(jnp.asarray(th_k)))
            t_np = np.asarray(self._lightcurve.times, dtype=np.float64)
            if self.fit_mean:
                mean = np.asarray(self.mean_model.value(jnp.asarray(t_np), jnp.asarray(theta[self._nk:])))
            else:
                mean = np.asarray(
                    self.mean_model.value(jnp.asarray(t_np), jnp.asarray(self.mean_model.get_parameter_vector()))
                )
        y = np.asarray(self._lightcurve.y, dtype=np.float64) - mean
        diag = np.asarray(self._diag_base, dtype=np.float64) + jitter
        return float(numpy_log_likelihood(coeffs, t_np, y, diag))

    # ------------------------------------------------------------------ #
    def _build_mean_model(self, meanmodel: Optional[str]) -> Tuple[MeanModel, bool]:
        """Reference heuristics (gpmodelling.py:62-124) for mean-model
        construction and initial guesses."""
        lc = self._lightcurve
        maxy = np.max(lc.y)

        if meanmodel is None:
            return ConstantModel(lc.mean, bounds=[(np.min(lc.y), maxy)]), False

        if meanmodel.lower() not in GPModelling.meanmodels:
            raise ValueError(
                "Input mean model %s not implemented! Only \n %s \n are available"
                % (meanmodel, "\t".join(GPModelling.meanmodels))
            )

        if meanmodel.lower() == "constant":
            return ConstantModel(lc.mean, bounds=[(np.min(lc.y), maxy)]), True

        if meanmodel.lower() == "linear":
            return LinearModel(0, 1.5, bounds=[(None, None), (None, None)]), True

        # gaussian
        sigma_guess = lc.duration / 2
        amplitude_guess = (maxy - np.min(lc.y)) * np.sqrt(2 * np.pi) * sigma_guess
        mean_guess = lc.times[len(lc.times) // 2]
        meanmodel_obj = GaussianModel(
            mean_guess,
            sigma_guess,
            amplitude_guess,
            bounds=[
                (lc.times[0], lc.times[-1]),
                (0, lc.duration),
                (maxy * np.sqrt(2 * np.pi) * lc.duration, 50 * maxy * np.sqrt(2 * np.pi) * lc.duration),
            ],
        )
        return meanmodel_obj, True

    # ------------------------------------------------------------------ #
    def _build_functions(self):
        kernel = self.kernel
        mean_model = self.mean_model
        fit_mean = self.fit_mean
        nk = self._nk
        t = self._t
        y = self._y
        diag_base = self._diag_base
        mean_const = (
            None if fit_mean else jnp.asarray(mean_model.get_parameter_vector())
        )

        def split(theta):
            return theta[:nk], theta[nk:]

        def loglike(theta):
            th_k, th_m = split(theta)
            mean = mean_model.value(t, th_m if fit_mean else mean_const)
            coeffs = kernel.coefficients(th_k)
            diag = diag_base + kernel.jitter(th_k)
            return solver_log_likelihood(coeffs, t, y - mean, diag)

        def log_prior(theta):
            th_k, th_m = split(theta)
            lp = kernel.log_prior(th_k)
            if fit_mean:
                lp = lp + mean_model.log_prior(th_m)
            return lp

        def log_prob(theta):
            lp = log_prior(theta)
            ll = loglike(theta)
            return jnp.where(jnp.isfinite(lp), lp + ll, -jnp.inf)

        # batch-native log-prob: thetas (W, D) -> (W,), batch axis last
        # (solver/batched.py layout).  The
        # ``_d`` variants take the data series (t, y, diag) and the
        # unfitted-mean parameter vector as runtime ARGUMENTS — the
        # sampler programs built on them are then shared by every
        # dataset of the same length (see _advance_segment); the
        # closure variants bind this instance's data for single-eval use.
        from mind_the_gaps_tpu.solver.batched import batched_log_likelihood

        def log_prob_batch_d(thetas, t_a, y_a, diag_a, mean_c):
            th_k = thetas[:, :nk]
            coeffs = jax.vmap(kernel.coefficients)(th_k)
            lp = jax.vmap(kernel.log_prior)(th_k)
            jitter = jax.vmap(kernel.jitter)(th_k)
            if fit_mean:
                th_m = thetas[:, nk:]
                means = jax.vmap(lambda tm: mean_model.value(t_a, tm))(th_m)  # (W, N)
                lp = lp + jax.vmap(mean_model.log_prior)(th_m)
            else:
                means = mean_model.value(t_a, mean_c)  # (N,) shared
                means = jnp.broadcast_to(means, (thetas.shape[0], t_a.shape[0]))
            ll = batched_log_likelihood(
                coeffs, t_a, y_a, diag_a, mean=means, extra_diag=jitter
            )
            return jnp.where(jnp.isfinite(lp), lp + ll, -jnp.inf)

        # f32 fast sampler path: likelihoods through the GPU kernel
        # (ops/pallas_celerite.py).  For an unfitted constant mean the
        # data series is shared across the batch; for fitted mean models
        # each walker subtracts its OWN mean curve and the per-walker
        # residuals go in as per-element (B, N) data.  ``mesh`` splits
        # the kernel call over the devices (derive_posteriors mesh mode).
        def log_prob_batch_fast_d(thetas, t_a, y_a, diag_a, mean_c, mesh=None):
            from mind_the_gaps_tpu.ops import pallas_log_likelihood

            th32 = thetas.astype(jnp.float32)
            coeffs = jax.vmap(kernel.coefficients)(th32[:, :nk])
            lp = jax.vmap(kernel.log_prior)(th32[:, :nk])
            jitter = jax.vmap(kernel.jitter)(th32[:, :nk])
            y32 = y_a.astype(jnp.float32)
            d32 = diag_a.astype(jnp.float32)
            if fit_mean:
                th_m = th32[:, nk:]
                t32 = t_a.astype(jnp.float32)
                means = jax.vmap(lambda tm: mean_model.value(t32, tm))(th_m)  # (B, N)
                lp = lp + jax.vmap(mean_model.log_prior)(th_m)
                ll = pallas_log_likelihood(
                    coeffs, t_a, y32[None, :] - means, d32, extra_diag=jitter, mesh=mesh,
                )
            else:
                const = mean_model.value(t_a[:1], mean_c)[0].astype(jnp.float32)
                mean_b = jnp.full((thetas.shape[0],), const, dtype=jnp.float32)
                ll = pallas_log_likelihood(
                    coeffs, t_a, y32, d32, mean=mean_b, extra_diag=jitter, mesh=mesh,
                )
            return jnp.where(jnp.isfinite(lp), lp + ll, -jnp.inf)

        mean_c0 = jnp.asarray(mean_model.get_parameter_vector(), dtype=jnp.float64)
        self._mean_c = mean_c0
        self._loglike_fn = loglike
        self._logprob_fn = log_prob
        self._loglike_jit = jax.jit(loglike)
        self._logprob_jit = jax.jit(log_prob)
        self._logprob_batch_d = jax.jit(log_prob_batch_d)
        self._logprob_batch_fast_d = jax.jit(log_prob_batch_fast_d)
        self._log_prob_batch_fast_d_fn = log_prob_batch_fast_d
        self._fast_batchers = {}
        self._logprob_batch = jax.jit(
            lambda thetas: log_prob_batch_d(thetas, t, y, diag_base, mean_c0)
        )
        self._logprob_batch_fast = jax.jit(
            lambda thetas: log_prob_batch_fast_d(thetas, t, y, diag_base, mean_c0)
        )
        self._segment_execs = {}
        self._recompute_execs = {}
        self._segment_lock = threading.Lock()

        # The MAP fit is a host-driven scipy L-BFGS-B loop: every
        # objective evaluation is one O(N) scan plus a host<->device
        # round trip.  The objective is sequential, single-sample work,
        # so when the default backend is not CPU, value_and_grad runs on
        # the local CPU backend with CPU-resident copies of the data
        # (exact f64; the sampler stays on the accelerator).
        nll = lambda th: -loglike(th)
        self._nll_and_grad = jax.jit(jax.value_and_grad(nll))
        if jax.default_backend() != "cpu":
            try:
                cpu = jax.devices("cpu")[0]
                t_c = jax.device_put(t, cpu)
                y_c = jax.device_put(y, cpu)
                d_c = jax.device_put(diag_base, cpu)

                def loglike_cpu(theta):
                    th_k, th_m = split(theta)
                    mean = mean_model.value(t_c, th_m if fit_mean else mean_const)
                    coeffs_l = kernel.coefficients(th_k)
                    diag = d_c + kernel.jitter(th_k)
                    return solver_log_likelihood(coeffs_l, t_c, y_c - mean, diag)

                self._map_device = cpu
                self._loglike_map_fn = loglike_cpu
                self._nll_and_grad = jax.jit(
                    jax.value_and_grad(lambda th: -loglike_cpu(th))
                )
            except RuntimeError:
                self._map_device = None
                self._loglike_map_fn = loglike
        else:
            self._map_device = None
            self._loglike_map_fn = loglike

    # ------------------------------------------------------------------ #
    def get_parameter_bounds(self) -> List[Tuple[float, float]]:
        bounds = list(self.kernel.get_parameter_bounds())
        if self.fit_mean:
            bounds += list(self.mean_model.get_parameter_bounds())
        return bounds

    @property
    def parameter_names(self):
        names = ["kernel:" + n for n in self.kernel.get_parameter_names()]
        if self.fit_mean:
            names += ["mean:" + n for n in self.mean_model.get_parameter_names()]
        return tuple(names)

    def set_parameter_vector(self, theta) -> None:
        """Set kernel (+ mean) parameters from a flat vector — the
        equivalent of the reference's gp.set_parameter_vector."""
        theta = np.asarray(theta, dtype=float)
        self.kernel.set_parameter_vector(theta[: self._nk])
        if self.fit_mean:
            self.mean_model.set_parameter_vector(theta[self._nk :])

    def get_parameter_vector(self) -> np.ndarray:
        if self.fit_mean:
            return np.concatenate(
                [self.kernel.get_parameter_vector(), self.mean_model.get_parameter_vector()]
            )
        return self.kernel.get_parameter_vector()

    def _log_probability(self, params) -> float:
        """Scalar log-posterior (host convenience, reference
        gpmodelling.py:127-152)."""
        return float(self._logprob_jit(jnp.asarray(params, dtype=jnp.float64)))

    def _neg_log_like(self, params) -> float:
        return -float(self._loglike_jit(jnp.asarray(params, dtype=jnp.float64)))

    # ------------------------------------------------------------------ #
    def _nll_exec_fn(self):
        """The compiled MAP objective: joins a pending precompile_fit()
        compile, else compiles the module lowered at construction."""
        if self._nll_exec is None:
            pending, self._nll_pending = self._nll_pending, None
            if pending is not None:
                pending.result()
            if self._nll_exec is None:
                self._nll_exec = self._nll_lowered.compile()
        return self._nll_exec

    def precompile_fit(self, executor):
        """Backend-compile the MAP objective (lowered at construction)
        on a worker thread — pure compile, no tracing, so it is safe to
        run concurrently (see _segment_lower)."""

        def work():
            try:
                ex = self._nll_lowered.compile()
                if self._nll_exec is None:
                    self._nll_exec = ex
            except Exception:
                pass  # fit() re-attempts and surfaces the error

        self._nll_pending = executor.submit(work)
        return self._nll_pending

    def fit(self, initial_params=None):
        """MAP fit with L-BFGS-B under the parameter bounds
        (reference gpmodelling.py:172-194), with exact jax gradients."""
        if initial_params is None:
            initial_params = self.initial_params
        nll_and_grad = self._nll_exec_fn()

        def fun(x):
            if self._map_device is not None:
                xj = jax.device_put(np.asarray(x, dtype=float), self._map_device)
            else:
                xj = jnp.asarray(x)
            v, g = nll_and_grad(xj)
            v = float(v)
            g = np.asarray(g, dtype=float)
            if not np.isfinite(v):
                return 1e25, np.zeros_like(g)
            return v, np.where(np.isfinite(g), g, 0.0)

        bounds = [
            (None if not np.isfinite(lo) else lo, None if not np.isfinite(hi) else hi)
            for lo, hi in ((float(b[0]), float(b[1])) for b in self.get_parameter_bounds())
        ]
        return minimize(fun, np.asarray(initial_params, dtype=float), jac=True, method="L-BFGS-B", bounds=bounds)

    def fit_device(self, initial_params=None, max_iters: int = 200, tol: float = 1e-10):
        """MAP fit entirely on device: optax L-BFGS (zoom linesearch)
        under one jitted ``while_loop``, iterates projected into the
        parameter box.

        The scipy ``fit()`` is the reference-parity path (true L-BFGS-B)
        and pays one host round trip per objective evaluation; this
        variant runs the entire optimization as a single program.  Returns
        (params (ndim,), nll value) as numpy/float.
        """
        import optax
        import optax.tree_utils as otu

        if initial_params is None:
            initial_params = self.initial_params
        bounds = np.array(
            [(-np.inf if b[0] is None else b[0], np.inf if b[1] is None else b[1])
             for b in ((float(x[0]), float(x[1])) for x in self.get_parameter_bounds())]
        )
        # runs where the MAP objective runs (the CPU backend when the
        # default device is an accelerator, see _build_functions)
        dev = self._map_device
        lo = jnp.asarray(bounds[:, 0])
        hi = jnp.asarray(bounds[:, 1])
        if dev is not None:
            lo = jax.device_put(lo, dev)
            hi = jax.device_put(hi, dev)
        loglike = self._loglike_map_fn

        def nll(theta):
            v = -loglike(theta)
            return jnp.where(jnp.isfinite(v), v, jnp.asarray(1e25, v.dtype))

        opt = optax.lbfgs()
        value_and_grad = optax.value_and_grad_from_state(nll)

        def step(carry):
            params, state, _ = carry
            value, grad = value_and_grad(params, state=state)
            updates, state = opt.update(
                grad, state, params, value=value, grad=grad, value_fn=nll
            )
            new_params = jnp.clip(optax.apply_updates(params, updates), lo, hi)
            delta = jnp.max(jnp.abs(new_params - params))
            return new_params, state, delta

        def cond(carry):
            _, state, delta = carry
            it = otu.tree_get(state, "count")
            return (it < max_iters) & (delta > tol)

        @jax.jit
        def run(theta0):
            state = opt.init(theta0)
            params, state, _ = jax.lax.while_loop(
                cond, step, (theta0, state, jnp.asarray(jnp.inf, theta0.dtype))
            )
            return params, nll(params)

        theta0 = np.clip(np.asarray(initial_params, dtype=np.float64), bounds[:, 0], bounds[:, 1])
        theta0 = jnp.asarray(theta0) if dev is None else jax.device_put(theta0, dev)
        params, value = run(theta0)
        return np.asarray(params), float(value)

    # ------------------------------------------------------------------ #
    def spread_walkers(self, walkers, parameters, bounds, percent=0.1, max_attempts=20, rng=None):
        """Gaussian ball around ``parameters`` clipped into bounds;
        faithful to reference gpmodelling.py:289-350 (including the
        1.05x/0.95x clamping of persistent out-of-bounds walkers).

        ``rng``: optional ``np.random.Generator``.  The reference draws
        from the global numpy RNG (gpmodelling.py:307), which makes even
        seeded runs irreproducible (and, with the LRT's threaded
        observed fits, interleaving-dependent); derive_posteriors passes
        a generator derived from its ``seed`` so seeded runs are exactly
        reproducible.  Default None keeps the reference's global-RNG
        behavior."""
        if percent < 0 or percent > 1:
            raise ValueError("The 'percent' parameter must be between 0 and 1 (inclusive).")
        draw = rng.normal if rng is not None else np.random.normal
        parameters = np.asarray(parameters, dtype=float)
        std = np.abs(parameters) * percent
        initial_samples = draw(parameters, std, size=(walkers, len(parameters)))
        bounds = np.array(
            [
                (-np.inf if lower is None else lower, np.inf if upper is None else upper)
                for lower, upper in bounds
            ]
        )
        factors_lower = np.where(bounds[:, 0] > 0, 1.05, 0.95)
        factors_upper = np.where(bounds[:, 1] > 0, 0.95, 1.05)

        for i in range(walkers):
            attempt = 0
            for attempt in range(max_attempts):
                if np.all(
                    np.logical_and(bounds[:, 0] <= initial_samples[i], initial_samples[i] <= bounds[:, 1])
                ):
                    break
                initial_samples[i] = draw(parameters, std)
            if attempt == max_attempts - 1:
                warnings.warn("Some walkers are out of bounds! Setting them to values close to the bounds")
                out_lower = initial_samples[i] < bounds[:, 0]
                out_upper = initial_samples[i] > bounds[:, 1]
                initial_samples[i][out_lower] = (bounds[:, 0] * factors_lower)[out_lower]
                initial_samples[i][out_upper] = (bounds[:, 1] * factors_upper)[out_upper]
        return initial_samples

    # ------------------------------------------------------------------ #
    @staticmethod
    def _shard_tag(a):
        """Short description of a (non-trivial) array sharding: sharding
        is part of a compiled program's signature, so the mesh-sharded
        segment programs must memoize separately from the single-device
        ones (derive_posteriors mesh mode)."""
        s = getattr(a, "sharding", None)
        if s is None or not hasattr(s, "spec"):
            return ""
        try:
            return str(s.spec)
        except Exception:  # pragma: no cover
            return "?"

    def _segment_sig(self, fast: bool, n_steps: int, state, chain_buf):
        return (
            bool(fast), int(n_steps), state.shape, chain_buf.shape,
            str(chain_buf.dtype), self._shard_tag(state), self._shard_tag(chain_buf),
        )

    def _segment_lower(self, fast: bool, n_steps: int, key, state, chain_buf, lp_buf, mesh=None):
        """Trace+lower one segment program (no backend compile).

        Kept separate from the compile so callers can lower on the MAIN
        thread: lowering mutates global symbol counters (inner jits like
        the log-prob batcher land in the module as e.g.
        ``log_prob_batch_fast_154``), so a program traced while OTHER
        threads are tracing gets order-dependent symbol names — and the
        persistent compilation cache hashes the serialized module, so a
        racy trace produces a key that never matches across processes
        (every "warm" LRT run recompiled its big programs until lowering
        was serialized).

        For the XLA (f64) segment, warm processes skip even the trace:
        the traced program persists as an on-disk exported artifact
        (program_cache.py).  The data series rides as runtime operands
        (_advance_segment), so the artifact (and compiled executable) is
        keyed on model STRUCTURE and shapes only — any dataset of the
        same length reuses it."""
        from mind_the_gaps_tpu.program_cache import lower_via_cache

        args = (key, state, chain_buf, lp_buf, jax.ShapeDtypeStruct((), jnp.int32)) + self._seg_data_avals()
        if fast:
            # the kernel's Triton call cannot be exported: lower directly
            return _advance_segment.lower(
                *args, log_prob_fn=self._fast_batcher(mesh), n_steps=int(n_steps)
            )
        sig = f"advance_segment|steps={int(n_steps)}|{self._structure_signature()}"
        return lower_via_cache(
            sig, _advance_segment, args,
            static_kwargs=dict(log_prob_fn=self._logprob_batch_d, n_steps=int(n_steps)),
        )

    def _fast_batcher(self, mesh=None):
        """The fast path's log-prob batcher, with the kernel call split
        over ``mesh`` when one is given (memoized: the batcher is a
        static argument of the segment program)."""
        if mesh is None:
            return self._logprob_batch_fast_d
        fn = self._fast_batchers.get(mesh)
        if fn is None:
            fn = jax.jit(partial(self._log_prob_batch_fast_d_fn, mesh=mesh))
            self._fast_batchers[mesh] = fn
        return fn

    def _seg_data(self):
        """The loop-invariant data operands of the sampler programs."""
        return (self._t, self._y, self._diag_base, self._mean_c)

    def _seg_data_avals(self):
        return tuple(jax.ShapeDtypeStruct(a.shape, a.dtype) for a in self._seg_data())

    def _structure_signature(self) -> str:
        """Stable description of the model STRUCTURE this instance's
        traced programs close over — kernel term classes/bounds and the
        mean model.  The data series and mean constants are runtime
        operands, so two models with equal structure trace
        byte-equivalent programs for equal shapes and share compiled
        executables and on-disk artifacts (program_cache.py)."""
        import hashlib

        h = hashlib.sha256()
        h.update(repr([type(t).__name__ for t in self.kernel.terms]).encode())
        h.update(repr(self.kernel.get_parameter_names()).encode())
        h.update(repr([(float(lo), float(hi)) for lo, hi in np.asarray(
            [(b[0] if b[0] is not None else -np.inf, b[1] if b[1] is not None else np.inf)
             for b in self.kernel.get_parameter_bounds()], dtype=np.float64)]).encode())
        h.update(type(self.mean_model).__name__.encode())
        h.update(repr(bool(self.fit_mean)).encode())
        if self.fit_mean:
            h.update(repr([(float(lo) if lo is not None else None, float(hi) if hi is not None else None)
                           for lo, hi in self.mean_model.get_parameter_bounds()]).encode())
        return h.hexdigest()

    def _recompute_lower(self, rows: int = 4096):
        """Lower the fast path's end-of-run f64 recompute program (one
        padded ``rows``-row batch through the XLA f64 log-prob); loads a
        pre-traced on-disk artifact when one matches (program_cache.py)."""
        from mind_the_gaps_tpu.program_cache import lower_via_cache

        args = (jax.ShapeDtypeStruct((rows, self._ndim), jnp.float64),) + self._seg_data_avals()
        sig = f"recompute|{rows}|{self._ndim}|{self._structure_signature()}"
        return lower_via_cache(sig, self._logprob_batch_d, args)

    def _recompute_exec(self, rows: int = 4096):
        """AOT executable of the f64 recompute, memoized per row count.

        derive_posteriors runs on worker threads in the LRT; going
        through the ``jax.jit`` dispatch there would TRACE the program on
        a racy thread (see ``_segment_lower`` on why that defeats the
        persistent compilation cache)."""
        with self._segment_lock:
            ex = self._recompute_execs.get(rows)
            if ex is None:
                ex = self._recompute_lower(rows).compile()
                self._recompute_execs[rows] = ex
        return ex

    def precompile_recompute(self, executor, rows: int = 4096):
        """Lower the f64 recompute on the calling thread, compile on a
        worker (same split and rationale as ``precompile_sampler``)."""
        try:
            lowered = self._recompute_lower(rows)
        except Exception:
            return None

        def work():
            try:
                ex = lowered.compile()
                with self._segment_lock:
                    self._recompute_execs.setdefault(rows, ex)
            except Exception:
                pass

        return executor.submit(work)

    def _segment_exec(self, fast: bool, n_steps: int, key, state, chain_buf, lp_buf, mesh=None):
        """AOT executable of one convergence-loop segment, memoized per
        (path, n_steps, buffer shape/dtype/sharding).  Compiling ahead of
        time lets ``precompile_sampler`` start this compile on a worker
        thread before the MAP fit finishes."""
        sig = self._segment_sig(fast, n_steps, state, chain_buf)
        with self._segment_lock:
            seg = self._segment_execs.get(sig)
            if seg is None:
                seg = self._segment_lower(fast, n_steps, key, state, chain_buf, lp_buf, mesh).compile()
                self._segment_execs[sig] = seg
        return seg

    def _segment_mesh_ok(self, mesh, lead: int) -> bool:
        """Mesh mode shards the leading chain axis (walkers, or chains
        when running multi-chain lanes); it needs that axis to divide
        the device count."""
        return mesh is not None and getattr(mesh, "size", 1) > 1 and lead % mesh.size == 0

    def _segment_shardings(self, mesh, state_ndim: int):
        from jax.sharding import NamedSharding, PartitionSpec as P

        ax = tuple(mesh.axis_names)[0]
        return (
            NamedSharding(mesh, P(ax, *([None] * (state_ndim - 1)))),
            NamedSharding(mesh, P(None, ax, None)),
            NamedSharding(mesh, P(None, ax)),
        )

    def precompile_sampler(
        self,
        executor,
        max_steps: int = 10000,
        convergence_steps: int = 500,
        walkers: int = 12,
        fast: Optional[bool] = None,
        mesh=None,
    ):
        """Start the derive_posteriors segment-program compile on a
        worker thread: firing this at pipeline entry hides the compile
        behind the MAP fit and any other cold compiles.  A failed
        compile here is re-attempted (and raised) by derive_posteriors.

        The trace/lower step runs on the CALLING thread (see
        ``_segment_lower``: racy traces embed order-dependent symbol
        names, defeating the persistent compilation cache across
        processes); only the backend compile goes to the worker."""
        if fast is None:
            fast = gpu_kernel_available()

        # dtype must match derive_posteriors' buffers (f32 on the
        # fast path) or this compiles a program the run never uses.
        # ShapeDtypeStructs, not real buffers: lowering needs avals only.
        dt = jnp.float32 if fast else jnp.float64
        key_aval = jax.eval_shape(lambda: jax.random.key(0))
        mesh_mode = self._segment_mesh_ok(mesh, walkers)
        if mesh_mode:
            # mirror derive_posteriors' mesh mode: sharding is part of
            # the compiled signature, so the dummy avals must carry it
            st_s, cb_s, lb_s = self._segment_shardings(mesh, 2)
            state = jax.ShapeDtypeStruct((walkers, self._ndim), dt, sharding=st_s)
            chain_buf = jax.ShapeDtypeStruct((max_steps, walkers, self._ndim), dt, sharding=cb_s)
            lp_buf = jax.ShapeDtypeStruct((max_steps, walkers), dt, sharding=lb_s)
        else:
            state = jax.ShapeDtypeStruct((walkers, self._ndim), dt)
            chain_buf = jax.ShapeDtypeStruct((max_steps, walkers, self._ndim), dt)
            lp_buf = jax.ShapeDtypeStruct((max_steps, walkers), dt)
        steps = min(convergence_steps, max_steps)
        sig = self._segment_sig(fast, steps, state, chain_buf)
        try:
            lowered = self._segment_lower(
                fast, steps, key_aval, state, chain_buf, lp_buf, mesh if mesh_mode else None
            )
        except Exception:
            lowered = None  # derive_posteriors re-attempts and raises

        def work():
            if lowered is None:
                return
            try:
                seg = lowered.compile()
                with self._segment_lock:
                    self._segment_execs.setdefault(sig, seg)
            except Exception:
                pass

        return executor.submit(work)

    # ------------------------------------------------------------------ #
    def derive_posteriors(
        self,
        initial_chain_params=None,
        fit: bool = True,
        converge: bool = True,
        max_steps: int = 10000,
        convergence_steps: int = 500,
        walkers: int = 12,
        cores: int = 6,  # kept for API parity; parallelism is on-device
        progress: bool = False,
        seed: Optional[int] = None,
        fast: Optional[bool] = None,
        chains: int = 1,
        mesh=None,
    ):
        """Ensemble MCMC with the reference's convergence policy
        (gpmodelling.py:197-286): every ``convergence_steps`` compute the
        autocorrelation time tau; stop once iteration > 100*tau and
        |dtau|/tau < 1%; then discard/thin by the 40tau (10tau if over
        budget) / tau/2 rules, or 5tau / tau/4 when unconverged.

        ``fast`` explores the chains in float32 through the GPU kernel
        (ops/pallas_celerite.py; all mean models: fitted means go in as
        per-walker residual series; f32 tracks f64 to <0.1 in
        log-likelihood — tests/test_mixed_precision.py) and then
        recomputes the reported log-probabilities of the thinned samples
        in float64.  Default (None): on where the kernel runs
        (``ops.gpu_kernel_available()``), the f64 XLA sampler elsewhere.
        A kernel failure is an error; there is no fallback.

        ``chains``: number of INDEPENDENT stretch-move ensembles run in
        lock-step (each of ``walkers`` walkers; proposals never cross
        ensembles).  The kernel's time per step is set by the serial
        recursion, not by the lane count, so extra chains ride along at
        little cost in the likelihood.  The pooled chain is exposed as
        chains*walkers walkers (tau averages over all of them;
        ``get_rstat`` then measures cross-ensemble mixing).
        ``initial_chain_params`` may be (chains, walkers, ndim); a
        (walkers, ndim) array with chains > 1 is an error.

        ``mesh``: optional ``jax.sharding.Mesh`` — shard the leading
        chain axis (walkers, or chains in multi-chain mode) over the
        devices, so one observed fit uses every device instead of one
        (the reference's walker Pool, gpmodelling.py:245).  The
        RNG is sharding-invariant (partitionable threefry), so the
        sampled chains are BIT-IDENTICAL to the single-device run
        (tests/test_mesh_observed_fits.py); only the walker-averaged
        tau reduction order may differ in the last ulp.  Ignored (with
        a warning) when the leading axis does not divide the device
        count.  ``protassov_lrt`` passes the default mesh when more
        than one device is present."""
        if seed is not None:
            self._key = jax.random.key(seed)
        if chains < 1:
            raise ValueError("chains must be >= 1")
        if initial_chain_params is None:
            if not fit:
                initial_params = self.initial_params
            else:
                solution = self.fit(self.initial_params)
                initial_params = solution.x
            initial_chain_params = self.spread_walkers(
                chains * walkers, initial_params,
                np.array(self.get_parameter_bounds(), dtype=object),
                rng=np.random.default_rng(seed) if seed is not None else None,
            )
            if chains > 1:
                initial_chain_params = initial_chain_params.reshape(
                    chains, walkers, -1
                )
        initial_chain_params = np.asarray(initial_chain_params, dtype=float)
        if chains > 1:
            if initial_chain_params.ndim != 3 or initial_chain_params.shape[0] != chains:
                raise ValueError(
                    "with chains > 1, initial_chain_params must have shape (chains, walkers, ndim)"
                )
            walkers = initial_chain_params.shape[1]
        else:
            if initial_chain_params.ndim == 3:
                chains = initial_chain_params.shape[0]
                walkers = initial_chain_params.shape[1]
            else:
                walkers = initial_chain_params.shape[0]
        pooled = chains * walkers

        if fast is None:
            fast = gpu_kernel_available()

        old_tau = np.inf
        self.converged = False
        self._autocorr = []

        # device-resident chain: the whole run writes into fixed-size
        # buffers (independent chains pooled as chains*walkers walkers),
        # the convergence check is one fused device program per segment
        # (sampler scan + masked autocorr) with a (D+1,)-scalar fetch,
        # and the chain crosses to the host ONCE at the end.
        #
        # The fast path runs the ENTIRE segment program in float32 — not
        # just the likelihood kernel — so the walker state, proposals and
        # buffers match the kernel's precision.  Parameter values at f32
        # (~1e-7 relative) are far below MCMC noise; reported
        # log-probabilities are recomputed in f64 below, and the fetched
        # chain is exposed as float64 for API parity.
        seg_dtype = jnp.float32 if fast else jnp.float64
        state = jnp.asarray(initial_chain_params, dtype=seg_dtype)
        chain_buf = jnp.zeros((max_steps, pooled, self._ndim), dtype=seg_dtype)
        lp_buf = jnp.zeros((max_steps, pooled), dtype=seg_dtype)
        seg_mesh = None
        if mesh is not None:
            if self._segment_mesh_ok(mesh, state.shape[0]):
                st_s, cb_s, lb_s = self._segment_shardings(mesh, state.ndim)
                state = jax.device_put(state, st_s)
                chain_buf = jax.device_put(chain_buf, cb_s)
                lp_buf = jax.device_put(lp_buf, lb_s)
                seg_mesh = mesh
            else:
                warnings.warn(
                    "derive_posteriors mesh mode needs the leading chain axis "
                    f"({state.shape[0]}) to divide the device count "
                    f"({getattr(mesh, 'size', 1)}); running unsharded"
                )

        def dispatch(carry, iteration, steps):
            seg = self._segment_exec(fast, steps, *carry, mesh=seg_mesh)
            return seg(*carry, jnp.asarray(iteration, dtype=jnp.int32), *self._seg_data())

        # Speculative segment pipelining: segment k+1 is dispatched
        # BEFORE segment k's tau scalars are fetched, so the device
        # never idles through the per-segment host roundtrip.  Results are bitwise identical to the
        # sequential loop: the speculative segment consumes exactly the
        # RNG stream / buffers the sequential loop would have given it,
        # and if the convergence check stops at k its outputs are simply
        # dropped (functional arrays — nothing was overwritten).
        carry = (self._key, state, chain_buf, lp_buf)
        iteration = 0
        tau = np.full(self._ndim, np.inf)
        steps = min(convergence_steps, max_steps)
        out = dispatch(carry, iteration, steps)
        while True:
            iteration += steps
            next_out = None
            if iteration < max_steps:
                steps_next = min(convergence_steps, max_steps - iteration)
                next_out = dispatch(out[:4], iteration, steps_next)
            tau = np.asarray(out[4])
            self._autocorr.append(np.mean(tau))
            if progress:
                print(f"step {iteration}/{max_steps} (accept {float(out[5]):.2f})", flush=True)

            if (
                np.all(tau * 100 < iteration)
                and np.all(np.abs(old_tau - tau) / tau < 0.01)
                and converge
            ):
                if progress:
                    print("Convergence reached after %d samples!" % iteration)
                self.converged = True
                break
            old_tau = tau
            if next_out is None:
                break
            steps = steps_next
            out = next_out

        key, state, chain_buf, lp_buf = out[:4]
        self._key = key
        # sharding of the final device buffers, kept for introspection
        # (dryrun_multichip / tests assert the mesh really partitioned
        # the segment program end to end before the host fetch below)
        self._last_segment_sharding = (
            tuple(chain_buf.shape), getattr(chain_buf, "sharding", None)
        )
        # float64 on fetch: API parity with emcee's f64 chains (the f32
        # fast path's values are preserved exactly; reported loglikes are
        # f64-recomputed below)
        sampler = ChainResult(
            np.asarray(chain_buf[:iteration], dtype=np.float64),
            np.asarray(lp_buf[:iteration], dtype=np.float64),
        )
        self._tau = tau
        mean_tau = np.mean(tau)
        if not np.isfinite(mean_tau):
            warnings.warn("Autocorrelation time is not finite (stuck chains?); using conservative burn-in")
            mean_tau = sampler.iteration / 10.0
            self._tau = np.where(np.isfinite(tau), tau, sampler.iteration)

        if not self.converged:
            warnings.warn(f"The chains did not converge after {sampler.iteration} iterations!")
            thin = max(int(mean_tau / 4), 1)
            discard = int(mean_tau) * 5
        else:
            discard = int(mean_tau * 40)
            if discard > max_steps:
                discard = int(mean_tau * 10)
            thin = max(int(mean_tau / 2), 1)
        discard = min(discard, sampler.iteration - 1)

        self._loglikelihoods = sampler.get_log_prob(discard=discard, thin=thin, flat=True)
        self._mcmc_samples = sampler.get_chain(discard=discard, thin=thin, flat=True)
        if fast and len(self._mcmc_samples):
            # report f64 log-probabilities at the f32-explored samples;
            # every chunk is padded to the same 4096-row shape so the
            # whole recompute reuses ONE compiled executable regardless
            # of how the thin/discard policy landed
            flat = np.asarray(self._mcmc_samples, dtype=np.float64)
            m = flat.shape[0]
            chunk = 4096
            pad = (-m) % chunk
            if pad:
                flat = np.concatenate([flat, np.broadcast_to(flat[:1], (pad, flat.shape[1]))])
            ex = self._recompute_exec(chunk)
            data = self._seg_data()
            out = []
            for start in range(0, flat.shape[0], chunk):
                out.append(np.asarray(ex(jnp.asarray(flat[start : start + chunk]), *data)))
            self._loglikelihoods = np.concatenate(out)[:m]
        self._sampler = sampler

    # ------------------------------------------------------------------ #
    def standarized_residuals(self, include_noise: bool = True, parameters=None):
        """(y - mu)/sqrt(var) at the training points (Kelly+2011 Eq. 49;
        reference gpmodelling.py:353-370).  Set ``parameters`` (or rely on
        the kernel's current vector) before calling."""
        theta = (
            np.asarray(parameters, dtype=float)
            if parameters is not None
            else np.concatenate(
                [self.kernel.get_parameter_vector()]
                + ([self.mean_model.get_parameter_vector()] if self.fit_mean else [])
            )
        )
        th_k = jnp.asarray(theta[: self._nk])
        th_m = (
            jnp.asarray(theta[self._nk:])
            if self.fit_mean
            else jnp.asarray(self.mean_model.get_parameter_vector())
        )
        mean = self.mean_model.value(self._t, th_m)
        coeffs = self.kernel.coefficients(th_k)
        jitter = self.kernel.jitter(th_k)
        diag = self._diag_base + jitter
        mu_res, var = solver_predict(coeffs, self._t, self._y - mean, diag)
        pred_mean = mu_res + mean
        # predict() returns the noise-free variance s - s^2 Kinv; convert
        # to the GP predictive variance at the training points:
        # var_gp = k(0) - ks Kinv ks = var  (same quantity)
        pred_var = var
        if include_noise:
            pred_var = pred_var + jitter
        std_res = (np.asarray(self._y) - np.asarray(pred_mean)) / np.sqrt(np.asarray(pred_var))
        return std_res

    def loo_residuals(self, parameters=None):
        """Exact leave-one-out standardized residuals: alpha_n /
        sqrt((K^-1)_nn) with alpha = K^-1 (y - mean), via the O(N R^2)
        selected inverse.

        Under the correct model these are ~ N(0, 1) *exactly* — unlike
        ``standarized_residuals`` (the reference's formula,
        gpmodelling.py:353-370), which divides by the GP predictive
        standard deviation: that residual's true variance is
        s^2 (K^-1)_nn, not s - s^2 (K^-1)_nn, so its KS-vs-normal
        diagnostic is miscalibrated (under-dispersed when noise <<
        signal, over-dispersed when noise >> signal).  Model selection
        (selection.compare_models) therefore tests THESE residuals."""
        from mind_the_gaps_tpu.solver.semiseparable import (
            build_matrices,
            factor,
            inverse_diag,
            solve,
        )

        theta = (
            np.asarray(parameters, dtype=float)
            if parameters is not None
            else self.get_parameter_vector()
        )
        th_k = jnp.asarray(theta[: self._nk])
        th_m = (
            jnp.asarray(theta[self._nk:])
            if self.fit_mean
            else jnp.asarray(self.mean_model.get_parameter_vector())
        )
        mean = self.mean_model.value(self._t, th_m)
        coeffs = self.kernel.coefficients(th_k)
        diag = self._diag_base + self.kernel.jitter(th_k)
        m = build_matrices(coeffs, self._t, diag)
        D, W, _ = factor(m)
        alpha = solve(m, D, W, self._y - mean)
        kinv = inverse_diag(m, D, W)
        return np.asarray(alpha) / np.sqrt(np.asarray(kinv))

    def predict(self, t_pred=None, parameters=None, return_var: bool = True, include_noise: bool = False):
        """GP predictive mean (and variance) at ``t_pred`` (defaults to the
        training times) — the celerite ``gp.predict`` API used for
        plotting model curves in the reference's notebooks."""
        theta = (
            np.asarray(parameters, dtype=float)
            if parameters is not None
            else self.get_parameter_vector()
        )
        th_k = jnp.asarray(theta[: self._nk])
        th_m = (
            jnp.asarray(theta[self._nk:])
            if self.fit_mean
            else jnp.asarray(self.mean_model.get_parameter_vector())
        )
        mean_train = self.mean_model.value(self._t, th_m)
        coeffs = self.kernel.coefficients(th_k)
        jitter = self.kernel.jitter(th_k)
        diag = self._diag_base + jitter
        if t_pred is None:
            mu_res, var = solver_predict(coeffs, self._t, self._y - mean_train, diag)
            mu = np.asarray(mu_res + mean_train)
            var = np.asarray(var)
        else:
            t_pred = np.asarray(t_pred, dtype=float)
            mean_pred = self.mean_model.value(jnp.asarray(t_pred), th_m)
            out = solver_predict_at(
                coeffs, self._t, self._y - mean_train, diag, t_pred, return_var=return_var
            )
            if return_var:
                mu = np.asarray(out[0] + mean_pred)
                var = np.asarray(out[1])
            else:
                return np.asarray(out + mean_pred)
        if not return_var:
            return mu
        if include_noise:
            var = var + float(jitter)
        return mu, var

    def get_rstat(self, burnin: Optional[int] = None):
        """Gelman-Rubin-style ratio per walker/parameter (faithful to the
        reference's formula at gpmodelling.py:373-403)."""
        if self._sampler is None:
            raise ValueError(
                "Posteriors have not been derived. Please run derive_posteriors prior to populate the attributes."
            )
        if burnin is None:
            burnin = int(np.mean(self.tau)) * 10
        samples = self._sampler.get_chain(discard=burnin)
        within_chain_variances = np.var(samples, axis=0)
        flat = self._sampler.get_chain(flat=True, discard=burnin)
        between_chain_variances = np.var(flat, axis=0)
        return within_chain_variances / between_chain_variances[np.newaxis, :]

    # ------------------------------------------------------------------ #
    @property
    def loglikelihoods(self):
        if self._loglikelihoods is None:
            raise AttributeError(
                "Posteriors have not been derived. Please run derive_posteriors prior to populate the attributes."
            )
        return self._loglikelihoods

    @property
    def autocorr(self):
        return self._autocorr

    @property
    def sampler(self):
        if self._loglikelihoods is None:
            raise AttributeError(
                "Posteriors have not been derived. Please run derive_posteriors prior to populate the attributes."
            )
        return self._sampler

    @property
    def mcmc_samples(self):
        if self._mcmc_samples is None:
            raise AttributeError(
                "Posteriors have not been derived. Please run derive_posteriors prior to populate the attributes."
            )
        return self._mcmc_samples

    @property
    def max_loglikelihood(self):
        if self._loglikelihoods is None:
            raise AttributeError(
                "Posteriors have not been derived. Please run derive_posteriors prior to populate the attributes."
            )
        return np.max(self._loglikelihoods)

    @property
    def max_parameters(self):
        if self._mcmc_samples is None:
            raise AttributeError(
                "Posteriors have not been derived. Please run derive_posteriors prior to populate the attributes."
            )
        return self._mcmc_samples[np.argmax(self._loglikelihoods)]

    @property
    def median_parameters(self):
        if self._mcmc_samples is None:
            raise AttributeError(
                "Posteriors have not been derived. Please run derive_posteriors prior to populate the attributes."
            )
        return np.median(self._mcmc_samples, axis=0)

    @property
    def k(self) -> int:
        return self._ndim

    @property
    def tau(self):
        if self._mcmc_samples is None:
            raise AttributeError(
                "Posteriors have not been derived. Please run derive_posteriors prior to populate the attributes."
            )
        return self._tau

    # ------------------------------------------------------------------ #
    # checkpoint / resume (the reference persists intermediates between
    # pipeline stages as .dat files, docs/workflow.md:43-92; here the
    # full sampler state round-trips through one npz)
    # ------------------------------------------------------------------ #
    def save_posteriors(self, path: str) -> None:
        """Persist the full MCMC state (chain, log-probs, tau, thinned
        samples) to an .npz checkpoint."""
        if self._sampler is None:
            raise RuntimeError("Posteriors have not been derived; nothing to save.")
        np.savez_compressed(
            path,
            chain=self._sampler._chain,
            log_probs=self._sampler._log_probs,
            tau=self._tau,
            converged=np.asarray(self.converged),
            autocorr=np.asarray(self._autocorr),
            mcmc_samples=self._mcmc_samples,
            loglikelihoods=self._loglikelihoods,
        )

    def load_posteriors(self, path: str) -> None:
        """Restore sampler state saved by save_posteriors."""
        data = np.load(path)
        self._sampler = ChainResult(data["chain"], data["log_probs"])
        self._tau = data["tau"]
        self.converged = bool(data["converged"])
        self._autocorr = list(data["autocorr"])
        self._mcmc_samples = data["mcmc_samples"]
        self._loglikelihoods = data["loglikelihoods"]

    # ------------------------------------------------------------------ #
    def generate_from_posteriors(
        self,
        nsims: int = 10,
        cpus: int = 8,  # API parity; the fan-out is on-device
        pdf: str = "Gaussian",
        extension_factor: int = 2,
        sigma_noise=None,
        seed: Optional[int] = None,
    ):
        """Posterior-predictive lightcurves, batched on device
        (reference gpmodelling.py:478-539).

        Returns a list of GappyLightcurve like the reference.
        """
        if self._mcmc_samples is None:
            raise RuntimeError(
                "Posteriors have not been derived. Please run derive_posteriors prior to calling this method."
            )
        if nsims >= len(self._mcmc_samples):
            warnings.warn(
                "The number of simulation requested (%d) is higher than the number of posterior samples (%d), so many samples will be drawn more than once"
                % (nsims, len(self._mcmc_samples))
            )
        rates, dy = self.generate_batch_from_posteriors(
            nsims, pdf=pdf, extension_factor=extension_factor, sigma_noise=sigma_noise, seed=seed
        )
        times = self._lightcurve.times
        return [GappyLightcurve(times, np.asarray(r), np.asarray(e)) for r, e in zip(rates, dy)]

    def _generate_lc_from_params(self, parameters, simulator) -> GappyLightcurve:
        """Generate one lightcurve from one posterior draw (API parity
        with reference gpmodelling.py:515-539; the batched path above is
        the production route)."""
        th_k = jnp.asarray(np.asarray(parameters, dtype=float)[: self._nk])
        simulator.psd_model = lambda w: self.kernel.get_psd(w, th_k)
        rates = simulator.generate_lightcurve()
        noisy_rates, dy = simulator.add_noise(rates)
        return GappyLightcurve(self._lightcurve.times, noisy_rates, dy)

    def make_device_generator(
        self,
        pdf: str = "Gaussian",
        extension_factor: int = 2,
        sigma_noise=None,
    ):
        """Build the device-resident posterior-predictive generator:
        ``gen(k_sim, k_noise, thetas (B, D)) -> (rates (B, n), dy (B, n))``
        as DEVICE arrays — the core of ``generate_batch_from_posteriors``
        without the per-chunk host fetch, so the LRT pipeline can feed
        simulations straight into the batched fitter without a host round
        trip of the (nsims, n) arrays)."""
        simulator = self._lightcurve.get_simulator(
            self.kernel.get_psd, pdf, sigma_noise=sigma_noise, extension_factor=extension_factor
        )
        omega = jnp.asarray(simulator.omega)
        nk = self._nk
        kernel = self.kernel

        @jax.jit
        def psd_batch(thetas):
            def one(theta):
                vals = kernel.get_psd(omega[1:], theta[:nk])
                return jnp.concatenate([jnp.zeros((1,), dtype=vals.dtype), vals])

            return jax.vmap(one)(thetas)

        def gen(k_sim, k_noise, thetas):
            psd_values = psd_batch(jnp.asarray(thetas))
            # non-convergence counts accumulate device-side; the caller
            # reports once at the end of the run (gen.report_nonconverged)
            # so the chunk loop stays sync-free
            rates = simulator.simulate_batch(k_sim, psd_values, warn_nonconverged=False)
            return simulator.add_noise_batch(k_noise, rates)

        if pdf.lower() == "gaussian":
            # the whole TK95 chunk (PSD eval -> spectral draw -> cut ->
            # downsample -> noise) fuses into ONE device program: one
            # dispatch per chunk, since the Gaussian path has no
            # data-dependent host loop (E13's lock-step while-loop keeps
            # its internal chunking).
            #
            # The lightcurve mean is a runtime OPERAND of the simulator
            # pipeline (core.py simulate_batch) and the generator takes
            # it as an explicit argument here, so the compiled program
            # (a ~6 MB executable, the last per-dataset compile of a
            # multi-lightcurve pipeline) is shared by every dataset
            # with this observing pattern.
            mean_value = jnp.asarray(simulator.mean, dtype=jnp.float64)

            @jax.jit
            def gen_m(k_sim, k_noise, thetas, mean_v):
                psd_values = psd_batch(jnp.asarray(thetas))
                rates = simulator.simulate_batch(k_sim, psd_values, mean=mean_v)
                return simulator.add_noise_batch(k_noise, rates)

            def gen_bound(k_sim, k_noise, thetas, mean_v=None):
                return gen_m(
                    k_sim, k_noise, thetas,
                    mean_value if mean_v is None else mean_v,
                )

            gen_bound.lower = lambda k1, k2, th: gen_m.lower(
                k1, k2, th, jax.ShapeDtypeStruct((), jnp.float64)
            )
            gen_bound.report_nonconverged = lambda warn=True: 0  # no E13 loop
            return gen_bound

        # non-Gaussian: the generation stays a host-chunked loop around
        # the vmapped E13 program; expose the entry precompile so the LRT
        # can overlap the batched PSD evaluation's compile (a (B, n_freq)
        # f64 program the Gaussian path fuses into gen_m) with the
        # observed fits.  Lowers stay on the caller's thread (cache-key
        # determinism, lrt.py entry notes); only backend compiles go to
        # the pool.
        ndim = self._ndim

        def _warn_on_fail(name):
            # a pool-side compile failure would otherwise be swallowed
            # and the lazy compile silently reappear mid-pipeline
            def cb(fut):
                exc = fut.exception()
                if exc is not None:
                    warnings.warn(
                        f"entry precompile of the {name} program failed "
                        f"({type(exc).__name__}: {exc}); it will compile "
                        "lazily on first dispatch"
                    )

            return cb

        def _precompile(executor, B=None, mesh=None):
            futs = []
            if B is not None:
                # mirror the runtime sharding: the LRT
                # shards the theta draws over the mesh, and sharding is
                # part of the compiled signature — an unsharded dummy
                # would seed a program the real batch-sharded call never
                # hits (and the big lazy compile would return)
                if mesh is not None and B % mesh.size == 0:
                    from jax.sharding import NamedSharding, PartitionSpec as P

                    sharding = NamedSharding(mesh, P(tuple(mesh.axis_names)[0], None))
                    th_aval = jax.ShapeDtypeStruct((B, ndim), jnp.float64, sharding=sharding)
                else:
                    th_aval = jax.ShapeDtypeStruct((B, ndim), jnp.float64)
                try:
                    psd_lowered = psd_batch.lower(th_aval)
                except Exception:
                    psd_lowered = None
                if psd_lowered is not None:
                    fut = executor.submit(psd_lowered.compile)
                    fut.add_done_callback(_warn_on_fail("batched PSD"))
                    futs.append(fut)
            return futs

        gen.precompile = _precompile
        gen.report_nonconverged = simulator.report_nonconverged
        return gen

    def generate_batch_from_posteriors(
        self,
        nsims: int,
        pdf: str = "Gaussian",
        extension_factor: int = 2,
        sigma_noise=None,
        seed: Optional[int] = None,
    ):
        """Array-returning batched version: (nsims, n) rates and errors."""
        if seed is not None:
            self._key = jax.random.key(seed)
        self._key, k_pick, k_sim, k_noise = jax.random.split(self._key, 4)

        idx = np.asarray(
            jax.random.randint(k_pick, (nsims,), 0, len(self._mcmc_samples))
        )
        param_samples = np.asarray(self._mcmc_samples)[idx]

        gen = self.make_device_generator(
            pdf, extension_factor=extension_factor, sigma_noise=sigma_noise
        )
        gen_chunk = GEN_CHUNK
        k_sims = jax.random.split(k_sim, max(1, -(-nsims // gen_chunk)))
        k_noises = jax.random.split(k_noise, len(k_sims))
        noisy_out, dy_out = [], []
        for ci, start in enumerate(range(0, nsims, gen_chunk)):
            noisy, dy = gen(
                k_sims[ci], k_noises[ci], param_samples[start : start + gen_chunk]
            )
            noisy_out.append(np.asarray(noisy))
            dy_out.append(np.asarray(dy))
        gen.report_nonconverged()  # one end-of-run E13 non-convergence warning
        return np.concatenate(noisy_out), np.concatenate(dy_out)
