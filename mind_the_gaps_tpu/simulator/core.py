"""TK95 / E13 lightcurve simulator, batched on device.

Rebuild of reference mind_the_gaps/simulator.py:25-539, redesigned around
XLA instead of translated:

- the Timmer & Koenig (1995) frequency-domain draw + irfft run on device
  (replacing pyfftw at simulator.py:92-119,386) and vmap over a batch of
  PSDs, so thousands of bootstrap lightcurves are one batched FFT kernel;
- the Emmanoulopoulos+2013 PDF adjustment is a ``lax.while_loop`` of
  rfft / phase-swap / irfft / rank-order remap (two argsorts), replacing
  the reference's Python loop (simulator.py:111-125); under vmap the loop
  runs in lock-step until every lightcurve in the batch converges;
- resampling into the observation windows ("downsample",
  simulator.py:340-367 — a Python loop over bins with argwhere) becomes a
  cumulative-sum + static index-window gather: after the random segment is
  shifted to the observation start (simulator.py:414), the fine grid's
  position relative to every exposure bin is *fixed*, so the bin windows
  are compile-time constants;
- observational noise (Poisson/Kraft/Gaussian) is applied by the batched
  models in simulator/noise.py.

The single-lightcurve ``Simulator`` class keeps the reference's API
(generate_lightcurve / add_noise / simulate_regularly_sampled /
downsample / psd_model setter), while ``simulate_batch`` exposes the pure
batched path used by the posterior-predictive bootstrap.
"""
from __future__ import annotations

import math
import warnings
from typing import Callable, Union

import numpy as np

import jax
import jax.numpy as jnp

from mind_the_gaps_tpu.simulator.noise import GaussianNoise, KraftNoise, PoissonNoise
from mind_the_gaps_tpu.simulator.regular import RegularLightcurve
from mind_the_gaps_tpu.stats import (
    create_log_normal,
    create_uniform_distribution,
    sample_pdf,
)

__all__ = [
    "Simulator",
    "TK95Simulator",
    "E13Simulator",
    "add_poisson_noise",
    "get_fft",
    "get_segment",
    "cut_random_segment",
]

_SQRT_2PI = math.sqrt(2.0 * math.pi)


# ---------------------------------------------------------------------- #
# pure device-side building blocks
# ---------------------------------------------------------------------- #
def tk95_rates(key, psd_values, n_fft: int, dt: float):
    """One TK95 realization: countrate series of length n_fft.

    psd_values: PSD evaluated at angular frequencies
    2*pi*rfftfreq(n_fft, dt)[1:], shape (n_fft//2,) ... (n_fft//2+1 - 1,).
    Normalization: counts *= sqrt(n_fft * dt * sqrt(2*pi)) (the celerite
    PSD convention, reference simulator.py:389), rate = counts / dt.
    """
    nf = n_fft // 2 + 1
    re, im = jax.random.normal(key, (2, nf), dtype=psd_values.dtype)
    amp = jnp.sqrt(0.5 * psd_values)
    # FFT in complex64: build the complex spectrum from f32 parts; the
    # draw is statistical and f32 spectral precision is ample.
    re32 = (re[1:] * amp[1:]).astype(jnp.float32)
    im32 = (im[1:] * amp[1:]).astype(jnp.float32)
    fft = jax.lax.complex(re32, im32)
    if n_fft % 2 == 0:
        fft = fft.at[-1].set(jax.lax.complex(re32[-1], jnp.float32(0.0)))
    fft = jnp.concatenate([jnp.asarray([1e6 + 0j], dtype=fft.dtype), fft])
    counts = jnp.fft.irfft(fft, n=n_fft).astype(psd_values.dtype)
    rate = counts * (math.sqrt(n_fft * dt * _SQRT_2PI) / dt)
    return rate


def _apply_rank_permutation(order, sorted_draws):
    """``out[order[i]] = sorted_draws[i]`` without a scatter: sorting
    the permutation as integer keys applies its inverse to the payload
    (bit-identical; the same trick the loop's remap uses)."""
    _, out = jax.lax.sort_key_val(order, sorted_draws, dimension=-1)
    return out


def e13_adjust(key, segment_rates, pdf: str, mean, max_iter: int, std=None, rtol=1e-4, atol=1e-8):
    """Emmanoulopoulos+2013 amplitude/rank-order iteration on a segment.

    Matches reference E13Simulator.adjust_lightcurve_pdf (simulator.py:65-131):
    target amplitudes from the TK95 segment, phases and value-ranking from
    draws of the target PDF (moment-matched to (mean, segment std) unless
    an explicit std is given).  Returns (adjusted_rates, iterations).
    """
    m = segment_rates.shape[-1]
    namp = m // 2 + 1
    sample_std = jnp.std(segment_rates) if std is None else std
    xsim = sample_pdf(key, pdf, mean, sample_std, (m,))
    # FFTs/sorts run in f32 (c64 FFTs, and f32 sorts are the loop's hot
    # op).  The spectrum provides phases and the ORDERING; the output
    # values are always a permutation of the original full-precision
    # draws.
    amplitudes_norm = jnp.abs(jnp.fft.rfft(segment_rates.astype(jnp.float32))) / namp
    # every iterate is a permutation of the initial draw, so its sorted
    # values are loop constants: one argsort per iteration, not two.
    sorted_draws = -jnp.sort(-xsim)
    sorted_draws32 = sorted_draws.astype(jnp.float32)

    def spectral_step(x32):
        phases = jnp.angle(jnp.fft.rfft(x32))
        adj = jnp.fft.irfft(amplitudes_norm * jnp.exp(1j * phases), n=m)
        order = jnp.argsort(-adj)
        # rank-order remap WITHOUT a scatter: sorting the permutation as
        # keys applies its inverse to the payload (bit-identical to the
        # scatter).
        _, xnew = jax.lax.sort_key_val(order, sorted_draws32)
        return xnew, order

    x0 = xsim.astype(jnp.float32)
    xadj, order = spectral_step(x0)

    def not_converged(state):
        xprev, xadj, order, it = state
        close = jnp.all(jnp.abs(xadj - xprev) <= atol + rtol * jnp.abs(xprev))
        return jnp.logical_and(jnp.logical_not(close), it < max_iter)

    def body(state):
        _, xadj, _, it = state
        xnew, order = spectral_step(xadj)
        return xadj, xnew, order, it + 1

    _, xadj, order, iters = jax.lax.while_loop(
        not_converged, body, (x0, xadj, order, 0)
    )
    # apply the final permutation to the full-precision draws
    out = _apply_rank_permutation(order, sorted_draws)
    return out, iters


def downsample_cumsum(segment_rates, starts, ends):
    """Mean of fine samples within each static [start, end) index window.

    Same semantics as the reference's per-bin argwhere+mean loop
    (simulator.py:358-367) but O(M + nbins) via cumulative sums.
    segment_rates may be batched (..., M).
    """
    cs = jnp.cumsum(segment_rates, axis=-1)
    cs = jnp.concatenate([jnp.zeros_like(cs[..., :1]), cs], axis=-1)
    tot = cs[..., ends] - cs[..., starts]
    counts = (ends - starts).astype(segment_rates.dtype)
    return tot / counts


# ---------------------------------------------------------------------- #
# strategy classes (API parity, reference simulator.py:25-141)
# ---------------------------------------------------------------------- #
class BaseSimulatorMethod:
    def __init__(self, mean):
        self.meanrate = mean

    def adjust_pdf(self, segment):
        raise NotImplementedError("This method should be implemented by subclasses")


class TK95Simulator(BaseSimulatorMethod):
    """Gaussian flux PDF: the TK95 series already has it; no-op."""

    def __init__(self, mean, random_state=None):
        super().__init__(mean)

    def adjust_pdf(self, segment):
        return segment


class E13Simulator(BaseSimulatorMethod):
    """Non-Gaussian flux PDFs via the E13 iteration."""

    def __init__(self, mean, pdf: str, max_iter: int = 1000, random_state=None):
        super().__init__(mean)
        if pdf not in ("lognormal", "uniform", "gaussian"):
            raise ValueError("pdf must be one of 'lognormal', 'uniform', 'gaussian'")
        self.pdf = pdf
        self.max_iter = max_iter
        if pdf == "lognormal":
            self.pdfmethod = create_log_normal
        elif pdf == "uniform":
            self.pdfmethod = create_uniform_distribution
        else:
            from scipy.stats import norm

            self.pdfmethod = norm
        self._key = jax.random.key(np.random.SeedSequence().entropy % (2**63))
        self._jitted = {}

    def _fn(self, max_iter, with_std=False):
        k = (max_iter, with_std)
        if k not in self._jitted:
            if with_std:
                self._jitted[k] = jax.jit(
                    lambda key, x, mean, std: e13_adjust(key, x, self.pdf, mean, max_iter, std=std)
                )
            else:
                self._jitted[k] = jax.jit(
                    lambda key, x, mean: e13_adjust(key, x, self.pdf, mean, max_iter)
                )
        return self._jitted[k]

    def adjust_pdf(self, segment: RegularLightcurve) -> RegularLightcurve:
        self._key, sub = jax.random.split(self._key)
        adjusted, iters = self._fn(self.max_iter)(sub, jnp.asarray(segment.countrate), self.meanrate)
        if int(iters) == self.max_iter:
            warnings.warn(
                "Lightcurve did not converge after %d iterations, PDF might be inaccurate. "
                "Try increase the maximum number of iterations" % int(iters)
            )
        return RegularLightcurve(segment.time, np.asarray(adjusted), dt=segment.dt)

    # direct equivalent of the reference's adjust_lightcurve_pdf for tests
    def adjust_lightcurve_pdf(self, lc: RegularLightcurve, pdf, max_iter: int = 400):
        self._key, sub = jax.random.split(self._key)
        adjusted, _ = self._fn(max_iter, with_std=True)(
            sub, jnp.asarray(lc.countrate), float(pdf.mean()), float(pdf.std())
        )
        return RegularLightcurve(lc.time, np.asarray(adjusted), dt=lc.dt)


# ---------------------------------------------------------------------- #
# the Simulator
# ---------------------------------------------------------------------- #
class Simulator:
    """Simulate lightcurves with a given PSD and flux PDF over a real
    observing pattern (timestamps + exposures), with noise.

    API parity with reference Simulator (simulator.py:143-420); the
    compute path is a single jitted program per instance.
    """

    def __init__(
        self,
        psd_model: Callable,
        times,
        exposures,
        mean: float,
        pdf: str = "gaussian",
        bkg_rate=None,
        bkg_rate_err=None,
        sigma_noise=None,
        aliasing_factor: float = 2,
        extension_factor: float = 10,
        epsilon: float = 1.001,
        max_iter: int = 400,
        random_state: Union[int, None] = None,
    ):
        times = np.asarray(times, dtype=float)
        if extension_factor < 1:
            raise ValueError("Extension factor must be greater than 1")
        if epsilon < 1:
            raise ValueError("Epsilon needs to be greater than 1!")
        if np.any(np.asarray(exposures) == 0):
            # reference simulator.py:203 raises the same way; add the fix
            # hint — a GappyLightcurve built without exposures (or loaded
            # from a file without an exposure column) defaults to zeros
            raise ValueError(
                "Some exposure times are 0! Simulation needs real exposure "
                "times: pass exposures= to GappyLightcurve (or load a file "
                "with an exposure column) before get_simulator/the LRT."
            )
        self._exposures = (
            np.full(len(times), exposures) if np.isscalar(exposures) else np.asarray(exposures, dtype=float)
        )

        if pdf.lower() not in ("gaussian", "lognormal", "uniform"):
            raise ValueError("%s not implemented! Currently implemented: Gaussian, Uniform or Lognormal" % pdf)
        elif pdf.lower() == "gaussian":
            self.simulator = TK95Simulator(mean)
        else:
            self.simulator = E13Simulator(mean, pdf.lower(), max_iter=max_iter)

        seed = np.random.SeedSequence(random_state).entropy % (2**63)
        self._key = jax.random.key(seed)

        self.sim_dt = float(np.min(self._exposures) / aliasing_factor)
        dt = np.diff(times)
        wrong = np.count_nonzero(dt < self.sim_dt * 0.99)
        if wrong > 0:
            raise ValueError(
                "%d timestamps differences are below the exposure integration time! "
                "Either reduce the exposure times, or space your observations" % wrong
            )

        start_time = times[0] - dt[0] / 1.99
        end_time = times[-1] + dt[-1]
        self.sim_duration = end_time - start_time
        duration = (times[-1] - times[0]) * extension_factor
        self.sim_timestamps = np.arange(
            start_time - self.sim_dt, start_time + duration + self.sim_dt, self.sim_dt
        )
        # Extend the fine grid to the next 5-smooth length: FFT libraries
        # are fast for small prime factors, while a length with a LARGE
        # prime factor can fall back to a dense O(n^2) transform (one
        # compiler turned n_fft = 99449 = 7 x 14207 into a 40 GB
        # f32[n_fft, n_fft] DFT matrix).  A slightly longer grid only
        # increases the effective extension factor (the reference's own
        # arange is approximate, simulator.py:217-238).
        from scipy.fft import next_fast_len

        n_good = next_fast_len(len(self.sim_timestamps), real=True)
        if n_good > len(self.sim_timestamps):
            self.sim_timestamps = self.sim_timestamps[0] + np.arange(n_good) * self.sim_dt
        self.fftndatapoints = len(self.sim_timestamps)
        self.pdf = pdf
        self.psd_model = psd_model
        self._times = times
        self.mean = mean
        self.max_iter = max_iter

        # noise selection (reference simulator.py:245-251)
        if sigma_noise is None:
            if bkg_rate is None or np.all(np.asarray(bkg_rate) == 0):
                self.noise = PoissonNoise(self._exposures)
            else:
                self.noise = KraftNoise(
                    self._exposures, np.asarray(bkg_rate) * self._exposures, bkg_rate_err
                )
        else:
            self.noise = GaussianNoise(self._exposures, sigma_noise)

        half_bins = self._exposures / 2 * epsilon
        self.strategy = [(time - hb, time + hb) for time, hb in zip(times, half_bins)]

        # --- static segment geometry --------------------------------- #
        # After cut_random_segment + shift, the fine grid sits at
        # t_j = strategy_start + dt/2 + j*dt regardless of the random cut
        # (reference simulator.py:412-414), so bin windows are static.
        self._segment_len = min(
            int(np.floor(self.sim_duration / self.sim_dt)) + 1, self.fftndatapoints
        )
        strategy_start = self.strategy[0][0]
        seg_times = strategy_start + self.sim_dt / 2 + np.arange(self._segment_len) * self.sim_dt
        lo = np.array([b[0] for b in self.strategy])
        hi = np.array([b[1] for b in self.strategy])
        self._win_starts = np.searchsorted(seg_times, lo, side="left").astype(np.int32)
        self._win_ends = np.searchsorted(seg_times, hi, side="left").astype(np.int32)
        self._seg_times = seg_times

        # angular frequencies for the PSD draw (reference simulator.py:490)
        self._omega = 2.0 * np.pi * np.fft.rfftfreq(self.fftndatapoints, self.sim_dt)

        self._pipeline = self._build_pipeline()

    # ------------------------------------------------------------------ #
    def __str__(self):
        return (
            f"Simulator(\n  PSD Model: {self._psd_model}\n  PDF: {self.pdf}\n)"
            f" Noise: {self.noise.name}"
        )

    @property
    def psd_model(self):
        return self._psd_model

    @psd_model.setter
    def psd_model(self, new_psd_model):
        if not callable(new_psd_model):
            raise ValueError("PSD model must be callable (e.g., a function or a kernel's get_psd).")
        self._psd_model = new_psd_model

    def set_psd_params(self, psd_params: dict):
        """Set attributes on the PSD model object (reference
        simulator.py:282-298)."""
        for par in psd_params:
            setattr(self._psd_model, par, psd_params[par])

    # ------------------------------------------------------------------ #
    def _build_pipeline(self):
        n_fft = self.fftndatapoints
        dt = self.sim_dt
        m = self._segment_len
        starts = jnp.asarray(self._win_starts)
        ends = jnp.asarray(self._win_ends)
        grid_t0 = float(self.sim_timestamps[0])
        grid_t1 = float(self.sim_timestamps[-1])
        duration = float(self.sim_duration)
        gaussian = self.pdf.lower() == "gaussian"
        pdf = self.pdf.lower()
        max_iter = self.max_iter

        # E13 fast path: cut a power-of-two window when the fine grid is
        # long enough — the E13 loop's rfft/irfft then take the radix-2
        # path instead of Bluestein.  The downsample windows only index the
        # first m samples, and the process is stationary, so adjusting
        # the slightly longer cut is statistically identical to the
        # reference's exact-m cut (simulator.py:536-539).
        m_cut = m
        if not gaussian:
            p2 = 1 << (m - 1).bit_length()
            if p2 <= n_fft:
                m_cut = p2
        self._e13_cut_len = m_cut

        def cut_segment(key, psd_values, mean_v):
            k_fft, k_cut, k_pdf = jax.random.split(key, 3)
            rate = tk95_rates(k_fft, psd_values, n_fft, dt)
            rate = rate - jnp.mean(rate) + mean_v
            # random segment (reference cut_random_segment, simulator.py:536)
            shift = jax.random.uniform(
                k_cut, (), minval=grid_t0, maxval=grid_t1 - duration, dtype=rate.dtype
            )
            k0 = jnp.ceil((shift - grid_t0) / dt).astype(jnp.int32)
            k0 = jnp.clip(k0, 0, n_fft - m_cut)
            return k_pdf, jax.lax.dynamic_slice(rate, (k0,), (m_cut,))

        # the lightcurve mean is a runtime OPERAND, not a trace constant:
        # with it baked in, every new dataset with the same observing
        # pattern recompiled the whole generation program (the mean is
        # the only data-derived value in the Gaussian pipeline — the
        # grid/window geometry depends on times/exposures alone)
        # the non-Gaussian pipeline also returns the E13 iteration count so
        # callers can surface non-convergence (the reference warns per
        # lightcurve, simulator.py:126-127; the batched path otherwise
        # clamped at max_iter silently)
        def pipeline(key, psd_values, mean_v):
            k_pdf, segment = cut_segment(key, psd_values, mean_v)
            if gaussian:
                return downsample_cumsum(segment, starts, ends)
            segment, iters = e13_adjust(k_pdf, segment, pdf, mean_v, max_iter)
            return downsample_cumsum(segment, starts, ends), iters

        self._cut_segment_fn = cut_segment
        self._starts_j, self._ends_j = starts, ends
        self._nonconv_fn = None  # jitted non-convergence accumulator
        self._nonconv_total = None  # device scalar, fetched by report_nonconverged
        return jax.jit(pipeline)

    def _psd_values(self):
        """Evaluate the PSD callable at the simulation frequencies.

        Works with numpy-based callables and with kernel ``get_psd``:
        the zero frequency is never used (reference simulator.py:494-497).
        """
        vals = np.asarray(self._psd_model(self._omega[1:]), dtype=float)
        return jnp.concatenate([jnp.zeros((1,)), jnp.asarray(vals)])

    def _next_key(self):
        self._key, sub = jax.random.split(self._key)
        return sub

    # ------------------------------------------------------------------ #
    def simulate_regularly_sampled(self) -> RegularLightcurve:
        """The long, finely-sampled TK95 lightcurve (reference
        simulator.py:369-394)."""
        rate = tk95_rates(self._next_key(), self._psd_values(), self.fftndatapoints, self.sim_dt)
        rate = np.asarray(rate)
        rate = rate - rate.mean() + self.mean
        return RegularLightcurve(self.sim_timestamps, rate, dt=self.sim_dt)

    def generate_lightcurve(self) -> np.ndarray:
        """One realization resampled onto the input timestamps
        (reference simulator.py:397-420)."""
        out = self._pipeline(
            self._next_key(), self._psd_values(), jnp.asarray(self.mean, dtype=jnp.float64)
        )
        if self.pdf.lower() != "gaussian":
            rates, iters = out
            if int(iters) >= self.max_iter:
                warnings.warn(
                    "Lightcurve did not converge after %d iterations, PDF might be "
                    "inaccurate. Try increase the maximum number of iterations"
                    % self.max_iter
                )
        else:
            rates = out
        return np.asarray(rates)

    def add_noise(self, rates):
        """Apply the configured noise model (reference simulator.py:300-338)."""
        return self.noise.add_noise(rates)

    def downsample(self, lc: RegularLightcurve) -> list:
        """Resample an arbitrary regular lightcurve into the strategy bins
        (host path; exact reference semantics simulator.py:340-367)."""
        rates = []
        for start, end in self.strategy:
            mask = (lc.time >= start) & (lc.time < end)
            rates.append(np.mean(lc.countrate[mask]) if mask.any() else np.nan)
        return rates

    # ------------------------------------------------------------------ #
    # batched path (used by GPModelling.generate_from_posteriors)
    # ------------------------------------------------------------------ #
    def _e13_chunk_default(self) -> int:
        """Lock-step chunk width for the E13 batch, by cut length.

        Wider chunks amortize dispatch at SMALL cut lengths, where the
        extra lock-step iterations (the loop runs to the chunk's slowest
        row) cost less than the saved dispatches; at LARGE cut lengths
        the FFTs and sorts fill the device and the higher lock-step
        maximum is pure waste.  Policy: ~4M resident elements per chunk,
        clamped to [128, 512].  Not yet tuned on a GPU.
        """
        m = max(int(getattr(self, "_e13_cut_len", 0) or self._segment_len), 1)
        return int(max(128, min(512, 1 << int(math.log2(max(4_194_304 // m, 1))))))

    def _accum_nonconv(self, iters, nb: int):
        """Fold one chunk's E13 iteration counts into the device-resident
        non-convergence total: rows past ``nb`` are padding.  One tiny
        jitted program — no host sync, so the chunk loop's dispatch
        pipelining is preserved (the reference's per-lightcurve warning,
        simulator.py:126-127, becomes one batched count surfaced by
        ``report_nonconverged``)."""
        if self._nonconv_fn is None:
            mi = self.max_iter

            def acc(total, it, nb_v):
                mask = jnp.arange(it.shape[0]) < nb_v
                return total + jnp.sum(jnp.where(mask, it >= mi, False))

            self._nonconv_fn = jax.jit(acc)
        if self._nonconv_total is None:
            self._nonconv_total = jnp.zeros((), jnp.int32)
        self._nonconv_total = self._nonconv_fn(
            self._nonconv_total, iters, jnp.asarray(nb, jnp.int32)
        )

    def report_nonconverged(self, warn: bool = True) -> int:
        """Number of simulated lightcurves whose E13 adjustment hit
        ``max_iter`` since the last report (one scalar fetch; warns like
        the reference's per-lightcurve message, simulator.py:126-127).
        Call after draining the batch — the LRT pipeline does this once
        at the end of the bootstrap so the per-chunk accumulation stays
        sync-free."""
        if self._nonconv_total is None:
            return 0
        count = int(self._nonconv_total)
        self._nonconv_total = None
        if count and warn:
            warnings.warn(
                "%d simulated lightcurve(s) did not converge after %d iterations, "
                "PDF might be inaccurate. Try increase the maximum number of "
                "iterations" % (count, self.max_iter)
            )
        return count

    def simulate_batch(self, key, psd_values_batch, chunk: Union[int, None] = None, mean=None,
                       warn_nonconverged: bool = True):
        """Generate B lightcurves from B PSD evaluations in one jitted,
        vmapped program: (B, n_freq) -> (B, n_times) noiseless rates.

        ``mean``: optional lightcurve mean OPERAND (defaults to the
        simulator's own); passing it as an argument keeps the compiled
        program independent of the dataset's flux level.

        Non-Gaussian PDFs run the E13 while-loop in lock-step across each
        chunk (vmap of the per-row loop; rows that converge freeze);
        ``chunk=None`` picks the width from the cut length
        (``_e13_chunk_default``).  The E13 cut is padded to a power of
        two so the loop's FFTs are radix-2 instead of Bluestein.

        A two-phase "straggler compaction" variant (bounded first pass,
        compacted rerun of non-converged lightcurves) lost to this
        single-phase path: every phase-1 chunk forces a host sync, and
        the E13 iteration spread is not heavy-tailed (most lightcurves
        converge within ~2x the median).
        """
        if chunk is None:
            chunk = self._e13_chunk_default()
        B = psd_values_batch.shape[0]
        keys = jax.random.split(key, B)
        mean_v = jnp.asarray(self.mean if mean is None else mean, dtype=jnp.float64)
        gaussian = self.pdf.lower() == "gaussian"
        vpipe = jax.vmap(self._pipeline, in_axes=(0, 0, None))
        if gaussian:
            return vpipe(keys, psd_values_batch, mean_v)

        outs = []
        for start in range(0, B, chunk):
            out, iters = vpipe(
                keys[start : start + chunk], psd_values_batch[start : start + chunk], mean_v
            )
            self._accum_nonconv(iters, out.shape[0])
            outs.append(out)
        if warn_nonconverged:
            self.report_nonconverged()
        return jnp.concatenate(outs, axis=0)

    def add_noise_batch(self, key, rates_batch):
        keys = jax.random.split(key, rates_batch.shape[0])
        return jax.vmap(self.noise.add_noise_jax)(keys, rates_batch)

    @property
    def omega(self):
        """Angular frequencies at which PSDs are evaluated (first entry is
        the unused zero frequency)."""
        return self._omega


# ---------------------------------------------------------------------- #
# module-level helpers (API parity, reference simulator.py:423-539)
# ---------------------------------------------------------------------- #
def add_poisson_noise(rates, exposures, background_counts=None, bkg_rate_err=None):
    """Add Poisson noise and frequentist uncertainties (host path)."""
    rates = np.asarray(rates)
    if background_counts is None:
        background_counts = np.zeros(len(rates), dtype=int)
    if bkg_rate_err is None:
        bkg_rate_err = np.zeros(len(rates), dtype=int)
    total_counts = rates * exposures + background_counts
    total_counts_poiss = np.random.poisson(total_counts)
    net_counts = total_counts_poiss - background_counts
    dy = np.sqrt((np.sqrt(total_counts_poiss) / exposures) ** 2 + bkg_rate_err**2)
    return net_counts / exposures, dy


def get_fft(N: int, dt: float, model: Callable) -> np.ndarray:
    """TK95 frequency-domain draw (host path, reference simulator.py:468-501)."""
    freqs = np.fft.rfftfreq(N, dt) * 2 * np.pi
    real, im = np.random.normal(0, size=(2, N // 2 + 1))
    complex_fft = np.empty(len(freqs), dtype=complex)
    complex_fft[1:] = (real + im * 1j)[1:] * np.sqrt(0.5 * np.asarray(model(freqs[1:])))
    complex_fft[0] = 1e6
    if N % 2 == 0:
        complex_fft[-1] = np.real(complex_fft[-1])
    return complex_fft


def get_segment(lc: RegularLightcurve, duration: float, N: int) -> RegularLightcurve:
    """The Nth consecutive segment of the given duration."""
    if N < 0:
        raise ValueError("N must be a non-negative integer.")
    start = lc.time[0] + duration * N
    return lc.truncate(start=start, stop=start + duration, method="time")


def cut_random_segment(lc: RegularLightcurve, duration: float) -> RegularLightcurve:
    """Random segment of the given duration (host path)."""
    shift = np.random.uniform(lc.time[0], lc.time[-1] - duration)
    return lc.truncate(start=shift, stop=shift + duration, method="time")
