"""Celerite-style kernel terms as pure functions of a flat parameter vector.

A celerite kernel is a sum of exponential-(co)sinusoid terms

    k(tau) = sum_r  a_r exp(-c_r tau)
           + sum_c  exp(-c_c tau) * (a_c cos(d_c tau) + b_c sin(d_c tau))

(tau = |t_i - t_j|), whose covariance matrices are semiseparable and admit
an O(N) Cholesky factorization (Foreman-Mackey et al. 2017).

Design notes:
- A ``Term`` instance is *static*: parameter names, coefficient widths
  (Jr real / Jc complex) and bounds are Python-level constants, so jitted
  functions specialize on the term structure.
- All numerics — ``coefficients(theta)``, ``psd(omega, theta)``,
  ``covariance(tau, theta)``, ``log_prior(theta)`` — are pure functions of
  the flat parameter vector ``theta`` (log-space parameters, matching the
  reference's celerite convention), so they vmap over batches of parameter
  draws (walkers x simulations) and differentiate cleanly.
- Branchy constructions (SHO's over/under-damped split) use static widths
  with ``jnp.where`` masking rather than data-dependent shapes.

Parity targets in the reference:
- custom terms: mind_the_gaps/models/celerite_models.py:7-90
  (Lorentzian, Cosinus, DampedRandomWalk, BendingPowerlaw)
- celerite built-ins used by notebooks/tests: RealTerm, ComplexTerm,
  SHOTerm, Matern32Term, JitterTerm (tests/models_test.py:9,
  docs/notebooks/tutorial_ppp.ipynb)
- PSD convention: celerite's sqrt(2/pi) normalization over angular
  frequency (verified against mind_the_gaps/models/psd_models.py).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

__all__ = [
    "Coefficients",
    "Term",
    "TermSum",
    "RealTerm",
    "ComplexTerm",
    "SHOTerm",
    "Matern32Term",
    "JitterTerm",
    "Lorentzian",
    "Cosinus",
    "DampedRandomWalk",
    "BendingPowerlaw",
]

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


class Coefficients(NamedTuple):
    """Celerite coefficient arrays: ``(a_r, c_r)`` for real terms and
    ``(a_c, b_c, c_c, d_c)`` for complex terms.  Widths are static."""

    ar: jnp.ndarray
    cr: jnp.ndarray
    ac: jnp.ndarray
    bc: jnp.ndarray
    cc: jnp.ndarray
    dc: jnp.ndarray


def _empty():
    return jnp.zeros((0,))


class Term:
    """Base class for celerite-style kernel terms.

    Subclasses define ``parameter_names`` plus ``_real(theta)`` /
    ``_complex(theta)`` returning tuples of scalars (or fixed-width arrays).
    """

    parameter_names: Tuple[str, ...] = ()

    def __init__(self, *args, bounds: Optional[Sequence[Tuple]] = None, **kwargs):
        values = dict(zip(self.parameter_names, args))
        for name in self.parameter_names[len(args):]:
            if name in kwargs:
                values[name] = kwargs.pop(name)
        unknown = set(kwargs) - set(self.parameter_names)
        if unknown:
            raise TypeError(f"Unknown parameters {sorted(unknown)} for {type(self).__name__}")
        values.update(kwargs)
        missing = [n for n in self.parameter_names if n not in values]
        if missing:
            raise TypeError(f"Missing parameters {missing} for {type(self).__name__}")
        self._values = np.array([float(values[n]) for n in self.parameter_names])
        if bounds is None:
            bounds = [(None, None)] * len(self.parameter_names)
        if len(bounds) != len(self.parameter_names):
            raise ValueError("bounds must have one (low, high) pair per parameter")
        self._bounds = [
            (
                -np.inf if lo is None else float(lo),
                np.inf if hi is None else float(hi),
            )
            for lo, hi in bounds
        ]

    # ------------------------------------------------------------------ #
    # static structure
    # ------------------------------------------------------------------ #
    @property
    def ndim(self) -> int:
        return len(self.parameter_names)

    @property
    def terms(self) -> Tuple["Term", ...]:
        return (self,)

    def get_parameter_names(self) -> Tuple[str, ...]:
        return tuple(self.parameter_names)

    def get_parameter_vector(self) -> np.ndarray:
        return self._values.copy()

    def set_parameter_vector(self, theta) -> None:
        theta = np.asarray(theta, dtype=float)
        if theta.shape != (self.ndim,):
            raise ValueError(f"expected parameter vector of shape ({self.ndim},)")
        self._values = theta.copy()

    def get_parameter_bounds(self):
        return list(self._bounds)

    def __add__(self, other: "Term") -> "TermSum":
        return TermSum(self.terms + other.terms)

    # ------------------------------------------------------------------ #
    # numerics — pure functions of theta
    # ------------------------------------------------------------------ #
    def _real(self, theta):
        """Return (ar, cr) as same-length tuples/arrays. Default: none."""
        return (), ()

    def _complex(self, theta):
        """Return (ac, bc, cc, dc). Default: none."""
        return (), (), (), ()

    def coefficients(self, theta=None) -> Coefficients:
        if theta is None:
            theta = jnp.asarray(self._values)
        theta = jnp.asarray(theta)
        ar, cr = self._real(theta)
        ac, bc, cc, dc = self._complex(theta)

        def _stack(vals):
            if len(vals) == 0:
                return _empty().astype(theta.dtype)
            return jnp.stack([jnp.asarray(v, dtype=theta.dtype) for v in vals])

        return Coefficients(_stack(ar), _stack(cr), _stack(ac), _stack(bc), _stack(cc), _stack(dc))

    def jitter(self, theta=None):
        """White-noise (diagonal) variance contributed by this term."""
        if theta is None:
            theta = jnp.asarray(self._values)
        return jnp.zeros((), dtype=jnp.asarray(theta).dtype)

    def log_prior(self, theta=None):
        """Celerite convention: flat prior, 0 inside bounds, -inf outside."""
        if theta is None:
            theta = jnp.asarray(self._values)
        theta = jnp.asarray(theta)
        lo = jnp.asarray([b[0] for b in self._bounds], dtype=theta.dtype)
        hi = jnp.asarray([b[1] for b in self._bounds], dtype=theta.dtype)
        inside = jnp.all((theta >= lo) & (theta <= hi))
        return jnp.where(inside, 0.0, -jnp.inf)

    def psd(self, omega, theta=None):
        """Celerite PSD over *angular* frequency, sqrt(2/pi) normalization.

        Matches celerite's ``Term.get_psd`` (and the analytic forms in the
        reference's mind_the_gaps/models/psd_models.py).
        """
        if theta is None:
            theta = jnp.asarray(self._values)
        omega = jnp.asarray(omega)
        c = self.coefficients(theta)
        w2 = omega[..., None] ** 2
        p = jnp.zeros_like(omega)
        if c.ar.shape[0]:
            p = p + jnp.sum(c.ar * c.cr / (c.cr**2 + w2), axis=-1)
        if c.ac.shape[0]:
            a, b, cc_, d = c.ac, c.bc, c.cc, c.dc
            c2pd2 = cc_**2 + d**2
            num = (a * cc_ + b * d) * c2pd2 + (a * cc_ - b * d) * w2
            den = w2**2 + 2.0 * (cc_**2 - d**2) * w2 + c2pd2**2
            p = p + jnp.sum(num / den, axis=-1)
        return _SQRT_2_OVER_PI * p

    def get_psd(self, omega, theta=None):
        """Alias matching the celerite API used throughout the reference
        (gpmodelling.py:509,535)."""
        return self.psd(omega, theta)

    def covariance(self, tau, theta=None):
        """k(|tau|), excluding jitter (celerite ``Term.get_value``)."""
        if theta is None:
            theta = jnp.asarray(self._values)
        tau = jnp.abs(jnp.asarray(tau))
        c = self.coefficients(theta)
        t = tau[..., None]
        k = jnp.zeros_like(tau)
        if c.ar.shape[0]:
            k = k + jnp.sum(c.ar * jnp.exp(-c.cr * t), axis=-1)
        if c.ac.shape[0]:
            k = k + jnp.sum(
                jnp.exp(-c.cc * t) * (c.ac * jnp.cos(c.dc * t) + c.bc * jnp.sin(c.dc * t)),
                axis=-1,
            )
        return k

    def variance(self, theta=None):
        """k(0) without jitter: sum of a_r and a_c."""
        c = self.coefficients(theta)
        out = jnp.zeros(())
        if c.ar.shape[0]:
            out = out + jnp.sum(c.ar)
        if c.ac.shape[0]:
            out = out + jnp.sum(c.ac)
        return out

    def __repr__(self):
        args = ", ".join(f"{n}={v:.6g}" for n, v in zip(self.parameter_names, self._values))
        return f"{type(self).__name__}({args})"


class TermSum(Term):
    """Sum of terms; parameter vector is the concatenation in order."""

    def __init__(self, terms: Sequence[Term]):
        self._terms = tuple(terms)
        self.parameter_names = tuple(
            f"terms[{i}]:{name}"
            for i, t in enumerate(self._terms)
            for name in t.parameter_names
        )
        self._values = np.concatenate([t._values for t in self._terms])
        self._bounds = [b for t in self._terms for b in t._bounds]

    @property
    def terms(self) -> Tuple[Term, ...]:
        return self._terms

    def set_parameter_vector(self, theta) -> None:
        super().set_parameter_vector(theta)
        for t, sub in zip(self._terms, self._split(np.asarray(theta))):
            t.set_parameter_vector(np.asarray(sub))

    def _split(self, theta):
        out, i = [], 0
        for t in self._terms:
            out.append(theta[i : i + t.ndim])
            i += t.ndim
        return out

    def coefficients(self, theta=None) -> Coefficients:
        if theta is None:
            theta = jnp.asarray(self._values)
        theta = jnp.asarray(theta)
        parts = [t.coefficients(sub) for t, sub in zip(self._terms, self._split(theta))]
        return Coefficients(*(jnp.concatenate([getattr(p, f) for p in parts]) for f in Coefficients._fields))

    def jitter(self, theta=None):
        if theta is None:
            theta = jnp.asarray(self._values)
        theta = jnp.asarray(theta)
        return sum(
            (t.jitter(sub) for t, sub in zip(self._terms, self._split(theta))),
            jnp.zeros((), dtype=theta.dtype),
        )

    def log_prior(self, theta=None):
        if theta is None:
            theta = jnp.asarray(self._values)
        theta = jnp.asarray(theta)
        return sum(
            (t.log_prior(sub) for t, sub in zip(self._terms, self._split(theta))),
            jnp.zeros((), dtype=theta.dtype),
        )

    def __repr__(self):
        return " + ".join(repr(t) for t in self._terms)


# ---------------------------------------------------------------------- #
# celerite built-in equivalents
# ---------------------------------------------------------------------- #
class RealTerm(Term):
    """a * exp(-c tau) (celerite RealTerm)."""

    parameter_names = ("log_a", "log_c")

    def _real(self, theta):
        return (jnp.exp(theta[0]),), (jnp.exp(theta[1]),)


class ComplexTerm(Term):
    """exp(-c tau) (a cos(d tau) + b sin(d tau)) (celerite ComplexTerm).

    Like celerite, supports 3 parameters (b fixed to 0) or 4.
    """

    def __init__(self, *args, bounds=None, **kwargs):
        nargs = len(args) + len([k for k in kwargs if k.startswith("log_")])
        if nargs == 3 and "log_b" not in kwargs:
            self.parameter_names = ("log_a", "log_c", "log_d")
        else:
            self.parameter_names = ("log_a", "log_b", "log_c", "log_d")
        super().__init__(*args, bounds=bounds, **kwargs)

    def _complex(self, theta):
        if len(self.parameter_names) == 3:
            a, c, d = jnp.exp(theta[0]), jnp.exp(theta[1]), jnp.exp(theta[2])
            b = jnp.zeros_like(a)
        else:
            a, b, c, d = (jnp.exp(theta[i]) for i in range(4))
        return (a,), (b,), (c,), (d,)


class SHOTerm(Term):
    """Stochastically-driven damped simple harmonic oscillator
    (celerite SHOTerm; PSD = Eq. 20 of Foreman-Mackey+2017, reproduced in
    reference psd_models.py:7).

    Static-width construction: 1 complex + 2 real slots; the inactive
    branch (over- vs under-damped) is masked to zero coefficients so the
    parameter-dependent branch never changes array shapes under jit.
    """

    parameter_names = ("log_S0", "log_Q", "log_omega0")

    def _coeffs(self, theta):
        S0 = jnp.exp(theta[0])
        Q = jnp.exp(theta[1])
        w0 = jnp.exp(theta[2])
        under = Q >= 0.5  # underdamped -> complex (oscillatory) term

        # underdamped branch: f = sqrt(4 Q^2 - 1)
        fu = jnp.sqrt(jnp.maximum(4.0 * Q**2 - 1.0, 1e-300))
        a_c = S0 * w0 * Q
        b_c = a_c / fu
        c_c = 0.5 * w0 / Q
        d_c = c_c * fu

        # overdamped branch: f = sqrt(1 - 4 Q^2), two real terms
        fo = jnp.sqrt(jnp.maximum(1.0 - 4.0 * Q**2, 1e-300))
        base = 0.5 * S0 * w0 * Q
        a1 = base * (1.0 + 1.0 / fo)
        a2 = base * (1.0 - 1.0 / fo)
        c1 = 0.5 * w0 / Q * (1.0 - fo)
        c2 = 0.5 * w0 / Q * (1.0 + fo)

        zero = jnp.zeros_like(S0)
        one = jnp.ones_like(S0)
        ar = (jnp.where(under, zero, a1), jnp.where(under, zero, a2))
        cr = (jnp.where(under, one, c1), jnp.where(under, one, c2))
        ac = (jnp.where(under, a_c, zero),)
        bc = (jnp.where(under, b_c, zero),)
        cc = (jnp.where(under, c_c, one),)
        dc = (jnp.where(under, d_c, zero),)
        return (ar, cr), (ac, bc, cc, dc)

    def _real(self, theta):
        return self._coeffs(theta)[0]

    def _complex(self, theta):
        return self._coeffs(theta)[1]


class Matern32Term(Term):
    """Matern-3/2 kernel via celerite's epsilon-regularized complex term:
    k(tau) = sigma^2 (1 + w0 tau) exp(-w0 tau), w0 = sqrt(3)/rho."""

    parameter_names = ("log_sigma", "log_rho")

    def __init__(self, *args, eps: float = 0.01, bounds=None, **kwargs):
        self.eps = float(eps)
        super().__init__(*args, bounds=bounds, **kwargs)

    def _complex(self, theta):
        sigma2 = jnp.exp(2.0 * theta[0])
        w0 = math.sqrt(3.0) * jnp.exp(-theta[1])
        return (sigma2,), (sigma2 * w0 / self.eps,), (w0,), (jnp.full_like(w0, self.eps),)


class JitterTerm(Term):
    """Pure white-noise term: adds sigma^2 to the covariance diagonal
    (celerite JitterTerm; ``kernel.jitter`` is used by the reference's
    standarized_residuals, gpmodelling.py:368)."""

    parameter_names = ("log_sigma",)

    def jitter(self, theta=None):
        if theta is None:
            theta = jnp.asarray(self._values)
        return jnp.exp(2.0 * jnp.asarray(theta)[0])


# ---------------------------------------------------------------------- #
# reference custom terms (celerite_models.py:7-90)
# ---------------------------------------------------------------------- #
class Lorentzian(Term):
    """Damped cosine: exp(-0.5 w0/Q tau) S0 cos(w0 tau)
    (reference celerite_models.py:7-34; PSD = Eq. 11 FM+17)."""

    parameter_names = ("log_S0", "log_Q", "log_omega0")

    def _complex(self, theta):
        S0 = jnp.exp(theta[0])
        Q = jnp.exp(theta[1])
        w0 = jnp.exp(theta[2])
        return (S0,), (jnp.zeros_like(S0),), (0.5 * w0 / Q,), (w0,)


class Cosinus(Term):
    """Undamped cosine: S0 cos(w0 tau) (reference celerite_models.py:36-53)."""

    parameter_names = ("log_S0", "log_omega0")

    def _complex(self, theta):
        S0 = jnp.exp(theta[0])
        w0 = jnp.exp(theta[1])
        zero = jnp.zeros_like(S0)
        return (S0,), (zero,), (zero,), (w0,)


class DampedRandomWalk(Term):
    """S0 exp(-w0 tau) — Eq. 13 of Foreman-Mackey+2017 with Q = 1/2
    (reference celerite_models.py:55-69)."""

    parameter_names = ("log_S0", "log_omega0")

    def _real(self, theta):
        S0 = jnp.exp(theta[0])
        w0 = jnp.exp(theta[1])
        return (S0,), (w0,)  # c = 0.5 * w0 / Q with Q = 1/2


class BendingPowerlaw(Term):
    """omega^-2 to omega^-4 bending term (reference celerite_models.py:71-90).

    Carries the positive-definiteness prior constraint log_S0 >= log_Q.
    """

    parameter_names = ("log_S0", "log_Q", "log_omega0")

    def _complex(self, theta):
        w0 = jnp.exp(theta[2])
        return (jnp.exp(theta[0]),), (jnp.exp(theta[1]),), (w0,), (w0,)

    def log_prior(self, theta=None):
        if theta is None:
            theta = jnp.asarray(self._values)
        theta = jnp.asarray(theta)
        base = super().log_prior(theta)
        return jnp.where(theta[0] < theta[1], -jnp.inf, base)
