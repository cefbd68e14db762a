"""Lightcurve simulation engine: TK95 / E13 with observational noise.

Device rebuild of reference mind_the_gaps/simulator.py +
noise_models.py: frequency-domain draws and PDF adjustment are batched
on-device FFTs; resampling onto the observing windows is a precomputed
static-index segment-mean; noise models are vectorized jax.random draws
(the Kraft posterior via incomplete-gamma bisection instead of the
reference's per-bin scipy loop).
"""
from mind_the_gaps_tpu.simulator.regular import RegularLightcurve
from mind_the_gaps_tpu.simulator.noise import (
    BaseNoise,
    PoissonNoise,
    KraftNoise,
    GaussianNoise,
)
from mind_the_gaps_tpu.simulator.core import (
    BaseSimulatorMethod,
    Simulator,
    TK95Simulator,
    E13Simulator,
    add_poisson_noise,
    get_fft,
    get_segment,
    cut_random_segment,
)

__all__ = [
    "BaseSimulatorMethod",
    "RegularLightcurve",
    "BaseNoise",
    "PoissonNoise",
    "KraftNoise",
    "GaussianNoise",
    "Simulator",
    "TK95Simulator",
    "E13Simulator",
    "add_poisson_noise",
    "get_fft",
    "get_segment",
    "cut_random_segment",
]
