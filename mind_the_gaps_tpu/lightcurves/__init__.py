"""Lightcurve containers and loaders.

Data layer replacing reference mind_the_gaps/lightcurves/:
``GappyLightcurve`` is an immutable container over plain arrays (host
numpy for I/O-adjacent state; methods hand JAX device arrays to the
compute layers), plus file-format loaders (Simple/Swift/Fermi CSV/QDP
parsing — host-side by nature).
"""
from mind_the_gaps_tpu.lightcurves.gappylightcurve import (
    GappyLightcurve,
    ExposureTimeError,
)
from mind_the_gaps_tpu.lightcurves.loaders import (
    SimpleLightcurve,
    SwiftLightcurve,
    FermiLightcurve,
)

__all__ = [
    "GappyLightcurve",
    "ExposureTimeError",
    "SimpleLightcurve",
    "SwiftLightcurve",
    "FermiLightcurve",
]
