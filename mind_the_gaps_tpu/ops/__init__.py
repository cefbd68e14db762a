"""Hand-written GPU kernels (Pallas through Triton) for the hot ops, and
the one switch that says where they run."""
import jax

from mind_the_gaps_tpu.ops.pallas_celerite import pallas_log_likelihood

__all__ = ["gpu_kernel_available", "pallas_log_likelihood"]


def gpu_kernel_available() -> bool:
    """True when the default backend runs the Pallas-Triton kernels.

    Every ``fast=None`` / ``backend="auto"`` choice in the package reads
    this: on a GPU the likelihood runs through the kernel, elsewhere
    through the XLA scan (solver/batched.py).  There is no fallback: a
    kernel that fails on the GPU fails the run."""
    return jax.default_backend() == "gpu"
