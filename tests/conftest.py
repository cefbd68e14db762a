"""Test configuration: run the suite on a virtual 8-device CPU mesh.

Tests exercise the multi-device sharding path without accelerator
hardware (``__graft_entry__.dryrun_multichip`` runs the same sharded
step).  CPU also gives native float64, which the parity tests rely on.
The backend follows ``JAX_PLATFORMS`` and defaults to CPU here.

Tests marked ``gpu`` run compiled kernels on a CUDA card and skip
elsewhere; the check is made per test by the ``_gpu_only`` fixture.
On a machine with a card:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu_onchip.py
"""
import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: runs compiled Pallas-Triton kernels on a CUDA card "
        "(skips without one; run with JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu_onchip.py)",
    )


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests unless JAX's default backend is a GPU."""
    if request.node.get_closest_marker("gpu") is not None:
        import jax

        if jax.default_backend() != "gpu":
            pytest.skip("needs a CUDA GPU: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu_onchip.py")


@pytest.fixture
def interpret_kernels(monkeypatch):
    """Run the package's GPU-kernel call sites through the Pallas
    interpreter, so the kernel paths are testable on the CPU."""
    from mind_the_gaps_tpu.ops import pallas_celerite

    monkeypatch.setattr(pallas_celerite, "_INTERPRET", True)
