"""The kernel lowers for CUDA without a card.

``jax.jit(f).trace(...).lower(lowering_platforms=("cuda",))`` runs the
Pallas-Triton lowering on the CPU host, with x64 on as the package sets
it.  That catches what interpret mode cannot: an operation the Triton
route does not lower, or an array whose size is not a power of two.
What ptxas says about registers is left to the on-card tests
(tests/test_gpu_onchip.py).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mind_the_gaps_tpu.kernels import DampedRandomWalk, Lorentzian, RealTerm, SHOTerm
from mind_the_gaps_tpu.ops.pallas_celerite import pallas_log_likelihood

_KERNELS = {
    "real_only": lambda: DampedRandomWalk(1.0, -3.0) + RealTerm(0.0, -1.0),
    "complex_only": lambda: SHOTerm(0.5, 1.0, -2.5) + Lorentzian(-1.0, 2.0, -2.0),
    "drw_lorentzian": lambda: DampedRandomWalk(1.0, -3.0) + Lorentzian(-1.0, 2.0, -2.0),
    "R6": lambda: RealTerm(0.5, -1.0) + RealTerm(-0.5, -2.0)
    + Lorentzian(-1.0, 2.0, -2.0) + Lorentzian(-0.5, 1.0, -1.0),
}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("mode", ["shared", "grouped", "element"])
@pytest.mark.parametrize("name", sorted(_KERNELS))
def test_kernel_lowers_for_cuda(name, mode, dtype):
    assert jax.config.jax_enable_x64
    kernel = _KERNELS[name]()
    dt = jnp.dtype(dtype)
    n, groups, repeats = 48, 6, 6  # 36 lanes: a padded last block
    batch = groups * repeats
    rng = np.random.default_rng(0)
    t = np.cumsum(rng.uniform(1.0, 2.0, n))
    theta0 = kernel.get_parameter_vector()
    thetas = jnp.asarray(theta0 + 0.01 * rng.normal(size=(batch, theta0.size)), dtype=dt)
    coeffs = jax.vmap(kernel.coefficients)(thetas)
    rows = {"shared": 1, "grouped": groups, "element": batch}[mode]
    shape = (n,) if mode == "shared" else (rows, n)
    y = jnp.zeros(shape, dt)
    diag = jnp.ones(shape, dt)
    reps = repeats if mode == "grouped" else 1

    def f(c, y, d):
        return pallas_log_likelihood(
            c, t, y, d, mean=jnp.zeros((batch,), dt), repeats=reps, interpret=False
        )

    lowered = jax.jit(f).trace(coeffs, y, diag).lower(lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert "__gpu$xla.gpu.triton" in text
    assert f"tensor<{batch}x{'f32' if dtype == 'float32' else 'f64'}>" in text
