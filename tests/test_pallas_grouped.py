"""Grouped (bootstrap), per-element and sharded layouts of the
Pallas-Triton kernel (interpret mode) against the batched scan."""
import numpy as np

import jax
import jax.numpy as jnp

from mind_the_gaps_tpu.kernels import DampedRandomWalk, Lorentzian
from mind_the_gaps_tpu.ops.pallas_celerite import pallas_log_likelihood
from mind_the_gaps_tpu.parallel import default_mesh
from mind_the_gaps_tpu.solver.batched import batched_log_likelihood


def _thetas(kernel, batch, seed, dtype=None):
    theta0 = kernel.get_parameter_vector()
    th = theta0 + 0.05 * np.asarray(jax.random.normal(jax.random.key(seed), (batch, len(theta0))))
    return jnp.asarray(th, dtype=dtype)


def test_pallas_grouped_matches_scan():
    kernel = DampedRandomWalk(1.0, -3.0) + Lorentzian(-1.0, 2.0, -2.0)
    rng = np.random.default_rng(0)
    N, G, W = 200, 16, 6  # 12 walkers -> 6 per half-update, as in the bootstrap
    B = G * W
    t = np.cumsum(rng.uniform(2.0, 8.0, N))
    ys = rng.normal(5.0, 2.0, (G, N))
    diags = rng.uniform(0.05, 0.2, (G, N))
    co = jax.vmap(kernel.coefficients)(_thetas(kernel, B, 1))
    means = jnp.repeat(jnp.asarray(ys.mean(axis=1)), W)
    jitter = jnp.asarray(rng.uniform(0.0, 0.01, B))

    ref = np.asarray(
        batched_log_likelihood(co, t, ys, diags, mean=means, repeats=W, extra_diag=jitter)
    )
    pal = np.asarray(
        pallas_log_likelihood(
            co, t, ys, diags, mean=means, repeats=W, extra_diag=jitter, interpret=True
        )
    )
    np.testing.assert_allclose(pal, ref, rtol=1e-12)


def test_pallas_grouped_f32():
    kernel = DampedRandomWalk(1.0, -3.0)
    rng = np.random.default_rng(1)
    N, G, W = 300, 32, 8
    B = G * W
    t = np.cumsum(rng.uniform(2.0, 8.0, N))
    ys = rng.normal(5.0, 2.0, (G, N)).astype(np.float32)
    diags = np.full((G, N), 0.09, np.float32)
    co = jax.vmap(kernel.coefficients)(_thetas(kernel, B, 2, jnp.float32))
    ref = np.asarray(batched_log_likelihood(co, t, ys, diags, repeats=W))
    pal = np.asarray(pallas_log_likelihood(co, t, ys, diags, repeats=W, interpret=True))
    np.testing.assert_allclose(pal, ref, rtol=1e-4, atol=1e-2)


def test_pallas_shared_unchanged():
    """Shared (N,) data broadcast to every lane."""
    kernel = DampedRandomWalk(1.0, -3.0) + Lorentzian(-1.0, 2.0, -2.0)
    rng = np.random.default_rng(2)
    N, B = 150, 40
    t = np.cumsum(rng.uniform(2.0, 8.0, N))
    y = rng.normal(0.0, 2.0, N)
    diag = np.full(N, 0.09)
    co = jax.vmap(kernel.coefficients)(_thetas(kernel, B, 3))
    ref = np.asarray(batched_log_likelihood(co, t, y, diag))
    pal = np.asarray(pallas_log_likelihood(co, t, y, diag, interpret=True))
    np.testing.assert_allclose(pal, ref, rtol=1e-12)


def test_pallas_per_element_series():
    """2-D y with repeats=1: every batch element owns its series (the
    per-walker-residual layout used by fitted mean models)."""
    kernel = DampedRandomWalk(1.0, -3.0) + Lorentzian(-1.0, 2.0, -2.0)
    rng = np.random.default_rng(3)
    N, B = 180, 24
    t = np.cumsum(rng.uniform(2.0, 8.0, N))
    ys = rng.normal(0.0, 2.0, (B, N))
    diags = rng.uniform(0.05, 0.2, (B, N))
    co = jax.vmap(kernel.coefficients)(_thetas(kernel, B, 4))
    jitter = jnp.asarray(rng.uniform(0.0, 0.01, B))

    ref = np.asarray(batched_log_likelihood(co, t, ys, diags, extra_diag=jitter))
    pal = np.asarray(pallas_log_likelihood(co, t, ys, diags, extra_diag=jitter, interpret=True))
    np.testing.assert_allclose(pal, ref, rtol=1e-12)


def test_pallas_per_element_shared_diag():
    """Per-element y with a shared 1-D diag broadcasts the diag."""
    kernel = DampedRandomWalk(1.0, -3.0)
    rng = np.random.default_rng(4)
    N, B = 100, 32
    t = np.cumsum(rng.uniform(2.0, 8.0, N))
    ys = rng.normal(0.0, 2.0, (B, N))
    diag = np.full(N, 0.09)
    co = jax.vmap(kernel.coefficients)(_thetas(kernel, B, 5))
    ref = np.asarray(batched_log_likelihood(co, t, ys, np.broadcast_to(diag, ys.shape)))
    pal = np.asarray(pallas_log_likelihood(co, t, ys, diag, interpret=True))
    np.testing.assert_allclose(pal, ref, rtol=1e-12)


def test_pallas_ragged_group_tile():
    """A batch that is not a multiple of the 32-lane block (G=68, half=7
    -> B=476: 15 blocks, the last one 4 lanes short) edge-pads the lanes
    and slices them off."""
    kernel = DampedRandomWalk(1.0, -3.0)
    rng = np.random.default_rng(5)
    N, G, W = 64, 68, 7
    B = G * W
    t = np.cumsum(rng.uniform(2.0, 8.0, N))
    ys = rng.normal(5.0, 2.0, (G, N))
    diags = np.full((G, N), 0.09)
    co = jax.vmap(kernel.coefficients)(_thetas(kernel, B, 6))
    ref = np.asarray(batched_log_likelihood(co, t, ys, diags, repeats=W))
    pal = np.asarray(pallas_log_likelihood(co, t, ys, diags, repeats=W, interpret=True))
    assert pal.shape == (B,)
    np.testing.assert_allclose(pal, ref, rtol=1e-12)


def test_pallas_mesh_sharded_matches_unsharded():
    """``mesh=``: the kernel call runs under shard_map over the 8
    virtual devices (grouped layout split by group, shared layout padded
    to a multiple of the mesh) and returns the unsharded result."""
    kernel = DampedRandomWalk(1.0, -3.0) + Lorentzian(-1.0, 2.0, -2.0)
    mesh = default_mesh()
    rng = np.random.default_rng(7)
    N, G, W = 40, 16, 3
    B = G * W
    t = np.cumsum(rng.uniform(2.0, 8.0, N))
    ys = jnp.asarray(rng.normal(5.0, 2.0, (G, N)))
    diags = jnp.full((G, N), 0.09)
    co = jax.vmap(kernel.coefficients)(_thetas(kernel, B, 8))
    ref = np.asarray(batched_log_likelihood(co, t, ys, diags, repeats=W))
    pal = np.asarray(
        jax.jit(lambda c, y, d: pallas_log_likelihood(c, t, y, d, repeats=W, mesh=mesh, interpret=True))(
            co, ys, diags
        )
    )
    np.testing.assert_allclose(pal, ref, rtol=1e-12)

    co_s = jax.tree.map(lambda x: x[:13], co)  # 13 lanes: padded to 16
    ref = np.asarray(batched_log_likelihood(co_s, t, ys[0], diags[0]))
    pal = np.asarray(pallas_log_likelihood(co_s, t, ys[0], diags[0], mesh=mesh, interpret=True))
    np.testing.assert_allclose(pal, ref, rtol=1e-12)
