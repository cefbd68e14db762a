"""derive_posteriors mesh mode: the observed fits use the device mesh.

The reference parallelizes its observed fit with a walker Pool
(reference gpmodelling.py:245); the multi-device equivalent here is
derive_posteriors(mesh=...) — the walker (or independent-chain) axis of
the segment program shards over the mesh, and protassov_lrt passes the
default mesh whenever more than one device is present.

Contracts pinned here:
1. the final chain/log-prob buffers really stay PARTITIONED over the
   mesh through every segment dispatch (not gathered/replicated);
2. the sampled chains, log-likelihoods and thinned samples are
   BIT-IDENTICAL to the single-device run (partitionable threefry makes
   the RNG sharding-invariant; all per-chain math is unaffected by the
   batch partitioning);
3. an indivisible leading axis gates the mesh off with a warning
   instead of failing.
"""
import warnings

import numpy as np
import pytest

import jax

from mind_the_gaps_tpu import GappyLightcurve
from mind_the_gaps_tpu.gpmodelling import GPModelling
from mind_the_gaps_tpu.kernels import DampedRandomWalk
from mind_the_gaps_tpu.parallel import default_mesh

needs_mesh = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device CPU mesh"
)


def _problem(n=64, seed=0):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(1.0, 3.0, n))
    lc = GappyLightcurve(t, rng.normal(5.0, 1.0, n) + 10.0, np.full(n, 0.2))
    kernel = DampedRandomWalk(log_S0=1.0, log_omega0=-2.0, bounds=[(-5, 10), (-8, 2)])
    return lc, kernel


def _derive(gp, init, mesh=None, chains=1):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # converge=False warns by design
        gp.derive_posteriors(
            initial_chain_params=init, chains=chains, max_steps=8,
            convergence_steps=4, converge=False, seed=5, fast=False, mesh=mesh,
        )


@needs_mesh
def test_mesh_mode_is_sharded_and_bit_identical():
    lc, kernel = _problem()
    mesh = default_mesh()
    gp = GPModelling(lc, kernel)
    init = gp.spread_walkers(
        16, gp.initial_params, np.array(gp.get_parameter_bounds(), dtype=object),
        rng=np.random.default_rng(1),
    )

    _derive(gp, init, mesh=mesh)
    buf_shape, buf_sharding = gp._last_segment_sharding
    assert buf_shape == (8, 16, kernel.ndim)
    # really partitioned on the pooled walker axis — one shard per device
    assert buf_sharding.shard_shape(buf_shape) == (8, 16 // mesh.size, kernel.ndim), (
        buf_sharding
    )
    chain_m = np.asarray(gp._sampler._chain)
    lp_m = np.asarray(gp._sampler._log_probs)
    ll_m = np.asarray(gp._loglikelihoods)
    samples_m = np.asarray(gp._mcmc_samples)

    gp_s = GPModelling(lc, kernel)
    _derive(gp_s, init, mesh=None)
    np.testing.assert_array_equal(chain_m, np.asarray(gp_s._sampler._chain))
    np.testing.assert_array_equal(lp_m, np.asarray(gp_s._sampler._log_probs))
    np.testing.assert_array_equal(ll_m, np.asarray(gp_s._loglikelihoods))
    np.testing.assert_array_equal(samples_m, np.asarray(gp_s._mcmc_samples))
    # tau's walker-mean reduction order may differ across the mesh — but
    # only in the last ulps
    np.testing.assert_allclose(gp._tau, gp_s._tau, rtol=1e-10)


@needs_mesh
def test_mesh_mode_multi_chain_lanes():
    """chains > 1: the independent-chain axis shards instead."""
    lc, kernel = _problem(seed=2)
    mesh = default_mesh()
    gp = GPModelling(lc, kernel)
    init = gp.spread_walkers(
        8 * 4, gp.initial_params, np.array(gp.get_parameter_bounds(), dtype=object),
        rng=np.random.default_rng(3),
    ).reshape(8, 4, -1)

    _derive(gp, init, mesh=mesh, chains=8)
    buf_shape, buf_sharding = gp._last_segment_sharding
    assert buf_shape == (8, 32, kernel.ndim)
    assert buf_sharding.shard_shape(buf_shape) == (8, 32 // mesh.size, kernel.ndim)

    gp_s = GPModelling(lc, kernel)
    _derive(gp_s, init, mesh=None, chains=8)
    np.testing.assert_array_equal(
        np.asarray(gp._sampler._chain), np.asarray(gp_s._sampler._chain)
    )


@needs_mesh
def test_mesh_mode_gates_off_indivisible_walkers():
    lc, kernel = _problem(seed=4)
    mesh = default_mesh()
    gp = GPModelling(lc, kernel)
    init = gp.spread_walkers(
        12, gp.initial_params, np.array(gp.get_parameter_bounds(), dtype=object),
        rng=np.random.default_rng(5),
    )  # 12 walkers do not divide 8 devices
    with pytest.warns(UserWarning, match="mesh mode"):
        gp.derive_posteriors(
            initial_chain_params=init, max_steps=4, convergence_steps=4,
            converge=False, seed=5, fast=False, mesh=mesh,
        )
    _, buf_sharding = gp._last_segment_sharding
    assert not hasattr(buf_sharding, "spec")  # single-device sharding
