"""Policy test for the adaptive E13 lock-step chunk width.

Wide chunks amortize dispatch at small cut lengths and waste lock-step
iterations at large ones; ``Simulator._e13_chunk_default`` keeps ~4M
resident elements per chunk, clamped to [128, 512].  This pins the
policy so a refactor can't silently change it.
"""
import numpy as np

from mind_the_gaps_tpu.models import psd_models
from mind_the_gaps_tpu.simulator import Simulator


def _sim_with_cut_len(m):
    times = np.arange(0.5, 400.0, 1.0)
    sim = Simulator(
        psd_models.BendingPowerlaw(S0=1.0, omega0=0.1), times, 0.2, 10.0,
        "Lognormal", extension_factor=1.05,
    )
    sim._e13_cut_len = m
    return sim


def test_chunk_default_policy():
    # ~4M resident elements, clamped to [128, 512], power of two
    assert _sim_with_cut_len(8192)._e13_chunk_default() == 512
    assert _sim_with_cut_len(16384)._e13_chunk_default() == 256
    assert _sim_with_cut_len(32768)._e13_chunk_default() == 128
    assert _sim_with_cut_len(65536)._e13_chunk_default() == 128
    assert _sim_with_cut_len(1 << 22)._e13_chunk_default() == 128  # huge cut
    assert _sim_with_cut_len(256)._e13_chunk_default() == 512  # tiny cut: cap


def test_chunk_default_is_pow2_everywhere():
    for m in [1000, 5000, 6586, 8192, 12000, 20000, 65536, 100000]:
        c = _sim_with_cut_len(m)._e13_chunk_default()
        assert 128 <= c <= 512 and (c & (c - 1)) == 0, (m, c)


def test_simulate_batch_uses_default_when_chunk_none():
    import jax
    import jax.numpy as jnp

    sim = _sim_with_cut_len(0)  # fall back to the real segment length
    del sim._e13_cut_len
    omega = jnp.asarray(sim.omega)
    psd = jnp.concatenate([jnp.zeros((1,)), jnp.asarray(sim.psd_model(omega[1:]))])
    psd_b = jnp.broadcast_to(psd[None, :], (4, psd.shape[0]))
    out = sim.simulate_batch(jax.random.key(0), psd_b)
    assert out.shape[0] == 4 and out.shape[1] > 0
    assert bool(jnp.all(jnp.isfinite(out))) and bool(jnp.all(out > 0))
