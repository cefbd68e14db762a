"""Exported-program cache (program_cache.py): write/load round-trip.

The main test process runs with 8 virtual CPU devices; these tests
drive the tier in single-device subprocesses, the configuration of a
one-card run.  The f64 XLA sampler segment is the exported program
(kernel programs bypass the tier: ``jax.export`` refuses Triton calls).
"""
from __future__ import annotations

import os
import subprocess
import sys

_SCRIPT = r"""
import os, sys
os.environ.pop("XLA_FLAGS", None)  # single CPU device
import jax
jax.config.update("jax_platforms", "cpu")

import numpy as np
from mind_the_gaps_tpu import GappyLightcurve
from mind_the_gaps_tpu.gpmodelling import GPModelling
from mind_the_gaps_tpu.kernels import DampedRandomWalk

assert len(jax.devices()) == 1, jax.devices()

rng = np.random.default_rng(0)
t = np.cumsum(rng.uniform(2.0, 8.0, 80))
lc = GappyLightcurve(t, 10 + rng.normal(0, 1, 80), np.full(80, 0.3), exposures=1.0)
gp = GPModelling(lc, DampedRandomWalk(log_S0=0.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)]))
gp.derive_posteriors(fit=False, converge=False, max_steps=40, convergence_steps=20,
                     walkers=8, seed=9, fast=False)
print("MAXLL", gp.max_loglikelihood)
"""


def _run(env):
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT], capture_output=True, text=True,
        timeout=600, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return [l for l in proc.stdout.splitlines() if l.startswith("MAXLL")]


def test_artifact_write_then_load_same_results(tmp_path):
    env = dict(os.environ)
    env["MTG_TPU_PROGRAM_CACHE"] = str(tmp_path / "programs")
    env.pop("XLA_FLAGS", None)

    out1 = _run(env)
    arts = os.listdir(env["MTG_TPU_PROGRAM_CACHE"])
    assert any(a.endswith(".jaxprog") for a in arts), (
        "single-device run wrote no exported artifacts"
    )
    mtimes = {
        a: os.path.getmtime(os.path.join(env["MTG_TPU_PROGRAM_CACHE"], a)) for a in arts
    }

    out2 = _run(env)
    assert out2 == out1, "artifact replay changed seeded results"
    # run 2 loaded the artifacts instead of re-exporting them
    arts2 = os.listdir(env["MTG_TPU_PROGRAM_CACHE"])
    assert sorted(arts2) == sorted(arts), "run 2 wrote new artifacts (cache key unstable)"
    for a in arts:
        assert os.path.getmtime(os.path.join(env["MTG_TPU_PROGRAM_CACHE"], a)) == mtimes[a]


def test_disable_env_var(tmp_path):
    env = dict(os.environ)
    env["MTG_TPU_PROGRAM_CACHE"] = str(tmp_path / "programs")
    env["MTG_TPU_NO_PROGRAM_CACHE"] = "1"
    env.pop("XLA_FLAGS", None)
    _run(env)
    assert not os.path.exists(env["MTG_TPU_PROGRAM_CACHE"])
