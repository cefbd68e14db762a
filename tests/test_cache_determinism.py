"""Persistent-compilation-cache key determinism across processes.

Regression guard: tracing embeds global-order-dependent symbol
names (e.g. ``log_prob_batch_fast_154``) in the lowered module, and the
persistent compilation cache hashes the serialized module — so any
program traced CONCURRENTLY with other tracing gets a cache key that
never reproduces in another process.  Every "warm" LRT run silently
recompiled all of its big programs until the entry precompiles were restructured to lower on the main
thread in a fixed order and only compile on the pool.

This test runs the full ``protassov_lrt`` entry twice in separate
subprocesses against one shared cache directory (CPU backend,
``jax_persistent_cache_min_compile_time_secs=0`` so everything is
persisted) and asserts the second run adds NO new entries for the
pipeline's programs (two identical runs: zero new entries).
"""
from __future__ import annotations

import os
import subprocess
import sys



_BIG = (
    "jit__advance_segment",
    "jit_batched_core",
    "jit_gen",
    "jit__f64_logprob_chunk_from_dy",
    "jit_log_prob_batch",
)

_SCRIPT = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_compilation_cache_dir", sys.argv[1])
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

import numpy as np
from mind_the_gaps_tpu import GappyLightcurve
from mind_the_gaps_tpu.kernels import DampedRandomWalk, Lorentzian
from mind_the_gaps_tpu.lrt import protassov_lrt

data_seed = int(sys.argv[2]) if len(sys.argv) > 2 else 0
rng = np.random.default_rng(0)
t = np.cumsum(rng.uniform(2.0, 8.0, 120))  # observing pattern is shared
drng = np.random.default_rng(data_seed)
y = 10.0 + 3.0 * data_seed + drng.normal(0.0, 1.0, 120)
lc = GappyLightcurve(t, y, np.full(120, 0.3), exposures=1.0)
null_kernel = DampedRandomWalk(log_S0=0.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)])
alt_kernel = DampedRandomWalk(log_S0=0.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)]) + Lorentzian(
    log_S0=-1.0, log_Q=2.0, log_omega0=-2.0, bounds=[(-8, 5), (0, 6), (-5, 0)])
res = protassov_lrt(
    lc, null_kernel, alt_kernel, nsims=8, chunk=8, seed=3,
    observed_max_steps=60, observed_walkers=8, sim_max_steps=20, sim_walkers=8,
)
print("T_OBS", res.t_obs)
"""


def test_precompiles_lower_on_the_calling_thread(monkeypatch):
    """The design contract behind reproducible cache keys: precompile
    helpers must TRACE/LOWER on the calling thread (deterministic global
    order) and ship only the backend compile to the executor.  The
    subprocess test below cannot reliably reproduce the trace race on a
    CPU backend (traces finish too fast to overlap), so this pins the
    mechanism directly — it fails on the pre-fix code, which lowered
    inside the worker.

    The spies watch ``.lower``, so the exported-program tier (which
    traces through jax.export on the same calling thread, never calling
    .lower) is disabled for the duration."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import jax.numpy as jnp

    from mind_the_gaps_tpu import GappyLightcurve
    from mind_the_gaps_tpu.gpmodelling import GPModelling
    from mind_the_gaps_tpu.kernels import DampedRandomWalk
    from mind_the_gaps_tpu.lrt import _ChunkFitter

    rng = np.random.default_rng(0)
    t = np.cumsum(rng.uniform(2.0, 8.0, 100))
    lc = GappyLightcurve(t, 10 + rng.normal(0, 1, 100), np.full(100, 0.3), exposures=1.0)
    kernel = DampedRandomWalk(log_S0=0.0, log_omega0=-3.0, bounds=[(-5, 10), (-8, 2)])
    gp = GPModelling(lc, kernel)

    monkeypatch.setenv("MTG_TPU_NO_PROGRAM_CACHE", "1")

    lower_threads = []
    orig_seg_lower = GPModelling._segment_lower
    orig_rec_lower = GPModelling._recompute_lower
    GPModelling._segment_lower = lambda self, *a, **k: (
        lower_threads.append(threading.current_thread()), orig_seg_lower(self, *a, **k)
    )[1]
    GPModelling._recompute_lower = lambda self, *a, **k: (
        lower_threads.append(threading.current_thread()), orig_rec_lower(self, *a, **k)
    )[1]
    try:
        with ThreadPoolExecutor(2) as pool:
            f1 = gp.precompile_sampler(pool, max_steps=40, convergence_steps=20, walkers=8, fast=False)
            f2 = gp.precompile_recompute(pool, rows=64)
            f1.result()
            if f2 is not None:
                f2.result()
    finally:
        GPModelling._segment_lower = orig_seg_lower
        GPModelling._recompute_lower = orig_rec_lower
    assert len(lower_threads) == 2
    assert all(th is threading.main_thread() for th in lower_threads), lower_threads

    fitter = _ChunkFitter(
        kernel, t, kernel.get_parameter_vector(), walkers=8, n_steps=10, chunk=8,
        dtype=jnp.float64, backend="xla",
    )
    runner_threads = []
    orig_runner = fitter.runner

    class _Spy:
        def lower(self, *a, **k):
            runner_threads.append(threading.current_thread())
            return orig_runner.lower(*a, **k)

        def __call__(self, *a, **k):
            return orig_runner(*a, **k)

    fitter.runner = _Spy()
    with ThreadPoolExecutor(2) as pool:
        fitter.precompile_async(pool, total=8)
        fitter._pending.result()
    assert runner_threads and all(
        th is threading.main_thread() for th in runner_threads
    ), runner_threads


def test_lrt_entry_cache_keys_reproduce_across_processes(tmp_path):
    cache = str(tmp_path / "cc")
    os.makedirs(cache, exist_ok=True)
    env = dict(os.environ)

    outs = []
    for _ in range(2):
        proc = subprocess.run(
            [sys.executable, "-c", _SCRIPT, cache],
            capture_output=True, text=True, timeout=900, env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )
        assert proc.returncode == 0, proc.stderr[-3000:]
        outs.append(proc.stdout)
        entries = sorted(os.listdir(cache))
        big = [e for e in entries if e.startswith(_BIG)]
        outs.append(big)

    first_big, second_big = outs[1], outs[3]
    assert first_big, "run 1 persisted no pipeline programs — cache not active?"
    new = set(second_big) - set(first_big)
    assert not new, (
        "run 2 compiled pipeline programs run 1 already compiled — "
        f"cache keys are not reproducible across processes: {sorted(new)}"
    )
    # seeded end-to-end reproducibility rides along for free
    t1 = [l for l in outs[0].splitlines() if l.startswith("T_OBS")]
    t2 = [l for l in outs[2].splitlines() if l.startswith("T_OBS")]
    assert t1 == t2, (t1, t2)


def test_new_dataset_same_pattern_shares_all_programs(tmp_path):
    """Data-as-operands contract (round 5/6): every pipeline program is
    keyed on model structure + SHAPES only — the data series (y, diag)
    and the lightcurve mean are runtime operands.  A second dataset with
    the same observing pattern (same times/shapes, different flux values
    and flux level) must therefore add ZERO new pipeline-program entries
    to a warm cache.  This is the mechanism behind the measured K=12
    full-pipeline calibration drop (1841 s -> 268 s: 12-17 s per
    complete LRT after the first)."""
    cache = str(tmp_path / "cc")
    os.makedirs(cache, exist_ok=True)
    env = dict(os.environ)

    bigs = []
    for data_seed in (0, 1):
        proc = subprocess.run(
            [sys.executable, "-c", _SCRIPT, cache, str(data_seed)],
            capture_output=True, text=True, timeout=900, env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )
        assert proc.returncode == 0, proc.stderr[-3000:]
        bigs.append([e for e in sorted(os.listdir(cache)) if e.startswith(_BIG)])

    assert bigs[0], "run 1 persisted no pipeline programs — cache not active?"
    new = set(bigs[1]) - set(bigs[0])
    assert not new, (
        "a new dataset with the same observing pattern recompiled pipeline "
        f"programs — data leaked into a traced program as a constant: {sorted(new)}"
    )
