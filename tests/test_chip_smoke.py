"""chip_smoke.py's phases at a tiny size on the CPU (the kernel through
the Pallas interpreter), and its refusal to report without a GPU."""
import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

TINY_LRT = dict(nsims=7, observed_max_steps=40, observed_walkers=8, sim_max_steps=10, chunk=8)


def test_kernel_parity_phase_tiny(interpret_kernels):
    out = chip_smoke.kernel_parity(n_points=48, groups=4, repeats=3, shared_lanes=4, r6_points=40, r6_groups=2)
    assert set(out) == {"grouped", "shared", "R6_grouped"}
    assert all(r["f64_max_rel"] <= chip_smoke.F64_RTOL for r in out.values())


def test_kernel_timing_phase_tiny(interpret_kernels):
    out = chip_smoke.kernel_timing(half_lanes=12, sweep_lanes=16, n_points=32, unrolls=(1,))
    assert out["half_update"]["lanes"] == 12 and out["sweep"]["lanes"] == 16
    assert out["half_update"]["kernel_ms"] > 0 and out["half_update"]["xla_unroll1_ms"] > 0


def test_lognormal_phase_tiny():
    out = chip_smoke.lognormal(n_points=40, sims=4, sort_shape=(2, 64))
    assert out["lcs_per_s"] > 0 and out["sort_key_val_ms"] > 0


def test_map_fit_phase_tiny():
    out = chip_smoke.map_fit(n_points=80)
    assert abs(out["nll_cpu"] - out["nll_device"]) <= 1e-3 * max(1.0, abs(out["nll_cpu"]))


def test_derive_posteriors_phase_tiny():
    out = chip_smoke.derive_posteriors(n_points=80, max_steps=40, walkers=8)
    assert out["abs_err_vs_f64"] <= 1e-5


def test_lrt_phase_tiny():
    out = chip_smoke.lrt(n_points=60, **TINY_LRT)
    assert len(out["t_dist"]) == TINY_LRT["nsims"] and 0.0 <= out["p_value"] <= 1.0


def test_chunk_refit_phase_tiny(interpret_kernels):
    out = chip_smoke.chunk_refit(sims=4, n_points=32, steps=3)
    assert out["pallas_null_plus_alt_s"] > 0 and "memory_analysis_alt" in out


def test_multi_device_phase_on_virtual_devices(interpret_kernels):
    """The four-card phase's body on the 8 virtual CPU devices: kernel
    path with and without the mesh, per-device shards, the LRT."""
    import jax

    assert len(jax.devices()) == 8
    out = chip_smoke.multi_device(n_points=40, sims=16, steps=4, lrt_kwargs=TINY_LRT, backend="pallas")
    assert out["devices"] == 8 and out["fit_mesh_vs_one_max_abs"] <= chip_smoke.T_ATOL
    assert len(out["lrt"]["t_dist"]) == TINY_LRT["nsims"]


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_gpu_exits_nonzero_without_result():
    proc = _run(ROOT, "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "no GPU" in proc.stderr + proc.stdout


def test_alone_in_a_directory_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    proc = _run(str(tmp_path), "chip_smoke.py")
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
