"""Where the caches go: ``$JAX_COMPILATION_CACHE_DIR`` when it is set
(the package then sets no other compile cache), else a fixed path inside
the checkout.  Each case imports the package in a fresh process."""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import json
import jax
import mind_the_gaps_tpu
from mind_the_gaps_tpu.program_cache import program_cache_dir
print(json.dumps({"jax": jax.config.jax_compilation_cache_dir, "programs": program_cache_dir(),
                  "root": mind_the_gaps_tpu.CACHE_ROOT}))
"""


def _dirs(env_update, drop=()):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **env_update)
    for k in ("JAX_COMPILATION_CACHE_DIR", "MTG_TPU_NO_COMPILE_CACHE", "MTG_TPU_PROGRAM_CACHE",
              "MTG_TPU_NO_PROGRAM_CACHE") + tuple(drop):
        if k not in env_update:
            env.pop(k, None)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_cache_dir_is_env_var_when_set(tmp_path):
    d = str(tmp_path / "jaxcache")
    out = _dirs({"JAX_COMPILATION_CACHE_DIR": d})
    assert out["jax"] == d
    assert out["programs"] == os.path.join(d, "programs")


def test_cache_dir_defaults_inside_the_checkout():
    out = _dirs({})
    root = os.path.join(ROOT, ".cache")
    assert out["root"] == root
    assert os.path.dirname(out["jax"]) == os.path.join(root, "jax")
    assert os.path.basename(out["jax"]).startswith("host-")
    assert out["programs"] == os.path.join(root, "programs")
