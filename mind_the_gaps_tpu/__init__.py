"""mind_the_gaps_tpu — (quasi-)periodicity detection in irregularly-sampled
astronomical lightcurves on a JAX accelerator.

A ground-up JAX/XLA re-design of the capabilities of
``andresgur/mind_the_gaps`` (GP modelling with celerite-style kernels,
TK95/E13 lightcurve simulation, ensemble MCMC, Protassov et al. 2002
posterior-predictive likelihood-ratio tests):

- the celerite O(N) semiseparable Cholesky factorization is a pure-JAX
  ``lax.scan`` / associative-scan kernel with autodiff support, plus a
  Pallas-Triton GPU kernel for the batched likelihood (ops/),
- the affine-invariant ensemble sampler is fully vectorized so
  (simulations x walkers) log-likelihoods evaluate as one batched kernel,
- the Timmer & Koenig / Emmanoulopoulos simulators run as batched
  on-device FFTs,
- batch axes (walkers, bootstrap simulations, kernel hypotheses) shard
  across a ``jax.sharding.Mesh`` via ``shard_map``/``NamedSharding``.

Precision: GP likelihood parity with celerite requires float64
(see reference gpmodelling.py:54 — celerite computes in double).  Importing
this package enables JAX x64 mode unless ``MTG_TPU_X64=0`` is set.
"""
from __future__ import annotations

import os

import jax

if os.environ.get("MTG_TPU_X64", "1") != "0":
    jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: the production pipeline re-runs the same
# few programs (observed-fit sampler, bootstrap runners) across
# processes.  JAX_COMPILATION_CACHE_DIR, when set, is used as it is;
# otherwise the cache lives at a fixed path inside the checkout
# (CACHE_ROOT/jax/host-<ISA>, gitignored).  Disable with
# MTG_TPU_NO_COMPILE_CACHE=1.
CACHE_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".cache")


def _cpuid_feature_words():
    """Raw CPUID feature leaves + XCR0, read directly from the hardware.

    LLVM's host-feature detection (what XLA:CPU embeds in AOT
    executables) reads CPUID from userspace, NOT /proc/cpuinfo — and two
    virtual machines can present byte-identical cpuinfo (generic
    hypervisor model string, filtered flag list) while differing in real
    CPUID (one with AVX-512/AMX, one without).  So the fingerprint must
    come from the same source LLVM uses.  Queried leaves are exactly the
    feature-relevant ones (1, 7.0-7.2, 0xD.0/1, 0x80000001,
    0x80000008) plus XCR0 via xgetbv (OS-enabled vector state gates
    AVX/AVX-512 in LLVM's detection); leaf 1 EBX is masked — its high
    byte is the executing core's APIC ID, which varies run to run.
    """
    import ctypes
    import mmap

    # shellcode: cpuid(eax=edi, ecx=esi) -> [rdx]; xgetbv when edi==-1
    code = bytes([
        0x53,                    # push rbx
        0x49, 0x89, 0xd1,        # mov r9, rdx   (out ptr)
        0x83, 0xff, 0xff,        # cmp edi, -1
        0x74, 0x17,              # je xgetbv (+23: the cpuid branch below)
        0x89, 0xf8,              # mov eax, edi
        0x89, 0xf1,              # mov ecx, esi
        0x0f, 0xa2,              # cpuid
        0x41, 0x89, 0x01,        # mov [r9], eax
        0x41, 0x89, 0x59, 0x04,  # mov [r9+4], ebx
        0x41, 0x89, 0x49, 0x08,  # mov [r9+8], ecx
        0x41, 0x89, 0x51, 0x0c,  # mov [r9+12], edx
        0x5b,                    # pop rbx
        0xc3,                    # ret
        # xgetbv(ecx=esi):
        0x89, 0xf1,              # mov ecx, esi
        0x0f, 0x01, 0xd0,        # xgetbv
        0x41, 0x89, 0x01,        # mov [r9], eax
        0x41, 0x89, 0x51, 0x04,  # mov [r9+4], edx
        0x41, 0xc7, 0x41, 0x08, 0x00, 0x00, 0x00, 0x00,  # [r9+8] = 0
        0x41, 0xc7, 0x41, 0x0c, 0x00, 0x00, 0x00, 0x00,  # [r9+12] = 0
        0x5b,                    # pop rbx
        0xc3,                    # ret
    ])
    buf = mmap.mmap(-1, len(code), prot=mmap.PROT_READ | mmap.PROT_WRITE | mmap.PROT_EXEC)
    buf.write(code)
    addr = ctypes.addressof(ctypes.c_char.from_buffer(buf))
    fn = ctypes.CFUNCTYPE(None, ctypes.c_int32, ctypes.c_uint32, ctypes.c_void_p)(addr)
    out = (ctypes.c_uint32 * 4)()

    def q(leaf, sub=0):
        fn(leaf, sub, ctypes.byref(out))
        return tuple(out)

    words = []
    maxleaf = q(0)[0]
    a, b, c, d = q(1)
    words.append((1, 0, a, b & 0x00FFFFFF, c, d))  # mask the APIC ID byte
    if maxleaf >= 7:
        maxsub = q(7, 0)[0]
        for s in range(0, min(maxsub, 2) + 1):
            words.append((7, s) + q(7, s))
    if maxleaf >= 0xD:
        words.append((0xD, 0) + q(0xD, 0))
        words.append((0xD, 1) + q(0xD, 1))
    # OS-enabled state (xgetbv) if OSXSAVE is set
    if c & (1 << 27):
        words.append((-1, 0) + q(-1, 0))
    maxext = q(0x80000000)[0]
    for leaf in (0x80000001, 0x80000008):
        if maxext >= leaf:
            words.append((leaf, 0) + q(leaf, 0))
    del fn
    buf.close()
    return words


def _host_isa_fingerprint() -> str:
    """Short stable fingerprint of the host CPU's ISA feature set.

    XLA:CPU AOT executables embed the compile machine's target features;
    loading one on a host with a *different* ISA can SIGILL (observed as
    cpu_aot_loader "machine type doesn't match" errors when a cache
    directory written on one machine generation is reused on another).
    Partitioning the default cache directory by the hardware CPUID
    feature leaves (see ``_cpuid_feature_words`` — /proc/cpuinfo is NOT
    a reliable basis) keeps homogeneous hosts sharing a cache while
    making cross-ISA reuse impossible — JAX's cache key does not include
    CPU features, and the host-CPU MAP fit compiles XLA:CPU programs.
    The split only costs a re-warm when the host's CPU generation
    changes.

    The basis also includes the CPU model name and core count, since
    XLA's codegen tuning follows the detected model.  NOTE the
    ``prefer-no-gather``/``prefer-no-scatter`` loader warnings are NOT
    evidence of a cross-host load: they fire on every XLA:CPU cache
    load, same-host included (see ``_logfilter.py``).
    """
    import platform
    import zlib

    flags = model = ""
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("flags") and not flags:
                    flags = " ".join(sorted(line.split(":", 1)[1].split()))
                elif line.startswith("model name") and not model:
                    model = line.split(":", 1)[1].strip()
                if flags and model:
                    break
    except OSError:
        pass
    try:
        cpuid = repr(_cpuid_feature_words())
    except Exception:  # non-x86, W^X mmap denied, ... — cpuinfo-only basis
        cpuid = "no-cpuid"
    basis = f"{platform.machine()}|{model}|{os.cpu_count()}|{flags}|{cpuid}".encode()
    return f"{zlib.crc32(basis) & 0xFFFFFFFF:08x}"


if (
    os.environ.get("MTG_TPU_NO_COMPILE_CACHE", "0") != "1"
    and not os.environ.get("JAX_COMPILATION_CACHE_DIR")
    and not jax.config.jax_compilation_cache_dir
):
    _cache_root = os.path.join(CACHE_ROOT, "jax")
    _cache_dir = os.path.join(_cache_root, f"host-{_host_isa_fingerprint()}")
    try:
        os.makedirs(_cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", _cache_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
        # prune sibling host-* dirs not touched in 14 days: a checkout
        # moved between machines would otherwise accumulate one dir per
        # CPU generation
        import shutil as _shutil
        import time as _time

        for _e in os.listdir(_cache_root):
            _p = os.path.join(_cache_root, _e)
            if (
                _e.startswith("host-")
                and _p != _cache_dir
                and os.path.isdir(_p)
                and os.path.getmtime(_p) < _time.time() - 14 * 86400
            ):
                _shutil.rmtree(_p, ignore_errors=True)
    except OSError:
        pass

# Every XLA:CPU cache LOAD logs a bogus feature-mismatch ERROR for the
# prefer-no-scatter/gather tuning pseudo-features — even for an
# artifact this host wrote moments ago (upstream: the loader compares
# against LLVM host detection, which never reports tuning
# pseudo-features), and regardless of WHICH cache dir is configured.
# Filter exactly those lines; real-ISA mismatch lines pass through.
# See _logfilter.py; MTG_TPU_NO_LOG_FILTER=1 disables.
from mind_the_gaps_tpu import _logfilter as _logfilter  # noqa: E402

_logfilter.install()

__version__ = "0.1.0"

from mind_the_gaps_tpu.lightcurves import (  # noqa: E402
    GappyLightcurve,
    SimpleLightcurve,
    SwiftLightcurve,
    FermiLightcurve,
)

__all__ = [
    "GappyLightcurve",
    "SimpleLightcurve",
    "SwiftLightcurve",
    "FermiLightcurve",
    "__version__",
]


def __getattr__(name):
    # lazy: avoid importing the heavy inference stack at package import
    if name == "GPModelling":
        from mind_the_gaps_tpu.gpmodelling import GPModelling

        return GPModelling
    if name == "AutocorrError":
        from mind_the_gaps_tpu.gpmodelling import AutocorrError

        return AutocorrError
    if name == "Simulator":
        from mind_the_gaps_tpu.simulator import Simulator

        return Simulator
    if name == "protassov_lrt":
        from mind_the_gaps_tpu.lrt import protassov_lrt

        return protassov_lrt
    raise AttributeError(f"module 'mind_the_gaps_tpu' has no attribute {name!r}")
