"""On-disk cache of exported (pre-traced) device programs.

The persistent XLA compilation cache removes backend COMPILES from warm
starts, but every process still pays the Python TRACE of each program
(the 10k LRT lowers ~9 programs at entry).  ``jax.export`` serializes a traced program to a
StableHLO artifact that later processes can deserialize in ~0 s and
compile straight from — skipping tracing entirely, and making the
compilation-cache key trivially stable (the artifact bytes on disk are
the single source of the program).

Keying and staleness: an artifact is valid only for the exact program
the current source would trace, so the key includes a fingerprint of
the package's own source files (content hash — any edit to the package
invalidates every artifact), the jax/jaxlib versions, the default
backend, the x64 flag, and a caller-supplied signature (program name +
shapes/dtypes/static config).  Artifacts live beside the XLA compile
cache: under ``$JAX_COMPILATION_CACHE_DIR/programs`` when that is set,
else in the checkout's ``.cache/programs``; ``MTG_TPU_NO_PROGRAM_CACHE=1``
disables the tier, ``MTG_TPU_PROGRAM_CACHE=<dir>`` relocates it.

Scope: XLA programs only — ``jax.export`` refuses the Triton custom
call of the GPU kernel, so kernel programs are lowered directly by
their callers.  Single-device programs replay as-is.  Multi-device
(mesh) programs are supported with two twists: the artifact key additionally carries the device context
(device count is already keyed; process count and device kinds are
added), and typed PRNG-key arguments cross the export boundary as raw
``key_data`` — replaying a serialized module that recorded a sharding
for a rank-0 typed-key aval fails MLIR verification ("sharding doesn't
match tensor rank: 0 != 1") because the replay call sees the physical
``uint32[2]``.  ``lower_via_cache`` wraps the program to take raw key
data and returns an executable shim that unwraps keys on call, so
callers keep passing typed keys.
Any failure (version skew, corrupt file, unexportable program) falls
back to tracing; the cache is an accelerator, never a correctness
dependency.
"""
from __future__ import annotations

import hashlib
import os
import threading
from typing import Optional

import jax

__all__ = ["exported_or_trace", "lower_via_cache", "program_cache_dir"]

_FINGERPRINT: Optional[str] = None
_FP_LOCK = threading.Lock()


def _package_fingerprint() -> str:
    """Content hash of every .py file in the package (memoized)."""
    global _FINGERPRINT
    with _FP_LOCK:
        if _FINGERPRINT is None:
            root = os.path.dirname(os.path.abspath(__file__))
            h = hashlib.sha256()
            for dirpath, dirnames, filenames in sorted(os.walk(root)):
                dirnames.sort()
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        p = os.path.join(dirpath, fn)
                        h.update(os.path.relpath(p, root).encode())
                        with open(p, "rb") as f:
                            h.update(f.read())
            _FINGERPRINT = h.hexdigest()[:24]
    return _FINGERPRINT


def program_cache_dir() -> Optional[str]:
    """Artifact directory: ``MTG_TPU_PROGRAM_CACHE``, else beside the
    compile cache (``$JAX_COMPILATION_CACHE_DIR/programs``), else the
    checkout's ``.cache/programs``; None when the tier is disabled."""
    if os.environ.get("MTG_TPU_NO_PROGRAM_CACHE"):
        return None
    d = os.environ.get("MTG_TPU_PROGRAM_CACHE")
    if d:
        return d
    jax_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if jax_dir:
        return os.path.join(jax_dir, "programs")
    from mind_the_gaps_tpu import CACHE_ROOT

    return os.path.join(CACHE_ROOT, "programs")


def _artifact_path(signature: str) -> Optional[str]:
    d = program_cache_dir()
    if d is None:
        return None
    try:
        import jaxlib

        jaxlib_version = getattr(jaxlib, "__version__", "unknown")
    except ImportError:  # pragma: no cover
        jaxlib_version = "none"
    devices = jax.devices()
    key = hashlib.sha256(
        "|".join(
            [
                signature,
                _package_fingerprint(),
                jax.__version__,
                jaxlib_version,
                jax.default_backend(),
                str(len(devices)),
                str(jax.process_count()),
                repr(sorted({d.device_kind for d in devices})),
                str(jax.config.jax_enable_x64),
            ]
        ).encode()
    ).hexdigest()[:40]
    return os.path.join(d, key + ".jaxprog")


def exported_or_trace(signature: str, export_thunk):
    """Return a callable equivalent to the program ``export_thunk`` would
    trace: a deserialized on-disk artifact when one exists for this
    source/backend/signature, else the freshly exported program (written
    back to disk for the next process).

    ``export_thunk()`` must return a ``jax.export.Exported``.  The
    returned object's ``.call`` is the jit-able entry point.  Callers
    gate on single-device execution themselves.
    """
    from jax import export as jexport

    path = _artifact_path(signature)
    if path is not None and os.path.exists(path):
        try:
            with open(path, "rb") as f:
                return jexport.deserialize(bytearray(f.read()))
        except Exception:
            try:
                os.remove(path)
            except OSError:
                pass
    exported = export_thunk()
    if path is not None:
        try:
            blob = exported.serialize()
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + f".tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)
            _prune(os.path.dirname(path))
        except Exception:
            pass  # cache write failures never break the pipeline
    return exported


_MAX_ARTIFACTS = 256


def _prune(d: str) -> None:
    """Bound the artifact directory: artifacts key on data hashes, so a
    survey over many lightcurves would grow it without bound.  Keep the
    newest _MAX_ARTIFACTS by mtime."""
    entries = [e for e in os.listdir(d) if e.endswith(".jaxprog")]
    if len(entries) <= _MAX_ARTIFACTS:
        return
    paths = [os.path.join(d, e) for e in entries]
    paths.sort(key=lambda p: os.path.getmtime(p), reverse=True)
    for p in paths[_MAX_ARTIFACTS:]:
        try:
            os.remove(p)
        except OSError:
            pass


class _CompilableExported:
    """Duck-types the ``.compile()`` of a ``jax.stages.Lowered`` over an
    exported artifact: wrapping the artifact's ``.call`` in jit and
    lowering it is cheap (the StableHLO module already exists — no
    retracing of the original program).  An artifact that fails to
    re-lower/compile (version or device-context skew that survived
    deserialization) is deleted and the program retraced.

    ``key_ix`` marks typed PRNG-key argument positions: the exported
    program takes raw ``key_data`` there (see module docstring), so the
    compiled executable is returned behind a shim that unwraps keys on
    call — callers keep the typed-key calling convention either way."""

    def __init__(self, exported, args, fallback, path, key_ix=()):
        self._exported = exported
        self._args = args
        self._fallback = fallback
        self._path = path
        self._key_ix = tuple(key_ix)

    def compile(self):
        try:
            compiled = jax.jit(self._exported.call).lower(*self._args).compile()
        except Exception:
            if self._path:
                try:
                    os.remove(self._path)
                except OSError:
                    pass
            return self._fallback().compile()
        if not self._key_ix:
            return compiled
        return _UnkeyingExecutable(compiled, self._key_ix)


class _UnkeyingExecutable:
    """Callable shim over a compiled exported program whose PRNG-key
    arguments were exported as raw key data."""

    def __init__(self, compiled, key_ix):
        self._compiled = compiled
        self._key_ix = key_ix

    def __call__(self, *args):
        args = list(args)
        for i in self._key_ix:
            args[i] = jax.random.key_data(args[i])
        return self._compiled(*args)


def _is_key_aval(a) -> bool:
    try:
        return jax.dtypes.issubdtype(a.dtype, jax.dtypes.prng_key)
    except Exception:
        return False


def _key_data_aval(a):
    """The raw-data form of a typed-key array or ShapeDtypeStruct."""
    if isinstance(a, jax.ShapeDtypeStruct):
        # default threefry keys: () key -> (2,) uint32 payload
        import numpy as _np

        return jax.ShapeDtypeStruct(tuple(a.shape) + (2,), _np.uint32)
    return jax.random.key_data(a)


def lower_via_cache(signature: str, jit_fn, args, static_kwargs=None):
    """A Lowered-like object for ``jit_fn(*args, **static_kwargs)``.

    Loads the pre-traced artifact for ``signature`` when one matches,
    else traces via ``jax.export`` (persisting the artifact).  The
    ``signature`` must describe every closure constant of the program
    (argument shapes/dtypes/shardings are appended here defensively).
    Any export/deserialize/replay failure falls back to a plain
    ``.lower()``.

    Multi-device processes are supported: the artifact key carries the
    device context (count/process count/kinds — an 8-device process
    never loads a single-device artifact), and typed PRNG-key
    arguments are rewritten to raw ``key_data`` across the export
    boundary (replaying a recorded rank-0 key sharding fails MLIR
    verification under a mesh).  Callers must put the mesh topology in
    ``signature`` when the program closes over one."""
    import numpy as _np

    kw = dict(static_kwargs or {})
    if program_cache_dir() is None:
        # tier disabled: exporting without a disk cache is pure overhead
        return jit_fn.lower(*args, **kw)
    multi_device = len(jax.devices()) != 1

    def _shard_desc(a):
        s = getattr(a, "sharding", None)
        if s is None:
            return ""
        try:
            return f"@{getattr(s, 'spec', s)}"
        except Exception:
            return "@?"

    aval_sig = ";".join(
        f"{tuple(_np.shape(a))}:{getattr(a, 'dtype', type(a).__name__)}"
        + (_shard_desc(a) if multi_device else "")
        for a in args
    )
    full_sig = signature + "|" + aval_sig
    try:
        from jax import export as jexport

        if multi_device:
            # typed keys cross the boundary as raw data (module docstring)
            key_ix = tuple(i for i, a in enumerate(args) if _is_key_aval(a))
            if key_ix:
                def rekeyed(*raw):
                    full = list(raw)
                    for i in key_ix:
                        full[i] = jax.random.wrap_key_data(full[i])
                    return jit_fn(*full, **kw)

                export_fn = jax.jit(rekeyed)
                export_args = tuple(
                    _key_data_aval(a) if i in key_ix else a for i, a in enumerate(args)
                )
                export_kw = {}
            else:
                export_fn, export_args, export_kw = jit_fn, tuple(args), kw
        else:
            key_ix = ()
            export_fn, export_args, export_kw = jit_fn, tuple(args), kw

        exported = exported_or_trace(
            full_sig, lambda: jexport.export(export_fn)(*export_args, **export_kw)
        )
        return _CompilableExported(
            exported, export_args,
            fallback=lambda: jit_fn.lower(*args, **kw),
            path=_artifact_path(full_sig),
            key_ix=key_ix,
        )
    except Exception:
        return jit_fn.lower(*args, **kw)
