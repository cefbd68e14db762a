"""Fast table loading backed by the _fastio C extension.

The native tier of the data layer (SURVEY.md §2.9-bis: the reference has
no in-repo native code; here the host-side bulk IO is C).  The extension
is compiled on demand with the system compiler into the package tree; if
no compiler is available everything falls back to numpy parsing with the
same semantics, so the package never hard-requires the build.

API:
- ``load_table(path)`` -> (N, C) float64 array (QDP 'NO' -> NaN,
  comment/header lines skipped).
- ``load_columns(path)`` -> dict of column name -> array when the file
  has a header line, else numbered columns.
- ``load_directory(paths, workers=8)`` -> list of arrays, parsed in a
  thread pool (the C parser releases the GIL).
"""
from __future__ import annotations

import os
import sysconfig
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Optional

import numpy as np

__all__ = ["load_table", "load_columns", "load_directory", "have_native", "build_native"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_fastio = None
_build_attempted = False


def _ext_path() -> str:
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return os.path.join(_HERE, "_fastio" + suffix)


def build_native(force: bool = False) -> bool:
    """Compile _fastio.c into the package directory.  Returns success."""
    import subprocess

    out = _ext_path()
    src = os.path.join(_HERE, "_fastio.c")
    if not force and os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return True
    include = sysconfig.get_paths()["include"]
    cc = os.environ.get("CC", "cc")
    cmd = [cc, "-O3", "-shared", "-fPIC", f"-I{include}", src, "-o", out]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if res.returncode != 0:
            warnings.warn(f"_fastio build failed: {res.stderr[-500:]}")
            return False
        return True
    except (OSError, subprocess.TimeoutExpired) as exc:
        warnings.warn(f"_fastio build unavailable: {exc}")
        return False


def _get_native():
    """Import the extension, building it on first use."""
    global _fastio, _build_attempted
    if _fastio is not None:
        return _fastio
    if _build_attempted:
        return None
    _build_attempted = True
    # (re)build when missing or older than its source: a binary copied
    # in from another checkout or machine is never trusted blindly
    if not build_native():
        return None
    try:
        import importlib.util

        spec = importlib.util.spec_from_file_location("mind_the_gaps_tpu.io._fastio", _ext_path())
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _fastio = mod
    except Exception as exc:  # pragma: no cover - platform specific
        warnings.warn(f"_fastio import failed: {exc}")
        _fastio = None
    return _fastio


def have_native() -> bool:
    return _get_native() is not None


def _parse_numpy(data: bytes):
    """Pure-numpy fallback with the same line semantics as the C parser."""
    rows: List[List[float]] = []
    ncols = -1
    nskipped = 0
    for raw in data.decode("utf-8", errors="replace").splitlines():
        line = raw.strip().lstrip(",")
        if not line or line[0] in "!#;%":
            continue
        toks = line.replace(",", " ").split()
        vals = []
        ok = True
        for tok in toks:
            if tok.upper() == "NO" or tok.lower() == "nan":
                vals.append(np.nan)
                continue
            try:
                vals.append(float(tok))
            except ValueError:
                ok = False
                break
        if not ok or not vals:
            if ncols >= 0:
                nskipped += 1
            continue
        if ncols < 0:
            ncols = len(vals)
        if len(vals) != ncols:
            nskipped += 1
            continue
        rows.append(vals)
    arr = np.asarray(rows, dtype=np.float64) if rows else np.empty((0, max(ncols, 0)))
    return arr, nskipped


def parse_bytes(data: bytes, warn_skipped: bool = False) -> np.ndarray:
    """Parse an in-memory table; (N, C) float64 (always writable).

    ``warn_skipped``: emit a warning when malformed/ragged rows were
    dropped (the C parser collapses consecutive delimiters, so e.g. an
    empty CSV field makes the row ragged and silently skipped otherwise).
    """
    mod = _get_native()
    if mod is not None:
        buf, nrows, ncols, nskipped = mod.parse_table(data)
        # copy: frombuffer over the returned bytes is read-only, and the
        # numpy fallback returns writable arrays — keep the tiers equal
        arr = (
            np.frombuffer(buf, dtype=np.float64)
            .reshape(nrows, ncols if nrows else 0)
            .copy()
        )
    else:
        arr, nskipped = _parse_numpy(data)
    if warn_skipped and nskipped:
        warnings.warn(
            f"table parse skipped {nskipped} malformed row(s) "
            "(ragged column count — empty delimited fields collapse)"
        )
    return arr


def load_table(path: str, warn_skipped: bool = True) -> np.ndarray:
    with open(path, "rb") as fh:
        return parse_bytes(fh.read(), warn_skipped=warn_skipped)


def _header_names(path: str) -> Optional[List[str]]:
    """Column names from the first non-empty line when it is a header."""
    with open(path, "r", errors="replace") as fh:
        for raw in fh:
            line = raw.strip()
            if not line:
                continue
            line = line.lstrip("!#;% ")
            toks = line.replace(",", " ").split()
            if not toks:
                continue
            try:
                float(toks[0])
                return None  # data line first: no header
            except ValueError:
                return toks
    return None


def load_columns(path: str) -> Dict[str, np.ndarray]:
    arr = load_table(path)
    names = _header_names(path)
    if names is None or len(names) != arr.shape[1]:
        names = [f"col{i}" for i in range(arr.shape[1])]
    return {name: arr[:, i] for i, name in enumerate(names)}


def load_directory(paths: Iterable[str], workers: int = 8) -> List[np.ndarray]:
    """Parse many files concurrently (the C parser releases the GIL, so
    threads give real parallelism; numpy fallback degrades gracefully)."""
    paths = list(paths)
    if not paths:
        return []
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(load_table, paths))
