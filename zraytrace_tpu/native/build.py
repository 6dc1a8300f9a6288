"""Build-and-load for the native components.

Compiles ``native/*.cpp`` into one shared library on first use with g++
(cached under ``<checkout>/.native_cache``, keyed by a source hash) and
binds it with ctypes. No pybind11 — plain C ABI.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
from pathlib import Path

from zraytrace_tpu.runtime import CHECKOUT

_SOURCES = ["bvh_builder.cpp", "obj_parser.cpp"]
_LIB = None
_TRIED = False


def _src_dir() -> Path:
    return Path(__file__).resolve().parent


def _cache_dir() -> Path:
    d = Path(
        os.environ.get(
            "ZRAYTRACE_NATIVE_CACHE",
            CHECKOUT / ".native_cache",
        )
    )
    d.mkdir(parents=True, exist_ok=True)
    return d


def load_library():
    """Return the ctypes library, building it if needed; None on failure."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        srcs = [p for p in (_src_dir() / s for s in _SOURCES) if p.exists()]
        if not srcs:
            return None
        digest = hashlib.sha256(
            b"".join(p.read_bytes() for p in srcs)
        ).hexdigest()[:16]
        so = _cache_dir() / f"libzrt_{digest}.so"
        if not so.exists():
            cmd = [
                "g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                "-o", str(so), *map(str, srcs),
            ]
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        _LIB = ctypes.CDLL(str(so))
    except Exception as e:  # pragma: no cover - toolchain-dependent
        print(f"[zraytrace_tpu.native] build failed, using Python fallback: {e}",
              file=sys.stderr)
        _LIB = None
    return _LIB


def native_available() -> bool:
    return load_library() is not None
