"""Native runtime pieces (C, loaded via ctypes).

The host's hot loops that are not kernels live here as small C
translation units compiled on demand with the system compiler and
loaded through ctypes (no pybind11; ctypes keeps the build
dependency-free).  Every user degrades gracefully to its pure-Python
path when no compiler is available.

Currently: wtrace_replay.c -- the witness-tape interpreter
(compiler/wtrace.py replay at C speed).  The library is built from this
package's copy of the source into ``za_tpu_torch/_build/native/`` at
first use (``CC`` names the compiler to try first).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
from typing import Optional

log = logging.getLogger("za_tpu_torch")

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIBS: dict = {}


def _cache_dir() -> str:
    d = os.path.join(os.path.dirname(_DIR), "_build", "native")
    os.makedirs(d, exist_ok=True)
    return d


def _build(src_path: str, tag: str) -> Optional[str]:
    """Compile src to a cached shared library; None if no toolchain.

    -march=native is tried first (the library is built on the machine
    it runs on; BMI2/ADX carry chains ~1.5x the Montgomery loop) with
    a portable -O3 fallback."""
    with open(src_path, "rb") as f:
        src = f.read()
    digest = hashlib.blake2b(src, digest_size=12).hexdigest()
    flag_sets = [
        ["-O3", "-march=native", "-funroll-loops"],
        ["-O3"],
    ]
    for flags in flag_sets:
        fdig = hashlib.blake2b(
            " ".join(flags).encode(), digest_size=4
        ).hexdigest()
        out = os.path.join(_cache_dir(), f"{tag}-{digest}-{fdig}.so")
        if os.path.exists(out):
            return out
        for cc in (os.environ.get("CC"), "cc", "gcc", "clang"):
            if not cc:
                continue
            tmp = tempfile.NamedTemporaryFile(
                dir=_cache_dir(), suffix=".so.tmp", delete=False
            )
            tmp.close()
            cmd = [cc, *flags, "-fPIC", "-shared", "-o", tmp.name,
                   src_path]
            try:
                subprocess.run(
                    cmd, check=True, capture_output=True, timeout=120
                )
                os.replace(tmp.name, out)
                return out
            except (OSError, subprocess.SubprocessError) as exc:
                log.debug("native build with %s failed: %s", cc, exc)
                try:
                    os.unlink(tmp.name)
                except OSError:
                    pass
    return None


def wtrace_lib() -> Optional[ctypes.CDLL]:
    """The witness-replay library, or None when unbuildable."""
    if "wtrace" in _LIBS:
        return _LIBS["wtrace"]
    lib = None
    try:
        path = _build(
            os.path.join(_DIR, "wtrace_replay.c"), "wtrace_replay"
        )
        if path:
            lib = ctypes.CDLL(path)
            lib.za_wtrace_replay.restype = ctypes.c_int
            lib.za_wtrace_replay.argtypes = [
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_int64),
            ]
    except OSError as exc:  # load failure: fall back to Python
        log.info("native wtrace unavailable (%s)", exc)
        lib = None
    _LIBS["wtrace"] = lib
    return lib
