"""Build the CUDA sources under ``csrc/`` with nvcc at first use and bind
their C entry points with ctypes.

Each ``csrc/*.cu`` becomes one shared library, compiled by its own nvcc
process (all started together) for ``sm_90a`` into
``za_tpu_torch/_build/<digest>/``, where the digest hashes every source
under ``csrc/``: a changed source rebuilds, an unchanged one loads.
Nothing here runs at import time; a machine without nvcc or a card
only meets this module when a CUDA tensor reaches a kernel wrapper.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_ROOT = PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _digest() -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build_dir() -> Path:
    return BUILD_ROOT / _digest()


def build_all() -> dict[str, float]:
    """Compile every csrc/*.cu that is not built yet, one nvcc each,
    concurrently.  Returns {source: seconds} for the sources built now;
    the compiler's output (registers, spills) lands in <name>.log."""
    with _lock:
        out = build_dir()
        out.mkdir(parents=True, exist_ok=True)
        todo = [s for s in sorted(CSRC.glob("*.cu"))
                if not (out / f"lib{s.stem}.so").exists()]
        procs = []
        for src in todo:
            tmp = out / f"lib{src.stem}.so.{os.getpid()}.tmp"
            log = open(out / f"{src.stem}.log", "w")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((src, tmp, log, time.monotonic(),
                          subprocess.Popen(cmd, stdout=log,
                                           stderr=subprocess.STDOUT)))
        times, failed = {}, []
        for src, tmp, log, t0, proc in procs:
            rc = proc.wait()
            log.close()
            times[src.name] = time.monotonic() - t0
            if rc != 0:
                failed.append(src.name)
                continue
            os.replace(tmp, out / f"lib{src.stem}.so")
        if failed:
            logs = "\n".join(
                (out / f"{Path(f).stem}.log").read_text()[-4000:]
                for f in failed)
            raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
        return times


def library(source: str) -> ctypes.CDLL:
    """The loaded shared library of csrc/<source>.cu (built if needed)."""
    lib = _libs.get(source)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(build_dir() / f"lib{source}.so"))
        lib.za_error_string.restype = ctypes.c_char_p
        lib.za_error_string.argtypes = [ctypes.c_int]
        _libs[source] = lib
    return lib


class Kernel:
    """One C entry point of csrc/<source>.cu.  ``argspec`` gives its
    arguments before the trailing stream: "p" a tensor (passed as its
    data pointer), "i" an int.  ``launches`` counts the launches made
    through this wrapper, and nothing else."""

    def __init__(self, name: str, source: str, argspec: str):
        self.name = name
        self.source = source
        self.argspec = argspec
        self.launches = 0
        self._fn = None

    def _resolve(self):
        if self._fn is None:
            fn = getattr(library(self.source), self.name)
            fn.restype = ctypes.c_int
            fn.argtypes = [
                ctypes.c_void_p if k == "p" else ctypes.c_int
                for k in self.argspec
            ] + [ctypes.c_void_p]
            self._fn = fn
        return self._fn

    def __call__(self, *args):
        if len(args) != len(self.argspec):
            raise TypeError(f"{self.name}: {len(self.argspec)} arguments, "
                            f"got {len(args)}")
        cargs = []
        for k, a in zip(self.argspec, args):
            if k == "p":
                if not (a.is_cuda and a.is_contiguous()):
                    raise ValueError(
                        f"{self.name}: tensor arguments must be contiguous "
                        f"CUDA tensors")
                cargs.append(a.data_ptr())
            else:
                cargs.append(int(a))
        fn = self._resolve()
        rc = fn(*cargs, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            msg = library(self.source).za_error_string(rc).decode()
            raise RuntimeError(f"{self.name}: CUDA error {rc}: {msg}")
        self.launches += 1


#: every kernel wrapper of the package, by entry-point name
KERNELS: dict[str, Kernel] = {}


def kernel(name: str, source: str, argspec: str) -> Kernel:
    k = Kernel(name, source, argspec)
    KERNELS[name] = k
    return k


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0
