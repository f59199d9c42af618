"""Build and load the hand-written CUDA kernels.

Every ``csrc/<name>.cu`` exports plain C launch functions. They are compiled
by ``nvcc`` for Hopper (``sm_90a``) into one shared library,
``<repo>/build/kernels/librap_kernels-<hash>.so``, loaded once with
``ctypes``. The hash covers the sources and the flags, so an unchanged tree
is compiled once. :func:`build` starts one ``nvcc -c`` per source at once,
then links the objects.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("swiglu", "paged_decode_attention", "flash_attention")
# src/repro_torch/kernels/build.py -> <repo>/build/kernels
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

_LIB: Optional[ctypes.CDLL] = None


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are compiled at first use")


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode() + p.read_bytes())
    return BUILD_DIR / f"librap_kernels-{h.hexdigest()[:16]}.so"


def _wait(proc: subprocess.Popen, what: str) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {what} "
                           f"(exit {proc.returncode}):\n{log}")


def build() -> Path:
    """The library's path, compiling it first if it is missing."""
    out = lib_path()
    if out.exists():
        return out
    # a private directory, renamed into place: another process may be
    # building or loading the same library
    tmp = BUILD_DIR / f"{out.stem}.{os.getpid()}.tmp"
    tmp.mkdir(parents=True, exist_ok=True)

    def run(args):
        return subprocess.Popen([nvcc(), *args], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    objs = [str(tmp / f"{n}.o") for n in SOURCES]
    procs = [run([*NVCC_FLAGS, "-c", "-o", o, str(CSRC / f"{n}.cu")])
             for n, o in zip(SOURCES, objs)]
    for n, p in zip(SOURCES, procs):
        _wait(p, f"{n}.cu")
    _wait(run([*ARCH, "-shared", "-o", str(tmp / out.name), *objs]), "link")
    os.replace(tmp / out.name, out)
    shutil.rmtree(tmp, ignore_errors=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        _LIB = ctypes.CDLL(str(build()))
    return _LIB


P, I, LL, F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                 ctypes.c_float)


def function(symbol: str, argtypes: List) -> ctypes._CFuncPtr:
    """C launch function ``symbol`` with its argument types declared
    (pointers and the stream as ``c_void_p``, so ctypes never cuts a 64-bit
    address to an int)."""
    fn = getattr(library(), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1, "torch.float16": 2}


def dtype_code(t) -> int:
    code = DTYPE_CODES.get(str(t.dtype))
    if code is None:
        raise TypeError(f"kernels take float32/bfloat16/float16, got {t.dtype}")
    return code
