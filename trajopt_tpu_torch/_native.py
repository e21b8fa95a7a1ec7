"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each source compiles with ``nvcc`` into a shared library with a plain C
interface, loaded with ctypes (no PyTorch headers: a build takes seconds).
The build happens at first use, into ``_build/`` beside this file, named by
a hash of the source so an edited source rebuilds; all sources compile in
parallel.  Nothing here runs at import time.

``LAUNCHES`` counts launches per kernel: each wrapper adds one where it
launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_double
# C signatures: (source stem, [(symbol, argtypes)])
_SIGNATURES = {
    "bb_quad": [(f"bb_quad_{s}", [_P, _P, _P, _L, _P, _P, _I, _I, _I, _I, _I,
                                  _P]) for s in ("f32", "f64")],
    "btd_factor": [(f"btd_factor_{s}", [_P, _P, _P, _P, _I, _I, _I, _D, _P])
                   for s in ("f32", "f64")],
    "btd_solve": [(f"btd_solve_{s}", [_P, _P, _P, _P, _I, _I, _I, _P])
                  for s in ("f32", "f64")],
}

LAUNCHES = dict.fromkeys(_SIGNATURES, 0)
_LIBS: dict = {}
BUILD_SECONDS: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc at first use")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so"


def build_all() -> float:
    """Compile every kernel source that has no current library, all at
    once (one nvcc each); returns the wall seconds spent."""
    t0 = time.perf_counter()
    todo = {n: _lib_path(n) for n in _SIGNATURES if not _lib_path(n).exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name, out in todo.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            (BUILD_DIR / f"{name}.log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    dt = time.perf_counter() - t0
    BUILD_SECONDS["last"] = dt
    return dt


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built at first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        for sym, argtypes in _SIGNATURES[name]:
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(name: str, code: int) -> None:
    """Raise if a launcher returned a CUDA error (or -1: unsupported size)."""
    if code == -1:
        raise ValueError(f"{name}: block size not instantiated (7, 14, 21)")
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")
