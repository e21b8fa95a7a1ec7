"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each source compiles with ``nvcc`` into a shared library with a plain C
interface, loaded with ctypes (no PyTorch headers: a build takes seconds).
The build happens at first use, into ``_build/`` beside this file, named by
a hash of the source so an edited source rebuilds; all sources compile in
parallel.  Nothing here runs at import time.

``LAUNCHES`` counts launches per kernel: each wrapper adds one where it
launches its kernel, and nowhere else.  A source's library is named by a
hash of the source, the headers of ``csrc/`` and its flags.

``host_library`` builds ``csrc/cast_host.cpp`` (the cast kernels' and
K7's block code), ``csrc/pose_host.cpp`` (K9 cart_pose's and K8
solve_ik's), ``csrc/contact_select_host.cpp`` (K10 contact_select's) and
``csrc/ipm_host.cpp`` (K6 ipm_banded's, which on the card is
``csrc/ipm_banded.cu`` built once per dtype and range of block sizes,
``K6_GROUPS``, and ``ipm_timer`` float32 with the phase timer; and K11
ipm_dense's, on the card ``csrc/ipm_dense.cu`` built likewise,
``K11_GROUPS`` and the dense order's per dtype, and ``ipm_dense_timer`` /
``_timer_dense`` float32 with its timer) for the CPU
with the host's C++ compiler, for checking that code against the plain
PyTorch version without a card.
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
_CAST = [_P, _P, _P, _L, _I, _I, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I,
         _I, _I, _P, _P]
_ROUTE = [_P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _P, _P, _I, _I, _P]
_DISC = [_P, _P, _I, _I, _P, _L, _I, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I,
         _I, _P]
_POSE = [_P, _P, _P, _L, _I, _I, _I, _I, _I] + [_P] * 9 + [_L, _I, _I, _P]
_IK = [_P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _D, _D, _I, _I, _P, _P, _P,
       _P, _I, _P]
_CSEL = [_P] * 7 + [_I] * 7 + [_D, _P]
# C signatures: (source stem, [(symbol, argtypes)])
_SIGNATURES = {
    "bb_quad": [(f"bb_quad_{s}", [_P, _P, _P, _L, _P, _P, _I, _I, _I, _I, _I,
                                  _P]) for s in ("f32", "f64")],
    "btd_factor": [(f"btd_factor_{s}", [_P, _P, _P, _P, _I, _I, _I, _D, _P])
                   for s in ("f32", "f64")],
    "btd_solve": [(f"btd_solve_{s}", [_P, _P, _P, _P, _I, _I, _I, _P])
                  for s in ("f32", "f64")],
    "cast_seg": [(f"{k}_{s}", _CAST) for k in
                 ("cast_seg", "cast_seg_value", "cast_sweep")
                 for s in ("f32", "f64")]
    + [("cast_seg_attrs", [_I, _P])],
    "cast_cvx": [(f"{k}_cvx_{s}", _CAST) for k in
                 ("cast_seg", "cast_seg_value", "cast_sweep")
                 for s in ("f32", "f64")]
    + [(f"convex_route_{s}", _ROUTE) for s in ("f32", "f64")]
    + [("cast_cvx_attrs", [_I, _P])],
    # K7 / K7v: the discrete terms' distances per (lane, step)
    "disc_dist": [(f"{k}_{s}", _DISC) for k in ("disc_dist", "disc_dist_value")
                  for s in ("f32", "f64")]
    + [("disc_dist_layout", [_I] * 7 + [_P]), ("disc_dist_attrs", [_I, _P])],
    # K9 / K9v: a cart_pose term's error rows (and Jacobian) per lane
    "cart_pose": [(f"cart_pose_{s}", _POSE) for s in ("f32", "f64")]
    + [("cart_pose_attrs", [_I, _P])],
    # K8: damped-least-squares IK, a lane's loop per warp
    "solve_ik": [(f"solve_ik_{s}", _IK) for s in ("f32", "f64")]
    + [("solve_ik_attrs", [_I, _P])],
    # K8 float32 with its phase timer (clk last)
    "solve_ik_timer": [("solve_ik_timed_f32", _IK + [_P]),
                       ("solve_ik_attrs", [_I, _P])],
    # K10 / K10v: the collision terms' worst-contact selection
    "contact_select": [(f"contact_select_{s}", _CSEL) for s in ("f32", "f64")]
    + [("contact_select_attrs", [_I, _P])],
    # K6 float32 with the phase timer
    "ipm_timer": [("ipm_banded_timed_f32", [_P, _P])],
}

# K6 runs at every block size from 1 to K6_BLOCK_MAX (csrc/banded.cuh
# BLOCK_MAX), in float32 and float64: csrc/ipm_banded.cu is built into one
# library per dtype and range of block sizes, so that nvcc builds the
# ranges in parallel (an instantiation's build time grows with its block
# size, so the ranges narrow as it grows: one size each from 16 up)
K6_BLOCK_MAX = 21
K6_GROUPS = ((1, 5), (6, 8), (9, 11), (12, 13), (14, 15), (16, 16), (17, 17),
             (18, 18), (19, 19), (20, 20), (21, 21))


def k6_library(f64: bool, b: int) -> str:
    """The name of K6's library for block size b (float64 or float32)."""
    for lo, hi in K6_GROUPS:
        if lo <= b <= hi:
            return f"ipm_banded_{'f64' if f64 else 'f32'}_b{lo}_{hi}"
    raise ValueError(f"ipm_banded: block size {b} outside 1..{K6_BLOCK_MAX}, "
                     "the sizes K6 is instantiated for")


# K11 ipm_dense runs the dense-row QPs: its block route at every b from 1
# to K6_BLOCK_MAX (a run-time b, each library one dtype and a range of b,
# whose factor and solves it instantiates), its dense route in every
# library; its sums over the lists of nonzeros.  The kernel that keeps the
# dense order (a QP of a few columns) is a library of its own per dtype,
# b 1-9 and the dense route (K11_DENSE_HI)
K11_GROUPS = ((1, 9), (10, 14), (15, 18), (19, 21))
K11_DENSE_HI = 9


def k11_library(f64: bool, b: int, lists: bool = True) -> str:
    """The name of K11's library for the block route at block size b (b 0:
    the dense route, which every library runs; float64 or float32), over
    the lists or (``lists`` False, b at most K11_DENSE_HI) in the dense
    order."""
    d = "f64" if f64 else "f32"
    if not lists:
        if 0 <= b <= K11_DENSE_HI:
            return f"ipm_dense_{d}_dense"
        raise ValueError(f"ipm_dense: the dense order at block size {b} "
                         f"(it is built for 1..{K11_DENSE_HI})")
    for lo, hi in K11_GROUPS:
        if lo <= b <= hi or (b == 0 and lo == 1):
            return f"ipm_dense_{d}_b{lo}_{hi}"
    raise ValueError(f"ipm_dense: block size {b} outside 1..{K6_BLOCK_MAX}, "
                     "the sizes K11's block route is instantiated for")


# library -> (source stem, its -D defines) of a library built from a
# source other than its own name's: K6's, and K4 at the n_dof ceiling
# (with and without the CONVEX routes), built apart from the cast sources'
# other kernels so that nvcc builds them in parallel
_VARIANTS = {k6_library(f64, lo): ("ipm_banded", [
    f"-DK6_F64={int(f64)}", f"-DK6_LO={lo}", f"-DK6_HI={hi}"])
    for f64 in (False, True) for lo, hi in K6_GROUPS}
for _name in _VARIANTS:
    _SIGNATURES[_name] = [("ipm_banded_run", [_P, _P]),
                          ("ipm_banded_attrs", [_I, _P])]
for _f64 in (False, True):
    for _lo, _hi in K11_GROUPS:
        _VARIANTS[k11_library(_f64, _lo)] = ("ipm_dense", [
            f"-DK11_F64={int(_f64)}", f"-DK11_LO={_lo}", f"-DK11_HI={_hi}"])
    _VARIANTS[k11_library(_f64, 0, False)] = ("ipm_dense", [
        f"-DK11_F64={int(_f64)}", "-DK11_LO=1", f"-DK11_HI={K11_DENSE_HI}",
        "-DK11_LISTS=0"])
# K11 float32 with its phase timer (b 1-9 and the dense route), over the
# lists and in the dense order
_VARIANTS["ipm_dense_timer"] = ("ipm_dense", [
    "-DK11_F64=0", "-DK11_LO=1", "-DK11_HI=9", "-DK11_TIMED=1"])
_VARIANTS["ipm_dense_timer_dense"] = ("ipm_dense", [
    "-DK11_F64=0", "-DK11_LO=1", "-DK11_HI=9", "-DK11_TIMED=1",
    "-DK11_LISTS=0"])
for _name, (_src, _) in _VARIANTS.items():
    if _src == "ipm_dense":
        _SIGNATURES[_name] = [("ipm_dense_run", [_P, _P]),
                              ("ipm_dense_attrs", [_P])]
_VARIANTS["solve_ik_timer"] = ("solve_ik", ["-DIK_TIMED=1"])
for _src, _sfx in (("cast_seg", ""), ("cast_cvx", "_cvx")):
    _VARIANTS[f"{_src}_ceil"] = (_src, ["-DCAST_CEIL"])
    _SIGNATURES[f"{_src}_ceil"] = [(f"cast_seg{_sfx}_{s}", _CAST)
                                   for s in ("f32", "f64")] \
        + [(f"{_src}_attrs", [_I, _P])]
SOURCES = tuple(_SIGNATURES)  # one library each
# libraries that build_all() leaves out, built when first asked for: K6,
# K11 and K8 with their phase timers, which only scripts/ipm_ab.py and
# scripts/pose_ab.py --phases run
ON_DEMAND = ("ipm_timer", "ipm_dense_timer", "ipm_dense_timer_dense",
             "solve_ik_timer")
# extra nvcc flags per source: the cast kernels keep every multiply and add
# separate (no FMA contraction), as the plain PyTorch versions compute them,
# so that their argmin decisions agree wherever there is no tie; so does
# K6 ipm_banded, whose float64 iterates are held to the plain loop's
_EXTRA_FLAGS = {"cast_seg": ["-fmad=false"], "cast_cvx": ["-fmad=false"],
                "disc_dist": ["-fmad=false"], "cart_pose": ["-fmad=false"],
                "solve_ik": ["-fmad=false"], "contact_select": ["-fmad=false"],
                "ipm_banded": ["-fmad=false"], "ipm_timer": ["-fmad=false"],
                "ipm_dense": ["-fmad=false"]}

# the n_dof K4's Jacobian and K8 run at (1..CAST_ND_MAX; csrc/cast_block.cuh
# and csrc/pose.cuh ND_MAX)
CAST_ND_MAX = 12

# kernel name -> launch count; the cast sources hold three kernels
# (``cast_cvx`` their CVX instantiations, with the CONVEX routes, and the
# route probe ``convex_route``).  ``convex_feature`` / ``convex_fw`` count the launches
# of K4, K4v and K5 that ran that CONVEX route (the generic feature
# enumeration, Frank-Wolfe max separation); ``cast_boxbox`` those of K4,
# K4v, K5 and K7 on a world with a box-box pair (the SAT distances);
# ``cast_seg_nd{n}`` the launches of K4 at n_dof n (counted in
# ``cast_seg`` too; every n but the 7-DoF arms'), ``ipm_banded_b{b}``,
# ``btd_factor_b{b}`` and ``btd_solve_b{b}`` those of K6, K2 and K3 at
# block size b (every b but 7); ``cart_pose`` and
# ``cart_pose_value`` count K9 and K9v (one source), ``solve_ik`` K8,
# ``contact_select`` and ``contact_select_value`` K10 and K10v;
# ``ipm_dense`` K11, ``ipm_dense_chol`` its launches on the dense route
# and ``ipm_dense_b{b}`` those on the block route at b (every b)
LAUNCHES = dict.fromkeys(
    ["bb_quad", "btd_factor", "btd_solve", "cast_seg", "cast_seg_value",
     "cast_sweep", "convex_feature", "convex_fw", "convex_route",
     "ipm_banded", "disc_dist", "disc_dist_value", "cart_pose",
     "cart_pose_value", "solve_ik", "contact_select", "contact_select_value",
     "cast_boxbox", "ipm_dense", "ipm_dense_chol"]
    + [f"cast_seg_nd{n}" for n in range(1, CAST_ND_MAX + 1) if n != 7]
    + [f"{k}_b{b}" for k in ("ipm_banded", "btd_factor", "btd_solve")
       for b in range(1, K6_BLOCK_MAX + 1) if b != 7]
    + [f"ipm_dense_b{b}" for b in range(1, K6_BLOCK_MAX + 1)], 0)
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


def _source(name: str) -> str:
    """The stem of library ``name``'s source in csrc/."""
    return _VARIANTS.get(name, (name,))[0]


def _flags(name: str) -> list:
    src, defines = _VARIANTS.get(name, (name, []))
    return NVCC_FLAGS + _EXTRA_FLAGS.get(src, []) + defines


# the host build keeps every multiply and add separate too; unoptimised,
# as it only checks arithmetic at small sizes (it compiles in ~1 s)
HOST_FLAGS = ["-std=c++17", "-O0", "-shared", "-fPIC", "-ffp-contract=off"]
_HOST_SIGNATURES = {"cast_host": [sig for src in ("cast_seg", "cast_cvx",
                                                  "disc_dist")
                                   for sig in _SIGNATURES[src]
                                   if not sig[0].endswith("_attrs")],
                    "pose_host": [sig for src in ("cart_pose", "solve_ik")
                                  for sig in _SIGNATURES[src]
                                  if not sig[0].endswith("_attrs")],
                    "ipm_host": [(f"{k}_{s}", [_P, _P])
                                 for k in ("ipm_banded", "ipm_dense",
                                           "ipm_dense_all", "ipm_dense_sizes")
                                 for s in ("f32", "f64")]
                    + [(f"btd_inverse_{s}", [_P] * 5 + [_I] * 4 + [t])
                       for s, t in (("f32", ctypes.c_float),
                                    ("f64", ctypes.c_double))]
                    + [("ipm_banded_layout", [_I] * 7 + [_P])],
                    # the team size in place of the stream
                    "contact_select_host": [
                        (f"contact_select_{s}", _CSEL[:-1] + [_I])
                        for s in ("f32", "f64")]
                    + [("contact_select_route", [_I] * 4)]}


def _lib_path(name: str, suffix: str = ".cu", flags=None) -> Path:
    src = (CSRC / f"{_source(name) if suffix == '.cu' else name}{suffix}"
           ).read_bytes()
    for hdr in sorted(CSRC.glob("*.cuh")):
        src += hdr.read_bytes()
    flags = _flags(name) if flags is None else flags
    h = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so"


def _load(path: Path, signatures) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for sym, argtypes in signatures:
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def build_all(names=None) -> float:
    """Compile every library of ``names`` (default: all but ON_DEMAND)
    that has no current build, all at once (one nvcc each); returns the
    wall seconds spent.  BUILD_SECONDS records each library's own wall
    seconds and the last call's ("last")."""
    t0 = time.perf_counter()
    if names is None:
        names = [n for n in _SIGNATURES if n not in ON_DEMAND]
    todo = {n: _lib_path(n) for n in names if not _lib_path(n).exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name, out in todo.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *_flags(name), "-o", str(tmp),
                   str(CSRC / f"{_source(name)}.cu")]
            log = open(BUILD_DIR / f"{name}.log", "w")
            procs[name] = (subprocess.Popen(cmd, stdout=log,
                                            stderr=subprocess.STDOUT), log,
                           tmp, out)
        failed = []
        while procs:
            done = [n for n, p in procs.items() if p[0].poll() is not None]
            for name in done:
                proc, log, tmp, out = procs.pop(name)
                log.close()
                BUILD_SECONDS[name] = time.perf_counter() - t0
                if proc.returncode != 0:
                    failed.append(f"{name}:\n"
                                  + (BUILD_DIR / f"{name}.log").read_text())
                else:
                    os.replace(tmp, out)
            time.sleep(0.05)
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
            build_all([name] if name in ON_DEMAND else None)
        lib = _LIBS[name] = _load(path, _SIGNATURES[name])
    return lib


def host_library(name: str, defines=()) -> ctypes.CDLL:
    """The loaded host build ``csrc/{name}.cpp`` (compiled at first use
    with the C++ compiler ``$CXX``, else ``c++``), with the preprocessor
    ``defines`` (``-D`` each; ``QM_TEST_FALLBACK``: every flagged fast path
    of csrc/qmath.cuh reports that it did not hold)."""
    flags = HOST_FLAGS + [f"-D{d}" for d in defines]
    key = (name,) + tuple(defines)
    lib = _LIBS.get(key)
    if lib is None:
        path = _lib_path(name, ".cpp", flags)
        if not path.exists():
            cxx = os.environ.get("CXX") or shutil.which("c++")
            if not cxx:
                raise RuntimeError("no C++ compiler for the host build")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run([cxx, *flags, "-I", str(CSRC), "-o", str(tmp),
                            str(CSRC / f"{name}.cpp")], check=True,
                           capture_output=True)
            os.replace(tmp, path)
        lib = _LIBS[key] = _load(path, _HOST_SIGNATURES[name])
    return lib


def check(name: str, code: int) -> None:
    """Raise if a launcher returned a CUDA error (or -1: a size the kernel
    is not instantiated for)."""
    if code == -1:
        raise ValueError(f"{name}: size not instantiated (block size 1 to "
                         f"{K6_BLOCK_MAX}; n_dof 1 to {CAST_ND_MAX} for "
                         "cast_seg; ipm_banded within "
                         "the shared-memory limit; ipm_dense's block route "
                         "in its library's range; the cast kernels' blocks "
                         "of 64 or 128 threads in teams of 4-32 on the card, "
                         "a team of 1 or a divisor of the threads up to 32 "
                         "on the host; disc_dist's of 32-256 threads, its "
                         "slots (and staged tables) within 227 KB of shared "
                         "memory; solve_ik "
                         f"n_dof 1 to {CAST_ND_MAX} and n_e 3 or 6; the "
                         "pose kernels' staged chain paths within the "
                         "shared memory; contact_select 1 <= K <= P with its "
                         "keys within 48 KB of shared memory)")
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")
