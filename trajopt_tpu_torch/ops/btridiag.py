"""Batched block-tridiagonal Cholesky for trajectory KKT systems
(``trajopt_tpu/ops/btridiag.py``).

The SQP subproblem's condensed KKT matrix K = P + J' D J + D_box is
block-tridiagonal whenever every term couples at most ADJACENT trajectory
steps.  It is factored as T small (b x b) block steps:

    L_0 = chol(D_0)
    M_i = O_i L_{i-1}^{-T}                       (i = 1..T-1)
    L_i = chol(D_i - M_i M_i')

so K = L L' with L block-bidiagonal; a solve is one forward and one
backward sweep.  Every function takes a leading lane axis.  The factor is
the explicit pair ``(LD (lanes, T, b, b), LM (lanes, T-1, b, b))``.

``btd_factor`` (K2, ``csrc/btd_factor.cu``) and ``btd_solve`` (K3,
``csrc/btd_solve.cu``) launch their CUDA kernels on CUDA tensors and run
their plain PyTorch versions (``btd_factor_plain``, ``btd_solve_plain``)
on CPU tensors.  On the card the IPM runs the same factor and solves as
device functions of K6 ``ipm_banded`` and K11 ``ipm_dense`` in another
form (``csrc/banded.cuh``): the pivot blocks' Cholesky factors inverted in
the factor, L_i^{-1}, and each solve two recurrences over products with
them, y_i = L_i^{-1} r_i - (L_i^{-1} M_i) y_{i-1} and x_i = L_i^{-T} y_i -
(M_{i+1} L_i^{-1})' x_{i+1}, with no division (``btd_inverse_host`` runs
that form on the CPU); the plain IPM loop takes the plain versions.
"""

from __future__ import annotations

import torch

from .. import _native

# block sizes the CUDA kernels instantiate: every b from 1 to
# _native.K6_BLOCK_MAX (csrc/banded.cuh BLOCK_MAX), as K6
KERNEL_BLOCKS = tuple(range(1, _native.K6_BLOCK_MAX + 1))


def _tiny(dtype) -> float:
    """Cholesky pivot floor (``btridiag.py:215``)."""
    return 1e-30 if dtype == torch.float64 else 1e-18


def blocks_from_dense(K: torch.Tensor, n_blocks: int, b: int):
    """Extract (D, O) block-tridiagonal views of dense (lanes, n, n)
    matrices.  Entries outside the band are IGNORED."""
    K4 = K.reshape(K.shape[0], n_blocks, b, n_blocks, b)
    D = torch.diagonal(K4, dim1=1, dim2=3).permute(0, 3, 1, 2)
    O = torch.diagonal(K4[:, 1:, :, :-1, :], dim1=1, dim2=3).permute(0, 3, 1, 2)
    return D.contiguous(), O.contiguous()


# --------------------------------------------------------------------------
# plain PyTorch versions (CPU path, and the kernels' oracle on the card)
# --------------------------------------------------------------------------


def _chol_plain(A: torch.Tensor, tiny: float) -> torch.Tensor:
    """Lower Cholesky of (lanes, b, b) blocks, pivots floored at tiny
    (``btridiag.py:171-185``)."""
    b = A.shape[-1]
    L = torch.zeros_like(A)
    for j in range(b):
        s = A[:, j, j] - torch.sum(L[:, j, :j] * L[:, j, :j], dim=-1)
        d = torch.sqrt(torch.clamp(s, min=tiny))
        L[:, j, j] = d
        if j + 1 < b:
            r = A[:, j + 1:, j] - torch.sum(
                L[:, j + 1:, :j] * L[:, j, None, :j], dim=-1)
            L[:, j + 1:, j] = r * (1.0 / d)[:, None]
    return L


def btd_factor_plain(D: torch.Tensor, O: torch.Tensor):
    """Block Cholesky; D (lanes, T, b, b), O (lanes, T-1, b, b) ->
    (LD (lanes, T, b, b), LM (lanes, T-1, b, b))."""
    tiny = _tiny(D.dtype)
    T = D.shape[1]
    LD = [_chol_plain(D[:, 0], tiny)]
    LM = []
    for t in range(1, T):
        # M = O L^{-T}:  L M' = O'
        M = torch.linalg.solve_triangular(
            LD[-1], O[:, t - 1].transpose(-1, -2), upper=False
        ).transpose(-1, -2)
        LM.append(M)
        LD.append(_chol_plain(D[:, t] - M @ M.transpose(-1, -2), tiny))
    return (torch.stack(LD, dim=1),
            torch.stack(LM, dim=1) if LM else O.new_zeros(O.shape))


def btd_solve_plain(LD: torch.Tensor, LM: torch.Tensor,
                    r: torch.Tensor) -> torch.Tensor:
    """Solve K x = r given the factor; r (lanes, T, b) -> x (lanes, T, b)."""
    T = LD.shape[1]

    def lower(L, v):
        return torch.linalg.solve_triangular(L, v[..., None], upper=False)[..., 0]

    def upper(L, v):  # L' x = v
        return torch.linalg.solve_triangular(
            L.transpose(-1, -2), v[..., None], upper=True)[..., 0]

    ys = [lower(LD[:, 0], r[:, 0])]
    for t in range(1, T):
        ys.append(lower(LD[:, t],
                        r[:, t] - (LM[:, t - 1] @ ys[-1][..., None])[..., 0]))
    xs = [upper(LD[:, T - 1], ys[T - 1])]
    for t in range(T - 2, -1, -1):
        rhs = ys[t] - (LM[:, t].transpose(-1, -2) @ xs[-1][..., None])[..., 0]
        xs.append(upper(LD[:, t], rhs))
    return torch.stack(xs[::-1], dim=1)


def btd_inverse_host(D: torch.Tensor, O: torch.Tensor, R: torch.Tensor,
                     fallback: bool = False):
    """K2 / K3's block-inverse form, as K6 and K11's block route run it on
    the card (``csrc/banded.cuh``: the factor with each pivot block's
    Cholesky factor inverted beside it, the couplings W_t, V_t, the solves
    as two recurrences over them), built for the CPU (``csrc/ipm_host.cpp``),
    on CPU tensors: D (lanes, T, b, b) and O (lanes, T-1, b, b) factored
    once, then K x = r for each right-hand side of R (lanes, k, T, b) ->
    (X (lanes, k, T, b), fell (lanes,) bool: the factor took its exact
    fallback).  ``fallback``: a build whose fast paths all report that
    they did not hold (csrc/qmath.cuh's QM_TEST_FALLBACK)."""
    if D.is_cuda:
        raise ValueError("btd_inverse_host: tensors must be on the CPU")
    lanes, T, b = D.shape[0], D.shape[1], D.shape[-1]
    dt = D.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"btd_inverse_host: dtype {dt} is not "
                        "float32/float64")
    D, O, R = (t.to(dt).contiguous() for t in (D, O, R))
    if O.shape != (lanes, T - 1, b, b) or R.shape[0] != lanes \
            or R.shape[2:] != (T, b):
        raise ValueError("btd_inverse_host: O (lanes, T-1, b, b) and R "
                         "(lanes, k, T, b) must match D (lanes, T, b, b)")
    X = torch.empty_like(R)
    fell = torch.zeros(lanes, dtype=torch.int32)
    lib = _native.host_library(
        "ipm_host", ("QM_TEST_FALLBACK",) if fallback else ())
    fn = lib.btd_inverse_f32 if dt == torch.float32 else lib.btd_inverse_f64
    _native.check("btd_inverse", fn(D.data_ptr(), O.data_ptr(), R.data_ptr(),
                                    X.data_ptr(), fell.data_ptr(), lanes, T,
                                    b, R.shape[1], _tiny(dt)))
    return X, fell.bool()


# --------------------------------------------------------------------------
# CUDA kernels K2 / K3
# --------------------------------------------------------------------------


def _check_blocks(name, lanes, T, b, dtype, device, **tensors):
    if device.type != "cuda":
        raise ValueError(f"{name}: tensors must be on a CUDA device")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {dtype} is not float32/float64")
    if b not in KERNEL_BLOCKS:
        raise ValueError(f"{name}: block size {b} outside 1.."
                         f"{KERNEL_BLOCKS[-1]}, the sizes it is instantiated "
                         "for")
    for key, (t, shape) in tensors.items():
        if t.dtype != dtype or t.device != device:
            raise TypeError(f"{name}: {key} dtype/device differs")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def btd_factor_cuda(D: torch.Tensor, O: torch.Tensor):
    """K2 on the card; same contract as ``btd_factor_plain``."""
    lanes, T, b = D.shape[0], D.shape[1], D.shape[-1]
    _check_blocks("btd_factor", lanes, T, b, D.dtype, D.device,
                  D=(D, (lanes, T, b, b)), O=(O, (lanes, T - 1, b, b)))
    LD = torch.empty_like(D)
    LM = torch.empty_like(O)
    lib = _native.library("btd_factor")
    fn = lib.btd_factor_f32 if D.dtype == torch.float32 else lib.btd_factor_f64
    stream = torch.cuda.current_stream(D.device).cuda_stream
    code = fn(D.data_ptr(), O.data_ptr(), LD.data_ptr(), LM.data_ptr(),
              lanes, T, b, _tiny(D.dtype), stream)
    _native.check("btd_factor", code)
    _native.LAUNCHES["btd_factor"] += 1
    if b != 7:
        _native.LAUNCHES[f"btd_factor_b{b}"] += 1
    return LD, LM


def btd_solve_cuda(LD: torch.Tensor, LM: torch.Tensor,
                   r: torch.Tensor) -> torch.Tensor:
    """K3 on the card; same contract as ``btd_solve_plain``."""
    lanes, T, b = LD.shape[0], LD.shape[1], LD.shape[-1]
    _check_blocks("btd_solve", lanes, T, b, LD.dtype, LD.device,
                  LD=(LD, (lanes, T, b, b)), LM=(LM, (lanes, T - 1, b, b)),
                  r=(r, (lanes, T, b)))
    x = torch.empty_like(r)
    lib = _native.library("btd_solve")
    fn = lib.btd_solve_f32 if LD.dtype == torch.float32 else lib.btd_solve_f64
    stream = torch.cuda.current_stream(LD.device).cuda_stream
    code = fn(LD.data_ptr(), LM.data_ptr(), r.data_ptr(), x.data_ptr(),
              lanes, T, b, stream)
    _native.check("btd_solve", code)
    _native.LAUNCHES["btd_solve"] += 1
    if b != 7:
        _native.LAUNCHES[f"btd_solve_b{b}"] += 1
    return x


def btd_factor(D: torch.Tensor, O: torch.Tensor, kernels: bool = True):
    """Block Cholesky of block-tridiagonal SPD matrices -> (LD, LM).

    K2 on a CUDA tensor (``kernels=False`` takes the plain version there,
    for comparisons); the plain version on a CPU tensor."""
    if D.is_cuda and kernels:
        return btd_factor_cuda(D, O)
    return btd_factor_plain(D, O)


def btd_solve(LD: torch.Tensor, LM: torch.Tensor, r: torch.Tensor,
              kernels: bool = True) -> torch.Tensor:
    """Solve K x = r from the (LD, LM) factor; r (lanes, T, b).

    K3 on a CUDA tensor (``kernels=False`` takes the plain version there);
    the plain version on a CPU tensor."""
    if LD.is_cuda and kernels:
        return btd_solve_cuda(LD, LM, r)
    return btd_solve_plain(LD, LM, r)
