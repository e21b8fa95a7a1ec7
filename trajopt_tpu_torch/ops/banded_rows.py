"""Banded constraint-row blocks: the sparse Jacobian format of the SQP QP
(``trajopt_tpu/ops/banded_rows.py``).

Every hinge/abs row of a trajectory subproblem touches at most two adjacent
trajectory steps, so rows are stored as 2-block windows instead of a dense
(m, n) matrix.

Format: a row group is ``(B, G)`` where ``B`` is ``(lanes, n_g, r, 2b)`` —
``n_g`` window groups (one per step/gap), ``r`` rows per group, each row a
``2b``-wide window over two adjacent size-``b`` column blocks — and ``G`` is
``(n_g,)`` int32 window start block indices shared by every lane (window =
columns ``[G*b, (G+2)*b)``).  A full row set is a tuple of such groups (one
per term), concatenated in row order; flat row vectors are ``(lanes, m)``.

``bb_quad`` — the block-tridiagonal assembly of A' diag(d) A inside every
IPM iteration — runs as the CUDA kernel K1 ``csrc/bb_quad.cu`` on a CUDA
tensor and as its plain PyTorch version (``bb_quad_group_plain``) on a CPU
tensor.  On the card the IPM runs K1's body as a device function of K6
``ipm_banded`` (``csrc/banded.cuh``); the plain IPM loop takes the plain
version.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import _native


def bb_sizes(Bs: Sequence[torch.Tensor]) -> list[int]:
    """Row count per group block."""
    return [int(B.shape[1] * B.shape[2]) for B in Bs]


def bb_split(Bs: Sequence[torch.Tensor], v: torch.Tensor) -> list[torch.Tensor]:
    """Split a flat (lanes, m) row vector into per-group (lanes, n_g, r)."""
    out, o = [], 0
    for B in Bs:
        ng, r = B.shape[1], B.shape[2]
        out.append(v[:, o:o + ng * r].reshape(v.shape[0], ng, r))
        o += ng * r
    return out


def _windows(v: torch.Tensor, G: torch.Tensor, b: int) -> torch.Tensor:
    """Gather (lanes, n_g, 2b) windows of flat (lanes, n) vectors."""
    vb = v.reshape(v.shape[0], -1, b)
    return torch.cat([vb[:, G], vb[:, G + 1]], dim=-1)


def bb_mv(Bs, Gs, v: torch.Tensor, b: int) -> torch.Tensor:
    """A @ v for banded rows; returns (lanes, m) in row order."""
    outs = []
    for B, G in zip(Bs, Gs):
        W = _windows(v, G, b)  # (lanes, n_g, 2b)
        outs.append(torch.einsum("zgrw,zgw->zgr", B, W).reshape(v.shape[0], -1))
    return (torch.cat(outs, dim=-1) if outs
            else v.new_zeros((v.shape[0], 0)))


def bb_rmv(Bs, Gs, w: torch.Tensor, n: int, b: int) -> torch.Tensor:
    """A.T @ w for banded rows; returns (lanes, n)."""
    acc = w.new_zeros((w.shape[0], n // b, b))
    for B, G, wg in zip(Bs, Gs, bb_split(Bs, w)):
        U = torch.einsum("zgrw,zgr->zgw", B, wg)  # (lanes, n_g, 2b)
        acc.index_add_(1, G, U[..., :b])
        acc.index_add_(1, G + 1, U[..., b:])
    return acc.reshape(w.shape[0], n)


def bb_rowmax(Bs) -> torch.Tensor:
    """max |row| per row (for row equilibration); (lanes, m)."""
    outs = [torch.amax(torch.abs(B), dim=-1).reshape(B.shape[0], -1)
            for B in Bs]
    return torch.cat(outs, dim=-1)


def bb_scale_rows(Bs, s: torch.Tensor):
    """Multiply each row by a scalar; s is flat (lanes, m)."""
    return tuple(B * sg[..., None] for B, sg in zip(Bs, bb_split(Bs, s)))


def bb_scale_cols(Bs, Gs, c: torch.Tensor, b: int):
    """Multiply columns by a flat (lanes, n) vector (e.g. a free mask)."""
    return tuple(B * _windows(c, G, b)[:, :, None, :]
                 for B, G in zip(Bs, Gs))


# --------------------------------------------------------------------------
# K1: block-tridiagonal assembly of A' diag(d) A
# --------------------------------------------------------------------------


def bb_quad_group_plain(B, G, dg, D, O) -> None:
    """Plain PyTorch K1 for one row group: adds the group's (D, O) blocks
    of A' diag(dg) A into D (lanes, nb, b, b) and O (lanes, nb-1, b, b)
    in place.  dg is (lanes, n_g * r)."""
    b = D.shape[-1]
    dg = dg.reshape(B.shape[0], B.shape[1], B.shape[2])
    W = torch.einsum("zgrw,zgr,zgrv->zgwv", B, dg, B)  # (lanes, n_g, 2b, 2b)
    D.index_add_(1, G, W[..., :b, :b])
    D.index_add_(1, G + 1, W[..., b:, b:])
    O.index_add_(1, G, W[..., b:, :b])


def bb_quad_group_cuda(B, G, dg, D, O) -> None:
    """K1 on the card (``csrc/bb_quad.cu``): same contract as
    ``bb_quad_group_plain``."""
    if not D.is_cuda:
        raise ValueError("bb_quad_group_cuda: tensors must be on a CUDA device")
    if D.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"bb_quad: dtype {D.dtype} is not float32/float64")
    lanes, nb, b = D.shape[0], D.shape[1], D.shape[-1]
    if B.dim() != 4 or B.shape[0] != lanes or B.shape[-1] != 2 * b:
        raise ValueError(f"bb_quad: B shape {tuple(B.shape)} does not match "
                         f"D {tuple(D.shape)}")
    ng, r = B.shape[1], B.shape[2]
    for name, t in (("B", B), ("dg", dg), ("D", D), ("O", O)):
        if t.dtype != D.dtype or t.device != D.device:
            raise TypeError(f"bb_quad: {name} dtype/device differs from D")
    if G.dtype != torch.int32 or G.device != D.device or G.shape != (ng,):
        raise TypeError("bb_quad: G must be (n_g,) int32 on D's device")
    if tuple(D.shape) != (lanes, nb, b, b) or tuple(O.shape) != (lanes, nb - 1, b, b):
        raise ValueError("bb_quad: D/O must be (lanes, nb, b, b)/(lanes, nb-1, b, b)")
    if tuple(dg.shape) != (lanes, ng * r) or dg.stride(1) != 1:
        raise ValueError("bb_quad: dg must be (lanes, n_g*r) with unit "
                         "column stride")
    if not (B.is_contiguous() and G.is_contiguous() and D.is_contiguous()
            and O.is_contiguous()):
        raise ValueError("bb_quad: B, G, D and O must be contiguous")
    lib = _native.library("bb_quad")
    fn = lib.bb_quad_f32 if D.dtype == torch.float32 else lib.bb_quad_f64
    stream = torch.cuda.current_stream(D.device).cuda_stream
    code = fn(B.data_ptr(), G.data_ptr(), dg.data_ptr(), dg.stride(0),
              D.data_ptr(), O.data_ptr(), lanes, ng, r, b, nb, stream)
    _native.check("bb_quad", code)
    _native.LAUNCHES["bb_quad"] += 1


def bb_quad(Bs, Gs, d: torch.Tensor, D: torch.Tensor, O: torch.Tensor,
            kernels: bool = True):
    """Accumulate the block-tridiagonal blocks of A' diag(d) A into D
    (lanes, nb, b, b) and O (lanes, nb-1, b, b) IN PLACE (O[i] =
    K[block i+1, block i]); returns (D, O).

    One K1 launch per row group on a CUDA tensor (``kernels=False`` takes
    the plain version there too, for comparisons); the plain version on a
    CPU tensor.
    """
    group = bb_quad_group_cuda if (D.is_cuda and kernels) \
        else bb_quad_group_plain
    o = 0
    for B, G in zip(Bs, Gs):
        m = B.shape[1] * B.shape[2]
        group(B, G, d[:, o:o + m], D, O)
        o += m
    return D, O


def bb_to_dense(Bs, Gs, n: int, b: int) -> torch.Tensor:
    """Materialize the dense (lanes, m, n) matrix (tests / dense paths)."""
    rows = []
    for B, G in zip(Bs, Gs):
        lanes, ng, r, _ = B.shape
        Jg = B.new_zeros((lanes, ng, r, n // b, b))
        g = torch.arange(ng, device=B.device)
        # advanced indices (g, G) are separated by a slice: they lead
        Jg[:, g, :, G, :] = B[..., :b].permute(1, 0, 2, 3)
        Jg[:, g, :, G + 1, :] += B[..., b:].permute(1, 0, 2, 3)
        rows.append(Jg.reshape(lanes, ng * r, n))
    return torch.cat(rows, dim=1)


def regroup(B: torch.Tensor, G, bs: int, c: int, nsb: int):
    """Regroup fine windows to 2-superblock windows at block size c*bs.

    ``B`` is ``(lanes, n_g, r, w*bs)`` — windows of ``w`` consecutive fine
    blocks starting at fine block ``G``.  With superblocks of ``c`` fine
    blocks, a window of ``w <= c + 1`` fine blocks always fits in two
    ADJACENT superblocks, so rows coupling up to ``c`` trajectory steps keep
    the 2-window format at the coarser block size.  Returns
    ``(B' (lanes, n_g, r, 2*c*bs), G' (n_g,) int32)`` with G' in
    superblocks.
    """
    lanes, n_g, r, wbs = B.shape
    w = wbs // bs
    if c == 1:
        if w == 2:
            return B, G
        raise ValueError(f"window of {w} fine blocks needs superblock c >= {w - 1}")
    if w > c + 1:
        raise ValueError(f"window of {w} fine blocks needs superblock c >= {w - 1}")
    Gn = np.asarray(G.cpu() if isinstance(G, torch.Tensor) else G, np.int64)
    Gs = np.minimum(Gn // c, nsb - 2)
    off = (Gn - Gs * c) * bs  # placement offset in [0, (2c-w)*bs]
    Bp = B.new_zeros((lanes, n_g, r, 2 * c * bs))
    for g in range(n_g):
        Bp[:, g, :, off[g]:off[g] + wbs] = B[:, g]
    return Bp, torch.as_tensor(Gs, dtype=torch.int32, device=B.device)


def step_window(Js: torch.Tensor, steps, nb: int):
    """Place per-step row blocks into 2-block windows.

    Js: (lanes, n_g, r, b) rows that each depend on ONE step's columns;
    steps: (n_g,) the step index of each group.  Returns (B (lanes, n_g, r,
    2b), G): interior steps sit in the window's first block; the last step
    (which has no successor block) sits in the second block of window nb-2.
    """
    steps = np.asarray(steps, np.int64)
    G = np.minimum(steps, nb - 2)
    right = torch.as_tensor(steps - G == 1, device=Js.device)
    z = torch.zeros_like(Js)
    left = torch.cat([Js, z], dim=-1)
    rightw = torch.cat([z, Js], dim=-1)
    B = torch.where(right[None, :, None, None], rightw, left)
    return B, torch.as_tensor(G, dtype=torch.int32, device=Js.device)
