"""Batched primal-dual interior-point solver for the SQP subproblem
(``trajopt_tpu/ops/ipm_qp.py``: ``:92-559``, the banded and the dense-row
paths).

  min  0.5 dx'P dx + q'dx + w_h'h + w_a'(p + nn)
  s.t. Jh dx + e_h <= h,  h >= 0          (hinge penalties)
       Ja dx - p + nn = -e_a,  p, nn >= 0 (abs / equality penalties)
       lb <= dx <= ub                      (trust region ∩ limits)

A Mehrotra predictor-corrector on the condensed Newton matrix
K = P + Jh' D_h Jh + Ja' D_a Ja + D_box.  When the rows are BANDED
(ops.banded_rows windows; ``data.A_h`` None) K is assembled directly in
block-tridiagonal form and factored by the block Cholesky (ops.btridiag).
When they are dense (``data.A_h`` / ``data.A_a`` (lanes, m, n): a problem
whose KKT matrix has no step band, e.g. a single step) K is formed dense,
symmetrized and regularized, then factored by the block Cholesky where
``kkt_block`` is set and the band holds (n >= 2 kkt_block), else by
``torch.linalg.cholesky`` with an explicit inverse through
``torch.linalg.solve_triangular``, as the reference's ``jnp.linalg``
calls do.

The loop runs in one of three ways, between a shared set-up (pinned
coordinates, scaling, P's blocks, f(0): ``_setup``) and teardown
(``_finish``):

* banded rows on a CUDA tensor (``kernels=True``): ONE launch of the
  hand-written kernel K6 ``ipm_banded`` (``csrc/ipm_banded.cu``): one CTA
  per lane runs that lane's whole loop, with K1-K3's math as device
  functions;
* dense rows on a CUDA tensor (``kernels=True``): ONE launch of the
  hand-written kernel K11 ``ipm_dense`` (``csrc/ipm_dense.cu``): one CTA
  per lane runs that lane's whole loop, the block-tridiagonal factor and
  solves as K2 / K3's device functions, the dense Cholesky its own;
* otherwise (a CPU tensor, or ``kernels=False``): the plain PyTorch loop
  ``_loop_plain``, K6's and K11's oracle, with the plain versions of K1
  ``bb_quad``, K2 ``btd_factor`` and K3 ``btd_solve`` and, on dense rows
  without a band, ``torch.linalg``'s Cholesky.

``solve_ipm_qp_host`` runs K6's or K11's device code built for the CPU
(``csrc/ipm_host.cpp``), for checking it without a card.

Lanes: every tensor has a leading lane axis and every reduction runs over
the non-lane axes, as ``vmap`` made them per lane.  The plain loop runs
while any lane is unsolved; a lane that has stopped keeps its state
bitwise (``torch.where``), as a vmapped ``while_loop`` keeps it.

Robustness contract (what the trust-region SQP relies on): the returned
step never increases the composite objective (best-iterate tracking with
dx = 0 as the starting incumbent); every iterate update is NaN-guarded;
pinned coordinates (lb == ub) are eliminated exactly by masking.

K6 forms P dx from P's block-tridiagonal blocks: P must have nothing
outside them.  ``band_plan`` checks that and builds K6's row tables; the
SQP builds one plan per solve and hands it to every QP, a direct caller
that passes none gets one built (and P checked) per call.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from .. import _native, resolve_device
from ..utils.lanes import lane_max, lane_min, lane_select
from .banded_rows import (
    bb_mv,
    bb_quad,
    bb_rmv,
    bb_rowmax,
    bb_scale_cols,
    bb_scale_rows,
)
from .btridiag import blocks_from_dense, btd_factor, btd_solve
from .prox_qp import ProxQPData
from .qp import (
    QPSettings,
    QP_MAX_ITER,
    QP_SOLVED,
    QP_SOLVED_INACCURATE,
    QP_UNSOLVED,
)
from .struct_qp import StructQPSolution

_FTB = 0.99  # fraction-to-boundary
_WMIN = 1e-10  # weight floor so zero-weight rows stay formally interior


def _dot(a, b):
    """Per-lane inner product of (lanes, k) tensors."""
    return torch.sum(a * b, dim=-1)


def _bmv(M, v):
    return (M @ v[..., None])[..., 0]


class _St(NamedTuple):
    dx: torch.Tensor
    h: torch.Tensor
    p: torch.Tensor
    nn: torch.Tensor
    z1: torch.Tensor
    y: torch.Tensor
    z5: torch.Tensor
    z6: torch.Tensor
    it: torch.Tensor
    status: torch.Tensor
    rp: torch.Tensor
    rd: torch.Tensor
    f_best: torch.Tensor
    dx_best: torch.Tensor


class _Setup(NamedTuple):
    """The scaled problem the loop solves, and what the teardown needs."""

    data: ProxQPData
    s: QPSettings
    lanes: int
    n: int
    mh: int
    ma: int
    bsz: int
    nb: int  # blocks of the block-tridiagonal factor (0: dense Cholesky)
    tiny: float
    dcap: float
    lb: torch.Tensor  # IPM bounds: pinned coordinates at (-1, 1)
    ub: torch.Tensor
    BhS: tuple  # banded rows: row-scaled, pinned columns masked
    BaS: tuple
    Jh: Optional[torch.Tensor]  # dense rows (lanes, m, n), likewise; or None
    Ja: Optional[torch.Tensor]
    eh: torch.Tensor
    ea: torch.Tensor
    c: torch.Tensor  # (lanes,) cost scale
    P: torch.Tensor
    q: torch.Tensor
    wh: torch.Tensor
    wa: torch.Tensor
    P_D: Optional[torch.Tensor]  # P's blocks (banded rows only)
    P_O: Optional[torch.Tensor]
    f_zero: torch.Tensor
    n_pairs: int

    @property
    def dense(self) -> bool:
        return self.Jh is not None

    def zeros_rows(self):
        return self.q.new_zeros((self.lanes, 0))

    def jh_mv(self, v):
        if self.dense:
            return _bmv(self.Jh, v)
        return bb_mv(self.BhS, self.data.Gh, v, self.bsz)

    def jh_rmv(self, w):
        if self.dense:
            return _bmv(self.Jh.transpose(1, 2), w)
        return bb_rmv(self.BhS, self.data.Gh, w, self.n, self.bsz)

    def ja_mv(self, v):
        if self.dense:
            return _bmv(self.Ja, v)
        return bb_mv(self.BaS, self.data.Ga, v, self.bsz)

    def ja_rmv(self, w):
        if self.dense:
            return _bmv(self.Ja.transpose(1, 2), w)
        return bb_rmv(self.BaS, self.data.Ga, w, self.n, self.bsz)

    def composite(self, dx):
        """Exact composite objective of the ORIGINAL problem at clip(dx)."""
        return composite_objective(self.data, dx, self.bsz)


def composite_objective(data: ProxQPData, dx, bsz):
    """The composite objective of ``data`` (the original, unscaled problem)
    at clip(dx, lb, ub), per lane."""
    d = torch.clamp(dx, min=data.lb, max=data.ub)
    f = 0.5 * _dot(d, _bmv(data.P, d)) + _dot(data.q, d)
    dense = data.A_h is not None
    if data.e_h.shape[1]:
        ah = _bmv(data.A_h, d) if dense else bb_mv(data.Bh, data.Gh, d, bsz)
        f = f + torch.sum(data.w_h * torch.clamp(data.e_h + ah, min=0.0),
                          dim=-1)
    if data.e_a.shape[1]:
        aa = _bmv(data.A_a, d) if dense else bb_mv(data.Ba, data.Ga, d, bsz)
        f = f + torch.sum(data.w_a * torch.abs(data.e_a + aa), dim=-1)
    return f


def check_p_band(P: torch.Tensor, b: int) -> None:
    """Raise unless P (lanes, n, n) is block-tridiagonal at block size b:
    K6 forms P v from the diagonal and sub-diagonal blocks alone."""
    n = P.shape[-1]
    blk = torch.arange(n, device=P.device) // b
    off = (blk[:, None] - blk[None, :]).abs() > 1
    if bool((P[:, off] != 0).any()):
        raise ValueError(
            f"solve_ipm_qp: P has entries outside the block tridiagonal at "
            f"block size {b}; the banded IPM needs every cost row to couple "
            "at most adjacent blocks (raise qp.kkt_block)")


def _setup(data: ProxQPData, s: QPSettings) -> _Setup:
    lanes, n = data.q.shape
    mh = data.e_h.shape[1]
    ma = data.e_a.shape[1]
    dt = data.q.dtype
    f64 = dt == torch.float64
    bsz = s.kkt_block
    dense = data.A_h is not None
    use_btd = bsz > 0 and n % bsz == 0 and n >= 2 * bsz
    if not (dense or use_btd):
        raise ValueError("banded rows require kkt_block to be set")
    nb = n // bsz if use_btd else 0

    # ---- exact elimination of pinned coordinates (lb == ub) ----
    width0 = data.ub - data.lb
    free = (width0 >= 1e-9).to(dt)  # 1 = optimized, 0 = pinned
    pin_val = torch.where(free > 0, torch.zeros_like(free),
                          0.5 * (data.lb + data.ub))
    q0 = free * (data.q + _bmv(data.P, pin_val))
    P0 = free[:, :, None] * data.P * free[:, None, :] \
        + torch.diag_embed(1.0 - free)
    lb = torch.where(free > 0, data.lb, torch.full_like(data.lb, -1.0))
    ub = torch.where(free > 0, data.ub, torch.full_like(data.ub, 1.0))

    # ---- row normalization + cost scaling ----
    BhS = BaS = ()
    Jh = Ja = None
    if dense:
        eh0 = data.e_h + _bmv(data.A_h, pin_val) if mh else data.e_h
        ea0 = data.e_a + _bmv(data.A_a, pin_val) if ma else data.e_a
        Ah0 = data.A_h * free[:, None, :]
        Aa0 = data.A_a * free[:, None, :]
        rh = torch.clamp(torch.amax(torch.abs(Ah0), dim=-1), min=1e-8) \
            if mh else data.q.new_ones((lanes, 0))
        ra = torch.clamp(torch.amax(torch.abs(Aa0), dim=-1), min=1e-8) \
            if ma else data.q.new_ones((lanes, 0))
        Jh = Ah0 / rh[..., None] if mh else Ah0
        Ja = Aa0 / ra[..., None] if ma else Aa0
    else:
        Bh0 = bb_scale_cols(data.Bh, data.Gh, free, bsz) if mh else ()
        Ba0 = bb_scale_cols(data.Ba, data.Ga, free, bsz) if ma else ()
        eh0 = data.e_h + bb_mv(data.Bh, data.Gh, pin_val, bsz) if mh \
            else data.e_h
        ea0 = data.e_a + bb_mv(data.Ba, data.Ga, pin_val, bsz) if ma \
            else data.e_a
        rh = torch.clamp(bb_rowmax(Bh0).to(dt), min=1e-8) if mh \
            else data.q.new_ones((lanes, 0))
        ra = torch.clamp(bb_rowmax(Ba0).to(dt), min=1e-8) if ma \
            else data.q.new_ones((lanes, 0))
        BhS = bb_scale_rows(Bh0, 1.0 / rh) if mh else ()
        BaS = bb_scale_rows(Ba0, 1.0 / ra) if ma else ()
    eh = eh0 / rh if mh else eh0
    ea = ea0 / ra if ma else ea0
    # per-lane cost scale
    cnorm = torch.clamp(torch.maximum(torch.mean(torch.abs(P0), dim=(1, 2)),
                                      torch.amax(torch.abs(q0), dim=-1)),
                        min=1.0)
    c = 1.0 / cnorm  # (lanes,)
    P = P0 * c[:, None, None]
    q = q0 * c[:, None]
    wh = torch.clamp(data.w_h * rh * c[:, None], min=_WMIN)
    wa = torch.clamp(data.w_a * ra * c[:, None], min=_WMIN)
    P_D, P_O = (None, None) if dense else blocks_from_dense(P, nb, bsz)
    return _Setup(
        data=data, s=s, lanes=lanes, n=n, mh=mh, ma=ma, bsz=bsz, nb=nb,
        tiny=1e-30 if f64 else 1e-25,
        # barrier-diagonal cap (bounds the f32 Newton system's conditioning)
        dcap=1e14 if f64 else 1e10,
        lb=lb, ub=ub, BhS=BhS, BaS=BaS, Jh=Jh, Ja=Ja, eh=eh, ea=ea, c=c,
        P=P, q=q,
        wh=wh, wa=wa, P_D=P_D, P_O=P_O,
        f_zero=composite_objective(data, torch.zeros_like(data.q), bsz),
        n_pairs=mh + mh + ma + ma + n + n)


# --------------------------------------------------------------------------
# the plain PyTorch loop (K6's and K11's oracle; the CPU path and
# kernels=False)
# --------------------------------------------------------------------------


def _loop_plain(su: _Setup) -> _St:
    """The loop in PyTorch, with the plain versions of K1-K3."""
    s, lanes, n, mh, ma = su.s, su.lanes, su.n, su.mh, su.ma
    bsz, nb, tiny, dcap = su.bsz, su.nb, su.tiny, su.dcap
    lb, ub, eh, ea, c = su.lb, su.ub, su.eh, su.ea, su.c
    P, q, wh, wa = su.P, su.q, su.wh, su.wa
    jh_mv, jh_rmv, ja_mv, ja_rmv = su.jh_mv, su.jh_rmv, su.ja_mv, su.ja_rmv
    zeros_rows = su.zeros_rows
    f64 = q.dtype == torch.float64
    n_pairs = su.n_pairs
    eye_b = torch.eye(bsz, dtype=q.dtype, device=q.device)

    # ---- initial interior point ----
    dx = torch.clamp(torch.zeros_like(q), min=lb + 0.01 * (ub - lb),
                     max=ub - 0.01 * (ub - lb))
    g = jh_mv(dx) + eh if mh else zeros_rows()
    h = torch.clamp(g, min=0.0) + 1.0
    r0 = ja_mv(dx) + ea if ma else zeros_rows()
    p = torch.clamp(r0, min=0.0) + 1.0
    nn = p - r0  # >= 1, makes the equality exact at the start
    z1 = 0.5 * wh
    y = q.new_zeros((lanes, ma))
    z5 = torch.ones_like(q)
    z6 = torch.ones_like(q)

    def mu_of(z1, s1, h, p, nn, y, dx, z5, z6):
        z2 = wh - z1
        z3 = wa - y
        z4 = wa + y
        tot = (_dot(z1, s1) + _dot(z2, h) if mh else 0.0)
        tot = tot + (_dot(z3, p) + _dot(z4, nn) if ma else 0.0)
        tot = tot + _dot(z5, dx - lb) + _dot(z6, ub - dx)
        return tot / n_pairs

    def residuals(dx, h, p, nn, z1, y, z5, z6):
        rdx = _bmv(P, dx) + q + (jh_rmv(z1) if mh else 0.0) \
            + (ja_rmv(y) if ma else 0.0) - z5 + z6
        re = (ja_mv(dx) - p + nn + ea) if ma else zeros_rows()
        return rdx, re

    def kkt_diags(st):
        z2 = wh - st.z1
        z3 = wa - st.y
        z4 = wa + st.y
        s1 = st.h - (jh_mv(st.dx) + eh) if mh else zeros_rows()
        denom = torch.clamp(st.h * st.z1 + s1 * z2, min=tiny) if mh else s1
        dh = torch.clamp(st.z1 * z2 / denom, max=dcap) if mh else s1
        da = torch.clamp(
            1.0 / torch.clamp(st.p / z3 + st.nn / z4, min=tiny), max=dcap) \
            if ma else zeros_rows()
        dbox = torch.clamp(st.z5 / (st.dx - lb) + st.z6 / (ub - st.dx),
                           max=dcap)
        return s1, z2, z3, z4, dh, da, dbox

    def newton(st, kkt_solve, s1, z2, z3, z4, rc1, rc2, rc3, rc4, rc5, rc6,
               rdx, re):
        """Solve the condensed Newton system for given complementarity rhs
        (steps DECREASE the residuals: J dW = -r)."""
        denom_h = torch.clamp(st.h * st.z1 + s1 * z2, min=tiny) if mh else s1
        b_h = (rc1 * z2 - st.z1 * rc2) / denom_h if mh else rc1
        da = torch.clamp(
            1.0 / torch.clamp(st.p / z3 + st.nn / z4, min=tiny), max=dcap) \
            if ma else zeros_rows()
        b_a = -re + rc3 / z3 - rc4 / z4 if ma else re
        rhs = -rdx - (jh_rmv(b_h) if mh else 0.0) \
            + (ja_rmv(da * b_a) if ma else 0.0) \
            + rc5 / (st.dx - lb) - rc6 / (ub - st.dx)
        ddx = kkt_solve(rhs)
        # one refinement step against the exact condensed matrix
        dh_diag = torch.clamp(st.z1 * z2 / denom_h, max=dcap) if mh else denom_h
        dbox = torch.clamp(st.z5 / (st.dx - lb) + st.z6 / (ub - st.dx),
                           max=dcap)
        K_mv = (_bmv(P, ddx) + (jh_rmv(dh_diag * jh_mv(ddx)) if mh else 0.0)
                + (ja_rmv(da * ja_mv(ddx)) if ma else 0.0) + dbox * ddx)
        ddx = ddx + kkt_solve(rhs - K_mv)

        dz1 = dh_diag * jh_mv(ddx) + b_h if mh else b_h
        dh = (rc2 + st.h * dz1) / z2 if mh else st.h
        dy = da * (ja_mv(ddx) - b_a) if ma else zeros_rows()
        dp = (rc3 + st.p * dy) / z3 if ma else st.p
        dnn = (rc4 - st.nn * dy) / z4 if ma else st.nn
        dz5 = (rc5 - st.z5 * ddx) / (st.dx - lb)
        dz6 = (rc6 + st.z6 * ddx) / (ub - st.dx)
        ds1 = dh - jh_mv(ddx) if mh else dh
        return ddx, dh, dp, dnn, dz1, dy, dz5, dz6, ds1

    def max_step(v, dv, cap=1e10):
        """Largest alpha in (0, 1] with v + alpha*dv >= (1-_FTB)*v, per
        lane."""
        bad = dv < 0
        a = torch.where(bad, -_FTB * v / torch.where(bad, dv, -1.0),
                        torch.full_like(v, cap))
        return torch.clamp(lane_min(a, 1.0), max=1.0)

    def make_kkt_solve(dh_d, da_d, dbox):
        """Factorize K = P + Jh' Dh Jh + Ja' Da Ja + Dbox; return solver."""
        if su.dense:
            return dense_kkt_solve(dh_d, da_d, dbox)
        D = su.P_D + torch.diag_embed(dbox.reshape(lanes, nb, bsz))
        O = su.P_O.clone()  # bb_quad accumulates in place
        if mh:
            bb_quad(su.BhS, su.data.Gh, dh_d, D, O, kernels=False)
        if ma:
            bb_quad(su.BaS, su.data.Ga, da_d, D, O, kernels=False)
        # relative regularization, per lane
        diag_max = torch.amax(torch.diagonal(D, dim1=-2, dim2=-1), dim=(1, 2))
        reg = (1e-12 * diag_max + 1e-11) if f64 else (1e-7 * diag_max + 1e-8)
        LD, LM = btd_factor(D + reg[:, None, None, None] * eye_b, O,
                            kernels=False)

        def kkt_solve(r):
            return btd_solve(LD, LM, r.reshape(lanes, nb, bsz),
                             kernels=False).reshape(lanes, n)

        return kkt_solve

    def dense_kkt_solve(dh_d, da_d, dbox):
        """K formed dense, symmetrized and regularized per lane, factored
        block-tridiagonally where the band holds, else by a dense Cholesky
        and an explicit inverse (a non-PD K gives NaN, as the reference's
        ``jnp.linalg.cholesky``, which the NaN guard catches)."""
        K = P + torch.diag_embed(dbox)
        if mh:
            K = K + (su.Jh.transpose(1, 2) * dh_d[:, None, :]) @ su.Jh
        if ma:
            K = K + (su.Ja.transpose(1, 2) * da_d[:, None, :]) @ su.Ja
        diag_max = torch.amax(torch.diagonal(K, dim1=-2, dim2=-1), dim=-1)
        reg = (1e-12 * diag_max + 1e-11) if f64 else (1e-7 * diag_max + 1e-8)
        Ksym = 0.5 * (K + K.transpose(1, 2))
        if nb:
            Db, Ob = blocks_from_dense(Ksym, nb, bsz)
            LD, LM = btd_factor(Db + reg[:, None, None, None] * eye_b, Ob,
                                kernels=False)

            def kkt_solve(r):
                return btd_solve(LD, LM,
                                 r.reshape(lanes, nb, bsz).contiguous(),
                                 kernels=False).reshape(lanes, n)

            return kkt_solve
        eye = torch.eye(n, dtype=q.dtype, device=q.device)
        L, info = torch.linalg.cholesky_ex(Ksym + reg[:, None, None] * eye)
        L = torch.where((info == 0)[:, None, None], L,
                        torch.full_like(L, float("nan")))
        Linv = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
        Kinv = Linv.transpose(1, 2) @ Linv

        def kkt_solve(r):
            return _bmv(Kinv, r)

        return kkt_solve

    def step_len(st, ddx, dh, dp, dnn, dz1, dy, dz5, dz6, ds1, s1, z2, z3,
                 z4):
        a = torch.minimum(max_step(st.dx - lb, ddx),
                          max_step(ub - st.dx, -ddx))
        a = torch.minimum(a, max_step(st.z5, dz5))
        a = torch.minimum(a, max_step(st.z6, dz6))
        if mh:
            a = torch.minimum(a, max_step(s1, ds1))
            a = torch.minimum(a, max_step(st.h, dh))
            a = torch.minimum(a, max_step(st.z1, dz1))
            a = torch.minimum(a, max_step(z2, -dz1))
        if ma:
            a = torch.minimum(a, max_step(st.p, dp))
            a = torch.minimum(a, max_step(st.nn, dnn))
            a = torch.minimum(a, max_step(z3, -dy))
            a = torch.minimum(a, max_step(z4, dy))
        return a

    def body(st: _St) -> _St:
        s1, z2, z3, z4, dh_d, da_d, dbox = kkt_diags(st)
        kkt_solve = make_kkt_solve(dh_d, da_d, dbox)

        rdx, re = residuals(st.dx, st.h, st.p, st.nn, st.z1, st.y,
                            st.z5, st.z6)
        mu = mu_of(st.z1, s1, st.h, st.p, st.nn, st.y, st.dx, st.z5, st.z6)

        # ---- affine (predictor) step: rc = -z*s ----
        aff = newton(st, kkt_solve, s1, z2, z3, z4,
                     -st.z1 * s1 if mh else s1,
                     -z2 * st.h if mh else s1,
                     -z3 * st.p if ma else st.p,
                     -z4 * st.nn if ma else st.nn,
                     -st.z5 * (st.dx - lb),
                     -st.z6 * (ub - st.dx),
                     rdx, re)
        ddx, dh, dp, dnn, dz1, dy, dz5, dz6, ds1 = aff
        a = step_len(st, *aff, s1, z2, z3, z4)[:, None]
        mu_aff = mu_of(st.z1 + a * dz1, s1 + a * ds1, st.h + a * dh,
                       st.p + a * dp, st.nn + a * dnn, st.y + a * dy,
                       st.dx + a * ddx, st.z5 + a * dz5, st.z6 + a * dz6)
        sigma = torch.clamp((mu_aff / torch.clamp(mu, min=tiny)) ** 3,
                            1e-8, 1.0)

        # ---- corrector step with Mehrotra second-order terms ----
        smu = (sigma * mu)[:, None]
        cor = newton(st, kkt_solve, s1, z2, z3, z4,
                     smu - st.z1 * s1 - dz1 * ds1 if mh else s1,
                     smu - z2 * st.h - (-dz1) * dh if mh else s1,
                     smu - z3 * st.p - (-dy) * dp if ma else st.p,
                     smu - z4 * st.nn - dy * dnn if ma else st.nn,
                     smu - st.z5 * (st.dx - lb) - dz5 * ddx,
                     smu - st.z6 * (ub - st.dx) - dz6 * (-ddx),
                     rdx, re)
        ddx, dh, dp, dnn, dz1, dy, dz5, dz6, ds1 = cor
        a = step_len(st, *cor, s1, z2, z3, z4)[:, None]

        dx1 = st.dx + a * ddx
        h1 = st.h + a * dh if mh else st.h
        p1 = st.p + a * dp if ma else st.p
        nn1 = st.nn + a * dnn if ma else st.nn
        z1_1 = st.z1 + a * dz1 if mh else st.z1
        y1 = st.y + a * dy if ma else st.y
        z5_1 = st.z5 + a * dz5
        z6_1 = st.z6 + a * dz6

        # ---- NaN guard: a broken Newton step keeps the incumbent ----
        def fin(v):
            return torch.all(torch.isfinite(v), dim=-1)
        finite = fin(dx1) & fin(z5_1) & fin(z6_1)
        if mh:
            finite = finite & fin(h1) & fin(z1_1)
        if ma:
            finite = finite & fin(p1) & fin(nn1) & fin(y1)
        dx1 = lane_select(finite, dx1, st.dx)
        h1 = lane_select(finite, h1, st.h)
        p1 = lane_select(finite, p1, st.p)
        nn1 = lane_select(finite, nn1, st.nn)
        z1_1 = lane_select(finite, z1_1, st.z1)
        y1 = lane_select(finite, y1, st.y)
        z5_1 = lane_select(finite, z5_1, st.z5)
        z6_1 = lane_select(finite, z6_1, st.z6)

        # ---- best-iterate tracking by exact composite objective ----
        f1 = su.composite(dx1)
        better = finite & (f1 < st.f_best)
        f_best = torch.where(better, f1, st.f_best)
        dx_best = lane_select(better, dx1, st.dx_best)

        # ---- termination (unscaled; OSQP-style abs + rel criterion) ----
        rdx1, re1 = residuals(dx1, h1, p1, nn1, z1_1, y1, z5_1, z6_1)
        mu1 = mu_of(z1_1, h1 - (jh_mv(dx1) + eh) if mh else h1, h1,
                    p1, nn1, y1, dx1, z5_1, z6_1)
        rp_u = lane_max(torch.abs(re1), 0.0)
        rd_u = torch.amax(torch.abs(rdx1), dim=-1) / c
        gap_u = (n_pairs * mu1) / c
        d_scale = torch.maximum(torch.amax(torch.abs(_bmv(P, dx1)), dim=-1),
                                torch.amax(torch.abs(q), dim=-1))
        if mh:
            d_scale = torch.maximum(
                d_scale, torch.amax(torch.abs(jh_rmv(z1_1)), dim=-1))
        if ma:
            d_scale = torch.maximum(
                d_scale, torch.amax(torch.abs(ja_rmv(y1)), dim=-1))
        d_scale = d_scale / c
        p_scale = (torch.maximum(torch.amax(torch.abs(ja_mv(dx1)), dim=-1),
                                 torch.amax(torch.abs(ea), dim=-1))
                   if ma else torch.zeros_like(c))
        f_scale = torch.maximum(torch.abs(f1), torch.abs(su.f_zero)) + 1.0
        eps_p = s.eps_abs + s.eps_rel * p_scale
        eps_d = s.eps_abs + s.eps_rel * d_scale
        eps_g = s.eps_abs * f_scale
        rp_r = rp_u / eps_p
        rd_r = torch.maximum(rd_u / eps_d, gap_u / eps_g)
        conv = finite & (rp_r <= 1.0) & (rd_r <= 1.0)
        broke = torch.where(f_best < su.f_zero, QP_SOLVED_INACCURATE,
                            QP_MAX_ITER).to(torch.int32)
        status = torch.where(conv, torch.full_like(st.status, QP_SOLVED),
                             torch.where(finite, st.status, broke))
        return _St(dx1, h1, p1, nn1, z1_1, y1, z5_1, z6_1,
                   st.it + 1, status, rp_r, rd_r, f_best, dx_best)

    def running(st: _St):
        return (st.status == QP_UNSOLVED) & (st.it < s.max_ipm_iter)

    big = torch.full((lanes,), float("inf"), dtype=q.dtype, device=q.device)
    st = _St(dx, h, p, nn, z1, y, z5, z6,
             torch.zeros((lanes,), dtype=torch.int32, device=q.device),
             torch.full((lanes,), QP_UNSOLVED, dtype=torch.int32,
                        device=q.device),
             big, big.clone(), su.f_zero, torch.zeros_like(q))
    act = running(st)
    while bool(act.any()):
        new = body(st)
        st = _St(*[lane_select(act, a, b) for a, b in zip(new, st)])
        act = running(st)
    return st


# --------------------------------------------------------------------------
# K6 ipm_banded: the whole loop as one launch (csrc/ipm_banded.cu)
# --------------------------------------------------------------------------

_INTS = ("lanes", "n", "b", "nb", "mh", "ma", "max_iter", "smem_rows",
         "smem_scr")
_PTRS = ("PD", "PO", "RD", "RO", "q", "qr", "lb", "ub", "lbr", "ubr", "cf",
         "Sh", "Rh", "eh", "wh", "ehr", "whr",
         "Sa", "Ra", "ea", "wa", "ear", "war",
         "rowGh", "covh", "rowGa", "cova",
         "dx", "z5", "z6", "dxb", "h", "z1", "p", "nn", "y", "rp", "rd", "fb",
         "scr", "it", "status", "clk")


class _K6Args(ctypes.Structure):
    """ctypes mirror of ``ipm::Args`` (csrc/ipm.cuh)."""

    _fields_ = ([(k, ctypes.c_int) for k in _INTS]
                + [("eps_abs", ctypes.c_double), ("eps_rel", ctypes.c_double)]
                + [(k, ctypes.c_void_p) for k in _PTRS])


K6_SCRATCH_VECS = 12  # m-vectors per row kind in K6's scratch (ipm.cuh)
# the block sizes K6 is instantiated for: every b from 1 to
# _native.K6_BLOCK_MAX (csrc/ipm_launch.cuh; the libraries
# _native.K6_GROUPS), which covers every robot of the model zoo at step
# coupling 1 and 2 (the 9-DoF rail with its 1/dt grid: b 20)
K6_BLOCKS = tuple(range(1, _native.K6_BLOCK_MAX + 1))
# K6's phase timer (ipm.cuh ipm::PH_*): clock64 cycles per lane, summed over
# its iterations, then the count of factors that took their fallback
# (K6_CLK_SLOTS per lane)
K6_PHASES = ("diagonals", "assembly", "factor", "residuals", "pred_pass",
             "pred_solve", "corr_pass", "corr_solve", "update", "objective")
K6_CLK_SLOTS = len(K6_PHASES) + 1


# K6's shared memory (csrc/ipm.cuh smem_layout, csrc/ipm_launch.cuh
# plan_smem): n-vectors, the reduction buffer's elements, the scalars, and
# the card's limit per CTA in bytes
K6_SMEM_VECS, K6_SMEM_RED, K6_SMEM_SCALARS = 17, 14 * 32, 2
K6_MAX_SMEM = 232448


def k6_smem_layout(n: int, b: int, nb: int, mh: int, ma: int, rows: bool,
                   scr: bool) -> dict:
    """Elements of each part of a K6 lane's shared memory, in
    ``ipm::smem_layout``'s order: the factor's block inverses D, M then W
    in O, V, the solves' scratch n-vector w, the n-vectors, the reduction
    buffer and scalars, and where ``rows`` / ``scr`` put them there, the
    scaled rows (hinge, abs) and the scratch m-vectors."""
    return {"D": nb * b * b, "O": (nb - 1) * b * b, "V": (nb - 1) * b * b,
            "w": nb * b, "vectors": K6_SMEM_VECS * n,
            "reduction": K6_SMEM_RED + K6_SMEM_SCALARS,
            "rows_h": mh * 2 * b if rows else 0,
            "rows_a": ma * 2 * b if rows else 0,
            "scratch": K6_SCRATCH_VECS * (mh + ma) if scr else 0}


def k6_smem_plan(n: int, b: int, nb: int, mh: int, ma: int, es: int):
    """K6's shared-memory plan for a QP's sizes, as its launcher chooses it
    (``plan_smem``: the rows and the scratch in shared memory where both
    fit, else the one that fits, the rows first, else neither):
    {"rows", "scratch": "shared" or "device", "bytes", "bytes_by_part"},
    or None where even the base does not fit."""
    for rows, scr in ((True, True), (True, False), (False, True),
                      (False, False)):
        parts = {k: v * es for k, v in k6_smem_layout(
            n, b, nb, mh, ma, rows, scr).items()}
        if sum(parts.values()) <= K6_MAX_SMEM:
            where = {True: "shared", False: "device"}
            return {"rows": where[rows], "scratch": where[scr],
                    "bytes": sum(parts.values()), "bytes_by_part": parts}
    return None


class _RowTables(NamedTuple):
    """One row kind's int tables for K6, shared by the lanes."""

    shapes: tuple  # (n_g, r) of each row group
    rowG: torch.Tensor  # (m,) window start block of each row
    # the cover lists: offsets (nb + 1) into the entries that follow,
    # (first row, rows, half) of each window that covers a column block, by
    # block, in row-group then window order (half 0: the window starts at
    # the block, 1: one block before it)
    cov: torch.Tensor


class BandPlan(NamedTuple):
    """What K6 needs of the problem's structure, fixed across the QPs of
    one SQP solve: the block size, at which P was checked block-tridiagonal
    (the cost rows' step coupling), the block count, and each row kind's
    tables (the window starts are the terms' stencils)."""

    b: int
    nb: int
    h: _RowTables
    a: _RowTables


def _group_shapes(Bs) -> tuple:
    return tuple((B.shape[1], B.shape[2]) for B in Bs)


def cover_lists(shapes, Gs, nb: int) -> list:
    """For each column block t < nb, the (first row, rows, half) of every
    window that covers it, in row-group then window order."""
    cover = [[] for _ in range(nb)]
    row0 = 0
    for (ng, r), G in zip(shapes, Gs):
        G = torch.as_tensor(G).cpu().tolist()
        for g in range(ng):
            for half in (0, 1):
                t = int(G[g]) + half
                if 0 <= t < nb:
                    cover[t].append((row0 + g * r, r, half))
        row0 += ng * r
    return cover


def _row_tables(Bs, Gs, nb, dev) -> _RowTables:
    shapes = _group_shapes(Bs)
    cover = cover_lists(shapes, Gs, nb)
    off = [0]
    for c in cover:
        off.append(off[-1] + len(c))
    cov = torch.tensor(off + [v for c in cover for e in c for v in e],
                       dtype=torch.int32, device=dev)
    if not Bs:
        return _RowTables(shapes, torch.zeros(1, dtype=torch.int32,
                                              device=dev), cov)
    Gs = [torch.as_tensor(g, device=dev).to(torch.int32) for g in Gs]
    rowG = torch.cat([g[:, None].expand(-1, r).reshape(-1)
                      for g, (_, r) in zip(Gs, shapes)])
    return _RowTables(shapes, rowG.contiguous(), cov)


def band_plan(data: ProxQPData, b: int) -> BandPlan:
    """K6's plan for QPs shaped as ``data``: raises unless P is
    block-tridiagonal at block size b (``check_p_band``), and builds the
    row tables once."""
    check_p_band(data.P, b)
    dev, nb = data.q.device, data.q.shape[1] // b
    return BandPlan(b, nb, _row_tables(data.Bh, data.Gh, nb, dev),
                    _row_tables(data.Ba, data.Ga, nb, dev))


def _k6_call(su: _Setup, plan: BandPlan, fn, clk=None, smem=(1, 1)) -> _St:
    """Lay the set-up out for K6, run ``fn(args)`` (the CUDA launcher or the
    host build) and return its final state.  ``clk``: K6's phase timer, an
    int64 (lanes, K6_CLK_SLOTS) tensor the card adds each phase's cycles
    and the factor's fallbacks to (float32 on the card; the host build
    ignores it).  ``smem``: where the host build keeps the scaled rows and
    the scratch (1 its shared-memory array, 0 device memory); the card's
    launcher decides by its budget."""
    d, lanes, n, b, mh, ma = su.data, su.lanes, su.n, su.bsz, su.mh, su.ma
    dt = su.q.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"ipm_banded: dtype {dt} is not float32/float64")
    if b not in K6_BLOCKS:
        raise ValueError(f"ipm_banded: block size {b} outside 1.."
                         f"{K6_BLOCKS[-1]}, the sizes K6 is instantiated for")
    if (plan.b, plan.nb, plan.h.shapes, plan.a.shapes) \
            != (b, su.nb, _group_shapes(d.Bh), _group_shapes(d.Ba)):
        raise ValueError("ipm_banded: the plan was built for another block "
                         "size or other row groups")
    RD, RO = blocks_from_dense(d.P, su.nb, b)

    def rows(Bs):
        """A kind's row groups packed as (lanes, m, 2b)."""
        if not Bs:
            return su.q.new_zeros((lanes, 0, 2 * b))
        return torch.cat([B.reshape(lanes, -1, 2 * b) for B in Bs], 1)

    def cont(t):
        return t.to(dt).contiguous()

    def empty(*shape):
        return su.q.new_empty((lanes,) + shape)

    out = dict(dx=empty(n), z5=empty(n), z6=empty(n), dxb=empty(n),
               h=empty(mh), z1=empty(mh), p=empty(ma), nn=empty(ma),
               y=empty(ma), rp=empty(), rd=empty(), fb=empty(),
               scr=empty(K6_SCRATCH_VECS * (mh + ma)),
               it=torch.empty((lanes,), dtype=torch.int32, device=su.q.device),
               status=torch.empty((lanes,), dtype=torch.int32,
                                  device=su.q.device))
    tensors = dict(
        PD=cont(su.P_D), PO=cont(su.P_O), RD=cont(RD), RO=cont(RO), q=cont(su.q),
        qr=cont(d.q), lb=cont(su.lb), ub=cont(su.ub), lbr=cont(d.lb), ubr=cont(d.ub),
        cf=cont(torch.stack([su.c, su.f_zero], -1)),
        Sh=cont(rows(su.BhS)), Rh=cont(rows(d.Bh)), eh=cont(su.eh),
        wh=cont(su.wh), ehr=cont(d.e_h), whr=cont(d.w_h),
        Sa=cont(rows(su.BaS)), Ra=cont(rows(d.Ba)), ea=cont(su.ea),
        wa=cont(su.wa), ear=cont(d.e_a), war=cont(d.w_a),
        rowGh=plan.h.rowG, covh=plan.h.cov, rowGa=plan.a.rowG,
        cova=plan.a.cov, **out)
    for k, t in tensors.items():
        if t.device != su.q.device:
            raise TypeError(f"ipm_banded: {k} is on {t.device}, not "
                            f"{su.q.device}")
    args = _K6Args(lanes=lanes, n=n, b=b, nb=su.nb, mh=mh, ma=ma,
                   max_iter=su.s.max_ipm_iter, smem_rows=smem[0],
                   smem_scr=smem[1],
                   eps_abs=su.s.eps_abs, eps_rel=su.s.eps_rel,
                   clk=0 if clk is None else clk.data_ptr(),
                   **{k: t.data_ptr() for k, t in tensors.items()})
    fn(args)
    return _St(out["dx"], out["h"], out["p"], out["nn"], out["z1"], out["y"],
               out["z5"], out["z6"], out["it"], out["status"], out["rp"],
               out["rd"], out["fb"], out["dxb"])


def ipm_banded_cuda(su: _Setup, plan: BandPlan, clk=None) -> _St:
    """K6 on the card: one launch runs every lane's whole loop (``clk``: the
    phase timer, see ``_k6_call``)."""
    if not su.q.is_cuda:
        raise ValueError("ipm_banded_cuda: tensors must be on a CUDA device")

    def launch(args):
        if clk is not None:
            fn = _native.library("ipm_timer").ipm_banded_timed_f32
        else:
            fn = _native.library(_native.k6_library(
                su.q.dtype == torch.float64, su.bsz)).ipm_banded_run
        stream = torch.cuda.current_stream(su.q.device).cuda_stream
        code = fn(ctypes.byref(args), stream)
        if code == -1:  # the block size is checked: shared memory
            raise ValueError(
                f"ipm_banded: n={su.n}, b={su.bsz} in {su.q.dtype} needs "
                "more shared memory per CTA than the card offers "
                "(ipm::smem_layout in csrc/ipm.cuh)")
        _native.check("ipm_banded", code)
        _native.LAUNCHES["ipm_banded"] += 1
        if su.bsz != 7:
            _native.LAUNCHES[f"ipm_banded_b{su.bsz}"] += 1

    if clk is not None and (su.q.dtype != torch.float32
                            or clk.shape != (su.lanes, K6_CLK_SLOTS)
                            or clk.dtype != torch.int64 or not clk.is_cuda
                            or not clk.is_contiguous()):
        raise ValueError("ipm_banded_cuda: the timer runs in float32, on a "
                         "contiguous int64 CUDA tensor clk "
                         f"({su.lanes}, {K6_CLK_SLOTS})")
    return _k6_call(su, plan, launch, clk)


def kernel_attributes() -> dict:
    """{"f32_b7": {"num_regs", "local_bytes", "max_threads",
    "static_smem_bytes"}, ...} of K6's instantiations on the card, float32
    and float64 at every block size (``cudaFuncGetAttributes``)."""
    out = {}
    for d in ("f32", "f64"):
        for b in K6_BLOCKS:
            lib = _native.library(_native.k6_library(d == "f64", b))
            buf = (ctypes.c_int * 4)()
            _native.check("ipm_banded_attrs", lib.ipm_banded_attrs(b, buf))
            out[f"{d}_b{b}"] = dict(zip(("num_regs", "local_bytes",
                                         "max_threads", "static_smem_bytes"),
                                        list(buf)))
    return out


def ipm_banded_host(su: _Setup, plan: BandPlan, smem=(1, 1),
                    fallback: bool = False) -> _St:
    """K6's device code built for the CPU (``csrc/ipm_host.cpp``), on CPU
    tensors: for checking it without a card (``smem``: see ``_k6_call``;
    ``fallback``: a build whose factors and solves all take their fallback,
    csrc/qmath.cuh's QM_TEST_FALLBACK)."""
    if su.q.is_cuda:
        raise ValueError("ipm_banded_host: tensors must be on the CPU")

    def launch(args):
        lib = _native.host_library(
            "ipm_host", ("QM_TEST_FALLBACK",) if fallback else ())
        fn = lib.ipm_banded_f32 if su.q.dtype == torch.float32 \
            else lib.ipm_banded_f64
        _native.check("ipm_banded", fn(ctypes.byref(args), None))

    return _k6_call(su, plan, launch, smem=smem)


# --------------------------------------------------------------------------
# K11 ipm_dense: the dense-row loop as one launch (csrc/ipm_dense.cu)
# --------------------------------------------------------------------------

_K11_INTS = ("lanes", "n", "b", "nb", "mh", "ma", "max_iter", "smem_k",
             "smem_lists", "smem_base", "smem_scr", "smem_raw", "lists", "nz_h",
             "nz_a", "nz_rh", "nz_ra", "nz_p", "nz_pr")
_K11_PTRS = ("P", "Pr", "q", "qr", "lb", "ub", "lbr", "ubr", "cf",
             "Jh", "Rh", "eh", "wh", "ehr", "whr",
             "Ja", "Ra", "ea", "wa", "ear", "war",
             "dx", "z5", "z6", "dxb", "h", "z1", "p", "nn", "y", "rp", "rd",
             "fb", "dscr", "it", "status", "clk")


class _K11Args(ctypes.Structure):
    """ctypes mirror of ``ipm_dense::Args`` (csrc/ipm_dense.cuh)."""

    _fields_ = ([(k, ctypes.c_int) for k in _K11_INTS]
                + [("eps_abs", ctypes.c_double), ("eps_rel", ctypes.c_double)]
                + [(k, ctypes.c_void_p) for k in _K11_PTRS])


K11_VECS, K11_SCRATCH_VECS = 18, 12  # ipm_dense.cuh N_VEC, N_SCR_VEC
# K11's phase timer (ipm_dense::CLK_SLOTS per lane): K6's phases, the
# factors that took their fallback, the cycles of the lane's set-up before
# its loop, and of the dense route's factor its panels' columns and its
# trailing updates
K11_CLK_SLOTS = len(K6_PHASES) + 4
# K11's sums run over its lists of nonzeros from this many columns on; a
# narrower QP keeps the dense order, where the lists would only add
# latency (the outputs are the same either way), on its dense route or
# its block route at b up to _native.K11_DENSE_HI (the dense order's
# library; at a larger b the lists)
K11_LISTS_MIN_N = 33
# K11's smem flags (``ipm_dense::Args``), in its plan's priority
K11_REGIONS = ("k", "lists", "base", "scr", "raw")


def k11_region_sizes(n: int, b: int, nb: int, mh: int, ma: int,
                     nz=(0,) * 6, es: int = 8) -> dict:
    """Elements of each of K11's regions per lane (``ipm_dense.cuh``'s
    k_size, lists_size, base_size, scr_size, raw_size), by
    ``K11_REGIONS``, for elements of ``es`` bytes: the dense route's
    packed K, the lists of the scaled rows and of P, the band (the block
    route's factor: D, O, V and the solves' scratch) and the n-vectors,
    the scratch m-vectors, the raw lists.  ``nz``: the lists' capacities
    (Jh, Ja, Rh, Ra, P, raw P), as ``k11_nonzeros``."""
    def lst(rows, cap):  # values, then int indices and offsets
        return cap + -(-4 * (cap + rows + 1) // es)
    nz_h, nz_a, nz_rh, nz_ra, nz_p, nz_pr = nz
    # the block route's D, O, V and the solves' scratch n-vector
    band = (nb * b * b + 2 * (nb - 1) * b * b + nb * b) if nb else 0
    return {"k": 0 if nb else n * (n + 1) // 2,
            "lists": lst(mh, nz_h) + lst(n, nz_h) + lst(ma, nz_a)
            + lst(n, nz_a) + lst(n, nz_p),
            "base": band + K11_VECS * n,
            "scr": K11_SCRATCH_VECS * (mh + ma),
            "raw": lst(mh, nz_rh) + lst(ma, nz_ra) + lst(n, nz_pr)}


def k11_scratch_size(n: int, b: int, nb: int, mh: int, ma: int,
                     nz=(0,) * 6, es: int = 8) -> int:
    """Elements of K11's device scratch per lane (``ipm_dense::
    scratch_size``): every region of ``k11_region_sizes``, each used where
    the launcher's plan leaves it out of shared memory."""
    return sum(k11_region_sizes(n, b, nb, mh, ma, nz, es).values())


def k11_nonzeros(su: _Setup, every_index: bool = False) -> tuple:
    """K11's list capacities for the set-up: the most nonzeros of any lane
    in the scaled Jh and Ja, the raw rows, P scaled and raw (one host
    sync); ``every_index``: every entry (the host build's lists of every
    index)."""
    d, n, mh, ma = su.data, su.n, su.mh, su.ma
    if every_index:
        return (mh * n, ma * n, mh * n, ma * n, n * n, n * n)
    Ms = (su.Jh, su.Ja, d.A_h, d.A_a, su.P, d.P)
    return tuple(int(c) for c in torch.stack(
        [(M != 0).flatten(1).sum(1).amax() for M in Ms]).tolist())


def _k11_args(su: _Setup, smem=(1,) * 5, clk=None, every_index=False,
              lists=None):
    """K11's launch arguments for the set-up: (args, tensors), ``tensors``
    every input and output the arguments point at (keep them while the
    arguments are used).  ``smem``: where the host build keeps the regions
    (``K11_REGIONS``: the packed K, the lists, base, the scratch, the raw
    lists; 1 its shared-memory array, 0 the device scratch); the card's
    launcher decides by its budget.  ``clk``: the phase timer, an int64
    (lanes, K11_CLK_SLOTS) tensor the timed library adds to (see
    ``ipm_dense_cuda``).  ``every_index``: capacities for lists of every
    entry (``ipm_dense_host``).  ``lists``: whether the sums run over the
    lists (None: from ``K11_LISTS_MIN_N`` columns on, and at a block size
    above ``_native.K11_DENSE_HI``)."""
    d, lanes, n, mh, ma = su.data, su.lanes, su.n, su.mh, su.ma
    dt = su.q.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"ipm_dense: dtype {dt} is not float32/float64")
    b = su.bsz if su.nb else 0
    if su.nb and b not in K6_BLOCKS:
        raise ValueError(f"ipm_dense: block size {b} outside 1.."
                         f"{K6_BLOCKS[-1]}, the sizes K11's block route is "
                         "instantiated for")

    def cont(t):
        return t.to(dt).contiguous()

    def empty(*shape):
        return su.q.new_empty((lanes,) + shape)

    if lists is None:
        lists = n >= K11_LISTS_MIN_N or b > _native.K11_DENSE_HI
    nz = k11_nonzeros(su, every_index) if lists else (0,) * 6
    tensors = dict(
        P=cont(su.P), Pr=cont(d.P),
        q=cont(su.q), qr=cont(d.q), lb=cont(su.lb), ub=cont(su.ub),
        lbr=cont(d.lb), ubr=cont(d.ub),
        cf=cont(torch.stack([su.c, su.f_zero], -1)),
        Jh=cont(su.Jh), Rh=cont(d.A_h), eh=cont(su.eh), wh=cont(su.wh),
        ehr=cont(d.e_h), whr=cont(d.w_h),
        Ja=cont(su.Ja), Ra=cont(d.A_a), ea=cont(su.ea), wa=cont(su.wa),
        ear=cont(d.e_a), war=cont(d.w_a),
        dx=empty(n), z5=empty(n), z6=empty(n), dxb=empty(n),
        h=empty(mh), z1=empty(mh), p=empty(ma), nn=empty(ma),
        y=empty(ma), rp=empty(), rd=empty(), fb=empty(),
        dscr=empty(k11_scratch_size(n, b, su.nb, mh, ma, nz,
                                    su.q.element_size())),
        it=torch.empty((lanes,), dtype=torch.int32, device=su.q.device),
        status=torch.empty((lanes,), dtype=torch.int32, device=su.q.device))
    for k, t in tensors.items():
        if t.device != su.q.device:
            raise TypeError(f"ipm_dense: {k} is on {t.device}, not "
                            f"{su.q.device}")
    args = _K11Args(lanes=lanes, n=n, b=b, nb=su.nb, mh=mh, ma=ma,
                    max_iter=su.s.max_ipm_iter,
                    **{f"smem_{k}": f for k, f in zip(K11_REGIONS, smem)},
                    lists=int(lists),
                    **dict(zip(("nz_h", "nz_a", "nz_rh", "nz_ra", "nz_p",
                                "nz_pr"), nz)),
                    eps_abs=su.s.eps_abs, eps_rel=su.s.eps_rel,
                    clk=0 if clk is None else clk.data_ptr(),
                    **{k: t.data_ptr() for k, t in tensors.items()})
    return args, tensors


def _k11_call(su: _Setup, fn, smem=(1,) * 5, clk=None, every_index=False,
              lists=None) -> _St:
    """Lay the set-up out for K11 (``_k11_args``), run ``fn(args)`` (the
    CUDA launcher or the host build) and return its final state."""
    args, t = _k11_args(su, smem, clk, every_index, lists)
    fn(args)
    return _St(t["dx"], t["h"], t["p"], t["nn"], t["z1"], t["y"], t["z5"],
               t["z6"], t["it"], t["status"], t["rp"], t["rd"], t["fb"],
               t["dxb"])


def ipm_dense_cuda(su: _Setup, clk=None) -> _St:
    """K11 on the card: one launch runs every lane's whole loop on the
    dense rows (the block route at su.bsz where su.nb > 0, else the dense
    Cholesky).  ``clk``: the phase timer (float32, b 1-9 or the dense
    route; the library ``ipm_dense_timer``), an int64 contiguous CUDA
    tensor (lanes, K11_CLK_SLOTS) each lane adds its phases' clock64
    cycles, its factors' fallbacks and its set-up's cycles to."""
    if not su.q.is_cuda:
        raise ValueError("ipm_dense_cuda: tensors must be on a CUDA device")
    if not su.dense:
        raise ValueError("ipm_dense_cuda: the rows are banded (K6's)")
    if clk is not None and (su.q.dtype != torch.float32
                            or (su.nb and su.bsz > _native.K11_DENSE_HI)
                            or clk.shape != (su.lanes, K11_CLK_SLOTS)
                            or clk.dtype != torch.int64 or not clk.is_cuda
                            or not clk.is_contiguous()):
        raise ValueError("ipm_dense_cuda: the timer runs in float32 at b 1-9 "
                         "or on the dense route, on a contiguous int64 CUDA "
                         f"tensor clk ({su.lanes}, {K11_CLK_SLOTS})")

    def launch(args):
        if clk is not None:
            name = "ipm_dense_timer" + ("" if args.lists else "_dense")
        else:
            name = _native.k11_library(su.q.dtype == torch.float64, args.b,
                                       bool(args.lists))
        fn = _native.library(name).ipm_dense_run
        stream = torch.cuda.current_stream(su.q.device).cuda_stream
        _native.check("ipm_dense", fn(ctypes.byref(args), stream))
        _native.LAUNCHES["ipm_dense"] += 1
        _native.LAUNCHES[f"ipm_dense_b{args.b}" if args.nb
                         else "ipm_dense_chol"] += 1

    return _k11_call(su, launch, clk=clk)


def dense_kernel_attributes() -> dict:
    """{"f32_b1_9": {"num_regs", "local_bytes", "max_threads",
    "static_smem_bytes"}, ..., "f32_dense": {...}} of K11's libraries on
    the card (``cudaFuncGetAttributes``; one kernel each, b at run time:
    over the lists, or in the dense order)."""
    out = {}
    for f64 in (False, True):
        names = [_native.k11_library(f64, lo) for lo, _ in _native.K11_GROUPS]
        for name in names + [_native.k11_library(f64, 0, False)]:
            buf = (ctypes.c_int * 4)()
            _native.check("ipm_dense_attrs",
                          _native.library(name).ipm_dense_attrs(buf))
            out[name.split("ipm_dense_", 1)[1]] = dict(zip(
                ("num_regs", "local_bytes", "max_threads",
                 "static_smem_bytes"), list(buf)))
    return out


def ipm_dense_host(su: _Setup, smem=(1,) * 5, every_index: bool = False,
                   lists=None) -> _St:
    """K11's device code built for the CPU (``csrc/ipm_host.cpp``), on CPU
    tensors: for checking it without a card (``smem``, ``lists``: see
    ``_k11_args``; ``every_index``: lists that hold every entry, zeros
    too, which must give the same outputs bit for bit)."""
    if su.q.is_cuda:
        raise ValueError("ipm_dense_host: tensors must be on the CPU")

    def launch(args):
        lib = _native.host_library("ipm_host")
        fn = getattr(lib, f"ipm_dense{'_all' if every_index else ''}_"
                     f"{'f32' if su.q.dtype == torch.float32 else 'f64'}")
        _native.check("ipm_dense", fn(ctypes.byref(args), None))

    return _k11_call(su, launch, smem=smem, every_index=every_index,
                     lists=lists)


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------


def _finish(su: _Setup, fin_st: _St) -> StructQPSolution:
    data, c = su.data, su.c
    # iteration cap without residual convergence: the incumbent is still a
    # descent (or zero) step; label it by whether it made progress
    status = torch.where(
        fin_st.status == QP_UNSOLVED,
        torch.where(fin_st.f_best < su.f_zero, QP_SOLVED_INACCURATE,
                    QP_MAX_ITER).to(torch.int32),
        fin_st.status)
    # a converged final iterate may still be (marginally) worse than the
    # incumbent in composite value — return the best
    f_fin = su.composite(fin_st.dx)
    use_fin = (status == QP_SOLVED) & (f_fin <= fin_st.f_best)
    dx_out = torch.clamp(lane_select(use_fin, fin_st.dx, fin_st.dx_best),
                         min=data.lb, max=data.ub)

    # warm-start slacks recomputed from dx_out (one consistent iterate)
    g_out = su.jh_mv(dx_out) + su.eh if su.mh else fin_st.h
    h_out = torch.clamp(g_out, min=0.0)
    r_out = su.ja_mv(dx_out) + su.ea if su.ma else su.zeros_rows()
    p_out = torch.clamp(r_out, min=0.0)
    nn_out = torch.clamp(-r_out, min=0.0)
    u_out = torch.cat([dx_out, h_out, p_out, nn_out], dim=-1)
    # duals in the ADMM row layout (hinge, abs, box, slack bounds)
    cc = c[:, None]
    z2f = su.wh - fin_st.z1
    z3f = su.wa - fin_st.y
    z4f = su.wa + fin_st.y
    y_out = torch.cat([
        fin_st.z1 / cc,
        fin_st.y / cc,
        (fin_st.z6 - fin_st.z5) / cc,
        -z2f / cc,
        -z3f / cc,
        -z4f / cc,
    ], dim=-1)
    return StructQPSolution(dx_out, u_out, y_out, status, fin_st.it,
                            fin_st.rp, fin_st.rd)


def solve_ipm_qp(data: ProxQPData, settings: QPSettings = QPSettings(),
                 u0: Optional[torch.Tensor] = None,
                 y0: Optional[torch.Tensor] = None,
                 device="cuda", kernels: bool = True,
                 plan: Optional[BandPlan] = None) -> StructQPSolution:
    """Solve a batch of composite-form QPs (every tensor (lanes, ...)).

    (u0, y0) are accepted for interface parity; the IPM re-initializes
    from a well-centered point.  ``device`` is where the data must lie
    (raises if CUDA is asked for and absent).  On a CUDA device the loop
    is one launch: K6 on banded rows, K11 on dense rows (``data.A_h``
    set; its block route where kkt_block gives a band, else its dense
    Cholesky); a failed build or launch raises.  ``kernels=False`` there,
    and every CPU tensor, runs the plain PyTorch loop.  ``plan`` is K6's
    ``band_plan`` for banded QPs of this structure (built, and P's band
    checked, here when None).
    """
    dev = resolve_device(device)
    if data.q.device.type != dev.type:
        raise ValueError(f"solve_ipm_qp: data on {data.q.device}, "
                         f"device={dev}")
    su = _setup(data, settings)
    if not (data.q.is_cuda and kernels):
        return _finish(su, _loop_plain(su))
    if su.dense:
        return _finish(su, ipm_dense_cuda(su))
    if plan is None:
        plan = band_plan(data, su.bsz)
    return _finish(su, ipm_banded_cuda(su, plan))


def solve_ipm_qp_host(data: ProxQPData, settings: QPSettings = QPSettings(),
                      plan: Optional[BandPlan] = None) -> StructQPSolution:
    """``solve_ipm_qp`` with the loop run by K6's host build (banded rows)
    or K11's (dense rows), on CPU tensors (the set-up and teardown are the
    same)."""
    su = _setup(data, settings)
    if su.dense:
        return _finish(su, ipm_dense_host(su))
    if plan is None:
        plan = band_plan(data, su.bsz)
    return _finish(su, ipm_banded_host(su, plan))
