"""Trust-region penalty SQP engine over a batch of lanes
(``trajopt_tpu/solver/sqp.py``).

The reference's three nested loops (penalty, SQP, trust region;
``BasicTrustRegionSQP::optimize``, trajopt_sco/src/optimizers.cpp:694-986)
are flattened into one loop whose body performs exactly one QP solve, as in
the JAX package.  The JAX package batched it with ``vmap`` over a
``while_loop``; here every tensor carries a leading lane axis and the loop
is a Python ``while`` over a per-lane ``running`` mask: the body runs for
every lane and a lane that has reached a terminal status keeps its state
bitwise (``torch.where``), as a vmapped ``while_loop`` keeps it.

Ported: the interior-point QP paths, banded (every row term provides
banded windows, ``kkt_block`` = coupling x step width: K6 on the card) and
dense-row (the rows as (lanes, m, n) matrices, for a problem whose KKT
matrix has no step band, e.g. a single step).  ``max_time`` stops the
lanes still running with ``TIME_LIMIT``: ``solve_batch`` (and ``solve``)
checks the host clock after every QP solve, ``solve_batch_compact`` at its
phase boundaries.  Not ported yet: GENERIC terms, the ADMM QP solver,
``callback``, ``record_history`` and the multi-device ``mesh`` of
``solve_batch_compact``; each raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from ..ops.banded_rows import bb_mv, regroup
from ..ops.ipm_qp import band_plan, solve_ipm_qp
from ..ops.prox_qp import ProxQPData
from ..ops.qp import resolve_solver
from ..terms.base import TermKind
from ..utils.lanes import lane_max, lane_select, tree_map
from .types import (
    CONVERGED,
    FAILED,
    PENALTY_ITERATION_LIMIT,
    RUNNING,
    SCO_ITERATION_LIMIT,
    TIME_LIMIT,
    ProblemData,
    ProblemSpec,
    SQPParams,
    SQPResult,
)


# --------------------------------------------------------------------------
# Static row plan
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class _Plan:
    """Grouping of terms into QP row blocks."""

    spec: ProblemSpec
    sq: tuple  # [(cost_idx, term, row_start)]
    gen: tuple  # [(cost_idx, term)]
    hin: tuple  # [(cost_idx, term, row_start)] hinge costs first in h-block
    ineq: tuple  # [(cnt_idx, term, row_start)] then ineq cnts
    ab: tuple  # [(cost_idx, term, row_start)] abs costs first in a-block
    eq: tuple  # [(cnt_idx, term, row_start)] then eq cnts
    m_sq: int
    m_h: int
    m_a: int
    entries: tuple  # per cnt_idx: (entry_start, n_groups)
    n_entries: int
    all_rows_banded: bool = False


def _plan(spec: ProblemSpec) -> _Plan:
    sq, gen, hin, ab = [], [], [], []
    off = 0
    for i, t in enumerate(spec.cost_terms):
        if t.kind == TermKind.SQUARED:
            sq.append((i, t, off))
            off += t.n_rows
    m_sq = off
    for i, t in enumerate(spec.cost_terms):
        if t.kind == TermKind.GENERIC:
            gen.append((i, t))
    off = 0
    for i, t in enumerate(spec.cost_terms):
        if t.kind == TermKind.HINGE:
            hin.append((i, t, off))
            off += t.n_rows
    ineq = []
    for j, t in enumerate(spec.cnt_terms):
        if t.kind == TermKind.INEQ:
            ineq.append((j, t, off))
            off += t.n_rows
    m_h = off
    off = 0
    for i, t in enumerate(spec.cost_terms):
        if t.kind == TermKind.ABS:
            ab.append((i, t, off))
            off += t.n_rows
    eq = []
    for j, t in enumerate(spec.cnt_terms):
        if t.kind == TermKind.EQ:
            eq.append((j, t, off))
            off += t.n_rows
    m_a = off
    entries = []
    e = 0
    for t in spec.cnt_terms:
        entries.append((e, t.viol_groups))
        e += t.viol_groups
    row_terms = [t for _, t, _ in hin] + [t for _, t, _ in ineq] + \
        [t for _, t, _ in ab] + [t for _, t, _ in eq]
    all_banded = all(t.jac_banded_fn is not None for t in row_terms)
    return _Plan(spec, tuple(sq), tuple(gen), tuple(hin), tuple(ineq),
                 tuple(ab), tuple(eq), m_sq, m_h, m_a, tuple(entries), e,
                 all_banded)


# --------------------------------------------------------------------------
# Convexification
# --------------------------------------------------------------------------


class _Cvx(NamedTuple):
    """Convex model at the linearization point x (lanes leading)."""

    err_sq: torch.Tensor  # (B, m_sq)
    J_sq: torch.Tensor  # (B, m_sq, n_x)
    w_sq: torch.Tensor  # (B, m_sq)
    err_h: torch.Tensor  # (B, m_h)
    J_h: Optional[torch.Tensor]  # (B, m_h, n_x); None on the banded path
    w_h_cost: torch.Tensor  # (B, m_h) cost weights; merit rows hold 1.0
    err_a: torch.Tensor  # (B, m_a)
    J_a: Optional[torch.Tensor]  # (B, m_a, n_x); None on the banded path
    w_a_cost: torch.Tensor  # (B, m_a)
    # banded window blocks (ops.banded_rows group tuples); () when dense
    bh: tuple = ()
    gh: tuple = ()
    ba: tuple = ()
    ga: tuple = ()


def _cat_rows(parts, x, width=None):
    """Concatenate per-term (B, k[, width]) blocks along the row axis."""
    if parts:
        return torch.cat(parts, dim=1)
    shape = (x.shape[0], 0) if width is None else (x.shape[0], 0, width)
    return x.new_zeros(shape)


def _convexify(plan: _Plan, data: ProblemData, x: torch.Tensor,
               banded_rows: bool = False, band_c: int = 1,
               kernels: bool = True) -> _Cvx:
    if plan.gen:
        raise NotImplementedError("GENERIC cost terms are not ported yet")
    n_x = plan.spec.n_x
    dt = x.dtype
    sq_blocks, h_blocks, a_blocks = [], [], []
    bh, gh, ba, ga = [], [], [], []

    # shared-precompute cache: terms carrying the same pre_fn object get
    # their (value, jacobian) aux from ONE pass at this linearization point
    vj_cache: dict = {}

    def _vj(t):
        if t.pre_fn is None:
            return None
        k = id(t.pre_fn)
        if k not in vj_cache:
            vj_cache[k] = t.pre_fn.value_jac(x, kernels=kernels)
        return vj_cache[k]

    def _jac_or_banded(t, p, bands_B, bands_G, vj=None):
        if not banded_rows:
            return t.jac(x, p, vj)
        out = t.jac_banded(x, p, vj)
        groups = out if isinstance(out, list) else [out]
        for B, G in groups:
            B = B.to(dt)
            if band_c > 1:
                # fold fine-step windows into 2-superblock windows at the
                # KKT block size band_c * n_cols (acc/jerk problems)
                B, G = regroup(B, G, plan.spec.n_cols, band_c,
                               plan.spec.n_steps // band_c)
            bands_B.append(B.contiguous())
            bands_G.append(G.to(torch.int32).contiguous())
        return None

    def _ones(t):
        return torch.ones((x.shape[0], t.n_rows), dtype=dt, device=x.device)

    for i, t, _ in plan.sq:
        p = data.cost_params[i]
        vj = _vj(t)
        sq_blocks.append((t.err(x, p, vj[0] if vj else None), t.jac(x, p, vj),
                          t.weights(p, x)))
    for i, t, _ in plan.hin:
        p = data.cost_params[i]
        vj = _vj(t)
        h_blocks.append((t.err(x, p, vj[0] if vj else None),
                         _jac_or_banded(t, p, bh, gh, vj), t.weights(p, x)))
    for j, t, _ in plan.ineq:
        p = data.cnt_params[j]
        vj = _vj(t)
        h_blocks.append((t.err(x, p, vj[0] if vj else None),
                         _jac_or_banded(t, p, bh, gh, vj), _ones(t)))
    for i, t, _ in plan.ab:
        p = data.cost_params[i]
        vj = _vj(t)
        a_blocks.append((t.err(x, p, vj[0] if vj else None),
                         _jac_or_banded(t, p, ba, ga, vj), t.weights(p, x)))
    for j, t, _ in plan.eq:
        p = data.cnt_params[j]
        vj = _vj(t)
        a_blocks.append((t.err(x, p, vj[0] if vj else None),
                         _jac_or_banded(t, p, ba, ga, vj), _ones(t)))

    def split(blocks, dense):
        err = _cat_rows([e for e, _, _ in blocks], x)
        w = _cat_rows([w for _, _, w in blocks], x)
        J = _cat_rows([j for _, j, _ in blocks], x, n_x) if dense else None
        return err, J, w

    err_sq, J_sq, w_sq = split(sq_blocks, True)
    err_h, J_h, w_h = split(h_blocks, not banded_rows)
    err_a, J_a, w_a = split(a_blocks, not banded_rows)
    return _Cvx(err_sq, J_sq, w_sq, err_h, J_h, w_h, err_a, J_a, w_a,
                tuple(bh), tuple(gh), tuple(ba), tuple(ga))


def _merit_row_weights(plan: _Plan, cvx: _Cvx, merit: torch.Tensor):
    """Effective slack weights: cost weights for cost rows, per-group merit
    coeff for constraint-penalty rows (cntsToCosts, optimizers.cpp:58-80)."""
    w_h = cvx.w_h_cost.clone()
    for j, t, start in plan.ineq:
        e0, g = plan.entries[j]
        w_h[:, start:start + t.n_rows] = torch.repeat_interleave(
            merit[:, e0:e0 + g], t.n_rows // g, dim=1).to(w_h.dtype)
    w_a = cvx.w_a_cost.clone()
    for j, t, start in plan.eq:
        e0, g = plan.entries[j]
        w_a[:, start:start + t.n_rows] = torch.repeat_interleave(
            merit[:, e0:e0 + g], t.n_rows // g, dim=1).to(w_a.dtype)
    return w_h, w_a


# --------------------------------------------------------------------------
# QP assembly — slack-free composite form (see ops.prox_qp)
# --------------------------------------------------------------------------


def _assemble_qp(plan: _Plan, cvx: _Cvx, w_h: torch.Tensor,
                 w_a: torch.Tensor, x: torch.Tensor, box: torch.Tensor,
                 lb: torch.Tensor, ub: torch.Tensor) -> ProxQPData:
    # objective: squared rows (a plain dense product, as XLA had it)
    Jt = cvx.J_sq.transpose(1, 2)
    Px = 2.0 * (Jt * cvx.w_sq[:, None, :]) @ cvx.J_sq
    Px = 0.5 * (Px + Px.transpose(1, 2))
    qx = 2.0 * (Jt @ (cvx.w_sq * cvx.err_sq)[..., None])[..., 0]

    # trust region ∩ variable bounds, in dx coordinates
    # (setTrustBoxConstraints, optimizers.cpp:150-165)
    lx = torch.maximum(lb, x - box[:, None]) - x
    ux = torch.minimum(ub, x + box[:, None]) - x
    return ProxQPData(P=Px, q=qx, A_h=cvx.J_h, e_h=cvx.err_h, w_h=w_h,
                      A_a=cvx.J_a, e_a=cvx.err_a, w_a=w_a, lb=lx, ub=ux,
                      Bh=cvx.bh, Gh=cvx.gh, Ba=cvx.ba, Ga=cvx.ga)


# --------------------------------------------------------------------------
# Model (convex) replay and exact evaluation
# --------------------------------------------------------------------------


def _model_values(plan: _Plan, cvx: _Cvx, dx: torch.Tensor, band_c: int = 1):
    """Per-term convex-model costs (B, n_cost) and violations
    (B, n_entries) at step dx."""
    B = dx.shape[0]
    zero = dx.new_zeros((B,))
    cost_vals = [zero] * len(plan.spec.cost_terms)
    viols = [None] * len(plan.spec.cnt_terms)

    r_sq = cvx.err_sq + (cvx.J_sq @ dx[..., None])[..., 0]
    if cvx.J_h is None:  # banded-rows path
        b = band_c * plan.spec.n_cols
        r_h = cvx.err_h + bb_mv(cvx.bh, cvx.gh, dx, b)
        r_a = cvx.err_a + bb_mv(cvx.ba, cvx.ga, dx, b)
    else:
        r_h = cvx.err_h + (cvx.J_h @ dx[..., None])[..., 0]
        r_a = cvx.err_a + (cvx.J_a @ dx[..., None])[..., 0]

    for i, t, s in plan.sq:
        rows = r_sq[:, s:s + t.n_rows]
        w = cvx.w_sq[:, s:s + t.n_rows]
        cost_vals[i] = torch.sum(w * rows * rows, dim=-1)
    for i, t, s in plan.hin:
        rows = r_h[:, s:s + t.n_rows]
        w = cvx.w_h_cost[:, s:s + t.n_rows]
        cost_vals[i] = torch.sum(w * torch.clamp(rows, min=0.0), dim=-1)
    for i, t, s in plan.ab:
        rows = r_a[:, s:s + t.n_rows]
        w = cvx.w_a_cost[:, s:s + t.n_rows]
        cost_vals[i] = torch.sum(w * torch.abs(rows), dim=-1)
    for j, t, s in plan.ineq:
        _, g = plan.entries[j]
        rows = r_h[:, s:s + t.n_rows]
        viols[j] = torch.sum(torch.clamp(rows, min=0.0).reshape(B, g, -1), -1)
    for j, t, s in plan.eq:
        _, g = plan.entries[j]
        rows = r_a[:, s:s + t.n_rows]
        viols[j] = torch.sum(torch.abs(rows).reshape(B, g, -1), dim=-1)
    return (torch.stack(cost_vals, dim=1) if cost_vals else dx.new_zeros((B, 0)),
            _cat_rows(viols, dx))


def _evaluate(spec: ProblemSpec, data: ProblemData, x: torch.Tensor,
              kernels: bool = True):
    """Exact per-term costs (B, n_cost) and per-group violations
    (B, n_entries) at x."""
    v_cache: dict = {}

    def _v(t):
        if t.pre_fn is None:
            return None
        k = id(t.pre_fn)
        if k not in v_cache:
            v_cache[k] = t.pre_fn.value(x, kernels=kernels)
        return v_cache[k]

    B = x.shape[0]
    costs = [t.value(x, data.cost_params[i], _v(t)).to(x.dtype)
             for i, t in enumerate(spec.cost_terms)]
    vs = [t.violations(x, data.cnt_params[j], _v(t)).to(x.dtype)
          for j, t in enumerate(spec.cnt_terms)]
    return (torch.stack(costs, dim=1) if costs else x.new_zeros((B, 0)),
            _cat_rows(vs, x))


# --------------------------------------------------------------------------
# The solver loop
# --------------------------------------------------------------------------


class _State(NamedTuple):
    x: torch.Tensor
    box: torch.Tensor
    merit: torch.Tensor
    cost_vals: torch.Tensor
    cnt_viols: torch.Tensor
    it: torch.Tensor  # accepted steps in current penalty round
    penalty_it: torch.Tensor
    qp_fails: torch.Tensor
    n_qp: torch.Tensor
    n_admm: torch.Tensor
    n_fev: torch.Tensor
    status: torch.Tensor


def _band_coupling(spec: ProblemSpec):
    """Largest step coupling over all terms of a trajectory problem, or
    None when any term is dense (GENERIC / unknown coupling).  A coupling c
    makes the condensed KKT matrix block-tridiagonal at block size
    c * n_cols."""
    if spec.n_steps < 2 or spec.n_cols < 1:
        return None
    if spec.n_steps * spec.n_cols != spec.n_x:
        return None
    cs = [1]
    for t in spec.cost_terms + spec.cnt_terms:
        if t.kind == TermKind.GENERIC or t.step_coupling is None:
            return None
        cs.append(t.step_coupling)
    return max(cs)


def _bandable(spec: ProblemSpec) -> bool:
    """True when the KKT matrix is block-tridiagonal at the STEP block
    size (every term couples at most adjacent steps)."""
    return _band_coupling(spec) == 1


def _i32(v, like):
    return torch.full_like(like, v, dtype=torch.int32)


def _check_unported(p: SQPParams) -> None:
    if p.callback is not None:
        raise NotImplementedError("SQPParams.callback is not ported yet")
    if p.record_history > 0 or p.record_history_x:
        raise NotImplementedError("SQPParams.record_history is not ported yet")


def _solve(spec: ProblemSpec, params: SQPParams, data: ProblemData,
           kernels: bool = True) -> SQPResult:
    _check_unported(params)
    plan = _plan(spec)
    p = params
    qp_solver = resolve_solver(p.qp.solver)
    # kkt_block == 0 means "auto": max_step_coupling * n_cols
    if p.qp.kkt_block == 0:
        c = _band_coupling(spec)
        if c is not None:
            blk = c * spec.n_cols
            if spec.n_x % blk == 0 and spec.n_x >= 2 * blk:
                p = dataclasses.replace(
                    p, qp=dataclasses.replace(p.qp, kkt_block=blk))
    n_cnt = plan.n_entries
    if (p.qp.kkt_block > 0 and spec.n_cols > 0
            and p.qp.kkt_block % spec.n_cols != 0):
        raise ValueError(
            f"qp.kkt_block={p.qp.kkt_block} must be a multiple of the "
            f"trajectory step width n_cols={spec.n_cols} (the KKT matrix "
            "is only block-tridiagonal at step-aligned block sizes)")

    c_band = _band_coupling(spec)
    blk_c = (p.qp.kkt_block // spec.n_cols
             if spec.n_cols > 0 and p.qp.kkt_block > 0
             and p.qp.kkt_block % spec.n_cols == 0 else 0)
    if qp_solver != "ipm":
        raise NotImplementedError(
            f"the {qp_solver!r} QP solver is not ported yet; only the "
            "interior-point solver ('ipm') is")
    banded_rows = (plan.all_rows_banded and c_band is not None
                   and blk_c >= max(c_band, 1)
                   and spec.n_steps % blk_c == 0
                   and spec.n_x >= 2 * p.qp.kkt_block)
    band_c = blk_c if banded_rows else 1

    x0 = torch.clamp(data.x0, min=data.lb, max=data.ub)
    dt = x0.dtype
    B = x0.shape[0]
    cost_vals0, viols0 = _evaluate(spec, data, x0, kernels)
    zi = torch.zeros((B,), dtype=torch.int32, device=x0.device)
    merit0 = torch.full((B, n_cnt), p.initial_merit_error_coeff, dtype=dt,
                        device=x0.device)
    box0 = torch.full((B,), p.trust_box_size, dtype=dt, device=x0.device)
    pen_it0, it0 = zi, zi
    if data.resume is not None:  # mid-solve restart (multi-phase batching)
        merit0 = data.resume["merit"].to(dt)
        box0 = data.resume["box"].to(dt)
        pen_it0 = data.resume["penalty_it"].to(torch.int32)
        it0 = data.resume["it"].to(torch.int32)

    st = _State(x=x0, box=box0, merit=merit0, cost_vals=cost_vals0,
                cnt_viols=viols0, it=it0, penalty_it=pen_it0, qp_fails=zi,
                n_qp=zi, n_admm=zi, n_fev=zi + 1,
                status=_i32(RUNNING, zi))

    def cond(st: _State):
        return (st.status == RUNNING) & (st.n_qp < p.max_total_qp_solves)

    qp_plan = None

    def body(st: _State) -> _State:
        nonlocal qp_plan
        cvx = _convexify(plan, data, st.x, banded_rows=banded_rows,
                         band_c=band_c, kernels=kernels)
        w_h, w_a = _merit_row_weights(plan, cvx, st.merit)
        qp_data = _assemble_qp(plan, cvx, w_h, w_a, st.x, st.box,
                               data.lb, data.ub)
        if qp_plan is None and banded_rows:
            # K6's plan (P's band checked, the row tables) holds for every
            # QP of the solve: the rows' step coupling and windows are the
            # terms' own
            qp_plan = band_plan(qp_data, p.qp.kkt_block)
        sol = solve_ipm_qp(qp_data, p.qp, device=st.x.device,
                           kernels=kernels, plan=qp_plan)
        dx = sol.x

        new_x = st.x + dx
        model_costs, model_viols = _model_values(plan, cvx, dx, band_c)
        new_costs, new_viols = _evaluate(spec, data, new_x, kernels)

        def merit_of(costs, viols):
            return torch.sum(costs, dim=-1) + torch.sum(st.merit * viols, -1)
        old_merit = merit_of(st.cost_vals, st.cnt_viols)
        model_merit = merit_of(model_costs, model_viols)
        new_merit = merit_of(new_costs, new_viols)
        approx = old_merit - model_merit
        exact = old_merit - new_merit
        ratio = exact / torch.where(torch.abs(approx) > 1e-30, approx,
                                    torch.full_like(approx, 1e-30))

        # a usable step: solved or inaccurate-but-descent, with the model
        # improvement non-negative up to the merit evaluations' noise floor
        noise = (1e-8 if dt == torch.float64 else 1e-4) \
            * (1.0 + torch.abs(old_merit))
        qp_ok = ((sol.status == 1) | (sol.status == 2)) \
            & (approx >= -noise) & torch.all(torch.isfinite(dx), dim=-1)

        # ---------------- QP-success decision tree ----------------
        sqp_conv = (approx < p.min_approx_improve) | (
            approx / torch.where(torch.abs(old_merit) > 1e-30, old_merit,
                                 torch.full_like(old_merit, 1e-30))
            < p.min_approx_improve_frac)
        shrink_step = (~sqp_conv) & ((exact < 0)
                                     | (ratio < p.improve_ratio_threshold))
        accept = (~sqp_conv) & (~shrink_step)

        # ---------------- QP-failure handling ----------------
        fail_shrink = st.qp_fails < (p.max_qp_solver_failures - 1)
        fail_minbox = st.qp_fails == (p.max_qp_solver_failures - 1)
        fail_fatal = st.qp_fails >= p.max_qp_solver_failures
        box_fail = torch.where(
            fail_shrink, st.box * p.trust_shrink_ratio,
            torch.where(fail_minbox,
                        torch.full_like(st.box, p.min_trust_box_size),
                        st.box))

        # ---------------- merge branches ----------------
        ok = qp_ok
        take = ok & accept
        x1 = torch.where(take[:, None], new_x, st.x)
        cost1 = torch.where(take[:, None], new_costs, st.cost_vals)
        viol1 = torch.where(take[:, None], new_viols, st.cnt_viols)
        box1 = torch.where(
            ok,
            torch.where(accept,
                        torch.clamp(st.box * p.trust_expand_ratio,
                                    max=p.max_trust_box_size),
                        torch.where(shrink_step, st.box * p.trust_shrink_ratio,
                                    st.box)),
            box_fail)
        it1 = torch.where(ok & accept, st.it + 1, st.it)
        qp_fails1 = torch.where(ok, torch.zeros_like(st.qp_fails),
                                st.qp_fails + 1)
        status1 = torch.where(~ok & fail_fatal, _i32(FAILED, st.status),
                              st.status)

        # SQP iteration limit (checked at the end of an accepted pass)
        viol_ok_now = lane_max(viol1, 0.0) < p.cnt_tolerance
        hit_iter_limit = ok & accept & (it1 >= p.max_iter)
        status1 = torch.where(
            hit_iter_limit,
            torch.where(viol_ok_now, _i32(CONVERGED, st.status),
                        _i32(SCO_ITERATION_LIMIT, st.status)),
            status1)

        # ---------------- penalty adjustment ----------------
        box_dead = box1 < p.min_trust_box_size
        pa = (status1 == RUNNING) & ((ok & sqp_conv) | box_dead)
        pa_done = pa & viol_ok_now
        status2 = torch.where(pa_done, _i32(CONVERGED, st.status), status1)
        pa_cont = pa & (~viol_ok_now)
        pen_it1 = torch.where(pa_cont, st.penalty_it + 1, st.penalty_it)
        status2 = torch.where(
            pa_cont & (pen_it1 >= p.max_merit_coeff_increases),
            _i32(PENALTY_ITERATION_LIMIT, st.status), status2)
        if p.inflate_constraints_individually:
            inflate = pa_cont[:, None] & (viol1 > p.cnt_tolerance)
        else:
            inflate = pa_cont[:, None].expand_as(viol1)
        merit1 = torch.where(inflate, st.merit * p.merit_coeff_increase_ratio,
                             st.merit)
        box2 = torch.where(
            pa_cont,
            torch.clamp(box1, min=p.min_trust_box_size
                        / p.trust_shrink_ratio * 1.5),
            box1)
        it2 = torch.where(pa_cont, torch.zeros_like(it1), it1)

        return _State(
            x=x1, box=box2, merit=merit1, cost_vals=cost1, cnt_viols=viol1,
            it=it2, penalty_it=pen_it1, qp_fails=qp_fails1,
            n_qp=st.n_qp + 1, n_admm=st.n_admm + sol.iters,
            n_fev=st.n_fev + 1, status=status2)

    act = cond(st)
    t_wall0 = None
    while bool(act.any()):
        new = body(st)
        if p.max_time != float("inf"):
            # the reference's wall-clock cutoff (optimizers.cpp:735), from
            # the end of the first QP solve, as the JAX package reads it
            now = time.monotonic()
            if t_wall0 is None:
                t_wall0 = now
            elif now - t_wall0 > p.max_time:
                new = new._replace(status=torch.where(
                    new.status == RUNNING, _i32(TIME_LIMIT, new.status),
                    new.status))
        st = _State(*[lane_select(act, a, b) for a, b in zip(new, st)])
        act = cond(st)

    # backstop cap hit while still running -> iteration limit, honestly:
    # the reference never labels an exhausted budget CONVERGED
    final_status = torch.where(st.status == RUNNING,
                               _i32(SCO_ITERATION_LIMIT, st.status), st.status)
    return SQPResult(
        x=st.x,
        status=final_status,
        cost_vals=st.cost_vals,
        cnt_viols=st.cnt_viols,
        total_cost=torch.sum(st.cost_vals, dim=-1),
        n_func_evals=st.n_fev,
        n_qp_solves=st.n_qp,
        n_admm_iters=st.n_admm,
        merit_coeffs=st.merit,
        trust_box_size=st.box,
        sqp_it=st.it,
        penalty_it=st.penalty_it,
    )


def _on_device(data: ProblemData, device) -> ProblemData:
    dev = resolve_device(device)
    return tree_map(lambda t: t.to(dev), data)


def solve(spec: ProblemSpec, data: ProblemData,
          params: SQPParams = SQPParams(), device="cuda",
          kernels: bool = True) -> SQPResult:
    """Solve one problem instance: ``data`` without a lane axis, the
    result's fields without one either (``solve_batch`` for many)."""
    one = tree_map(lambda t: t[None] if torch.is_tensor(t) else t, data)
    res = _solve(spec, params, _on_device(one, device), kernels)
    return SQPResult(*[t[0] for t in res])


def solve_batch(spec: ProblemSpec, data: ProblemData,
                params: SQPParams = SQPParams(), device="cuda",
                kernels: bool = True) -> SQPResult:
    """Solve a batch of instances (every tensor of ``data`` has a leading
    lane axis) in one lockstep loop; lanes that finish are frozen.

    ``kernels=False`` runs the plain PyTorch versions of the QP and
    collision kernels on a CUDA device as well (for comparisons)."""
    return _solve(spec, params, _on_device(data, device), kernels)


def solve_batch_compact(spec: ProblemSpec, data: ProblemData,
                        params: SQPParams = SQPParams(),
                        phase_qp_solves: int = 8,
                        min_bucket: int = 8,
                        mesh=None, device="cuda",
                        kernels: bool = True) -> SQPResult:
    """Batched solve with host-side straggler compaction (multi-phase).

    Runs phases of ``phase_qp_solves`` QP solves each: after every phase
    it retires the lanes that reached a terminal status, gathers the
    stragglers into a power-of-two bucket and resumes them mid-solve via
    ``ProblemData.resume`` (merit coeffs, trust box, iteration counters) —
    each lane's iterate sequence is that of the single-phase solve.
    Compaction recurses until the bucket stops shrinking, then the
    remaining budget runs in one final phase.

    Requires ``phase_qp_solves < params.max_iter`` so that a phase-boundary
    ``SCO_ITERATION_LIMIT`` on a lane with ``sqp_it < max_iter`` can only
    mean "budget exhausted, still running".  ``mesh`` (multi-device) is
    not ported yet.
    """
    if mesh is not None:
        raise NotImplementedError("solve_batch_compact(mesh=...) is not "
                                  "ported yet")
    _check_unported(params)
    if not (0 < phase_qp_solves < params.max_iter):
        raise ValueError(
            f"phase_qp_solves={phase_qp_solves} must be in (0, "
            f"max_iter={params.max_iter}) for resumable-status detection")
    data = _on_device(data, device)
    batch = data.x0.shape[0]
    total_budget = params.max_total_qp_solves
    t_start = time.monotonic()
    # max_time is enforced HERE, at phase boundaries (the JAX package's
    # place), so the phases themselves run without it
    run_params = dataclasses.replace(params, max_time=float("inf"))

    def _resumable(res, spent):
        # resumable = exhausted every phase budget so far while still
        # RUNNING; terminal iteration limits are excluded by sqp_it < max_iter
        status, n_qp, sqp_it = (t.cpu().numpy() for t in
                                (res.status, res.n_qp_solves, res.sqp_it))
        return np.where((status == SCO_ITERATION_LIMIT) & (n_qp >= spent)
                        & (sqp_it < params.max_iter))[0]

    budget = min(phase_qp_solves, total_budget)
    p1 = dataclasses.replace(run_params, max_total_qp_solves=budget)
    res = _solve(spec, p1, data, kernels)
    spent = budget
    prev_bucket = batch

    while spent < total_budget:
        idx = _resumable(res, spent)
        if (params.max_time != float("inf")
                and time.monotonic() - t_start > params.max_time):
            if idx.size:  # the lanes still running stop on the clock
                live = torch.as_tensor(idx, device=res.status.device)
                status = res.status.clone()
                status[live] = TIME_LIMIT
                res = res._replace(status=status)
            return res
        if idx.size == 0:
            return res

        bucket = max(min_bucket, 1 << int(idx.size - 1).bit_length())
        bucket = min(bucket, batch)
        remaining = total_budget - spent
        if bucket >= prev_bucket or bucket <= min_bucket:
            # compaction exhausted — run the remainder in one phase
            budget = remaining
        else:
            budget = min(phase_qp_solves, remaining)
        dev = data.x0.device
        pad = torch.as_tensor(np.resize(idx, bucket), device=dev)
        d2 = tree_map(lambda a: a[pad], data._replace(resume=None))
        d2 = d2._replace(
            x0=res.x[pad],
            resume={
                "merit": res.merit_coeffs[pad],
                "box": res.trust_box_size[pad],
                "penalty_it": res.penalty_it[pad],
                "it": res.sqp_it[pad],
            })
        p2 = dataclasses.replace(run_params, max_total_qp_solves=budget)
        res2 = _solve(spec, p2, d2, kernels)
        spent += budget
        prev_bucket = bucket

        n = idx.size
        it = torch.as_tensor(idx, device=dev)

        def put(a, b):
            a = a.clone()
            a[it] = b[:n]
            return a

        def add(a, b):
            a = a.clone()
            a[it] += b[:n]
            return a

        res = res._replace(
            x=put(res.x, res2.x),
            status=put(res.status, res2.status),
            cost_vals=put(res.cost_vals, res2.cost_vals),
            cnt_viols=put(res.cnt_viols, res2.cnt_viols),
            total_cost=put(res.total_cost, res2.total_cost),
            n_func_evals=add(res.n_func_evals, res2.n_func_evals),
            n_qp_solves=add(res.n_qp_solves, res2.n_qp_solves),
            n_admm_iters=add(res.n_admm_iters, res2.n_admm_iters),
            merit_coeffs=put(res.merit_coeffs, res2.merit_coeffs),
            trust_box_size=put(res.trust_box_size, res2.trust_box_size),
            sqp_it=put(res.sqp_it, res2.sqp_it),
            penalty_it=put(res.penalty_it, res2.penalty_it),
        )
    return res
