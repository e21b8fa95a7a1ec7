"""Collision cost/constraint terms, discrete and swept ("cast"), and the
trajectory gate (``trajopt_tpu/terms/collision.py``).

Error rows are ``margin - dist``: per (step, pair) for the discrete terms,
per (step gap, sub-segment, pair) for the cast terms; a hinge cost
``coeff * max(0, margin - dist)`` or INEQ constraint rows.
:class:`DiscreteDistancePre` and :class:`CastDistancePre` own the FK +
distance (+ Jacobian) pipelines; every term built over the same object
receives its output as ``aux`` from the SQP engine, so a cost and a
constraint over one world share one distance pass and one Jacobian pass
per linearization.

On a CUDA tensor the pipelines run as hand-written kernels: K7
``disc_dist`` (distances + per-step Jacobian) and K7v ``disc_dist_value``
(``csrc/disc_dist.cu``) for the discrete terms; K4 ``cast_seg`` (distances
+ two-endpoint Jacobian, at n_dof 1 to 12), K4v ``cast_seg_value`` and K5
``cast_sweep`` (the n_sub gate of ``trajectory_in_collision``;
``csrc/cast_seg.cu``) for the cast terms, whose CVX instantiations
(``csrc/cast_cvx.cu``) a world with CONVEX geometry takes; they add the
CONVEX routes (``convex_route`` runs one route alone, as a probe).  On a
CPU tensor — or with ``kernels=False`` — the plain PyTorch versions run:
``value_jac`` is ``torch.func.vmap(torch.func.jacfwd(...))`` over the plain
world, the mirror of the reference's ``jax.vmap(jax.jacfwd(...))``.

``max_contacts`` (the reference's ``max_num_cnt``) keeps the K worst
contacts of each group: pair-level for the cast terms (a pair ranked by its
worst segment, all its segments kept), row-level for the discrete terms.
On a CUDA tensor the selection is K10 ``contact_select`` (with the banded
rows) and K10v ``contact_select_value`` (the values; ``csrc/
contact_select.cu``), on the distances K4 / K7 wrote; the plain version
(``contact_select_plain``) takes the K largest keys by a stable descending
sort, which keeps ``jax.lax.top_k``'s order (the lower index first among
equal keys).  ``max_contacts >= n_pairs`` selects nothing, as in the JAX
package.  ``weighted=True`` (use_weighted_sum) aggregates a group's rows
into one, in plain PyTorch.

Not ported yet (``NotImplementedError``): K7 on a world with CONVEX
geometry (its plain version runs on a CPU tensor); K4 above n_dof 12.

params: {"margins": (B,) or (B, n_pairs), "coeffs": likewise}.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _native
from ..collision import geometry as G
from ..collision.world import CollisionWorld
from ..ops.banded_rows import bb_to_dense, step_window
from ..utils.lanes import lane_broadcast
from .base import Term, hinge_cost, ineq_constraint

# the n_dof K4's Jacobian takes (csrc/cast_kernel.cuh): 7 (the 7-DoF arms)
# in an instantiation of its own, every other n_dof from 1 up to the
# ceiling in one more, with and without the CONVEX routes
JAC_NDOF = tuple(range(1, _native.CAST_ND_MAX + 1))
# K7's blocks (csrc/disc_dist.cu): (lane, step) slots and threads per CTA,
# per instantiation (the slots lowered where a world's records do not fit
# the shared memory: _disc_plan), chosen by measurement at the spherebot's, arm7's and
# boxbot's shapes (scripts/disc_ab.py --sweep; PERF.md section 6)
DISC_BLOCKS = {("disc_dist", torch.float32): (10, 256),
               ("disc_dist", torch.float64): (16, 256),
               ("disc_dist_value", torch.float32): (8, 256),
               ("disc_dist_value", torch.float64): (8, 128)}
# the (pair, slot, column) items a K7 CTA takes at most by default: a
# world whose slots carry more takes fewer slots a CTA (down to one), so
# that its grid still fills the card (PERF.md section 6: arm7 with 450
# table spheres, 22,246 items a slot: 0.88 ms at 8 slots a CTA, 0.22 ms
# at one, on an H100)
DISC_CTA_ITEMS = 4096
# the cast kernels' blocks (csrc/cast_block.cuh): a CTA of 64 or 128
# threads per (lane, gap), in teams of 4, 8, 16 or 32 lanes of a warp that
# share one feature enumeration.  On the card each kernel runs at the
# layout measured fastest at the main paths' shapes (PERF.md section 6),
# per kernel and per instantiation (with the CONVEX routes or not).
# The host build plays any layout (team 1: one thread is the whole block;
# CAST_TEAM: warps of a 128-thread CTA), all bitwise equal.
CAST_TEAM, CAST_THREADS = 32, 128
CAST_BLOCKS = {("cast_seg", False): (64, 8), ("cast_seg_value", False): (64, 8),
               ("cast_sweep", False): (128, 16),
               ("cast_seg", True): (128, 16), ("cast_seg_value", True): (128, 16),
               ("cast_sweep", True): (64, 8),
               # the route probe, per route
               ("convex_feature", True): (128, 16),
               ("convex_fw", True): (64, 8)}


def _bcast(v, n, dtype):
    return lane_broadcast(v.to(dtype), (n,))


def _coeff_scalar(p, dtype):
    """Per-lane scalar coefficient (B,) of a weighted (use_weighted_sum)
    term: the loader rejects per-pair coeff overrides there, so the
    (B, n_pairs) coeffs are uniform and element 0 is THE coefficient."""
    c = p["coeffs"].to(dtype)
    return c.reshape(c.shape[0], -1)[:, 0]


def _weighted_rows(errs, Js):
    """Error-weighted average of per-pair gradients (the reference's
    use_weighted_sum, weighted_average_methods.cpp:31-68): a group's row
    grad = sum_p w_p grad_p / sum_p w_p, w_p = max(err_p, 0) / max_err (its
    err is max_err, the largest over its rows).  errs (B, G, R), Js (B, G,
    R, w) -> (B, G, w)."""
    max_err = torch.amax(errs, dim=2)
    w = torch.clamp(errs, min=0.0) / torch.clamp(max_err[..., None],
                                                 min=1e-12)
    tot = torch.clamp(torch.sum(w, dim=2), min=1e-12)
    return torch.einsum("bgp,bgpw->bgw", w, Js) / tot[..., None]


# --------------------------------------------------------------------------
# K10 / K10v: the worst-contact selection
# --------------------------------------------------------------------------


def contact_select_plain(D, margins, coeffs, buffer: float, K: int, Ja=None,
                         Jb=None, right_group: int = -1):
    """The worst-contact selection (K10's plain version; see
    ``csrc/contact_select.cuh`` for the layouts).  D (B, G, S, P) with
    margins, coeffs (B, P): a pair's key is its largest ``margin - D`` over
    the group's S segments, and the K largest keys are kept (a stable
    descending sort: the lower index first among equal keys, as
    ``jax.lax.top_k``).  Returns the selected value rows (B, G S K),
    ``where(act, coeff err, -1)`` with act = err >= -buffer, and, given Ja
    (B, G, S P, nc), the banded window rows (B, G, S K, 2 nc) scaled by
    ``where(act, coeff, 0)``: cast ``[-Ja, -Jb]``; discrete (Jb None, S 1)
    ``-Ja`` in the first half, or in the second for group ``right_group``."""
    B, G, S, P = D.shape
    errs = margins[:, None, None, :] - D
    key = torch.amax(errs, dim=2)  # (B, G, P)
    idx = torch.sort(key, dim=-1, descending=True, stable=True).indices[
        ..., :K]
    vals = torch.gather(errs, 3, idx[:, :, None, :].expand(B, G, S, K))
    act = vals >= -torch.as_tensor(buffer, dtype=D.dtype)
    cof = torch.gather(coeffs, 1, idx.reshape(B, G * K)).reshape(B, G, 1, K)
    out = torch.where(act, cof * vals, torch.full_like(vals, -1.0)).reshape(
        B, -1)
    if Ja is None:
        return out
    sc = torch.where(act, cof, torch.zeros_like(vals))[..., None]
    nc = Ja.shape[-1]
    gidx = idx[:, :, None, :, None].expand(B, G, S, K, nc)

    def rows(J):
        Js = torch.gather(J.reshape(B, G, S, P, nc), 3, gidx)
        return ((-Js) * sc).reshape(B, G, S * K, nc)

    Ra = rows(Ja)
    if Jb is not None:
        return out, torch.cat([Ra, rows(Jb)], dim=-1)
    z = torch.zeros_like(Ra)
    right = (torch.arange(G, device=D.device) == right_group)[
        None, :, None, None]
    return out, torch.where(right, torch.cat([z, Ra], -1),
                            torch.cat([Ra, z], -1))


# the register route's caps (csrc/contact_select.cuh NP_MAX, S_MAX, NR):
# pairs and row slots per lane, segments
SELECT_PAIRS_PER_LANE, SELECT_SEG_MAX, SELECT_ROW_SLOTS = 2, 8, 2


def select_route(P: int, S: int, K: int, team: int = 32) -> str:
    """The route K10 / K10v take at (P, S, K) for a team of ``team``
    threads (the card's: 32), as ``contact_select.cuh reg_route``:
    "registers" or "shared"."""
    regs = P <= team * SELECT_PAIRS_PER_LANE and S <= SELECT_SEG_MAX \
        and S * K <= team * SELECT_ROW_SLOTS
    return "registers" if regs else "shared"


def _select_call(fn, D, margins, coeffs, buffer, K, Ja, Jb, right_group,
                 last):
    """Check the selection's arguments, allocate its outputs and call
    ``fn`` (a K10 entry point) with ``last`` (the stream, or the host
    build's team size)."""
    dt = D.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"contact_select: dtype {dt} is not float32/float64")
    if D.dim() != 4:
        raise ValueError("contact_select: D must be (B, G, S, P)")
    B, G, S, P = D.shape
    if not 1 <= K <= P:
        raise ValueError(f"contact_select: K={K} outside [1, {P}]")
    ins = [D, margins, coeffs] + [J for J in (Ja, Jb) if J is not None]
    for t in ins:
        if t.dtype != dt or t.device != D.device or not t.is_contiguous():
            raise ValueError("contact_select: every input must be contiguous "
                             "and of D's dtype and device")
    if margins.shape != (B, P) or coeffs.shape != (B, P):
        raise ValueError("contact_select: margins and coeffs must be (B, P)")
    nc = 0 if Ja is None else Ja.shape[-1]
    for J in (Ja, Jb):
        if J is not None and J.shape != (B, G, S * P, nc):
            raise ValueError(f"contact_select: J must be {(B, G, S * P, nc)}")
    if Jb is not None and Ja is None:
        raise ValueError("contact_select: Jb needs Ja")
    vals = D.new_empty((B, G * S * K))
    rows = D.new_empty((B, G, S * K, 2 * nc)) if Ja is not None else None
    code = fn(D.data_ptr(), 0 if Ja is None else Ja.data_ptr(),
              0 if Jb is None else Jb.data_ptr(), margins.data_ptr(),
              coeffs.data_ptr(), vals.data_ptr(),
              0 if rows is None else rows.data_ptr(), B, G, S, P, K, nc,
              right_group, float(buffer), last)
    _native.check("contact_select", code)
    return vals if rows is None else (vals, rows)


def _select_fn(lib, dt):
    return lib.contact_select_f32 if dt == torch.float32 \
        else lib.contact_select_f64


def contact_select(D, margins, coeffs, buffer: float, K: int, Ja=None,
                   Jb=None, right_group: int = -1, kernels: bool = True):
    """The worst-contact selection (arguments and outputs as
    :func:`contact_select_plain`): K10 (with Ja) or K10v (without) on a
    CUDA tensor, the plain version on a CPU tensor or with
    ``kernels=False``."""
    if not (D.is_cuda and kernels):
        return contact_select_plain(D, margins, coeffs, buffer, K, Ja, Jb,
                                    right_group)
    fn = _select_fn(_native.library("contact_select"), D.dtype)
    out = _select_call(fn, D, margins, coeffs, buffer, K, Ja, Jb,
                       right_group,
                       torch.cuda.current_stream(D.device).cuda_stream)
    _native.LAUNCHES["contact_select" if Ja is not None
                     else "contact_select_value"] += 1
    return out


def contact_select_host(D, margins, coeffs, buffer: float, K: int, Ja=None,
                        Jb=None, right_group: int = -1, team: int = 32):
    """K10 / K10v built for the host (``csrc/contact_select_host.cpp``), on
    CPU tensors: each group run by ``team`` threads in turn (``team`` a
    power of two up to 32), on the route the card takes at that team size
    (:func:`select_route`): the register route's warp reductions and
    shuffles, or the shared-memory route's butterfly, over the team."""
    if D.is_cuda:
        raise ValueError("contact_select: the host build takes CPU tensors")
    fn = _select_fn(_native.host_library("contact_select_host"), D.dtype)
    return _select_call(fn, D, margins, coeffs, buffer, K, Ja, Jb,
                        right_group, team)


# --------------------------------------------------------------------------
# K4 / K4v / K5 wrappers
# --------------------------------------------------------------------------


def jac_instantiation(n_dof: int) -> int:
    """The tangent columns of the K4 instantiation that runs at ``n_dof``
    (csrc/cast_kernel.cuh ``launch_jac``): 7 itself, every other n_dof the
    ceiling's; raises above the ceiling."""
    if n_dof not in JAC_NDOF:
        raise NotImplementedError(
            f"cast_seg: the Jacobian kernel is built for n_dof 1 to "
            f"{JAC_NDOF[-1]}, not {n_dof}")
    return 7 if n_dof == 7 else JAC_NDOF[-1]


def _cast_call(lib, kind: str, world: CollisionWorld, x: torch.Tensor,
               n_steps: int, nc: int, first: int, n_gaps: int, n_sub: int,
               stream=None, block=(CAST_THREADS, CAST_TEAM), clk=None):
    """Call entry point ``kind`` of a cast library on ``x`` (B, n_steps *
    nc); the gaps are steps [first, first + n_gaps]; ``block`` the CTA's
    (threads, team size); ``clk`` (card only, int64 (B n_gaps, 4))
    receives each CTA's phase timer.  Returns D, and Ja, Jb for
    ``cast_seg``."""
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{kind}: dtype {x.dtype} is not float32/float64")
    if x.dim() != 2 or x.shape[1] != n_steps * nc or not x.is_contiguous():
        raise ValueError(f"{kind}: x must be contiguous (B, {n_steps * nc})")
    nd, P = world.chain.n_dof, world.n_pairs
    cvx = bool(world.n_convex_verts)
    if kind == "cast_seg":
        jac_instantiation(nd)
    if n_sub < 2 or n_gaps < 1 or first + n_gaps > n_steps - 1:
        raise ValueError(f"{kind}: bad n_sub={n_sub} or gap range")
    lanes = x.shape[0]
    ints, reals = world.kernel_tables(x.dtype, x.device)
    ss = CollisionWorld._fractions(n_sub, x.dtype, x.device)
    n_seg = n_sub - 1
    if kind == "cast_sweep":
        D = torch.empty((lanes, n_gaps, P), dtype=x.dtype, device=x.device)
    else:
        D = torch.empty((lanes, n_gaps, n_seg, P), dtype=x.dtype,
                        device=x.device)
    Ja = Jb = None
    if kind == "cast_seg":
        Ja = torch.empty((lanes, n_gaps, n_seg * P, nc), dtype=x.dtype,
                         device=x.device)
        Jb = torch.empty_like(Ja)
    sfx = ("_cvx_" if cvx else "_") + (
        "f32" if x.dtype == torch.float32 else "f64")
    code = getattr(lib, f"{kind}{sfx}")(
        ints.data_ptr(), reals.data_ptr(), x.data_ptr(), x.stride(0), nc,
        first, n_gaps, ss.data_ptr(), n_sub, D.data_ptr(),
        0 if Ja is None else Ja.data_ptr(),
        0 if Jb is None else Jb.data_ptr(), lanes, world.chain.n_links, nd,
        len(world.geoms), P, *block, 0 if clk is None else clk.data_ptr(),
        stream)
    _native.check(kind, code)
    return D, Ja, Jb


def _cast_launch(kind: str, world: CollisionWorld, x: torch.Tensor, *args,
                 clk=None):
    """Launch one of the cast kernels on the card (arguments as
    :func:`_cast_call`)."""
    if not x.is_cuda:
        raise ValueError(f"{kind}: tensors must be on a CUDA device")
    # K4 at any n_dof but 7 is the ceiling's library
    lib = _native.library(("cast_cvx" if world.n_convex_verts else "cast_seg")
                          + ("_ceil" if kind == "cast_seg"
                             and world.chain.n_dof != 7 else ""))
    out = _cast_call(lib, kind, world, x, *args,
                     stream=torch.cuda.current_stream(x.device).cuda_stream,
                     block=CAST_BLOCKS[kind, bool(world.n_convex_verts)],
                     clk=clk)
    _native.LAUNCHES[kind] += 1
    if kind == "cast_seg" and world.chain.n_dof != 7:
        _native.LAUNCHES[f"cast_seg_nd{world.chain.n_dof}"] += 1
    for route in world.kernel_routes():
        _native.LAUNCHES[route] += 1
    if world.n_box_pairs:
        _native.LAUNCHES["cast_boxbox"] += 1
    return out


def cast_host(kind: str, world: CollisionWorld, x: torch.Tensor, *args,
              team: int = 1, threads: int = CAST_THREADS):
    """The cast kernels built for the host (``csrc/cast_host.cpp``: the
    kernels' block body, its threads played in turn), on a CPU tensor: a
    check of the kernels on a CPU (arguments as :func:`_cast_call`).
    ``team=1``: one thread is the whole block; a larger team: a CTA of
    ``threads`` threads in teams of ``team`` (``CAST_TEAM``: warps), each
    thread's share in turn, as the card divides the work.  Every layout
    gives bitwise the same outputs."""
    if x.is_cuda:
        raise ValueError(f"{kind}: the host build takes CPU tensors")
    return _cast_call(_native.host_library("cast_host"), kind, world, x,
                      *args, block=(threads, team))


def kernel_attributes():
    """{instantiation: {"num_regs", "local_bytes", "max_threads",
    "static_smem_bytes"}} of every K4, K4v, K5, K7 and K10 instantiation on
    the card (``cudaFuncGetAttributes``, through each library's query);
    ``cast_seg_ceil_*`` is K4 at the n_dof ceiling (every n_dof but 7),
    ``disc_dist*_global_*`` K7 / K7v reading a large world's tables from
    global memory."""
    out = {}
    kinds = {"cast_seg": [f"{k}_{s}" for k in ("cast_seg", "cast_seg_value",
                                                "cast_sweep")
                          for s in ("f32", "f64")],
             "cast_seg_ceil": ["cast_seg_ceil_f32", "cast_seg_ceil_f64"],
             "cast_cvx": [f"{k}_cvx_{s}" for k in ("cast_seg",
                                                   "cast_seg_value",
                                                   "cast_sweep")
                          for s in ("f32", "f64")],
             "cast_cvx_ceil": ["cast_seg_cvx_ceil_f32",
                               "cast_seg_cvx_ceil_f64"],
             "disc_dist": [f"{k}{g}_{s}" for g in ("", "_global")
                           for k in ("disc_dist", "disc_dist_value")
                           for s in ("f32", "f64")],
             "contact_select": ["contact_select_f32", "contact_select_f64",
                                "contact_select_np2_f32",
                                "contact_select_np2_f64"]}
    for lib, names in kinds.items():
        src = lib.removesuffix("_ceil")
        query = getattr(_native.library(lib), f"{src}_attrs")
        for which, kind in enumerate(names):
            buf = (ctypes.c_int * 4)()
            _native.check(f"{src}_attrs", query(which, buf))
            out[kind] = dict(zip(("num_regs", "local_bytes", "max_threads",
                                  "static_smem_bytes"), list(buf)))
    return out


def _route_call(lib, world: CollisionWorld, V1, r1, V2, r2, fw: bool,
                stream=None, block=(CAST_THREADS, CAST_TEAM),
                index: bool = False):
    """The route probe ``convex_route`` of a cast library on rows of
    vertex sets V1 (rows, n1, 3), V2 (rows, n2, 3) and radii (rows,);
    ``index``: also the witness index per row (the generic enumeration's
    winning candidate, Frank-Wolfe's final direction)."""
    dt = V1.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"convex_route: dtype {dt} is not float32/float64")
    V1, V2 = V1.contiguous(), V2.contiguous()
    r1, r2 = r1.to(dt).contiguous(), r2.to(dt).contiguous()
    rows = V1.shape[0]
    if V2.shape[0] != rows or r1.shape != (rows,) or r2.shape != (rows,):
        raise ValueError("convex_route: V1, V2, r1, r2 need one row each")
    ints, reals = world.kernel_tables(dt, V1.device)
    D = torch.empty((rows,), dtype=dt, device=V1.device)
    K = torch.empty((rows,), dtype=torch.int32, device=V1.device) \
        if index else None
    sfx = "f32" if dt == torch.float32 else "f64"
    code = getattr(lib, f"convex_route_{sfx}")(
        ints.data_ptr(), reals.data_ptr(), V1.data_ptr(), V1.shape[1],
        V2.data_ptr(), V2.shape[1], r1.data_ptr(), r2.data_ptr(), rows,
        int(fw), D.data_ptr(), 0 if K is None else K.data_ptr(), *block,
        stream)
    _native.check("convex_route", code)
    return (D, K) if index else D


def convex_route(world: CollisionWorld, V1, r1, V2, r2, fw: bool):
    """One CONVEX route alone, a row per team: the generic feature
    enumeration (``fw=False``, ``make_feature_distance(n1, n2,
    generic_topology)``) or the Frank-Wolfe max separation (``fw=True``,
    ``d_convex_convex``) between conv(V1)+r1 and conv(V2)+r2.  The kernel
    on a CUDA tensor (the world's tables give it the topologies and cover
    directions), the plain version on a CPU tensor."""
    if not V1.is_cuda:
        if fw:
            return G.d_convex_convex(V1, r1, V2, r2)
        return G.make_feature_distance(V1.shape[1], V2.shape[1],
                                       G.generic_topology)(V1, r1, V2, r2)
    out = _route_call(_native.library("cast_cvx"), world, V1, r1, V2, r2, fw,
                      torch.cuda.current_stream(V1.device).cuda_stream,
                      block=CAST_BLOCKS["convex_fw" if fw else
                                        "convex_feature", True])
    _native.LAUNCHES["convex_route"] += 1
    return out


def convex_route_host(world: CollisionWorld, V1, r1, V2, r2, fw: bool,
                      team: int = 1, index: bool = False):
    """The route probe built for the host, on CPU tensors (``team`` as
    :func:`cast_host`, ``index`` as :func:`_route_call`)."""
    if V1.is_cuda:
        raise ValueError("convex_route: the host build takes CPU tensors")
    return _route_call(_native.host_library("cast_host"), world, V1, r1, V2,
                       r2, fw, block=(CAST_THREADS, team), index=index)


# --------------------------------------------------------------------------
# K7 / K7v wrappers and the discrete terms
# --------------------------------------------------------------------------


class DiscPlan(NamedTuple):
    """What a call of K7 / K7v takes that does not depend on x's values or
    lanes (:func:`_disc_plan`)."""
    kind: str           # "disc_dist" or "disc_dist_value"
    fn: object          # the library's entry point
    tables: tuple       # the world's ints, reals: pointers, lengths
    n_steps: int        # x holds n_steps steps of nc columns
    nc: int
    first: int          # the steps [first, first + span)
    span: int
    sizes: tuple        # links, dofs, geometries
    slots: int          # (lane, step) slots a CTA, within the shared memory
    stage: int          # 1: the tables staged into shared memory
    threads: int
    n_pairs: int
    box_pairs: bool     # a pair is box-box (cast_boxbox's count)


def _disc_plan(lib, kind: str, world: CollisionWorld, x: torch.Tensor,
               n_steps: int, nc: int, first: int, span: int,
               block: Optional[tuple] = None) -> DiscPlan:
    """The plan of a call of entry point ``kind`` (``disc_dist`` or
    ``disc_dist_value``) of a library on the steps [first, first + span)
    of n_steps steps of nc columns, cached on the world per (library,
    kind, dtype, device, steps, block).  ``block`` (slots, threads,
    stage), each None for the default: ``DISC_BLOCKS``'s threads and its
    slots, fewer where they would carry more than ``DISC_CTA_ITEMS``
    items, then lowered to what fits the card's shared memory and the
    tables staged or not as the launcher's ``disc_dist_layout`` finds.
    Raises, and caches nothing, on a dtype, a step range or a world the
    kernel does not take (CONVEX geometry, or one (lane, step)'s record
    larger than a block's shared memory)."""
    key = ("disc_plan", id(lib), kind, x.dtype, x.device, n_steps, nc, first,
           span, block)
    plan = world._cache.get(key)
    if plan is not None:
        return plan
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{kind}: dtype {x.dtype} is not float32/float64")
    if span < 1 or first < 0 or first + span > n_steps:
        raise ValueError(f"{kind}: bad step range")
    if world.n_convex_verts:
        raise NotImplementedError(
            f"{kind}: a world with CONVEX geometry has no K7 instantiation "
            "yet")
    S, nt, stage = (None, None, None) if block is None else block
    if S is None:
        items = world.n_pairs * (nc if kind == "disc_dist" else 1)
        S = min(DISC_BLOCKS[kind, x.dtype][0],
                max(1, DISC_CTA_ITEMS // max(1, items)))
    ints, reals = world.kernel_tables(x.dtype, x.device)
    sizes = (world.chain.n_links, world.chain.n_dof, len(world.geoms))
    fit = (ctypes.c_int * 2)()
    if lib.disc_dist_layout(x.element_size(), ints.numel(), reals.numel(),
                            *sizes, S, fit) < 0:
        raise ValueError(f"{kind}: one (lane, step)'s record of this world "
                         "does not fit a block's shared memory")
    sfx = "f32" if x.dtype == torch.float32 else "f64"
    plan = world._cache[key] = DiscPlan(
        kind, getattr(lib, f"{kind}_{sfx}"),
        (ints.data_ptr(), reals.data_ptr(), ints.numel(), reals.numel()),
        n_steps, nc, first, span, sizes, fit[0],
        fit[1] if stage is None else int(stage),
        nt or DISC_BLOCKS[kind, x.dtype][1], world.n_pairs,
        world.n_box_pairs > 0)
    return plan


def _disc_call(plan: DiscPlan, x: torch.Tensor, stream=None, out=None):
    """Run a plan of :func:`_disc_plan` on ``x`` (B, n_steps * nc), into
    ``out`` (D, J) where given.  Returns D (B, span, P) and, for
    ``disc_dist``, J (B, span, P, nc)."""
    width = plan.n_steps * plan.nc
    if x.dim() != 2 or x.shape[1] != width or not x.is_contiguous():
        raise ValueError(f"{plan.kind}: x must be contiguous (B, {width})")
    lanes = x.shape[0]
    if out is None:
        D = torch.empty((lanes, plan.span, plan.n_pairs), dtype=x.dtype,
                        device=x.device)
        J = torch.empty((lanes, plan.span, plan.n_pairs, plan.nc),
                        dtype=x.dtype, device=x.device) \
            if plan.kind == "disc_dist" else None
    else:
        D, J = out
    code = plan.fn(*plan.tables, x.data_ptr(), x.stride(0), plan.nc,
                   plan.first, plan.span, D.data_ptr(),
                   0 if J is None else J.data_ptr(), lanes, *plan.sizes,
                   plan.slots, plan.stage, plan.threads, stream)
    _native.check(plan.kind, code)
    return D, J


def disc_launch(kind: str, world: CollisionWorld, x: torch.Tensor,
                n_steps: int, nc: int, first: int, span: int):
    """Launch K7 / K7v on the card on ``x`` (B, n_steps * nc), the steps
    [first, first + span): D (B, span, P) and, for ``disc_dist``, J (B,
    span, P, nc), zero past n_dof."""
    if not x.is_cuda:
        raise ValueError(f"{kind}: tensors must be on a CUDA device")
    plan = _disc_plan(_native.library("disc_dist"), kind, world, x, n_steps,
                      nc, first, span)
    # the current stream's handle, as torch.cuda.current_stream(...)
    # .cuda_stream gives it, without building a Stream object per call
    out = _disc_call(plan, x,
                     torch._C._cuda_getCurrentRawStream(x.get_device()))
    _native.LAUNCHES[kind] += 1
    if plan.box_pairs:
        _native.LAUNCHES["cast_boxbox"] += 1
    return out


def disc_host(kind: str, world: CollisionWorld, x: torch.Tensor,
              n_steps: int, nc: int, first: int, span: int,
              slots: Optional[int] = None, threads: Optional[int] = None,
              stage: Optional[bool] = None):
    """K7 / K7v built for the host (``csrc/cast_host.cpp``: the kernels'
    block body, its threads played in turn), on a CPU tensor (arguments as
    :func:`disc_launch`; ``slots`` (lane, step) slots, ``threads`` a CTA
    and ``stage`` the tables staged, by default the card's for the kind,
    dtype and world: any slots >= 1 and threads 1 to 256 within the
    card's shared memory)."""
    if x.is_cuda:
        raise ValueError(f"{kind}: the host build takes CPU tensors")
    plan = _disc_plan(_native.host_library("cast_host"), kind, world, x,
                      n_steps, nc, first, span, (slots, threads, stage))
    return _disc_call(plan, x)


class DiscreteDistancePre:
    """Shared per-step distance (+ per-step Jacobian) pipeline.

    ``value(x)`` -> D (B, span, P) signed distances; ``value_jac(x)`` ->
    (D, Js) with Js (B, span, P, nc) the raw distance Jacobian wrt that
    step's columns (the inv-dt column zero-padded).  ``kernels`` holds the
    choice of the last ``value`` / ``value_jac`` call: the terms' selection
    on that output follows it (K10 or its plain version)."""

    def __init__(self, world: CollisionWorld, n_steps: int,
                 first_step: int = 0, last_step: Optional[int] = None,
                 n_cols: Optional[int] = None):
        self.world = world
        self.n_steps = n_steps
        self.first_step = first_step
        self.last = (n_steps - 1) if last_step is None else last_step
        self.span = self.last - first_step + 1
        self.n_dof = world.chain.n_dof
        self.nc = n_cols or self.n_dof
        self.P = world.n_pairs
        self.kernels = True

    def _q(self, x):
        X = x.reshape(x.shape[0], self.n_steps, self.nc)
        return X[:, self.first_step:self.last + 1, :self.n_dof]

    def _launch(self, kind, x):
        return disc_launch(kind, self.world, x.contiguous(), self.n_steps,
                           self.nc, self.first_step, self.span)

    def value(self, x, kernels: bool = True):
        """D (B, span, P): K7v on a CUDA tensor (``kernels=False`` takes
        the plain version there), the plain version on the CPU."""
        self.kernels = kernels
        if x.is_cuda and kernels:
            return self._launch("disc_dist_value", x)[0]
        return self.world.pair_distances(self._q(x))

    def value_jac(self, x, kernels: bool = True):
        """(D, Js): K7 on a CUDA tensor (``kernels=False`` takes the plain
        version there); the plain version is ``vmap(jacfwd)`` over the
        plain world."""
        self.kernels = kernels
        if x.is_cuda and kernels:
            return self._launch("disc_dist", x)
        B = x.shape[0]

        def f(q):
            d = self.world.pair_distances(q)
            return d, d

        Js, D = torch.func.vmap(torch.func.jacfwd(f, has_aux=True))(
            self._q(x).reshape(-1, self.n_dof))
        Js = Js.reshape(B, self.span, self.P, self.n_dof)
        if self.nc != self.n_dof:  # the inv-dt column has no dependence
            Js = torch.cat([Js, Js.new_zeros(Js.shape[:-1] + (
                self.nc - self.n_dof,))], dim=-1)
        return D.reshape(B, self.span, self.P), Js


def discrete_collision_term(
    name: str,
    world: CollisionWorld,
    n_steps: int,
    first_step: int = 0,
    last_step: Optional[int] = None,
    is_constraint: bool = False,
    n_cols: Optional[int] = None,
    weighted: bool = False,
    max_contacts: Optional[int] = None,
    buffer: float = 0.5,
    pre: Optional[DiscreteDistancePre] = None,
) -> Term:
    """Discrete collision at each step in [first, last]: one hinge / INEQ
    row per (step, pair).  ``max_contacts`` < n_pairs keeps the K worst
    rows of each step within the ``buffer`` window (row-level selection,
    K10; per-pair coeffs folded into the kept rows, deactivated rows the
    constant -1 with a zero Jacobian); ``weighted=True`` aggregates a
    step's pairs into ONE row (error-weighted average gradient).  ``pre``:
    a shared :class:`DiscreteDistancePre` (cost + constraint over one
    world)."""
    if pre is None:
        pre = DiscreteDistancePre(world, n_steps, first_step, last_step,
                                  n_cols)
    assert (pre.world is world and pre.n_steps == n_steps
            and pre.first_step == first_step
            and pre.last == ((n_steps - 1) if last_step is None else last_step)
            and pre.nc == (n_cols or world.chain.n_dof))
    span, P, nc = pre.span, pre.P, pre.nc
    n = span * P
    steps = first_step + np.arange(span)

    def _errs(x, p, aux=None):
        D = aux if aux is not None else pre.value(x)  # (B, span, P)
        margins = _bcast(p["margins"], P, x.dtype)
        return margins[:, None, :] - D

    def fn(x, p, aux=None):
        return _errs(x, p, aux).reshape(x.shape[0], -1)

    def _row_coeffs(p, dtype):
        return _bcast(p["coeffs"], P, dtype).repeat(1, span)

    def _jac_steps(x, p, aux=None, cf=False):
        _, Js = aux if aux is not None else pre.value_jac(x)
        if cf:
            Js = Js * _bcast(p["coeffs"], P, x.dtype)[:, None, :, None]
        return -Js  # d(margin - dist)/dq

    def _dense(Js):
        """The per-step blocks Js (B, span, r, nc) scattered into the
        (span r, n_x) layout: each row block depends on ONE step."""
        B, r = Js.shape[0], Js.shape[2]
        J = Js.new_zeros((B, span, r, n_steps, nc))
        sidx = torch.arange(span, device=Js.device)
        # advanced indices (sidx, first + sidx) are separated by a slice:
        # they lead
        J[:, sidx, :, first_step + sidx, :] = Js.permute(1, 0, 2, 3)
        return J.reshape(B, span * r, n_steps * nc)

    def jac_fn(x, p, aux=None, cf=False):
        return _dense(_jac_steps(x, p, aux, cf))

    def jac_banded_fn(x, p, aux=None, cf=False):
        return step_window(_jac_steps(x, p, aux, cf), steps, n_steps)

    if max_contacts is not None and max_contacts < P:
        K = max_contacts
        # step_window's windows: the last trajectory step sits in the
        # second half of window n_steps - 2 (group ``right``)
        G = torch.as_tensor(np.minimum(steps, n_steps - 2), dtype=torch.int32)
        right = n_steps - 1 - first_step

        def _sel(x, p, aux, jac):
            args = (_bcast(p["margins"], P, x.dtype).contiguous(),
                    _bcast(p["coeffs"], P, x.dtype).contiguous(), buffer, K)
            if not jac:
                D = aux if aux is not None else pre.value(x)
                return contact_select(D[:, :, None, :].contiguous(), *args,
                                      kernels=pre.kernels)
            D, Js = aux if aux is not None else pre.value_jac(x)
            return contact_select(D[:, :, None, :].contiguous(), *args,
                                  Js.contiguous(), None, right,
                                  kernels=pre.kernels)[1]

        def sfn(x, p, aux=None):
            return _sel(x, p, aux, False)

        def sjac(x, p, aux=None):
            Bw = _sel(x, p, aux, True)  # one half of each row is zero
            return _dense(Bw[..., :nc] + Bw[..., nc:])

        def sjac_banded(x, p, aux=None):
            return _sel(x, p, aux, True), G.to(x.device)

        if is_constraint:
            return ineq_constraint(name, span * K, sfn, jac_fn=sjac,
                                   viol_groups=span, step_coupling=0,
                                   jac_banded_fn=sjac_banded, pre_fn=pre)
        return hinge_cost(name, span * K, sfn, jac_fn=sjac, step_coupling=0,
                          jac_banded_fn=sjac_banded, pre_fn=pre)

    if weighted:
        def wfn(x, p, aux=None):
            werr = torch.amax(_errs(x, p, aux), dim=2)  # (B, span)
            if is_constraint:
                werr = werr * _coeff_scalar(p, x.dtype)[:, None]
            return werr

        def wjac_banded(x, p, aux=None):
            if aux is None:
                aux = pre.value_jac(x)
            Jrow = _weighted_rows(_errs(x, p, aux[0]), _jac_steps(x, p, aux))
            if is_constraint:
                Jrow = Jrow * _coeff_scalar(p, x.dtype)[:, None, None]
            return step_window(Jrow[:, :, None, :], steps, n_steps)

        def wjac(x, p, aux=None):
            Bw, Gw = wjac_banded(x, p, aux)
            return bb_to_dense([Bw], [Gw], n_steps * nc, nc)

        def wwf(p):
            c = _coeff_scalar(p, p["coeffs"].dtype)
            return c[:, None].expand(c.shape[0], span)

        if is_constraint:
            return ineq_constraint(name, span, wfn, jac_fn=wjac,
                                   viol_groups=span, step_coupling=0,
                                   jac_banded_fn=wjac_banded, pre_fn=pre)
        return hinge_cost(name, span, wfn, weight_fn=wwf, jac_fn=wjac,
                          step_coupling=0, jac_banded_fn=wjac_banded,
                          pre_fn=pre)

    if is_constraint:
        def cfn(x, p, aux=None):
            return fn(x, p, aux) * _row_coeffs(p, x.dtype)
        return ineq_constraint(
            name, n, cfn,
            jac_fn=lambda x, p, aux=None: jac_fn(x, p, aux, cf=True),
            viol_groups=span,  # one reference constraint per timestep
            step_coupling=0,
            jac_banded_fn=lambda x, p, aux=None: jac_banded_fn(
                x, p, aux, cf=True),
            pre_fn=pre)
    return hinge_cost(name, n, fn, weight_fn=lambda p: _row_coeffs(
        p, p["coeffs"].dtype), jac_fn=jac_fn, step_coupling=0,
        jac_banded_fn=jac_banded_fn, pre_fn=pre)


class CastDistancePre:
    """Shared swept-distance (+ two-endpoint Jacobian) pipeline.

    ``value(x)`` -> D (B, n_gaps, n_seg, P); ``value_jac(x)`` -> (D, (Ja,
    Jb)) with Ja / Jb (B, n_gaps, n_seg * P, nc) the raw distance Jacobians
    wrt the gap's two endpoint steps.  ``kernels``: as
    :class:`DiscreteDistancePre`."""

    def __init__(self, world: CollisionWorld, n_steps: int,
                 first_step: int = 0, last_step: Optional[int] = None,
                 n_sub: int = 8, n_cols: Optional[int] = None):
        self.world = world
        self.n_steps = n_steps
        self.first_step = first_step
        self.last = (n_steps - 1) if last_step is None else last_step
        self.n_gaps = self.last - first_step
        assert self.n_gaps >= 1
        self.n_dof = world.chain.n_dof
        self.nc = n_cols or self.n_dof
        self.P = world.n_pairs
        self.n_seg = max(n_sub - 1, 1)
        self.R = self.n_seg * self.P
        self.kernels = True

    def _qab(self, x):
        X = x.reshape(x.shape[0], self.n_steps, self.nc)[..., :self.n_dof]
        return (X[:, self.first_step:self.last],
                X[:, self.first_step + 1:self.last + 1])

    def _launch(self, kind, x):
        return _cast_launch(kind, self.world, x.contiguous(), self.n_steps,
                            self.nc, self.first_step, self.n_gaps,
                            self.n_seg + 1)

    def value(self, x, kernels: bool = True):
        """D (B, n_gaps, n_seg, P): K4v on a CUDA tensor (``kernels=False``
        takes the plain version there), the plain version on the CPU."""
        self.kernels = kernels
        if x.is_cuda and kernels:
            return self._launch("cast_seg_value", x)[0]
        qa, qb = self._qab(x)
        return self.world.cast_pair_distances_seg(qa, qb, self.n_seg + 1)

    def value_jac(self, x, kernels: bool = True):
        """(D, (Ja, Jb)): K4 on a CUDA tensor (``kernels=False`` takes the
        plain version there); the plain version is ``vmap(jacfwd)`` over
        the plain world."""
        self.kernels = kernels
        if x.is_cuda and kernels:
            D, Ja, Jb = self._launch("cast_seg", x)
            return D, (Ja, Jb)
        qa, qb = self._qab(x)
        B = x.shape[0]

        def f(a, b):
            d = self.world.cast_pair_distances_seg(a, b, self.n_seg + 1)
            return d, d

        (Ja, Jb), D = torch.func.vmap(
            torch.func.jacfwd(f, argnums=(0, 1), has_aux=True))(
            qa.reshape(-1, self.n_dof), qb.reshape(-1, self.n_dof))
        shape = (B, self.n_gaps, self.R, self.n_dof)
        Ja, Jb = Ja.reshape(shape), Jb.reshape(shape)
        if self.nc != self.n_dof:  # the inv-dt column has no dependence
            z = Ja.new_zeros(shape[:-1] + (self.nc - self.n_dof,))
            Ja = torch.cat([Ja, z], dim=-1)
            Jb = torch.cat([Jb, z], dim=-1)
        return D.reshape(B, self.n_gaps, self.n_seg, self.P), (Ja, Jb)


def cast_collision_term(
    name: str,
    world: CollisionWorld,
    n_steps: int,
    first_step: int = 0,
    last_step: Optional[int] = None,
    n_sub: int = 8,
    is_constraint: bool = False,
    n_cols: Optional[int] = None,
    weighted: bool = False,
    max_contacts: Optional[int] = None,
    buffer: float = 0.5,
    pre: Optional[CastDistancePre] = None,
) -> Term:
    """Swept-volume collision over each step gap in [first, last-1]: one
    hinge / INEQ row per (gap, sub-segment, pair).  ``max_contacts`` <
    n_pairs keeps the K worst PAIRS of each gap (ranked by their worst
    segment) with all their segments' rows (pair-level selection, K10);
    ``weighted=True`` aggregates a gap's rows into ONE.  ``pre``: a shared
    :class:`CastDistancePre` (cost + constraint over one world)."""
    if pre is None:
        pre = CastDistancePre(world, n_steps, first_step, last_step, n_sub,
                              n_cols)
    assert (pre.world is world and pre.n_steps == n_steps
            and pre.first_step == first_step
            and pre.last == ((n_steps - 1) if last_step is None else last_step)
            and pre.n_seg == max(n_sub - 1, 1)
            and pre.nc == (n_cols or world.chain.n_dof))
    n_gaps, P, n_seg, R, nc = pre.n_gaps, pre.P, pre.n_seg, pre.R, pre.nc
    n = n_gaps * R

    def _errs(x, p, aux=None):
        D = aux if aux is not None else pre.value(x)  # (B, n_gaps, n_seg, P)
        margins = _bcast(p["margins"], P, x.dtype)
        return (margins[:, None, None, :] - D).reshape(x.shape[0], n_gaps, R)

    def fn(x, p, aux=None):
        return _errs(x, p, aux).reshape(x.shape[0], -1)

    def _row_coeffs(p, dtype):
        return _bcast(p["coeffs"], P, dtype).repeat(1, n_gaps * n_seg)

    def _jac_gaps(x, p, aux=None, cf=False):
        _, (Ja, Jb) = aux if aux is not None else pre.value_jac(x)
        if cf:
            w = _bcast(p["coeffs"], P, x.dtype).repeat(1, n_seg)
            Ja = Ja * w[:, None, :, None]
            Jb = Jb * w[:, None, :, None]
        return -Ja, -Jb  # d(margin - dist)/dq

    def _dense(Ja_, Jb_, cols):
        """The per-gap row blocks (B, n_gaps, r, nc) scattered into the
        (n_gaps r, n_x) layout (each depends on the gap's two steps)."""
        B, r = Ja_.shape[0], Ja_.shape[2]
        J = Ja_.new_zeros((B, n_gaps, r, n_steps, nc))
        g = torch.arange(n_gaps, device=Ja_.device)
        J[:, g, :, first_step + g, :cols] = Ja_[..., :cols].permute(1, 0, 2, 3)
        J[:, g, :, first_step + 1 + g, :cols] = Jb_[..., :cols].permute(
            1, 0, 2, 3)
        return J.reshape(B, n_gaps * r, n_steps * nc)

    def jac_fn(x, p, aux=None, cf=False):
        return _dense(*_jac_gaps(x, p, aux, cf), pre.n_dof)

    def _G(x):
        return first_step + torch.arange(n_gaps, dtype=torch.int32,
                                         device=x.device)

    def jac_banded_fn(x, p, aux=None, cf=False):
        Ja_, Jb_ = _jac_gaps(x, p, aux, cf)
        return torch.cat([Ja_, Jb_], dim=-1), _G(x)

    if max_contacts is not None and max_contacts < P:
        # PAIR-level selection: a gap keeps its K worst pairs with ALL their
        # per-segment rows (the reference's contacts are per link pair)
        K = max_contacts
        KR = n_seg * K

        def _sel(x, p, aux, jac):
            args = (_bcast(p["margins"], P, x.dtype).contiguous(),
                    _bcast(p["coeffs"], P, x.dtype).contiguous(), buffer, K)
            if not jac:
                D = aux if aux is not None else pre.value(x)
                return contact_select(D.contiguous(), *args,
                                      kernels=pre.kernels)
            D, (Ja, Jb) = aux if aux is not None else pre.value_jac(x)
            return contact_select(D.contiguous(), *args, Ja.contiguous(),
                                  Jb.contiguous(), kernels=pre.kernels)[1]

        def sfn(x, p, aux=None):
            return _sel(x, p, aux, False)

        def sjac(x, p, aux=None):
            Bw = _sel(x, p, aux, True)
            return _dense(Bw[..., :nc], Bw[..., nc:], nc)

        def sjac_banded(x, p, aux=None):
            return _sel(x, p, aux, True), _G(x)

        if is_constraint:
            return ineq_constraint(name, n_gaps * KR, sfn, jac_fn=sjac,
                                   viol_groups=n_gaps, step_coupling=1,
                                   jac_banded_fn=sjac_banded, pre_fn=pre)
        return hinge_cost(name, n_gaps * KR, sfn, jac_fn=sjac,
                          step_coupling=1, jac_banded_fn=sjac_banded,
                          pre_fn=pre)

    if weighted:
        def wfn(x, p, aux=None):
            werr = torch.amax(_errs(x, p, aux), dim=2)  # (B, n_gaps)
            if is_constraint:
                werr = werr * _coeff_scalar(p, x.dtype)[:, None]
            return werr

        def wjac_banded(x, p, aux=None):
            if aux is None:
                aux = pre.value_jac(x)
            Js = torch.cat(_jac_gaps(x, p, aux), dim=-1)  # (B, n_gaps, R, 2nc)
            Jrow = _weighted_rows(_errs(x, p, aux[0]), Js)
            if is_constraint:
                Jrow = Jrow * _coeff_scalar(p, x.dtype)[:, None, None]
            return Jrow[:, :, None, :], _G(x)

        def wjac(x, p, aux=None):
            Bw, Gw = wjac_banded(x, p, aux)
            return bb_to_dense([Bw], [Gw], n_steps * nc, nc)

        def wwf(p):
            c = _coeff_scalar(p, p["coeffs"].dtype)
            return c[:, None].expand(c.shape[0], n_gaps)

        if is_constraint:
            return ineq_constraint(name, n_gaps, wfn, jac_fn=wjac,
                                   viol_groups=n_gaps, step_coupling=1,
                                   jac_banded_fn=wjac_banded, pre_fn=pre)
        return hinge_cost(name, n_gaps, wfn, weight_fn=wwf, jac_fn=wjac,
                          step_coupling=1, jac_banded_fn=wjac_banded,
                          pre_fn=pre)

    if is_constraint:
        def cfn(x, p, aux=None):
            return fn(x, p, aux) * _row_coeffs(p, x.dtype)
        return ineq_constraint(
            name, n, cfn,
            jac_fn=lambda x, p, aux=None: jac_fn(x, p, aux, cf=True),
            viol_groups=n_gaps,  # one reference constraint per step gap
            step_coupling=1,
            jac_banded_fn=lambda x, p, aux=None: jac_banded_fn(
                x, p, aux, cf=True),
            pre_fn=pre)
    return hinge_cost(name, n, fn, weight_fn=lambda p: _row_coeffs(
        p, p["coeffs"].dtype), jac_fn=jac_fn, step_coupling=1,
        jac_banded_fn=jac_banded_fn, pre_fn=pre)


def cast_sweep_distances(world: CollisionWorld, X: torch.Tensor,
                         n_sub: int = 16, kernels: bool = True):
    """(B, T - 1, n_pairs) swept distances of every step gap of the
    trajectories X (B, T, n_dof) at ``n_sub`` substates: K5 on a CUDA
    tensor, the plain ``cast_pair_distances`` otherwise."""
    if X.is_cuda and kernels:
        B, T, nd = X.shape
        return _cast_launch("cast_sweep", world,
                            X.reshape(B, T * nd).contiguous(), T, nd, 0,
                            T - 1, n_sub)[0]
    return world.cast_pair_distances(X[:, :-1], X[:, 1:], n_sub)


def trajectory_in_collision(world: CollisionWorld, X: torch.Tensor,
                            margin: float = 0.0, n_sub: int = 16,
                            pair_mask=None):
    """Independent swept check of final trajectories X (B, T, n_dof):
    returns each lane's minimum swept distance over all gaps and pairs
    (>= margin means collision-free).  ``pair_mask`` (n_pairs,) restricts
    the check to a pair subset."""
    d = cast_sweep_distances(world, X, n_sub)
    if pair_mask is not None:
        keep = torch.as_tensor(pair_mask, dtype=torch.bool, device=d.device)
        d = torch.where(keep, d, torch.full_like(d, float("inf")))
    return torch.amin(d, dim=(1, 2))
