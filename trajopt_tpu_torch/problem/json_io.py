"""Reference-schema-compatible JSON problem documents
(``trajopt_tpu/problem/json_io.py``).

Parses the de-facto public TrajOpt problem format
(``ProblemConstructionInfo::fromJson``,
trajopt/src/problem_description.cpp:118-308 and the term registry
:53-66) into a (spec, data, SQPParams) triple:

  {"basic_info":  {"n_steps", "manip", "fixed_timesteps", "use_time", ...},
   "opt_info":    { 18 SQP knobs ... },
   "costs":       [ {"type", "name", "use_time", "params": {...}}, ... ],
   "constraints": [ ... ],
   "init_info":   {"type": "stationary"|"joint_interpolated"|"given_traj",
                   "data": ..., "endpoint": ..., "dt": ...}}

Supported term types (the full reference registry,
problem_description.cpp:53-66): joint_pos, joint_vel, joint_acc,
joint_jerk, cart_pose, dynamic_cart_pose, cart_vel, collision, total_time.
Unknown fields are rejected (ensure_only_members,
problem_description.cpp:32-51); scalars broadcast to per-dof vectors
(checkParameterSize, :75-89).

Time parameterization: a term-level ``use_time`` flag (accepted as a bool
or a case-insensitive string, matching jsoncpp's lenient parse of the
reference configs) switches the problem to an (n_steps, n_dof+1) grid with
a trailing 1/dt column, exactly as the reference auto-sets
``basic_info.use_time`` when any term uses time
(problem_description.cpp:169-211).  joint_vel with time becomes the
dt-scaled velocity term; joint_pos with time is dt-independent; joint
acc/jerk with time are unimplemented (the reference throws for several
time variants too, problem_description.cpp:931-938).

Term parameters are float64 numpy arrays, as the port's scene builders
make them (the terms cast them to x's dtype); ``load_problem`` returns one
instance's data (no lane axis) as float64 tensors on ``device``, the
trajectory builder's convention: cast them to float32 for a float32
solve.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np
import torch

from ..collision.broadphase import pair_distance_bounds, prune_pairs
from ..collision.world import CollisionWorld
from ..kinematics.chain import Chain
from ..ops.lie import quat_wxyz_to_matrix
from ..ops.qp import CONVEX_SOLVER_NAMES, QPSettings, resolve_solver
from ..solver.types import SQPParams
from ..terms.cartesian import (cart_pose_term, cart_vel_term,
                               default_cart_pose_params)
from ..terms.collision import (CastDistancePre, DiscreteDistancePre,
                               cast_collision_term, discrete_collision_term)
from ..terms.joint import joint_motion_term
from ..terms.time import timed_joint_vel_term, total_time_term
from .trajectory import TrajProblemBuilder, interpolated_init, stationary_init

_JOINT_ORDERS = {"joint_pos": 0, "joint_vel": 1, "joint_acc": 2, "joint_jerk": 3}

_TERM_FIELDS = {"type", "name", "use_time", "params"}

# ---------------------------------------------------------------------------
# User-extensible term registry (TermInfo::RegisterMaker,
# trajopt/src/problem_description.cpp:53-66, decl
# include/trajopt/problem_description.hpp:102-116): ``load_problem``
# consults this map BEFORE the built-in chain, so user types can be added
# at runtime and built-in names can be overridden, exactly like the
# reference's name->maker map.
# ---------------------------------------------------------------------------

_USER_TERM_MAKERS: dict = {}


def register_term_type(name: str, maker) -> None:
    """Register a JSON-loadable term type.

    ``maker(entry, ctx) -> (Term, params)`` receives the raw JSON term
    dict (``{"type", "name", "use_time", "params"}``) and a context dict
    ``{"chain", "world", "n_steps", "n_dof", "n_cols", "use_time",
    "is_constraint", "name"}``; it returns the :class:`~trajopt_tpu_torch.
    terms.base.Term` plus one instance's params (a dict of numpy arrays,
    no lane axis).  The returned term's
    kind must match ``is_constraint`` (cost kinds under ``costs``,
    EQ/INEQ under ``constraints``) — ``load_problem`` validates this like
    ``ConstructProblem``'s term-type check (problem_description.cpp:
    416-452)."""
    if not callable(maker):
        raise TypeError(f"maker for {name!r} must be callable")
    _USER_TERM_MAKERS[name] = maker


def unregister_term_type(name: str) -> None:
    _USER_TERM_MAKERS.pop(name, None)


def _only(params: dict, allowed: set, ctx: str):
    extra = set(params) - allowed
    if extra:
        raise ValueError(f"unknown fields {extra} in {ctx}")


def _bool(v, ctx: str = "") -> bool:
    """Lenient bool: the reference configs carry strings like "tRuE"."""
    if isinstance(v, bool):
        return v
    if isinstance(v, str):
        s = v.strip().lower()
        if s in ("true", "1"):
            return True
        if s in ("false", "0"):
            return False
        raise ValueError(f"bad bool {v!r} in {ctx}")
    return bool(v)


def _vec(v, n, name) -> np.ndarray:
    a = np.atleast_1d(np.asarray(v, dtype=np.float64))
    if a.size == 1:
        a = np.full(n, float(a[0]))
    if a.size != n:
        raise ValueError(f"{name}: expected size {n} or 1, got {a.size}")
    return a


def _quat(wxyz) -> np.ndarray:
    return quat_wxyz_to_matrix(torch.as_tensor(np.asarray(
        wxyz, np.float64))).numpy()


def _opt_params(opt: dict) -> SQPParams:
    _only(opt, {
        "improve_ratio_threshold", "min_trust_box_size", "min_approx_improve",
        "min_approx_improve_frac", "max_iter", "trust_shrink_ratio",
        "trust_expand_ratio", "cnt_tolerance", "max_merit_coeff_increases",
        "merit_coeff_increase_ratio", "max_time", "initial_merit_error_coeff",
        "trust_box_size", "log_results", "log_dir", "num_threads",
        "inflate_constraints_individually", "max_qp_solver_failures",
    }, "opt_info")
    kw = {}
    for k in ("improve_ratio_threshold", "min_trust_box_size",
              "min_approx_improve", "min_approx_improve_frac",
              "trust_shrink_ratio", "trust_expand_ratio", "cnt_tolerance",
              "merit_coeff_increase_ratio", "initial_merit_error_coeff",
              "trust_box_size", "max_time"):
        if k in opt:
            kw[k] = float(opt[k])
    for k in ("max_iter", "max_merit_coeff_increases", "max_qp_solver_failures"):
        if k in opt:
            kw[k] = int(opt[k])
    if "inflate_constraints_individually" in opt:
        kw["inflate_constraints_individually"] = bool(
            opt["inflate_constraints_individually"])
    return SQPParams(**kw)


def load_problem(doc: dict | str, chain: Chain,
                 world: Optional[CollisionWorld] = None,
                 qp: Optional[QPSettings] = None,
                 n_sub: int = 8, n_sub_cap: int = 64,
                 max_contacts: Optional[int] = 32,
                 cull: bool = True, device="cuda"):
    """Build (spec, data, params) from a reference-format JSON document.

    ``n_sub`` floors and ``n_sub_cap`` caps the swept-collision substate
    count derived from longest_valid_segment_length (static shapes need a
    per-problem bound; lower the cap to trade LVS fidelity for compute).

    Contact reduction (the analog of the reference's broad phase +
    contact-window pipeline, see terms.collision._topk_rows and
    collision.broadphase):

    * ``max_contacts`` caps QP rows per step/gap at the K worst contacts
      (None = one row per pair per (sub)segment, the exact lowering);
    * ``cull=True`` statically drops candidate pairs that provably stay
      outside margin + safety_margin_buffer over the whole joint box.

    The data's tensors (float64, no lane axis) are made on ``device``
    (default the card; ``"cpu"`` has to be asked for).
    """
    if isinstance(doc, str):
        doc = json.loads(doc)

    basic = dict(doc.get("basic_info", {}))
    # NOTE: "start_fixed" is deliberately NOT accepted: the reference removed
    # it from the JSON schema in favor of fixed_timesteps (readBasicInfo,
    # problem_description.cpp:122-123; CHANGELOG "Changed dofs_fixed name to
    # fixed_timesteps"), and its ensure_only_members would reject it too.
    _only(basic, {"n_steps", "manip", "fixed_timesteps", "fixed_dofs",
                  "use_time", "dt_lower_lim", "dt_upper_lim",
                  "convex_solver"}, "basic_info")
    T = int(basic["n_steps"])
    D = chain.n_dof

    all_entries = list(doc.get("costs", [])) + list(doc.get("constraints", []))
    for e in all_entries:
        _only(e, _TERM_FIELDS, e.get("type", "term"))
    # any term using time flips the whole problem to the 1/dt grid
    # (problem_description.cpp:169-211 auto-sets basic_info.use_time)
    use_time = _bool(basic.get("use_time", False), "basic_info.use_time") or \
        any(_bool(e.get("use_time", False), e.get("type", "?"))
            for e in all_entries)

    b = TrajProblemBuilder(
        chain, T, use_time=use_time,
        dt_lower=float(basic.get("dt_lower_lim", 1e-3)),
        dt_upper=float(basic.get("dt_upper_lim", 1.0)), device=device)
    NC = D + (1 if use_time else 0)

    for s in basic.get("fixed_timesteps", []):
        b.fix_timestep(int(s))
    for d in basic.get("fixed_dofs", []):
        b.fix_dof(int(d))

    # init trajectory parsed BEFORE terms: LVS collision terms derive their
    # static substate count from the init motion (see the collision branch)
    init = doc.get("init_info", {"type": "stationary"})
    # strict unknown-field rejection (ensure_only_members,
    # problem_description.cpp:32-51) — typos must not silently no-op
    _only(init, {"type", "data", "endpoint", "dt"}, "init_info")
    itype = init.get("type", "stationary")
    init_dt = float(init.get("dt", 0.1))
    if itype == "given_traj":
        X0 = np.asarray(init["data"], dtype=np.float64)
        if X0.shape not in ((T, D), (T, NC)):
            raise ValueError(f"init data shape {X0.shape} != {(T, D)}")
    elif itype == "joint_interpolated":
        q0 = np.zeros(D) if "data" not in init else np.asarray(
            init["data"], dtype=np.float64)
        X0 = interpolated_init(q0, np.asarray(init["endpoint"],
                                              dtype=np.float64), T)
    else:  # stationary
        q0 = np.zeros(D) if "data" not in init else np.asarray(
            init["data"], dtype=np.float64)
        X0 = stationary_init(q0, T)
    # largest joint-space step motion of the init trajectory (for LVS)
    X0np = np.asarray(X0, dtype=np.float64)[:, :D]
    max_step_dist = float(np.max(np.linalg.norm(np.diff(X0np, axis=0),
                                                axis=1))) if T > 1 else 0.0

    # shared-precompute caches: collision cost + constraint entries over
    # the same (world, steps, substates) get ONE distance pipeline (the
    # reference's contact-result cache, collision_terms.cpp:440-466); the
    # pruned-world cache makes identically-culled terms share a world
    # object so the pre cache can hit
    pre_cache: dict = {}
    prune_cache: dict = {}
    bounds: dict = {}

    def add_term(entry: dict, is_constraint: bool, idx: int):
        ttype = entry["type"]
        name = entry.get("name", f"{ttype}_{idx}")
        term_time = _bool(entry.get("use_time", False), ttype)
        params = dict(entry.get("params", {}))

        if ttype in _USER_TERM_MAKERS:  # registry first (RegisterMaker)
            ctx = {"chain": chain, "world": world, "n_steps": T,
                   "n_dof": D, "n_cols": NC, "use_time": term_time,
                   "is_constraint": is_constraint, "name": name}
            term, p = _USER_TERM_MAKERS[ttype](entry, ctx)
            if term.is_cost == is_constraint:
                section = "constraints" if is_constraint else "costs"
                raise ValueError(
                    f"registered term {ttype!r} produced a "
                    f"{'cost' if term.is_cost else 'constraint'} under "
                    f"{section!r} (term-type check, "
                    "problem_description.cpp:416-452)")
            return term, p

        if ttype in _JOINT_ORDERS:
            order = _JOINT_ORDERS[ttype]
            _only(params, {"coeffs", "targets", "upper_tols", "lower_tols",
                           "first_step", "last_step"}, ttype)
            first = int(params.get("first_step", 0))
            last = int(params.get("last_step", T - 1))
            up = _vec(params.get("upper_tols", 0.0), D, "upper_tols")
            lo = _vec(params.get("lower_tols", 0.0), D, "lower_tols")
            toleranced = bool(np.any(up != 0.0) or np.any(lo != 0.0))
            if term_time and order == 1:
                term = timed_joint_vel_term(
                    name, T, D, first_step=first, last_step=last,
                    is_constraint=is_constraint, toleranced=toleranced)
            elif term_time and order >= 2:
                raise NotImplementedError(
                    f"{ttype} with use_time is not implemented "
                    "(reference leaves several time variants unimplemented, "
                    "problem_description.cpp:931-938)")
            else:
                # joint_pos (dt-independent) or untimed term on a timed grid
                term = joint_motion_term(name, order, T, D, first_step=first,
                                         last_step=last,
                                         is_constraint=is_constraint,
                                         toleranced=toleranced, n_cols=NC)
            p = {"targets": _vec(params.get("targets", 0.0), D, "targets"),
                 "coeffs": _vec(params.get("coeffs", 1.0), D, "coeffs")}
            if toleranced:
                p["upper_tols"] = up
                p["lower_tols"] = lo
            return term, p

        if ttype in ("cart_pose", "dynamic_cart_pose"):
            _only(params, {"timestep", "source_frame", "target_frame",
                           "source_frame_offset_xyz", "source_frame_offset_wxyz",
                           "target_frame_offset_xyz", "target_frame_offset_wxyz",
                           "pos_coeffs", "rot_coeffs"}, ttype)
            step = int(params.get("timestep", T - 1))
            source = params["source_frame"]
            target = params.get("target_frame")
            # dynamic_cart_pose: the target frame is a moving chain link
            # (DynamicCartPoseTermInfo, kinematic_terms.cpp:98-184).  For
            # plain cart_pose a target that names a movable chain link is
            # treated the same way; a base/world frame name gives a fixed
            # world target.
            target_is_link = ttype == "dynamic_cart_pose" or (
                target in chain.link_names
                and bool(chain.ancestor[chain.link_index(target)].any()))
            toff_p = np.asarray(params.get("target_frame_offset_xyz",
                                           [0, 0, 0]), np.float64)
            toff_R = _quat(params.get("target_frame_offset_wxyz",
                                      [1, 0, 0, 0]))
            soff_p = np.asarray(params.get("source_frame_offset_xyz",
                                           [0, 0, 0]), np.float64)
            soff_R = _quat(params.get("source_frame_offset_wxyz",
                                      [1, 0, 0, 0]))
            term = cart_pose_term(
                name, chain, T, step, source,
                target_link=target if target_is_link else None,
                is_constraint=is_constraint, kind="abs", n_cols=NC)
            p = default_cart_pose_params(
                target_R=toff_R, target_p=toff_p,
                pos_coeffs=_vec(params.get("pos_coeffs", 1.0), 3,
                                "pos_coeffs"),
                rot_coeffs=_vec(params.get("rot_coeffs", 1.0), 3,
                                "rot_coeffs"),
                source_off_R=soff_R, source_off_p=soff_p)
            return term, p

        if ttype == "cart_vel":
            _only(params, {"first_step", "last_step", "max_displacement",
                           "link"}, ttype)
            term = cart_vel_term(
                name, chain, T, params["link"],
                first_step=int(params.get("first_step", 0)),
                last_step=int(params.get("last_step", T - 1)),
                is_constraint=is_constraint, n_cols=NC)
            return term, {"max_displacement":
                          np.asarray(float(params["max_displacement"]))}

        if ttype == "total_time":
            if not use_time:
                raise ValueError("total_time requires a use_time problem")
            _only(params, {"coeff", "limit"}, ttype)
            term = total_time_term(name, T, D, is_constraint=is_constraint)
            return term, {"limit": np.asarray(float(params.get("limit", 1.0))),
                          "coeff": np.asarray(float(params.get("coeff", 1.0)))}

        if ttype == "collision":
            if world is None:
                raise ValueError("collision term requires a CollisionWorld")
            _only(params, {"coeffs", "dist_pen", "evaluator_type",
                           "fixed_steps", "first_step", "last_step",
                           "longest_valid_segment_length", "use_weighted_sum",
                           "contact_test_type", "pair_coeffs", "pair_margins",
                           "pairs", "safety_margin_buffer", "max_num_cnt"},
                  ttype)
            ev = int(params.get("evaluator_type", 1))
            first = int(params.get("first_step", 0))
            last = int(params.get("last_step", T - 1))
            coeffs = float(np.atleast_1d(params.get("coeffs", 20.0))[0])
            # reference configs write dist_pen as a one-element list
            margin = float(np.atleast_1d(params.get("dist_pen", 0.025))[0])
            weighted = _bool(params.get("use_weighted_sum", False),
                             f"{ttype}.use_weighted_sum")
            # contact window: contacts farther than margin + buffer are
            # invisible to the optimizer (CollisionTermInfo::fromJson
            # "safety_margin_buffer" default 0.5,
            # problem_description.cpp:1630)
            buffer = float(params.get("safety_margin_buffer", 0.5))
            # per-contact row cap: "max_num_cnt" (collision_types.h:162)
            # overrides the load_problem-level default
            mc = params.get("max_num_cnt", max_contacts)
            mc = None if mc is None else int(mc)
            # per-link-pair overrides (CollisionCoeffData default +
            # per-pair values, collision_types.h:124-163); the reference's
            # "pairs" list format ({"link": .., "pair": [..], "coeffs": ..,
            # "dist_pen": ..}, problem_description.cpp:1668-1701) is
            # translated to the dict form
            pair_margins = dict(params.get("pair_margins") or {})
            pair_coeffs = dict(params.get("pair_coeffs") or {})
            for ent in params.get("pairs", []):
                _only(ent, {"link", "pair", "coeffs", "dist_pen"},
                      f"{ttype}.pairs")
                for other in ent["pair"]:
                    key = f"{ent['link']},{other}"
                    if "dist_pen" in ent:
                        pair_margins[key] = float(
                            np.atleast_1d(ent["dist_pen"])[0])
                    if "coeffs" in ent:
                        pair_coeffs[key] = float(
                            np.atleast_1d(ent["coeffs"])[0])
            # typo rejection happens against the FULL world; culled pairs
            # may then legitimately disappear from the override sets
            world.pair_value_array(margin, pair_margins or None)
            world.pair_value_array(coeffs, pair_coeffs or None)
            cw = world
            if cull:
                cull_dist = (max([margin] + list(pair_margins.values()))
                             + buffer)
                # keyed by the pairs kept: entries whose cull distances
                # keep the same pairs share one pruned world, and so one
                # distance pipeline (the JAX package keys by the distance)
                if id(world) not in bounds:
                    bounds[id(world)] = pair_distance_bounds(world)
                ck = (id(world),
                      tuple(np.flatnonzero(bounds[id(world)] <= cull_dist)))
                if ck not in prune_cache:
                    prune_cache[ck] = prune_pairs(world, cull_dist)
                cw = prune_cache[ck]
                known = {tuple(sorted(nm)) for nm in cw.pair_link_names()}

                def _subset(ov):
                    return {k: v for k, v in ov.items()
                            if tuple(sorted(k.split(",") if isinstance(k, str)
                                            else k)) in known}
                pair_margins = _subset(pair_margins)
                pair_coeffs = _subset(pair_coeffs)
            margins_arr = cw.pair_value_array(
                margin, pair_margins or None)
            coeffs_arr = cw.pair_value_array(
                coeffs, pair_coeffs or None)
            if weighted and (params.get("pair_coeffs")
                             or params.get("pair_margins")):
                raise ValueError(
                    f"{ttype}: use_weighted_sum aggregates pairs into one "
                    "row per step; per-pair overrides cannot apply")
            pair_p = {"margins": margins_arr, "coeffs": coeffs_arr}
            # "fixed_steps" marks steps whose variables are pinned
            # (collision contacts on those ends are filtered in the
            # reference, collision_terms.cpp:558-600).  Here fixed steps are
            # enforced by equal variable bounds, so their step gradients are
            # inert in the QP — the field is accepted and needs no action.
            if ev <= 1 or T == 1:  # DISCRETE (or single step)
                pk = ("disc", id(cw), T, first, last, NC)
                if pk not in pre_cache:
                    pre_cache[pk] = DiscreteDistancePre(
                        cw, T, first_step=first, last_step=last, n_cols=NC)
                term = discrete_collision_term(
                    name, cw, T, first_step=first, last_step=last,
                    is_constraint=is_constraint, n_cols=NC,
                    weighted=weighted, max_contacts=mc, buffer=buffer,
                    pre=pre_cache[pk])
            else:  # LVS_DISCRETE / CONTINUOUS / LVS_CONTINUOUS -> swept
                # longest_valid_segment_length sets the substate count:
                # the reference interpolates ceil(dist/lvs)+1 substates per
                # gap (continuous_collision_evaluators.cpp:205-240); static
                # shapes need one per-problem bound, so size it from the
                # init trajectory's largest step motion (callers can widen
                # via the n_sub argument, which acts as a floor)
                lvs = params.get("longest_valid_segment_length")
                n_sub_t = n_sub
                if lvs is not None:
                    n_sub_t = max(n_sub,
                                  min(int(np.ceil(max_step_dist / float(lvs)))
                                      + 1, n_sub_cap))
                pk = ("cast", id(cw), T, first, last, n_sub_t, NC)
                if pk not in pre_cache:
                    pre_cache[pk] = CastDistancePre(
                        cw, T, first_step=first, last_step=last,
                        n_sub=n_sub_t, n_cols=NC)
                term = cast_collision_term(
                    name, cw, T, first_step=first, last_step=last,
                    n_sub=n_sub_t, is_constraint=is_constraint, n_cols=NC,
                    weighted=weighted, max_contacts=mc, buffer=buffer,
                    pre=pre_cache[pk])
            return term, pair_p

        raise ValueError(f"unsupported term type: {ttype}")

    for i, c in enumerate(doc.get("costs", [])):
        term, p = add_term(c, is_constraint=False, idx=i)
        b.add_cost(term, p)
    for i, c in enumerate(doc.get("constraints", [])):
        term, p = add_term(c, is_constraint=True, idx=i)
        b.add_constraint(term, p)

    spec, data = b.build(X0, init_dt=init_dt)
    params = _opt_params(doc.get("opt_info", {}))
    # backend selection (readBasicInfo "convex_solver",
    # problem_description.cpp:124 -> createModel solver_interface.cpp:
    # 305-325): an explicit config name pins the backend; AUTO keeps the
    # "auto" sentinel so the TRAJOPT_CONVEX_SOLVER env override still
    # applies at solve time.  Unknown or unported names raise at load.
    settings = qp if qp is not None else QPSettings()
    conv = basic.get("convex_solver")
    if conv is not None and settings.solver == "auto":
        mapped = CONVEX_SOLVER_NAMES.get(str(conv).upper())
        if mapped is None:
            resolve_solver(str(conv))  # raises with the supported-name list
        if mapped in ("admm", "ipm"):
            settings = dataclasses.replace(settings, solver=mapped)
    params = SQPParams(**{**params.__dict__, "qp": settings})
    return spec, data, params
