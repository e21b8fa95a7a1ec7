"""Carry the JAX reference's numbers across to the port.

The JAX package's containers are read by attribute name only — nothing
here imports ``jax`` or ``trajopt_tpu``.  The tests map a JAX
``ProblemData`` to numpy first (``jax.tree.map(np.asarray, data)``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .collision.world import CollisionWorld, GeomSpec, _make_world
from .kinematics.chain import Chain
from .solver.types import ProblemData
from .utils.lanes import tree_map

_CHAIN_FIELDS = ("link_names", "joint_names", "parent", "off_R", "off_p",
                 "jtype", "axis", "dof_of_link", "link_of_dof", "ancestor",
                 "lb", "ub", "vel")


def _tensors(tree, device, dtype):
    def leaf(a):
        t = torch.as_tensor(np.asarray(a), device=device)
        return t.to(dtype) if t.is_floating_point() else t
    return tree_map(leaf, tree)


def problem_data_from_numpy(tree, device="cuda",
                            dtype=torch.float64) -> ProblemData:
    """A (batched) JAX ``ProblemData`` with numpy leaves -> the port's
    ``ProblemData`` on ``device`` (the card unless ``device="cpu"``),
    floating leaves cast to ``dtype``."""
    device = resolve_device(device)
    return ProblemData(
        x0=_tensors(tree.x0, device, dtype),
        lb=_tensors(tree.lb, device, dtype),
        ub=_tensors(tree.ub, device, dtype),
        cost_params=_tensors(tuple(tree.cost_params), device, dtype),
        cnt_params=_tensors(tuple(tree.cnt_params), device, dtype),
        resume=_tensors(tree.resume, device, dtype),
    )


def chain_from_numpy(chain) -> Chain:
    """A port ``Chain`` from any chain-like object with the JAX ``Chain``'s
    fields (names and numpy arrays)."""
    kw = {}
    for f in _CHAIN_FIELDS:
        v = getattr(chain, f)
        kw[f] = tuple(v) if f in ("link_names", "joint_names") \
            else np.array(v, copy=True)
    return Chain(**kw)


def world_from_numpy(chain: Chain, geoms, pairs) -> CollisionWorld:
    """A port ``CollisionWorld`` from the reference world's static tables:
    ``chain`` (a port ``Chain``, e.g. from :func:`chain_from_numpy`),
    ``geoms`` (one dict per geometry with the ``GeomSpec`` fields link,
    kind, off_R, off_p, radius, half, name, and for a CONVEX geometry its
    padded local vertices ``verts``; ``radius`` is then its sweep radius)
    and ``pairs`` ((gi, gj) in the reference's order).  Groups and sweep
    routes are derived again from these tables."""
    specs = [GeomSpec(link=int(g["link"]), kind=int(g["kind"]),
                      off_R=np.array(g["off_R"], np.float64),
                      off_p=np.array(g["off_p"], np.float64),
                      radius=float(g["radius"]),
                      half=np.array(g["half"], np.float64),
                      name=str(g["name"]),
                      verts=None if g.get("verts") is None
                      else np.array(g["verts"], np.float64))
             for g in geoms]
    return _make_world(chain, specs, [(int(i), int(j)) for i, j in pairs])
