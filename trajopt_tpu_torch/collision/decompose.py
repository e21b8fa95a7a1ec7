"""Convex-hull geometry from a vertex cloud (``trajopt_tpu/collision/
decompose.py``, the numpy part the scenes need).

Ported: ``convex_hull_vertices`` and ``fit_hull``.  The primitive fits,
the k-means split and the mesh loaders are not ported yet.
"""

from __future__ import annotations

import numpy as np

from ..kinematics.urdf import UrdfGeom


def convex_hull_vertices(verts: np.ndarray, max_verts: int = 32) -> np.ndarray:
    """Reduce a vertex cloud to at most ``max_verts`` extreme points: the
    support point along each of a spread of directions (Fibonacci sphere),
    deduplicated; beyond ``max_verts`` the points farthest from their
    centroid are kept."""
    n_dirs = max(max_verts * 4, 64)
    i = np.arange(n_dirs)
    phi = np.pi * (3.0 - np.sqrt(5.0))
    y = 1.0 - 2.0 * (i + 0.5) / n_dirs
    rr = np.sqrt(np.maximum(1.0 - y * y, 0.0))
    dirs = np.stack([np.cos(phi * i) * rr, y, np.sin(phi * i) * rr], axis=1)
    idx = np.unique(np.argmax(verts @ dirs.T, axis=0))
    if len(idx) > max_verts:
        c = verts[idx].mean(axis=0)
        d = np.linalg.norm(verts[idx] - c, axis=1)
        idx = idx[np.argsort(d)[::-1][:max_verts]]
    return verts[idx]


def fit_hull(verts: np.ndarray, max_verts: int = 32,
             sweep_radius: float = 0.0) -> UrdfGeom:
    """A convex-hull geometry (kind "convex", ``size[0]`` its sweep
    radius) from a vertex cloud."""
    hv = convex_hull_vertices(np.asarray(verts, np.float64), max_verts)
    return UrdfGeom("convex", np.array([sweep_radius]), np.zeros(3),
                    np.zeros(3), verts=hv)
