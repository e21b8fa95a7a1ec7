"""The explicit lane axis that takes the place of ``vmap``.

Every batched tensor of the port carries a leading lane axis.  These
helpers do what ``vmap`` and ``jax.tree`` did for the JAX package: map over
the tensors of a problem-data tree, reduce per lane, select per lane, and
broadcast a per-lane parameter.
"""

from __future__ import annotations

import torch


def tree_map(fn, *trees):
    """Apply ``fn`` leaf-wise over parallel trees of dicts, NamedTuples,
    tuples and lists; ``None`` stays ``None``; anything else is a leaf."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, dict):
        return {k: tree_map(fn, *[t[k] for t in trees]) for k in t0}
    if isinstance(t0, tuple) and hasattr(t0, "_fields"):
        return type(t0)(*[tree_map(fn, *f) for f in zip(*trees)])
    if isinstance(t0, (tuple, list)):
        return type(t0)(tree_map(fn, *f) for f in zip(*trees))
    return fn(*trees)


def lane_select(mask: torch.Tensor, new: torch.Tensor,
                old: torch.Tensor) -> torch.Tensor:
    """Per lane: ``new`` where ``mask`` (lanes,) holds, else ``old`` —
    bitwise, so a NaN in a lane that is not taken never spreads."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)),
                       new, old)


def lane_max(v: torch.Tensor, initial: float) -> torch.Tensor:
    """Per-lane ``jnp.max(v, initial=...)`` over the last axis; accepts an
    empty axis (``torch.amax`` does not)."""
    init = torch.full(v.shape[:1], initial, dtype=v.dtype, device=v.device)
    if v.shape[-1] == 0:
        return init
    return torch.maximum(torch.amax(v, dim=-1), init)


def lane_min(v: torch.Tensor, initial: float) -> torch.Tensor:
    """Per-lane ``jnp.min(v, initial=...)`` over the last axis."""
    init = torch.full(v.shape[:1], initial, dtype=v.dtype, device=v.device)
    if v.shape[-1] == 0:
        return init
    return torch.minimum(torch.amin(v, dim=-1), init)


def lane_broadcast(v: torch.Tensor, shape: tuple) -> torch.Tensor:
    """Broadcast a per-lane parameter ``(B, *s)`` to ``(B, *shape)``,
    aligning ``s`` to the right of ``shape`` (numpy's rule, applied per
    lane as ``vmap`` did)."""
    extra = len(shape) - (v.dim() - 1)
    v = v.reshape((v.shape[0],) + (1,) * extra + tuple(v.shape[1:]))
    return v.expand((v.shape[0],) + tuple(shape))
