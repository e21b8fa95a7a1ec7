"""Term system: costs and constraints as torch functions over lanes
(``trajopt_tpu/terms/base.py:84-209``).

A term's functions take ``x`` of shape ``(B, n_x)`` — one row per lane —
and ``params``, a dict whose tensors carry the same leading lane axis; they
return ``(B, n_rows)`` error rows.  Kinds and their exact values:

- ``SQUARED``   cost  = sum_i w_i * err_i^2
- ``ABS``       cost  = sum_i w_i * |err_i|
- ``HINGE``     cost  = sum_i w_i * max(0, err_i)
- ``GENERIC``   scalar cost (not ported yet)
- ``EQ``        constraint rows err_i = 0;   violation = sum_i |err_i|
- ``INEQ``      constraint rows err_i <= 0;  violation = sum_i max(0, err_i)

A term without ``jac_fn`` is linearized by autodiff, as in the JAX
package: ``torch.func.jacfwd`` over x under ``torch.func.vmap`` over lanes.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Optional

import torch

from ..utils.lanes import tree_map


class TermKind(enum.IntEnum):
    SQUARED = 0
    ABS = 1
    HINGE = 2
    GENERIC = 3
    EQ = 4
    INEQ = 5


COST_KINDS = (TermKind.SQUARED, TermKind.ABS, TermKind.HINGE, TermKind.GENERIC)
CNT_KINDS = (TermKind.EQ, TermKind.INEQ)


@dataclasses.dataclass(frozen=True, eq=False)
class Term:
    """Static term specification (hashable by identity).

    ``fn(x, params) -> (B, n_rows)``; ``weight_fn(params)`` per-row cost
    weights ``(B, n_rows)``; ``jac_fn(x, params) -> (B, n_rows, n_x)``
    (may be an expanded view of a constant); ``jac_banded_fn(x, params)``
    returns ``(B (B, n_g, r, w), G (n_g,) int32)`` window blocks in the
    ops.banded_rows format, or a list of such groups.  ``viol_groups``,
    ``step_coupling`` and ``pre_fn`` as in the JAX package.
    """

    name: str
    kind: TermKind
    n_rows: int
    fn: Callable[[torch.Tensor, Any], torch.Tensor]
    weight_fn: Optional[Callable[[Any], torch.Tensor]] = None
    jac_fn: Optional[Callable[[torch.Tensor, Any], torch.Tensor]] = None
    viol_groups: int = 1
    step_coupling: Optional[int] = None
    jac_banded_fn: Optional[Callable[[torch.Tensor, Any], Any]] = None
    pre_fn: Optional[Any] = None

    @property
    def is_cost(self) -> bool:
        return self.kind in COST_KINDS

    def weights(self, params: Any, x: torch.Tensor) -> torch.Tensor:
        """(B, n_rows) cost weights in x's dtype and device."""
        if self.weight_fn is None:
            return torch.ones((x.shape[0], self.n_rows), dtype=x.dtype,
                              device=x.device)
        return self.weight_fn(params).to(x.dtype)

    def err(self, x: torch.Tensor, params: Any, aux: Any = None) -> torch.Tensor:
        e = self.fn(x, params) if self.pre_fn is None \
            else self.fn(x, params, aux)
        if self.kind == TermKind.GENERIC:
            return e.reshape(x.shape[0])
        return e.reshape(x.shape[0], self.n_rows)

    def jac(self, x: torch.Tensor, params: Any, aux: Any = None) -> torch.Tensor:
        """Linearization (B, n_rows, n_x): ``jac_fn``, else forward-mode
        autodiff of ``err`` per lane (as the JAX package, without ``aux``)."""
        if self.jac_fn is None:
            def lane(a, keep):
                return a if keep is None else a[None]

            dims = tree_map(lambda a: 0 if torch.is_tensor(a) else None,
                            params)

            def one(xx, pp):
                return self.err(xx[None], tree_map(lane, pp, dims))[0]
            return torch.func.vmap(torch.func.jacfwd(one),
                                   in_dims=(0, dims))(x, params)
        j = self.jac_fn(x, params) if self.pre_fn is None \
            else self.jac_fn(x, params, aux)
        return j.reshape(x.shape[0], self.n_rows, x.shape[1])

    def jac_banded(self, x: torch.Tensor, params: Any, aux: Any = None):
        """Banded-window linearization (see jac_banded_fn); None if the
        term has no banded form."""
        if self.jac_banded_fn is None:
            return None
        if self.pre_fn is None:
            return self.jac_banded_fn(x, params)
        return self.jac_banded_fn(x, params, aux)

    def value(self, x: torch.Tensor, params: Any, aux: Any = None) -> torch.Tensor:
        """Exact cost value per lane, (B,)."""
        if self.kind == TermKind.GENERIC:
            return self.err(x, params, aux)
        e = self.err(x, params, aux)
        w = self.weights(params, x)
        if self.kind == TermKind.SQUARED:
            return torch.sum(w * e * e, dim=-1)
        if self.kind == TermKind.ABS:
            return torch.sum(w * torch.abs(e), dim=-1)
        if self.kind == TermKind.HINGE:
            return torch.sum(w * torch.clamp(e, min=0.0), dim=-1)
        raise ValueError(f"value() on constraint term {self.name}")

    def violation(self, x: torch.Tensor, params: Any, aux: Any = None) -> torch.Tensor:
        """Total exact violation per lane, (B,)."""
        return torch.sum(self.violations(x, params, aux), dim=-1)

    def violations(self, x: torch.Tensor, params: Any,
                   aux: Any = None) -> torch.Tensor:
        """Per-group violations, (B, viol_groups)."""
        e = self.err(x, params, aux)
        if self.kind == TermKind.EQ:
            v = torch.abs(e)
        elif self.kind == TermKind.INEQ:
            v = torch.clamp(e, min=0.0)
        else:
            raise ValueError(f"violation() on cost term {self.name}")
        return torch.sum(v.reshape(x.shape[0], self.viol_groups, -1), dim=-1)


class KernelChoice:
    """A ``pre_fn`` that precomputes nothing: it hands the SQP's
    ``kernels`` choice to a term whose own functions launch a kernel
    (``cart_pose_term``: K9, ``ik_term``: K8).  ``fn`` receives it as
    ``aux`` (``None`` from a direct caller: the kernel on a CUDA tensor),
    ``jac_fn`` as ``aux[1]``."""

    def value(self, x, kernels: bool = True):
        return kernels

    def value_jac(self, x, kernels: bool = True):
        return kernels, kernels


def kernels_of(aux) -> bool:
    """The ``kernels`` choice a :class:`KernelChoice` handed a term's
    function (``aux``: None, a bool, or value_jac's pair)."""
    if aux is None:
        return True
    return bool(aux[1]) if isinstance(aux, tuple) else bool(aux)


def squared_cost(name, n_rows, fn, weight_fn=None, jac_fn=None,
                 step_coupling=None, jac_banded_fn=None, pre_fn=None) -> Term:
    return Term(name, TermKind.SQUARED, n_rows, fn, weight_fn, jac_fn,
                step_coupling=step_coupling, jac_banded_fn=jac_banded_fn,
                pre_fn=pre_fn)


def abs_cost(name, n_rows, fn, weight_fn=None, jac_fn=None,
             step_coupling=None, jac_banded_fn=None, pre_fn=None) -> Term:
    return Term(name, TermKind.ABS, n_rows, fn, weight_fn, jac_fn,
                step_coupling=step_coupling, jac_banded_fn=jac_banded_fn,
                pre_fn=pre_fn)


def hinge_cost(name, n_rows, fn, weight_fn=None, jac_fn=None,
               step_coupling=None, jac_banded_fn=None, pre_fn=None) -> Term:
    return Term(name, TermKind.HINGE, n_rows, fn, weight_fn, jac_fn,
                step_coupling=step_coupling, jac_banded_fn=jac_banded_fn,
                pre_fn=pre_fn)


def generic_cost(name, fn) -> Term:
    # GENERIC terms carry a dense PSD-projected Hessian — never bandable
    return Term(name, TermKind.GENERIC, 1, fn)


def eq_constraint(name, n_rows, fn, jac_fn=None, viol_groups=1,
                  step_coupling=None, jac_banded_fn=None, pre_fn=None) -> Term:
    return Term(name, TermKind.EQ, n_rows, fn, None, jac_fn, viol_groups,
                step_coupling=step_coupling, jac_banded_fn=jac_banded_fn,
                pre_fn=pre_fn)


def ineq_constraint(name, n_rows, fn, jac_fn=None, viol_groups=1,
                    step_coupling=None, jac_banded_fn=None, pre_fn=None) -> Term:
    return Term(name, TermKind.INEQ, n_rows, fn, None, jac_fn, viol_groups,
                step_coupling=step_coupling, jac_banded_fn=jac_banded_fn,
                pre_fn=pre_fn)

