"""Trajectory problem construction (``trajopt_tpu/problem/trajectory.py``).

The decision vector is the flattened (n_steps, n_cols) joint grid.  A
:class:`TrajProblemBuilder` accumulates terms and their per-instance
parameters, then ``build()`` emits the static :class:`ProblemSpec` plus one
instance's :class:`ProblemData` (tensors on the builder's device, no lane
axis); ``stack_data`` stacks instances along a leading lane axis, which is
the form the solver takes.

Fixed timesteps / fixed dofs are enforced with equal lower/upper variable
bounds.  Construction runs in numpy on the host; tensors are made once at
the end.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..kinematics.chain import Chain
from ..solver.types import ProblemData, ProblemSpec
from ..terms.base import Term
from ..utils.lanes import tree_map


def stationary_init(q0, n_steps: int) -> np.ndarray:
    """Every step at q0 (numpy, host side)."""
    return np.tile(np.asarray(q0)[None, :], (n_steps, 1))


def interpolated_init(q0, q1, n_steps: int) -> np.ndarray:
    a = np.linspace(0.0, 1.0, n_steps)[:, None]
    return (1 - a) * np.asarray(q0)[None, :] + a * np.asarray(q1)[None, :]


@dataclasses.dataclass
class TrajProblemBuilder:
    """Accumulates terms + params for one problem class."""

    chain: Chain
    n_steps: int
    # time parameterization: adds a 1/dt column (reference use_time,
    # problem_description.cpp:553-592); bounds are [1/dt_upper, 1/dt_lower]
    use_time: bool = False
    dt_lower: float = 1e-3
    dt_upper: float = 1.0
    device: Any = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._cost_terms: list[Term] = []
        self._cost_params: list[Any] = []
        self._cnt_terms: list[Term] = []
        self._cnt_params: list[Any] = []
        self._fixed_steps: list[int] = []
        self._fixed_dofs: list[int] = []

    @property
    def n_dof(self) -> int:
        return self.chain.n_dof

    @property
    def n_cols(self) -> int:
        return self.n_dof + (1 if self.use_time else 0)

    @property
    def n_x(self) -> int:
        return self.n_steps * self.n_cols

    def add_cost(self, term: Term, params: Any = ()):
        self._cost_terms.append(term)
        self._cost_params.append(params)
        return self

    def add_constraint(self, term: Term, params: Any = ()):
        self._cnt_terms.append(term)
        self._cnt_params.append(params)
        return self

    def fix_timestep(self, step: int):
        """Pin an entire step to its initial value (fixed_timesteps)."""
        self._fixed_steps.append(step)
        return self

    def fix_dof(self, dof: int):
        """Pin one dof across all steps (fixed_dofs)."""
        self._fixed_dofs.append(dof)
        return self

    def build(self, init_traj, init_dt: float = 0.1):
        """Returns (spec, data) for the given (n_steps, n_dof) init traj;
        data is one instance (no lane axis) on the builder's device."""
        T, D = self.n_steps, self.n_cols
        init = np.asarray(init_traj)
        dt = init.dtype if init.dtype in (np.float32, np.float64) else np.float64
        init = init.astype(dt)
        if self.use_time and init.shape[-1] == self.n_dof:
            col = np.full((T, 1), 1.0 / init_dt, dt)
            init = np.concatenate([init.reshape(T, self.n_dof), col], axis=1)
        init = init.reshape(T, D)
        lb = np.tile(np.asarray(self.chain.lb, dt)[None, :], (T, 1))
        ub = np.tile(np.asarray(self.chain.ub, dt)[None, :], (T, 1))
        if self.use_time:
            lb = np.concatenate(
                [lb, np.full((T, 1), 1.0 / self.dt_upper, dt)], axis=1)
            ub = np.concatenate(
                [ub, np.full((T, 1), 1.0 / self.dt_lower, dt)], axis=1)
        for s in self._fixed_steps:
            lb[s] = init[s]
            ub[s] = init[s]
        for d in self._fixed_dofs:
            lb[:, d] = init[:, d]
            ub[:, d] = init[:, d]
        spec = ProblemSpec(
            n_x=T * D,
            cost_terms=tuple(self._cost_terms),
            cnt_terms=tuple(self._cnt_terms),
            n_steps=T,
            n_cols=D,
        )
        data = ProblemData(
            x0=init.reshape(-1),
            lb=lb.reshape(-1),
            ub=ub.reshape(-1),
            cost_params=tuple(self._cost_params),
            cnt_params=tuple(self._cnt_params),
        )
        return spec, tree_map(
            lambda a: torch.as_tensor(a if torch.is_tensor(a) else np.asarray(a),
                                      device=self.device), data)


def stack_data(datas: Sequence[ProblemData]) -> ProblemData:
    """Stack per-instance ProblemData along a new leading lane axis."""
    return tree_map(lambda *xs: torch.stack([torch.as_tensor(x) for x in xs]),
                    *datas)
