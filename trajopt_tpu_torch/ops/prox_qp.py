"""The composite-form SQP subproblem container
(``trajopt_tpu/ops/prox_qp.py:50-67``).

  min 0.5 dx'P dx + q'dx + sum w_h max(0, A_h dx + e_h)
                         + sum w_a |A_a dx + e_a|     s.t. lb <= dx <= ub

Every tensor carries a leading lane axis.  The reference's proximal solver
(``solve_prox_qp``) is used only by the JAX package's tests and is not
ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class ProxQPData(NamedTuple):
    P: torch.Tensor  # (B, n, n)
    q: torch.Tensor  # (B, n)
    A_h: Optional[torch.Tensor]  # (B, m_h, n) hinge rows; None when banded
    e_h: torch.Tensor  # (B, m_h)
    w_h: torch.Tensor  # (B, m_h) hinge weights (>= 0)
    A_a: Optional[torch.Tensor]  # (B, m_a, n) abs rows; None when banded
    e_a: torch.Tensor  # (B, m_a)
    w_a: torch.Tensor  # (B, m_a)
    lb: torch.Tensor  # (B, n)
    ub: torch.Tensor  # (B, n)
    # banded row windows (ops.banded_rows group format) — set with
    # A_h/A_a = None
    Bh: tuple = ()  # tuple of (B, n_g, r, 2b) window blocks
    Gh: tuple = ()  # tuple of (n_g,) int32 window start blocks (all lanes)
    Ba: tuple = ()
    Ga: tuple = ()
