"""PyTorch port vs JAX reference: the banded interior-point QP solver
(ops.ipm_qp, banded path), float64 on the CPU.

Random flagship-shaped subproblems — a joint-velocity quadratic, hinge rows
on step-gap windows, abs rows on per-step windows plus a goal block, a
trust box and a pinned first step — solved lane by lane by the reference
and as one batch by the port.  Status and iteration count must be equal
and dx agree to 1e-8 (both run the same float64 Newton sequence; only sum
orders differ).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu.ops.ipm_qp import solve_ipm_qp as j_solve
from trajopt_tpu.ops.prox_qp import ProxQPData as JData
from trajopt_tpu.ops.qp import QPSettings as JSettings
from trajopt_tpu_torch.ops.banded_rows import step_window
from trajopt_tpu_torch.ops.ipm_qp import solve_ipm_qp as t_solve
from trajopt_tpu_torch.ops.prox_qp import ProxQPData as TData
from trajopt_tpu_torch.ops.qp import QPSettings as TSettings

TOL = 1e-8
B_SZ, NB = 7, 5


def _problem(rng, lanes, with_hinge=True):
    b, nb = B_SZ, NB
    n = b * nb
    S = np.zeros(((nb - 1) * b, n))  # joint-velocity stencil
    for t in range(nb - 1):
        for d in range(b):
            S[t * b + d, t * b + d] = -1.0
            S[t * b + d, (t + 1) * b + d] = 1.0
    P = np.stack([2.0 * S.T @ np.diag(rng.uniform(1, 5, S.shape[0])) @ S
                  for _ in range(lanes)])
    q = rng.normal(size=(lanes, n))
    Bh = (rng.normal(size=(lanes, nb - 1, 3, 2 * b)),) if with_hinge else ()
    Gh = (np.arange(nb - 1, dtype=np.int32),) if with_hinge else ()
    Bstep, Gstep = step_window(torch.as_tensor(rng.normal(size=(lanes, nb, 2, b))),
                               np.arange(nb), nb)
    Ba = (Bstep.numpy(), rng.normal(size=(lanes, 1, b, 2 * b)))
    Ga = (Gstep.numpy(), np.asarray([nb - 2], np.int32))
    mh = sum(B.shape[1] * B.shape[2] for B in Bh)
    ma = sum(B.shape[1] * B.shape[2] for B in Ba)
    lb = -rng.uniform(0.05, 0.3, (lanes, n))
    ub = rng.uniform(0.05, 0.3, (lanes, n))
    pin = rng.uniform(-0.02, 0.02, (lanes, b))
    lb[:, :b] = pin  # pinned first step (fixed timestep)
    ub[:, :b] = pin
    arrays = dict(P=P, q=q, e_h=rng.normal(size=(lanes, mh)),
                  w_h=rng.uniform(1, 20, (lanes, mh)),
                  e_a=rng.normal(size=(lanes, ma)),
                  w_a=rng.uniform(1, 20, (lanes, ma)), lb=lb, ub=ub)
    return arrays, Bh, Gh, Ba, Ga


@pytest.mark.parametrize("with_hinge", [True, False])
@pytest.mark.parametrize("tight", [False, True])
def test_ipm_matches_reference(with_hinge, tight):
    lanes = 4
    rng = np.random.default_rng(7 + 2 * tight + with_hinge)
    arrays, Bh, Gh, Ba, Ga = _problem(rng, lanes, with_hinge)
    kw = dict(eps_abs=1e-8, eps_rel=1e-10, max_ipm_iter=40) if tight \
        else dict(eps_abs=1e-4, eps_rel=1e-6, max_ipm_iter=16)
    kw.update(solver="ipm", kkt_block=B_SZ)

    tdata = TData(**{k: torch.as_tensor(v) for k, v in arrays.items()},
                  A_h=None, A_a=None,
                  Bh=tuple(torch.as_tensor(B) for B in Bh),
                  Gh=tuple(torch.as_tensor(G) for G in Gh),
                  Ba=tuple(torch.as_tensor(B) for B in Ba),
                  Ga=tuple(torch.as_tensor(np.array(G)) for G in Ga))
    sol = t_solve(tdata, TSettings(**kw), device="cpu")
    for z in range(lanes):
        jd = JData(**{k: jnp.asarray(v[z]) for k, v in arrays.items()},
                   A_h=None, A_a=None,
                   Bh=tuple(jnp.asarray(B[z]) for B in Bh),
                   Gh=tuple(jnp.asarray(G) for G in Gh),
                   Ba=tuple(jnp.asarray(B[z]) for B in Ba),
                   Ga=tuple(jnp.asarray(G) for G in Ga))
        ref = j_solve(jd, JSettings(**kw))
        assert int(sol.status[z]) == int(ref.status), z
        assert int(sol.iters[z]) == int(ref.iters), z
        np.testing.assert_allclose(sol.x[z].numpy(), np.asarray(ref.x),
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(sol.u[z].numpy(), np.asarray(ref.u),
                                   rtol=0, atol=TOL)
        # the pinned step comes back exact
        np.testing.assert_array_equal(sol.x[z, :B_SZ].numpy(),
                                      arrays["lb"][z, :B_SZ])
    assert (sol.status >= 1).all()
