"""PyTorch port vs JAX reference: banded-row algebra (ops.banded_rows) and
the block-tridiagonal Cholesky (ops.btridiag), float64 on the CPU.

Tolerance 1e-10 relative (scaled by the largest reference entry): the
port sums the block products in another order than the reference's
scatter-adds and unrolled scalar chains.

The CUDA kernels (K1 bb_quad, K2 btd_factor, K3 btd_solve) have no CPU
build: ``chip_smoke.py`` holds them against these plain versions on the
card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu.ops import banded_rows as jbr
from trajopt_tpu.ops import btridiag as jbt
from trajopt_tpu_torch.ops import banded_rows as tbr
from trajopt_tpu_torch.ops import btridiag as tbt
from trajopt_tpu_torch.ops import ipm_qp as tipm
from trajopt_tpu_torch.ops.prox_qp import ProxQPData
from trajopt_tpu_torch.ops.qp import QPSettings

RTOL = 1e-10


def _close(got, ref):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    scale = max(float(np.max(np.abs(ref))) if ref.size else 0.0, 1.0)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * scale)


def _groups(rng, lanes, nb, b):
    """Row groups like the flagship's: gap windows, per-step windows
    (last step in window nb-2) and a one-group goal block."""
    steps = np.arange(nb)
    Js = rng.normal(size=(lanes, nb, 2, b))
    Bs_np = [rng.normal(size=(lanes, nb - 1, 3, 2 * b)),
             None,
             rng.normal(size=(lanes, 1, b, 2 * b))]
    Gs_np = [np.arange(nb - 1, dtype=np.int32), None,
             np.asarray([nb - 2], np.int32)]
    Bw, Gw = jbr.step_window(jnp.asarray(Js[0]), steps, nb)
    Bs_np[1] = np.stack([np.asarray(jbr.step_window(jnp.asarray(Js[z]),
                                                    steps, nb)[0])
                         for z in range(lanes)])
    Gs_np[1] = np.asarray(Gw)
    Bt, Gt = tbr.step_window(torch.as_tensor(Js), steps, nb)
    _close(Bt, Bs_np[1])
    np.testing.assert_array_equal(Gt.numpy(), Gs_np[1])
    return Bs_np, Gs_np


@pytest.mark.parametrize("b", [7, 14, 21])
def test_banded_rows_match(b):
    rng = np.random.default_rng(b)
    lanes, nb = 3, 5
    n = nb * b
    Bs_np, Gs_np = _groups(rng, lanes, nb, b)
    m = sum(B.shape[1] * B.shape[2] for B in Bs_np)
    Bs_t = tuple(torch.as_tensor(B) for B in Bs_np)
    Gs_t = tuple(torch.as_tensor(np.array(G)) for G in Gs_np)
    v = rng.normal(size=(lanes, n))
    w = rng.normal(size=(lanes, m))
    d = rng.uniform(0.1, 2.0, (lanes, m))
    c = (rng.uniform(size=(lanes, n)) > 0.2).astype(float)
    vt, wt, dt_, ct = (torch.as_tensor(a) for a in (v, w, d, c))

    D_t = torch.zeros((lanes, nb, b, b), dtype=torch.float64)
    O_t = torch.zeros((lanes, nb - 1, b, b), dtype=torch.float64)
    tbr.bb_quad(Bs_t, Gs_t, dt_, D_t, O_t)
    dense_t = tbr.bb_to_dense(Bs_t, Gs_t, n, b)
    for z in range(lanes):
        Bj = [jnp.asarray(B[z]) for B in Bs_np]
        Gj = [jnp.asarray(G) for G in Gs_np]
        _close(tbr.bb_mv(Bs_t, Gs_t, vt, b)[z], jbr.bb_mv(Bj, Gj, jnp.asarray(v[z]), b))
        _close(tbr.bb_rmv(Bs_t, Gs_t, wt, n, b)[z],
               jbr.bb_rmv(Bj, Gj, jnp.asarray(w[z]), n, b))
        _close(tbr.bb_rowmax(Bs_t)[z], jbr.bb_rowmax(Bj))
        for got, ref in zip(tbr.bb_scale_rows(Bs_t, dt_),
                            jbr.bb_scale_rows(Bj, jnp.asarray(d[z]))):
            _close(got[z], ref)
        for got, ref in zip(tbr.bb_scale_cols(Bs_t, Gs_t, ct, b),
                            jbr.bb_scale_cols(Bj, Gj, jnp.asarray(c[z]), b)):
            _close(got[z], ref)
        Dj, Oj = jbr.bb_quad(Bj, Gj, jnp.asarray(d[z]), nb, b)
        _close(D_t[z], Dj)
        _close(O_t[z], Oj)
        _close(dense_t[z], jbr.bb_to_dense(Bj, Gj, n, b))


@pytest.mark.parametrize("c", [2, 3])
def test_regroup_matches(c):
    rng = np.random.default_rng(c)
    bs, nsb, lanes = 7, 3, 2
    w = c + 1
    ng = c * nsb - c
    B = rng.normal(size=(lanes, ng, 4, w * bs))
    G = np.arange(ng, dtype=np.int32)
    Bt, Gt = tbr.regroup(torch.as_tensor(B), torch.as_tensor(G), bs, c, nsb)
    for z in range(lanes):
        Bj, Gj = jbr.regroup(jnp.asarray(B[z]), jnp.asarray(G), bs, c, nsb)
        _close(Bt[z], Bj)
        np.testing.assert_array_equal(Gt.numpy(), np.asarray(Gj))


def _spd_blocks(rng, lanes, T, b):
    """Random block-tridiagonal SPD systems (J' diag(d) J + I from gap
    windows) and their dense form."""
    n = T * b
    B = rng.normal(size=(lanes, T - 1, 2 * b, 2 * b))
    G = np.arange(T - 1, dtype=np.int32)
    d = rng.uniform(0.1, 3.0, (lanes, (T - 1) * 2 * b))
    D = torch.eye(b, dtype=torch.float64).repeat(lanes, T, 1, 1)
    O = torch.zeros((lanes, T - 1, b, b), dtype=torch.float64)
    tbr.bb_quad((torch.as_tensor(B),), (torch.as_tensor(G),),
                torch.as_tensor(d), D, O)
    return D, O, n


@pytest.mark.parametrize("b,T", [(7, 6), (14, 5), (21, 4)])
def test_btd_factor_solve_match(b, T):
    rng = np.random.default_rng(100 + b)
    lanes = 3
    D, O, n = _spd_blocks(rng, lanes, T, b)
    r = rng.normal(size=(lanes, T, b))
    LD, LM = tbt.btd_factor(D, O)
    x = tbt.btd_solve(LD, LM, torch.as_tensor(r))
    LDj, LMj = jax.vmap(jbt.btd_factor)(jnp.asarray(D.numpy()),
                                        jnp.asarray(O.numpy()))
    xj = jax.vmap(jbt.btd_solve)(LDj, LMj, jnp.asarray(r))
    _close(LD, LDj)
    _close(LM, LMj)
    _close(x, xj)
    # blocks_from_dense round trip of the assembled matrix
    K = np.zeros((lanes, n, n))
    for t in range(T):
        K[:, t * b:(t + 1) * b, t * b:(t + 1) * b] = D[:, t].numpy()
    for t in range(T - 1):
        K[:, (t + 1) * b:(t + 2) * b, t * b:(t + 1) * b] = O[:, t].numpy()
        K[:, t * b:(t + 1) * b, (t + 1) * b:(t + 2) * b] = \
            O[:, t].numpy().transpose(0, 2, 1)
    Dd, Od = tbt.blocks_from_dense(torch.as_tensor(K), T, b)
    for z in range(lanes):
        Dj, Oj = jbt.blocks_from_dense(jnp.asarray(K[z]), T, b)
        _close(Dd[z], Dj)
        _close(Od[z], Oj)
    _close(x.reshape(lanes, n), np.linalg.solve(K, r.reshape(lanes, n, 1))[..., 0])
    if b == 7:  # the scalarized variant the reference IPM runs
        fs = jax.jit(lambda D_, O_, r_: jbt.btd_solve_scalar(
            jbt.btd_factor_scalar(D_, O_), r_))
        for z in range(lanes):
            _close(x[z], fs(jnp.asarray(D[z].numpy()), jnp.asarray(O[z].numpy()),
                            jnp.asarray(r[z])))


def test_cuda_wrappers_reject_cpu_tensors():
    """A CUDA wrapper launches its kernel or raises; it never falls back."""
    D = torch.eye(7, dtype=torch.float64).repeat(1, 3, 1, 1)
    O = torch.zeros((1, 2, 7, 7), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        tbt.btd_factor_cuda(D, O)
    with pytest.raises(ValueError, match="CUDA"):
        tbt.btd_solve_cuda(D, O, torch.zeros((1, 3, 7), dtype=torch.float64))
    with pytest.raises(ValueError, match="CUDA"):
        tbr.bb_quad_group_cuda(torch.zeros((1, 2, 1, 14), dtype=torch.float64),
                               torch.zeros(2, dtype=torch.int32),
                               torch.zeros((1, 2), dtype=torch.float64), D, O)
    # K6 ipm_banded, on the set-up of a small box-only QP
    n = 14
    z = torch.zeros((1, 0), dtype=torch.float64)
    data = ProxQPData(P=torch.eye(n, dtype=torch.float64)[None],
                      q=torch.ones((1, n), dtype=torch.float64), A_h=None,
                      e_h=z, w_h=z, A_a=None, e_a=z, w_a=z,
                      lb=-torch.ones((1, n), dtype=torch.float64),
                      ub=torch.ones((1, n), dtype=torch.float64))
    su = tipm._setup(data, QPSettings(solver="ipm", kkt_block=7))
    with pytest.raises(ValueError, match="CUDA"):
        tipm.ipm_banded_cuda(su, tipm.band_plan(data, 7))
