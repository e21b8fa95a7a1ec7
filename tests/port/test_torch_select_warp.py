"""K10 contact_select / K10v's host build against the plain selection, bit
for bit, and the plain selection against JAX's, on the CPU.

- ``contact_select_host`` at teams of 1 and 32 (the card's warp: the
  register route wherever ``select_route`` gives it, the shared-memory
  route elsewhere) against ``contact_select_plain``, float32 and float64,
  every output's bits equal (signed zeros included), over P in {1, 5, 28,
  31, 32, 33, 64, 65, 300}, S in {1, 7, 47} (cast), K in {1, 3, P}, nc in
  {2, 7, 8, 13}, the cast form and the discrete form with ``right_group``
  at the last group, the first and none; each input holds a group with
  exact ties between pairs (pairs a lane apart on the card among them), a
  group with NaN distances, a group with every pair inactive (err <
  -buffer) and keys of +0 and -0 (ranked alike: the lower index first);
- at 7a's shapes (29 gaps x 7 segments x 28 pairs, K 3, nc 7; the discrete
  form 30 steps), the host build against JAX's own selection:
  ``jax.lax.top_k`` over the keys and the gathers of
  ``trajopt_tpu/terms/collision.py:441-491`` (cast) and ``:252-290`` with
  ``ops/banded_rows.step_window`` (discrete), written as there;
- ``select_route`` against the host build's own rule.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trajopt_tpu.ops.banded_rows import step_window
from trajopt_tpu_torch import _native
from trajopt_tpu_torch.terms import collision as TCOL

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
import chip_smoke as CS  # noqa: E402

PAIRS = [1, 5, 28, 31, 32, 33, 64, 65, 300]
SEGS = [1, 7, 47]
NCS = [2, 7, 8, 13]
BUF = 0.4
LANES, GROUPS = 2, 4


def _bits(x):
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)


def _same(a, b):
    """Every element's bits equal (NaNs, signed zeros included)."""
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _inputs(rng, S, P, nc, dt, cast):
    """chip_smoke's seeded inputs (``select_case``: keys of -0 and +0, exact
    ties, NaN distances, every pair inactive, a group each) as tensors."""
    return tuple(None if a is None else torch.as_tensor(a, dtype=dt)
                 .contiguous() for a in CS.select_case(
                     rng, S, P, nc, cast, lanes=LANES, groups=GROUPS,
                     buffer=BUF))


def _check(D, m, c, K, Ja, Jb, right):
    pv = TCOL.contact_select_plain(D, m, c, BUF, K)
    pr = TCOL.contact_select_plain(D, m, c, BUF, K, Ja, Jb, right)
    assert _same(pr[0], pv)
    for team in (1, 32):
        hv = TCOL.contact_select_host(D, m, c, BUF, K, team=team)
        hr = TCOL.contact_select_host(D, m, c, BUF, K, Ja, Jb, right,
                                      team=team)
        info = (team, tuple(D.shape), K, Ja.shape[-1], right, D.dtype)
        assert _same(hv, pv), info
        assert _same(hr[0], pv), info
        assert _same(hr[1], pr[1]), info


@pytest.mark.parametrize("P", PAIRS)
@pytest.mark.parametrize("dt", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_host_build_bitwise_at_every_size(dt, P):
    """Both routes, both forms, every (S, K, nc) of the lists at this P."""
    rng = np.random.default_rng(16 + P)
    Ks = sorted({k for k in (1, 3, P) if k <= P})
    routes = set()
    for S in SEGS:
        for nc in NCS:
            D, m, c, Ja, Jb = _inputs(rng, S, P, nc, dt, True)
            for K in Ks:
                routes.add(TCOL.select_route(P, S, K))
                _check(D, m, c, K, Ja, Jb, -1)
    for nc in NCS:
        D, m, c, Ja, _ = _inputs(rng, 1, P, nc, dt, False)
        for K in Ks:
            for right in (GROUPS - 1, 0, -1):
                _check(D, m, c, K, Ja, None, right)
    assert routes == ({"registers", "shared"} if P <= 64 else {"shared"})


def test_select_route_matches_the_host_rule():
    """``select_route`` is the kernels' own rule (``reg_route``)."""
    lib = _native.host_library("contact_select_host")
    for team in (1, 2, 4, 8, 16, 32):
        for P in PAIRS:
            for S in (1, 7, 8, 9, 47):
                for K in sorted({1, 3, 9, 10, P}):
                    want = TCOL.select_route(P, S, K, team) == "registers"
                    assert lib.contact_select_route(P, S, K, team) == want


# --------------------------------------------------------------------------
# 7a's shapes against JAX's selection
# --------------------------------------------------------------------------


def _jax_cast(D, m, c, Ja, Jb, K, buffer):
    """terms/collision.py:441-491 (_sel, sfn, _sel_jac_gaps, sjac_banded)
    for one lane: D (n_gaps, n_seg, P); Ja, Jb the err Jacobians."""
    n_gaps, n_seg, P = D.shape
    nc = Ja.shape[-1]
    errs = (m[None, None, :] - D).reshape(n_gaps, n_seg, P)
    key = jnp.max(errs, axis=1)
    _, idx = jax.lax.top_k(key, K)
    vals = jnp.take_along_axis(errs, idx[:, None, :], axis=2)
    act = vals >= -jnp.asarray(buffer, D.dtype)
    cof = c[idx]
    fn = jnp.where(act, cof[:, None, :] * vals, -1.0).reshape(-1)
    sc = jnp.where(act, cof[:, None, :], 0.0)

    def g(J):
        J = J.reshape(n_gaps, n_seg, P, nc)
        Js = jnp.take_along_axis(J, idx[:, None, :, None], axis=2)
        return (Js * sc[..., None]).reshape(n_gaps, n_seg * K, nc)

    return fn, jnp.concatenate([g(Ja), g(Jb)], axis=-1)


def _jax_discrete(D, m, c, J, K, buffer, n_steps):
    """terms/collision.py:70-89 and :252-290 (_topk_rows, sfn,
    _sel_jac_steps, sjac_banded) for one lane: D (span, P), J the err
    Jacobians (span, P, nc), the span all n_steps steps."""
    errs = m[None, :] - D
    vals, idx = jax.lax.top_k(errs, K)
    act = vals >= -jnp.asarray(buffer, D.dtype)
    vals = jnp.where(act, vals, -jnp.asarray(buffer, D.dtype))
    cof = c[idx]
    fn = jnp.where(act, cof * vals, -1.0).reshape(-1)
    sc = jnp.where(act, cof, 0.0)
    Js = jnp.take_along_axis(J, idx[:, :, None], axis=1) * sc[:, :, None]
    B, _ = step_window(Js, jnp.arange(n_steps), n_steps)
    return fn, B


@pytest.mark.parametrize("form", ["cast", "discrete"])
@pytest.mark.parametrize("dt", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_7a_shape_matches_jax_top_k(form, dt):
    """2 lanes at 7a's shapes, with exact ties and a NaN key: the host
    build (teams 1 and 32) and the plain selection against JAX's top_k
    selection, bit for bit."""
    rng = np.random.default_rng(7)
    cast = form == "cast"
    G, S, P, K, nc = (29, 7, 28, 3, 7) if cast else (30, 1, 28, 3, 7)
    D, m, c, Ja, Jb = _inputs(rng, S, P, nc, dt, cast)
    D = torch.cat([D] + [D[:, :1]] * (G - GROUPS), 1).contiguous()
    Ja, Jb = (None if J is None else torch.cat(
        [J] + [J[:, :1]] * (G - GROUPS), 1).contiguous() for J in (Ja, Jb))
    D[:, GROUPS:] += torch.as_tensor(rng.uniform(-0.1, 0.1, (
        LANES, G - GROUPS, S, P)), dtype=dt)
    right = -1 if cast else G - 1
    assert TCOL.select_route(P, S, K) == "registers"
    want = []
    for b in range(LANES):
        j = lambda x: jnp.asarray(x[b].numpy())  # noqa: E731
        if cast:
            fn, rows = _jax_cast(j(D), j(m), j(c), -j(Ja), -j(Jb), K, BUF)
        else:
            fn, rows = _jax_discrete(j(D)[:, 0], j(m), j(c),
                                     -j(Ja).reshape(G, P, nc), K, BUF, G)
        want.append((torch.as_tensor(np.array(fn)),
                     torch.as_tensor(np.array(rows))))
    wv = torch.stack([w[0] for w in want])
    wr = torch.stack([w[1] for w in want])
    assert wv.dtype == dt and wr.shape == (LANES, G, S * K, 2 * nc)
    pv, pr = TCOL.contact_select_plain(D, m, c, BUF, K, Ja, Jb, right)
    assert _same(pv, wv) and _same(pr, wr)
    for team in (1, 32):
        hv, hr = TCOL.contact_select_host(D, m, c, BUF, K, Ja, Jb, right,
                                          team=team)
        assert _same(hv, wv) and _same(hr, wr), team
