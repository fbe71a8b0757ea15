"""Port parity: the alias builds (plain versions of kernels 2 and 3),
update_rows and changed_rows.

Tolerances and why:
* Row masses: the port sums each row left to right in float32, the order
  the reference's row sum takes on the CPU at these K (≤ 16), so masses
  are bit-equal; the tables are then required to be bit-equal too (alias
  exactly, prob to 0 ulp), because every later operation is the same
  IEEE float32 operation in the same order.  Where a mass differs (not
  expected here) alias need not agree, so the test only requires it where
  mass is bit-equal.
* The distribution each table encodes equals p/mass to 1e-6 absolute in
  every row, zero-mass rows (uniform) included: the pairing's repeated
  float32 subtractions move mass by a few ulp of 1 per slot.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import alias as ref_alias
from repro.core import ps as ref_ps
from repro.kernels import alias_build as ref_kernels
from repro_torch.core import alias, ps
from repro_torch.kernels import ops


def _dense(seed, r, k, zero_rows=3):
    rng = np.random.default_rng(seed)
    p = (rng.gamma(0.3, size=(r, k)) * (rng.random((r, k)) < 0.7))
    p = p.astype(np.float32)
    p[:zero_rows] = 0.0                       # uniform fallback rows
    p[zero_rows] = np.float32(1.0)            # all-equal row: no smalls
    return p


def _encoded(prob, alias_):
    prob = np.asarray(prob, np.float64)
    k = prob.shape[1]
    q = prob.copy()
    for row in range(prob.shape[0]):
        np.add.at(q[row], np.asarray(alias_)[row], 1.0 - prob[row])
    return q / k


def _target(p, mass):
    p = np.asarray(p, np.float64)
    out = np.full_like(p, 1.0 / p.shape[1])
    ok = np.asarray(mass) > 0
    out[ok] = p[ok] / np.asarray(mass, np.float64)[ok, None]
    return out


def _check_against(p, got, want_prob, want_alias, want_mass):
    same = np.asarray(want_mass) == got.mass.numpy()
    assert same.all(), f"{(~same).sum()} row masses differ"
    np.testing.assert_array_equal(got.alias.numpy()[same],
                                  np.asarray(want_alias)[same])
    np.testing.assert_array_equal(got.prob.numpy()[same],
                                  np.asarray(want_prob)[same])
    err = np.abs(_encoded(got.prob.numpy(), got.alias.numpy())
                 - _target(p, got.mass.numpy())).max()
    assert err <= 1e-6, err


@pytest.mark.parametrize("r,k,seed", [(64, 16, 0), (40, 7, 1), (256, 13, 2),
                                      (8, 1, 3)])
def test_plain_build_matches_core_alias(r, k, seed):
    p = _dense(seed, r, k, zero_rows=min(3, r - 1))
    want = ref_alias.build(jnp.asarray(p))
    got = alias.build(torch.as_tensor(p))
    _check_against(p, got, want.prob, want.alias, want.mass)


@pytest.mark.parametrize("r,k,seed", [(64, 16, 4), (256, 8, 5)])
def test_plain_build_matches_pallas_alias_build(r, k, seed):
    """The TPU kernel (interpret mode) builds the same tables."""
    p = _dense(seed, r, k)
    prob, al, mass = ref_kernels.alias_build(jnp.asarray(p), tile_r=8)
    got = ops.build_tables(torch.as_tensor(p), device="cpu")
    _check_against(p, got, prob, al, mass)


def _stats(seed, v, k):
    rng = np.random.default_rng(seed)
    n_wk = np.floor(rng.gamma(0.5, size=(v, k)) * 3).astype(np.float32)
    n_wk[5] = 0.0
    return n_wk, n_wk.sum(0)


def test_gather_build_matches_pallas_and_full_rebuild():
    """Kernel 3's plain version equals alias_build_gather_fused, and each
    gathered row equals the same row of a full rebuild: the dense term
    keeps the division grouped first, prior·((n_wk+β)/(n_k+β̄))."""
    v, k = 96, 16
    n_wk, n_k = _stats(7, v, k)
    prior = np.full(k, 0.1, np.float32)
    rows = np.array([5, 0, 17, 95, 42, 3], np.int32)
    beta, beta_bar = 0.01, 0.01 * v
    wp, wa, wm, wd = ref_kernels.alias_build_gather_fused(
        jnp.asarray(n_wk), jnp.asarray(n_k), jnp.asarray(prior),
        jnp.asarray(rows), beta=beta, beta_bar=beta_bar)
    t = [torch.as_tensor(x) for x in (n_wk, n_k, prior, rows)]
    sub, dense = ops.build_tables_gather_fused(*t, beta=beta,
                                               beta_bar=beta_bar,
                                               device="cpu")
    np.testing.assert_array_equal(dense.numpy(), np.asarray(wd))
    _check_against(dense.numpy(), sub, wp, wa, wm)

    full_dense = 0.1 * ((t[0] + beta) / (t[1][None, :] + beta_bar))
    full = ops.build_tables(full_dense, device="cpu")
    idx = torch.as_tensor(rows).long()
    assert torch.equal(dense, full_dense[idx])
    for a, b in zip(sub, full):
        assert torch.equal(a, b[idx])


def test_update_rows_matches_reference():
    v, k = 20, 6
    rng = np.random.default_rng(3)
    base = rng.random((v, k)).astype(np.float32)
    sub_p = rng.random((4, k)).astype(np.float32)
    rows = np.array([7, 2, 19, 0], np.int32)
    valid = np.array([True, False, True, True])
    rt = ref_alias.build(jnp.asarray(base))
    rs = ref_alias.build(jnp.asarray(sub_p))
    want, want_stale = ref_alias.update_rows(
        rt, jnp.asarray(base), jnp.asarray(rows), jnp.asarray(valid), rs,
        jnp.asarray(sub_p))
    tt = alias.build(torch.as_tensor(base))
    ts = alias.build(torch.as_tensor(sub_p))
    got, got_stale = alias.update_rows(
        tt, torch.as_tensor(base), torch.as_tensor(rows),
        torch.as_tensor(valid), ts, torch.as_tensor(sub_p))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got_stale.numpy(), np.asarray(want_stale))
    assert torch.equal(tt.prob, alias.build(torch.as_tensor(base)).prob), \
        "update_rows must not modify its inputs"


@pytest.mark.parametrize("mass,k_rows,threshold", [
    ([0.0, 3.0, 1.0, 3.0, 0.0, 3.0, 2.0], 4, 0.5),   # ties: lower id first
    ([0.0] * 6, 3, 0.0),                              # nothing changed
    ([1.0, 2.0], 5, 0.0),                             # k_rows > V clamps
    ([5.0, 5.0, 5.0, 5.0], 2, 0.0),
])
def test_changed_rows_matches_lax_top_k(mass, k_rows, threshold):
    m = np.asarray(mass, np.float32)
    wr, wv = ref_ps.changed_rows(jnp.asarray(m), k_rows, threshold)
    gr, gv = ps.changed_rows(torch.as_tensor(m), k_rows, threshold)
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_plain_versions_are_the_wrapped_functions():
    """ops on CPU tensors returns exactly the plain build's results (no
    other path)."""
    p = torch.as_tensor(_dense(9, 16, 8))
    a = ops.build_tables(p, device="cpu")
    b = alias.build(p)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
