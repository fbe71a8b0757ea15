"""Port parity for kernels 6-9 on the CPU: the plain versions behind
``ops.build_tables_fused_lda``, ``ops.sample_rows``,
``ops.sample_rows_sorted`` and ``ops.mh_accept`` against the reference's
Pallas kernels in interpret mode on the same inputs.

Tolerances and why:
* The fused build forms p = (α·(n_wk+β))/(n_k+β̄) as the TPU kernel is
  written and sums each row left to right, XLA's CPU order at K ≤ 16:
  tables and stale matrix equal the reference's oracle of the fused build
  (``repro.kernels.ref.alias_build_fused_ref``) and its wrapper's stale
  matrix bit for bit.  Against the Pallas kernel in interpret mode the
  masses, the stale matrix and every alias entry are equal, but prob is
  not: XLA's algebraic simplifier rewrites the kernel's (num/den)/mass
  into num/(den·mass), so each scaled entry p/mass·K may round one ulp
  apart, an ulp of values up to K, which the pairing's subtractions carry
  into prob.  prob is held to 4·K·2⁻²⁴ absolute.
* The fused tables differ from the unfused build's
  (α·((n_wk+β)/(n_k+β̄))) in the last place on some inputs, which the test
  pins.
* Alias draws and the accept step are a gather, a compare and a select
  (and one float32 log) given the same uniforms: equal.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import alias_build as ref_build
from repro.kernels import alias_sample as ref_sample
from repro.kernels import mh_accept as ref_accept
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracles
from repro_torch.core import alias, lda
from repro_torch.kernels import _build, ops, ref


def _counts(rng, v, k, scale=3.0):
    n_wk = np.floor(rng.gamma(0.4, size=(v, k)) * scale).astype(np.float32)
    n_wk[1] = 0.0                                  # an unseen word
    return n_wk, n_wk.sum(0)


@pytest.mark.parametrize("v,k,alpha,beta,seed", [
    (64, 16, 0.1, 0.01, 0), (40, 7, 0.37, 0.05, 1), (256, 8, 1.3, 0.1, 2)])
def test_fused_build_matches_pallas(v, k, alpha, beta, seed):
    rng = np.random.default_rng(seed)
    n_wk, n_k = _counts(rng, v, k)
    wp, wa, wm = ref_build.alias_build_fused(
        jnp.asarray(n_wk), jnp.asarray(n_k), alpha=alpha, beta=beta,
        vocab_size=v, tile_r=8)
    want_t, want_stale = ref_ops.build_tables_fused_lda(
        jnp.asarray(n_wk), jnp.asarray(n_k), alpha=alpha, beta=beta,
        vocab_size=v, tile_r=8)
    _build.reset_launches()
    got, stale = ops.build_tables_fused_lda(
        torch.as_tensor(n_wk), torch.as_tensor(n_k), alpha=alpha, beta=beta,
        vocab_size=v, device="cpu")
    assert sum(_build.LAUNCHES.values()) == 0
    for a, b in zip(got, ref_oracles.alias_build_fused_ref(
            jnp.asarray(n_wk), jnp.asarray(n_k), alpha, beta, v)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(stale.numpy(), np.asarray(want_stale))
    np.testing.assert_array_equal(got.mass.numpy(), np.asarray(wm))
    np.testing.assert_array_equal(got.mass.numpy(), np.asarray(want_t.mass))
    np.testing.assert_array_equal(got.alias.numpy(), np.asarray(wa))
    np.testing.assert_allclose(got.prob.numpy(), np.asarray(wp), rtol=0,
                               atol=4 * k * 2.0 ** -24)
    np.testing.assert_array_equal(
        stale.numpy(), ref.fused_dense_ref(
            torch.as_tensor(n_wk), torch.as_tensor(n_k), alpha=alpha,
            beta=beta, vocab_size=v).numpy())
    # LDAConfig(fused_alias_build=True) builds through this path.
    cfg = lda.LDAConfig(n_topics=k, vocab_size=v, alpha=alpha, beta=beta,
                        fused_alias_build=True)
    shared = lda.SharedStats(n_wk=torch.as_tensor(n_wk),
                             n_k=torch.as_tensor(n_k))
    t2, s2 = lda.build_alias(cfg, shared)
    assert torch.equal(s2, stale)
    for a, b in zip(t2, got):
        assert torch.equal(a, b)


def test_fused_grouping_differs_from_unfused_build():
    """The trap the fused kernel's grouping sets: (α·(n_wk+β))/(n_k+β̄) is
    not α·((n_wk+β)/(n_k+β̄)) in float32, so its stale matrix and tables
    are not those of the unfused build on the same statistics."""
    rng = np.random.default_rng(9)
    v, k = 64, 16
    n_wk, n_k = _counts(rng, v, k)
    cfg = lda.LDAConfig(n_topics=k, vocab_size=v, alpha=0.37)
    shared = lda.SharedStats(n_wk=torch.as_tensor(n_wk),
                             n_k=torch.as_tensor(n_k))
    fused, stale_f = ops.build_tables_fused_lda(
        shared.n_wk, shared.n_k, alpha=cfg.alpha, beta=cfg.beta,
        vocab_size=v, device="cpu")
    plain, stale_p = lda.build_alias(cfg, shared)
    assert not torch.equal(stale_f, stale_p)
    assert not all(torch.equal(a, b) for a, b in zip(fused, plain))
    rel = ((stale_f - stale_p).abs() / stale_p).max()
    assert 0 < float(rel) <= 2 * np.finfo(np.float32).eps
    want = np.asarray(ref_ops.build_tables_fused_lda(
        jnp.asarray(n_wk), jnp.asarray(n_k), alpha=cfg.alpha, beta=cfg.beta,
        vocab_size=v)[1])
    np.testing.assert_array_equal(stale_f.numpy(), want)


def _draw_inputs(rng, v, k, b, n_pad, sort):
    p = (rng.gamma(0.3, size=(v, k)) * (rng.random((v, k)) < 0.7))
    t = alias.build(torch.as_tensor(p.astype(np.float32)))
    rows = rng.integers(0, v, size=b - n_pad)
    rows = np.sort(rows) if sort else rows
    pad = np.full(n_pad, v)
    if not sort and n_pad:
        pad[0] = -1                                # below the vocabulary
    rows = np.concatenate([rows, pad]).astype(np.int32)
    if not sort:
        rows = rng.permutation(rows).astype(np.int32)
    slot = rng.integers(0, k, size=b).astype(np.int32)
    coin = rng.random(b).astype(np.float32)
    return t, rows, slot, coin


@pytest.mark.parametrize("v,k,b,n_pad,seed", [
    (64, 16, 512, 0, 0), (128, 8, 1024, 37, 1), (64, 4, 256, 256, 2)])
def test_alias_sample_matches_pallas(v, k, b, n_pad, seed):
    """Unsorted draws (kernel 8's plain version) equal the TPU kernel's,
    rows outside [0, V) included (0)."""
    rng = np.random.default_rng(seed)
    t, rows, slot, coin = _draw_inputs(rng, v, k, b, n_pad, sort=False)
    want = np.asarray(ref_sample.alias_sample(
        jnp.asarray(t.prob.numpy()), jnp.asarray(t.alias.numpy()),
        jnp.asarray(rows), jnp.asarray(slot), jnp.asarray(coin),
        tile_v=16, tile_b=256))
    got = ops.sample_rows(t, torch.as_tensor(rows), uniforms=(
        torch.as_tensor(slot), torch.as_tensor(coin)), device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    outside = (rows < 0) | (rows >= v)
    assert (got.numpy()[outside] == 0).all()
    if (~outside).any():
        assert (got.numpy()[~outside] != slot[~outside]).any()


@pytest.mark.parametrize("v,k,b,n_pad,seed", [
    (64, 16, 512, 0, 3), (128, 8, 1024, 101, 4), (64, 8, 256, 200, 5)])
def test_alias_sample_sorted_matches_pallas(v, k, b, n_pad, seed):
    """Draws over an ascending stream with sentinels (kernel 7's plain
    version) equal the tile-skipping TPU kernel's."""
    rng = np.random.default_rng(seed)
    t, rows, slot, coin = _draw_inputs(rng, v, k, b, n_pad, sort=True)
    tile_v, tile_b = 16, 64
    rs = rows.reshape(-1, tile_b)
    has = rs[:, 0] < v
    last = np.max(np.where(rs < v, rs, -1), axis=1)
    vstart = np.where(has, rs[:, 0] // tile_v, 0).astype(np.int32)
    vcount = np.where(has, last // tile_v - vstart + 1, 0).astype(np.int32)
    want = np.asarray(ref_sample.alias_sample_sorted(
        jnp.asarray(t.prob.numpy()), jnp.asarray(t.alias.numpy()),
        jnp.asarray(rows), jnp.asarray(slot), jnp.asarray(coin),
        jnp.asarray(vstart), jnp.asarray(vcount), tile_v=tile_v,
        tile_b=tile_b))
    args = (t, torch.as_tensor(rows), torch.as_tensor(vstart),
            torch.as_tensor(vcount))
    uni = (torch.as_tensor(slot), torch.as_tensor(coin))
    got = ops.sample_rows_sorted(*args, tile_b=tile_b, uniforms=uni,
                                 device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    if n_pad:
        assert (got.numpy()[-n_pad:] == 0).all()
    unsorted = ops.sample_rows(t, args[1], uniforms=uni, device="cpu")
    assert torch.equal(got, unsorted)
    with pytest.raises(ValueError, match="one per tile"):
        ops.sample_rows_sorted(*args, tile_b=2 * tile_b, uniforms=uni,
                               device="cpu")



@pytest.mark.parametrize("k,runs,seed", [
    (16, [(3, 150), (4, 2), (9, 100)], 7),          # runs across tiles
    (7, [(0, 64), (1, 63), (2, 65), (3, 1)], 8),     # K % 4 != 0
    (24, [(5, 40), (6, 40), (7, 48)], 9),            # then sentinel tiles
    (8, [(int(r), 1) for r in range(30)], 10)])      # runs of one draw
def test_alias_sample_sorted_long_runs_match_pallas(k, runs, seed):
    """Kernel 7's plain version equals the tile-skipping TPU kernel's on
    sorted streams of long runs (V = 32, tile_b = 64): runs crossing
    tiles, a tile of one row, and tiles of sentinels only (vcount 0)."""
    v, tile_v, tile_b = 32, 8, 64
    rng = np.random.default_rng(seed)
    p = rng.gamma(0.3, size=(v, k)) * (rng.random((v, k)) < 0.7)
    t = alias.build(torch.as_tensor(p.astype(np.float32)))
    rows = np.concatenate([np.full(n, r) for r, n in runs])
    b = 5 * tile_b
    rows = np.concatenate([rows, np.full(b - rows.shape[0], v)])
    rows = rows.astype(np.int32)
    slot = rng.integers(0, k, size=b).astype(np.int32)
    coin = rng.random(b).astype(np.float32)
    rs = rows.reshape(-1, tile_b)
    has = rs[:, 0] < v
    last = np.max(np.where(rs < v, rs, -1), axis=1)
    vstart = np.where(has, rs[:, 0] // tile_v, 0).astype(np.int32)
    vcount = np.where(has, last // tile_v - vstart + 1, 0).astype(np.int32)
    assert (vcount == 0).any()
    want = np.asarray(ref_sample.alias_sample_sorted(
        jnp.asarray(t.prob.numpy()), jnp.asarray(t.alias.numpy()),
        jnp.asarray(rows), jnp.asarray(slot), jnp.asarray(coin),
        jnp.asarray(vstart), jnp.asarray(vcount), tile_v=tile_v,
        tile_b=tile_b))
    got = ops.sample_rows_sorted(
        t, torch.as_tensor(rows), torch.as_tensor(vstart),
        torch.as_tensor(vcount), tile_b=tile_b, uniforms=(
            torch.as_tensor(slot), torch.as_tensor(coin)), device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[rows >= v] == 0).all()

def test_sample_rows_generator_draws_its_streams():
    """With a generator the wrappers draw (slot, coin) in that order, so
    the same seed gives the draws of the injected streams."""
    rng = np.random.default_rng(6)
    t, rows, _, _ = _draw_inputs(rng, 32, 8, 128, 8, sort=True)
    rows = torch.as_tensor(rows)
    g = torch.Generator().manual_seed(3)
    slot = torch.randint(0, 8, rows.shape, generator=g, dtype=torch.int32)
    coin = torch.rand(rows.shape, generator=g)
    want = ref.alias_sample_ref(t.prob, t.alias, rows, slot, coin)
    assert torch.equal(ops.sample_rows(
        t, rows, torch.Generator().manual_seed(3), device="cpu"), want)
    one = torch.zeros(1, dtype=torch.int32)
    assert torch.equal(ops.sample_rows_sorted(
        t, rows, one, one, torch.Generator().manual_seed(3), tile_b=128,
        device="cpu"), want)


@pytest.mark.parametrize("b,seed", [(4096, 0), (1000, 1), (8192, 2)])
def test_mh_accept_matches_pallas(b, seed):
    rng = np.random.default_rng(seed)
    z = rng.integers(0, 64, size=b).astype(np.int32)
    cand = rng.integers(0, 64, size=b).astype(np.int32)
    lps = [np.log(rng.gamma(0.5, size=b) + 1e-6).astype(np.float32)
           for _ in range(4)]
    u = rng.random(b).astype(np.float32)
    u[:3] = [0.0, 1e-38, 1.0 - 2 ** -24]           # log's far ends
    tile_b = 4096 if b % 4096 == 0 else b
    want = np.asarray(ref_accept.mh_accept(
        *map(jnp.asarray, (z, cand, *lps, u)), tile_b=tile_b))
    g = torch.as_tensor
    got = ops.mh_accept(g(z), g(cand), *map(g, lps), u=g(u), device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    accepted = got.numpy() == cand
    assert 0.05 < accepted.mean() < 0.95
    gen = ops.mh_accept(g(z), g(cand), *map(g, lps),
                        torch.Generator().manual_seed(0), device="cpu")
    assert bool(((gen == g(z)) | (gen == g(cand))).all())
