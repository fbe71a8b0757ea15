"""Port parity: the sorted MHW chain (plain version of kernel 1) and the
LDA sorted sweep, fed the reference's uniforms.

Tolerance: none.  The port's plain chain accumulates the cumulative sum of
the sparse weights left to right in float32, the order of the
reference's cumsum on the CPU at these K (≤ 16), and every other step is
the same float32 operation in the same order, so the draws are required
to be identical.  (On the card the kernel sums 32 blocks in parallel;
chip_smoke.py states that mismatch rate.)  A log() that rounded one ulp
apart near an accept tie could in principle flip one draw; the inputs here
show none.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import family as ref_family
from repro.core import lda as ref_lda
from repro.kernels import mhw_fused as ref_fused
from repro.kernels import ops as ref_ops
from repro_torch import bridge
from repro_torch.core import family, mhw
from repro_torch.kernels import ops
from tests.conftest import make_synthetic_corpus


def _windows(rows, v, tile_v, tile_b):
    rs = rows.reshape(-1, tile_b)
    has = rs[:, 0] < v
    last = np.max(np.where(rs < v, rs, -1), axis=1)
    vstart = np.where(has, rs[:, 0] // tile_v, 0).astype(np.int32)
    vcount = np.where(has, last // tile_v - vstart + 1, 0).astype(np.int32)
    return vstart, vcount


@pytest.mark.parametrize("prior_kind", ["lda", "hdp"])
@pytest.mark.parametrize("v,k,b,tile_v,tile_b,lo,hi,n_pad,steps", [
    (60, 16, 384, 12, 128, 0, 60, 0, 2),
    (120, 16, 256, 12, 64, 24, 60, 0, 3),
    (60, 8, 256, 12, 64, 0, 7, 61, 2),      # skew + padding rows
])
def test_plain_chain_matches_pallas_kernel(v, k, b, tile_v, tile_b, lo, hi,
                                           n_pad, steps, prior_kind):
    rng = np.random.default_rng(v * k + b)
    beta, beta_bar = 0.01, 0.01 * v
    n_wk = (rng.gamma(1.0, size=(v, k)) * 5).astype(np.float32)
    n_k = n_wk.sum(0)
    if prior_kind == "lda":
        prior = np.full(k, 0.1, np.float32)
    else:
        prior = (2.0 * rng.dirichlet(np.ones(k))).astype(np.float32)
    stale = np.asarray(jnp.asarray(prior)[None, :]
                       * ((jnp.asarray(n_wk) + beta)
                          / (jnp.asarray(n_k)[None, :] + beta_bar)))
    tabs = ref_ops.build_tables(jnp.asarray(stale), tile_r=4)
    rows = np.sort(rng.integers(lo, hi, size=b - n_pad)).astype(np.int32)
    rows = np.concatenate([rows, np.full(n_pad, v, np.int32)])
    z0 = rng.integers(0, k, size=b).astype(np.int32)
    ndk = rng.gamma(0.5, size=(b, k)).astype(np.float32)
    ndk[np.arange(b), z0] += 1.0
    slot = rng.integers(0, k, size=(steps, b)).astype(np.int32)
    uni = [rng.random((steps, b)).astype(np.float32) for _ in range(4)]
    vstart, vcount = _windows(rows, v, tile_v, tile_b)

    want = np.asarray(ref_fused.mhw_sweep_fused(
        tabs.prob, tabs.alias, tabs.mass, jnp.asarray(stale),
        jnp.asarray(n_wk), jnp.asarray(n_k), jnp.asarray(prior),
        jnp.asarray(rows), jnp.asarray(z0), jnp.asarray(ndk),
        jnp.asarray(slot), *map(jnp.asarray, uni), jnp.asarray(vstart),
        jnp.asarray(vcount), tile_v=tile_v, tile_b=tile_b, n_steps=steps,
        beta=beta, beta_bar=beta_bar))

    def t(x):
        return torch.tensor(np.asarray(x))

    got = mhw.sorted_chain(
        t(tabs.prob), t(tabs.alias), t(tabs.mass), t(stale), t(n_wk),
        t(n_k), t(prior), t(rows), torch.arange(b, dtype=torch.int32),
        t(z0), t(ndk), t(slot), *map(t, uni), beta=beta,
        beta_bar=beta_bar).numpy()
    np.testing.assert_array_equal(got, want)
    if n_pad:
        np.testing.assert_array_equal(got[-n_pad:], z0[-n_pad:])


@pytest.mark.parametrize("chunks", [1, 4])
def test_sweep_sorted_matches_reference_with_injected_uniforms(chunks):
    """LDAFamily.sweep_sorted from the same state and the reference's
    layouts' geometry, fed the same per-chunk uniforms, gives the same z,
    n_dk and n_wk delta as the reference family sweep."""
    tokens, mask, _ = make_synthetic_corpus(n_topics=6, vocab=96, n_docs=40,
                                            doc_len=24, seed=3)
    tokens, mask = np.array(tokens), np.array(mask)
    mask[::3, -5:] = False                       # masked tail positions
    rcfg = ref_lda.LDAConfig(n_topics=12, vocab_size=96, mh_steps=2,
                             sorted_chunks=chunks, tile_b=64)
    cfg = bridge.config_from(rcfg)
    jt, jm = jnp.asarray(tokens), jnp.asarray(mask)
    rlocal, rshared = ref_lda.init_state(rcfg, jt, jm, jax.random.PRNGKey(0))
    rtables, rstale = ref_lda.build_alias(rcfg, rshared)

    rng = np.random.default_rng(11)
    streams = {}

    def uniforms(c, lay, tile_b):
        if c not in streams:
            bp = int(lay.rows.shape[0])
            streams[c] = (
                rng.integers(0, cfg.n_topics, size=(2, bp)).astype(np.int32),
                *(rng.random((2, bp)).astype(np.float32) for _ in range(4)))
        return streams[c]

    rfam = ref_family.get("lda")
    rlays = rfam.build_sorted_layouts(rcfg, jt, jm)
    rl2, rd = rfam.sweep_sorted(
        rcfg, rlocal, rshared, rtables, rstale, jt, jm,
        jax.random.PRNGKey(1), rlays,
        chunk_uniforms=lambda c, lay, tb: tuple(
            jnp.asarray(a) for a in uniforms(c, lay, tb)))

    np_of = lambda nt: {f: np.asarray(getattr(nt, f)) for f in nt._fields}
    local = bridge.local_from(np_of(rlocal), device="cpu")
    shared = bridge.shared_from(np_of(rshared), device="cpu")
    tables, stale = bridge.proposal_from(np_of(rtables), rstale,
                                          device="cpu")
    fam = family.get("lda")
    tt, tm = torch.as_tensor(tokens), torch.as_tensor(mask)
    lays = fam.build_sorted_layouts(cfg, tt, tm)
    for rl, gl in zip(rlays, lays):
        assert torch.equal(gl.rows, torch.tensor(np.asarray(rl.rows)))
    l2, d = fam.sweep_sorted(
        cfg, local, shared, tables, stale, tt, tm, (0, 1), lays,
        chunk_uniforms=lambda c, lay, tb: tuple(
            torch.as_tensor(a) for a in uniforms(c, lay, tb)),
        device="cpu")
    np.testing.assert_array_equal(l2.z.numpy(), np.asarray(rl2.z))
    np.testing.assert_array_equal(l2.n_dk.numpy(), np.asarray(rl2.n_dk))
    np.testing.assert_array_equal(d["n_wk"].numpy(), np.asarray(rd["n_wk"]))
    assert float((l2.z != local.z).float().mean()) > 0.1, "chain moved"


def test_sweep_geometry_guard_rejects_foreign_layouts():
    tokens = torch.zeros((8, 12), dtype=torch.int32)
    mask = torch.ones((8, 12), dtype=torch.bool)
    cfg = bridge.config_from(ref_lda.LDAConfig(n_topics=4, vocab_size=16,
                                               sorted_chunks=2))
    fam = family.get("lda")
    lays = fam.build_sorted_layouts(cfg, tokens, mask)
    local, shared = fam.init_state(cfg, tokens, mask, (0,))
    tables, stale = fam.build_alias(cfg, shared)
    with pytest.raises(ValueError, match="chunks"):
        fam.sweep_sorted(cfg, local, shared, tables, stale, tokens, mask,
                         (0,), lays[:1], device="cpu")


def test_ops_sweep_draws_its_own_uniforms_on_cpu():
    """Without injected uniforms the wrapper draws them from the
    generator: the same generator seed gives the same chain."""
    cfg = bridge.config_from(ref_lda.LDAConfig(n_topics=8, vocab_size=32))
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, 32, size=(10, 16)),
                             dtype=torch.int32)
    mask = torch.ones((10, 16), dtype=torch.bool)
    fam = family.get("lda")
    local, shared = fam.init_state(cfg, tokens, mask, (0,))
    tables, stale = fam.build_alias(cfg, shared)
    lay = fam.build_sorted_layouts(cfg, tokens, mask)[0]
    z = torch.zeros(lay.rows.shape[0], dtype=torch.int32)
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(5)
        runs.append(ops.mhw_sweep_sorted(
            tables, stale, shared.n_wk, shared.n_k,
            torch.full((8,), 0.1), lay.rows, lay.docs, z, local.n_dk, gen,
            mh_steps=2, beta=0.01, beta_bar=0.32, device="cpu"))
    assert torch.equal(runs[0], runs[1])
    assert bool((runs[0] != 0).any())
