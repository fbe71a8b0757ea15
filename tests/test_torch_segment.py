"""Port parity: the sorted layout and the synthetic corpus.

The layout's integer arrays must equal the reference's exactly: the sort
is stable, masked positions sort last as sentinel V, and the padding to
tile_b fixes the stream length.  The corpus must equal the reference's
array for array (same generator draws, in the same order).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import segment as ref_segment
from repro.data import synthetic as ref_synth
from repro_torch.data import segment, synthetic

FIELDS = ("order", "rows", "docs", "real", "vstart", "vcount", "hist",
          "offsets")


def _grid(seed, d, l, v, mask_frac):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, v, size=(d, l)).astype(np.int32)
    mask = rng.random((d, l)) >= mask_frac
    return tokens, mask


@pytest.mark.parametrize("d,l,v,tile_v,tile_b,mask_frac", [
    (16, 12, 64, 16, 64, 0.0),      # no padding needed: 192 = 3 * 64
    (13, 11, 96, 12, 64, 0.3),      # masked positions + pad to tile_b
    (7, 5, 40, 40, 1024, 0.5),      # one tile, pad far beyond B
])
def test_layout_matches_reference(d, l, v, tile_v, tile_b, mask_frac):
    """Every field equals segment.build_layout exactly (tolerance: none,
    they are integers)."""
    tokens, mask = _grid(d * l + v, d, l, v, mask_frac)
    ref = ref_segment.build_layout(jnp.asarray(tokens), jnp.asarray(mask),
                                   v, tile_v=tile_v, tile_b=tile_b)
    got = segment.build_layout(torch.as_tensor(tokens),
                               torch.as_tensor(mask), v, tile_v=tile_v,
                               tile_b=tile_b)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)


def test_chunked_layouts_and_round_trip():
    """Chunk bounds and per-chunk layouts equal the reference's, and
    sort_values/unsort_values invert each other on every chunk."""
    tokens, mask = _grid(5, 10, 17, 50, 0.25)
    bounds = segment.chunk_bounds(17, 4)
    assert bounds == ref_segment.chunk_bounds(17, 4)
    refs = ref_segment.build_chunked_layouts(
        jnp.asarray(tokens), jnp.asarray(mask), 50, bounds=bounds, tile_v=10,
        tile_b=16)
    got = segment.build_chunked_layouts(
        torch.as_tensor(tokens), torch.as_tensor(mask), 50, bounds=bounds,
        tile_v=10, tile_b=16)
    for r, g in zip(refs, got):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(g, f).numpy(),
                                          np.asarray(getattr(r, f)))
        flat = torch.arange(g.order.shape[0], dtype=torch.int32)
        s = segment.sort_values(g, flat, fill=-1)
        assert s.shape[0] == g.rows.shape[0]
        assert bool((s[g.order.shape[0]:] == -1).all())
        back = segment.unsort_values(g, s, torch.zeros_like(flat))
        assert torch.equal(back, flat)


@pytest.mark.parametrize("n_topics,vocab,n_docs,doc_len,seed", [
    (8, 300, 64, 48, 5),       # vocabulary not a power of two
    (16, 4096, 200, 64, 0),    # power of two: the raw-draw path
    (4, 256, 50, 9, 7),
    (3, 64, 40, 2, 10),        # tiny documents
])
def test_corpus_matches_reference(n_topics, vocab, n_docs, doc_len, seed):
    """make_topic_corpus equals the reference array for array."""
    kw = dict(n_topics=n_topics, vocab_size=vocab, n_docs=n_docs,
              doc_len=doc_len, seed=seed)
    ref = ref_synth.make_topic_corpus(ref_synth.CorpusConfig(**kw))
    got = synthetic.make_topic_corpus(synthetic.CorpusConfig(**kw))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)
    for (rt, rm), (gt, gm) in zip(ref_synth.shard_corpus(ref[0], ref[1], 3),
                                  synthetic.shard_corpus(got[0], got[1], 3)):
        np.testing.assert_array_equal(gt, rt)
        np.testing.assert_array_equal(gm, rm)


def test_np_alias_build_matches_reference():
    """The two-pointer Vose build gives the reference's tables bit for
    bit, including all-small and all-large edge rows."""
    rng = np.random.default_rng(0)
    cases = [np.ones(5), np.array([1.0]), np.array([0.0, 0.0, 3.0])]
    cases += [rng.gamma(0.3, size=k) + (rng.random(k) < 0.2)
              for k in (2, 17, 300)]
    for p in cases:
        rp, ra = ref_synth._np_alias_build(p)
        gp, ga = synthetic._np_alias_build(p)
        np.testing.assert_array_equal(gp, rp)
        np.testing.assert_array_equal(ga, ra)
