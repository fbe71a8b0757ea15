"""Communication filters, error feedback and the sparse delta form on the
port: mirrors ``tests/test_ps_filters.py`` and ``tests/test_sparse_delta.py``.

Against the reference: given the reference's random rows (its
``jax.random.randint`` draw, injected through ``random_rows=``),
``compress_delta``, ``filter_delta`` and ``filter_push`` equal
``repro.core.ps`` and ``repro.core.distributed`` bit for bit (the deltas
are float32 integers and the row masses exact; ties in the top-k go to
the lower index on both sides).  Within the port: the sparse form round
trips bit for bit, a sparse push lands on the dense push's bytes, and
error feedback loses no mass.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as ref_dist
from repro.core import family as ref_family
from repro.core import ps as ref_ps
from repro_torch import device as device_mod
from repro_torch.core import distributed, family, ps
from repro_torch.core import server as server_mod
from tests.conftest import make_synthetic_corpus

VOCAB = 64


def _delta(v, k, seed, density=0.3, lo=-3, hi=4):
    rng = np.random.default_rng(seed)
    dense = rng.integers(lo, hi, size=(v, k)).astype(np.float32)
    return dense * (rng.random((v, k)) < density)


def _ref_rows(key, n, v):
    return np.asarray(jax.random.randint(key, (n,), 0, v, jnp.int32))


# (V, K, k_rows, random_rows, seed): ties (small integer masses), repeated
# random rows, a random draw larger than V, and k_rows >= V (passthrough).
CASES = [(40, 12, 5, 3, 0), (16, 4, 3, 12, 1), (8, 3, 2, 20, 2),
         (64, 8, 10, 5, 3), (6, 5, 64, 16, 4), (33, 2, 1, 0, 5)]


@pytest.mark.parametrize("v,k,k_rows,random_rows,seed", CASES)
def test_compress_and_filter_equal_reference(v, k, k_rows, random_rows,
                                             seed):
    delta = _delta(v, k, seed)
    spec = ps.FilterSpec("topk", k_rows=k_rows, random_rows=random_rows)
    rspec = ref_ps.FilterSpec("topk", k_rows=k_rows, random_rows=random_rows)
    key = jax.random.PRNGKey(seed)
    rows = torch.as_tensor(_ref_rows(key, random_rows, v))
    want = ref_ps.compress_delta(jnp.asarray(delta), rspec, key)
    got = ps.compress_delta(torch.as_tensor(delta), spec, random_rows=rows)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    want_d = ref_ps.filter_delta(jnp.asarray(delta), rspec, key)
    got_d = ps.filter_delta(torch.as_tensor(delta), spec, random_rows=rows)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    # every row of the filtered delta is the original row or zero
    for r in range(v):
        assert (np.array_equal(got_d[r].numpy(), delta[r])
                or not got_d[r].any())


@pytest.mark.parametrize("threshold", [0.0, 1.0, 3.0, 7.5])
def test_threshold_filter_equals_reference(threshold):
    delta = _delta(48, 6, 9)
    want = ref_ps.filter_delta(jnp.asarray(delta), ref_ps.FilterSpec(
        "threshold", threshold=threshold), jax.random.PRNGKey(0))
    got = ps.filter_delta(torch.as_tensor(delta), ps.FilterSpec(
        "threshold", threshold=threshold))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    mag = np.abs(delta).sum(-1)
    assert not got.numpy()[mag < threshold].any()


def test_dense_filter_identity():
    delta = torch.randn(8, 4)
    assert ps.filter_delta(delta, ps.FilterSpec()) is delta


@pytest.mark.parametrize("seed", range(4))
def test_topk_keeps_largest_rows(seed):
    delta = torch.as_tensor(_delta(30, 5, seed))
    filt = ps.filter_delta(delta, ps.FilterSpec("topk", k_rows=3))
    mag = delta.abs().sum(-1)
    kept = filt.abs().sum(-1) > 0
    if kept.any() and (~kept).any():
        assert float(mag[kept].min()) >= float(mag[~kept].max())


@pytest.mark.parametrize("k_rows", [1, 3, 6])
def test_error_feedback_conserves_mass(k_rows):
    """residual + Σ sent == the accumulated delta, exactly."""
    delta = torch.as_tensor(_delta(24, 7, k_rows))
    spec = ps.FilterSpec("topk", k_rows=k_rows, random_rows=1)
    residual = torch.zeros_like(delta)
    total = torch.zeros_like(delta)
    for i in range(4):
        acc = residual + delta
        sent = ps.filter_delta(acc, spec, device_mod.generator((0, i), "cpu"))
        residual = acc - sent
        total = total + sent
    assert torch.equal(total + residual, 4 * delta)


def test_small_leaf_passthrough():
    delta = torch.randn(2, 3)
    out = ps.filter_delta(delta, ps.FilterSpec("topk", k_rows=64,
                                               random_rows=16))
    assert torch.equal(out, delta)


def test_random_rows_come_from_the_generator():
    """Without injected rows the draw is the generator's: one seed, one
    selection; the rows stay in [0, V)."""
    delta = torch.as_tensor(_delta(64, 4, 3))
    spec = ps.FilterSpec("topk", k_rows=2, random_rows=8)
    runs = [ps.compress_delta(delta, spec,
                              device_mod.generator((5, 1), "cpu"))
            for _ in range(2)]
    assert torch.equal(runs[0].indices, runs[1].indices)
    assert int(runs[0].indices.min()) >= 0
    assert int(runs[0].indices.max()) < 64
    with pytest.raises(ValueError, match="topk"):
        ps.compress_delta(delta, ps.FilterSpec("threshold"))


# ---------------------------------------------------------------------------
# changed_rows
# ---------------------------------------------------------------------------

def test_changed_rows_edge_cases():
    idx, valid = ps.changed_rows(torch.zeros(16), k_rows=4, threshold=0.0)
    assert idx.shape == (4,) and not bool(valid.any())
    idx, valid = ps.changed_rows(torch.tensor([0.0, 2.0, 0.0, 1.0]),
                                 k_rows=100, threshold=0.0)
    assert set(idx.tolist()) == {0, 1, 2, 3}
    assert set(idx[valid].tolist()) == {1, 3}
    idx, _ = ps.changed_rows(torch.ones(12), 5, 0.5)
    assert idx.tolist() == [0, 1, 2, 3, 4]       # ties to the lower index
    mass = jnp.asarray(np.float32([3, 1, 3, 0, 2, 3, 1]))
    want, _ = ref_ps.changed_rows(mass, 5, 0.5)
    got, _ = ps.changed_rows(torch.as_tensor(np.asarray(mass)), 5, 0.5)
    assert got.tolist() == np.asarray(want).tolist()


# ---------------------------------------------------------------------------
# filter_push against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dense", "threshold", "topk"])
def test_filter_push_equals_reference(kind):
    """PDP's two statistics (i = 0, 1 draw their own rows): the residual is
    added before filtering and residual' = deltas − sent, as the
    reference's."""
    spec_kw = {"dense": {}, "threshold": dict(threshold=2.0),
               "topk": dict(k_rows=5, random_rows=4)}[kind]
    names = ("m_wk", "s_wk")
    deltas = {n: _delta(VOCAB, 6, 10 + i) for i, n in enumerate(names)}
    residual = {n: _delta(VOCAB, 6, 20 + i, density=0.1)
                for i, n in enumerate(names)}
    key = jax.random.PRNGKey(3)
    rfam, fam = ref_family.get("pdp"), family.get("pdp")
    want_sent, want_res = ref_dist.filter_push(
        rfam, {n: jnp.asarray(v) for n, v in deltas.items()},
        ref_ps.FilterSpec(kind, **spec_kw), key,
        {n: jnp.asarray(v) for n, v in residual.items()})
    rows = [torch.as_tensor(_ref_rows(jax.random.fold_in(key, i), 4,
                                      VOCAB)) for i in range(2)]
    got_sent, got_res = distributed.filter_push(
        fam, {n: torch.as_tensor(v) for n, v in deltas.items()},
        ps.FilterSpec(kind, **spec_kw), (0, device_mod.FILTER, 0, 0),
        {n: torch.as_tensor(v) for n, v in residual.items()},
        random_rows=lambda i: rows[i])
    for n in names:
        np.testing.assert_array_equal(got_sent[n].numpy(),
                                      np.asarray(want_sent[n]), err_msg=n)
        if kind == "dense":
            assert got_res is not None and torch.equal(
                got_res[n], torch.as_tensor(residual[n]))
        else:
            np.testing.assert_array_equal(got_res[n].numpy(),
                                          np.asarray(want_res[n]), err_msg=n)
            assert torch.equal(got_sent[n] + got_res[n], torch.as_tensor(
                deltas[n] + residual[n]))


# ---------------------------------------------------------------------------
# The sparse delta form
# ---------------------------------------------------------------------------

def test_sparse_roundtrip_multi_stat_equals_reference():
    rng = np.random.default_rng(0)
    a = np.zeros((10, 4), np.float32)
    b = np.zeros((10, 3), np.float32)
    a[[1, 7]] = rng.normal(size=(2, 4)).astype(np.float32)
    b[[2, 7]] = rng.normal(size=(2, 3)).astype(np.float32)
    sp = ps.to_sparse_delta({"a": torch.as_tensor(a),
                             "b": torch.as_tensor(b)})
    want = ref_ps.to_sparse_delta({"a": a, "b": b})
    assert sp.rows.tolist() == np.asarray(want.rows).tolist() == [1, 2, 7]
    assert sp.rows.dtype == torch.int32
    for n in ("a", "b"):
        np.testing.assert_array_equal(sp.values[n].numpy(),
                                      np.asarray(want.values[n]))
    out = ps.from_sparse_delta(sp, 10)
    np.testing.assert_array_equal(out["a"].numpy(), a)
    np.testing.assert_array_equal(out["b"].numpy(), b)


def test_sparse_roundtrip_zero_and_tiny_values():
    sp = ps.to_sparse_delta({"a": torch.zeros(6, 2)})
    assert sp.rows.numel() == 0
    assert torch.equal(ps.from_sparse_delta(sp, 6)["a"], torch.zeros(6, 2))
    a = np.zeros((8, 2), np.float32)
    a[3] = [-1.0, np.float32(1e-30)]
    a[5] = [0.0, -0.0]
    sp = ps.to_sparse_delta({"a": torch.as_tensor(a)})
    assert sp.rows.tolist() == [3]
    out = ps.from_sparse_delta(sp, 8)["a"].numpy()
    np.testing.assert_array_equal(out[3], a[3])


@pytest.fixture(scope="module")
def corpus():
    tokens, mask, _ = make_synthetic_corpus(n_topics=4, vocab=VOCAB,
                                            n_docs=16, doc_len=12, seed=3)
    return torch.as_tensor(np.asarray(tokens)), torch.as_tensor(
        np.asarray(mask))


def _sweep_deltas(name, corpus):
    tokens, mask = corpus
    fam = family.get(name)
    cfg = fam.config_cls(n_topics=4, vocab_size=VOCAB)
    local, shared = fam.init_state(cfg, tokens, mask, (0,))
    tables, stale = fam.build_alias(cfg, shared)
    _, deltas = fam.sweep(cfg, local, shared, tables, stale, tokens, mask,
                          (1,), layout="sorted", device="cpu")
    return fam, shared, deltas


@pytest.mark.parametrize("name", ["lda", "pdp"])
def test_sparse_roundtrip_real_sweep_deltas(name, corpus):
    _, _, deltas = _sweep_deltas(name, corpus)
    sp = ps.to_sparse_delta(deltas)
    assert 0 < sp.rows.numel() < VOCAB
    out = ps.from_sparse_delta(sp, VOCAB)
    for n, v in deltas.items():
        assert torch.equal(out[n], v), n


@pytest.mark.parametrize("name", ["lda", "pdp"])
@pytest.mark.parametrize("n_shards", [1, 3])
def test_push_sparse_bitexact_with_push(name, n_shards, corpus):
    fam, shared, deltas = _sweep_deltas(name, corpus)
    srv = server_mod.make_server(fam, VOCAB, n_shards=n_shards)
    a = srv.push(srv.init_state(shared, 1), deltas, track_mass=True)
    b = srv.push_sparse(srv.init_state(shared, 1), ps.to_sparse_delta(deltas),
                        track_mass=True)
    for n, v in fam.stats_dict(srv.snapshot(a)).items():
        assert torch.equal(v, fam.stats_dict(srv.snapshot(b))[n]), n
    for x, y in zip(srv.shard_row_mass(a), srv.shard_row_mass(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kind", ["dense", "topk"])
def test_filter_push_sparse_matches_filter_push(kind, corpus):
    fam, _, deltas = _sweep_deltas("lda", corpus)
    spec = ps.FilterSpec(kind, k_rows=4, random_rows=3)
    residual = None if kind == "dense" else {
        n: torch.zeros_like(v) for n, v in deltas.items()}
    key = (7, device_mod.FILTER, 0, 0)
    sent, res = distributed.filter_push(fam, deltas, spec, key, residual)
    sp, res2 = distributed.filter_push_sparse(fam, deltas, spec, key,
                                              residual)
    if res is None:
        assert res2 is None
    else:
        for n in res:
            assert torch.equal(res[n], res2[n])
    dense = ps.from_sparse_delta(sp, VOCAB)
    for n, v in sent.items():
        assert torch.equal(dense[n], v), n
    if kind == "topk":
        assert sp.rows.numel() <= 4 + 3
