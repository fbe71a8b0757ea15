"""Serving on the card (tests marked ``cuda``; they skip without one).

The batched fold-in engine launches kernel 1 (LDA, HDP) or kernel 4 (PDP)
once per chunk, after the document-list build, on a grid of documents
whose sorted runs differ from those of a one-document shard; kernel 1
caches each word's LM row per run.  So on the card the engine must still
equal ``reference_fold_in`` (the family's sweep on a one-document shard)
bit for bit, and a document's result must not depend on its batch-mates
or the admission order.  This file imports no JAX: the GPU machine has
none.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import family as fam_mod
from repro_torch.core import lda
from repro_torch.data.synthetic import CorpusConfig, make_topic_corpus
from repro_torch.engine import Trainer, TrainerConfig
from repro_torch.kernels import _build
from repro_torch.serve import (FoldInEngine, InferRequest, ServeConfig,
                               from_checkpoint, from_trainer,
                               reference_fold_in, result_checksum)
from repro_torch.serve.engine import InferResult

K, V, MAX_LEN, SWEEPS = 64, 512, 64, 3
SWEEP_KERNEL = {"lda": "mhw_sweep_fused", "hdp": "mhw_sweep_fused",
                "pdp": "pdp_sweep_fused"}


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _trained(cfg, dev, tmp_path=None):
    tokens, mask, _ = make_topic_corpus(CorpusConfig(
        n_topics=8, vocab_size=V, n_docs=128, doc_len=48, seed=3))
    tcfg = TrainerConfig(layout="sorted", n_clients=2,
                         snapshot_dir=None if tmp_path is None
                         else str(tmp_path))
    tr = Trainer(cfg, tokens, mask, config=tcfg, seed=0, device=dev)
    for _ in range(2):
        tr.step()
    return tr


def _reqs(n, seed):
    rng = np.random.default_rng(seed)
    return [InferRequest(uid=i, tokens=rng.integers(
        0, V, size=int(rng.integers(3, MAX_LEN + 1))).astype(np.int32),
        seed=500 + i) for i in range(n)]


def _scfg(slots=4):
    return ServeConfig(max_slots=slots, max_len=MAX_LEN, n_sweeps=SWEEPS)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lda", "pdp", "hdp"])
def test_engine_on_card_equals_reference_fold_in(name, cuda_device):
    fam = fam_mod.get(name)
    cfg = fam.config_cls(n_topics=K, vocab_size=V)
    snap = from_trainer(_trained(cfg, cuda_device), device=cuda_device)
    shared = [t.clone() for t in snap.shared]
    reqs = _reqs(7, seed=1)
    _build.reset_launches()
    eng = FoldInEngine(snap, _scfg(), device=cuda_device)
    got = eng.run(reqs)
    assert _build.LAUNCHES[SWEEP_KERNEL[name]] == (
        eng.sweeps_run * cfg.sorted_chunks)
    assert _build.LAUNCHES["doc_topic_lists"] == (
        eng.sweeps_run * cfg.sorted_chunks)
    for req in reqs:
        _, theta, z = reference_fold_in(snap, req.tokens, req.seed,
                                        n_sweeps=SWEEPS, max_len=MAX_LEN,
                                        device=cuda_device)
        want = InferResult(uid=req.uid, theta=theta, assignments=z,
                           n_sweeps=SWEEPS)
        np.testing.assert_array_equal(got[req.uid].assignments, z)
        np.testing.assert_array_equal(got[req.uid].theta, theta)
        assert result_checksum(got[req.uid]) == result_checksum(want)
        assert np.isclose(theta.sum(), 1.0, atol=1e-4)
    assert all(torch.equal(a, b) for a, b in zip(shared, snap.shared))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lda", "pdp", "hdp"])
def test_batch_composition_independence_on_card(name, cuda_device):
    fam = fam_mod.get(name)
    cfg = fam.config_cls(n_topics=K, vocab_size=V)
    snap = from_trainer(_trained(cfg, cuda_device), device=cuda_device)
    reqs = _reqs(6, seed=2)
    solo = FoldInEngine(snap, _scfg(), device=cuda_device).run([reqs[0]])
    pooled = FoldInEngine(snap, _scfg(), device=cuda_device).run(reqs)
    reordered = FoldInEngine(snap, _scfg(slots=3), device=cuda_device).run(
        list(reversed(reqs)))
    assert result_checksum(solo[0]) == result_checksum(pooled[0])
    for uid in range(6):
        assert (result_checksum(pooled[uid])
                == result_checksum(reordered[uid]))


@pytest.mark.cuda
def test_fused_lda_snapshot_on_card(cuda_device):
    cfg = lda.LDAConfig(n_topics=K, vocab_size=V, fused_alias_build=True)
    tr = _trained(cfg, cuda_device)
    _build.reset_launches()
    snap = from_trainer(tr, device=cuda_device)
    assert _build.LAUNCHES["alias_build_fused"] == 1
    got = FoldInEngine(snap, _scfg(), device=cuda_device).run(_reqs(3, 4))
    req = _reqs(3, 4)[2]
    _, theta, z = reference_fold_in(snap, req.tokens, req.seed,
                                    n_sweeps=SWEEPS, max_len=MAX_LEN,
                                    device=cuda_device)
    np.testing.assert_array_equal(got[2].assignments, z)
    np.testing.assert_array_equal(got[2].theta, theta)


@pytest.mark.cuda
def test_checkpoint_round_trip_on_card(cuda_device, tmp_path):
    cfg = lda.LDAConfig(n_topics=K, vocab_size=V)
    tr = _trained(cfg, cuda_device, tmp_path)
    tr.save_snapshot()
    a = from_trainer(tr, device=cuda_device)
    b = from_checkpoint(str(tmp_path), cfg, device=cuda_device)
    for x, y in zip((*a.shared, *a.tables, a.stale),
                    (*b.shared, *b.tables, b.stale)):
        assert x.device.type == "cuda" and torch.equal(x, y)
