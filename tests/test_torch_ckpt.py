"""Snapshots on disk: ``repro_torch.checkpoint.ckpt`` mirrors
``tests/test_checkpoint.py`` on torch trees, and a Trainer snapshot
written by either package is read by the other's
``serve.snapshot.from_checkpoint`` into equal shared statistics (the
``server/shards/<s>/<stat>`` and ``server/aux/<stat>`` leaves carry the
same names, dtypes and shapes; counts are float32 and exact, so
"equal" is bit for bit).
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch

from repro.core import family as ref_fam_mod
from repro.core import ps as ref_ps
from repro.engine import Trainer as RefTrainer
from repro.engine import TrainerConfig as RefTrainerConfig
from repro.serve import snapshot as ref_snapshot
from repro_torch import bridge
from repro_torch.checkpoint import ckpt
from repro_torch.core import family as fam_mod
from repro_torch.core import ps
from repro_torch.data.synthetic import CorpusConfig, make_topic_corpus
from repro_torch.engine import Trainer, TrainerConfig
from repro_torch.serve import snapshot as port_snapshot

FAMILIES = ("lda", "pdp", "hdp")


class Pair(NamedTuple):
    first: torch.Tensor
    second: torch.Tensor | None


def tree():
    return {"params": {"w": torch.arange(6.0).reshape(2, 3),
                       "b": torch.zeros(3)},
            "step": torch.tensor(7, dtype=torch.int32),
            "nested": [torch.ones(2), torch.full((1,), 2.0)]}


def _leaves(t):
    return [leaf for _, leaf in ckpt._leaves(t)]


def _equal(a, b) -> bool:
    return all(torch.equal(torch.as_tensor(x), torch.as_tensor(y))
               for x, y in zip(_leaves(a), _leaves(b)))


def test_save_restore_roundtrip(tmp_path):
    t = tree()
    ckpt.save(str(tmp_path), "state", 10, t)
    restored = ckpt.restore(str(tmp_path), "state", t)
    assert len(_leaves(t)) == len(_leaves(restored)) == 5
    assert _equal(t, restored)


def test_latest_step_and_manifest(tmp_path):
    t = tree()
    ckpt.save(str(tmp_path), "state", 5, t)
    ckpt.save(str(tmp_path), "state", 12, t)
    assert ckpt.latest_step(str(tmp_path), "state") == 12
    restored = ckpt.restore(str(tmp_path), "state", t, step=5)
    assert int(restored["step"]) == 7
    m = json.load(open(tmp_path / "state.MANIFEST"))
    assert m == {"latest": "state-12.npz", "step": 12, "steps": [5, 12]}


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path), "nope", tree())


def test_dtype_preserved_via_template(tmp_path):
    t = {"x": torch.tensor([1, 2], dtype=torch.int32),
         "y": torch.tensor([1.5], dtype=torch.bfloat16)}
    ckpt.save(str(tmp_path), "s", 1, t)
    r = ckpt.restore(str(tmp_path), "s", t)
    assert r["x"].dtype == torch.int32
    assert r["y"].dtype == torch.bfloat16
    assert float(r["y"]) == 1.5


def test_atomic_manifest_survives_partial_writer(tmp_path):
    t = tree()
    ckpt.save(str(tmp_path), "state", 1, t)
    with open(os.path.join(str(tmp_path), "junk.tmp"), "w") as f:
        f.write("partial")
    assert ckpt.latest_step(str(tmp_path), "state") == 1
    restored = ckpt.restore(str(tmp_path), "state", t)
    assert int(restored["step"]) == 7


def test_relocated_snapshot_dir_restores(tmp_path):
    t = tree()
    src = tmp_path / "orig"
    ckpt.save(str(src), "state", 3, t)
    dst = tmp_path / "relocated"
    os.rename(str(src), str(dst))
    restored = ckpt.restore(str(dst), "state", t)
    assert int(restored["step"]) == 7
    manifest = json.load(open(dst / "state.MANIFEST"))
    assert manifest["latest"] == os.path.basename(manifest["latest"])


def test_legacy_manifest_with_joined_path_restores(tmp_path):
    t = tree()
    src = tmp_path / "orig"
    ckpt.save(str(src), "state", 3, t)
    mpath = src / "state.MANIFEST"
    m = json.load(open(mpath))
    m["latest"] = os.path.join(str(src), m["latest"])
    del m["steps"]
    json.dump(m, open(mpath, "w"))
    dst = tmp_path / "relocated"
    os.rename(str(src), str(dst))
    restored = ckpt.restore_latest(str(dst), "state", t)
    assert int(restored["step"]) == 7


def test_template_shape_mismatch_clear_error(tmp_path):
    t = tree()
    ckpt.save(str(tmp_path), "state", 1, t)
    bad = {**t, "params": {**t["params"], "w": torch.zeros(3, 2)}}
    with pytest.raises(ValueError, match=r"params/w.*shape"):
        ckpt.restore(str(tmp_path), "state", bad)


def test_template_missing_leaf_clear_error(tmp_path):
    t = tree()
    ckpt.save(str(tmp_path), "state", 1, t)
    with pytest.raises(ValueError, match="extra"):
        ckpt.restore(str(tmp_path), "state", {**t, "extra": torch.zeros(2)})


def test_template_dtype_kind_mismatch_clear_error(tmp_path):
    ckpt.save(str(tmp_path), "s", 1, {"x": torch.tensor([1.5, 2.5])})
    with pytest.raises(ValueError, match="dtype"):
        ckpt.restore(str(tmp_path), "s",
                     {"x": torch.tensor([1, 2], dtype=torch.int32)})


def test_corrupt_latest_falls_back_to_previous(tmp_path):
    t = tree()
    ckpt.save(str(tmp_path), "state", 1, t)
    t2 = {"params": {k: v + 1 for k, v in t["params"].items()},
          "step": t["step"] + 1, "nested": [x + 1 for x in t["nested"]]}
    path2 = ckpt.save(str(tmp_path), "state", 2, t2)
    with open(path2, "r+b") as f:
        f.truncate(30)
    restored = ckpt.restore_latest(str(tmp_path), "state", t)
    assert int(restored["step"]) == 7
    with pytest.raises(ckpt.CorruptSnapshotError):
        ckpt.restore_latest(str(tmp_path), "state", t, step=2)
    step, raw = ckpt.load_raw(str(tmp_path), "state")
    assert step == 1 and int(raw["step"]) == 7
    path1 = os.path.join(str(tmp_path), "state-1.npz")
    with open(path1, "r+b") as f:
        f.truncate(10)
    with pytest.raises(ckpt.CorruptSnapshotError, match="tried steps"):
        ckpt.restore_latest(str(tmp_path), "state", t)
    with pytest.raises(ckpt.CorruptSnapshotError, match="tried steps"):
        ckpt.load_raw(str(tmp_path), "state")


def _ref_key(path) -> str:
    """The reference's ``ckpt._flatten`` key of a JAX key path."""
    return "/".join(str(getattr(p, "key", getattr(p, "idx",
                                                  getattr(p, "name", p))))
                    for p in path)


def test_flat_keys_follow_the_reference(tmp_path):
    """Dict children by key (sorted), tuple and list children by index,
    NamedTuple children by field name, no leaf for None; the saved keys
    are the ones ``jax.tree_util`` gives the same tree, and restore
    ignores saved leaves the template lacks."""
    t = {"b": (Pair(torch.ones(2), None), [np.int32(3)]),
         "a": {"z": torch.zeros(1), "y": None}, "c": 1.5}
    path = ckpt.save(str(tmp_path), "s", 0, t)
    with np.load(path) as data:
        keys = list(data.files)
    jt = {"b": (Pair(np.ones(2), None), [np.int32(3)]),
          "a": {"z": np.zeros(1), "y": None}, "c": 1.5}
    want = [_ref_key(kp)
            for kp, _ in jax.tree_util.tree_flatten_with_path(jt)[0]]
    assert keys == want == ["a/z", "b/0/first", "b/1/0", "c"]
    part = ckpt.restore(str(tmp_path), "s", {"a": {"z": torch.ones(1)}})
    assert torch.equal(part["a"]["z"], torch.zeros(1))


# ---------------------------------------------------------------------------
# Trainer snapshots across packages
# ---------------------------------------------------------------------------

def _corpus():
    tokens, mask, _ = make_topic_corpus(CorpusConfig(
        n_topics=4, vocab_size=64, n_docs=24, doc_len=16, seed=1))
    return np.asarray(tokens), np.asarray(mask)


def _np_of(nt):
    return {f: np.asarray(getattr(nt, f)) for f in nt._fields}


@pytest.mark.parametrize("name", FAMILIES)
def test_reference_snapshot_read_by_the_port(tmp_path, name):
    ref_fam = ref_fam_mod.get(name)
    rcfg = ref_fam.config_cls(n_topics=4, vocab_size=64)
    tokens, mask = _corpus()
    tr = RefTrainer(rcfg, tokens, mask, config=RefTrainerConfig(
        layout="sorted", n_clients=2, n_server_shards=2,
        snapshot_dir=str(tmp_path)), key=jax.random.PRNGKey(0))
    tr.run(2, eval_every=3)
    tr.save_snapshot()
    snap = port_snapshot.from_checkpoint(
        str(tmp_path), bridge.config_from(rcfg), n_shards=2, device="cpu")
    want = _np_of(tr.shared)
    for stat, value in snap.family.stats_dict(snap.shared).items():
        np.testing.assert_array_equal(value.numpy(), want[stat],
                                      err_msg=stat)
        assert value.dtype == torch.float32
    assert snap.tables.prob.shape[0] == 64


@pytest.mark.parametrize("name", FAMILIES)
def test_port_snapshot_read_by_the_reference(tmp_path, name):
    fam = fam_mod.get(name)
    cfg = fam.config_cls(n_topics=4, vocab_size=64)
    tokens, mask = _corpus()
    tr = Trainer(cfg, tokens, mask, config=TrainerConfig(
        layout="sorted", n_clients=2, n_server_shards=2,
        snapshot_dir=str(tmp_path)), device="cpu")
    for _ in range(2):
        tr.step()
    path = tr.save_snapshot()
    assert path.endswith("trainer-2.npz")
    rcfg = bridge.config_to(cfg, ref_fam_mod.get(name).config_cls)
    snap = ref_snapshot.from_checkpoint(str(tmp_path), rcfg, n_shards=2)
    want = bridge.to_numpy(tr.shared)
    for stat, value in _np_of(snap.shared).items():
        np.testing.assert_array_equal(value, want[stat], err_msg=stat)
    # The shared leaves carry the reference's names, dtypes and shapes.
    with np.load(path) as data:
        shared_keys = sorted(k for k in data.files
                             if k.startswith(("server/shards/",
                                              "server/aux/")))
        dtypes = {k: data[k].dtype for k in shared_keys}
    template, _ = ref_snapshot._shared_template(ref_fam_mod.get(name),
                                                rcfg, 2)
    ref_leaves = {_ref_key(kp): leaf for kp, leaf in
                  jax.tree_util.tree_flatten_with_path(template)[0]}
    assert shared_keys == sorted(ref_leaves)
    assert all(dtypes[k] == ref_leaves[k].dtype for k in shared_keys)


def test_snapshot_every_writes_its_steps(tmp_path):
    """``snapshot_every=2`` over 4 rounds writes steps 2 and 4; without a
    directory ``save_snapshot()`` raises."""
    cfg = fam_mod.get("lda").config_cls(n_topics=4, vocab_size=64)
    tokens, mask = _corpus()
    tr = Trainer(cfg, tokens, mask, config=TrainerConfig(
        layout="sorted", snapshot_every=2, snapshot_dir=str(tmp_path)),
        device="cpu")
    for _ in range(4):
        tr.step()
    m = json.load(open(tmp_path / "trainer.MANIFEST"))
    assert m["steps"] == [2, 4] and m["latest"] == "trainer-4.npz"
    tr = Trainer(cfg, tokens, mask, config=TrainerConfig(layout="sorted"),
                 device="cpu")
    with pytest.raises(ValueError, match="snapshot_dir"):
        tr.save_snapshot()


@pytest.mark.parametrize("name,kw", [
    ("pdp", dict(consistency="ssp:2")),
    ("hdp", dict(consistency="ssp:1")),
    ("lda", dict(filter=ps.FilterSpec("topk", k_rows=8, random_rows=4))),
    ("pdp", dict(filter=ps.FilterSpec("threshold", threshold=2.0)))])
def test_trainer_snapshot_round_trips_policy_leaves(tmp_path, name, kw):
    """SSP's cache and lag, and a filter's residual dicts, come back from a
    Trainer snapshot with their dtypes and shapes; the SSP leaves carry
    the reference's names (``server/cache/<stat>``,
    ``server/client_lag/<stat>``, ``server/cache_version`` as int32)."""
    fam = fam_mod.get(name)
    cfg = fam.config_cls(n_topics=4, vocab_size=64)
    tokens, mask = _corpus()
    tcfg = TrainerConfig(layout="sorted", n_clients=2,
                         snapshot_dir=str(tmp_path), **kw)
    tr = Trainer(cfg, tokens, mask, config=tcfg, device="cpu")
    for _ in range(2):
        tr.step()
    path = tr.save_snapshot()
    back = Trainer.restore(cfg, tokens, mask, config=tcfg, device="cpu")
    want = dict(ckpt._leaves(tr.snapshot_state()))
    got = dict(ckpt._leaves(back.snapshot_state()))
    assert sorted(want) == sorted(got)
    for key, leaf in want.items():
        other = got[key]
        if isinstance(leaf, torch.Tensor):
            assert other.dtype == leaf.dtype and other.shape == leaf.shape, \
                key
            assert torch.equal(other, leaf), key
        else:
            assert np.asarray(other).dtype == np.asarray(leaf).dtype, key
            assert np.array_equal(np.asarray(other), np.asarray(leaf)), key
    with np.load(path) as data:
        files = set(data.files)
        if tr.pstate.cache is not None:
            assert data["server/cache_version"].dtype == np.int32
            for stat in fam.shared_stats:
                assert f"server/cache/{stat}" in files
            for stat in fam.delta_names:
                assert data[f"server/client_lag/{stat}"].shape[0] == 2
        if tr.residuals[0] is not None:
            for c in range(2):
                for stat in fam.delta_names:
                    assert f"residuals/{c}/{stat}" in files


def test_policy_snapshot_leaves_match_the_reference(tmp_path):
    """An SSP run with a top-k filter writes the reference's leaves with
    the reference's dtypes and shapes, but for the run's stream root: the
    reference's ``key`` (a PRNGKey), the port's ``seed``."""
    rcfg = ref_fam_mod.get("lda").config_cls(n_topics=4, vocab_size=64)
    tokens, mask = _corpus()
    kw = dict(layout="sorted", n_clients=2, consistency="ssp:2")
    ref = RefTrainer(rcfg, tokens, mask, key=jax.random.PRNGKey(0),
                     config=RefTrainerConfig(
                         **kw, snapshot_dir=str(tmp_path / "ref"),
                         filter=ref_ps.FilterSpec("topk", k_rows=8,
                                                  random_rows=4)))
    ref.step()
    tr = Trainer(bridge.config_from(rcfg), tokens, mask, device="cpu",
                 config=TrainerConfig(
                     **kw, snapshot_dir=str(tmp_path / "port"),
                     filter=ps.FilterSpec("topk", k_rows=8, random_rows=4)))
    tr.step()
    leaves = []
    for path in (ref.save_snapshot(), tr.save_snapshot()):
        with np.load(path) as data:
            leaves.append({k: (data[k].dtype, data[k].shape)
                           for k in data.files})
    want, got = leaves
    assert set(want) - set(got) == {"key"}
    assert set(got) - set(want) == {"seed"}
    for k in set(want) & set(got):
        assert got[k] == want[k], k
