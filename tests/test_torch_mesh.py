"""The port's mesh round alone, with its own streams, and Algorithms 2 and
3 against the reference.

* A mirror of ``tests/test_distributed_round.py::
  test_distributed_round_8dev`` on a 2×2 gloo mesh of four CPU processes:
  8 LDA rounds over two server shards (perplexity falls below 0.8×,
  clocks [8, 8], every shard's row mass, counts exact), a dead client
  (clocks [9, 8]), SSP(1) (exact, ``cache_version == 2``), the sorted
  layout, PDP (no shared violation) and HDP (no client-local violation);
  and every rank's statistics equal to every other's.
* ``projection.project_distributed`` on a 1×2 and a 1×4 mesh against the
  reference's Algorithm 1 (``repro.core.projection.project``) on random
  inconsistent integer statistics, bit for bit (the rules are
  row-parallel, the aggregates sums of integer partial sums).
* ``make_on_demand``, the mirror of ``tests/test_projection.py::
  test_on_demand_projection``, equal to the reference's.
* ``examples/distributed_lvm_torch.py --device cpu`` for two rounds.

The mesh's processes import this module to find their functions, so the
reference is imported only inside the tests that read it.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import distributed, family, hdp, lda, pdp, projection
from repro_torch.data.synthetic import (CorpusConfig, make_topic_corpus,
                                        shard_corpus)
from repro_torch.launch.mesh import run_on_mesh

ROOT = Path(__file__).resolve().parents[1]
PPL_KEY = (5,)


def _corpus():
    tokens, mask, _ = make_topic_corpus(CorpusConfig(
        n_topics=8, vocab_size=128, n_docs=64, doc_len=32, seed=0))
    return np.asarray(tokens), np.asarray(mask)


def _init(fam, cfg, parts, dev):
    """Each client's initial locals and the merged statistics, from the
    streams (0, c)."""
    locals_, shared = [], None
    for c, (t, m) in enumerate(parts):
        loc, sh = fam.init_state(cfg, t, m, (0, c))
        locals_.append(loc)
        shared = sh if shared is None else fam.shared_from_dict({
            n: v + fam.stats_dict(sh)[n]
            for n, v in fam.stats_dict(shared).items()})
    return locals_, shared


def _rounds(mesh, dev, cfg, dcfg, rounds, alive=None, key0=0):
    """``rounds`` mesh rounds of ``dcfg`` from a fresh state; returns this
    rank's client's local state, the server, its state and the rank's
    shard."""
    tokens, mask = _corpus()
    c = mesh.get_local_rank("data")
    parts = [(torch.as_tensor(t, device=dev), torch.as_tensor(m, device=dev))
             for t, m in shard_corpus(tokens, mask, 2)]
    fam = family.get(dcfg.model)
    locals_, shared = _init(fam, cfg, parts, dev)
    server = distributed.make_server(cfg, dcfg)
    state = server.init_state(shared, 2)
    round_fn = distributed.make_round_fn(cfg, dcfg, mesh, server=server,
                                         device=dev)
    local = locals_[c]
    for r in range(rounds):
        if (not server.policy.caches or r == 0
                or server.policy.needs_refresh(r, state.cache_version)):
            state = server.refresh_proposal(cfg, state)
        local, state = round_fn(local, state, *parts[c], (key0, r),
                                alive or [1, 1])
    return local, server, state, parts[c], round_fn


def _exact(fam, cfg, mesh, local, shard, stats) -> float:
    """max |Σ_clients count(z) − counts| over the data group."""
    name = "m_wk" if fam.name == "pdp" else "n_wk"
    mine = fam.count_stats(cfg, *shard, local)[name]
    torch.distributed.all_reduce(mine, group=mesh.get_group("data"))
    return float((mine - stats[name]).abs().max())


def mirror_rank(mesh, dev) -> dict:
    """The reference test's checks, on one rank."""
    tokens, mask = _corpus()
    ho = (torch.as_tensor(tokens[:16]), torch.as_tensor(mask[:16]))
    out = {}
    cfg = lda.LDAConfig(n_topics=8, vocab_size=128, mh_steps=2)
    fam = family.get("lda")
    dcfg = distributed.DistConfig(model="lda", tau=1, n_server_shards=2)
    _, shared0 = _init(fam, cfg, [(torch.as_tensor(t), torch.as_tensor(m))
                                  for t, m in shard_corpus(tokens, mask, 2)],
                       dev)
    out["p0"] = fam.perplexity(cfg, shared0, *ho, PPL_KEY)
    local, server, state, shard, round_fn = _rounds(mesh, dev, cfg, dcfg, 8)
    shared = server.assemble(state)
    out["p1"] = fam.perplexity(cfg, shared, *ho, PPL_KEY)
    out["clocks"] = state.clocks.tolist()
    out["shard_mass"] = [float(m.sum()) for m in server.shard_row_mass(state)]
    out["lda_err"] = _exact(fam, cfg, mesh, local, shard,
                            fam.stats_dict(shared))
    out["n_wk"] = shared.n_wk.numpy()
    state = server.refresh_proposal(cfg, state)
    _, state2 = round_fn(local, state, *shard, (0, 99), [1, 0])
    out["p2"] = fam.perplexity(cfg, server.assemble(state2), *ho, PPL_KEY)
    out["dead_clocks"] = state2.clocks.tolist()

    ssp = distributed.DistConfig(model="lda", tau=1, consistency="ssp:1")
    local, server, state, shard, _ = _rounds(mesh, dev, cfg, ssp, 4,
                                             key0=500)
    out["ssp_err"] = _exact(fam, cfg, mesh, local, shard,
                            fam.stats_dict(server.assemble(state)))
    out["ssp_version"] = state.cache_version

    srt = distributed.DistConfig(model="lda", tau=1, layout="sorted")
    local, server, state, shard, _ = _rounds(mesh, dev, cfg, srt, 1,
                                             key0=400)
    out["sorted_err"] = _exact(fam, cfg, mesh, local, shard,
                               fam.stats_dict(server.assemble(state)))
    out["sorted_ppl"] = fam.perplexity(cfg, server.assemble(state), *ho,
                                       PPL_KEY)

    pcfg = pdp.PDPConfig(n_topics=8, vocab_size=128, mh_steps=2,
                         stirling_n_max=128, concentration=5.0)
    pfam = family.get("pdp")
    local, server, state, shard, _ = _rounds(
        mesh, dev, pcfg, distributed.DistConfig(model="pdp"), 2, key0=200)
    shared = server.assemble(state)
    out["pdp_ppl"] = pfam.perplexity(pcfg, shared, *ho, PPL_KEY)
    out["pdp_violations"] = pfam.count_violations(shared)
    out["pdp_err"] = _exact(pfam, pcfg, mesh, local, shard,
                            pfam.stats_dict(shared))

    hcfg = hdp.HDPConfig(n_topics=8, vocab_size=128, b1=2.0, mh_steps=2)
    hfam = family.get("hdp")
    local, server, state, shard, _ = _rounds(
        mesh, dev, hcfg, distributed.DistConfig(model="hdp"), 2, key0=300)
    out["hdp_ppl"] = hfam.perplexity(hcfg, server.assemble(state), *ho,
                                     PPL_KEY)
    out["hdp_local_violations"] = hfam.count_local_violations(local)
    return out


@pytest.fixture(scope="module")
def mirror():
    return run_on_mesh(mirror_rank, 2, 2, device="cpu")


def test_lda_converges_across_the_mesh(mirror):
    for r in mirror:
        assert r["p1"] < r["p0"] * 0.8, (r["p0"], r["p1"])
        assert r["clocks"] == [8, 8]
        assert all(m > 0 for m in r["shard_mass"]) and len(
            r["shard_mass"]) == 2
        assert r["lda_err"] == 0.0
        np.testing.assert_array_equal(r["n_wk"], mirror[0]["n_wk"])
        assert r["p1"] == mirror[0]["p1"]


def test_dead_client_pushes_nothing(mirror):
    for r in mirror:
        assert np.isfinite(r["p2"]) and r["p2"] < r["p0"]
        assert r["dead_clocks"] == [9, 8]


def test_ssp_and_sorted_stay_exact(mirror):
    for r in mirror:
        assert r["ssp_err"] == 0.0
        assert r["ssp_version"] == 2          # refreshed at clock 0, then 2
        assert r["sorted_err"] == 0.0 and np.isfinite(r["sorted_ppl"])


def test_pdp_and_hdp_hold_their_polytopes(mirror):
    for r in mirror:
        assert np.isfinite(r["pdp_ppl"]) and r["pdp_violations"] == 0.0
        assert r["pdp_err"] == 0.0
        assert np.isfinite(r["hdp_ppl"]) and r["hdp_local_violations"] == 0


def failing_rank(mesh, dev):
    """Rank 1 raises; rank 0 waits for it in a barrier that never ends."""
    if torch.distributed.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    torch.distributed.barrier()


def mismatched_meshes(mesh, dev) -> list[str]:
    """The errors of meshes that do not fit this job's process group."""
    from repro_torch.launch.mesh import make_host_mesh
    errors = []
    for kw in ({"backend": "nccl"}, {"data": 2}):
        try:
            make_host_mesh(device=dev, **kw)
        except ValueError as e:
            errors.append(str(e))
    return errors


def test_make_host_mesh_refuses_another_backend_or_size():
    (errors,) = run_on_mesh(mismatched_meshes, device="cpu")
    assert len(errors) == 2
    assert "'gloo'" in errors[0] and "'nccl'" in errors[0]
    assert "needs 2 ranks" in errors[1]


def test_run_on_mesh_raises_a_ranks_error():
    """A rank's exception reaches the caller with its traceback, and the
    rank left waiting on it in a collective is ended."""
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_on_mesh(failing_rank, 1, 2, device="cpu", timeout=120)


# ------------------------------------------------ Algorithms 2 and 3
def _random_stats(fam_name: str, seed: int, v: int = 24, k: int = 8,
                  d: int = 8) -> dict[str, np.ndarray]:
    """Deliberately inconsistent integer statistics, as relaxed
    consistency produces (``tests/test_projection.py::_random_stats``)."""
    rng = np.random.default_rng(seed)

    def ints(lo, hi, shape):
        return rng.integers(lo, hi, size=shape).astype(np.float32)
    if fam_name == "pdp":
        m, s = ints(-3, 20, (v, k)), ints(-3, 25, (v, k))
        return {"m_wk": m, "s_wk": s, "m_k": m.sum(0), "s_k": s.sum(0)}
    n = ints(-3, 20, (v, k))
    out = {"n_wk": n, "n_k": n.sum(0) + 1.0}
    if fam_name == "hdp":
        out.update(m_dk=ints(-2, 6, (d, k)), n_dk=ints(0, 4, (d, k)))
    return out


RULESETS = {"lda": ("LDA_RULES", "LDA_AGGREGATES", None),
            "pdp": ("PDP_RULES", "PDP_AGGREGATES", None),
            "hdp": ("HDP_RULES", "HDP_AGGREGATES", None),
            # HDP's document statistics replicated on every rank
            "hdp-docs-replicated": ("HDP_RULES", "HDP_AGGREGATES",
                                    {"m_dk": None, "n_dk": None})}


def alg2_rank(mesh, dev, cases: dict) -> dict:
    out = {}
    for name, (stats, rules, aggs, row_specs) in cases.items():
        got = projection.project_distributed(
            {n: torch.as_tensor(v) for n, v in stats.items()},
            getattr(projection, rules), getattr(projection, aggs), mesh,
            "model", row_specs)
        out[name] = {n: v.numpy() for n, v in got.items()}
    return out


@pytest.mark.parametrize("ranks", [2, 4])
def test_project_distributed_equals_algorithm_1(ranks):
    import jax.numpy as jnp

    from repro.core import projection as ref_projection

    cases = {name: (_random_stats(name[:3], seed), rules, aggs, specs)
             for seed, (name, (rules, aggs, specs))
             in enumerate(RULESETS.items())}
    got = run_on_mesh(alg2_rank, 1, ranks, device="cpu", args=(cases,))
    for name, (stats, rules, aggs, _) in cases.items():
        want = ref_projection.project(
            {n: jnp.asarray(v) for n, v in stats.items()},
            getattr(ref_projection, rules), getattr(ref_projection, aggs))
        mine = projection.project(
            {n: torch.as_tensor(v) for n, v in stats.items()},
            getattr(projection, rules), getattr(projection, aggs))
        assert any(not np.array_equal(np.asarray(want[n]), stats[n])
                   for n in stats), "the statistics were infeasible"
        for rank, out in enumerate(got):
            assert set(out[name]) == set(want), (name, rank)
            for n in want:
                np.testing.assert_array_equal(
                    out[name][n], np.asarray(want[n]),
                    err_msg=f"{name} rank {rank} {n}")
                np.testing.assert_array_equal(out[name][n],
                                              mine[n].numpy())


def test_project_distributed_rejects_uneven_rows(monkeypatch):
    class TwoRanks:           # rank 0 of a 2-rank axis, no process group
        def get_group(self, axis):
            return None

        def get_local_rank(self, axis):
            return 0

    monkeypatch.setattr(projection.dist, "get_world_size",
                        lambda group=None: 2)
    stats = {n: torch.as_tensor(v)
             for n, v in _random_stats("lda", 0, v=7).items()}
    with pytest.raises(ValueError, match="multiple"):
        projection.project_distributed(stats, projection.LDA_RULES,
                                       projection.LDA_AGGREGATES, TwoRanks())


def test_on_demand_projection():
    """Algorithm 3: the pull-path filter makes reads safe, leaves the
    aggregates as they were, and equals the reference's."""
    import jax.numpy as jnp

    from repro.core import projection as ref_projection

    stats = _random_stats("pdp", 3)
    on_pull = projection.make_on_demand(projection.PDP_RULES)
    got = on_pull({n: torch.as_tensor(v) for n, v in stats.items()})
    assert float(projection.count_violations(got,
                                             projection.PDP_RULES)) == 0.0
    want = ref_projection.make_on_demand(ref_projection.PDP_RULES)(
        {n: jnp.asarray(v) for n, v in stats.items()})
    for n in want:
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))
    np.testing.assert_array_equal(got["m_k"].numpy(), stats["m_k"])


def test_distributed_example_runs_on_the_cpu(tmp_path, capsys):
    path = ROOT / "examples" / "distributed_lvm_torch.py"
    spec = importlib.util.spec_from_file_location("distributed_lvm_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    res = mod.main(["--device", "cpu", "--rounds", "2", "--clients", "2",
                    "--snapshot-dir", str(tmp_path)])
    assert res.perplexities and np.all(np.isfinite(res.perplexities))
    assert res.violations and all(v == 0 for v in res.violations)
    assert "device=cpu" in capsys.readouterr().out
