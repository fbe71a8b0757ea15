"""The wire across packages, on the CPU: the port's
``RemoteParameterServer`` against the reference's ``ShardServer`` and the
reference's client against the port's ``ShardServer``, all in threads of
this process.

The same INIT and the same pushes (dense PUSH, PUSH_SPARSE, ghost; a
negative delta that the family's rules clamp at the barrier) leave
bit-equal stores whichever package serves and whichever pushes; SSP's
NOT_MODIFIED answers and versions are the same; a shard snapshot written
by one package's server is restored by the other's and finishes the run
it was cut from.  Tolerance: none (every value is a float32 integer).
"""

from __future__ import annotations

import numpy as np
import pytest

from repro.net.client import RemoteParameterServer as RefClient
from repro.net.server import serve_shards as ref_serve_shards
from repro_torch.core import family as fam_mod
from repro_torch.net.client import RemoteParameterServer
from repro_torch.net.server import serve_shards

TIMEOUT = 30.0
V, K = 64, 4
CPU = "cpu"


def _serve(pkg, family, **kw):
    kw.setdefault("barrier_timeout", TIMEOUT)
    if pkg == "port":
        return serve_shards(family, vocab_size=V, device=CPU, **kw)
    return ref_serve_shards(family, vocab_size=V, **kw)


def _client(pkg, servers, family, **kw):
    addrs = tuple("%s:%d" % s.address for s in servers)
    if pkg == "port":
        return RemoteParameterServer(addrs, family=family, vocab_size=V,
                                     timeout=TIMEOUT, device=CPU, **kw)
    return RefClient(addrs, family=family, vocab_size=V, timeout=TIMEOUT,
                     **kw)


def _close(*servers):
    for group in servers:
        for s in group:
            s.close()


def _init_stats(family, c):
    """Client c's initial statistics: integer rows, aggregates summed."""
    fam = fam_mod.get(family)
    rng = np.random.default_rng(100 + c)
    stats = {n: rng.integers(0, 4, size=(V, K)).astype(np.float32)
             for n in fam.delta_names}
    if family == "pdp":
        stats["s_wk"] = np.minimum(stats["s_wk"], stats["m_wk"])
    for agg in fam.aggregates:
        stats[agg.out] = stats[agg.src].sum(agg.axis)
    return fam.shared_from_dict(stats)


def _delta(family, r, c):
    """Integer deltas in [-2, 2] with whole zero rows (for the sparse
    frame) and negative cells (for the barrier's projection)."""
    fam = fam_mod.get(family)
    rng = np.random.default_rng(1000 + 10 * r + c)
    out = {}
    for n in fam.delta_names:
        d = rng.integers(-2, 3, size=(V, K)).astype(np.float32)
        d[rng.random(V) < 0.5] = 0.0
        out[n] = d
    return out


def _drive(client_pkg, server_pkg, family):
    """INIT two clients, then three BSP rounds mixing dense, sparse and
    ghost pushes; returns the store (pull_keys) and the assembled
    aggregates."""
    fam = fam_mod.get(family)
    servers = _serve(server_pkg, family, n_clients=2, n_shards=2)
    try:
        dense = _client(client_pkg, servers, family, n_clients=2)
        sparse = _client(client_pkg, servers, family, n_clients=2,
                         sparse_push=True)
        dense.init_push(0, _init_stats(family, 0))
        sparse.init_push(1, _init_stats(family, 1))
        plan = {0: (("dense", 0), ("sparse", 1)),
                1: (("ghost", 0), ("dense", 1)),
                2: (("sparse", 0), ("sparse", 1))}
        for r, pushes in plan.items():
            dense.pull(r)
            for how, c in pushes:
                if how == "ghost":
                    dense.push_ghost(r, c)
                else:
                    (dense if how == "dense" else sparse).push(
                        r, c, _delta(family, r, c))
        dense.clock(min_round=3)
        store = dense.pull_keys(list(fam.delta_names))
        snap = fam.stats_dict(dense.snapshot(min_round=3))
        aggs = {a.out: np.asarray(snap[a.out]) for a in fam.aggregates}
        clocks = dense.clock()[1].tolist()
        dense.close()
        sparse.close()
    finally:
        _close(servers)
    return store, aggs, clocks


@pytest.mark.parametrize("family", ["lda", "pdp"])
@pytest.mark.parametrize("client_pkg,server_pkg", [
    ("port", "ref"), ("ref", "port"), ("port", "port")])
def test_stores_equal_across_packages(family, client_pkg, server_pkg):
    want, want_aggs, want_clocks = _drive("ref", "ref", family)
    got, got_aggs, got_clocks = _drive(client_pkg, server_pkg, family)
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
        assert got[n].dtype == want[n].dtype
    for n in want_aggs:
        np.testing.assert_array_equal(got_aggs[n], want_aggs[n], err_msg=n)
    assert got_clocks == want_clocks == [2, 3]
    # The barrier's projection clamped the negative cells.
    assert min(float(v.min()) for v in want.values()) >= 0.0


def _ssp_flow(client_pkg, server_pkg):
    servers = _serve(server_pkg, "lda", n_clients=1, consistency="ssp:2")
    out = []
    try:
        rps = _client(client_pkg, servers, "lda", n_clients=1,
                      consistency="ssp:2")
        rps.init_push(0, _init_stats("lda", 0))
        version = None
        for r in range(6):
            shared, v, refreshed = rps.pull(r, version)
            out.append((bool(refreshed), int(v)))
            if refreshed:
                version = v
                out.append(np.asarray(shared.n_wk).tobytes())
            rps.push(r, 0, {"n_wk": np.abs(_delta("lda", r, 0)["n_wk"])})
        rps.close()
    finally:
        _close(servers)
    return out


@pytest.mark.parametrize("client_pkg,server_pkg", [
    ("port", "ref"), ("ref", "port")])
def test_ssp_not_modified_answers_equal(client_pkg, server_pkg):
    want = _ssp_flow("ref", "ref")
    got = _ssp_flow(client_pkg, server_pkg)
    assert got == want
    flags = [x for x in want if isinstance(x, tuple)]
    assert flags == [(True, 0), (False, 0), (False, 0), (True, 3),
                     (False, 3), (False, 3)]


@pytest.mark.parametrize("writer,reader", [("port", "ref"),
                                           ("ref", "port")])
def test_shard_snapshot_restores_across_packages(writer, reader, tmp_path):
    """Round 0 finalized, round 1 half pushed (a pending delta and a
    ghost-free slot): the writer's shards snapshot, the reader's restore,
    a replayed push dedups against the carried log, and the missing push
    finalizes round 1 to the writer's own result."""
    kw = dict(n_clients=2, n_shards=2, snapshot_dir=str(tmp_path))
    src = _serve(writer, "lda", **kw)
    try:
        rps = _client(writer, src, "lda", n_clients=2)
        rps.init_push(0, _init_stats("lda", 0))
        rps.init_push(1, _init_stats("lda", 1))
        rps.pull(0)
        for c in range(2):
            rps.push(0, c, _delta("lda", 0, c))
        rps.pull(1)
        rps.push(1, 0, _delta("lda", 1, 0))
        for s in src:
            s.snapshot_to()
        rps.push(1, 1, _delta("lda", 1, 1))
        rps.clock(min_round=2)
        want = rps.pull_keys(["n_wk"])["n_wk"]
        rps.close()
    finally:
        _close(src)
    dst = _serve(reader, "lda", restore=True, **kw)
    try:
        assert [s.stats()["server_round"] for s in dst] == [1, 1]
        assert [s.stats()["clocks"] for s in dst] == [[1, 1], [1, 1]]
        rps = _client(reader, dst, "lda", n_clients=2)
        rps.push(1, 0, _delta("lda", 1, 0))     # replay: the recorded ack
        rps.push(1, 1, _delta("lda", 1, 1))
        rps.clock(min_round=2)
        np.testing.assert_array_equal(rps.pull_keys(["n_wk"])["n_wk"],
                                      want)
        rps.close()
    finally:
        _close(dst)
