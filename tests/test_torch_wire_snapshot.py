"""``serve.snapshot.from_servers`` on the CPU: freezing the statistics of
live shard servers, the port's after a tcp run or the reference's loaded
with the same statistics, gives the tables ``freeze`` builds from the
in-process statistics, bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.net.client import RemoteParameterServer as RefClient
from repro.net.server import serve_shards as ref_serve_shards
from repro_torch import bridge
from repro_torch.engine import Trainer, TrainerConfig
from repro_torch.net.server import serve_shards
from repro_torch.serve import snapshot as snap_mod
from tests.conftest import make_family_cfg, make_synthetic_corpus

CPU = "cpu"


def _addrs(servers):
    return tuple("%s:%d" % s.address for s in servers)


def _same(a, b):
    fa, fb = a.family.stats_dict(a.shared), b.family.stats_dict(b.shared)
    for n in fa:
        assert torch.equal(fa[n], fb[n]), n
    for f in a.tables._fields:
        assert torch.equal(getattr(a.tables, f), getattr(b.tables, f)), f
    assert torch.equal(a.stale, b.stale)


@pytest.mark.parametrize("family_name", ["lda", "pdp"])
def test_from_servers_equals_freeze(family_name):
    tokens, mask, _ = make_synthetic_corpus(n_topics=4, vocab=64, n_docs=16,
                                            doc_len=12, seed=3)
    tokens, mask = np.asarray(tokens), np.asarray(mask)
    cfg = bridge.config_from(make_family_cfg(family_name, n_topics=4,
                                             vocab_size=64))
    inproc = Trainer(cfg, tokens, mask, device=CPU,
                     config=TrainerConfig(layout="sorted", n_clients=2))
    for _ in range(3):
        inproc.step()
    want = snap_mod.freeze(cfg, inproc.shared, CPU)

    servers = serve_shards(family_name, vocab_size=64, n_clients=2,
                           n_shards=2, device=CPU)
    try:
        tr = Trainer(cfg, tokens, mask, device=CPU, config=TrainerConfig(
            layout="sorted", n_clients=2, transport="tcp",
            server_addrs=_addrs(servers)))
        for _ in range(3):
            tr.step()
        got = snap_mod.from_servers(_addrs(servers), cfg, n_clients=2,
                                    min_round=3, device=CPU)
        tr.close()
    finally:
        for s in servers:
            s.close()
    _same(got, want)

    # The reference's shard server, holding the same statistics.
    ref_servers = ref_serve_shards(family_name, vocab_size=64, n_clients=1)
    try:
        with RefClient(_addrs(ref_servers), family=family_name,
                       n_clients=1, vocab_size=64) as rps:
            stats = inproc.family.stats_dict(inproc.shared)
            rps.init_push(0, inproc.family.shared_from_dict(
                {n: v.numpy() for n, v in stats.items()}))
        got_ref = snap_mod.from_servers(_addrs(ref_servers), cfg,
                                        n_clients=1, device=CPU)
    finally:
        for s in ref_servers:
            s.close()
    _same(got_ref, want)
