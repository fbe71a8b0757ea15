"""Port parity for the mesh round beyond LDA's scan layout: the top-k
filter, the sorted layout, PDP, HDP and the compressed transport
``sync_compressed``, each against the reference under ``shard_map`` in a
subprocess, bit for bit.  The harness, its draws and its tolerance (none)
are ``tests/test_torch_mesh_parity.py``'s.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import family, ps
from tests.test_torch_mesh_parity import (DEAD1, LIVE, V, check_round,
                                          drift, run_parity, sync_deltas,
                                          sync_rows)

TOPK = {"kind": "topk", "k_rows": 6, "random_rows": 2}
SYNC = {"ranks": 4, "seed": 11, "filter": TOPK}

# name: family, DistConfig fields, alive flags of each round
SCENARIOS = {
    "lda-topk": ("lda", {"filter": TOPK}, [LIVE, LIVE]),
    "lda-sorted": ("lda", {"layout": "sorted"}, [LIVE, DEAD1]),
    "pdp": ("pdp", {}, [LIVE, LIVE]),
    "hdp": ("hdp", {}, [LIVE, LIVE]),
}


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    return run_parity(tmp_path_factory.mktemp("mesh_families"), SCENARIOS,
                      sync=SYNC)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_mesh_round_equals_the_reference(name, parity):
    last, ref = check_round(name, len(SCENARIOS[name][2]), parity)
    fam = family.get(SCENARIOS[name][0])
    stats = {n: torch.as_tensor(ref[f"{last}/stats/{n}"])
             for n in fam.shared_stats}
    assert fam.count_violations(fam.shared_from_dict(stats)) == 0.0
    z, counted = ref[f"{last}/local/z"], ref[f"{last}/stats/" + (
        "m_wk" if name == "pdp" else "n_wk")]
    if name == "lda-topk":
        # The mesh round discards the filter's residual (ROADMAP C.3):
        # the counts fall behind the assignments, in both packages alike.
        assert drift(z, counted) > 0.0
    elif name == "lda-sorted":
        assert ref[f"{last}/clocks"].tolist() == [2, 1]
    else:
        assert drift(z, counted) == 0.0
    if name == "hdp":
        local = {f: torch.as_tensor(ref[f"{last}/local/{f}"])
                 for f in ("m_dk", "n_dk")}
        assert fam.count_local_violations(fam.local_cls(
            z=torch.as_tensor(z), **local)) == 0.0


def test_sync_compressed_equals_the_reference(parity):
    """Four ranks' integer deltas, top-k 6 + 2 random rows each: every
    rank's result equals the reference's under ``shard_map`` and the sum
    of each rank's compressed delta scattered back in one process."""
    _, ref, _, synced = parity
    deltas, rows = sync_deltas(SYNC), sync_rows(SYNC)
    spec = ps.FilterSpec(**TOPK)
    want = sum(ps.decompress_delta(ps.compress_delta(
        torch.as_tensor(d), spec, random_rows=torch.as_tensor(r)), V,
        d.shape[1]) for d, r in zip(deltas, rows))
    for rank, got in enumerate(synced):
        np.testing.assert_array_equal(got, ref["sync"], err_msg=str(rank))
        np.testing.assert_array_equal(got, want.numpy())
    assert 0 < np.count_nonzero(ref["sync"].any(1)) < V
