"""Stale-synchronous, filter-compressed gradient sync: the paper's
parameter-server communication pattern (eventual consistency + magnitude-
priority filters, §5.3) applied to data-parallel SGD (port of
``repro.train.sync``).

Each client keeps an error-feedback residual of what its filter withheld
so far; every ``sync_every`` steps it pushes the filtered residual (top-k
rows by L1 magnitude plus uniformly drawn anti-starvation rows) and keeps
the rest, so nothing is dropped.  This module holds the filter over a
gradient tree and the traffic estimate; the clients' loop is the example's
(``examples/train_lm_torch.py``).  The reference's ``make_sync_fns``, the
push over a mesh's data axis, waits for ROADMAP A.13b.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from repro_torch import device as device_mod
from repro_torch.core import ps
from repro_torch.models.model import leaves, unflatten


@dataclass(frozen=True)
class SyncConfig:
    sync_every: int = 1                    # τ: steps between syncs
    filter: ps.FilterSpec = field(default_factory=ps.FilterSpec)


def filter_tree(grads: Any, spec: ps.FilterSpec, key: device_mod.Key) -> Any:
    """Apply the communication filter leaf-wise.  2-D+ leaves filter by
    row-magnitude on their leading dim; 1-D leaves pass through dense (they
    are negligible traffic).  Leaf i (in the tree's flattening order, keys
    sorted) draws its random rows from ``fold_in(key, i)``; ``key`` is a
    ``FILTER``-purpose stream key, e.g. ``(seed, FILTER, step, client)``."""
    def one(i, g):
        if g.ndim < 2 or spec.kind == "dense":
            return g
        gen = device_mod.generator(device_mod.fold_in(key, i), g.device)
        rows = g.reshape(g.shape[0], -1)
        return ps.filter_delta(rows, spec, gen).reshape(g.shape)

    return unflatten(grads, [one(i, g) for i, g in enumerate(leaves(grads))])


def sync_bytes_estimate(params: Any, spec: ps.FilterSpec) -> tuple[int, int]:
    """(dense_bytes, filtered_bytes) one sync round would move per client —
    the napkin math for the collective term."""
    dense = 0
    filtered = 0
    for g in leaves(params):
        nbytes = g.numel() * 4
        dense += nbytes
        if g.ndim >= 2 and spec.kind == "topk":
            rows = g.shape[0]
            row_bytes = (g.numel() // rows) * 4
            kept = min(rows, spec.k_rows + spec.random_rows)
            filtered += kept * row_bytes + kept * 4
        else:
            filtered += nbytes
    return dense, filtered
