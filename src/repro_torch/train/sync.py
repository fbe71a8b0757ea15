"""Stale-synchronous, filter-compressed gradient sync: the paper's
parameter-server communication pattern (eventual consistency + magnitude-
priority filters, §5.3) applied to data-parallel SGD (port of
``repro.train.sync``).

Each client keeps an error-feedback residual of what its filter withheld
so far; every ``sync_every`` steps it pushes the filtered residual (top-k
rows by L1 magnitude plus uniformly drawn anti-starvation rows) and keeps
the rest, so nothing is dropped.  This module holds the filter over a
gradient tree, the push over a mesh's data axis (:func:`make_sync_fns`,
each client a rank of the ``data`` group) and the traffic estimate; the
clients' loop in one process is the example's
(``examples/train_lm_torch.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from repro_torch import device as device_mod
from repro_torch.core import collectives, ps
from repro_torch.models.model import leaves, map2, map_tree, unflatten


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


def make_sync_fns(mesh, scfg: SyncConfig, data_axis: str = "data"):
    """Returns push(residual, key) -> (synced, new_residual), the
    reference's push over the clients of a mesh (a client is a rank of the
    ``data_axis`` group; every rank of the group calls it): the filtered
    residual (:func:`filter_tree` with this client's ``key``), summed over
    the clients, and the residual less what was sent."""
    group = mesh.get_group(data_axis)

    def push(residual: Any, key: device_mod.Key) -> tuple[Any, Any]:
        sent = filter_tree(residual, scfg.filter, key)
        synced = map_tree(lambda s: collectives.all_reduce_sum(
            s.clone(memory_format=torch.contiguous_format), group,
            "sync push"), sent)
        return synced, map2(lambda r, s: r - s, residual, sent)

    return push


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
