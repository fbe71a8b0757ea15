"""The per-client round body (port of ``tau_sweeps`` and ``filter_push``
from ``repro.core.distributed``).  The mesh round waits for ROADMAP.md
queue A.11.
"""

from __future__ import annotations

import torch

from repro_torch import device as device_mod
from repro_torch.core import ps


def tau_sweeps(model_cfg, fam, local, snapshot, tables, stale, tokens, mask,
               sweep_keys, *, method: str = "mhw", layout: str = "sorted",
               sorted_layouts=None, device=None):
    """One client's work in a round: a sweep per key in ``sweep_keys``
    against the snapshot, applying its own deltas locally between sweeps,
    then the family's client-local rules.  Returns (local', Σ deltas)."""
    acc = {n: torch.zeros_like(fam.stats_dict(snapshot)[n])
           for n in fam.delta_names}
    shared_local = snapshot
    for key in sweep_keys:
        local, deltas = fam.sweep(model_cfg, local, shared_local, tables,
                                  stale, tokens, mask, key, method=method,
                                  layout=layout,
                                  sorted_layouts=sorted_layouts,
                                  device=device)
        shared_local = fam.apply_delta(shared_local, deltas)
        acc = {n: acc[n] + deltas[n] for n in acc}
    return fam.local_project(local), acc


def filter_push(fam, deltas: dict[str, torch.Tensor], spec: ps.FilterSpec,
                key: device_mod.Key, residual=None):
    """Communication filter and error feedback on a client's accumulated
    delta; returns (sent, residual').  The dense filter passes both
    through."""
    if spec.kind == "dense":
        return deltas, residual
    raise NotImplementedError(spec.kind)
