"""The per-client round body (port of ``tau_sweeps``, ``filter_push`` and
``filter_push_sparse`` from ``repro.core.distributed``).  The mesh round
and its compressed all-gather (``sync_compressed``) wait for ROADMAP.md
queue A.11.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch import device as device_mod
from repro_torch.core import ps


def tau_sweeps(model_cfg, fam, local, snapshot, tables, stale, tokens, mask,
               sweep_keys, *, method: str = "mhw", layout: str = "scan",
               sorted_layouts=None, device=None,
               sweep_draws: Sequence | None = None):
    """One client's work in a round: a sweep per key in ``sweep_keys``
    against the snapshot, applying its own deltas locally between sweeps,
    then the family's client-local rules.  Returns (local', Σ deltas).

    ``sweep_draws`` (optional) replaces each sweep's own streams (None
    for a sweep that draws its own): on the sorted layout the
    ``chunk_uniforms`` callback of ``ModelFamily.sweep_sorted``, on the
    scan layout the ``position_draws`` callback of the family's sweep."""
    acc = {n: torch.zeros_like(fam.stats_dict(snapshot)[n])
           for n in fam.delta_names}
    shared_local = snapshot
    for s, key in enumerate(sweep_keys):
        draws = sweep_draws[s] if sweep_draws is not None else None
        if layout == "sorted":
            local, deltas = fam.sweep_sorted(
                model_cfg, local, shared_local, tables, stale, tokens, mask,
                key, sorted_layouts, chunk_uniforms=draws, device=device)
        else:
            local, deltas = fam.sweep(
                model_cfg, local, shared_local, tables, stale, tokens, mask,
                key, method=method, layout=layout, device=device,
                position_draws=draws)
        shared_local = fam.apply_delta(shared_local, deltas)
        acc = {n: acc[n] + deltas[n] for n in acc}
    return fam.local_project(local), acc


def filter_push(fam, deltas: dict[str, torch.Tensor], spec: ps.FilterSpec,
                key: device_mod.Key, residual=None, *,
                random_rows: Callable[[int], torch.Tensor | None]
                | None = None):
    """Communication filter and error feedback on a client's accumulated
    delta: the residual is added first, then each statistic is filtered
    (statistic i's random rows from the stream ``fold_in(key, i)``, or
    from ``random_rows(i)`` when that gives them), and what was withheld
    becomes the residual.  Returns (sent, residual'); the dense filter
    passes both through."""
    if spec.kind == "dense":
        return deltas, residual
    if residual is not None:
        deltas = {n: deltas[n] + residual[n] for n in deltas}
    sent = {}
    for i, (n, v) in enumerate(deltas.items()):
        rows = random_rows(i) if random_rows is not None else None
        gen = None
        if spec.kind == "topk" and spec.random_rows > 0 and rows is None:
            gen = device_mod.generator(device_mod.fold_in(key, i), v.device)
        sent[n] = ps.filter_delta(v, spec, gen, random_rows=rows)
    return sent, {n: deltas[n] - sent[n] for n in deltas}


def filter_push_sparse(fam, deltas: dict[str, torch.Tensor],
                       spec: ps.FilterSpec, key: device_mod.Key,
                       residual=None, *, random_rows=None
                       ) -> tuple[ps.SparseDelta, dict | None]:
    """:func:`filter_push` with the sent delta as a
    :class:`~repro_torch.core.ps.SparseDelta` (the same arithmetic, so the
    same residual; ``ps.from_sparse_delta`` rebuilds the sent delta bit
    for bit)."""
    sent, residual = filter_push(fam, deltas, spec, key, residual,
                                 random_rows=random_rows)
    return ps.to_sparse_delta(sent), residual
