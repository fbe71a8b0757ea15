"""The sync-round body, run eagerly (port of ``repro.engine.round``).

One round: pull → per client ``tau`` sweeps against the snapshot → filter
→ push (summed at the BSP barrier) → project → family auxiliaries →, in
incremental mode, the rebuild of the drifted alias rows.  The semantics
are those of the reference's Python loop (``Trainer._step_python``) with
the incremental tail of its compiled round.  There is no trace to compile:
PyTorch runs it op by op, and each sorted chunk is one kernel launch.

RNG: the reference keys sweep s of client c in round r with
``fold_in(key, r*131 + c*17 + s)`` and chunk ch with a further
``fold_in(·, ch)``.  The port keys the same stream by the tuple
(seed, SWEEP, r, c, s, ch) (see :mod:`repro_torch.device`).  The
family's auxiliary step (``post_round``, HDP's CRT tables and θ0) is
keyed (seed, AUX, r), the reference's ``fold_in(key, 9000 + r)``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch import device as device_mod
from repro_torch.core import ps
from repro_torch.core.distributed import filter_push, tau_sweeps


@dataclass(frozen=True)
class RoundConfig:
    """The slice of ``TrainerConfig`` the round body reads."""

    layout: str
    method: str
    n_clients: int
    tau: int
    filter: ps.FilterSpec
    alias_rebuild_rows: int
    alias_rebuild_threshold: float | None

    @classmethod
    def from_trainer(cls, tcfg) -> "RoundConfig":
        return cls(layout=tcfg.layout, method=tcfg.method,
                   n_clients=tcfg.n_clients, tau=tcfg.tau,
                   filter=tcfg.filter,
                   alias_rebuild_rows=tcfg.alias_rebuild_rows,
                   alias_rebuild_threshold=tcfg.alias_rebuild_threshold)


def run_round(server, model_cfg, rcfg: RoundConfig, incremental: bool,
              state, locals_, residuals, shard_tokens, shard_masks, layouts,
              seed: int, r: int, do_project: bool, device):
    """One BSP round; returns (locals', server state', residuals')."""
    fam = server.family
    snapshot, cache, version = server.pull_round(state, r)
    total = None
    new_locals, new_residuals = [], []
    for c in range(rcfg.n_clients):
        keys = [(seed, device_mod.SWEEP, r, c, s) for s in range(rcfg.tau)]
        loc, acc = tau_sweeps(
            model_cfg, fam, locals_[c],
            server.client_view(snapshot, state.client_lag, c),
            state.tables, state.stale, shard_tokens[c], shard_masks[c],
            keys, method=rcfg.method, layout=rcfg.layout,
            sorted_layouts=layouts[c] if layouts is not None else None,
            device=device)
        sent, res = filter_push(fam, acc, rcfg.filter, (seed, r, c),
                                residuals[c])
        new_locals.append(loc)
        new_residuals.append(res)
        if total is None:
            total = sent
        else:
            for n in total:
                total[n] += sent[n]
    pushed = torch.ones(rcfg.n_clients, dtype=torch.int32,
                        device=state.clocks.device)
    state = server.push(state, total, pushed, track_mass=incremental)
    state = server.project(state, do_project)
    new_locals, dense = fam.post_round(model_cfg, new_locals,
                                       server.assemble(state),
                                       (seed, device_mod.AUX, r))
    state = server.load_dense(state, dense)
    state = state._replace(cache=cache, cache_version=version)
    if incremental:
        rows, valid, state = server.consume_changed_rows(
            state, rcfg.alias_rebuild_rows, rcfg.alias_rebuild_threshold)
        tables, stale = fam.rebuild_alias_rows(
            model_cfg, server.assemble(state), state.tables, state.stale,
            rows, valid, device=device)
        state = state._replace(tables=tables, stale=stale)
    return new_locals, state, new_residuals
