"""The sync-round body, run eagerly (port of ``repro.engine.round``).

One round: pull → per live client ``tau`` sweeps against its view of the
snapshot → filter → push → project → family auxiliaries →, in incremental
mode, the rebuild of the drifted alias rows.  The semantics are those of
the reference's compiled round (``_round_impl``), with its clients
iterated as in its Python loop (``Trainer._step_python``), which skips a
dead client; the reference holds the two bit-identical.  There is no trace
to compile: PyTorch runs it op by op, and each sorted chunk is one kernel
launch.

The policy decides the pull and the push: BSP pulls the canonical state
and sums the pushes at the barrier; SSP pulls the versioned cache (a copy
of the canonical state on a refresh round) plus the client's own
read-my-writes lag; async applies each client's push to the snapshot
before the next client pulls it.  Fault masks (``alive``, ``push_ok``,
from :mod:`repro_torch.core.fault`): a dead client keeps its locals,
residual and lag row and pushes nothing; a lost push keeps the client's
update, residual and lag row but drops its delta.  A client's clock
advances when its push lands (``alive & push_ok``).

RNG: the reference keys sweep s of client c in round r with
``fold_in(key, r*131 + c*17 + s)``; a sorted sweep keys chunk ch with a
further ``fold_in(·, ch)``, a scan sweep splits it into one key a position.
The port keys the same streams: a sorted chunk (seed, SWEEP, r, c, s, ch),
a scan sweep one generator (seed, SWEEP, r, c, s) (see
:mod:`repro_torch.device`), drawn in position order, then MH-step order,
then per step u_mix (D,), the sparse term's Gumbel field (D, E), the alias
slot and coin (D,) and the accept uniform (D,) (``core.mhw.StepDraws``);
``exact`` draws one (D, E) Gumbel field a position.  Client c's filter in
round r is keyed (seed, FILTER, r, c), statistic i under it ``fold_in(·,
i)`` (the reference: ``fold_in(key, 7000 + r*131 + c)``, then
``fold_in(·, i)``).
The family's auxiliary step (``post_round``, HDP's CRT tables and θ0) is
keyed (seed, AUX, r), the reference's ``fold_in(key, 9000 + r)``.
:class:`RoundStreams` lets a caller supply the sweeps' draws and the
filter's random rows instead.
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


class RoundStreams:
    """Where a round's random numbers come from.  This default draws the
    port's own streams (keyed as the module docstring says); a replacement
    with the same methods supplies others, as the parity tests do with
    the reference's draws.

    ``chunk_uniforms(r, c, s)``: sweep s of client c in round r's
    ``chunk_uniforms`` callback for ``ModelFamily.sweep_sorted``, or None.
    ``position_draws(r, c, s)``: that scan sweep's callback from position
    i to its draws (a sequence of ``core.mhw.StepDraws`` for ``mhw``, the
    (D, E) Gumbel field for ``exact``), or None.
    ``random_rows(r, c, i)``: the top-k filter's random row ids for
    statistic i of client c in round r, or None.
    """

    def chunk_uniforms(self, r: int, c: int, s: int):
        return None

    def position_draws(self, r: int, c: int, s: int):
        return None

    def sweep_draws(self, layout: str, r: int, c: int, tau: int) -> list:
        """Each of the ``tau`` sweeps' draws callback for ``layout``."""
        fn = (self.chunk_uniforms if layout == "sorted"
              else self.position_draws)
        return [fn(r, c, s) for s in range(tau)]

    def random_rows(self, r: int, c: int, i: int):
        return None


def filter_key(seed: int, r: int, c: int) -> device_mod.Key:
    """The stream key of client c's filter in round r; statistic i draws
    from ``fold_in(filter_key(...), i)``."""
    return (seed, device_mod.FILTER, r, c)


def run_round(server, model_cfg, rcfg: RoundConfig, incremental: bool,
              state, locals_, residuals, shard_tokens, shard_masks, layouts,
              seed: int, r: int, do_project: bool, device, *,
              alive=None, push_ok=None, do_refresh: bool = True,
              streams: RoundStreams | None = None):
    """One round; returns (locals', server state', residuals').

    ``alive`` and ``push_ok`` are per-client flags (all True when None);
    ``do_refresh`` is SSP's refresh decision for this round.  ``state``'s
    read-my-writes lag is updated in place (see :mod:`..core.server`)."""
    fam, pol = server.family, server.policy
    n = rcfg.n_clients
    alive = (True,) * n if alive is None else tuple(map(bool, alive))
    push_ok = (True,) * n if push_ok is None else tuple(map(bool, push_ok))
    streams = streams or RoundStreams()

    snapshot, cache, version = server.pull_round(state, r, do_refresh)
    lag = server.reset_lag(state.client_lag, do_refresh)
    # The push sum: the first landed push, then each later one added out of
    # place, so no client's own delta (the dense filter's `sent`) is ever
    # written through; zeros when none lands.  Its values are the
    # reference's zeros + Σ sent·(alive & push_ok): 0 + x == x for counts.
    total = None
    new_locals, new_residuals = list(locals_), list(residuals)
    for c in range(n):
        if not alive[c]:
            continue                 # frozen: no sweep, no push
        keys = [(seed, device_mod.SWEEP, r, c, s) for s in range(rcfg.tau)]
        loc, acc = tau_sweeps(
            model_cfg, fam, locals_[c], server.client_view(snapshot, lag, c),
            state.tables, state.stale, shard_tokens[c], shard_masks[c],
            keys, method=rcfg.method, layout=rcfg.layout,
            sorted_layouts=layouts[c] if layouts is not None else None,
            device=device,
            sweep_draws=streams.sweep_draws(rcfg.layout, r, c, rcfg.tau))
        if lag is not None:
            # Read-my-writes: the pre-filter delta rides in the client's
            # lag row until the next refresh, lost push or not (it is in
            # the client's own replica either way).
            for name in lag:
                lag[name][c] += acc[name]
        sent, res = filter_push(
            fam, acc, rcfg.filter, filter_key(seed, r, c),
            residuals[c], random_rows=lambda i, c=c: streams.random_rows(
                r, c, i))
        new_locals[c], new_residuals[c] = loc, res
        if not push_ok[c]:
            continue                 # lost push: the delta is dropped
        total = dict(sent) if total is None else {
            name: total[name] + sent[name] for name in total}
        if pol.immediate:            # async: the next client pulls it
            snapshot = fam.apply_delta(snapshot, sent)
    if total is None:
        total = {name: torch.zeros_like(fam.stats_dict(snapshot)[name])
                 for name in fam.delta_names}

    # Clock increments made on the device (a host list would be a blocking
    # host-to-device copy in the middle of the round).
    pushed = torch.ones(n, dtype=torch.int32, device=state.clocks.device)
    for c in range(n):
        if not (alive[c] and push_ok[c]):
            pushed[c] = 0
    if pol.immediate:
        state = server.load_dense(state, snapshot)
        if incremental:
            state = server.accumulate_mass(state, total)
        state = state._replace(clocks=state.clocks + pushed)
    else:
        state = server.push(state, total, pushed, track_mass=incremental)
    state = server.project(state, do_project)
    new_locals, dense = fam.post_round(model_cfg, new_locals,
                                       server.assemble(state),
                                       (seed, device_mod.AUX, r))
    state = server.load_dense(state, dense)
    state = state._replace(cache=cache, cache_version=version,
                           client_lag=lag)
    if incremental:
        rows, valid, state = server.consume_changed_rows(
            state, rcfg.alias_rebuild_rows, rcfg.alias_rebuild_threshold)
        tables, stale = fam.rebuild_alias_rows(
            model_cfg, server.assemble(state), state.tables, state.stale,
            rows, valid, device=device)
        state = state._replace(tables=tables, stale=stale)
    return new_locals, state, new_residuals
