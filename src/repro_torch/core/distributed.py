"""Distributed collapsed Gibbs sampling on a process mesh (port of
``repro.core.distributed``, paper §5.2-§5.5).

The per-client round body, :func:`tau_sweeps` and :func:`filter_push`, is
shared with the single-process round (``engine/round.py``).  The mesh
round, :func:`make_round_fn`, runs as one process per (data, model) cell of
a ``torch.distributed`` ``DeviceMesh`` (``launch/mesh.py`` makes one and
starts its processes): clients are the ranks of the ``data`` axis, each
with its document shard; the canonical statistics' rows are laid over the
``model`` axis.  A round is:

  1. pull    the policy's view of the server state (BSP and async the
             canonical statistics, SSP its versioned cache plus the
             client's own lag),
  2. sample  ``tau`` sweeps of the client against that view,
  3. filter  the communication filter on the client's delta (the residual
             is discarded, as the reference's mesh round discards it),
  4. push    an ``all_reduce`` of each live client's filtered delta over
             the ``data`` group, applied to the canonical statistics,
  5. project Algorithm 2 over the ``model`` group (one server shard) or
             Algorithm 1 (several), then the server's bookkeeping.

Every rank of a client's data row runs that client, as the reference's
SPMD program runs it on every device of the model axis, so every rank
ends the round with the same server state.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

import torch

from repro_torch import device as device_mod
from repro_torch.core import collectives
from repro_torch.core import family as family_mod
from repro_torch.core import projection, ps
from repro_torch.core import server as server_mod


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


@dataclass(frozen=True)
class DistConfig:
    """The mesh round's configuration (the reference's fields and
    defaults): ``model`` names a family of ``family.FAMILIES``; ``tau``
    sweeps a round; ``consistency`` is ``"bsp"``, ``"ssp:<bound>"`` or
    ``"async"`` (under lock-step async's pushes meet at the same reduce as
    BSP's; what differs is the pull, never a cache); ``n_server_shards``
    vocabulary shards of the server state; ``layout`` ``"scan"`` or
    ``"sorted"`` (MHW only).  ``alias_refresh_every`` is carried for the
    caller, which refreshes the proposal (``server.refresh_proposal``)
    before the rounds it chooses; the round projects whenever
    ``project_every`` is non-zero."""

    model: str = "lda"
    tau: int = 1
    alias_refresh_every: int = 1
    filter: ps.FilterSpec = field(default_factory=ps.FilterSpec)
    project_every: int = 1
    consistency: str = "bsp"
    n_server_shards: int = 1
    layout: str = "scan"


def client_round(model_cfg, fam, dist_cfg: DistConfig, local, snapshot,
                 tables, stale, tokens, mask, key: device_mod.Key,
                 method: str = "mhw", *, sorted_layouts=None, device=None,
                 sweep_draws: Sequence | None = None):
    """One client's work in a mesh round: :func:`tau_sweeps` with sweep s
    keyed ``fold_in(key, s)``.  Returns (local', Σ deltas)."""
    keys = [device_mod.fold_in(key, s) for s in range(dist_cfg.tau)]
    return tau_sweeps(model_cfg, fam, local, snapshot, tables, stale,
                      tokens, mask, keys, method=method,
                      layout=dist_cfg.layout, sorted_layouts=sorted_layouts,
                      device=device, sweep_draws=sweep_draws)


def make_server(model_cfg, dist_cfg: DistConfig
                ) -> server_mod.ParameterServer:
    """The round's parameter server: family, vocabulary shards and policy
    from the configs."""
    return server_mod.make_server(
        family_mod.get(dist_cfg.model), model_cfg.vocab_size,
        n_shards=dist_cfg.n_server_shards,
        consistency=dist_cfg.consistency)


class MeshStreams:
    """Where a mesh round's random numbers come from (the counterpart of
    ``engine.round.RoundStreams`` for one round).  This default draws the
    port's own streams, keyed from the round's key (see
    :func:`make_round_fn`); a replacement with the same methods supplies
    others, as the parity tests do with the reference's draws.

    ``sweep_draws(layout, c, tau)``: for each of client c's ``tau`` sweeps
    the sorted layout's ``chunk_uniforms`` callback or the scan layout's
    ``position_draws`` callback, or None.  ``random_rows(c, i)``: the top-k
    filter's random row ids for client c's statistic i, or None.
    """

    def sweep_draws(self, layout: str, c: int, tau: int) -> list:
        return [None] * tau

    def random_rows(self, c: int, i: int):
        return None


def make_round_fn(model_cfg, dist_cfg: DistConfig, mesh,
                  method: str = "mhw", data_axis: str = "data",
                  model_axis: str = "model",
                  server: server_mod.ParameterServer | None = None, *,
                  device=None, streams: MeshStreams | None = None
                  ) -> Callable:
    """The mesh round, ``round_fn(local, state, tokens, mask, key, alive)
    -> (local', state')``, called on every rank of ``mesh`` (a
    ``DeviceMesh`` with axes ``data_axis`` and ``model_axis``).

    ``local``, ``tokens`` and ``mask`` are this rank's client's: the client
    is the rank's coordinate on ``data_axis``.  ``state`` is the server's
    :class:`~repro_torch.core.server.ServerState`, the same on every rank,
    with its alias proposal refreshed by the caller; ``alive`` the
    (n_clients,) live flags (paper §5.4): a dead client still sweeps, but
    its push is multiplied by 0 and its clock stays.  ``key`` is the
    round's stream key: client c draws from ``fold_in(key, c)``, its sweep
    s from ``fold_in(·, s)`` (a sorted chunk ch from a further
    ``fold_in(·, ch)``) and its filter from ``fold_in(·, 7)``, statistic i
    under it from ``fold_in(·, i)`` (the reference's keying, whose filter
    key is also sweep 7's when ``tau`` > 7).  ``streams`` replaces those
    draws.  Each collective runs in a profiler range of its own
    (:mod:`repro_torch.core.collectives`).

    SSP's refresh predicate is ``max(clocks) − cache_version > bound``
    (``max``, so a dead client cannot freeze the schedule), and a client
    samples the cache plus its own lag row (read-my-writes).  The filter's
    residual is discarded, as in the reference's mesh round: under a
    filter that withholds rows the counts drift from the assignments.
    The sorted layouts of a rank's shard are built on the first round that
    sees its ``tokens`` and reused while the same tensors come back.

    Every rank applies the same summed delta: an ``all_reduce`` of float32
    integer counts below 2^24 is exact in any order, and so is Algorithm
    2's sum of partial column sums.
    """
    fam = family_mod.get(dist_cfg.model)
    if server is None:
        server = make_server(model_cfg, dist_cfg)
    if dist_cfg.layout not in ("scan", "sorted"):
        raise ValueError(f"unknown layout {dist_cfg.layout!r}")
    if dist_cfg.layout == "sorted" and method != "mhw":
        raise ValueError("layout='sorted' requires method='mhw'")
    dev = device_mod.resolve(device)
    streams = streams or MeshStreams()
    data_group = mesh.get_group(data_axis)
    me = mesh.get_local_rank(data_axis)
    n_clients = mesh.shape[mesh.mesh_dim_names.index(data_axis)]
    hoisted: list = [None, None, None]      # tokens, mask, their layouts

    def layouts_of(tokens, mask):
        if dist_cfg.layout != "sorted":
            return None
        if hoisted[0] is not tokens or hoisted[1] is not mask:
            hoisted[:] = [tokens, mask, fam.build_sorted_layouts(
                model_cfg, tokens, mask)]
        return hoisted[2]

    def round_fn(local, state, tokens, mask, key: device_mod.Key, alive):
        live = [bool(a) for a in (alive.tolist() if torch.is_tensor(alive)
                                  else alive)]
        if len(live) != n_clients:
            raise ValueError(f"alive has {len(live)} flags for "
                             f"{n_clients} clients")
        # 1. pull
        clock_now = int(state.clocks.max())
        refresh = (not server.policy.caches
                   or clock_now - state.cache_version > server.policy.bound)
        snapshot, cache, version = server.pull_round(state, clock_now,
                                                     refresh)
        lag = server.reset_lag(state.client_lag, refresh)
        canonical = (server.assemble(state) if server.policy.caches
                     else snapshot)

        # 2-3. sample and filter, this rank's client
        key_c = device_mod.fold_in(key, me)
        local2, deltas = client_round(
            model_cfg, fam, dist_cfg, local,
            server.client_view(snapshot, lag, me), state.tables, state.stale,
            tokens, mask, key_c, method, sorted_layouts=layouts_of(
                tokens, mask), device=dev,
            sweep_draws=streams.sweep_draws(dist_cfg.layout, me,
                                            dist_cfg.tau))
        a = 1.0 if live[me] else 0.0
        sent, _ = filter_push(fam, deltas, dist_cfg.filter,
                              device_mod.fold_in(key_c, 7),
                              random_rows=lambda i: streams.random_rows(me, i))

        # 4. push: the live clients' sum on every rank
        summed = {n: collectives.all_reduce_sum(sent[n] * a, data_group,
                                                f"push {n}")
                  for n in fam.delta_names}
        if lag is not None:
            lag = {n: torch.stack(collectives.all_gather(
                v[me] + deltas[n] * a, data_group, f"lag {n}"))
                for n, v in lag.items()}
        shared = fam.apply_delta(canonical, summed)

        # 5. project
        stats = fam.stats_dict(shared)
        if dist_cfg.project_every and server.spec.n_shards == 1:
            row_specs = {n: model_axis if v.dim() == 2 else None
                         for n, v in stats.items()}
            stats = _project_alg2(stats, fam.shared_rules, fam.aggregates,
                                  mesh, model_axis, row_specs)
        elif dist_cfg.project_every:
            stats = projection.project(stats, fam.shared_rules,
                                       fam.aggregates)
        state2 = server.load_dense(state, fam.shared_from_dict(stats))
        state2 = server.accumulate_mass(state2, summed)
        clocks = state.clocks + torch.tensor(
            live, dtype=torch.int32, device=state.clocks.device)
        return local2, state2._replace(cache=cache, cache_version=version,
                                       client_lag=lag, clocks=clocks)

    return round_fn


def _project_alg2(stats, rules, aggregates, mesh, model_axis, row_specs):
    """Algorithm 2 over ``model_axis`` with the rules whose operands are
    all elementwise statistics (no aggregate's output)."""
    outs = {a.out for a in aggregates}
    elem = {n for n in stats if n not in outs}
    rules = [r for r in rules
             if r.a in elem and (r.b is None or r.b in elem)]
    return projection.project_distributed(stats, rules, aggregates, mesh,
                                          model_axis, row_specs)


def sync_compressed(delta: torch.Tensor, spec: ps.FilterSpec,
                    key: device_mod.Key, group, *,
                    random_rows: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """The compressed transport, called on every rank of ``group`` (the
    data group): this rank's (V, K) ``delta`` through
    :func:`ps.compress_delta` (random rows from ``key``'s stream, or
    ``random_rows``), the indices and rows ``all_gather``ed over the
    group, and scatter-added into a zeroed (V, K) in rank order.  The wire
    carries n_clients·k rows instead of V.  Returns the summed delta, the
    same on every rank."""
    gen = None
    if random_rows is None and spec.random_rows > 0:
        gen = device_mod.generator(key, delta.device)
    comp = ps.compress_delta(delta, spec, gen, random_rows=random_rows)
    idx = collectives.all_gather(comp.indices, group, "compressed rows")
    val = collectives.all_gather(comp.values, group, "compressed values")
    return torch.zeros_like(delta).index_add_(0, torch.cat(idx).long(),
                                              torch.cat(val))
