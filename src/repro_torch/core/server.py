"""The in-process parameter server under BSP (port of
``repro.core.server``).

Shared statistics whose leading dimension is the vocabulary are split into
contiguous row ranges (:class:`ShardSpec`); aggregates such as ``n_k`` stay
unsharded and are re-derived from the assembled view.  Assembly is pure
concatenation, so any shard count gives the same numbers.  The server also
keeps the per-shard changed-row accounting behind the incremental alias
rebuild and the resident alias proposal (tables + stale dense matrix).

Only BSP is ported: SSP and async wait for ROADMAP.md queue A.8.  State
lives in :class:`ServerState`; the :class:`ParameterServer` object is a
frozen configuration and its methods return new states.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.core import ps


@dataclass(frozen=True)
class ShardSpec:
    """``n_rows`` vocabulary rows split into ``n_shards`` balanced
    contiguous ranges."""

    n_rows: int
    n_shards: int = 1

    def __post_init__(self):
        if not 1 <= self.n_shards <= self.n_rows:
            raise ValueError(
                f"n_shards={self.n_shards} must be in [1, {self.n_rows}]")

    @property
    def bounds(self) -> tuple[int, ...]:
        return tuple(i * self.n_rows // self.n_shards
                     for i in range(self.n_shards + 1))

    def rows_of(self, shard: int) -> tuple[int, int]:
        b = self.bounds
        return b[shard], b[shard + 1]


@dataclass(frozen=True)
class Consistency:
    """Base pull/push policy; SSP and Async join it with queue A.8."""

    kind = "bsp"


@dataclass(frozen=True)
class BSP(Consistency):
    """Bulk-synchronous: every pull returns the canonical state as of the
    end of the previous round; pushes are summed at the round barrier."""


def make_consistency(spec: str | Consistency) -> Consistency:
    """Parse ``TrainerConfig.consistency``; only ``"bsp"`` is ported."""
    if isinstance(spec, Consistency):
        return spec
    s = spec.strip().lower()
    if s == "bsp":
        return BSP()
    if s == "async" or s.startswith("ssp"):
        raise NotImplementedError(
            f"consistency {spec!r} is not ported yet (ROADMAP.md queue "
            "A.8); only 'bsp' is")
    raise ValueError(f"unknown consistency {spec!r}; expected 'bsp', "
                     "'ssp:<bound>' or 'async'")


class ServerState(NamedTuple):
    """shards: per-shard dicts of row slices; aux: unsharded statistics;
    cache/cache_version/client_lag: the SSP pull cache (None under BSP);
    clocks: per-client round clocks; row_mass: per-shard accumulated L1
    row mass of tracked pushes; tables/stale: the alias proposal."""

    shards: tuple[dict[str, torch.Tensor], ...]
    aux: dict[str, torch.Tensor]
    cache: Any
    cache_version: int
    client_lag: Any
    clocks: torch.Tensor
    row_mass: tuple[torch.Tensor, ...]
    tables: Any
    stale: Any


@dataclass(frozen=True)
class ParameterServer:
    family: Any
    spec: ShardSpec
    policy: Consistency = BSP()

    def _is_sharded(self, x: torch.Tensor) -> bool:
        return x.dim() == 2 and x.shape[0] == self.spec.n_rows

    def _ranges(self):
        return [self.spec.rows_of(s) for s in range(self.spec.n_shards)]

    def split(self, shared):
        """Dense shared pytree → (per-shard slice dicts, aux dict)."""
        stats = self.family.stats_dict(shared)
        sharded = {n: v for n, v in stats.items() if self._is_sharded(v)}
        aux = {n: v for n, v in stats.items() if n not in sharded}
        shards = tuple({n: sharded[n][lo:hi] for n in sharded}
                       for lo, hi in self._ranges())
        return shards, aux

    def assemble(self, state: ServerState):
        """The canonical dense view (concatenation, no arithmetic)."""
        stats = dict(state.aux)
        for n in state.shards[0]:
            stats[n] = (torch.cat([sh[n] for sh in state.shards], 0)
                        if len(state.shards) > 1 else state.shards[0][n])
        return self.family.shared_from_dict(stats)

    def load_dense(self, state: ServerState, shared) -> ServerState:
        shards, aux = self.split(shared)
        return state._replace(shards=shards, aux=aux)

    def init_state(self, shared, n_clients: int) -> ServerState:
        shards, aux = self.split(shared)
        dev = next(iter(aux.values())).device
        return ServerState(
            shards=shards, aux=aux, cache=None, cache_version=0,
            client_lag=None,
            clocks=torch.zeros(n_clients, dtype=torch.int32, device=dev),
            row_mass=tuple(torch.zeros(hi - lo, dtype=torch.float32,
                                       device=dev)
                           for lo, hi in self._ranges()),
            tables=None, stale=None)

    def snapshot(self, state: ServerState):
        return self.assemble(state)

    def pull_round(self, state: ServerState, round_idx: int,
                   do_refresh: bool = True):
        """(snapshot, cache', version'): BSP pulls the canonical state."""
        return self.assemble(state), None, int(round_idx)

    def client_view(self, snapshot, client_lag, c: int):
        """Client c's pull; identity without a read-my-writes lag."""
        if client_lag is None:
            return snapshot
        return self.family.apply_delta(
            snapshot, {n: v[c] for n, v in client_lag.items()})

    def push(self, state: ServerState, deltas: dict[str, torch.Tensor],
             clock_inc: torch.Tensor | None = None, *,
             track_mass: bool = False) -> ServerState:
        """Apply summed client deltas through the family's apply_delta."""
        dense = self.family.apply_delta(self.assemble(state), deltas)
        state = self.load_dense(state, dense)
        if track_mass:
            state = self.accumulate_mass(state, deltas)
        if clock_inc is not None:
            state = state._replace(
                clocks=state.clocks + clock_inc.to(torch.int32))
        return state

    def accumulate_mass(self, state: ServerState,
                        deltas: dict[str, torch.Tensor]) -> ServerState:
        """Fold a push's per-row L1 mass into the per-shard accounting."""
        mass = sum(deltas[n].abs().sum(-1)
                   for n in self.family.alias_delta_stats)
        return state._replace(row_mass=tuple(
            m + mass[lo:hi] for m, (lo, hi) in zip(state.row_mass,
                                                   self._ranges())))

    def project(self, state: ServerState, do_project: bool = True
                ) -> ServerState:
        """Constraint projection (Algorithm 1) when ``do_project``."""
        if not do_project:
            return state
        return self.load_dense(state,
                               self.family.project(self.assemble(state)))

    def consume_changed_rows(self, state: ServerState, k_rows: int,
                             threshold: float):
        """Global top-``k_rows`` rows by accumulated mass, with the
        validity mask, and the accounting reset."""
        mass = (torch.cat(state.row_mass) if len(state.row_mass) > 1
                else state.row_mass[0])
        rows, valid = ps.changed_rows(mass, k_rows, threshold)
        state = state._replace(row_mass=tuple(
            torch.zeros_like(m) for m in state.row_mass))
        return rows, valid, state

    def refresh_proposal(self, model_cfg, state: ServerState) -> ServerState:
        """Full alias rebuild against the canonical statistics."""
        tables, stale = self.family.build_alias(model_cfg,
                                                self.assemble(state))
        return state._replace(tables=tables, stale=stale)


def make_server(family, vocab_size: int, *, n_shards: int = 1,
                consistency: str | Consistency = "bsp") -> ParameterServer:
    return ParameterServer(family=family, spec=ShardSpec(vocab_size, n_shards),
                           policy=make_consistency(consistency))
