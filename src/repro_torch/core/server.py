"""The in-process parameter server and its consistency policies (port of
``repro.core.server``).

Shared statistics whose leading dimension is the vocabulary are split into
contiguous row ranges (:class:`ShardSpec`); aggregates such as ``n_k`` stay
unsharded and are re-derived from the assembled view.  Assembly is pure
concatenation, so any shard count gives the same numbers.  The server also
keeps the per-shard changed-row accounting behind the incremental alias
rebuild and the resident alias proposal (tables + stale dense matrix).

Policies (:class:`Consistency`):

* :class:`BSP`: every pull returns the canonical state as of the end of the
  previous round; pushes are summed at the round barrier.
* :class:`SSP`: clients sample a versioned stale cache and may run up to
  ``bound`` rounds ahead of it; the pull refreshes the cache (in the
  lock-step simulation, the blocking pull) once ``round − version`` would
  exceed the bound.  Read-my-writes: client c samples the cache plus its
  own deltas since the cache version (``client_lag[c]``), so only other
  clients' updates are stale.
* :class:`Async`: each client's push lands at once, so a later client of
  the same round samples it (Gauss-Seidel across clients); pulls never
  block.

State lives in :class:`ServerState`; the :class:`ParameterServer` object is
a frozen configuration and its methods return new states.  The round
updates the state's read-my-writes lag in place, as the reference's
compiled round donates it: a state handed to a round is not read again.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Sequence

import numpy as np
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

    def shard_of(self, row: int) -> int:
        """The shard that owns vocabulary row ``row``."""
        if not 0 <= row < self.n_rows:
            raise IndexError(row)
        return int(np.searchsorted(np.asarray(self.bounds), row,
                                   "right")) - 1

    def row_to_shard(self) -> np.ndarray:
        """(n_rows,) int32 row → shard map."""
        out = np.zeros((self.n_rows,), np.int32)
        for s in range(self.n_shards):
            lo, hi = self.rows_of(s)
            out[lo:hi] = s
        return out

    def split(self, x):
        """A (n_rows, ...) array's per-shard row slices."""
        return tuple(x[lo:hi] for lo, hi in
                     (self.rows_of(s) for s in range(self.n_shards)))


@dataclass(frozen=True)
class Consistency:
    """Base pull/push policy (BSP's behaviour)."""

    kind = "bsp"
    # Does the policy keep a versioned stale cache in ServerState?
    caches = False
    # Do pushes land at once, client by client, within the round?
    immediate = False
    # Staleness bound: a client at round r samples a cache of version v
    # only while r − v <= bound.
    bound = 0

    @property
    def key(self) -> str:
        """Stable name of the policy (``"bsp"``, ``"ssp(2)"``, ``"async"``)."""
        return self.kind

    def needs_refresh(self, round_idx: int, version: int | None) -> bool:
        """Must the cached snapshot be refreshed before round
        ``round_idx``?  Lock-step clients make this a host decision."""
        return True


@dataclass(frozen=True)
class BSP(Consistency):
    """Bulk-synchronous: pull the canonical state of the end of the
    previous round; pushes are summed at the round barrier."""


@dataclass(frozen=True)
class SSP(Consistency):
    """Stale-synchronous parallel with staleness bound ``bound``;
    ``SSP(0)`` refreshes every round, as BSP."""

    bound: int = 1
    kind = "ssp"
    caches = True

    def __post_init__(self):
        if self.bound < 0:
            raise ValueError(f"SSP bound must be >= 0, got {self.bound}")

    @property
    def key(self) -> str:
        return f"ssp({self.bound})"

    def needs_refresh(self, round_idx: int, version: int | None) -> bool:
        return version is None or round_idx - version > self.bound


@dataclass(frozen=True)
class Async(Consistency):
    """Pushes land at once, pulls never block."""

    kind = "async"
    immediate = True


def make_consistency(spec: str | Consistency) -> Consistency:
    """Parse ``TrainerConfig.consistency``: ``"bsp"``, ``"async"``, or
    ``"ssp:<bound>"`` (also ``"ssp(<bound>)"``, and bare ``"ssp"`` for
    bound 1).  A negative bound reaches :class:`SSP`'s check and raises."""
    if isinstance(spec, Consistency):
        return spec
    s = spec.strip().lower()
    if s == "bsp":
        return BSP()
    if s == "async":
        return Async()
    if s.startswith("ssp"):
        rest = s[3:].strip("(): \t")
        try:
            return SSP(bound=int(rest)) if rest else SSP()
        except ValueError as e:
            if "bound" in str(e):     # a bad bound, not unparseable text
                raise
    raise ValueError(f"unknown consistency {spec!r}; expected 'bsp', "
                     "'ssp:<bound>' or 'async'")


class ServerState(NamedTuple):
    """shards: per-shard dicts of row slices; aux: unsharded statistics;
    cache: SSP's versioned stale snapshot (None under BSP and async);
    cache_version: the round of its last refresh; client_lag: SSP's
    read-my-writes lag, per delta statistic the (n_clients, …) stacked
    deltas each client applied since the cache version (None under BSP
    and async); clocks: per-client round clocks, advanced when a client's
    push lands; row_mass: per-shard accumulated L1 row mass of tracked
    pushes; tables/stale: the alias proposal."""

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

    def _copy(self, shared):
        fam = self.family
        return fam.shared_from_dict({n: v.clone() for n, v in
                                     fam.stats_dict(shared).items()})

    def init_state(self, shared, n_clients: int) -> ServerState:
        """The server's first state.  SSP's cache is a copy of ``shared``,
        never a view of the shards."""
        shards, aux = self.split(shared)
        dev = next(iter(aux.values())).device
        cache = client_lag = None
        if self.policy.caches:
            cache = self._copy(shared)
            stats = self.family.stats_dict(shared)
            client_lag = {n: torch.zeros((n_clients,) + tuple(stats[n].shape),
                                         dtype=stats[n].dtype, device=dev)
                          for n in self.family.delta_names}
        return ServerState(
            shards=shards, aux=aux, cache=cache, cache_version=0,
            client_lag=client_lag,
            clocks=torch.zeros(n_clients, dtype=torch.int32, device=dev),
            row_mass=tuple(torch.zeros(hi - lo, dtype=torch.float32,
                                       device=dev)
                           for lo, hi in self._ranges()),
            tables=None, stale=None)

    def snapshot(self, state: ServerState):
        """The canonical statistics, fresh whatever the policy."""
        return self.assemble(state)

    def pull(self, state: ServerState,
             keys: Sequence[tuple[str, int]] | None = None):
        """Client pull: with ``keys=None`` the policy's view (SSP the
        cache, BSP and async the canonical state); with
        ``keys=[(stat, shard), ...]`` those shard slices of the canonical
        store."""
        if keys is None:
            return state.cache if self.policy.caches else self.assemble(state)
        return [state.shards[shard][name] for name, shard in keys]

    def reset_lag(self, client_lag, do_refresh: bool):
        """Zeroed read-my-writes lag when the pull refreshes (the fresh
        cache holds every applied push); the lag as it is otherwise."""
        if client_lag is None or not do_refresh:
            return client_lag
        return {n: torch.zeros_like(v) for n, v in client_lag.items()}

    def rejoin_client(self, state: ServerState, c: int) -> ServerState:
        """Client ``c``'s lag row zeroed before it re-enters: it restored
        its locals from a snapshot that holds none of the writes the row
        carried.  The caller forces a fresh pull on the rejoin round.  A
        no-op without a lag (BSP, async).  The row is zeroed in place, as
        the round adds to the lag: the state handed in is not read
        again."""
        if state.client_lag is not None:
            for v in state.client_lag.values():
                v[c] = 0
        return state

    def client_view(self, snapshot, client_lag, c: int):
        """Client c's pull under read-my-writes SSP: the cache plus its
        own lag row; identity without a lag."""
        if client_lag is None:
            return snapshot
        return self.family.apply_delta(
            snapshot, {n: v[c] for n, v in client_lag.items()})

    def pull_round(self, state: ServerState, round_idx: int,
                   do_refresh: bool = True):
        """The round's pull: (snapshot, cache', version').  BSP and async
        pull the canonical state and keep no cache; SSP pulls the cache,
        refreshed to a copy of the canonical state when ``do_refresh``."""
        if not self.policy.caches:
            return self.assemble(state), None, int(round_idx)
        if not do_refresh:
            return state.cache, state.cache, state.cache_version
        cache = self._copy(self.assemble(state))
        return cache, cache, int(round_idx)

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

    def push_sparse(self, state: ServerState, sparse: ps.SparseDelta,
                    clock_inc: torch.Tensor | None = None, *,
                    track_mass: bool = False) -> ServerState:
        """A :class:`~repro_torch.core.ps.SparseDelta` push: densified
        here, then :meth:`push`, so it equals the dense push bit for bit."""
        dense = ps.from_sparse_delta(sparse, self.spec.n_rows)
        return self.push(state, dense, clock_inc, track_mass=track_mass)

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

    def shard_row_mass(self, state: ServerState) -> tuple[torch.Tensor, ...]:
        """Per-shard accumulated row mass."""
        return state.row_mass

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
