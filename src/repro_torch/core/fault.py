"""Fault plans (port of ``repro.core.fault``): scripted and seeded-random
failures over clients and rounds, resolved on the host once per round.

A :class:`FaultPlan` is a frozen schedule of :class:`FaultEvent`\\ s.
:meth:`FaultPlan.resolve` turns it, for one round, into a
:class:`RoundFaults` record of per-client flags that the round reads.
Four round kinds (``ROUND_KINDS``):

``crash``
    The client is gone for ``[start, stop)``: it neither samples nor
    pushes, its locals, residuals and read-my-writes lag are frozen, and
    its server clock stops.  At round ``stop`` it rejoins: the Trainer
    restores its locals from the latest snapshot when snapshots are on,
    clears its lag row and forces a fresh pull.  A snapshot older than the
    crash loses the client's unsnapshotted moves, so the consistency error
    may be non-zero after such a rejoin.

``straggle``
    Within ``[start, stop)`` the client completes a round only every
    ``period``-th round; on the other rounds it is masked as a dead
    client, but nothing is lost and no rejoin is needed.

``lost_push``
    The client samples and keeps its update, but its filtered delta never
    reaches the server: the mass is lost, not carried in a residual, and
    its clock does not advance.

``failed_pull``
    The shared cache refresh fails for rounds in ``[start, stop)``.  Only
    a caching policy (SSP) has a refresh to fail: the clients keep
    sampling the stale cache while the Trainer retries each round, and
    after ``TrainerConfig.pull_retry_limit`` consecutive failures the
    refresh goes through.  Under BSP and async it does nothing.

The network kinds (``NET_KINDS``: ``conn_drop``, ``frame_truncate``,
``delay``) schedule transport faults on the wire: :meth:`FaultPlan.
net_events` feeds them to :class:`repro_torch.net.chaos.ChaosProxy`, and
:meth:`FaultPlan.resolve` ignores them.  For
them ``client`` is a connection ordinal at the proxy (-1 = every
connection), ``[start, stop)`` a window of frame ordinals, ``period``
fires the action every period-th frame of the window and ``magnitude``
sizes it (the kept fraction of a truncated payload, the seconds of a
delay).

Determinism: :meth:`FaultPlan.random` draws its events at construction
from ``numpy.random.default_rng(seed)``, as the reference does, so both
packages give equal events for equal arguments and resolution is a pure
function of (plan, round).  numpy only, no torch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

ROUND_KINDS = ("crash", "straggle", "lost_push", "failed_pull")
NET_KINDS = ("conn_drop", "frame_truncate", "delay")
KINDS = ROUND_KINDS + NET_KINDS

_NET_MAGNITUDE_DEFAULT = {"conn_drop": 0.0, "frame_truncate": 0.5,
                          "delay": 0.05}


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: ``kind`` applied to ``client`` for rounds in
    ``[start, stop)``.  ``client`` is ignored for ``failed_pull`` (the
    cache refresh is shared).  ``period`` applies to ``straggle`` only
    (the client completes work every ``period``-th round of the window)
    and to the network kinds (the action fires every ``period``-th frame
    of the window; the default of 2 means every other frame — pass
    ``period=1`` for every frame).  For the network kinds
    (``NET_KINDS``) ``client`` is a proxy connection ordinal (-1 = all),
    ``[start, stop)`` is a frame-ordinal window, and ``magnitude`` sizes
    the action (truncate fraction / delay seconds)."""

    kind: str
    client: int = 0
    start: int = 0
    stop: int = 0
    period: int = 2
    magnitude: float = 0.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if self.stop < self.start:
            raise ValueError(f"fault window [{self.start}, {self.stop}) "
                             "is reversed")
        if self.kind in NET_KINDS:
            if self.client < -1:
                raise ValueError("network fault connection ordinal must "
                                 f"be >= -1 (-1 = all), got {self.client}")
            if self.period < 1:
                raise ValueError("network fault period must be >= 1, "
                                 f"got {self.period}")
            if self.magnitude == 0.0 and self.kind != "conn_drop":
                object.__setattr__(self, "magnitude",
                                   _NET_MAGNITUDE_DEFAULT[self.kind])
            if self.kind == "frame_truncate" and not (
                    0.0 <= self.magnitude < 1.0):
                raise ValueError("frame_truncate magnitude is the kept "
                                 "payload fraction and must be in "
                                 f"[0, 1), got {self.magnitude}")
            if self.magnitude < 0.0:
                raise ValueError(f"magnitude must be >= 0, "
                                 f"got {self.magnitude}")
            return
        if self.kind != "failed_pull" and self.client < 0:
            raise ValueError(f"client must be >= 0, got {self.client}")
        if self.kind == "straggle" and self.period < 2:
            raise ValueError("straggle period must be >= 2 (period 1 is "
                             "a healthy client)")

    def active(self, round_idx: int) -> bool:
        return self.start <= round_idx < self.stop


@dataclass(frozen=True)
class RoundFaults:
    """Host-side resolution of a :class:`FaultPlan` for one round — the
    flags the Trainer hands the round.

    alive        per-client: samples and updates its local state this
                 round (False while crashed or mid-straggle).
    push_ok      per-client: its produced delta lands on the server
                 (False additionally under ``lost_push``).  A client's
                 server clock advances iff ``alive & push_ok``.
    pull_failed  the shared cache refresh fails this round (SSP only).
    rejoining    clients whose crash window ends at exactly this round —
                 the Trainer runs the rejoin protocol for them before
                 dispatching the round.
    """

    alive: tuple[bool, ...]
    push_ok: tuple[bool, ...]
    pull_failed: bool = False
    rejoining: tuple[int, ...] = ()

    @property
    def alive_mask(self) -> np.ndarray:
        return np.asarray(self.alive, bool)

    @property
    def push_mask(self) -> np.ndarray:
        return np.asarray(self.push_ok, bool)


_HEALTHY_CACHE: dict[int, RoundFaults] = {}


def healthy(n_clients: int) -> RoundFaults:
    """The no-fault resolution (cached — it is the steady-state value)."""
    rf = _HEALTHY_CACHE.get(n_clients)
    if rf is None:
        rf = _HEALTHY_CACHE[n_clients] = RoundFaults(
            alive=(True,) * n_clients, push_ok=(True,) * n_clients)
    return rf


@dataclass(frozen=True)
class FaultPlan:
    """A schedule of :class:`FaultEvent`\\ s, resolved per round.

    Frozen and hashable (it rides on ``TrainerConfig``); the empty plan
    is the healthy run.  Construct scripted plans directly or via the
    :meth:`crash` / :meth:`scripted` helpers, random chaos plans via
    :meth:`random`, and the legacy ``drop_client`` tuple via
    :meth:`from_drop_client`.
    """

    events: tuple[FaultEvent, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))
        for e in self.events:
            if not isinstance(e, FaultEvent):
                raise TypeError(f"FaultPlan events must be FaultEvent, "
                                f"got {type(e).__name__}")

    # ------------------------------------------------------------ builders
    @classmethod
    def none(cls) -> "FaultPlan":
        return cls()

    @classmethod
    def scripted(cls, *events: FaultEvent) -> "FaultPlan":
        return cls(events=tuple(events))

    @classmethod
    def crash(cls, client: int, start: int, stop: int) -> "FaultPlan":
        """One client crashed for ``[start, stop)``, rejoining at
        ``stop`` — the kill-and-rejoin scenario."""
        return cls(events=(FaultEvent("crash", client, start, stop),))

    @classmethod
    def from_drop_client(cls, drop: tuple[int, int, int]) -> "FaultPlan":
        """The legacy ``TrainerConfig.drop_client=(id, from, to)`` tuple
        as a one-event plan (same semantics: crash for ``[from, to)``)."""
        client, start, stop = drop
        return cls.crash(int(client), int(start), int(stop))

    @classmethod
    def random(cls, seed: int, n_clients: int, n_rounds: int, *,
               p_crash: float = 0.02, p_straggle: float = 0.02,
               p_lost_push: float = 0.02, p_failed_pull: float = 0.01,
               mean_window: float = 3.0) -> "FaultPlan":
        """A seeded-random chaos schedule, deterministic under ``seed``.

        Per client and round, each per-client hazard fires independently
        with its probability and opens a window of geometric mean length
        ``mean_window`` (at most one concurrent event per client — a
        crashed client cannot also straggle).  ``p_failed_pull`` is the
        per-round hazard of a shared refresh outage.  Events are
        materialized eagerly here, so two plans with equal arguments are
        equal values.
        """
        rng = np.random.default_rng(seed)
        p_stop = 1.0 / max(mean_window, 1.0)
        events: list[FaultEvent] = []
        hazards = (("crash", p_crash), ("straggle", p_straggle),
                   ("lost_push", p_lost_push))
        for c in range(n_clients):
            busy_until = 0
            for r in range(n_rounds):
                if r < busy_until:
                    continue
                for kind, p in hazards:
                    if rng.random() < p:
                        length = 1 + int(rng.geometric(p_stop))
                        stop = min(r + length, n_rounds)
                        events.append(FaultEvent(kind, c, r, stop))
                        busy_until = stop
                        break
        outage_until = 0
        for r in range(n_rounds):
            if r >= outage_until and rng.random() < p_failed_pull:
                length = 1 + int(rng.geometric(p_stop))
                stop = min(r + length, n_rounds)
                events.append(FaultEvent("failed_pull", 0, r, stop))
                outage_until = stop
        return cls(events=tuple(events))

    # ----------------------------------------------------------- resolution
    @property
    def max_client(self) -> int:
        """Largest client id any per-client *round* event names (-1 if
        none) — validated against ``n_clients`` by the Trainer.  Network
        events name connection ordinals, not clients, and are skipped."""
        ids = [e.client for e in self.events
               if e.kind not in NET_KINDS and e.kind != "failed_pull"]
        return max(ids) if ids else -1

    @property
    def last_round(self) -> int:
        """First round from which the plan is permanently healthy (the
        frame-ordinal windows of network events do not count)."""
        return max((e.stop for e in self.events
                    if e.kind not in NET_KINDS), default=0)

    @property
    def net_events(self) -> tuple[FaultEvent, ...]:
        """The transport-level events, for the chaos proxy."""
        return tuple(e for e in self.events if e.kind in NET_KINDS)

    def resolve(self, round_idx: int, n_clients: int) -> RoundFaults:
        """The per-round fault flags — a pure host-side function of
        (plan, round): see :class:`RoundFaults` for field semantics."""
        if not self.events or round_idx > self.last_round:
            return healthy(n_clients)
        alive = [True] * n_clients
        push_ok = [True] * n_clients
        pull_failed = False
        rejoining: set[int] = set()
        for e in self.events:
            if e.kind in NET_KINDS:
                continue  # transport-level: resolved by the chaos proxy
            if e.kind == "failed_pull":
                pull_failed = pull_failed or e.active(round_idx)
                continue
            c = e.client
            if c >= n_clients:
                raise ValueError(
                    f"fault event {e} names client {c} but the run has "
                    f"only {n_clients} clients")
            if e.kind == "crash":
                if e.active(round_idx):
                    alive[c] = False
                    push_ok[c] = False
                elif e.stop == round_idx and e.start < e.stop:
                    rejoining.add(c)
            elif e.kind == "straggle":
                if e.active(round_idx) and (round_idx - e.start) % e.period:
                    alive[c] = False
                    push_ok[c] = False
            elif e.kind == "lost_push":
                if e.active(round_idx):
                    push_ok[c] = False
        # A client crashed by an overlapping event does not rejoin yet.
        rejoin = tuple(sorted(c for c in rejoining if alive[c]))
        return RoundFaults(alive=tuple(alive), push_ok=tuple(push_ok),
                           pull_failed=pull_failed, rejoining=rejoin)
