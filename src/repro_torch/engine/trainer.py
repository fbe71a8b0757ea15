"""``Trainer``: the driver loop (port of ``repro.engine.trainer``) for
training any registered family (LDA, PDP, HDP) on the position-scan
layout (the default; ``method="mhw"`` or ``"exact"``) or the token-sorted
layout (``method="mhw"``), in process or over the wire.

Each round: (faults, rejoins) → (alias maintenance) → pull → sample →
client-local rules → filter → push → project → family auxiliaries (HDP's
tables and θ0) → (snapshot), through
:func:`repro_torch.engine.round.run_round`, under the configured policy
(``"bsp"``, ``"ssp:<bound>"`` or ``"async"``; :mod:`repro_torch.core.server`).
Alias tables are rebuilt in full every ``alias_refresh_every`` rounds
(kernel 2, or kernel 6 for ``LDAConfig(fused_alias_build=True)``); under
SSP exactly when the pull refreshes the cache; or, in incremental mode
(``alias_rebuild_threshold`` set), only the drifted rows at the end of
every round (kernel 3 for LDA and HDP, kernel 5 for PDP), with a full
rebuild every ``alias_full_rebuild_every`` rounds.

Faults (``fault_plan``, :mod:`repro_torch.core.fault`) are resolved on
the host each round into the round's ``alive`` and ``push_ok`` flags; a
crashed client rejoins by restoring its locals from the latest snapshot
(``snapshot_every`` and ``snapshot_dir``), clearing its read-my-writes lag
and forcing a fresh pull.  :meth:`Trainer.restore` resumes a run from its
snapshots, bit for bit under BSP.

Over the wire (``transport="tcp"``, :mod:`repro_torch.net`) the shared
statistics live in shard servers: a round pulls them (a versioned cache
refresh, NOT_MODIFIED within SSP's bound), sweeps this process's clients
(``local_clients``) against them, and pushes each client's filtered delta
as a frame that the servers sum at their round barrier in ascending client
id; projection runs there.  Streams stay keyed by the global client id,
so M worker processes together reproduce the single-process run, bit for
bit under BSP.  A fault rides the wire as a ghost push; HDP (whose
auxiliary step needs every client's locals) and incremental rebuilds stay
in process.

The trainer runs on ``cuda`` unless ``device="cpu"`` is passed
(:mod:`repro_torch.device`).  RNG: the trainer's ``seed`` heads every
stream key; client c's initial topics come from (seed, INIT, c), round r's
sweeps from (seed, SWEEP, r, c, s) (and a sorted sweep's chunks from
(seed, SWEEP, r, c, s, chunk); :mod:`repro_torch.engine.round`), its filters from (seed, FILTER,
r, c), and evaluations from (seed, EVAL, 42) — the reference uses
``PRNGKey(42)`` there.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.checkpoint import ckpt
from repro_torch.core import family as family_mod
from repro_torch.core import fault as fault_mod
from repro_torch.core import ps
from repro_torch.core import server as server_mod
from repro_torch.data.synthetic import shard_corpus
from repro_torch.engine import round as round_mod


@dataclass(frozen=True)
class TrainerConfig:
    """The reference's field names and defaults.

    Ported: ``layout`` (``"scan"`` with ``method="mhw"`` or ``"exact"``;
    ``"sorted"`` with ``"mhw"``), ``n_clients``, ``tau``,
    ``consistency`` (``"bsp"``, ``"ssp:<bound>"``, ``"async"``),
    ``n_server_shards``, the alias schedules, ``project_every``, every
    ``filter`` kind, ``fault_plan`` (``drop_client`` is its deprecated
    form), ``snapshot_every``/``snapshot_dir``/``snapshot_name`` and
    ``pull_retry_limit``, and the wire's ``transport``, ``server_addrs``,
    ``local_clients``, ``sparse_push`` and ``reconnect_limit``.  The round
    always runs eagerly: ``compiled=True`` and ``compiled=False`` (the
    reference's Python loop, which it holds bit-identical to its compiled
    round) run the same round here, and ``compiled=False`` with
    incremental rebuilds raises as in the reference.
    """

    layout: str = "scan"
    method: str = "mhw"
    n_clients: int = 1
    tau: int = 1
    consistency: str = "bsp"
    n_server_shards: int = 1
    compiled: bool = True
    alias_refresh_every: int | None = None
    alias_rebuild_threshold: float | None = None
    alias_rebuild_rows: int = 64
    alias_full_rebuild_every: int = 16
    project_every: int = 1
    filter: ps.FilterSpec = field(default_factory=ps.FilterSpec)
    fault_plan: fault_mod.FaultPlan | None = None
    drop_client: tuple[int, int, int] | None = None
    snapshot_every: int = 0
    snapshot_dir: str | None = None
    snapshot_name: str = "trainer"
    pull_retry_limit: int = 3
    transport: str = "inproc"
    server_addrs: tuple[str, ...] = ()
    local_clients: tuple[int, ...] | None = None
    sparse_push: bool = False
    reconnect_limit: int = 3


@dataclass
class RunResult:
    perplexities: list[float] = field(default_factory=list)
    topics_per_word: list[float] = field(default_factory=list)
    iter_times: list[float] = field(default_factory=list)
    violations: list[float] = field(default_factory=list)
    tokens: int = 0

    @property
    def tokens_per_s(self) -> float:
        """Training throughput over the timed segments; NaN before any."""
        if not self.iter_times:
            return float("nan")
        return self.tokens / max(float(np.mean(self.iter_times)), 1e-9)


class Trainer:
    """Multi-client trainer, in process or over tcp; the family follows
    from the type of ``model_cfg``.

    ``tokens``/``mask`` are (D, L) arrays (numpy or tensors); they are
    split into ``n_clients`` document shards and moved to ``device``.
    ``streams`` (a :class:`repro_torch.engine.round.RoundStreams`)
    replaces the rounds' own random streams, in process and over the wire;
    the parity tests feed the reference's through it.
    """

    def __init__(self, model_cfg, tokens, mask, *,
                 config: TrainerConfig = TrainerConfig(),
                 seed: int = 0, device=None,
                 streams: round_mod.RoundStreams | None = None):
        if config.layout not in ("scan", "sorted"):
            raise ValueError(f"unknown layout {config.layout!r}")
        if config.layout == "sorted" and config.method != "mhw":
            raise ValueError("layout='sorted' requires method='mhw'")
        if config.alias_rebuild_threshold is not None and not config.compiled:
            raise ValueError("incremental alias rebuilds "
                             "(alias_rebuild_threshold) require compiled "
                             "rounds; the reference loop only supports the "
                             "alias_refresh_every cadence")
        if config.transport not in ("inproc", "tcp"):
            raise ValueError(f"unknown transport {config.transport!r}; "
                             "expected 'inproc' or 'tcp'")
        if config.transport == "inproc" and (
                config.server_addrs or config.local_clients is not None
                or config.sparse_push):
            raise ValueError("server_addrs / local_clients / sparse_push "
                             "are tcp-only knobs; set transport='tcp'")
        self.fault_plan = self._resolve_fault_plan(config)
        self.cfg = model_cfg
        self.tcfg = config
        self.family = family_mod.family_of(model_cfg)
        remote_mode = config.transport == "tcp"
        if remote_mode:
            self._validate_tcp(config)
        self.device = device_mod.resolve(device)
        self.seed = int(seed)
        self.streams = streams
        tokens = np.asarray(tokens)
        mask = np.asarray(mask)
        self.tokens = torch.as_tensor(tokens, device=self.device)
        self.mask = torch.as_tensor(mask, device=self.device)
        self.n_tokens = int(mask.sum())
        self.shards = [
            (torch.as_tensor(t, device=self.device),
             torch.as_tensor(m, device=self.device))
            for t, m in shard_corpus(tokens, mask, config.n_clients)]
        # The global client ids this process runs: all of them in process
        # (and for single-process tcp), a subset for one of several worker
        # processes sharing the shard servers.
        self.local_clients = (tuple(range(config.n_clients))
                              if config.local_clients is None
                              else tuple(sorted(config.local_clients)))
        local_set = set(self.local_clients)

        # Over the wire each process computes only its clients' initial
        # statistics and INIT-pushes them; the servers merge them in
        # ascending client id, as _merge_shared does here.
        self.locals_: list = [None] * config.n_clients
        shared = None
        init_stats = {}
        for c, (t, m) in enumerate(self.shards):
            if c not in local_set:
                continue
            loc, sh = self.family.init_state(
                model_cfg, t, m, (self.seed, device_mod.INIT, c))
            self.locals_[c] = loc
            if remote_mode:
                init_stats[c] = sh
            else:
                shared = (sh if shared is None
                          else self._merge_shared(shared, sh))
        self.remote = self.server = self.pstate = None
        if remote_mode:
            from repro_torch.net import client as net_client
            self.remote = net_client.RemoteParameterServer(
                config.server_addrs, family=self.family,
                n_clients=config.n_clients,
                vocab_size=model_cfg.vocab_size,
                consistency=config.consistency,
                sparse_push=config.sparse_push,
                reconnect_limit=config.reconnect_limit,
                local_clients=self.local_clients, device=self.device)
            for c in sorted(init_stats):
                self.remote.init_push(c, init_stats[c])
            stats = self.family.stats_dict(init_stats[self.local_clients[0]])
        else:
            self.server = server_mod.make_server(
                self.family, model_cfg.vocab_size,
                n_shards=config.n_server_shards,
                consistency=config.consistency)
            self.pstate = self.server.init_state(shared, config.n_clients)
            stats = self.family.stats_dict(shared)
        # The client edge of the wire: the pulled versioned snapshot (SSP's
        # cache), the alias proposal built from it, and each local client's
        # own read-my-writes lag row.
        self._tcp_snapshot = self._tcp_tables = self._tcp_stale = None
        self._tcp_version: int | None = None
        self._lag: dict[int, dict[str, torch.Tensor]] | None = None
        if remote_mode and self.remote.policy.caches:
            self._lag = {c: {n: torch.zeros_like(stats[n])
                             for n in self.family.delta_names}
                         for c in self.local_clients}
        self.alias_builds = 0
        # Hoisted sorted layouts (the tokens never change between sweeps),
        # for this process's clients only.
        self.layouts = None
        if config.layout == "sorted":
            self.layouts = tuple(
                self.family.build_sorted_layouts(model_cfg, t, m)
                if c in local_set else None
                for c, (t, m) in enumerate(self.shards))
        self.alias_refresh_every = (
            config.alias_refresh_every
            if config.alias_refresh_every is not None
            else getattr(model_cfg, "alias_refresh_every", 1))
        # Error-feedback residuals: zeros for a filter that withholds
        # mass, so what it withholds is carried, never dropped.
        if config.filter.kind != "dense":
            self.residuals: list = [
                {n: torch.zeros_like(stats[n]) for n in self.family.delta_names}
                if c in local_set else None
                for c in range(config.n_clients)]
        else:
            self.residuals = [None] * config.n_clients
        self.round_idx = 0
        self._rcfg = round_mod.RoundConfig.from_trainer(config)
        # Host mirror of SSP's cache version (the lock-step pull schedule
        # is a host decision), the failed-pull retry budget, and counters.
        self._host_version: int | None = None
        self._pull_retries = 0
        self.pull_failures = 0
        self.rejoins = 0

    def _validate_tcp(self, config: TrainerConfig) -> None:
        """Reject what the wire cannot honour, as the reference does:
        servers must be named, incremental rebuilds are in-process
        machinery (tcp rebuilds from the pulled snapshot on the refresh
        schedule), and a family with a cross-client auxiliary step (HDP)
        needs every client's locals at the barrier."""
        if not config.server_addrs:
            raise ValueError("transport='tcp' requires server_addrs "
                             "(host:port shard servers)")
        if config.alias_rebuild_threshold is not None:
            raise ValueError("incremental alias rebuilds are in-process "
                             "machinery; tcp rebuilds from the pulled "
                             "snapshot on the refresh schedule")
        if type(self.family).post_round is not family_mod.ModelFamily.post_round:
            raise NotImplementedError(
                f"family {self.family.name!r} overrides post_round "
                "(cross-client auxiliary resampling at the barrier) — not "
                "servable over the wire; use transport='inproc'")
        if config.local_clients is not None:
            lc = tuple(config.local_clients)
            if not lc or len(set(lc)) != len(lc) or \
                    not all(0 <= c < config.n_clients for c in lc):
                raise ValueError(
                    f"local_clients {lc} must be distinct ids in "
                    f"[0, {config.n_clients})")

    @staticmethod
    def _resolve_fault_plan(config: TrainerConfig) -> fault_mod.FaultPlan:
        """``config.fault_plan``, or the deprecated ``drop_client`` tuple as
        a one-event crash plan."""
        if config.drop_client is not None:
            if config.fault_plan is not None:
                raise ValueError(
                    "TrainerConfig.drop_client and TrainerConfig.fault_plan "
                    "are mutually exclusive — drop_client is the deprecated "
                    "shim; express the crash as FaultPlan.crash(...) inside "
                    "the plan instead")
            warnings.warn(
                "TrainerConfig.drop_client is deprecated; use "
                "fault_plan=FaultPlan.crash(client, start, stop) "
                "(repro_torch.core.fault) — drop_client compiles to exactly "
                "that one-event plan", DeprecationWarning, stacklevel=3)
            return fault_mod.FaultPlan.from_drop_client(config.drop_client)
        if config.fault_plan is None:
            return fault_mod.FaultPlan.none()
        if config.fault_plan.max_client >= config.n_clients:
            raise ValueError(
                f"fault plan names client {config.fault_plan.max_client} "
                f"but the run has only {config.n_clients} clients")
        return config.fault_plan

    def _merge_shared(self, acc, sh):
        """Sum the clients' initial statistics, as the reference does:
        replicated ones (HDP's θ0) come from client 0 alone, although
        HDP's m_k is summed over clients."""
        fam = self.family
        a, b = fam.stats_dict(acc), fam.stats_dict(sh)
        return fam.shared_from_dict({
            n: (a[n] if n in fam.replicated_stats or a[n].dim() == 0
                else a[n] + b[n]) for n in a})

    @property
    def shared(self):
        """The assembled canonical shared statistics.  Over tcp a SNAPSHOT
        round trip that first waits for every stepped round to finalize at
        the servers."""
        if self.remote is not None:
            return self.remote.snapshot(min_round=self.round_idx)
        return self.server.snapshot(self.pstate)

    @property
    def tables(self):
        """The alias proposal's tables: the server state's, over tcp the
        ones this process built from its last pull."""
        return self._tcp_tables if self.remote is not None \
            else self.pstate.tables

    @property
    def stale(self):
        """The proposal's stale dense term, beside :attr:`tables`."""
        return self._tcp_stale if self.remote is not None \
            else self.pstate.stale

    @property
    def clocks(self) -> np.ndarray:
        """Per-client round clocks as the server tracks them."""
        if self.remote is not None:
            return self.remote.clock()[1]
        return self.pstate.clocks.cpu().numpy()

    @property
    def _incremental(self) -> bool:
        return self.tcfg.alias_rebuild_threshold is not None

    def _pull_refresh(self, r: int, *, force: bool = False,
                      failed: bool = False) -> bool:
        """Does round ``r``'s pull refresh the cache?  Always under BSP and
        async (they keep none).  Under SSP when the bound would be
        exceeded, or ``force`` (a rejoin's fresh pull).  A due refresh
        that ``failed`` (the ``failed_pull`` fault) is skipped — the
        clients sample the stale cache past the bound — and retried next
        round, until ``pull_retry_limit`` consecutive failures force it
        through."""
        pol = self.server.policy
        if not pol.caches:
            return True
        if not (force or pol.needs_refresh(r, self._host_version)):
            return False
        if failed and not force \
                and self._pull_retries < self.tcfg.pull_retry_limit:
            self._pull_retries += 1
            self.pull_failures += 1
            return False
        self._pull_retries = 0
        self._host_version = r
        return True

    def _refresh_alias(self, do_refresh: bool) -> None:
        """Full rebuild on the cadence; under SSP when the pull refreshes
        (the proposal is part of the pulled cache); in incremental mode on
        the full-rebuild cadence only (partial rebuilds end each round)."""
        srv, r = self.server, self.round_idx
        if self.pstate.tables is not None:
            if self._incremental:
                every = self.tcfg.alias_full_rebuild_every
                if not (every and r % every == 0):
                    return
            elif srv.policy.caches:
                if not do_refresh:
                    return
            elif r % self.alias_refresh_every != 0:
                return
        self.pstate = srv.refresh_proposal(self.cfg, self.pstate)
        self.alias_builds += 1

    def _round_faults(self) -> fault_mod.RoundFaults:
        """This round's fault flags, with the rejoin protocol already run
        for every client whose crash ends now."""
        rf = self.fault_plan.resolve(self.round_idx, self.tcfg.n_clients)
        if rf.rejoining:
            self._rejoin(rf.rejoining)
        return rf

    def _rejoin(self, clients: tuple[int, ...]) -> None:
        """Restore each rejoining client's locals (and residual) from the
        latest snapshot when there is one (else its frozen in-memory state
        stands in for it) and zero its read-my-writes lag row."""
        snap = self._load_latest_snapshot()
        for c in clients:
            if c not in self.local_clients:
                continue              # another worker process's client
            if snap is not None:
                self.locals_[c] = _to(snap["locals"][c], self.device)
                if self.residuals[c] is not None:
                    self.residuals[c] = _to(snap["residuals"][c],
                                            self.device)
            if self.remote is not None:
                # Over the wire: a REJOIN frame (clear pending pushes and
                # open log entries, lift any eviction); the caller's
                # forced-fresh pull zeroes the lag.
                self.remote.rejoin(c)
            else:
                self.pstate = self.server.rejoin_client(self.pstate, c)
        self.rejoins += len(clients)

    def _load_latest_snapshot(self) -> dict | None:
        """The clients' locals and residuals from the newest readable
        snapshot, or None when snapshots are off or none was written yet.
        When every snapshot is unreadable it warns and returns None."""
        if not self.tcfg.snapshot_dir:
            return None
        template = {"locals": tuple(self.locals_),
                    "residuals": tuple(self.residuals)}
        try:
            return ckpt.restore_latest(self.tcfg.snapshot_dir,
                                       self.tcfg.snapshot_name, template)
        except FileNotFoundError:
            return None
        except ckpt.CorruptSnapshotError as e:
            warnings.warn(f"rejoin falling back to in-memory state: {e}",
                          RuntimeWarning, stacklevel=2)
            return None

    def _sync(self) -> None:
        """Wait for the device and, over tcp, for the servers' barrier to
        finalize every stepped round (a CLOCK with ``min_round``)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self.remote is not None:
            self.remote.clock(min_round=self.round_idx)

    def step(self) -> None:
        """One sync round: (faults) → pull → sample → filter → push →
        project → (snapshot); returns once it is enqueued on the device
        (a fault plan, SSP's schedule or a snapshot may sync; a tcp round
        returns once its pushes are acknowledged)."""
        if self.remote is not None:
            self._step_remote()
        else:
            self._step_local()
        if self.tcfg.snapshot_every and self.tcfg.snapshot_dir \
                and self.round_idx % self.tcfg.snapshot_every == 0:
            self.save_snapshot()

    def _step_local(self) -> None:
        r = self.round_idx
        rf = self._round_faults()
        do_refresh = self._pull_refresh(r, force=bool(rf.rejoining),
                                        failed=rf.pull_failed)
        self._refresh_alias(do_refresh)
        do_project = bool(self.tcfg.project_every
                          and r % self.tcfg.project_every == 0)
        self.locals_, self.pstate, self.residuals = round_mod.run_round(
            self.server, self.cfg, self._rcfg, self._incremental,
            self.pstate, self.locals_, self.residuals,
            [t for t, _ in self.shards], [m for _, m in self.shards],
            self.layouts, self.seed, r, do_project, self.device,
            alive=rf.alive, push_ok=rf.push_ok, do_refresh=do_refresh,
            streams=self.streams)
        self.round_idx += 1

    def _refresh_alias_tcp(self, refreshed: bool) -> None:
        """Alias maintenance at the client edge of the wire: built from the
        pulled snapshot, under SSP exactly when the pull refreshed, under
        BSP and async on the ``alias_refresh_every`` cadence; the pulled
        snapshot of round r holds what ``refresh_proposal`` reads in
        process."""
        if self._tcp_tables is not None:
            if self.remote.policy.caches:
                if not refreshed:
                    return
            elif self.round_idx % self.alias_refresh_every != 0:
                return
        self._tcp_tables, self._tcp_stale = self.family.build_alias(
            self.cfg, self._tcp_snapshot)
        self.alias_builds += 1

    def _step_remote(self) -> None:
        """One round over the wire: the in-process round with the server's
        side of each phase replaced by frames.  The pull is a versioned
        cache refresh; each local client's ``tau`` sweeps run against it
        (plus its own lag under SSP), with the round's streams keyed by
        the global client id; its filtered delta is pushed as a frame the
        servers sum at their barrier; projection runs there.  A dead or
        push-losing client fills its barrier slot with a ghost push; a
        ``failed_pull`` skips the due refresh, bounded by
        ``pull_retry_limit``; a rejoin REJOINs at the servers and forces a
        fresh pull.  Async pulls once a round (the clients of a process
        sweep the same snapshot), as the reference does."""
        fam, cfg, tcfg = self.family, self.cfg, self.tcfg
        r = self.round_idx
        pol = self.remote.policy
        rf = self._round_faults()
        force = bool(rf.rejoining)
        skip_pull = False
        if rf.pull_failed and not force and pol.caches \
                and self._tcp_snapshot is not None \
                and pol.needs_refresh(r, self._host_version) \
                and self._pull_retries < tcfg.pull_retry_limit:
            # The due refresh "fails": sample the stale cache past the
            # bound and retry next round.
            self._pull_retries += 1
            self.pull_failures += 1
            skip_pull = True
        refreshed = False
        if not skip_pull:
            fresh, version, refreshed = self.remote.pull(
                r, None if force else (
                    self._tcp_version if pol.caches else None))
            if refreshed:
                self._tcp_snapshot, self._tcp_version = fresh, version
                self._host_version = version
                self._pull_retries = 0
                if self._lag is not None:
                    # The fresh cache holds every applied push.
                    self._lag = {c: {n: torch.zeros_like(v)
                                     for n, v in row.items()}
                                 for c, row in self._lag.items()}
        self._refresh_alias_tcp(refreshed)
        snapshot = self._tcp_snapshot
        streams = self.streams or round_mod.RoundStreams()
        for c in self.local_clients:
            if not rf.alive[c]:
                # Frozen, no contribution; a ghost fills its barrier slot.
                self.remote.push_ghost(r, c)
                continue
            t, m = self.shards[c]
            view = (fam.apply_delta(snapshot, self._lag[c])
                    if self._lag is not None else snapshot)
            keys = [(self.seed, device_mod.SWEEP, r, c, s)
                    for s in range(tcfg.tau)]
            self.locals_[c], acc = round_mod.tau_sweeps(
                cfg, fam, self.locals_[c], view, self._tcp_tables,
                self._tcp_stale, t, m, keys, method=tcfg.method,
                layout=tcfg.layout,
                sorted_layouts=(self.layouts[c] if self.layouts is not None
                                else None),
                device=self.device,
                sweep_draws=streams.sweep_draws(tcfg.layout, r, c, tcfg.tau))
            if self._lag is not None:
                # The pre-filter delta rides in the client's lag row until
                # the next refresh, lost push or not.
                self._lag[c] = {n: self._lag[c][n] + acc[n] for n in acc}
            sent, self.residuals[c] = round_mod.filter_push(
                fam, acc, tcfg.filter, round_mod.filter_key(self.seed, r, c),
                self.residuals[c], random_rows=lambda i, c=c:
                streams.random_rows(r, c, i))
            if not rf.push_ok[c]:
                # Lost push: the delta is dropped; a ghost fills the slot.
                self.remote.push_ghost(r, c)
                continue
            self.remote.push(r, c, sent)
        self.round_idx += 1

    def close(self) -> None:
        """Release the wire connections (tcp); a no-op in process."""
        if self.remote is not None:
            self.remote.close()

    def run(self, n_rounds: int, *, eval_every: int = 5,
            eval_docs: int = 32) -> RunResult:
        """``n_rounds`` rounds with held-out evaluation on the first
        ``eval_docs`` documents every ``eval_every`` rounds and after the
        last; round times are per eval segment."""
        eval_t, eval_m = self.tokens[:eval_docs], self.mask[:eval_docs]
        res = RunResult(tokens=self.n_tokens)
        first = self.round_idx
        self._sync()
        seg_start, seg_rounds = time.perf_counter(), 0
        for r in range(first, first + n_rounds):
            self.step()
            seg_rounds += 1
            if (r - first) % eval_every == 0 or r == first + n_rounds - 1:
                self._sync()
                dt = (time.perf_counter() - seg_start) / seg_rounds
                res.iter_times.extend([dt] * seg_rounds)
                res.perplexities.append(self.perplexity(eval_t, eval_m))
                res.topics_per_word.append(
                    self.family.topics_per_word(self.shared))
                res.violations.append(
                    self.family.count_violations(self.shared))
                seg_start, seg_rounds = time.perf_counter(), 0
        return res

    def perplexity(self, tokens=None, mask=None, key=None) -> float:
        t = self.tokens if tokens is None else torch.as_tensor(
            tokens, device=self.device)
        m = self.mask if mask is None else torch.as_tensor(
            mask, device=self.device)
        return float(self.family.perplexity(
            self.cfg, self.shared, t, m,
            (self.seed, device_mod.EVAL, 42) if key is None else key))

    # ---------------------------------------------------- snapshot/restore
    def snapshot_state(self) -> dict:
        """The training state a snapshot carries, under the reference's
        leaf names: the server's ``ServerState`` (``server/shards/<s>/
        <stat>`` and ``server/aux/<stat>`` with the reference's names,
        dtypes and shapes, so each package's ``serve.snapshot.
        from_checkpoint`` reads the other's file; SSP's cache, version and
        lag, clocks, changed-row mass and the alias proposal), the
        clients' locals and residuals, and the round counters
        (``round_idx``, ``host_version`` (-1 before SSP's first pull),
        ``alias_builds``, ``pull_retries``).  Where the reference keeps its
        run's ``PRNGKey`` (leaf ``key``) the port keeps its integer seed
        (leaf ``seed``), so a whole Trainer restores only within its own
        package.

        Over tcp the shard servers own the canonical statistics and
        snapshot themselves, so the worker's snapshot carries its client
        edge instead of ``server``: its clients' locals and residuals, the
        pulled snapshot (``tcp_snapshot``, ``tcp_version``), the alias
        proposal built from it (``tcp_tables``, ``tcp_stale``) and the lag
        rows (``tcp_lag``), the reference's leaves."""
        hv = -1 if self._host_version is None else self._host_version
        state = {
            "locals": tuple(self.locals_),
            "residuals": tuple(self.residuals),
            "seed": np.int64(self.seed),
            "round_idx": np.int32(self.round_idx),
            "host_version": np.int32(hv),
            "alias_builds": np.int32(self.alias_builds),
            "pull_retries": np.int32(self._pull_retries),
        }
        if self.remote is None:
            state["server"] = self.pstate._replace(
                cache_version=np.int32(self.pstate.cache_version))
            return state
        if self._tcp_snapshot is None or self._tcp_tables is None:
            raise ValueError("tcp snapshot before the first pull: the "
                             "client edge is empty — step a round first")
        tv = -1 if self._tcp_version is None else self._tcp_version
        state.update({"tcp_snapshot": self._tcp_snapshot,
                      "tcp_version": np.int32(tv),
                      "tcp_tables": self._tcp_tables,
                      "tcp_stale": self._tcp_stale,
                      "tcp_lag": self._lag})
        return state

    def save_snapshot(self) -> str:
        """Write :meth:`snapshot_state` at the current round through
        ``checkpoint.ckpt`` into ``TrainerConfig.snapshot_dir``; returns
        the file's path."""
        if not self.tcfg.snapshot_dir:
            raise ValueError("TrainerConfig.snapshot_dir is not set")
        return ckpt.save(self.tcfg.snapshot_dir, self.tcfg.snapshot_name,
                         self.round_idx, self.snapshot_state())

    @classmethod
    def restore(cls, model_cfg, tokens, mask, *,
                config: TrainerConfig = TrainerConfig(),
                snapshot_dir: str | None = None, step: int | None = None,
                seed: int = 0, device=None) -> "Trainer":
        """Resume a run from its snapshots: a Trainer built as
        ``__init__`` builds it (same corpus, config and seed), then its
        round state overwritten from the newest readable snapshot in
        ``snapshot_dir`` (default ``config.snapshot_dir``), or from
        ``step``.  Under BSP the resumed rounds equal the uninterrupted
        run's bit for bit."""
        sdir = snapshot_dir if snapshot_dir is not None \
            else config.snapshot_dir
        if not sdir:
            raise ValueError("no snapshot_dir: pass snapshot_dir= or set "
                             "TrainerConfig.snapshot_dir")
        trainer = cls(model_cfg, tokens, mask, config=config, seed=seed,
                      device=device)
        # A snapshot is written after a round, whose pull built the alias
        # proposal: build one so that the template has its leaves.  Over
        # tcp the fresh Trainer has re-sent its INIT pushes, which the
        # servers' mutation log dedups (same seed, same bytes).
        if trainer.remote is not None:
            trainer._materialize_tcp_edge()
        else:
            trainer.pstate = trainer.server.refresh_proposal(model_cfg,
                                                             trainer.pstate)
        snap = ckpt.restore_latest(sdir, config.snapshot_name,
                                   trainer.snapshot_state(), step=step)
        trainer._install_snapshot(snap)
        return trainer

    def _materialize_tcp_edge(self) -> None:
        """A client edge of the snapshot's structure for a tcp restore's
        template: one pull and the proposal built from it (the values are
        overwritten by the snapshot's)."""
        if self._tcp_snapshot is None:
            self._tcp_snapshot, self._tcp_version, _ = self.remote.pull(
                0, None)
        if self._tcp_tables is None:
            self._tcp_tables, self._tcp_stale = self.family.build_alias(
                self.cfg, self._tcp_snapshot)

    def _install_snapshot(self, snap: dict) -> None:
        self.locals_ = list(_to(snap["locals"], self.device))
        self.residuals = list(_to(snap["residuals"], self.device))
        self.seed = int(snap["seed"])
        self.round_idx = int(snap["round_idx"])
        hv = int(snap["host_version"])
        self._host_version = None if hv < 0 else hv
        self.alias_builds = int(snap["alias_builds"])
        self._pull_retries = int(snap["pull_retries"])
        if self.remote is None:
            server = _to(snap["server"], self.device)
            self.pstate = server._replace(
                cache_version=int(server.cache_version))
            return
        self._tcp_snapshot = _to(snap["tcp_snapshot"], self.device)
        self._tcp_tables = _to(snap["tcp_tables"], self.device)
        self._tcp_stale = _to(snap["tcp_stale"], self.device)
        self._lag = _to(snap["tcp_lag"], self.device)
        # The rejoin protocol: clear what the dead incarnation left at the
        # servers (pending pushes, open log entries, an eviction) and take
        # the next pull fresh.  Replayed pushes of rounds the servers
        # already finalized dedup against the log, so the resumed rounds
        # apply exactly once.
        for c in self.local_clients:
            self.remote.rejoin(c)
        self._tcp_version = None

    def consistency_error(self) -> float:
        """Max |counts from the assignments − maintained counts| over the
        count-conserved shared statistics; exactly 0.0 with the dense
        filter under every policy (staleness delays what a client sees,
        never what the server applies), unless a push was lost.  Over tcp
        it needs every client's locals in this process."""
        fam, cfg = self.family, self.cfg
        if len(self.local_clients) != self.tcfg.n_clients:
            raise RuntimeError(
                "consistency_error needs every client's locals; this "
                f"worker only runs clients {self.local_clients} of "
                f"{self.tcfg.n_clients}")
        totals: dict[str, torch.Tensor] = {}
        for (t, m), loc in zip(self.shards, self.locals_):
            for n, v in fam.count_stats(cfg, t, m, loc).items():
                totals[n] = v if n not in totals else totals[n] + v
        stats = fam.stats_dict(self.shared)
        return max(float((totals[n] - stats[n]).abs().max())
                   for n in fam.conserved_stats)


def _to(tree, device):
    """``tree`` with every tensor leaf moved to ``device``."""
    return ckpt.map_leaves(
        tree, lambda leaf: leaf.to(device)
        if isinstance(leaf, torch.Tensor) else leaf)
