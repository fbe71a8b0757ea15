"""``Trainer``: the driver loop (port of ``repro.engine.trainer``) for
in-process training of any registered family (LDA, PDP, HDP) on the
token-sorted layout under BSP.

Each round: (alias maintenance) → pull → sample → client-local rules →
filter → push → project → family auxiliaries (HDP's tables and θ0),
through :func:`repro_torch.engine.round.run_round`.  Alias tables are
rebuilt in full every ``alias_refresh_every`` rounds (kernel 2, or kernel
6 for ``LDAConfig(fused_alias_build=True)``), or, in incremental mode
(``alias_rebuild_threshold`` set), only the drifted rows at the end of
every round (kernel 3 for LDA and HDP, kernel 5 for PDP), with a full
rebuild every ``alias_full_rebuild_every`` rounds.

The trainer runs on ``cuda`` unless ``device="cpu"`` is passed
(:mod:`repro_torch.device`).  RNG: the trainer's ``seed`` heads every
stream key; client c's initial topics come from (seed, INIT, c), round r's
sweeps from (seed, SWEEP, r, c, s, chunk), and evaluations from
(seed, EVAL, 42) — the reference uses ``PRNGKey(42)`` there.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.checkpoint import ckpt
from repro_torch.core import family as family_mod
from repro_torch.core import ps
from repro_torch.core import server as server_mod
from repro_torch.data.synthetic import shard_corpus
from repro_torch.engine import round as round_mod


@dataclass(frozen=True)
class TrainerConfig:
    """The reference's field names and defaults.

    Ported here: ``layout="sorted"``, ``method="mhw"``, ``n_clients``,
    ``tau``, ``consistency="bsp"``, ``n_server_shards``, the alias
    schedules, ``project_every`` and the dense ``filter``.  ``compiled``
    has no counterpart: the round always runs eagerly, which is what
    ``compiled=True`` means here; the reference's uncompiled Python loop
    (``compiled=False``) is not ported.  ``fault_plan``/``drop_client``,
    ``snapshot_every`` and the tcp transport knobs raise unless left at
    their defaults (ROADMAP.md queue A.8 and A.10); ``snapshot_dir`` and
    ``snapshot_name`` name where :meth:`Trainer.save_snapshot` writes.
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
    fault_plan: Any = None
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


_UNPORTED = {  # field: (default, ROADMAP.md item)
    "compiled": (True, "A.5 (the uncompiled reference loop)"),
    "fault_plan": (None, "A.8"),
    "drop_client": (None, "A.8"),
    "snapshot_every": (0, "A.8"),
    "pull_retry_limit": (3, "A.8"),
    "transport": ("inproc", "A.10"),
    "server_addrs": ((), "A.10"),
    "local_clients": (None, "A.10"),
    "sparse_push": (False, "A.10"),
    "reconnect_limit": (3, "A.10"),
}


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
    """Multi-client trainer on the sorted layout, in process, BSP; the
    family follows from the type of ``model_cfg``.

    ``tokens``/``mask`` are (D, L) arrays (numpy or tensors); they are
    split into ``n_clients`` document shards and moved to ``device``.
    """

    def __init__(self, model_cfg, tokens, mask, *,
                 config: TrainerConfig = TrainerConfig(layout="sorted"),
                 seed: int = 0, device=None):
        for name, (default, item) in _UNPORTED.items():
            if getattr(config, name) != default:
                raise NotImplementedError(
                    f"TrainerConfig.{name}={getattr(config, name)!r} is not "
                    f"ported yet (ROADMAP.md queue {item})")
        if config.layout != "sorted":
            raise NotImplementedError(
                f"layout={config.layout!r} is not ported yet (ROADMAP.md "
                "queue A.4, the position-scan oracle); use layout='sorted'")
        if config.method != "mhw":
            raise ValueError("layout='sorted' requires method='mhw'")
        self.device = device_mod.resolve(device)
        self.cfg = model_cfg
        self.tcfg = config
        self.seed = int(seed)
        self.family = family_mod.family_of(model_cfg)
        tokens = np.asarray(tokens)
        mask = np.asarray(mask)
        self.tokens = torch.as_tensor(tokens, device=self.device)
        self.mask = torch.as_tensor(mask, device=self.device)
        self.n_tokens = int(mask.sum())
        self.shards = [
            (torch.as_tensor(t, device=self.device),
             torch.as_tensor(m, device=self.device))
            for t, m in shard_corpus(tokens, mask, config.n_clients)]

        self.locals_: list = []
        shared = None
        for c, (t, m) in enumerate(self.shards):
            loc, sh = self.family.init_state(
                model_cfg, t, m, (self.seed, device_mod.INIT, c))
            self.locals_.append(loc)
            shared = sh if shared is None else self._merge_shared(shared, sh)
        self.server = server_mod.make_server(
            self.family, model_cfg.vocab_size,
            n_shards=config.n_server_shards, consistency=config.consistency)
        self.pstate = self.server.init_state(shared, config.n_clients)
        self.alias_builds = 0
        self.layouts = tuple(self.family.build_sorted_layouts(model_cfg, t, m)
                             for t, m in self.shards)
        self.alias_refresh_every = (
            config.alias_refresh_every
            if config.alias_refresh_every is not None
            else getattr(model_cfg, "alias_refresh_every", 1))
        self.residuals: list = [None] * config.n_clients
        self.round_idx = 0
        self._rcfg = round_mod.RoundConfig.from_trainer(config)

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
        """The assembled canonical shared statistics."""
        return self.server.snapshot(self.pstate)

    @property
    def _incremental(self) -> bool:
        return self.tcfg.alias_rebuild_threshold is not None

    def _refresh_alias(self) -> None:
        """Full rebuild on the cadence (or, in incremental mode, on the
        full-rebuild cadence only; partial rebuilds end each round)."""
        r = self.round_idx
        if self.pstate.tables is not None:
            if self._incremental:
                every = self.tcfg.alias_full_rebuild_every
                if not (every and r % every == 0):
                    return
            elif r % self.alias_refresh_every != 0:
                return
        self.pstate = self.server.refresh_proposal(self.cfg, self.pstate)
        self.alias_builds += 1

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self) -> None:
        """One sync round; returns once it is enqueued on the device."""
        r = self.round_idx
        self._refresh_alias()
        do_project = bool(self.tcfg.project_every
                          and r % self.tcfg.project_every == 0)
        self.locals_, self.pstate, self.residuals = round_mod.run_round(
            self.server, self.cfg, self._rcfg, self._incremental,
            self.pstate, self.locals_, self.residuals,
            [t for t, _ in self.shards], [m for _, m in self.shards],
            self.layouts, self.seed, r, do_project, self.device)
        self.round_idx += 1

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

    def snapshot_state(self) -> dict:
        """The training state a snapshot carries, under the reference's
        leaf names: the server's ``ServerState`` (``server/shards/<s>/
        <stat>`` and ``server/aux/<stat>`` with the reference's names,
        dtypes and shapes, so each package's ``serve.snapshot.
        from_checkpoint`` reads the other's file; clocks, changed-row
        mass and the alias proposal), the clients' locals and residuals,
        the seed and the round counters.  Restoring a whole Trainer from
        it waits for ROADMAP.md queue A.8."""
        return {
            "locals": tuple(self.locals_),
            "residuals": tuple(self.residuals),
            "seed": np.int64(self.seed),
            "round_idx": np.int32(self.round_idx),
            "alias_builds": np.int32(self.alias_builds),
            "server": self.pstate,
        }

    def save_snapshot(self) -> str:
        """Write :meth:`snapshot_state` at the current round through
        ``checkpoint.ckpt`` into ``TrainerConfig.snapshot_dir``; returns
        the file's path."""
        if not self.tcfg.snapshot_dir:
            raise ValueError("TrainerConfig.snapshot_dir is not set")
        return ckpt.save(self.tcfg.snapshot_dir, self.tcfg.snapshot_name,
                         self.round_idx, self.snapshot_state())

    def consistency_error(self) -> float:
        """Max |counts from the assignments − maintained counts| over the
        count-conserved shared statistics; exactly 0.0 under BSP with the
        dense filter."""
        fam, cfg = self.family, self.cfg
        totals: dict[str, torch.Tensor] = {}
        for (t, m), loc in zip(self.shards, self.locals_):
            for n, v in fam.count_stats(cfg, t, m, loc).items():
                totals[n] = v if n not in totals else totals[n] + v
        stats = fam.stats_dict(self.shared)
        return max(float((totals[n] - stats[n]).abs().max())
                   for n in fam.conserved_stats)
