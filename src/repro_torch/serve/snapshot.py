"""Inference snapshots: a trained model frozen for serving (port of
``repro.serve.snapshot``).

Serving never changes the model.  An :class:`InferenceSnapshot` holds what
the fold-in engine needs: the family's name, the model config, the dense
shared statistics and the alias proposal built over them.  It comes from

* :func:`freeze`: shared statistics in memory;
* :func:`from_trainer`: a live port ``Trainer`` (its assembled
  ``Trainer.shared``);
* :func:`from_checkpoint`: a snapshot written by ``Trainer.save_snapshot``
  of either package; only the ``server/shards`` and ``server/aux`` leaves
  are read, and the proposal is built anew;
* :func:`from_servers`: live shard servers of either package, through
  the port's wire client (one SNAPSHOT round trip a shard).

The tables are built once, at freeze time, by the family's
``build_alias``, the producer training uses: kernel 2 on the card (width K
for LDA and HDP, 2K for PDP), kernel 6 for
``LDAConfig(fused_alias_build=True)``.  Every function runs on ``cuda``
unless ``device="cpu"`` is passed (:mod:`repro_torch.device`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import device as device_mod
from repro_torch.checkpoint import ckpt
from repro_torch.core import family as family_mod
from repro_torch.core import server as server_mod


@dataclasses.dataclass(frozen=True)
class InferenceSnapshot:
    """A trained model frozen for fold-in serving.

    ``shared`` is the family's SharedStats; ``tables``/``stale`` the alias
    proposal over it.  The engine reads them and never writes any of
    them."""

    family_name: str
    cfg: Any
    shared: Any
    tables: Any
    stale: torch.Tensor

    @property
    def family(self) -> family_mod.ModelFamily:
        return family_mod.get(self.family_name)

    @property
    def vocab_size(self) -> int:
        return self.cfg.vocab_size

    @property
    def n_topics(self) -> int:
        return self.cfg.n_topics

    @property
    def device(self) -> torch.device:
        return self.stale.device

    def topic_prior(self) -> torch.Tensor:
        """(K,) per-topic prior used to normalise harvested proportions:
        the family's sparse prior, its first K entries for PDP (whose 2K
        joint outcomes carry α in both halves)."""
        prior = self.family.sparse_prior(self.cfg, self.shared)
        return prior[: self.cfg.n_topics]

    def language_model(self) -> torch.Tensor:
        """(V, K) per-topic word distributions φ under the frozen stats."""
        return self.family.language_model(self.cfg, self.shared)


def freeze(cfg: Any, shared: Any, device=None) -> InferenceSnapshot:
    """Freeze shared statistics into a snapshot on ``device``, building
    the alias proposal over them."""
    dev = device_mod.resolve(device)
    fam = family_mod.family_of(cfg)
    shared = fam.shared_from_dict(
        {n: v.to(dev) for n, v in fam.stats_dict(shared).items()})
    tables, stale = fam.build_alias(cfg, shared)
    return InferenceSnapshot(family_name=fam.name, cfg=cfg, shared=shared,
                             tables=tables, stale=stale)


def from_trainer(trainer: Any, device=None) -> InferenceSnapshot:
    """Freeze a live Trainer's assembled statistics (a round boundary:
    the trainer runs its rounds in order on one stream)."""
    return freeze(trainer.cfg, trainer.shared, device)


def _shared_template(fam: family_mod.ModelFamily, cfg: Any, n_shards: int
                     ) -> tuple[dict, tuple[str, ...]]:
    """A ``{"server": {"shards": …, "aux": …}}`` template whose leaves are
    the ``server/shards/<s>/<stat>`` and ``server/aux/<stat>`` keys a
    Trainer snapshot records; :func:`ckpt.restore` ignores every other
    saved leaf, so the client locals are never read."""
    dummy = torch.zeros((1, 1), dtype=torch.int32)
    _, shared = fam.init_state(cfg, dummy, dummy.bool(), (0,))
    srv = server_mod.make_server(fam, cfg.vocab_size, n_shards=n_shards)
    shards, aux = srv.split(shared)
    return ({"server": {"shards": tuple(dict(s) for s in shards),
                        "aux": dict(aux)}}, tuple(sorted(shards[0])))


def from_checkpoint(directory: str, cfg: Any, *, n_shards: int = 1,
                    name: str = "trainer", step: int | None = None,
                    device=None) -> InferenceSnapshot:
    """Freeze the newest readable Trainer snapshot under ``directory``
    (written by either package).  ``n_shards`` must be the partition it
    was written with (the shapes are checked).  Only the shared statistics
    are read; the proposal is rebuilt."""
    dev = device_mod.resolve(device)
    fam = family_mod.family_of(cfg)
    template, sharded = _shared_template(fam, cfg, n_shards)
    snap = ckpt.restore_latest(directory, name, template, step=step)
    shards, aux = snap["server"]["shards"], snap["server"]["aux"]
    dense = {n: torch.cat([s[n] for s in shards], 0) for n in sharded}
    dense.update(aux)
    return freeze(cfg, fam.shared_from_dict(dense), dev)


def from_servers(addrs: Any, cfg: Any, *, n_clients: int,
                 consistency: str = "bsp", timeout: float = 60.0,
                 min_round: int = 0, device=None) -> InferenceSnapshot:
    """Freeze the canonical assembled statistics of live shard servers:
    one SNAPSHOT round trip per shard, after every round below
    ``min_round`` has finalized, assembled on ``device``."""
    from repro_torch.net import client as net_client
    with net_client.RemoteParameterServer(
            tuple(addrs), family=family_mod.family_of(cfg),
            n_clients=n_clients, consistency=consistency,
            vocab_size=cfg.vocab_size, timeout=timeout,
            device=device) as remote:
        shared = remote.snapshot(min_round=min_round)
    return freeze(cfg, shared, device)
