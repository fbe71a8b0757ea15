"""Port parity over the wire: the port's ``Trainer(transport="tcp")`` on
the port's shard servers against the reference's tcp ``Trainer`` on the
reference's, bit for bit, on the CPU.

Both start from the reference's initial statistics (the port's family
``init_state`` is pointed at the reference's per-client draws for the
test), and the port is fed the reference's random numbers through
``Trainer(streams=)``: each sweep's chunk uniforms are
``kernels.ops._step_uniforms(fold_in(fold_in(key, r*131 + c*17 + s), ch),
E, mh_steps, B)`` (E = K, or 2K for PDP) and each statistic's random filter
rows the ``jax.random.randint`` draw under ``fold_in(fold_in(key, 7000 +
r*131 + c), i)``.  Tolerance: none.  At K ≤ 16 the two packages' alias
tables and chains are equal and every count is a float32 integer, so z,
n_dk (and PDP's r), the shared statistics, the clocks and the filter's
residuals must be equal after every round, and so must LDA's alias
proposal each process built from its pull (``Trainer.tables``,
``.stale``; PDP's log factors round apart in their last bits, 4 ulp,
``ROADMAP.md`` C).  The scan case (``lda-scan``,
the reference's default layout) feeds each sweep's position draws
instead, as ``tests/test_torch_scan_trainer.py`` does in process.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import family as ref_family
from repro.core import fault as ref_fault
from repro.core import ps as ref_ps
from repro.data.synthetic import shard_corpus as ref_shard_corpus
from repro.engine import Trainer as RefTrainer
from repro.engine import TrainerConfig as RefTrainerConfig
from repro.kernels import ops as ref_ops
from repro.net.server import serve_shards as ref_serve_shards
from repro_torch import bridge
from repro_torch.core import family, fault, ps
from repro_torch.engine import Trainer, TrainerConfig
from repro_torch.engine.round import RoundStreams
from repro_torch.net.server import serve_shards
from tests.conftest import make_family_cfg, make_synthetic_corpus
from tests.test_torch_scan import ref_position_draws

V, K, ROUNDS = 64, 8, 3
TIMEOUT = 30.0
TOPK = dict(kind="topk", k_rows=6, random_rows=5)


def _plan(mod):
    """Ghosts on the wire: a lost push, a crash and rejoin, a straggler."""
    e = mod.FaultEvent
    return mod.FaultPlan.scripted(
        e("lost_push", client=0, start=0, stop=1),
        e("crash", client=1, start=1, stop=2),
        e("straggle", client=0, start=1, stop=3, period=2))


# name: (family, TrainerConfig extras, filter kwargs, fault plan factory)
SCENARIOS = {
    "lda-bsp": ("lda", {}, None, None),
    "pdp-bsp": ("pdp", {}, None, None),
    "lda-sparse": ("lda", {"sparse_push": True}, None, None),
    "pdp-sparse": ("pdp", {"sparse_push": True}, None, None),
    "lda-topk": ("lda", {"sparse_push": True}, TOPK, None),
    "lda-faults": ("lda", {}, None, _plan),
    "lda-ssp2": ("lda", {"consistency": "ssp:2"}, None, None),
    "lda-scan": ("lda", {"layout": "scan"}, None, None),
}


class ReferenceStreams(RoundStreams):
    """The reference's draws, as torch tensors."""

    def __init__(self, key, cfg, n_outcomes, spec: ps.FilterSpec,
                 shapes=()):
        self.key, self.cfg, self.e, self.spec = key, cfg, n_outcomes, spec
        self.shapes = shapes

    def chunk_uniforms(self, r, c, s):
        key_s = jax.random.fold_in(self.key, r * 131 + c * 17 + s)

        def draw(ch, lay, tile_b):
            u = ref_ops._step_uniforms(jax.random.fold_in(key_s, ch),
                                       self.e, self.cfg.mh_steps,
                                       int(lay.rows.shape[0]))
            return tuple(torch.as_tensor(np.asarray(a)) for a in u)
        return draw

    def position_draws(self, r, c, s):
        d, l = self.shapes[c]
        return ref_position_draws(
            jax.random.fold_in(self.key, r * 131 + c * 17 + s), l, d, self.e,
            "mhw", self.cfg.mh_steps)

    def random_rows(self, r, c, i):
        kf = jax.random.fold_in(self.key, 7000 + r * 131 + c)
        rows = jax.random.randint(jax.random.fold_in(kf, i),
                                  (self.spec.random_rows,), 0,
                                  self.cfg.vocab_size, jnp.int32)
        return torch.as_tensor(np.asarray(rows))


@pytest.fixture(scope="module")
def corpus():
    tokens, mask, _ = make_synthetic_corpus(n_topics=4, vocab=V, n_docs=24,
                                            doc_len=16, seed=3)
    return np.asarray(tokens), np.asarray(mask)


def _np(nt):
    return {f: np.asarray(getattr(nt, f)) for f in nt._fields}


def _eq(got: torch.Tensor, want, what: str):
    np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(want),
                                  err_msg=what)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_tcp_rounds_equal_the_reference_tcp_trainer(name, corpus,
                                                    monkeypatch):
    tokens, mask = corpus
    fam_name, extra, filt, plan = SCENARIOS[name]
    rcfg = make_family_cfg(fam_name, n_topics=K, vocab_size=V)
    rcfg = type(rcfg)(**{**rcfg.__dict__, "tile_b": 64})
    cfg = bridge.config_from(rcfg)
    fam, rfam = family.get(fam_name), ref_family.get(fam_name)
    consistency = extra.get("consistency", "bsp")
    key = jax.random.PRNGKey(7)

    # The reference's initial draws, handed to the port's Trainer.
    inits = {}
    for c, (t, m) in enumerate(ref_shard_corpus(tokens, mask, 2)):
        loc, sh = rfam.init_state(rcfg, jnp.asarray(t), jnp.asarray(m),
                                  jax.random.fold_in(key, c))
        inits[c] = (bridge.local_from(_np(loc), device="cpu", kind=fam),
                    bridge.shared_from(_np(sh), device="cpu", kind=fam))
    monkeypatch.setattr(fam, "init_state",
                        lambda cfg_, t, m, k: inits[k[2]])

    common = {"layout": "sorted", "n_clients": 2, "transport": "tcp",
              **extra}
    ref_srv = ref_serve_shards(fam_name, vocab_size=V, n_clients=2,
                               n_shards=2, consistency=consistency,
                               barrier_timeout=TIMEOUT)
    srv = serve_shards(fam_name, vocab_size=V, n_clients=2, n_shards=2,
                       consistency=consistency, barrier_timeout=TIMEOUT,
                       device="cpu")
    addrs = lambda ss: tuple("%s:%d" % s.address for s in ss)  # noqa: E731
    try:
        ref = RefTrainer(rcfg, tokens, mask, key=key, config=RefTrainerConfig(
            **common, server_addrs=addrs(ref_srv),
            filter=ref_ps.FilterSpec(**(filt or {})),
            fault_plan=plan(ref_fault) if plan else None))
        spec = ps.FilterSpec(**(filt or {}))
        tr = Trainer(cfg, tokens, mask, device="cpu",
                     streams=ReferenceStreams(
                         key, rcfg, rfam.n_outcomes(rcfg), spec,
                         shapes=[tuple(t.shape) for t, _ in ref.shards]),
                     config=TrainerConfig(
                         **common, server_addrs=addrs(srv), filter=spec,
                         fault_plan=plan(fault) if plan else None))
        z0 = tr.locals_[1].z.clone()
        for r in range(ROUNDS):
            ref.step()
            tr.step()
            for c in range(2):
                for f in fam.local_stats:
                    _eq(getattr(tr.locals_[c], f),
                        getattr(ref.locals_[c], f), f"r{r} {f}[{c}]")
                if filt:
                    _eq(tr.residuals[c]["n_wk"], ref.residuals[c]["n_wk"],
                        f"r{r} residual[{c}]")
            got, want = fam.stats_dict(tr.shared), rfam.stats_dict(ref.shared)
            for n in want:
                _eq(got[n], want[n], f"r{r} {n}")
            np.testing.assert_array_equal(tr.clocks, np.asarray(ref.clocks))
            assert tr.alias_builds == ref.alias_builds, r
            assert tr.rejoins == ref.rejoins, r
            # the proposal this process built from its pull (PDP's log
            # factors round apart in the last bits: LDA's only)
            assert (tr.tables is None) == (ref.tables is None), r
            if ref.tables is not None and fam_name == "lda":
                for f in ref.tables._fields:
                    _eq(getattr(tr.tables, f), getattr(ref.tables, f),
                        f"r{r} tables.{f}")
                _eq(tr.stale, ref.stale, f"r{r} stale")
        assert tr.consistency_error() == ref.consistency_error()
        assert float((tr.locals_[1].z != z0).float().mean()) > 0.1, \
            "the chains moved"
        if plan:
            assert tr.rejoins == 1 and tr.consistency_error() > 0.0
        if consistency != "bsp":
            assert tr.alias_builds == 1          # refresh at round 0 only
        tr.close()
        ref.close()
    finally:
        for s in list(srv) + list(ref_srv):
            s.close()
