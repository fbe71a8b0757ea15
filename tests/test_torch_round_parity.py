"""Port parity, the slice as a whole: LDA rounds under SSP, async, the
top-k filter and a fault plan, against the reference's Python loop
(``Trainer._step_python``, which the reference holds bit-identical to its
compiled round), bit for bit.

Both trainers start from the reference's initial locals and statistics
(through ``bridge``), and the port is fed the reference's random numbers
through ``Trainer(streams=)``: each sweep's chunk uniforms are
``kernels.ops._step_uniforms(fold_in(fold_in(key, r*131 + c*17 + s), ch))``
and each statistic's random filter rows the ``jax.random.randint`` draw
under ``fold_in(fold_in(key, 7000 + r*131 + c), i)``, as the reference
draws them.  Tolerance: none.  At K ≤ 16 the port's alias tables and
chains equal the reference's (``tests/test_torch_sweep.py``) and every
count is a float32 integer, so z, n_dk, n_wk, the clocks, SSP's lag, the
filter's residuals and the counters must be equal after every round.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fault as ref_fault
from repro.core import lda as ref_lda
from repro.core import ps as ref_ps
from repro.engine import Trainer as RefTrainer
from repro.engine import TrainerConfig as RefTrainerConfig
from repro.kernels import ops as ref_ops
from repro_torch import bridge
from repro_torch.core import fault, ps
from repro_torch.engine import Trainer, TrainerConfig
from repro_torch.engine.round import RoundStreams
from tests.conftest import make_synthetic_corpus

V, K, ROUNDS = 64, 8, 4
TOPK = dict(kind="topk", k_rows=6, random_rows=5)


def _plan(mod):
    e = mod.FaultEvent
    return mod.FaultPlan.scripted(
        e("lost_push", client=0, start=1, stop=2),
        e("crash", client=1, start=1, stop=3),
        e("straggle", client=0, start=2, stop=4, period=2))


def _refresh_plan(mod):
    e = mod.FaultEvent
    return mod.FaultPlan.scripted(
        e("failed_pull", start=1, stop=3),
        e("crash", client=0, start=1, stop=3))


# name: (consistency, filter kwargs, fault plan builder)
SCENARIOS = {
    "ssp1": ("ssp:1", None, None),
    "async": ("async", None, None),
    "topk": ("bsp", TOPK, None),
    "faults": ("bsp", None, _plan),
    "ssp1-faults": ("ssp:1", TOPK, _refresh_plan),
}


class ReferenceStreams(RoundStreams):
    """The reference loop's draws, as torch tensors."""

    def __init__(self, key, cfg, spec: ps.FilterSpec):
        self.key, self.cfg, self.spec = key, cfg, spec

    def chunk_uniforms(self, r, c, s):
        key_s = jax.random.fold_in(self.key, r * 131 + c * 17 + s)

        def draw(ch, lay, tile_b):
            u = ref_ops._step_uniforms(jax.random.fold_in(key_s, ch),
                                       self.cfg.n_topics, self.cfg.mh_steps,
                                       int(lay.rows.shape[0]))
            return tuple(torch.as_tensor(np.asarray(a)) for a in u)
        return draw

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


def _trainers(name: str, corpus) -> tuple:
    """The reference's trainer and the port's, from the reference's
    initial locals and statistics, the port fed its streams."""
    tokens, mask = corpus
    consistency, filt, plan = SCENARIOS[name]
    rcfg = ref_lda.LDAConfig(n_topics=K, vocab_size=V, tile_b=64)
    cfg = bridge.config_from(rcfg)
    common = dict(layout="sorted", n_clients=2, consistency=consistency,
                  compiled=False, pull_retry_limit=1)
    key = jax.random.PRNGKey(7)
    ref = RefTrainer(rcfg, tokens, mask, key=key, config=RefTrainerConfig(
        **common, filter=ref_ps.FilterSpec(**(filt or {})),
        fault_plan=plan(ref_fault) if plan else None))
    spec = ps.FilterSpec(**(filt or {}))
    tr = Trainer(cfg, tokens, mask, device="cpu",
                 streams=ReferenceStreams(key, rcfg, spec),
                 config=TrainerConfig(
                     **common, filter=spec,
                     fault_plan=plan(fault) if plan else None))
    tr.locals_ = [bridge.local_from(_np(loc), device="cpu")
                  for loc in ref.locals_]
    tr.pstate = tr.server.init_state(
        bridge.shared_from(_np(ref.shared), device="cpu"), 2)
    return ref, tr


def _proposal_eq(tr, ref, what: str):
    """``Trainer.tables`` and ``.stale``, the reference's bit for bit."""
    assert (tr.tables is None) == (ref.tables is None), what
    if ref.tables is not None:
        for f in ref.tables._fields:
            _eq(getattr(tr.tables, f), getattr(ref.tables, f),
                f"{what} tables.{f}")
        _eq(tr.stale, ref.stale, f"{what} stale")


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_rounds_equal_the_reference_loop(name, corpus):
    _, filt, _ = SCENARIOS[name]
    ref, tr = _trainers(name, corpus)
    ref_z1 = torch.as_tensor(np.asarray(ref.locals_[1].z))
    for r in range(ROUNDS):
        ref.step()
        tr.step()
        for c in range(2):
            _eq(tr.locals_[c].z, ref.locals_[c].z, f"r{r} z[{c}]")
            _eq(tr.locals_[c].n_dk, ref.locals_[c].n_dk, f"r{r} n_dk[{c}]")
            if filt:
                _eq(tr.residuals[c]["n_wk"], ref.residuals[c]["n_wk"],
                    f"r{r} residual[{c}]")
        _eq(tr.shared.n_wk, ref.shared.n_wk, f"r{r} n_wk")
        _eq(tr.shared.n_k, ref.shared.n_k, f"r{r} n_k")
        np.testing.assert_array_equal(tr.clocks, np.asarray(ref.clocks))
        if tr.pstate.client_lag is not None:
            _eq(tr.pstate.client_lag["n_wk"], ref.pstate.client_lag["n_wk"],
                f"r{r} lag")
            _eq(tr.pstate.cache.n_wk, ref.pstate.cache.n_wk, f"r{r} cache")
            assert tr.pstate.cache_version == int(ref.pstate.cache_version)
        assert tr.alias_builds == ref.alias_builds, r
        assert tr.pull_failures == ref.pull_failures, r
        assert tr.rejoins == ref.rejoins, r
    assert tr.consistency_error() == ref.consistency_error()
    assert float((tr.locals_[1].z != ref_z1).float().mean()) > 0.1, \
        "the chains moved"
    if filt:
        assert any(float(res["n_wk"].abs().sum()) > 0
                   for res in tr.residuals), "the filter withheld rows"
    if name == "async":
        assert tr.alias_builds == ROUNDS
    if name == "ssp1":
        assert tr.alias_builds == 2          # refreshes at rounds 0 and 2
    if name == "faults":
        np.testing.assert_array_equal(tr.clocks, [2, 2])
        assert tr.rejoins == 1 and tr.consistency_error() > 0.0
    if name == "ssp1-faults":
        assert tr.pull_failures == 1 and tr.rejoins == 1


@pytest.mark.parametrize("name", ["ssp1", "faults"])
def test_proposal_tables_equal_the_reference(name, corpus):
    """The server state's alias proposal (``Trainer.tables``, ``.stale``)
    after each of two rounds: SSP's built at round 0 and kept, BSP's
    rebuilt every round."""
    ref, tr = _trainers(name, corpus)
    for r in range(2):
        ref.step()
        tr.step()
        _proposal_eq(tr, ref, f"r{r}")
    assert tr.tables is not None
