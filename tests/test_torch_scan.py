"""Port parity for the position-scan layout: the MHW mixture proposal and
chain (``core.mhw``), the scan sweeps of LDA, HDP and PDP with the exact
and the MHW sampler, and the family protocol's sealed hooks, each against
the JAX reference on the same numpy-seeded inputs.

The reference draws its randomness inside ``jax.random``; the port's scan
sweep takes it injected (``position_draws``).  :func:`ref_position_draws`
derives position i's draws from the reference's sweep key as the reference
splits it: ``split(key, L)[i]``; for ``exact`` the (D, E) Gumbel field
that ``jax.random.categorical`` adds to the logits (``argmax(gumbel(key,
shape) + logits)`` in the installed JAX); for ``mhw`` per MH step
``split(step) → (k_prop, k_acc)``, ``k_prop → (k_coin, k_sparse,
k_dense)``, ``k_dense → (k_slot, k_coin)``.

Tolerance: none, but for log densities compared as values (``log_q``,
``doc_sparse_logp``), which are held to ``LOG_ULP``.  At K ≤ 16 the row sums are taken left to right on both
sides, the fields are formed by the same float32 operations in the same
order, and every count is a float32 integer, so z, r, n_dk and the deltas
must be equal.  XLA's CPU ``log`` and ``exp`` round differently from
PyTorch's on a few per cent of inputs (ROADMAP C); near a Gumbel or accept
tie one ulp could flip a draw, and PDP's log factors sum up to seven
logs; the inputs here show no flip.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import alias as ref_alias
from repro.core import family as ref_family
from repro.core import mhw as ref_mhw
from repro_torch import bridge
from repro_torch.core import family, mhw
from repro_torch.core.alias import AliasTable
from repro_torch.kernels import _build
from tests.conftest import make_family_cfg, make_synthetic_corpus

V, K = 64, 8
LOG_ULP = 2     # a float32 log, XLA's CPU routine against PyTorch's


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a))


def _step_draws(key, b: int, e: int) -> tuple:
    """One MH step's draws from its step key, the reference's splits."""
    k_prop, k_acc = jax.random.split(key)
    k_coin, k_sparse, k_dense = jax.random.split(k_prop, 3)
    k_slot, k_coin2 = jax.random.split(k_dense)
    return (jax.random.uniform(k_coin, (b,)),
            jax.random.gumbel(k_sparse, (b, e)),
            jax.random.randint(k_slot, (b,), 0, e, dtype=jnp.int32),
            jax.random.uniform(k_coin2, (b,)),
            jax.random.uniform(k_acc, (b,)))


@partial(jax.jit, static_argnums=(1, 2, 3))
def _chain_draws(key, b: int, e: int, steps: int):
    return jax.vmap(lambda k: _step_draws(k, b, e))(
        jax.random.split(key, steps))


@partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _sweep_draws(key, l: int, d: int, e: int, steps: int):
    keys = jax.random.split(key, l)
    if steps == 0:
        return jax.vmap(lambda k: jax.random.gumbel(k, (d, e)))(keys)
    return jax.vmap(lambda k: _chain_draws(k, d, e, steps))(keys)


def ref_chain_draws(key, b: int, e: int, steps: int) -> list:
    """``mh_chain(key, ...)``'s draws as one StepDraws a step."""
    arrs = [np.asarray(a) for a in _chain_draws(key, b, e, steps)]
    return [mhw.StepDraws(*(torch.as_tensor(a[s]) for a in arrs))
            for s in range(steps)]


def ref_position_draws(key, l: int, d: int, e: int, method: str,
                       mh_steps: int):
    """The reference scan sweep's draws under sweep key ``key``, as the
    port's ``position_draws`` callback."""
    if method == "exact":
        g = np.asarray(_sweep_draws(key, l, d, e, 0))
        return lambda i: torch.as_tensor(g[i])
    arrs = [np.asarray(a) for a in _sweep_draws(key, l, d, e, mh_steps)]
    return lambda i: [mhw.StepDraws(*(torch.as_tensor(a[i, s])
                                      for a in arrs))
                      for s in range(mh_steps)]


def _proposal_inputs(b=48, e=12, r=10, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.gamma(0.3, size=(b, e)).astype(np.float32)
    w[rng.random((b, e)) < 0.6] = 0.0
    w[:3] = 0.0                                   # dense-only rows
    dense = rng.gamma(1.0, size=(r, e)).astype(np.float32)
    rows = rng.integers(0, r, size=b).astype(np.int32)
    tabs = ref_alias.build(jnp.asarray(dense))
    ref_prop = ref_mhw.MixtureProposal(jnp.asarray(w), tabs,
                                       jnp.asarray(rows))
    prop = mhw.MixtureProposal(
        torch.as_tensor(w), AliasTable(_t(tabs.prob), _t(tabs.alias),
                                       _t(tabs.mass)), torch.as_tensor(rows))
    return rng, w, dense, rows, ref_prop, prop


def test_mixture_proposal_sample_and_log_q_match_reference():
    _, _, dense, _, ref_prop, prop = _proposal_inputs()
    b, e = ref_prop.sparse_weights.shape
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        k_prop, _ = jax.random.split(key)
        want = ref_prop.sample(k_prop)
        got = prop.sample(mhw.StepDraws(*(_t(a) for a in _step_draws(
            key, b, e))))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype == torch.int32
        want_q = ref_prop.log_q(want, jnp.asarray(dense))
        got_q = prop.log_q(got, torch.as_tensor(dense))
        np.testing.assert_array_max_ulp(got_q.numpy(), np.asarray(want_q),
                                        maxulp=LOG_ULP)


@pytest.mark.parametrize("steps", [1, 3])
def test_mh_chain_and_stats_match_reference(steps):
    rng, w, dense, rows, ref_prop, prop = _proposal_inputs(seed=steps)
    b, e = w.shape
    target = rng.gamma(1.0, size=(b, e)).astype(np.float32)
    init = rng.integers(0, e, size=b).astype(np.int32)
    bidx = np.arange(b)

    def ref_log_p(t):
        return jnp.log(jnp.asarray(target)[bidx, t] + 1e-30)

    def log_p(t):
        return torch.log(torch.as_tensor(target)[bidx, t.long()] + 1e-30)

    key = jax.random.PRNGKey(11)
    draws = ref_chain_draws(key, b, e, steps)
    want = ref_mhw.mh_chain(key, jnp.asarray(init), ref_prop,
                            jnp.asarray(dense), ref_log_p, steps)
    got = mhw.mh_chain(draws, torch.as_tensor(init), prop,
                       torch.as_tensor(dense), log_p, steps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want_z, want_rate = ref_mhw.mh_chain_with_stats(
        key, jnp.asarray(init), ref_prop, jnp.asarray(dense), ref_log_p,
        steps)
    got_z, got_rate = mhw.mh_chain_with_stats(
        draws, torch.as_tensor(init), prop, torch.as_tensor(dense), log_p,
        steps)
    np.testing.assert_array_equal(got_z.numpy(), np.asarray(want_z))
    assert float(got_rate) == float(want_rate)
    assert 0.0 < float(got_rate) < 1.0
    assert (got.numpy() != init).mean() > 0.2, "the chains moved"


def _sweep_setup(name, seed=0):
    rcfg = make_family_cfg(name, n_topics=K, vocab_size=V)
    tokens, mask, _ = make_synthetic_corpus(n_topics=4, vocab=V, n_docs=24,
                                            doc_len=16, seed=seed)
    rfam = ref_family.get(name)
    jt, jm = jnp.asarray(tokens), jnp.asarray(mask)
    local, shared = rfam.init_state(rcfg, jt, jm, jax.random.PRNGKey(seed))
    if name == "hdp":
        theta0 = np.random.default_rng(seed).dirichlet(np.ones(K))
        shared = shared._replace(theta0=jnp.asarray(theta0, jnp.float32))
    return rcfg, rfam, np.asarray(tokens), np.asarray(mask), local, shared


def _np(nt):
    return {f: np.asarray(getattr(nt, f)) for f in nt._fields}


@pytest.mark.parametrize("method", ["exact", "mhw"])
@pytest.mark.parametrize("name", ["lda", "hdp", "pdp"])
def test_scan_sweep_matches_reference_with_injected_draws(name, method):
    rcfg, rfam, tokens, mask, local, shared = _sweep_setup(name)
    fam = family.get(name)
    cfg = bridge.config_from(rcfg)
    jt, jm = jnp.asarray(tokens), jnp.asarray(mask)
    # Tables two sweeps stale, so the MH accepts matter.
    tables, stale = rfam.build_alias(rcfg, shared)
    key = jax.random.PRNGKey(5)
    d, l = tokens.shape
    e = rfam.n_outcomes(rcfg)
    loc = bridge.local_from(_np(local), device="cpu", kind=fam)
    sh = bridge.shared_from(_np(shared), device="cpu", kind=fam)
    t, s = bridge.proposal_from(_np(tables), stale, device="cpu")
    tt, tm = torch.as_tensor(tokens), torch.as_tensor(mask)
    moved = 0.0
    for sweep in range(3):
        k = jax.random.fold_in(key, sweep)
        want_local, want_d = rfam.sweep(rcfg, local, shared, tables, stale,
                                        jt, jm, k, method=method,
                                        layout="scan")
        draws = ref_position_draws(k, l, d, e, method,
                                   rcfg.mh_steps if method == "mhw" else 0)
        got_loc, got_d = fam.sweep(cfg, loc, sh, t, s, tt, tm, (sweep,),
                                   method=method, layout="scan",
                                   device="cpu", position_draws=draws)
        for f in fam.local_stats:
            np.testing.assert_array_equal(
                getattr(got_loc, f).numpy(),
                np.asarray(getattr(want_local, f)),
                err_msg=f"sweep {sweep} {f}")
        for n in fam.delta_names:
            np.testing.assert_array_equal(got_d[n].numpy(),
                                          np.asarray(want_d[n]),
                                          err_msg=f"sweep {sweep} {n}")
        moved += float((got_loc.z != loc.z).float().mean())
        local, loc = want_local, got_loc
        shared = rfam.apply_delta(shared, want_d)
        sh = fam.apply_delta(sh, got_d)
    assert moved / 3 > 0.05, "the chains moved"
    assert got_loc.z.dtype == torch.int32


def test_scan_sweep_own_stream_is_exact_and_launches_nothing_on_cpu():
    """With its own streams (no injection) a scan sweep keeps the counts
    consistent, is reproducible from its key, and on the CPU runs the
    plain versions of kernels 8 and 9 only."""
    rcfg, _, tokens, mask, _, _ = _sweep_setup("lda", seed=1)
    cfg = bridge.config_from(rcfg)
    fam = family.get("lda")
    tt, tm = torch.as_tensor(tokens), torch.as_tensor(mask)
    loc, sh = fam.init_state(cfg, tt, tm, (0,))
    tables, stale = fam.build_alias(cfg, sh)
    _build.reset_launches()
    runs = [fam.sweep(cfg, loc, sh, tables, stale, tt, tm, (3,),
                      device="cpu") for _ in range(2)]
    assert sum(_build.LAUNCHES.values()) == 0
    (a, da), (b, db) = runs
    assert torch.equal(a.z, b.z) and torch.equal(da["n_wk"], db["n_wk"])
    new = fam.apply_delta(sh, da)
    assert torch.equal(new.n_wk, fam.count_stats(cfg, tt, tm, a)["n_wk"])
    from repro_torch.core import lda
    assert torch.equal(a.n_dk, lda.count_dk(cfg, a.z, tm))
    assert torch.equal(a.z[~tm], loc.z[~tm])


@pytest.mark.parametrize("layout,method,exc", [
    ("bogus", "mhw", "unknown layout"), ("sorted", "exact", "requires"),
    ("scan", "bogus", "unknown method")])
def test_sweep_rejects_what_the_reference_rejects(layout, method, exc):
    rcfg, rfam, tokens, mask, local, shared = _sweep_setup("pdp")
    fam = family.get("pdp")
    cfg = bridge.config_from(rcfg)
    tt, tm = torch.as_tensor(tokens), torch.as_tensor(mask)
    loc, sh = fam.init_state(cfg, tt, tm, (0,))
    tables, stale = fam.build_alias(cfg, sh)
    with pytest.raises(ValueError, match=exc):
        fam.sweep(cfg, loc, sh, tables, stale, tt, tm, (0,), method=method,
                  layout=layout, device="cpu")
    rt, rs = rfam.build_alias(rcfg, shared)
    with pytest.raises(ValueError):
        rfam.sweep(rcfg, local, shared, rt, rs, jnp.asarray(tokens),
                   jnp.asarray(mask), jax.random.PRNGKey(0), method=method,
                   layout=layout)


def test_family_names_and_sealed_hooks_match_reference():
    assert list(family.names()) == list(ref_family.names())
    rng = np.random.default_rng(4)
    lp = [rng.normal(size=32).astype(np.float32) for _ in range(4)]
    for name in family.names():
        fam, rfam = family.get(name), ref_family.get(name)
        rcfg, _, _, _, _, shared = _sweep_setup(name)
        cfg = bridge.config_from(rcfg)
        sh = bridge.shared_from(_np(shared), device="cpu", kind=fam)
        e = rfam.n_outcomes(rcfg)
        doc = rng.integers(0, 5, size=(32, e)).astype(np.float32)
        out = rng.integers(0, e, size=32).astype(np.int32)
        np.testing.assert_array_max_ulp(
            fam.doc_sparse_logp(cfg, sh, torch.as_tensor(doc),
                                torch.as_tensor(out)).numpy(),
            np.asarray(rfam.doc_sparse_logp(rcfg, shared, jnp.asarray(doc),
                                            jnp.asarray(out))),
            maxulp=LOG_ULP)
        np.testing.assert_array_equal(
            fam.accept_ratio(*map(torch.as_tensor, lp)).numpy(),
            np.asarray(rfam.accept_ratio(*map(jnp.asarray, lp))))
        assert type(fam).doc_sparse_logp is family.ModelFamily.doc_sparse_logp
        assert type(fam).accept_ratio is family.ModelFamily.accept_ratio
