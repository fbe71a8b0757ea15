"""Pitman-Yor topic model / Poisson-Dirichlet process sampler (port of
``repro.core.pdp``).

Per (word w, topic t) the sampler keeps m_wk (customers: how often dish w
was served in restaurant t) and s_wk (tables serving it), and per token a
table-open indicator r.  The joint conditional over (t, r) of paper eqs.
5-6, with generalized-Stirling ratios, splits into a document-sparse and a
dense part like LDA's, over 2K outcomes e = t + K·r.  The dense term
α·f(t, r) is built into (V, 2K) alias tables by kernel 2 (full builds) or
kernel 5 (the changed rows, ``core.family.ModelFamily.rebuild_alias_rows``).
The scan sweep (the default layout) runs the exact sampler or
:func:`repro_torch.core.mhw.mh_chain` over the 2K outcomes at each
position (kernels 8 and 9 in its MH steps); each sorted chunk of a sorted
sweep is one launch of kernel 4 (``kernels/mhw_fused.py::pdp_sweep_fused``),
whose plain version is :func:`sorted_chain_pdp`.

All counts are float32, exact below 2²⁴.  Every scatter-add goes through
``lda.add_at`` (``index_add_`` on the flat view).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch import device as device_mod
from repro_torch.core import alias as alias_mod
from repro_torch.core import lda, mhw, stirling
from repro_torch.kernels import ops


@dataclass(frozen=True)
class PDPConfig:
    """The reference's fields and defaults.  ``tile_v``/``tile_b``/
    ``tile_k`` only shape the sorted layout here, as ``LDAConfig``'s
    docstring says (its tiles cover the 2K joint outcomes)."""

    n_topics: int
    vocab_size: int
    alpha: float = 0.1            # document Dirichlet
    discount: float = 0.1         # a, the power-law discount
    concentration: float = 10.0   # b
    gamma: float = 0.5            # base distribution ψ0 ~ Dir(γ)
    mh_steps: int = 2
    stirling_n_max: int = 512
    alias_refresh_every: int = 1
    tile_v: int | None = None
    tile_b: int = 1024
    tile_k: int | None = None
    sorted_chunks: int = 4


class SharedStats(NamedTuple):
    m_wk: torch.Tensor  # (V, K) customer counts
    s_wk: torch.Tensor  # (V, K) table counts
    m_k: torch.Tensor   # (K,) aggregates, derived
    s_k: torch.Tensor   # (K,)


class LocalState(NamedTuple):
    z: torch.Tensor     # (D, L) int32 topic assignments
    r: torch.Tensor     # (D, L) int32 table-open indicators
    n_dk: torch.Tensor  # (D, K) float32 doc-topic counts


def _count(cfg: PDPConfig, tokens, z, mask, weight) -> torch.Tensor:
    val = (mask.reshape(-1) * weight.reshape(-1)).to(torch.float32)
    return lda.add_at(torch.zeros((cfg.vocab_size, cfg.n_topics),
                                  dtype=torch.float32, device=tokens.device),
                      tokens.reshape(-1), z.reshape(-1), val)


def init_state(cfg: PDPConfig, tokens: torch.Tensor, mask: torch.Tensor,
               key: device_mod.Key) -> tuple[LocalState, SharedStats]:
    """Random topics, each token a table opener with probability 1/2, then
    the s ≤ m, m > 0 ⇒ s ≥ 1 repair of the table counts."""
    gen = device_mod.generator(key, tokens.device)
    z = torch.randint(0, cfg.n_topics, tokens.shape, generator=gen,
                      device=tokens.device, dtype=torch.int32)
    z = torch.where(mask, z, 0)
    r = (torch.rand(tokens.shape, generator=gen, device=tokens.device)
         < 0.5).to(torch.int32)
    r = torch.where(mask, r, 0)
    m_wk = _count(cfg, tokens, z, mask, torch.ones_like(r))
    s_wk = _count(cfg, tokens, z, mask, r)
    s_wk = torch.where(m_wk > 0, torch.clamp_min(s_wk, 1.0), 0.0)
    s_wk = torch.minimum(s_wk, m_wk)
    return (LocalState(z=z, r=r, n_dk=lda.count_dk(cfg, z, mask)),
            SharedStats(m_wk=m_wk, s_wk=s_wk, m_k=m_wk.sum(0),
                        s_k=s_wk.sum(0)))


def log_factors(table: torch.Tensor, m_wk_row: torch.Tensor,
                s_wk_row: torch.Tensor, m_k: torch.Tensor, s_k: torch.Tensor,
                *, b: float, a: float, gamma: float, gamma_bar: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token log factors f(t, r) of eqs. 5-6 without the (α + n_dt)
    factor, for every topic, from the corrected rows: (log_f_r0, log_f_r1).
    The operations and their order are the reference's, term by term, and
    the sweep kernel's (``csrc/pdp_fused.cu``)."""
    log_denom = torch.log(b + m_k)
    # r = 0: existing table
    #   (m_tw + 1 - s_tw)/(m_tw + 1) * S^{m+1}_{s} / S^{m}_{s} / (b + m_t)
    occ = torch.clamp_min(m_wk_row + 1.0 - s_wk_row, 0.0)
    log_f0 = (torch.log(occ + 1e-30) - torch.log(m_wk_row + 1.0)
              + stirling.log_ratio_same(table, m_wk_row, s_wk_row)
              - log_denom)
    # r = 1: open a new table
    #   (b + a s_t)/(b + m_t) * (s_tw+1)/(m_tw+1) * (γ + s_tw)/(γ̄ + s_t)
    #   * S^{m+1}_{s+1} / S^{m}_{s}
    log_f1 = (torch.log(b + a * s_k) - log_denom
              + torch.log(s_wk_row + 1.0) - torch.log(m_wk_row + 1.0)
              + torch.log(gamma + s_wk_row) - torch.log(gamma_bar + s_k)
              + stirling.log_ratio_incr(table, m_wk_row, s_wk_row))
    return log_f0, log_f1


def _log_factors(cfg: PDPConfig, table, m_wk_row, s_wk_row, m_k, s_k):
    """:func:`log_factors` with the config's hyperparameters."""
    return log_factors(table, m_wk_row, s_wk_row, m_k, s_k,
                       b=cfg.concentration, a=cfg.discount, gamma=cfg.gamma,
                       gamma_bar=cfg.gamma * cfg.vocab_size)


def own_contrib(k_topics: int, e0: torch.Tensor, real: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ^{-di} one-hot contributions of joint outcomes e = t + K·r:
    (own_t, own_r), each (B, K) float32, zero on padding."""
    e0 = e0.long()
    z0, r0 = e0 % k_topics, e0 // k_topics
    karange = torch.arange(k_topics, device=e0.device)[None, :]
    own_t = ((karange == z0[:, None]) & real[:, None]).to(torch.float32)
    own_r = own_t * (r0[:, None] > 0).to(torch.float32)
    return own_t, own_r


def corrected_rows(m_row_raw, s_row_raw, own_t, own_r):
    """The ^{-di} removal and the CRP repair: a removed non-opener cannot
    leave a table-less dish; a removed opener of an empty dish removes its
    table."""
    m_row = m_row_raw - own_t
    s_row = s_row_raw - own_r
    s_row = torch.where(m_row > 0, torch.clamp_min(s_row, 1.0), 0.0)
    s_row = torch.minimum(s_row, m_row)
    return m_row, s_row


def dense_rows(cfg: PDPConfig, m_rows, s_rows, m_k, s_k) -> torch.Tensor:
    """(R, 2K) dense term α·f(t, r) of the given (m, s) rows: columns
    [0, K) are r=0, [K, 2K) r=1."""
    table = stirling.as_tensor(cfg.stirling_n_max, cfg.discount,
                               m_rows.device)
    log_f0, log_f1 = _log_factors(cfg, table, m_rows, s_rows, m_k[None, :],
                                  s_k[None, :])
    return cfg.alpha * torch.cat([torch.exp(log_f0), torch.exp(log_f1)], -1)


def dense_probs(cfg: PDPConfig, shared: SharedStats) -> torch.Tensor:
    """Dense proposal term over the joint (t, r) space: (V, 2K)."""
    return dense_rows(cfg, shared.m_wk, shared.s_wk, shared.m_k, shared.s_k)


def build_alias(cfg: PDPConfig, shared: SharedStats
                ) -> tuple[alias_mod.AliasTable, torch.Tensor]:
    """Alias tables over the dense term (kernel 2) and the term itself."""
    dp = dense_probs(cfg, shared)
    return ops.build_tables(dp, device=dp.device), dp


def sweep(cfg: PDPConfig, local: LocalState, shared: SharedStats,
          tables: alias_mod.AliasTable, stale: torch.Tensor,
          tokens: torch.Tensor, mask: torch.Tensor, key: device_mod.Key,
          method: str = "mhw", layout: str = "scan",
          sorted_layouts=None, device=None, position_draws=None
          ) -> tuple[LocalState, torch.Tensor, torch.Tensor]:
    """One Gibbs sweep; returns (local', Δm_wk, Δs_wk).  The layouts and
    ``position_draws`` are LDA's (``lda.sweep``), over the 2K joint
    outcomes e = t + K·r."""
    if layout == "sorted":
        if method != "mhw":
            raise ValueError("layout='sorted' requires method='mhw'")
        from repro_torch.core import family as family_mod
        local2, deltas = family_mod.get("pdp").sweep_sorted(
            cfg, local, shared, tables, stale, tokens, mask, key,
            sorted_layouts, device=device)
        return local2, deltas["m_wk"], deltas["s_wk"]
    if layout != "scan":
        raise ValueError(f"unknown layout {layout!r}")
    if method not in ("exact", "mhw"):
        raise ValueError(f"unknown method {method!r}")
    z, r, n_dk = _scan(cfg, local, shared, tables, stale, tokens, mask, key,
                       method, position_draws, device_mod.resolve(device))
    delta_m, delta_s = deltas_from(cfg, tokens, mask, local.z, local.r, z, r)
    return LocalState(z=z, r=r, n_dk=n_dk), delta_m, delta_s


def _scan(cfg: PDPConfig, local, shared, tables, stale, tokens, mask, key,
          method, position_draws, dev):
    """The position scan of :func:`sweep`, each position's operations
    those of the reference's ``position_step`` on the (D, K) and (D, 2K)
    fields: the own-count removal with the CRP repair
    (:func:`corrected_rows`), the log factors over the corrected
    aggregates, then the exact Gumbel argmax of log(n_dk_ext + α) + log f,
    or the MH chain with the sparse weights n_dk_ext·exp(log f).  Streams
    as ``lda.scan_sweep_lm``'s, over E = 2K."""
    d, l = tokens.shape
    k = cfg.n_topics
    docs = torch.arange(d, device=dev)
    stirl = stirling.as_tensor(cfg.stirling_n_max, cfg.discount, dev)
    gen = (device_mod.generator(key, dev) if position_draws is None
           else None)
    tok_cols = tokens.t().contiguous().to(torch.int32)
    mask_cols = mask.t().contiguous()
    z_cols = local.z.t().contiguous().clone()
    r_cols = local.r.t().contiguous().clone()
    n_dk = local.n_dk.clone()
    for i in range(l):
        w, z_old, r_old, m = tok_cols[i], z_cols[i], r_cols[i], mask_cols[i]
        zl, wl = z_old.long(), w.long()
        mf = m.to(torch.float32)
        n_dk[docs, zl] -= mf
        own_t = torch.zeros((d, k), dtype=torch.float32, device=dev)
        own_t[docs, zl] = mf
        own_r = own_t * r_old.to(torch.float32)[:, None]
        m_row, s_row = corrected_rows(shared.m_wk[wl], shared.s_wk[wl],
                                      own_t, own_r)
        log_f0, log_f1 = _log_factors(cfg, stirl, m_row, s_row,
                                      shared.m_k[None, :] - own_t,
                                      shared.s_k[None, :] - own_r)
        del m_row, s_row, own_t, own_r
        log_f = torch.cat([log_f0, log_f1], -1)              # (D, 2K)
        del log_f0, log_f1
        n_dk_ext = torch.cat([n_dk, n_dk], -1)
        draws = position_draws(i) if position_draws is not None else None
        if method == "exact":
            logits = torch.log(n_dk_ext + cfg.alpha).add_(log_f)
            g = mhw.gumbel(gen, (d, 2 * k), dev) if draws is None else draws
            e_new = torch.argmax(g + logits, dim=-1).to(torch.int32)
            del logits, g
        else:
            def log_p(e):
                el = e.long()
                return (torch.log(n_dk_ext[docs, el] + cfg.alpha)
                        + log_f[docs, el])

            prop = mhw.MixtureProposal(n_dk_ext * torch.exp(log_f), tables,
                                       w)
            e_new = mhw.mh_chain(gen if draws is None else draws,
                                 z_old + k * r_old, prop, stale, log_p,
                                 cfg.mh_steps)
            del prop
        del log_f, n_dk_ext
        z_new = torch.where(m, e_new % k, z_old)
        r_new = torch.where(m, e_new // k, r_old)
        n_dk[docs, z_new.long()] += mf
        z_cols[i], r_cols[i] = z_new, r_new
    return z_cols.t().contiguous(), r_cols.t().contiguous(), n_dk


def deltas_from(cfg: PDPConfig, tokens, mask, z_old, r_old, z_new, r_new
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(V, K) customer and table count deltas between two states."""
    w = tokens.reshape(-1)
    mf = mask.reshape(-1).to(torch.float32)
    zn, zo = z_new.reshape(-1), z_old.reshape(-1)

    def zeros():
        return torch.zeros((cfg.vocab_size, cfg.n_topics),
                           dtype=torch.float32, device=tokens.device)

    delta_m = lda.add_at(lda.add_at(zeros(), w, zn, mf), w, zo, -mf)
    delta_s = lda.add_at(
        lda.add_at(zeros(), w, zn, mf * r_new.reshape(-1)),
        w, zo, -mf * r_old.reshape(-1))
    return delta_m, delta_s


def sorted_chain_pdp(prob, alias, mass, stale, m_wk, s_wk, m_k, s_k, stirl,
                     prior, rows, docs, e0, n_dk, slot, coin, u_mix, u_sparse,
                     u_acc, *, b: float, a: float, gamma: float,
                     gamma_bar: float) -> torch.Tensor:
    """Plain version of the PDP sweep kernel: the MH chain over the 2K joint
    outcomes of a token-sorted chunk.

    prob/alias/stale: (V, 2K); mass: (V,); m_wk/s_wk: (V, K); m_k/s_k:
    (K,); stirl: the log-Stirling table; prior: (2K,); rows/docs/e0: (B,)
    sorted token-types (≥ V is padding, kept at e0), document ids and
    joint-outcome chain init; n_dk: (D, K) raw document counts (the
    own-token removal happens here); uniforms (S, B), slot in [0, 2K).
    Returns (B,) int32 joint outcomes.
    """
    v, k_topics = m_wk.shape
    real = rows < v
    r = rows.clamp(0, v - 1).long()
    own_t, own_r = own_contrib(k_topics, e0, real)
    m_row, s_row = corrected_rows(m_wk[r], s_wk[r], own_t, own_r)
    log_f0, log_f1 = log_factors(stirl, m_row, s_row, m_k[None, :] - own_t,
                                 s_k[None, :] - own_r, b=b, a=a, gamma=gamma,
                                 gamma_bar=gamma_bar)
    # Free each (B, K) temporary once used: on the card a 131,072-token
    # slice at K = 1024 makes every one of them 0.5 GiB.
    del m_row, s_row
    log_f = torch.cat([log_f0, log_f1], -1)                  # (B, 2K)
    del log_f0, log_f1
    ndk_m = n_dk[docs.long()] - own_t
    ndk_ext = torch.cat([ndk_m, ndk_m], -1)
    del ndk_m, own_t, own_r
    e = mhw.mix_chain(e0, doc=ndk_ext, prior=prior, logf=log_f,
                      sparse_w=ndk_ext * torch.exp(log_f),
                      stale_rows=stale[r], prob_rows=prob[r],
                      alias_rows=alias[r], dense_mass=mass[r], slot=slot,
                      coin=coin, u_mix=u_mix, u_sparse=u_sparse, u_acc=u_acc)
    return torch.where(real, e, e0).to(torch.int32)


def apply_delta(shared: SharedStats, delta_m, delta_s) -> SharedStats:
    """Add the deltas and re-derive the aggregates (the C2 rule)."""
    m_wk = shared.m_wk + delta_m
    s_wk = shared.s_wk + delta_s
    return SharedStats(m_wk=m_wk, s_wk=s_wk, m_k=m_wk.sum(0),
                       s_k=s_wk.sum(0))


def language_model(cfg: PDPConfig, shared: SharedStats) -> torch.Tensor:
    """Posterior-mean p(w|t): hierarchical CRP smoothing with base ψ0."""
    b, a = cfg.concentration, cfg.discount
    gamma_bar = cfg.gamma * cfg.vocab_size
    s_w = shared.s_wk.sum(-1)
    p0 = (cfg.gamma + s_w) / (gamma_bar + s_w.sum())
    direct = torch.clamp_min(shared.m_wk - a * shared.s_wk, 0.0)
    back = (b + a * shared.s_k)[None, :] * p0[:, None]
    return (direct + back) / (b + shared.m_k)[None, :]


def perplexity(cfg: PDPConfig, shared: SharedStats, tokens: torch.Tensor,
               mask: torch.Tensor, key: device_mod.Key,
               n_fold_sweeps: int = 10) -> float:
    """Held-out perplexity by fold-in against :func:`language_model`."""
    return lda.fold_in_perplexity(cfg, language_model(cfg, shared), tokens,
                                  mask, key, n_fold_sweeps)
