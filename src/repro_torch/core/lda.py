"""Latent Dirichlet Allocation (port of ``repro.core.lda``): the exact
collapsed Gibbs sampler (``method="exact"``, the paper's YahooLDA
baseline) and the MHW sampler (``method="mhw"``, AliasLDA).

The dense proposal term α·(n_wk+β)/(n_k+β̄) is built into alias tables by
kernel 2 (``kernels/alias_build.py``), or, with
``fused_alias_build=True``, computed and built in one launch of kernel 6.
Two sweep layouts:

* ``layout="scan"`` (the default, the reference's correctness oracle):
  positions in turn, every document of the shard at once, so each
  document's ``n_dk`` stays exact as in a sequential Gibbs sweep.  MHW
  runs :func:`repro_torch.core.mhw.mh_chain` at each position (kernels 8
  and 9 on the card); ``exact`` takes the Gumbel argmax of the full
  conditional.  :func:`scan_sweep_lm` is shared with HDP.
* ``layout="sorted"`` (``method="mhw"`` only): each sorted chunk of a
  sweep is one launch of kernel 1 (``kernels/mhw_fused.py``) through
  ``core.family.LDAFamily.sweep_sorted``.

Sufficient statistics: n_dk (D, K) client-local, n_wk (V, K) and n_k (K,)
shared through the parameter server; all float32 counts, exact below 2²⁴.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch import device as device_mod
from repro_torch.core import alias as alias_mod
from repro_torch.core import mhw
from repro_torch.kernels import ops


@dataclass(frozen=True)
class LDAConfig:
    """The reference's fields and defaults.

    ``tile_v``/``tile_b``/``tile_k`` size the reference's TPU tiles.  Here
    ``tile_v`` and ``tile_b`` only shape the sorted layout (its padding to
    ``tile_b`` fixes the length of the uniform streams; ``tile_v`` sizes
    the layout's tile-skip fields), and ``tile_k`` has no effect: no CUDA
    kernel tiles by them.
    """

    n_topics: int
    vocab_size: int
    alpha: float = 0.1
    beta: float = 0.01
    mh_steps: int = 2
    alias_refresh_every: int = 1
    tile_v: int | None = None
    tile_b: int = 1024
    tile_k: int | None = None
    sorted_chunks: int = 4
    fused_alias_build: bool = False


class SharedStats(NamedTuple):
    n_wk: torch.Tensor  # (V, K) float32
    n_k: torch.Tensor   # (K,)  float32


class LocalState(NamedTuple):
    z: torch.Tensor     # (D, L) int32 topic assignments (0 where masked)
    n_dk: torch.Tensor  # (D, K) float32 doc-topic counts


def init_state(cfg: LDAConfig, tokens: torch.Tensor, mask: torch.Tensor,
               key: device_mod.Key) -> tuple[LocalState, SharedStats]:
    """Random topic init and consistent sufficient statistics."""
    gen = device_mod.generator(key, tokens.device)
    z = torch.randint(0, cfg.n_topics, tokens.shape, generator=gen,
                      device=tokens.device, dtype=torch.int32)
    z = torch.where(mask, z, 0)
    n_wk = count_wk(cfg, tokens, z, mask)
    return (LocalState(z=z, n_dk=count_dk(cfg, z, mask)),
            SharedStats(n_wk=n_wk, n_k=n_wk.sum(0)))


def add_at(mat: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
           vals: torch.Tensor) -> torch.Tensor:
    """``mat[rows, cols] += vals`` in place, duplicates summed, through
    ``index_add_`` on the flat view (atomic adds on the card; PyTorch's
    accumulating ``index_put_`` sorts the indices first, which took most
    of a training round at the main path's size).  The order of the adds
    is unspecified, which is exact here: every count is an integer-valued
    float32 below 2²⁴."""
    flat = rows.long() * mat.shape[1] + cols.long()
    mat.view(-1).index_add_(0, flat, vals)
    return mat


def count_dk(cfg, z: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(D, n_topics) document-topic counts of the unmasked ``z``."""
    d, l = z.shape
    docs = torch.arange(d, device=z.device).repeat_interleave(l)
    return add_at(torch.zeros((d, cfg.n_topics), dtype=torch.float32,
                              device=z.device),
                  docs, z.reshape(-1), mask.reshape(-1).to(torch.float32))


def count_wk(cfg: LDAConfig, tokens: torch.Tensor, z: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    return add_at(torch.zeros((cfg.vocab_size, cfg.n_topics),
                              dtype=torch.float32, device=z.device),
                  tokens.reshape(-1), z.reshape(-1),
                  mask.reshape(-1).to(torch.float32))


def language_model(cfg: LDAConfig, shared: SharedStats) -> torch.Tensor:
    """p(w|t) rows: (V, K) = (n_wk + β) / (n_k + β̄)."""
    beta_bar = cfg.beta * cfg.vocab_size
    return (shared.n_wk + cfg.beta) / (shared.n_k[None, :] + beta_bar)


def dense_probs(cfg: LDAConfig, shared: SharedStats) -> torch.Tensor:
    """The dense proposal term α_t·(n_wt+β)/(n_t+β̄) per token-type row."""
    return cfg.alpha * language_model(cfg, shared)


def build_alias(cfg: LDAConfig, shared: SharedStats
                ) -> tuple[alias_mod.AliasTable, torch.Tensor]:
    """Alias tables over the dense term (kernel 2) and the term itself.
    With ``fused_alias_build`` kernel 6 forms the term α·(n_wk+β) /
    (n_k+β̄) itself, with the product taken before the division, so its
    tables and stale matrix differ from the unfused ones in the last
    place."""
    if cfg.fused_alias_build:
        return ops.build_tables_fused_lda(
            shared.n_wk, shared.n_k, alpha=cfg.alpha, beta=cfg.beta,
            vocab_size=cfg.vocab_size, device=shared.n_wk.device)
    dp = dense_probs(cfg, shared)
    return ops.build_tables(dp, device=dp.device), dp


def sweep(cfg: LDAConfig, local: LocalState, shared: SharedStats,
          tables: alias_mod.AliasTable, stale: torch.Tensor,
          tokens: torch.Tensor, mask: torch.Tensor, key: device_mod.Key,
          method: str = "mhw", layout: str = "scan",
          sorted_layouts=None, device=None, position_draws=None
          ) -> tuple[LocalState, torch.Tensor, torch.Tensor]:
    """One Gibbs sweep over a client's shard; returns (local', Δn_wk, Δn_k).

    ``shared`` is the client's frozen snapshot for the sweep; the tables
    and ``stale`` may be staler.  ``layout="sorted"`` (mhw only) runs the
    chunked sorted sweep on the hoisted ``sorted_layouts``;
    ``position_draws`` replaces the scan sweep's stream (see
    :func:`scan_sweep_lm`)."""
    if layout == "sorted":
        if method != "mhw":
            raise ValueError("layout='sorted' requires method='mhw'")
        from repro_torch.core import family as family_mod
        local2, deltas = family_mod.get("lda").sweep_sorted(
            cfg, local, shared, tables, stale, tokens, mask, key,
            sorted_layouts, device=device)
        return local2, deltas["n_wk"], deltas["n_wk"].sum(0)
    if layout != "scan":
        raise ValueError(f"unknown layout {layout!r}")
    z, n_dk = scan_sweep_lm(cfg, local.z, local.n_dk, shared.n_wk,
                            shared.n_k, tables, stale, tokens, mask, key,
                            method=method, prior=cfg.alpha,
                            position_draws=position_draws, device=device)
    dwk = delta_wk(cfg, tokens, mask, local.z, z)
    return LocalState(z=z, n_dk=n_dk), dwk, dwk.sum(0)


def delta_wk(cfg, tokens, mask, z_old, z_new) -> torch.Tensor:
    """(V, K) word-topic delta between two assignments (the batched push
    of paper §5.3), its adds in any order: exact for integer counts."""
    w = tokens.reshape(-1)
    m = mask.reshape(-1).to(torch.float32)
    delta = torch.zeros((cfg.vocab_size, cfg.n_topics), dtype=torch.float32,
                        device=tokens.device)
    add_at(delta, w, z_new.reshape(-1), m)
    return add_at(delta, w, z_old.reshape(-1), -m)


def scan_sweep_lm(cfg, z, n_dk, n_wk, n_k, tables, stale, tokens, mask,
                  key: device_mod.Key, *, method: str, prior,
                  prior_eps: bool = False, position_draws=None, device=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The position-scan sweep of the LM families: LDA (``prior`` the
    float α) and HDP (``prior`` the (K,) vector b1·θ0, with
    ``prior_eps``: its log target adds 1e-30 inside the first log, as the
    reference's does).  Returns (z', n_dk').

    At position i every document removes its token's own count (the ^{-di}
    correction) from ``n_dk`` and from its gathered LM row
    (n_wk − own + β)/(n_k − own + β̄), then draws its new topic:
    ``exact`` as argmax(gumbel + log(n_dk + prior) + log(lm + 1e-30));
    ``mhw`` by :func:`mhw.mh_chain` with the sparse weights n_dk·lm, the
    dense tables and log p(t) = log(n_dk_t + prior_t) + log(lm_t + 1e-30).
    Masked positions keep their topic.  The own count is subtracted at the
    D cells [d, z_old] in place rather than through a (D, K) one-hot: the
    same float operations on every cell.

    Streams: one generator per sweep, keyed ``key``, drawn in position
    order, then MH-step order, then the fields of :class:`mhw.StepDraws`
    (``exact``: one (D, K) Gumbel field a position).
    ``position_draws(i)`` (optional) gives position i's draws instead: a
    sequence of ``mh_steps`` :class:`mhw.StepDraws`, or the (D, K)
    Gumbel field for ``exact``."""
    if method not in ("exact", "mhw"):
        raise ValueError(f"unknown method {method!r}")
    dev = device_mod.resolve(device)
    d, l = tokens.shape
    k = cfg.n_topics
    beta_bar = cfg.beta * cfg.vocab_size
    docs = torch.arange(d, device=dev)
    gen = (device_mod.generator(key, dev) if position_draws is None
           else None)
    tok_cols = tokens.t().contiguous().to(torch.int32)
    mask_cols = mask.t().contiguous()
    z_cols = z.t().contiguous().clone()
    n_dk = n_dk.clone()
    denom = n_k + beta_bar
    vector_prior = isinstance(prior, torch.Tensor)
    for i in range(l):
        w, z_old, m = tok_cols[i], z_cols[i], mask_cols[i]
        zl = z_old.long()
        mf = m.to(torch.float32)
        n_dk[docs, zl] -= mf
        lm = n_wk[w.long()]
        own = lm[docs, zl] - mf
        lm.add_(cfg.beta).div_(denom)
        lm[docs, zl] = (own + cfg.beta) / (n_k[zl] - mf + beta_bar)
        draws = position_draws(i) if position_draws is not None else None
        if method == "exact":
            logits = torch.log(n_dk + prior).add_(torch.log(lm + 1e-30))
            g = mhw.gumbel(gen, (d, k), dev) if draws is None else draws
            z_new = torch.argmax(g + logits, dim=-1).to(torch.int32)
            del logits, g
        else:
            def log_p(t):
                tl = t.long()
                first = n_dk[docs, tl] + (prior[tl] if vector_prior
                                          else prior)
                if prior_eps:
                    first = first + 1e-30
                return torch.log(first) + torch.log(lm[docs, tl] + 1e-30)

            prop = mhw.MixtureProposal(n_dk * lm, tables, w)
            z_new = mhw.mh_chain(gen if draws is None else draws, z_old,
                                 prop, stale, log_p, cfg.mh_steps)
            del prop
        del lm
        z_new = torch.where(m, z_new, z_old)
        n_dk[docs, z_new.long()] += mf
        z_cols[i] = z_new
    return z_cols.t().contiguous(), n_dk


def perplexity(cfg: LDAConfig, shared: SharedStats, tokens: torch.Tensor,
               mask: torch.Tensor, key: device_mod.Key,
               n_fold_sweeps: int = 10) -> float:
    """Held-out perplexity with fold-in estimation of θ_d (paper §6): φ is
    frozen from the trained statistics, θ_d comes from ``n_fold_sweeps``
    position-scan Gibbs sweeps on the held-out documents, then
    π = exp(−Σ log Σ_t θ_dt φ_wt / Σ N_d)."""
    return fold_in_perplexity(cfg, language_model(cfg, shared), tokens,
                              mask, key, n_fold_sweeps)


def fold_in_perplexity(cfg, phi: torch.Tensor, tokens: torch.Tensor,
                       mask: torch.Tensor, key: device_mod.Key,
                       n_fold_sweeps: int = 10,
                       prior: torch.Tensor | None = None) -> float:
    """Fold-in held-out perplexity against the frozen (V, K) word rows
    ``phi``; ``cfg`` gives ``n_topics``.  The document prior is the scalar
    ``cfg.alpha`` on every topic, or the per-topic vector ``prior`` (K,)
    (HDP's b1·θ0), normalised by its sum.  Shared by the families whose
    evaluation differs only in φ and the prior."""
    dev = tokens.device
    d, l = tokens.shape
    gen = device_mod.generator(key, dev)
    z = torch.randint(0, cfg.n_topics, (d, l), generator=gen, device=dev)
    z = torch.where(mask, z, 0)
    n_dk = count_dk(cfg, z, mask)
    docs = torch.arange(d, device=dev)
    log_phi = torch.log(phi + 1e-30)
    mask_f = mask.to(torch.float32)
    for _ in range(n_fold_sweeps):
        for i in range(l):
            w, m = tokens[:, i].long(), mask_f[:, i]
            n_dk[docs, z[:, i]] -= m
            logits = torch.log(n_dk + (cfg.alpha if prior is None
                                        else prior[None, :])) + log_phi[w]
            u = torch.rand(logits.shape, generator=gen, device=dev)
            z_new = torch.argmax(logits - torch.log(-torch.log(u + 1e-20)
                                                    + 1e-20), dim=-1)
            z[:, i] = torch.where(mask[:, i], z_new, z[:, i])
            n_dk[docs, z[:, i]] += m
    if prior is None:
        theta = (n_dk + cfg.alpha) / (n_dk.sum(-1, keepdim=True)
                                      + cfg.alpha * cfg.n_topics)
    else:
        theta = (n_dk + prior[None, :]) / (n_dk.sum(-1, keepdim=True)
                                           + prior.sum())
    pw = torch.einsum("dk,dlk->dl", theta, phi[tokens.long()])
    logp = torch.where(mask, torch.log(pw + 1e-30), 0.0)
    return float(torch.exp(-logp.sum() / mask.sum().clamp_min(1)))


def topics_per_word(shared: SharedStats, threshold: float = 0.5) -> float:
    """Average number of non-zero topics across seen token-types."""
    nz = (shared.n_wk > threshold).sum(-1).to(torch.float32)
    seen = shared.n_wk.sum(-1) > threshold
    return float(torch.where(seen, nz, 0.0).sum() / seen.sum().clamp_min(1))
