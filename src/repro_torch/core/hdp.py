"""HDP-LDA, the hierarchical Dirichlet process topic model, with the MHW
sampler (port of ``repro.core.hdp``).

Truncated direct-assignment sampler with auxiliary table counts:

  p(z_di = t | rest) ∝ (n_dt^{-di} + b1·θ0_t) · (n_wt + β)/(n_t + β̄)

  m_dk ~ CRT(n_dk, b1·θ0_k)          (Antoniak, Chinese-restaurant tables)
  θ0   ~ Dir(m_·1 + b0/K, …, m_·K + b0/K)

The conditional splits into the document-sparse term and the dense term
b1·θ0_t · LM, so the sweep is LDA's with the per-topic prior b1·θ0: the
scan sweep is ``lda.scan_sweep_lm`` (kernels 8 and 9 in its MH steps),
kernel 1 runs each sorted chunk, kernel 2 builds the full tables over the
dense term, and kernel 3 rebuilds the drifted rows.

Shared statistics: n_wk, n_k, m_k (table counts summed over documents and
clients) and θ0; local: z, n_dk, m_dk.  The local rules 1 ≤ m_dk ≤ n_dk
where n_dk > 0, else m_dk = 0, are ``projection.HDP_RULES``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core import alias as alias_mod
from repro_torch.core import lda
from repro_torch.kernels import ops


@dataclass(frozen=True)
class HDPConfig:
    """The reference's fields and defaults; the tile fields mean what they
    mean in :class:`repro_torch.core.lda.LDAConfig`."""

    n_topics: int           # truncation level K
    vocab_size: int
    b0: float = 1.0         # root DP concentration
    b1: float = 1.0         # document DP concentration
    beta: float = 0.01      # topic-word Dirichlet
    mh_steps: int = 2
    crt_max: int = 128      # counts above it draw crt_max Bernoullis
    alias_refresh_every: int = 1
    tile_v: int | None = None
    tile_b: int = 1024
    tile_k: int | None = None
    sorted_chunks: int = 4


class SharedStats(NamedTuple):
    n_wk: torch.Tensor    # (V, K) float32
    n_k: torch.Tensor     # (K,)
    m_k: torch.Tensor     # (K,) table counts summed over documents
    theta0: torch.Tensor  # (K,) root topic distribution


class LocalState(NamedTuple):
    z: torch.Tensor       # (D, L) int32
    n_dk: torch.Tensor    # (D, K) float32
    m_dk: torch.Tensor    # (D, K) float32 per-document table counts


def init_state(cfg: HDPConfig, tokens: torch.Tensor, mask: torch.Tensor,
               key: device_mod.Key) -> tuple[LocalState, SharedStats]:
    """Random topics, then :func:`state_from_z`."""
    gen = device_mod.generator(key, tokens.device)
    z = torch.randint(0, cfg.n_topics, tokens.shape, generator=gen,
                      device=tokens.device, dtype=torch.int32)
    return state_from_z(cfg, tokens, mask, torch.where(mask, z, 0))


def state_from_z(cfg: HDPConfig, tokens: torch.Tensor, mask: torch.Tensor,
                 z: torch.Tensor) -> tuple[LocalState, SharedStats]:
    """Counts of the assignments ``z``, one table per occupied (d, k),
    and θ0 = (m_k + b0/K) / (Σ m_k + b0)."""
    n_dk = lda.count_dk(cfg, z, mask)
    n_wk = lda.count_wk(cfg, tokens, z, mask)
    m_dk = torch.clamp_max(n_dk, 1.0)
    m_k = m_dk.sum(0)
    theta0 = (m_k + cfg.b0 / cfg.n_topics) / (m_k.sum() + cfg.b0)
    return (LocalState(z=z, n_dk=n_dk, m_dk=m_dk),
            SharedStats(n_wk=n_wk, n_k=n_wk.sum(0), m_k=m_k, theta0=theta0))


def language_model(cfg: HDPConfig, shared: SharedStats) -> torch.Tensor:
    beta_bar = cfg.beta * cfg.vocab_size
    return (shared.n_wk + cfg.beta) / (shared.n_k[None, :] + beta_bar)


def dense_probs(cfg: HDPConfig, shared: SharedStats) -> torch.Tensor:
    """Dense term b1·θ0_t · (n_wt+β)/(n_t+β̄), the prior formed first."""
    return cfg.b1 * shared.theta0[None, :] * language_model(cfg, shared)


def build_alias(cfg: HDPConfig, shared: SharedStats
                ) -> tuple[alias_mod.AliasTable, torch.Tensor]:
    """Alias tables over the dense term (kernel 2) and the term itself."""
    dp = dense_probs(cfg, shared)
    return ops.build_tables(dp, device=dp.device), dp


def sweep(cfg: HDPConfig, local: LocalState, shared: SharedStats,
          tables: alias_mod.AliasTable, stale: torch.Tensor,
          tokens: torch.Tensor, mask: torch.Tensor, key: device_mod.Key,
          method: str = "mhw", layout: str = "scan", sorted_layouts=None,
          device=None, position_draws=None
          ) -> tuple[LocalState, torch.Tensor, torch.Tensor]:
    """One Gibbs sweep; returns (local', Δn_wk, Δn_k); m_dk is kept.
    The layouts and ``position_draws`` are LDA's (``lda.sweep``), with the
    prior b1·θ0 and the reference's 1e-30 inside the log target's first
    log."""
    if layout == "sorted":
        if method != "mhw":
            raise ValueError("layout='sorted' requires method='mhw'")
        from repro_torch.core import family as family_mod
        local2, deltas = family_mod.get("hdp").sweep_sorted(
            cfg, local, shared, tables, stale, tokens, mask, key,
            sorted_layouts, device=device)
        return local2, deltas["n_wk"], deltas["n_wk"].sum(0)
    if layout != "scan":
        raise ValueError(f"unknown layout {layout!r}")
    z, n_dk = lda.scan_sweep_lm(
        cfg, local.z, local.n_dk, shared.n_wk, shared.n_k, tables, stale,
        tokens, mask, key, method=method, prior=cfg.b1 * shared.theta0,
        prior_eps=True, position_draws=position_draws, device=device)
    dwk = lda.delta_wk(cfg, tokens, mask, local.z, z)
    return LocalState(z=z, n_dk=n_dk, m_dk=local.m_dk), dwk, dwk.sum(0)


def resample_tables(cfg: HDPConfig, local: LocalState, shared: SharedStats,
                    generator: torch.Generator | None = None, *,
                    uniforms: torch.Tensor | None = None
                    ) -> tuple[LocalState, torch.Tensor]:
    """Antoniak step m_dk ~ CRT(n_dk, b1·θ0_k); returns (local', m_k).

    CRT(n, c) = Σ_{j<n} Bernoulli(c/(c + j)), with n clamped to
    ``crt_max``.  The reference draws a (D, K, crt_max) uniform tensor;
    here only the min(n_dk, crt_max) draws of each nonzero (d, k) are
    made, one uniform each (at most a client's token count), compared
    with p = c/(c + j) in float32 (0/0 where θ0_k underflowed, which
    never accepts) and added into m_dk.  ``uniforms`` (D, K, crt_max)
    replaces the draw with the reference's tensor, of which the same
    entries are taken, so the result is bit-equal to the reference's.
    """
    n_dk = local.n_dk
    d, k = n_dk.shape
    dev = n_dk.device
    c = cfg.b1 * shared.theta0
    n = torch.ceil(torch.clamp(n_dk, 0, cfg.crt_max)).reshape(-1).long()
    cells = torch.nonzero(n > 0).squeeze(1)
    reps = n[cells]
    total = int(reps.sum())
    cell = torch.repeat_interleave(cells, reps, output_size=total)
    first = torch.repeat_interleave(torch.cumsum(reps, 0) - reps, reps,
                                    output_size=total)
    j = torch.arange(total, device=dev) - first
    c_j = c[cell % k]
    p = c_j / (c_j + j.to(torch.float32))
    if uniforms is None:
        u = torch.rand(total, generator=generator, device=dev)
    else:
        u = uniforms.reshape(d * k, cfg.crt_max)[cell, j]
    m = torch.zeros(d * k, dtype=torch.float32, device=dev)
    m.index_add_(0, cell, (u < p).to(torch.float32))
    # CRT(n, c) >= 1 whenever n >= 1 (the j = 0 draw has p = 1).
    m_dk = torch.where(n_dk > 0, torch.clamp_min(m.view(d, k), 1.0), 0.0)
    return local._replace(m_dk=m_dk), m_dk.sum(0)


def resample_theta0(cfg: HDPConfig, m_k: torch.Tensor,
                    generator: torch.Generator | None = None, *,
                    gammas: torch.Tensor | None = None) -> torch.Tensor:
    """θ0 ~ Dir(m_k + b0/K) as normalised gamma draws; ``gammas`` replaces
    the draw.  The K gammas are summed left to right in float32 on the
    host, the order of the reference's sum on the CPU, so given its gammas
    θ0 is bit-equal to its own."""
    conc = m_k + cfg.b0 / cfg.n_topics
    g = (torch._standard_gamma(conc, generator=generator) if gammas is None
         else gammas)
    total = np.cumsum(g.cpu().numpy(), dtype=np.float32)[-1]
    return g / torch.tensor(total, device=g.device)


def apply_delta(cfg: HDPConfig, shared: SharedStats, delta_wk: torch.Tensor,
                delta_k: torch.Tensor, m_k: torch.Tensor | None = None,
                theta0: torch.Tensor | None = None) -> SharedStats:
    return SharedStats(
        n_wk=shared.n_wk + delta_wk, n_k=shared.n_k + delta_k,
        m_k=shared.m_k if m_k is None else m_k,
        theta0=shared.theta0 if theta0 is None else theta0)


def perplexity(cfg: HDPConfig, shared: SharedStats, tokens: torch.Tensor,
               mask: torch.Tensor, key: device_mod.Key,
               n_fold_sweeps: int = 10) -> float:
    """Fold-in held-out perplexity with the document prior b1·θ0."""
    return lda.fold_in_perplexity(cfg, language_model(cfg, shared), tokens,
                                  mask, key, n_fold_sweeps,
                                  prior=cfg.b1 * shared.theta0)
