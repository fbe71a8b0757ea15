"""The ``ModelFamily`` protocol and registry (port of
``repro.core.family``): LDA, PDP and HDP.

``ModelFamily.sweep`` runs one Gibbs sweep of either layout: the position
scan (the default, each family's ``sweep``) or the sorted sweep below.
Every family factors its conditional as p(e) ∝ (doc_e + prior_e)·f_e;
``sparse_prior``, ``doc_sparse_logp`` and ``accept_ratio`` expose it.

``ModelFamily.sweep_sorted`` is the chunked sorted sweep: ``sorted_chunks``
position-chunks in turn, each one launch of the family's fused kernel
(Jacobi within a chunk), with ``n_dk`` refreshed between chunks
(Gauss-Seidel across them).  The shared statistics stay the sweep-start
snapshot throughout.  LDA and HDP share the LM sweep kernel and differ in
its per-topic ``prior`` vector (α·1 against b1·θ0); PDP runs the 2K
joint-outcome kernel.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from repro_torch import device as device_mod
from repro_torch.core import alias as alias_mod
from repro_torch.core import hdp, lda, mhw, pdp, projection, stirling
from repro_torch.data import segment
from repro_torch.kernels import ops


def _rule_names(rule: projection.Rule) -> tuple[str, ...]:
    return (rule.a,) if rule.b is None else (rule.a, rule.b)


class ModelFamily:
    """Per-family declarations plus the family-independent machinery."""

    name: str = ""
    config_cls: type = object
    shared_cls: type = object
    local_cls: type = object
    shared_stats: tuple[str, ...] = ()
    local_stats: tuple[str, ...] = ()
    replicated_stats: tuple[str, ...] = ()
    conserved_stats: tuple[str, ...] = ()
    delta_names: tuple[str, ...] = ()
    rules: tuple[projection.Rule, ...] = ()
    aggregates: tuple[projection.Aggregate, ...] = ()

    @property
    def shared_rules(self) -> tuple[projection.Rule, ...]:
        return tuple(r for r in self.rules
                     if set(_rule_names(r)) <= set(self.shared_stats))

    @property
    def local_rules(self) -> tuple[projection.Rule, ...]:
        return tuple(r for r in self.rules
                     if set(_rule_names(r)) <= set(self.local_stats))

    @property
    def alias_delta_stats(self) -> tuple[str, ...]:
        """Shared statistics whose row drift stales the alias rows."""
        return self.delta_names

    def stats_dict(self, shared) -> dict[str, torch.Tensor]:
        return dict(shared._asdict())

    def shared_from_dict(self, d: dict[str, torch.Tensor]):
        return self.shared_cls(**{n: d[n] for n in self.shared_stats})

    def local_dict(self, local) -> dict[str, torch.Tensor]:
        return dict(local._asdict())

    def local_from_dict(self, d: dict[str, torch.Tensor]):
        return self.local_cls(**{n: d[n] for n in self.local_stats})

    def n_outcomes(self, cfg) -> int:
        """E: the size of the per-token outcome space (K, or 2K for PDP)."""
        return cfg.n_topics

    def language_model(self, cfg, shared) -> torch.Tensor:
        """(V, K) per-topic word distributions φ under ``shared``."""
        raise NotImplementedError

    def dense_probs(self, cfg, shared) -> torch.Tensor:
        """(V, E) dense proposal term prior_e · f_e per token-type."""
        raise NotImplementedError

    def dense_probs_rows(self, cfg, shared, rows: torch.Tensor
                         ) -> torch.Tensor:
        """(R, E) dense rows of token-types ``rows``, equal to
        ``dense_probs(cfg, shared)[rows]``; families override it with
        gathered math whose cost scales with R."""
        return self.dense_probs(cfg, shared)[rows.long()]

    def sparse_prior(self, cfg, shared) -> torch.Tensor:
        """(E,) per-outcome prior mass of the document-sparse term."""
        raise NotImplementedError

    def doc_sparse_logp(self, cfg, shared, doc_rows: torch.Tensor,
                        outcome: torch.Tensor) -> torch.Tensor:
        """log(doc_e + prior_e) at ``outcome``: doc_rows (B, E), outcome
        (B,) → (B,).  Sealed, as in the reference: it resolves to
        ``mhw.doc_sparse_logp``, which the chains evaluate directly, so a
        family changes its target through ``sparse_prior`` and its sweep,
        never by overriding this."""
        return mhw.doc_sparse_logp(doc_rows, self.sparse_prior(cfg, shared),
                                   outcome)

    def accept_ratio(self, log_p_cand, log_p_cur, log_q_cur, log_q_cand
                     ) -> torch.Tensor:
        """The MH accept log ratio of paper eq. 7, the same for every
        family; sealed like :meth:`doc_sparse_logp`, resolving to
        ``mhw.accept_log_ratio``."""
        return mhw.accept_log_ratio(log_p_cand, log_p_cur, log_q_cur,
                                    log_q_cand)

    def rebuild_alias_rows(self, cfg, shared, tables, stale, rows, valid,
                           device=None):
        """Incremental alias rebuild of ``rows``: gathered dense rows, the
        compacted-rows build (kernel 5), scattered into the resident
        tables; rows with ``valid=False`` keep theirs.  The LM families
        override it with the fused gather build."""
        p_rows = self.dense_probs_rows(cfg, shared, rows)
        sub = ops.build_tables_rows(p_rows, device=device)
        return alias_mod.update_rows(tables, stale, rows, valid, sub, p_rows)

    def project(self, shared):
        """Algorithm 1 on the shared statistics."""
        return self.shared_from_dict(projection.project(
            self.stats_dict(shared), self.shared_rules, self.aggregates))

    def count_violations(self, shared) -> float:
        return float(projection.count_violations(self.stats_dict(shared),
                                                 self.shared_rules))

    def local_project(self, local):
        """The family's client-local rules (HDP's 1 ≤ m_dk ≤ n_dk) applied
        to a client's state; the identity when it has none."""
        if not self.local_rules:
            return local
        return self.local_from_dict(projection.project(
            self.local_dict(local), self.local_rules))

    def count_local_violations(self, local) -> float:
        """Elementwise violations of the client-local rules (0 when the
        family has none)."""
        if not self.local_rules:
            return 0.0
        return float(projection.count_violations(self.local_dict(local),
                                                 self.local_rules))

    def sweep(self, cfg, local, shared, tables, stale, tokens, mask, key, *,
              method="mhw", layout="scan", sorted_layouts=None, device=None,
              position_draws=None) -> tuple[Any, dict[str, torch.Tensor]]:
        """One Gibbs sweep of either layout; returns (local', {delta name:
        (V, K) delta})."""
        raise NotImplementedError

    def post_round(self, cfg, locals_: list, shared, key: device_mod.Key):
        """Per-round auxiliary step after the push and the projection
        (HDP's tables and θ0); the identity by default."""
        return locals_, shared

    # ---------------------------------------------- token-sorted fast path
    def sorted_tile_v(self, cfg) -> int:
        """The reference's vocab tile size; it only sizes the layout's
        tile-skip fields here.  The reference's ``sorted_tile_k`` (the
        K-tile of its kernels' VMEM staging) is TPU tiling and has no
        counterpart: no CUDA kernel tiles K by it."""
        return cfg.tile_v or segment.pick_tile_vmem(
            cfg.vocab_size, self.n_outcomes(cfg),
            tile_k=getattr(cfg, "tile_k", None))

    def build_sorted_layouts(self, cfg, tokens, mask
                             ) -> tuple[segment.SortedLayout, ...]:
        """The per-chunk sorted layouts :meth:`sweep_sorted` expects; build
        once per shard and reuse across sweeps."""
        l = tokens.shape[1]
        n_chunks = max(1, min(cfg.sorted_chunks, l))
        return segment.build_chunked_layouts(
            tokens, mask, cfg.vocab_size,
            bounds=segment.chunk_bounds(l, n_chunks),
            tile_v=self.sorted_tile_v(cfg), tile_b=cfg.tile_b)

    def encode(self, cfg, local) -> torch.Tensor:
        raise NotImplementedError

    def topic_of(self, cfg, e: torch.Tensor) -> torch.Tensor:
        return e

    def sorted_chunk(self, cfg, shared, tables, stale, lay, e_sorted, n_dk,
                     generator, uniforms=None, device=None) -> torch.Tensor:
        raise NotImplementedError

    def finalize_sorted(self, cfg, local, e_grid, n_dk, tokens, mask):
        raise NotImplementedError

    def sweep_sorted(self, cfg, local, shared, tables, stale, tokens, mask,
                     key: device_mod.Key, layouts, chunk_uniforms=None,
                     device=None) -> tuple[Any, dict[str, torch.Tensor]]:
        """Token-sorted MHW sweep, one kernel launch per position-chunk.

        ``key`` is the sweep's stream key; chunk c draws its uniforms from
        ``fold_in(key, c)``.  ``chunk_uniforms`` (optional) is a callback
        ``(c, lay, tile_b) -> uniforms | None`` that supplies chunk c's
        ``(slot, coin, u_mix, u_sparse, u_acc)`` streams instead.
        """
        dev = device_mod.resolve(device)
        d, l = tokens.shape
        tile_v = self.sorted_tile_v(cfg)
        n_chunks = max(1, min(cfg.sorted_chunks, l))
        bounds = segment.chunk_bounds(l, n_chunks)
        if layouts is not None and len(layouts) != n_chunks:
            raise ValueError(
                f"sorted_layouts has {len(layouts)} chunks, cfg wants "
                f"{n_chunks}; rebuild with "
                f"family.get({self.name!r}).build_sorted_layouts(cfg, ...)")

        e_grid = self.encode(cfg, local).clone()
        n_dk = local.n_dk.clone()
        for c in range(n_chunks):
            s, e = bounds[c], bounds[c + 1]
            tok_c, mask_c = tokens[:, s:e], mask[:, s:e]
            bc = d * (e - s)
            tile_b = min(cfg.tile_b, bc)
            lay = layouts[c] if layouts is not None else segment.build_layout(
                tok_c, mask_c, cfg.vocab_size, tile_v=tile_v, tile_b=tile_b)
            # Geometry guard for hoisted layouts: rows are padded to
            # tile_b, which fixes the length of the uniform streams.
            if lay.hist.shape[0] * tile_v != cfg.vocab_size:
                raise ValueError(
                    f"sorted_layouts[{c}] was built with tile_v="
                    f"{cfg.vocab_size // lay.hist.shape[0]}, sweep uses "
                    f"{tile_v}; rebuild with "
                    f"family.get({self.name!r}).build_sorted_layouts")
            if (lay.rows.shape[0] % tile_b != 0
                    or lay.vstart.shape[0] != lay.rows.shape[0] // tile_b
                    or lay.order.shape[0] != bc):
                raise ValueError(
                    f"sorted_layouts[{c}] batch tiling "
                    f"({lay.vstart.shape[0]} tiles over "
                    f"{lay.rows.shape[0]} draws) does not match "
                    f"tile_b={tile_b}")

            e_c = e_grid[:, s:e]
            e_flat = e_c.reshape(-1)
            e_s = segment.sort_values(lay, e_flat, fill=0)
            uniforms = (chunk_uniforms(c, lay, tile_b)
                        if chunk_uniforms is not None else None)
            gen = (None if uniforms is not None else
                   device_mod.generator(device_mod.fold_in(key, c), dev))
            e_new_s = self.sorted_chunk(cfg, shared, tables, stale, lay, e_s,
                                        n_dk, gen, uniforms=uniforms,
                                        device=dev)
            e_new_flat = segment.unsort_values(lay, e_new_s, e_flat)
            e_new_c = torch.where(mask_c, e_new_flat.reshape(d, e - s), e_c)

            docs_c = torch.arange(bc, device=dev) // (e - s)
            m_c = mask_c.reshape(-1).to(torch.float32)
            lda.add_at(n_dk, docs_c, self.topic_of(cfg, e_new_c.reshape(-1)),
                       m_c)
            lda.add_at(n_dk, docs_c, self.topic_of(cfg, e_flat), -m_c)
            e_grid[:, s:e] = e_new_c
        return self.finalize_sorted(cfg, local, e_grid, n_dk, tokens, mask)


class _LMFamilyBase(ModelFamily):
    """Families whose fresh factor is the LM row (n_wk − own + β)/(n_k −
    own + β̄); they differ in the per-topic prior vector."""

    def rebuild_alias_rows(self, cfg, shared, tables, stale, rows, valid,
                           device=None):
        """Incremental alias rebuild of ``rows`` (kernel 3), scattered into
        the resident tables; rows with ``valid=False`` keep theirs."""
        sub, p_rows = ops.build_tables_gather_fused(
            shared.n_wk, shared.n_k, self.sparse_prior(cfg, shared), rows,
            beta=cfg.beta, beta_bar=cfg.beta * cfg.vocab_size,
            device=device)
        return alias_mod.update_rows(tables, stale, rows, valid, sub, p_rows)

    def encode(self, cfg, local) -> torch.Tensor:
        return local.z

    def sorted_chunk(self, cfg, shared, tables, stale, lay, e_sorted, n_dk,
                     generator, uniforms=None, device=None) -> torch.Tensor:
        return ops.mhw_sweep_sorted(
            tables, stale, shared.n_wk, shared.n_k,
            self.sparse_prior(cfg, shared), lay.rows, lay.docs, e_sorted,
            n_dk, generator, mh_steps=cfg.mh_steps, beta=cfg.beta,
            beta_bar=cfg.beta * cfg.vocab_size, uniforms=uniforms,
            device=device)

    def count_stats(self, cfg, tokens, mask, local) -> dict[str, torch.Tensor]:
        return {"n_wk": lda.count_wk(cfg, tokens, local.z, mask)}

    def topics_per_word(self, shared) -> float:
        return lda.topics_per_word(
            lda.SharedStats(n_wk=shared.n_wk, n_k=shared.n_k))


class LDAFamily(_LMFamilyBase):
    name = "lda"
    config_cls = lda.LDAConfig
    shared_cls = lda.SharedStats
    local_cls = lda.LocalState
    shared_stats = ("n_wk", "n_k")
    local_stats = ("z", "n_dk")
    conserved_stats = ("n_wk",)
    delta_names = ("n_wk",)
    rules = projection.LDA_RULES
    aggregates = projection.LDA_AGGREGATES

    def init_state(self, cfg, tokens, mask, key):
        return lda.init_state(cfg, tokens, mask, key)

    def language_model(self, cfg, shared) -> torch.Tensor:
        return lda.language_model(cfg, shared)

    def dense_probs(self, cfg, shared) -> torch.Tensor:
        return lda.dense_probs(cfg, shared)

    def build_alias(self, cfg, shared):
        return lda.build_alias(cfg, shared)

    def sparse_prior(self, cfg, shared) -> torch.Tensor:
        return torch.full((cfg.n_topics,), cfg.alpha, dtype=torch.float32,
                          device=shared.n_k.device)

    def sweep(self, cfg, local, shared, tables, stale, tokens, mask, key, *,
              method="mhw", layout="scan", sorted_layouts=None,
              device=None, position_draws=None):
        local2, dwk, _ = lda.sweep(cfg, local, shared, tables, stale, tokens,
                                   mask, key, method=method, layout=layout,
                                   sorted_layouts=sorted_layouts,
                                   device=device,
                                   position_draws=position_draws)
        return local2, {"n_wk": dwk}

    def apply_delta(self, shared, deltas):
        n_wk = shared.n_wk + deltas["n_wk"]
        return lda.SharedStats(n_wk=n_wk, n_k=n_wk.sum(0))

    def finalize_sorted(self, cfg, local, e_grid, n_dk, tokens, mask):
        dwk = lda.delta_wk(cfg, tokens, mask, local.z, e_grid)
        return lda.LocalState(z=e_grid, n_dk=n_dk), {"n_wk": dwk}

    def perplexity(self, cfg, shared, tokens, mask, key) -> float:
        return lda.perplexity(cfg, shared, tokens, mask, key)


class HDPFamily(_LMFamilyBase):
    name = "hdp"
    config_cls = hdp.HDPConfig
    shared_cls = hdp.SharedStats
    local_cls = hdp.LocalState
    shared_stats = ("n_wk", "n_k", "m_k", "theta0")
    local_stats = ("z", "n_dk", "m_dk")
    replicated_stats = ("theta0",)
    conserved_stats = ("n_wk",)
    delta_names = ("n_wk",)
    rules = projection.HDP_RULES
    aggregates = projection.HDP_AGGREGATES

    def init_state(self, cfg, tokens, mask, key):
        return hdp.init_state(cfg, tokens, mask, key)

    def language_model(self, cfg, shared) -> torch.Tensor:
        return hdp.language_model(cfg, shared)

    def dense_probs(self, cfg, shared) -> torch.Tensor:
        return hdp.dense_probs(cfg, shared)

    def build_alias(self, cfg, shared):
        return hdp.build_alias(cfg, shared)

    def sparse_prior(self, cfg, shared) -> torch.Tensor:
        return cfg.b1 * shared.theta0

    def sweep(self, cfg, local, shared, tables, stale, tokens, mask, key, *,
              method="mhw", layout="scan", sorted_layouts=None,
              device=None, position_draws=None):
        local2, dwk, _ = hdp.sweep(cfg, local, shared, tables, stale, tokens,
                                   mask, key, method=method, layout=layout,
                                   sorted_layouts=sorted_layouts,
                                   device=device,
                                   position_draws=position_draws)
        return local2, {"n_wk": dwk}

    def apply_delta(self, shared, deltas):
        n_wk = shared.n_wk + deltas["n_wk"]
        return hdp.SharedStats(n_wk=n_wk, n_k=n_wk.sum(0), m_k=shared.m_k,
                               theta0=shared.theta0)

    def finalize_sorted(self, cfg, local, e_grid, n_dk, tokens, mask):
        dwk = lda.delta_wk(cfg, tokens, mask, local.z, e_grid)
        return (hdp.LocalState(z=e_grid, n_dk=n_dk, m_dk=local.m_dk),
                {"n_wk": dwk})

    def post_round(self, cfg, locals_, shared, key):
        """CRT tables per client (client c's stream ``fold_in(key, c)``);
        m_k sums across clients, then θ0 | m_k (stream
        ``fold_in(key, 101)``), as the reference keys them."""
        dev = shared.n_k.device
        locals_ = list(locals_)
        m_k_total = None
        for c, loc in enumerate(locals_):
            locals_[c], m_k = hdp.resample_tables(
                cfg, loc, shared,
                device_mod.generator(device_mod.fold_in(key, c), dev))
            m_k_total = m_k if m_k_total is None else m_k_total + m_k
        theta0 = hdp.resample_theta0(
            cfg, m_k_total,
            device_mod.generator(device_mod.fold_in(key, 101), dev))
        return locals_, shared._replace(m_k=m_k_total, theta0=theta0)

    def perplexity(self, cfg, shared, tokens, mask, key) -> float:
        return hdp.perplexity(cfg, shared, tokens, mask, key)


class PDPFamily(ModelFamily):
    name = "pdp"
    config_cls = pdp.PDPConfig
    shared_cls = pdp.SharedStats
    local_cls = pdp.LocalState
    shared_stats = ("m_wk", "s_wk", "m_k", "s_k")
    local_stats = ("z", "r", "n_dk")
    # s_wk is not count-conserved: the init repair and the projection
    # adjust table counts without rewriting the per-token r indicators.
    conserved_stats = ("m_wk",)
    delta_names = ("m_wk", "s_wk")
    rules = projection.PDP_RULES
    aggregates = projection.PDP_AGGREGATES

    def init_state(self, cfg, tokens, mask, key):
        return pdp.init_state(cfg, tokens, mask, key)

    def n_outcomes(self, cfg) -> int:
        return 2 * cfg.n_topics

    def language_model(self, cfg, shared) -> torch.Tensor:
        return pdp.language_model(cfg, shared)

    def dense_probs(self, cfg, shared) -> torch.Tensor:
        return pdp.dense_probs(cfg, shared)

    def dense_probs_rows(self, cfg, shared, rows) -> torch.Tensor:
        # Both m_wk and s_wk rows feed the 2K columns, which is why
        # alias_delta_stats tracks the drift of both.
        r = rows.long()
        return pdp.dense_rows(cfg, shared.m_wk[r], shared.s_wk[r],
                              shared.m_k, shared.s_k)

    def build_alias(self, cfg, shared):
        return pdp.build_alias(cfg, shared)

    def sparse_prior(self, cfg, shared) -> torch.Tensor:
        return torch.full((2 * cfg.n_topics,), cfg.alpha, dtype=torch.float32,
                          device=shared.m_k.device)

    def sweep(self, cfg, local, shared, tables, stale, tokens, mask, key, *,
              method="mhw", layout="scan", sorted_layouts=None,
              device=None, position_draws=None):
        local2, dm, ds = pdp.sweep(cfg, local, shared, tables, stale, tokens,
                                   mask, key, method=method, layout=layout,
                                   sorted_layouts=sorted_layouts,
                                   device=device,
                                   position_draws=position_draws)
        return local2, {"m_wk": dm, "s_wk": ds}

    def apply_delta(self, shared, deltas):
        return pdp.apply_delta(shared, deltas["m_wk"], deltas["s_wk"])

    def count_stats(self, cfg, tokens, mask, local) -> dict[str, torch.Tensor]:
        return {"m_wk": pdp._count(cfg, tokens, local.z, mask,
                                   torch.ones_like(local.r)),
                "s_wk": pdp._count(cfg, tokens, local.z, mask, local.r)}

    def topics_per_word(self, shared) -> float:
        return lda.topics_per_word(
            lda.SharedStats(n_wk=shared.m_wk, n_k=shared.m_k))

    def encode(self, cfg, local) -> torch.Tensor:
        return local.z + cfg.n_topics * local.r

    def topic_of(self, cfg, e: torch.Tensor) -> torch.Tensor:
        return e % cfg.n_topics

    def sorted_chunk(self, cfg, shared, tables, stale, lay, e_sorted, n_dk,
                     generator, uniforms=None, device=None) -> torch.Tensor:
        stirl = stirling.as_tensor(cfg.stirling_n_max, cfg.discount,
                                   shared.m_wk.device)
        return ops.pdp_sweep_sorted(
            tables, stale, shared.m_wk, shared.s_wk, shared.m_k, shared.s_k,
            stirl, self.sparse_prior(cfg, shared), lay.rows, lay.docs,
            e_sorted, n_dk, generator, mh_steps=cfg.mh_steps,
            concentration=cfg.concentration, discount=cfg.discount,
            gamma=cfg.gamma, gamma_bar=cfg.gamma * cfg.vocab_size,
            uniforms=uniforms, device=device)

    def finalize_sorted(self, cfg, local, e_grid, n_dk, tokens, mask):
        z_new = e_grid % cfg.n_topics
        r_new = e_grid // cfg.n_topics
        dm, ds = pdp.deltas_from(cfg, tokens, mask, local.z, local.r, z_new,
                                 r_new)
        return (pdp.LocalState(z=z_new, r=r_new, n_dk=n_dk),
                {"m_wk": dm, "s_wk": ds})

    def perplexity(self, cfg, shared, tokens, mask, key) -> float:
        return pdp.perplexity(cfg, shared, tokens, mask, key)


FAMILIES: dict[str, ModelFamily] = {}


def register(family: ModelFamily) -> ModelFamily:
    """Register a family singleton under its name (last wins); rejects a
    family whose rules mix shared and local statistics."""
    dropped = (set(family.rules) - set(family.shared_rules)
               - set(family.local_rules))
    if dropped:
        raise ValueError(
            f"family {family.name!r}: rules {sorted(r.a for r in dropped)} "
            "span shared and local statistics")
    FAMILIES[family.name] = family
    return family


register(LDAFamily())
register(PDPFamily())
register(HDPFamily())


def get(name: str) -> ModelFamily:
    try:
        return FAMILIES[name]
    except KeyError:
        raise KeyError(f"unknown model family {name!r}; registered: "
                       f"{sorted(FAMILIES)}") from None


def family_of(cfg: Any) -> ModelFamily:
    for fam in FAMILIES.values():
        if isinstance(cfg, fam.config_cls):
            return fam
    raise TypeError(f"no registered ModelFamily for config {type(cfg)!r}")


def names() -> Sequence[str]:
    return sorted(FAMILIES)
