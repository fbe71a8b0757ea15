"""Mixture-of-Experts layer: top-k routing with capacity-bounded, sort-based
dispatch (port of ``repro.models.moe``; no dense (T, E, C) one-hot
dispatch tensors).

Dispatch algorithm (static shapes throughout), per token group:
  1. router logits → top-k experts + weights per token (ties to the lower
     expert id, as ``jax.lax.top_k``);
  2. flatten (token, slot) pairs, sort them by expert id, stably (the
     reference's ``jnp.argsort`` is stable: which tokens a full expert
     drops depends on it);
  3. position-in-expert via sorted-order cumsum; tokens beyond the per-expert
     capacity C = ceil(T·k/E · capacity_factor) are *dropped* (standard
     Switch/GShard semantics; the router aux loss keeps loads balanced);
  4. scatter into the (E, C, D) buffer, batched expert matmuls, scatter back
     weighted by router gates.

The dispatch is grouped (``cfg.moe_groups`` token groups, each with its
own capacity), batched over the groups.  The expert-parallel all-to-all
form of the reference (``_moe_a2a``) runs over a mesh and waits for
ROADMAP A.13b.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import cast, einsum, einsum_f32, normal

Params = dict[str, Any]


def init_moe(cfg: ModelConfig, gen: torch.Generator, device,
             n: tuple[int, ...] = ()) -> Params:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    return {
        "router": normal(gen, n + (d, e), s_in, device),
        "w_gate": normal(gen, n + (e, d, f), s_in, device),
        "w_up": normal(gen, n + (e, d, f), s_in, device),
        "w_down": normal(gen, n + (e, f, d), s_out, device),
    }


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts
                      * cfg.capacity_factor))
    return max(8, ((c + 7) // 8) * 8)  # pad to an 8-multiple for tiling


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last dim, ties to the
    lower index (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch(cfg: ModelConfig, xg: torch.Tensor, gateg: torch.Tensor,
              idsg: torch.Tensor, c: int):
    """Sort-based dispatch of G token groups: (G, T', D) → (G, E, C, D)
    buffer plus (slot, keep, sorted token, sorted gate) combine metadata,
    each (G, T'·k)."""
    g, t, d = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    dev = xg.device
    flat_expert = idsg.reshape(g, t * k)
    flat_gate = gateg.reshape(g, t * k)
    order = torch.sort(flat_expert, dim=-1, stable=True).indices
    sorted_expert = torch.gather(flat_expert, 1, order)
    sorted_token = order // k                    # flat (token, slot) → token
    sorted_gate = torch.gather(flat_gate, 1, order)

    # position of each (token, slot) within its expert's queue
    counts = torch.zeros((g, e), dtype=torch.int64, device=dev).scatter_add_(
        1, sorted_expert, torch.ones_like(sorted_expert))
    offsets = torch.cumsum(counts, dim=1) - counts
    pos_in_expert = (torch.arange(t * k, device=dev)[None]
                     - torch.gather(offsets, 1, sorted_expert))
    keep = pos_in_expert < c

    # scatter tokens into the (E, C, D) buffer; dropped ones to a spare row
    slot = torch.where(keep, sorted_expert * c + pos_in_expert, e * c)
    rows = (torch.arange(g, device=dev)[:, None] * (e * c + 1) + slot)
    src = torch.gather(xg, 1, sorted_token[..., None].expand(g, t * k, d))
    buf = xg.new_zeros((g * (e * c + 1), d)).index_add(
        0, rows.reshape(-1), src.reshape(-1, d))
    buf = buf.reshape(g, e * c + 1, d)[:, :-1].reshape(g, e, c, d)
    return buf, slot, keep, (sorted_token, sorted_gate)


def _combine(out_buf: torch.Tensor, slot, keep, meta, t: int, dtype):
    """Scatter expert outputs of every group back to (G, T', D) token
    order, each token's k outputs summed in ``dtype`` in sorted order."""
    sorted_token, sorted_gate = meta
    g, e, c, d = out_buf.shape
    idx = torch.where(keep, slot, 0)
    gathered = torch.gather(out_buf.reshape(g, e * c, d), 1,
                            idx[..., None].expand(*idx.shape, d))
    gathered = torch.where(keep[..., None], gathered, 0.0)
    rows = torch.arange(g, device=out_buf.device)[:, None] * t + sorted_token
    contrib = gathered * sorted_gate[..., None].to(dtype)
    out = torch.zeros((g * t, d), dtype=dtype, device=out_buf.device)
    return out.index_add(0, rows.reshape(-1),
                         contrib.reshape(-1, d).to(dtype)).reshape(g, t, d)


def moe_block(cfg: ModelConfig, p: Params, x: torch.Tensor):
    """x: (B, S, D) → (out, aux_loss).

    Dispatch is grouped (``cfg.moe_groups`` token groups): each group
    sorts and packs its own tokens with a per-group capacity.
    """
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    g = cfg.moe_groups or 1
    if t % g:
        g = 1
    tg = t // g
    c = capacity(cfg, tg)
    xt = x.reshape(t, d)

    logits = einsum_f32("td,de->te", xt, cast(p["router"]))
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = top_k(probs, k)                   # (T, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    # Load-balance auxiliary loss (Switch-style): E * Σ_e f_e · P_e
    me = probs.mean(0)
    ce = torch.zeros((e,), dtype=torch.float32, device=x.device).index_add(
        0, expert_ids.reshape(-1),
        torch.full((t * k,), 1.0 / (t * k), dtype=torch.float32,
                   device=x.device))
    aux = e * torch.sum(me * ce) * cfg.router_aux_weight

    buf, slot, keep, meta = _dispatch(cfg, xt.reshape(g, tg, d),
                                      gate_vals.reshape(g, tg, k),
                                      expert_ids.reshape(g, tg, k), c)
    gate_h = einsum("gecd,edf->gecf", buf, cast(p["w_gate"])).float()
    up_h = einsum("gecd,edf->gecf", buf, cast(p["w_up"])).float()
    h = (F.silu(gate_h) * up_h).to(x.dtype)
    out_buf = einsum("gecf,efd->gecd", h, cast(p["w_down"])).to(x.dtype)
    out = _combine(out_buf, slot, keep, meta, tg, x.dtype)
    return out.reshape(b, s, d), aux


def moe_block_dense_ref(cfg: ModelConfig, p: Params,
                        x: torch.Tensor) -> torch.Tensor:
    """Oracle: evaluate every expert on every token and mix by gates
    (no capacity drops).  Used by tests on small shapes."""
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    logits = torch.einsum("td,de->te", xt, p["router"].to(x.dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, expert_ids = top_k(probs, cfg.top_k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    gate_h = torch.einsum("td,edf->etf", xt, p["w_gate"].to(x.dtype))
    up_h = torch.einsum("td,edf->etf", xt, p["w_up"].to(x.dtype))
    h = F.silu(gate_h) * up_h
    all_out = torch.einsum("etf,efd->etd", h, p["w_down"].to(x.dtype))

    mask = F.one_hot(expert_ids, cfg.n_experts).float()
    weights = torch.einsum("tk,tke->te", gate_vals, mask)     # (T, E)
    out = torch.einsum("te,etd->td", weights.to(x.dtype), all_out)
    return out.reshape(b, s, d)
