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
own capacity), batched over the groups.

Over a mesh (the hooks of ``models/layers.py``) a rank holds a block of
the tokens.  The router and the load-balance statistics are computed on
its own tokens, the statistics summed over the ranks that hold distinct
tokens before their product (the reference's SPMD program computes them
over all tokens).  The dispatch then takes one of four forms:

* the rank's tokens are whole groups (rows laid out contiguously, the
  group size dividing them): the groups are dispatched locally;
* the reference's expert-parallel all-to-all (:func:`_moe_a2a`), under
  its condition: a model axis, the batch over every axis (zero_batch),
  one group a rank and E divisible by the model axis.  Each model rank
  holds E/m experts (their weights gathered over the other axes only);
* zero_seq, where every group lies within one data rank's rows (the dry
  run's group a row): each model rank dispatches a contiguous block of
  its data rank's groups (``layers.seq_groups``, the reference's G over
  (data, model) where ``model`` divides them), their tokens and routes
  brought from its model peers by one all-to-all each (``moe seq``,
  ``moe seq route``) and the outputs sent back by one more (``moe seq
  back``);
* else a group spans data ranks (``moe_groups`` unset, or fewer groups
  than data ranks, under megatron or zero_seq): the token group is
  gathered before the stable sort, since capacity drops depend on the
  whole group, every rank dispatches all groups, and keeps its own
  tokens' outputs (the reference replicates the sort there too).

Under megatron's tensor-parallel layout (``layers.tensor_parallel``) the
model ranks hold the same tokens and compute the same route and dispatch;
each runs its own E/m experts on the slots routed to them (E dividing m,
expert parallel), else its d_ff slice of every expert, and the combine's
float32 partial sums are summed over ``model`` and rounded once.  The
tokens and the gates enter through ``collectives.all_reduce_grad``, so
their gradients, and the router's, are the whole ones on every rank.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives
from repro_torch.models import layers
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


def _experts(p: Params, buf: torch.Tensor, dtype,
             partial: bool = False) -> torch.Tensor:
    """The expert MLPs of a (G, E, C, D) buffer; ``partial``: ``p`` holds
    a d_ff slice, and the output is its float32 partial sum."""
    gate_h = einsum_f32("gecd,edf->gecf", buf, cast(p["w_gate"]))
    up_h = einsum_f32("gecd,edf->gecf", buf, cast(p["w_up"]))
    h = (F.silu(gate_h) * up_h).to(dtype)
    if partial:
        return einsum_f32("gecf,efd->gecd", h, cast(p["w_down"]))
    return einsum("gecf,efd->gecd", h, cast(p["w_down"])).to(dtype)


def _experts_tp(cfg: ModelConfig, p: Params, buf: torch.Tensor, slot,
                keep, meta, t: int, dtype) -> torch.Tensor:
    """The tensor-parallel experts and combine of a dispatched (G, E, C,
    D) buffer: the rank's E/m experts whole (their slots only), else its
    d_ff slice of every expert; the combine of the rank's float32
    contributions summed over ``model``, rounded once to ``dtype``."""
    e, m = cfg.n_experts, layers.model_size()
    if e % m == 0:
        lo, hi = layers.split_ranges(e, m)[
            layers.get_mesh().get_local_rank("model")]
        mine = _experts(p, buf[:, lo:hi], dtype).float()
        g, _, c, d = buf.shape
        out_buf = torch.cat([mine.new_zeros((g, lo, c, d)), mine,
                             mine.new_zeros((g, e - hi, c, d))], dim=1)
    else:
        out_buf = _experts(p, buf, dtype, partial=True)
    out = _combine(out_buf, slot, keep, meta, t, torch.float32)
    return collectives.all_reduce_value(out, layers.model_group(),
                                        "moe out").to(dtype)


def _groups(cfg: ModelConfig, t_all: int) -> int:
    g = cfg.moe_groups or 1
    return 1 if t_all % g else g


def a2a_applies(cfg: ModelConfig, t_all: int) -> bool:
    """The reference's condition for :func:`_moe_a2a`: a mesh with a model
    axis, a batch spec covering ``model`` (zero_batch, in training or in
    a served prefill), one token group a device and E divisible by the
    model axis."""
    mesh = layers.get_mesh()
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return False
    rows = layers.token_spec()[0]
    batch_covers_model = isinstance(rows, tuple) and "model" in rows
    return (batch_covers_model and _groups(cfg, t_all) == mesh.size()
            and cfg.n_experts % layers.model_size() == 0)


def block_gather_specs(cfg: ModelConfig, specs, n_tokens: int):
    """The blocks' specs to gather at use: under :func:`_moe_a2a` the
    expert weights keep their expert dim local (each model rank computes
    its own E/m experts), so ``model`` leaves their gather."""
    if specs is None or not a2a_applies(cfg, n_tokens * layers.token_ranks()):
        return specs
    moe = {n: (sp[0], None) + tuple(sp[2:]) if n.startswith("w_") else sp
           for n, sp in specs["moe"].items()}
    return dict(specs, moe=moe)


def _constrain_dispatch(buf: torch.Tensor) -> torch.Tensor:
    """The reference pins its (G, E, C, D) dispatch buffer to the device
    grid so the data-dependent scatter stays local; a rank's buffer here
    is already local."""
    return buf


def _moe_a2a(cfg: ModelConfig, p: Params, xt: torch.Tensor,
             gate_vals: torch.Tensor, expert_ids: torch.Tensor, c: int,
             dtype) -> torch.Tensor:
    """Expert-parallel MoE with explicit all-to-all, one token group a rank
    (the reference's ``_moe_a2a``):
      1. rank-local sort-based dispatch → (E, C, D);
      2. ``all_to_all`` over the model group: each model rank keeps its
         E/m experts and receives their tokens from its peers →
         (E/m, m·C, D), the peers in rank order;
      3. the expert MLPs on the rank's E/m experts (``p``'s expert dim is
         already local);
      4. the reverse all-to-all and the rank-local combine.
    Two all-to-alls of exactly the dispatched bytes; their backward is the
    same exchange in reverse."""
    t, d = xt.shape
    e, m = cfg.n_experts, layers.model_size()
    group = layers.get_mesh().get_group("model")
    buf, slot, keep, meta = _dispatch(cfg, xt[None], gate_vals[None],
                                      expert_ids[None], c)
    send = _constrain_dispatch(buf)[0].reshape(m, e // m, c, d)
    recv = collectives.all_to_all(send, group, "moe dispatch")
    buf2 = recv.transpose(0, 1).reshape(1, e // m, m * c, d)
    out_buf = _experts(p, buf2, dtype)[0]
    back = out_buf.reshape(e // m, m, c, d).transpose(0, 1)
    back = collectives.all_to_all(back, group, "moe combine")
    return _combine(back.reshape(1, e, c, d), slot, keep, meta, t, dtype)[0]


def moe_block(cfg: ModelConfig, p: Params, x: torch.Tensor):
    """x: (B, S, D) → (out, aux_loss).

    Dispatch is grouped (``cfg.moe_groups`` token groups): each group
    sorts and packs its own tokens with a per-group capacity.  On a mesh
    ``x`` is the rank's token block and the groups are those of the global
    batch (see the module docstring).
    """
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    ranks = layers.token_ranks()
    t_all = t * ranks
    g = _groups(cfg, t_all)
    tg = t_all // g
    c = capacity(cfg, tg)
    xt = x.reshape(t, d)

    logits = einsum_f32("td,de->te", xt, cast(p["router"]))
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = top_k(probs, k)                   # (T, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    # Load-balance auxiliary loss (Switch-style): E * Σ_e f_e · P_e, its
    # statistics over every token of the batch
    if ranks == 1:
        me = probs.mean(0)
    else:
        me = layers.tokens_sum(probs.sum(0), "moe me") / t_all
    ce = torch.zeros((e,), dtype=torch.float32, device=x.device).index_add(
        0, expert_ids.reshape(-1),
        torch.full((t * k,), 1.0 / (t_all * k), dtype=torch.float32,
                   device=x.device))
    ce = layers.tokens_sum(ce, "moe ce")
    aux = e * torch.sum(me * ce) * cfg.router_aux_weight

    if a2a_applies(cfg, t_all):
        out = _moe_a2a(cfg, p, xt, gate_vals, expert_ids, c, x.dtype)
        return out.reshape(b, s, d), aux

    tp = layers.tensor_parallel()
    if tp:
        x = layers.replicated_in(x, "moe in")
        xt = x.reshape(t, d)
        gate_vals = layers.replicated_in(gate_vals, "moe gates in")
    parts = layers.seq_groups(b, s, tg)
    contiguous = not layers.sequence_sharded() or layers.model_size() == 1
    spans = parts is None and ranks > 1 and not (contiguous and t % tg == 0)
    if parts is not None:
        # zero_seq: the rank's block of its data rank's groups, their
        # tokens and routes (the ids exact as float32) from its model peers
        xt = layers.to_groups(x, parts, "moe seq")
        route = torch.cat([gate_vals, expert_ids.to(gate_vals.dtype)], -1)
        route = layers.to_groups(route.reshape(b, s, 2 * k), parts,
                                 "moe seq route")
        gate_vals, expert_ids = route[:, :k], route[:, k:].long()
    elif spans:
        # a group spans ranks: gather the token group before the sort
        xg = layers.gather_tokens(x, "moe tokens")
        shape = xg.shape
        xt = xg.reshape(-1, d)
        gate_vals = layers.gather_tokens(gate_vals.reshape(b, s, k),
                                         "moe gates").reshape(-1, k)
        expert_ids = layers.gather_tokens(expert_ids.reshape(b, s, k),
                                          "moe ids").reshape(-1, k)
    n = xt.shape[0] // tg
    buf, slot, keep, meta = _dispatch(cfg, xt.reshape(n, tg, d),
                                      gate_vals.reshape(n, tg, k),
                                      expert_ids.reshape(n, tg, k), c)
    if tp:
        out = _experts_tp(cfg, p, _constrain_dispatch(buf), slot, keep, meta,
                          tg, x.dtype)
    else:
        out_buf = _experts(p, _constrain_dispatch(buf), x.dtype)
        out = _combine(out_buf, slot, keep, meta, tg, x.dtype)
    if parts is not None:
        out = layers.from_groups(out.reshape(-1, d), parts, b, "moe seq back")
    elif spans:
        out = layers.local_tokens(out.reshape(shape))
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
