"""Shared neural building blocks (port of ``repro.models.layers``).

Functions on trees of tensors: a block's parameters are a dict of
tensors with the reference's names and shapes, and every function here
is the reference's function of the same name.

Weight layout notes:
- Attention projections are stored 3-D as (d_model, n_heads, head_dim),
  as the reference stores them.
- Mixed precision: master weights stay f32 and are cast to
  ``COMPUTE_DTYPE`` (bf16) at use.  A product of two ``COMPUTE_DTYPE``
  operands accumulates in f32 and is rounded once to ``COMPUTE_DTYPE``
  (:func:`einsum`), as the reference's ``preferred_element_type=f32``
  followed by ``.astype``.  Where the reference keeps the f32 product
  (attention scores, the MLP's gate and up, the SSM projections) the
  port widens the rounded product: one bf16 rounding
  (relative 2^-9) the reference does not make, the usual practice of
  PyTorch's bf16 models.  The logits and the router's product, which
  decide an argmax or a route, keep the f32 product exactly
  (:func:`einsum_f32`).  With ``COMPUTE_DTYPE = torch.float32`` the two
  packages compute the same products.  A product with one f32 operand runs
  in f32, as JAX promotes it.
- The zero-mode hooks of the reference (``set_activation_spec``,
  ``constrain``) shard activations over a mesh; off a mesh they are the
  identity, and the mesh modes wait for ROADMAP A.13b.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig

Params = dict[str, Any]

COMPUTE_DTYPE = torch.bfloat16


def cast(x: torch.Tensor) -> torch.Tensor:
    return x.to(COMPUTE_DTYPE)


def einsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` of two operands in their common dtype: f32
    accumulation, one rounding to a ``COMPUTE_DTYPE`` result; f32 when
    either operand is f32 (JAX's promotion)."""
    if a.dtype != b.dtype:
        a, b = a.float(), b.float()
    return torch.einsum(spec, a, b)


def einsum_f32(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The reference's f32-kept product exactly: ``COMPUTE_DTYPE``
    operands widened to f32 (their products are exact there), an f32
    matmul.  For the logits and the router, whose values decide an argmax
    or a route."""
    return torch.einsum(spec, a.float(), b.float())


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * scale.float()).to(dt)


def init_rms_norm(d: int, device, n: tuple[int, ...] = ()) -> torch.Tensor:
    return torch.ones(n + (d,), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) or (S,)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)              # (hd/2,)
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs              # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, optional sliding window / qk-norm / bias), q-chunked
# ---------------------------------------------------------------------------

def normal(gen: torch.Generator, shape, scale: float, device) -> torch.Tensor:
    """N(0, 1) draws of ``shape`` from ``gen``, times ``scale`` (the
    reference's ``jax.random.normal(k, shape) * scale``)."""
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device) * scale


def init_attention(cfg: ModelConfig, gen: torch.Generator, device,
                   n: tuple[int, ...] = ()) -> Params:
    """Attention weights, stacked over leading dims ``n`` (layers)."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    s_in = 1.0 / math.sqrt(d)
    s_out = 1.0 / math.sqrt(h * hd)
    p = {
        "wq": normal(gen, n + (d, h, hd), s_in, device),
        "wk": normal(gen, n + (d, kv, hd), s_in, device),
        "wv": normal(gen, n + (d, kv, hd), s_in, device),
        "wo": normal(gen, n + (h, hd, d), s_out, device),
    }
    zeros = lambda *shape: torch.zeros(n + shape, dtype=torch.float32,
                                       device=device)
    if cfg.attn_bias:
        p["bq"], p["bk"], p["bv"] = zeros(h, hd), zeros(kv, hd), zeros(kv, hd)
    if cfg.qk_norm:
        p["q_norm"] = init_rms_norm(hd, device, n)
        p["k_norm"] = init_rms_norm(hd, device, n)
    return p


def qkv_project(cfg: ModelConfig, p: Params, x: torch.Tensor,
                positions: torch.Tensor, rope: bool = True):
    q = einsum("bsd,dhk->bshk", x, cast(p["wq"])).to(x.dtype)
    k = einsum("bsd,dhk->bshk", x, cast(p["wk"])).to(x.dtype)
    v = einsum("bsd,dhk->bshk", x, cast(p["wv"])).to(x.dtype)
    if cfg.attn_bias:
        q = q + cast(p["bq"])
        k = k + cast(p["bk"])
        v = v + cast(p["bv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
         window: int = 0, q_offset: torch.Tensor | int = 0,
         kv_len: torch.Tensor | None = None,
         q_chunk: int = 1024) -> torch.Tensor:
    """Grouped-query scaled dot-product attention, chunked over queries.

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd).  ``q_offset`` is the absolute
    position of q[0] (decode: cache length so far).  ``kv_len`` optionally
    masks the valid prefix of the KV buffers (decode with preallocated
    caches).  Masked scores are -1e30.  Queries are chunked at the largest
    divisor of Sq not above ``q_chunk`` (Sq=1500 → 750), each chunk
    recomputed in backward (``torch.utils.checkpoint``), so the transient
    score buffer is (B, KV, rep, q_chunk, Sk), never Sq × Sk.
    """
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    rep = h // kv
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, sq, kv, rep, hd)
    kpos = torch.arange(sk, device=q.device)

    def attend(q_blk: torch.Tensor, blk_offset: int) -> torch.Tensor:
        c = q_blk.shape[1]
        scores = einsum("bqgrh,bkgh->bgrqk", q_blk, k).float() * scale
        qpos = blk_offset + torch.arange(c, device=q.device) + q_offset
        mask = torch.ones((c, sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window:
            mask &= kpos[None, :] > qpos[:, None] - window
        if kv_len is not None:
            mask &= kpos[None, :] < kv_len
        scores = torch.where(mask, scores, -1e30)
        probs = torch.softmax(scores, dim=-1)
        out = einsum("bgrqk,bkgh->bqgrh", probs.to(q.dtype), v)
        return out.to(q.dtype).reshape(b, c, h, hd)

    if sq <= q_chunk:
        return attend(qg, 0)
    while sq % q_chunk:
        q_chunk -= 1
    outs = [checkpoint(attend, qg[:, i:i + q_chunk], i, use_reentrant=False)
            for i in range(0, sq, q_chunk)]
    return torch.cat(outs, dim=1)


def attention_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                    positions: torch.Tensor, *, causal: bool = True,
                    rope: bool = True, window: int | None = None
                    ) -> torch.Tensor:
    q, k, v = qkv_project(cfg, p, x, positions, rope=rope)
    w = cfg.sliding_window if window is None else window
    out = sdpa(q, k, v, causal=causal, window=w)
    return einsum("bshk,hkd->bsd", out, cast(p["wo"])).to(x.dtype)


def cross_attention_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                          mem_k: torch.Tensor, mem_v: torch.Tensor
                          ) -> torch.Tensor:
    """Decoder cross-attention over precomputed encoder K/V (no rope)."""
    q = einsum("bsd,dhk->bshk", x, cast(p["wq"])).to(x.dtype)
    out = sdpa(q, mem_k, mem_v, causal=False)
    return einsum("bshk,hkd->bsd", out, cast(p["wo"])).to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(cfg: ModelConfig, gen: torch.Generator, device,
             n: tuple[int, ...] = (), kind: str = "swiglu") -> Params:
    d, f = cfg.d_model, cfg.d_ff
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    if kind == "swiglu":
        return {"w_gate": normal(gen, n + (d, f), s_in, device),
                "w_up": normal(gen, n + (d, f), s_in, device),
                "w_down": normal(gen, n + (f, d), s_out, device)}
    return {"w_up": normal(gen, n + (d, f), s_in, device),      # gelu
            "w_down": normal(gen, n + (f, d), s_out, device)}


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp_block(p: Params, x: torch.Tensor) -> torch.Tensor:
    if "w_gate" in p:
        gate = einsum("bsd,df->bsf", x, cast(p["w_gate"])).float()
        up = einsum("bsd,df->bsf", x, cast(p["w_up"])).float()
        h = (F.silu(gate) * up).to(x.dtype)
    else:
        up = einsum("bsd,df->bsf", x, cast(p["w_up"])).float()
        h = gelu(up).to(x.dtype)
    return einsum("bsf,fd->bsd", h, cast(p["w_down"])).to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embed(cfg: ModelConfig, gen: torch.Generator, device) -> torch.Tensor:
    return normal(gen, (cfg.padded_vocab, cfg.d_model),
                  1.0 / math.sqrt(cfg.d_model), device)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens.long(), cast(table))


def unembed(table: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Logits against the (possibly tied) embedding table: (B, S, Vp),
    f32."""
    return einsum_f32("bsd,vd->bsv", h, cast(table))
