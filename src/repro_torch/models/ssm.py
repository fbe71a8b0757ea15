"""SSM / linear-recurrence blocks: RWKV-6 (Finch) and Mamba-2 (SSD) (port
of ``repro.models.ssm``).

Both ride on :mod:`repro_torch.models.linear_attn`; the block code handles
the projections, data-dependent decay, token shift / short conv, and
gating.

RWKV-6 [arXiv:2404.05892]: data-dependent decay
w_t = exp(-exp(w0 + tanh(x̃ Wa) Wb)); the r/k/v/g token-shift interpolation
uses static learned mixes.

Mamba-2 [arXiv:2405.21060-style SSD as used by Zamba2]: scalar-per-head
decay exp(-softplus(dt)·exp(A_log)), depthwise causal conv front, RMSNorm
gate, D skip.

The decode cache keeps RWKV's token-shift carries in f32, as the
reference's does, but the carried value (a normalized input, so exact in
the compute dtype) is mixed in the compute dtype, as the forward mixes
its shifted input: a decode step computes what the forward computes at
that position.  The reference's step promotes the mix to f32 instead, so
its decode and its forward part by a bf16 rounding of every mixed input
(one cause of its intermittent round-trip failure, ROADMAP C.2).
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.models import linear_attn as la
from repro_torch.models.layers import (cast, einsum, init_rms_norm, normal,
                                       rms_norm)

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# RWKV-6 time mix + channel mix
# ---------------------------------------------------------------------------

def rwkv_dims(cfg: ModelConfig) -> tuple[int, int]:
    h = cfg.ssm_heads or cfg.d_model // 64
    return h, cfg.d_model // h  # (heads, head_dim)


def init_rwkv6_time_mix(cfg: ModelConfig, gen: torch.Generator, device,
                        n: tuple[int, ...] = ()) -> Params:
    d = cfg.d_model
    h, hd = rwkv_dims(cfg)
    lora = max(32, d // 16)
    s = 1.0 / math.sqrt(d)
    full = lambda value: torch.full(n + (d,), value, dtype=torch.float32,
                                    device=device)
    return {
        "mix_r": full(0.5), "mix_k": full(0.5), "mix_v": full(0.5),
        "mix_g": full(0.5), "mix_w": full(0.5),
        "wr": normal(gen, n + (d, d), s, device),
        "wk": normal(gen, n + (d, d), s, device),
        "wv": normal(gen, n + (d, d), s, device),
        "wg": normal(gen, n + (d, d), s, device),
        "wo": normal(gen, n + (d, d), s, device),
        # data-dependent decay LoRA: w = exp(-exp(w0 + tanh(x Wa) Wb))
        "w0": full(-2.0),
        "wa": normal(gen, n + (d, lora), s, device),
        "wb": normal(gen, n + (lora, d), 1.0 / math.sqrt(lora), device),
        "u": normal(gen, n + (h, hd), 0.1, device),            # bonus
        "ln_out": init_rms_norm(d, device, n),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """x_{t-1} with x_{-1} = prev (decode carry) or 0, in x's dtype."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


def _rwkv_projections(cfg, p, x, xp):
    """r, k, v, g (f32) and the log decay of the mixed inputs."""
    def mixed(name):
        m = cast(p["mix_" + name])
        return x * m + xp * (1.0 - m)

    r, k, v, g = (einsum("bsd,de->bse", mixed(n), cast(p["w" + n])).float()
                  for n in ("r", "k", "v", "g"))
    # data-dependent decay (per channel = per (head, key-dim))
    lw = (p["w0"].float()
          + torch.tanh(einsum("bsd,dl->bsl", mixed("w"),
                              cast(p["wa"])).float())
          @ p["wb"].float())
    return r, k, v, g, -torch.exp(lw)                  # log decay ≤ 0


def rwkv6_time_mix(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                   shift_prev: torch.Tensor | None = None,
                   state: torch.Tensor | None = None, chunk: int = 64):
    """Returns (out, last_x (B,1,D) shift carry, final state (B,H,K,P))."""
    b, s, d = x.shape
    h, hd = rwkv_dims(cfg)
    r, k, v, g, log_w = _rwkv_projections(cfg, p, x,
                                          _token_shift(x, shift_prev))
    out, new_state = la.linear_attention(
        r.reshape(b, s, h, hd), k.reshape(b, s, h, hd),
        v.reshape(b, s, h, hd), log_w.reshape(b, s, h, hd),
        chunk=min(chunk, s), inclusive=False, u=p["u"].float(),
        initial_state=state)
    out = out.reshape(b, s, d).to(x.dtype)
    out = rms_norm(out, p["ln_out"], cfg.norm_eps) * F.silu(g)
    out = einsum("bsd,de->bse", out, cast(p["wo"]))
    return out.to(x.dtype), x[:, -1:], new_state


def rwkv6_time_mix_step(cfg: ModelConfig, p: Params, x_t: torch.Tensor,
                        shift_prev: torch.Tensor, state: torch.Tensor):
    """Decode step: x_t (B,1,D).  Returns (out, new shift carry, new state)."""
    b, _, d = x_t.shape
    h, hd = rwkv_dims(cfg)
    r, k, v, g, log_w = _rwkv_projections(cfg, p, x_t,
                                          shift_prev.to(x_t.dtype))
    out, new_state = la.linear_attention_step(
        r[:, 0].reshape(b, h, hd), k[:, 0].reshape(b, h, hd),
        v[:, 0].reshape(b, h, hd), log_w[:, 0].reshape(b, h, hd), state,
        inclusive=False, u=p["u"].float())
    out = out.reshape(b, 1, d).to(x_t.dtype)
    out = rms_norm(out, p["ln_out"], cfg.norm_eps) * F.silu(g)
    out = einsum("bsd,de->bse", out, cast(p["wo"]))
    return out.to(x_t.dtype), x_t, new_state


def init_rwkv6_channel_mix(cfg: ModelConfig, gen: torch.Generator, device,
                           n: tuple[int, ...] = ()) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mix_k": torch.full(n + (d,), 0.5, dtype=torch.float32,
                            device=device),
        "wk": normal(gen, n + (d, f), 1.0 / math.sqrt(d), device),
        "wv": normal(gen, n + (f, d), 1.0 / math.sqrt(f), device),
    }


def rwkv6_channel_mix(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                      shift_prev: torch.Tensor | None = None):
    xp = _token_shift(x, shift_prev)
    m = cast(p["mix_k"])
    xk = x * m + xp * (1.0 - m)
    h = torch.relu(einsum("bsd,df->bsf", xk, cast(p["wk"])).float()).square()
    return (einsum("bsf,fd->bsd", h, cast(p["wv"])).to(x.dtype),
            x[:, -1:])


# ---------------------------------------------------------------------------
# Mamba-2 (SSD) block
# ---------------------------------------------------------------------------

def mamba2_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """(d_inner, n_heads, head_dim)."""
    d_inner = 2 * cfg.d_model
    heads = cfg.ssm_heads or d_inner // 64
    return d_inner, heads, d_inner // heads


def init_mamba2(cfg: ModelConfig, gen: torch.Generator, device,
                n: tuple[int, ...] = ()) -> Params:
    d = cfg.d_model
    d_inner, h, hd = mamba2_dims(cfg)
    ns = cfg.ssm_state
    # in_proj emits [z (d_inner), x (d_inner), B (n), C (n), dt (h)]
    d_proj = 2 * d_inner + 2 * ns + h
    a_log = torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                     device=device))
    return {
        "w_in": normal(gen, n + (d, d_proj), 1.0 / math.sqrt(d), device),
        "conv": normal(gen, n + (cfg.ssm_conv, d_inner),
                       1.0 / math.sqrt(cfg.ssm_conv), device),
        "conv_b": torch.zeros(n + (d_inner,), dtype=torch.float32,
                              device=device),
        "a_log": a_log.expand(n + (h,)).clone(),
        "dt_bias": torch.zeros(n + (h,), dtype=torch.float32, device=device),
        "d_skip": torch.ones(n + (h,), dtype=torch.float32, device=device),
        "norm": init_rms_norm(d_inner, device, n),
        "w_out": normal(gen, n + (d_inner, d), 1.0 / math.sqrt(d_inner),
                        device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: torch.Tensor | None):
    """Depthwise causal conv1d.  x (B,S,C), w (W,C).  ``prev`` is the
    (B,W-1,C) carry for decode.  Returns (out, new carry)."""
    width = w.shape[0]
    if prev is None:
        prev = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([prev, x], dim=1)
    wc = cast(w)
    out = sum(xp[:, i:i + x.shape[1]] * wc[i] for i in range(width))
    return out + cast(b), xp[:, -(width - 1):]


def _mamba2_core(cfg, p, x):
    """Shared projections: returns (z, xc_preconv, B, C, dt), f32."""
    d_inner, h, _ = mamba2_dims(cfg)
    n = cfg.ssm_state
    proj = einsum("bsd,de->bse", x, cast(p["w_in"])).float()
    return torch.split(proj, [d_inner, d_inner, n, n, h], dim=-1)


def _mamba2_ssm_inputs(cfg, p, dt, bmat, cmat, xc):
    """(r, k, v, log_w) of the linear attention from the projections;
    dt (B,S,H), bmat/cmat (B,S,N), xc (B,S,d_inner)."""
    b, s = xc.shape[:2]
    _, h, hd = mamba2_dims(cfg)
    n = cfg.ssm_state
    dt = F.softplus(dt.float() + p["dt_bias"])                      # (B,S,H)
    a_log = p["a_log"]
    if layers.block_dtype() is not None:
        # the zero modes hold block weights in bf16 and the reference takes
        # this exp there; on a mesh they arrive as float32 holding bf16
        a_log = a_log.to(layers.block_dtype())
    log_w = (-torch.exp(a_log)[None, None] * dt)[..., None]          # (B,S,H,1)
    v = xc.reshape(b, s, h, hd).float()
    # B/C shared across heads (ngroups=1): k_t = dt·B_t, r_t = C_t
    k = dt[..., None] * bmat[:, :, None, :].float()                 # (B,S,H,N)
    r = cmat[:, :, None, :].float().expand(b, s, h, n)
    return r, k, v, log_w


def _mamba2_out(cfg, p, out, v, z, dtype):
    b, s = out.shape[:2]
    d_inner = mamba2_dims(cfg)[0]
    out = out + p["d_skip"][None, None, :, None] * v
    out = out.reshape(b, s, d_inner).to(dtype)
    out = rms_norm(out * F.silu(z), p["norm"], cfg.norm_eps)
    return einsum("bse,ed->bsd", out, cast(p["w_out"])).to(dtype)


def mamba2_block(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                 conv_prev: torch.Tensor | None = None,
                 state: torch.Tensor | None = None, chunk: int = 64):
    """Returns (out, conv carry, ssm state)."""
    s = x.shape[1]
    z, xc, bmat, cmat, dt = _mamba2_core(cfg, p, x)
    xc, conv_carry = _causal_conv(xc, p["conv"], p["conv_b"], conv_prev)
    xc = F.silu(xc)
    r, k, v, log_w = _mamba2_ssm_inputs(cfg, p, dt, bmat, cmat, xc)
    out, new_state = la.linear_attention(
        r, k, v, log_w, chunk=min(chunk, s), inclusive=True,
        initial_state=state)
    return _mamba2_out(cfg, p, out, v, z, x.dtype), conv_carry, new_state


def mamba2_step(cfg: ModelConfig, p: Params, x_t: torch.Tensor,
                conv_prev: torch.Tensor, state: torch.Tensor):
    """Decode step, x_t (B,1,D)."""
    z, xc, bmat, cmat, dt = _mamba2_core(cfg, p, x_t)
    xc, conv_carry = _causal_conv(xc, p["conv"], p["conv_b"], conv_prev)
    xc = F.silu(xc)
    r, k, v, log_w = _mamba2_ssm_inputs(cfg, p, dt, bmat, cmat, xc)
    out, new_state = la.linear_attention_step(
        r[:, 0], k[:, 0], v[:, 0], log_w[:, 0], state, inclusive=True)
    return (_mamba2_out(cfg, p, out[:, None], v, z, x_t.dtype), conv_carry,
            new_state)
