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

Under megatron's tensor-parallel layout (``layers.tensor_parallel``) the
blocks take the rank's slices of their weights (``layers.leaf_layout``):
each model rank projects, recurs and normalises its heads alone (the
recurrence is independent per head; the norms complete their sums of
squares over ``model``) and its share of the output product is summed
over ``model`` (``layers.row_parallel``).  RWKV-6's decay LoRA is split by
its columns, ``tanh(x·Wa)`` gathered over ``model`` (an activation of
(B, S, max(32, D/16))); Mamba-2's B and C (one group) are computed on
every rank.  A served decode step's state block is the cache's (every
head's, its value dim P split over ``model``): every head's per-token
inputs are gathered, the rank steps its block in place, and its output
moves back to its heads.

Under zero_seq (``layers.seq_group``) the sequence is split over
``model``: the projections, the decay LoRA, the norms and the gates run
on the rank's positions; the token shift and the causal conv take the
rows before the rank's range from the ranks before it
(``layers.seq_halo``); the linear attention exchanges the ranks'
boundary states (``linear_attn.linear_attention``'s ``group``).  The
carries returned are those after the rank's last position: the
sequence's on the last rank.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.models import linear_attn as la
from repro_torch.core import collectives
from repro_torch.models.layers import (cast, einsum, einsum_f32,
                                        init_rms_norm, normal)

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# RWKV-6 time mix + channel mix
# ---------------------------------------------------------------------------

def rwkv_dims(cfg: ModelConfig) -> tuple[int, int]:
    h = cfg.ssm_heads or cfg.d_model // 64
    return h, cfg.d_model // h  # (heads, head_dim)


def rwkv_lora(cfg: ModelConfig) -> int:
    """The decay LoRA's width."""
    return max(32, cfg.d_model // 16)


def init_rwkv6_time_mix(cfg: ModelConfig, gen: torch.Generator, device,
                        n: tuple[int, ...] = ()) -> Params:
    d = cfg.d_model
    h, hd = rwkv_dims(cfg)
    lora = rwkv_lora(cfg)
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
    """x_{t-1} with x_{-1} = prev (decode carry) or 0, in x's dtype; under
    zero_seq's split sequence the previous rank's last row
    (``layers.seq_halo``)."""
    if layers.seq_group() is not None:
        prev = layers.seq_halo(x, 1, prev)
    elif prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


def _rwkv_projections(cfg, p, x, xp):
    """r, k, v, g (f32) and the log decay of the mixed inputs (under the
    tensor-parallel layout the rank's heads' channels: each mixed input
    enters its split products through ``layers.replicated_in``)."""
    tp = layers.tensor_parallel()

    def mixed(name):
        m = cast(p["mix_" + name])
        y = x * m + xp * (1.0 - m)
        return layers.replicated_in(y, "tmix in") if tp else y

    r, k, v, g = (einsum_f32("bsd,de->bse", mixed(n), cast(p["w" + n]))
                  for n in ("r", "k", "v", "g"))
    # data-dependent decay (per channel = per (head, key-dim))
    a = torch.tanh(einsum_f32("bsd,dl->bsl", mixed("w"), cast(p["wa"])))
    if tp:      # every LoRA column, for the rank's channels of wb
        n, m = rwkv_lora(cfg), layers.model_size()
        a = collectives.relayout(
            a, layers.model_group(),
            (2, collectives.one_each(layers.split_ranges(n, m))),
            (2, collectives.one_each([(0, n)] * m)), "decay lora")
    lw = p["w0"].float() + a @ p["wb"].float()
    return r, k, v, g, -torch.exp(lw)                  # log decay ≤ 0


def _rwkv_out(cfg, p, out, g, dtype):
    """The output norm (over d_model), the gate and the output product of
    the heads' outputs ``out`` (B, S, their channels)."""
    out = layers.rms_norm_split(out, p["ln_out"], cfg.d_model, cfg.norm_eps,
                                "tmix norm") * F.silu(g)
    return layers.out_product("bsd,de->bse", out, p["wo"], dtype,
                              "tmix out")


def _tp_state_step(h: int, state: torch.Tensor, v: torch.Tensor, step):
    """A served decode step's recurrence under the tensor-parallel layout:
    ``step(v block) -> (out, new state)`` on the rank's ``state`` block
    (B, H, K, P / m as the serve layout splits the value dim over
    ``model``, or whole), ``v`` every head's values (B, H, P).  Returns
    the rank's heads' output (B, its heads, P), moved to them by one
    all-to-all (``"decode out"``), and the new block."""
    m, r = layers.model_size(), layers.model_rank()
    p, ps = v.shape[-1], state.shape[-1]
    if state.shape[1] != h or ps not in (p, p // m):
        raise NotImplementedError(f"a state block {tuple(state.shape)} not "
                                  "split over its value dim")
    heads = layers.split_ranges(h, m)
    if ps == p:
        out, new = step(v)
        return out[:, heads[r][0]:heads[r][1]], new
    cols = layers.split_ranges(p, m)
    out, new = step(v[..., cols[r][0]:cols[r][1]])
    return collectives.relayout(out, layers.model_group(),
                                (2, collectives.one_each(cols)),
                                (1, collectives.one_each(heads)),
                                "decode out"), new


def rwkv6_time_mix(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                   shift_prev: torch.Tensor | None = None,
                   state: torch.Tensor | None = None, chunk: int = 64):
    """Returns (out, last_x (B,1,D) shift carry, final state (B,H,K,P);
    under the tensor-parallel layout the rank's heads' (B, its heads, K,
    P); under zero_seq's split sequence the carries after the rank's last
    position, the sequence's on the last rank)."""
    b, s, _ = x.shape
    _, hd = rwkv_dims(cfg)
    r, k, v, g, log_w = _rwkv_projections(cfg, p, x,
                                          _token_shift(x, shift_prev))
    nh = r.shape[-1] // hd
    out, new_state = la.linear_attention(
        r.reshape(b, s, nh, hd), k.reshape(b, s, nh, hd),
        v.reshape(b, s, nh, hd), log_w.reshape(b, s, nh, hd),
        chunk=chunk, inclusive=False, u=p["u"].float(),
        initial_state=state, group=layers.seq_group())
    out = out.reshape(b, s, nh * hd).to(x.dtype)
    return _rwkv_out(cfg, p, out, g, x.dtype), x[:, -1:], new_state


def rwkv6_time_mix_step(cfg: ModelConfig, p: Params, x_t: torch.Tensor,
                        shift_prev: torch.Tensor, state: torch.Tensor):
    """Decode step: x_t (B,1,D).  Returns (out, new shift carry, new state).
    Under the tensor-parallel layout ``state`` is the rank's block of the
    served cache (:func:`_tp_state_step`): every head's r, k, v, log decay
    and bonus r·diag(u)·k are gathered (``"decode inputs"``)."""
    b = x_t.shape[0]
    h, hd = rwkv_dims(cfg)
    r, k, v, g, log_w = _rwkv_projections(cfg, p, x_t,
                                          shift_prev.to(x_t.dtype))
    nh = r.shape[-1] // hd
    r, k, v, log_w = (t[:, 0].reshape(b, nh, hd) for t in (r, k, v, log_w))
    u = p["u"].float()
    if layers.tensor_parallel():
        bonus = (r * u * k).sum(-1, keepdim=True)               # (B, nh, 1)
        r, k, v, log_w, bonus = layers.gather_heads(
            [r, k, v, log_w, bonus], h, "decode inputs")

        def step(vb):
            out, new = la.linear_attention_step(r, k, vb, log_w, state,
                                                inclusive=False)
            return out + bonus * vb, new

        out, new_state = _tp_state_step(h, state, v, step)
    else:
        out, new_state = la.linear_attention_step(
            r, k, v, log_w, state, inclusive=False, u=u)
    out = out.reshape(b, 1, nh * hd).to(x_t.dtype)
    return _rwkv_out(cfg, p, out, g, x_t.dtype), x_t, new_state


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
    """Under the tensor-parallel layout ``p`` holds the rank's d_ff slice
    (the MLP's pattern)."""
    xp = _token_shift(x, shift_prev)
    m = cast(p["mix_k"])
    xk = x * m + xp * (1.0 - m)
    if layers.tensor_parallel():
        xk = layers.replicated_in(xk, "cmix in")
    h = torch.relu(einsum_f32("bsd,df->bsf", xk, cast(p["wk"]))).square()
    return (layers.out_product("bsf,fd->bsd", h, p["wv"], x.dtype,
                               "cmix out"), x[:, -1:])


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
    (B,W-1,C) carry for decode.  Returns (out, new carry).  Under zero_seq's
    split sequence the W-1 positions before the rank's first come from
    the ranks before it (``layers.seq_halo``), and the carry is the last
    W-1 positions up to the rank's last."""
    width = w.shape[0]
    if layers.seq_group() is not None:
        prev = layers.seq_halo(x, width - 1, prev)
    elif prev is None:
        prev = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([prev, x], dim=1)
    wc = cast(w)
    out = sum(xp[:, i:i + x.shape[1]] * wc[i] for i in range(width))
    return out + cast(b), xp[:, -(width - 1):]


def _mamba2_core(cfg, p, x):
    """Shared projections: returns (z, xc_preconv, B, C, dt), f32 (under
    the tensor-parallel layout the rank's heads' z, x and dt, and all of B
    and C)."""
    _, h, hd = mamba2_dims(cfg)
    lo, hi = layers.tp_range(h)
    nh, n = hi - lo, cfg.ssm_state
    if layers.tensor_parallel():
        x = layers.replicated_in(x, "mamba in")
    # Rounded to bf16 before it is widened, where the reference keeps the
    # float32 product (ROADMAP C.5): kept in float32, the bf16 decode of
    # zamba2-2.7b at full width parts from its forward by 0.120 of a row on
    # an H100 (0.022 rounded), past chip_smoke's 16b bound of 0.1.  The
    # reference's own bf16 decode parts so on some inputs (up to 0.059 of
    # a row on XLA's CPU at 16b's shapes) and the port with this product in
    # float32 follows it (0.045 on the same row); the rounding hides that.
    proj = einsum("bsd,de->bse", x, cast(p["w_in"])).float()
    return torch.split(proj, [nh * hd, nh * hd, n, n, nh], dim=-1)


def _mamba2_ssm_inputs(cfg, p, dt, bmat, cmat, xc):
    """(r, k, v, log_w) of the linear attention from the projections;
    dt (B,S,H), bmat/cmat (B,S,N), xc (B,S,d_inner)."""
    b, s = xc.shape[:2]
    hd = mamba2_dims(cfg)[2]
    h, n = dt.shape[-1], cfg.ssm_state
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
    out = out.reshape(b, s, -1).to(dtype)
    out = layers.rms_norm_split(out * F.silu(z), p["norm"], d_inner,
                                cfg.norm_eps, "mamba norm")
    return layers.out_product("bse,ed->bsd", out, p["w_out"], dtype,
                              "mamba out")


def mamba2_block(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                 conv_prev: torch.Tensor | None = None,
                 state: torch.Tensor | None = None, chunk: int = 64):
    """Returns (out, conv carry, ssm state); under zero_seq's split
    sequence the carries after the rank's last position, the sequence's
    on the last rank."""
    z, xc, bmat, cmat, dt = _mamba2_core(cfg, p, x)
    xc, conv_carry = _causal_conv(xc, p["conv"], p["conv_b"], conv_prev)
    xc = F.silu(xc)
    r, k, v, log_w = _mamba2_ssm_inputs(cfg, p, dt, bmat, cmat, xc)
    out, new_state = la.linear_attention(
        r, k, v, log_w, chunk=chunk, inclusive=True, initial_state=state,
        group=layers.seq_group())
    return _mamba2_out(cfg, p, out, v, z, x.dtype), conv_carry, new_state


def _conv_step(cfg, p, xc, prev):
    """A served decode step's conv of the rank's channels ``xc`` (B, 1,
    its heads' channels) under the tensor-parallel layout, ``prev`` the
    rank's block of the carry (B, W-1, d_inner / m, or whole): (out, the
    new carry block).  Where the block is the rank's heads' channels
    nothing moves; else the carry's blocks and the new inputs are
    gathered over ``model`` (``"decode conv"``)."""
    d_inner, h, hd = mamba2_dims(cfg)
    m, r = layers.model_size(), layers.model_rank()
    chans = [(lo * hd, hi * hd) for lo, hi in layers.split_ranges(h, m)]
    blocks = layers.split_ranges(d_inner, m) if prev.shape[-1] < d_inner \
        else [(0, d_inner)] * m
    if blocks == chans:
        return _causal_conv(xc, p["conv"], p["conv_b"], prev)
    carry, new = collectives.gather_ranges(
        [(prev, 2, collectives.one_each(blocks)),
         (xc.float(), 2, collectives.one_each(chans))],
        layers.model_group(), "decode conv")
    out, _ = _causal_conv(xc, p["conv"], p["conv_b"],
                          carry[..., chans[r][0]:chans[r][1]])
    window = torch.cat([carry, new], dim=1)[:, 1:]
    return out, window[..., blocks[r][0]:blocks[r][1]]


def mamba2_step(cfg: ModelConfig, p: Params, x_t: torch.Tensor,
                conv_prev: torch.Tensor, state: torch.Tensor):
    """Decode step, x_t (B,1,D).  Under the tensor-parallel layout
    ``conv_prev`` and ``state`` are the rank's blocks of the served cache
    (:func:`_conv_step`, :func:`_tp_state_step`): every head's k = dt·B,
    x and log decay are gathered (``"decode inputs"``), C is every
    rank's."""
    tp = layers.tensor_parallel()
    z, xc, bmat, cmat, dt = _mamba2_core(cfg, p, x_t)
    if tp:
        xc, conv_carry = _conv_step(cfg, p, xc, conv_prev)
    else:
        xc, conv_carry = _causal_conv(xc, p["conv"], p["conv_b"], conv_prev)
    xc = F.silu(xc)
    r, k, v, log_w = _mamba2_ssm_inputs(cfg, p, dt, bmat, cmat, xc)
    r, k, vt, log_w = r[:, 0], k[:, 0], v[:, 0], log_w[:, 0]
    if tp:
        h = mamba2_dims(cfg)[1]
        k, vt, log_w = layers.gather_heads([k, vt, log_w], h,
                                           "decode inputs")
        r = cmat[:, 0, None, :].float().expand(k.shape)
        out, new_state = _tp_state_step(
            h, state, vt, lambda vb: la.linear_attention_step(
                r, k, vb, log_w, state, inclusive=True))
    else:
        out, new_state = la.linear_attention_step(r, k, vt, log_w, state,
                                                  inclusive=True)
    return (_mamba2_out(cfg, p, out[:, None], v, z, x_t.dtype), conv_carry,
            new_state)
