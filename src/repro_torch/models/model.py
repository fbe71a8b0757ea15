"""Model assembly: init / forward / prefill / decode for every architecture
family (dense, moe, ssm, hybrid, audio enc-dec, vlm); port of
``repro.models.model``.

Parameters are a tree of tensors (nested dicts) with the reference's
paths and shapes, the per-layer leaves stacked: ``blocks.attn.wq`` is
(L, d, H, hd).  So carrying weights across packages is a copy leaf by
leaf (:mod:`repro_torch.bridge`) and checkpoints read across packages.
:class:`LM` holds such a tree as the parameters of an ``nn.Module``; the
functions below take the tree itself, as the reference's do.

- The layer loop runs over the stacked leaves; ``remat=True`` checkpoints
  each block (``torch.utils.checkpoint``, non-reentrant), as the
  reference's ``_scan_blocks`` does, so the backward pass stores only
  layer inputs.
- Forward returns *hidden states*, not logits: the loss unembeds in
  sequence chunks (:mod:`repro_torch.train.loss`).
- Over a (data, model) mesh (``train/train_step.py``'s mesh step, the
  hooks of ``models/layers.py``) the tree holds a rank's local blocks:
  each layer's weights are gathered at use inside the layer loop (so a
  rank holds one block's full weights at a time, again in remat's
  recomputation), in bf16 under the zero modes (:func:`_maybe_cast_blocks`);
  the positions are global; under zero_seq the recurrent blocks run on
  the gathered sequence and attention gathers its keys and values.
- Decode caches are ring buffers when the config has a sliding window
  shorter than the cache (mixtral).  :func:`prefill` and
  :func:`decode_step` run without autograd; ``decode_step`` writes the
  new keys, values and states into the cache's tensors in place (a
  serving loop's usual form) and returns the cache with ``pos``
  advanced.  ``pos`` stays a device tensor, so a step needs no host sync.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import device as device_mod
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as layers_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (attention_block, cast,
                                       cross_attention_block, einsum, embed,
                                       gather_param, gather_params, gelu,
                                       get_activation_spec, init_attention,
                                       init_embed, init_mlp, init_rms_norm,
                                       layer_specs, mlp_block, normal,
                                       param_spec, qkv_project, rms_norm,
                                       sdpa, unembed)

Params = dict[str, Any]


# The subtrees whose weights the zero modes use in bf16.
CAST_TREES = ("blocks", "shared_attn", "encoder")


def _maybe_cast_blocks(tree: Params) -> Params:
    """zero modes: block weights in bf16 before the layer loop, as the
    reference casts its storage-sharded blocks before the scan so that the
    per-layer gather moves bf16, not f32.  On a mesh the cast rides in
    that gather (``layers.gather_param``'s ``wire``), which sums the
    ranks' gradient shares before rounding; off a mesh (one process under
    a zero mode's activation spec) the blocks are cast here.  The f32
    master weights are untouched; gradients flow back through the cast."""
    if get_activation_spec() is None or layers_mod.get_mesh() is not None:
        return tree
    return map_tree(lambda x: x.to(torch.bfloat16)
                    if x.dtype == torch.float32 else x, tree)


# ===========================================================================
# Trees
# ===========================================================================

def layers(tree: Params) -> list[Params]:
    """The layers of a stacked tree, each a tree of views.  ``unbind``
    gives a leaf one backward node that stacks its layers' gradients once
    (indexing layer by layer would add a zero-filled stack a layer)."""
    per_leaf = {k: layers(v) if isinstance(v, dict) else v.unbind(0)
                for k, v in tree.items()}
    n = len(next(iter(per_leaf.values())))
    return [{k: v[i] for k, v in per_leaf.items()} for i in range(n)]


def map_tree(fn, tree: Params) -> Params:
    return {k: map_tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def map2(fn, a: Params, b: Params) -> Params:
    """``fn`` of the matching leaves of two trees of one structure."""
    return {k: map2(fn, v, b[k]) if isinstance(v, dict) else fn(v, b[k])
            for k, v in a.items()}


def leaves(tree: Params) -> list[torch.Tensor]:
    """Leaves in the reference's flattening order (keys sorted)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(leaves(v) if isinstance(v, dict) else [v])
    return out


def unflatten(tree: Params, flat) -> Params:
    """A tree of ``tree``'s structure whose leaves are ``flat``, in the
    order of :func:`leaves`."""
    it = iter(flat)

    def build(t):
        return {k: build(t[k]) if isinstance(t[k], dict) else next(it)
                for k in sorted(t)}

    return build(tree)


def to_batch(batch: dict, device) -> dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(
        v, torch.Tensor) else v, device=device) for k, v in batch.items()}


# ===========================================================================
# Init
# ===========================================================================

def _init_dense_block(cfg: ModelConfig, gen, dev, n=()) -> Params:
    block = {"ln1": init_rms_norm(cfg.d_model, dev, n),
             "attn": init_attention(cfg, gen, dev, n),
             "ln2": init_rms_norm(cfg.d_model, dev, n)}
    if cfg.family == "moe":
        block["moe"] = moe_mod.init_moe(cfg, gen, dev, n)
    else:
        block["mlp"] = init_mlp(cfg, gen, dev, n)
    return block


def _init_encdec_block(cfg: ModelConfig, gen, dev, n, *, cross: bool
                       ) -> Params:
    block = {"ln1": init_rms_norm(cfg.d_model, dev, n),
             "attn": init_attention(cfg, gen, dev, n),
             "ln2": init_rms_norm(cfg.d_model, dev, n),
             "mlp": init_mlp(cfg, gen, dev, n, kind="gelu")}
    if cross:
        block["ln_x"] = init_rms_norm(cfg.d_model, dev, n)
        block["xattn"] = init_attention(cfg, gen, dev, n)
    return block


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Params:
    """Random weights with the reference's distributions and scales, drawn
    from the ``(seed, MODEL)`` stream on ``device`` (``cuda`` unless the
    CPU is asked for).  Torch's generator gives other numbers than JAX's;
    parity tests carry the reference's weights across instead."""
    dev = device_mod.resolve(device)
    return _init_tree(cfg, device_mod.generator((seed, device_mod.MODEL),
                                                dev), dev)


def param_shapes(cfg: ModelConfig) -> Params:
    """The parameter tree as meta tensors (shapes and dtypes, no storage):
    what the sharding rules read, at any size."""
    return _init_tree(cfg, None, torch.device("meta"))


def _init_tree(cfg: ModelConfig, gen, dev) -> Params:
    n = (cfg.n_layers,)
    params: Params = {"embed": init_embed(cfg, gen, dev),
                      "final_norm": init_rms_norm(cfg.d_model, dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = init_embed(cfg, gen, dev)

    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        params["blocks"] = _init_dense_block(cfg, gen, dev, n)
        if fam == "vlm":
            params["projector"] = {
                "w1": normal(gen, (cfg.vision_dim, cfg.d_model),
                             1.0 / math.sqrt(cfg.vision_dim), dev),
                "w2": normal(gen, (cfg.d_model, cfg.d_model),
                             1.0 / math.sqrt(cfg.d_model), dev)}
    elif fam == "ssm":
        params["blocks"] = {
            "ln1": init_rms_norm(cfg.d_model, dev, n),
            "tmix": ssm_mod.init_rwkv6_time_mix(cfg, gen, dev, n),
            "ln2": init_rms_norm(cfg.d_model, dev, n),
            "cmix": ssm_mod.init_rwkv6_channel_mix(cfg, gen, dev, n)}
    elif fam == "hybrid":
        params["blocks"] = {"ln": init_rms_norm(cfg.d_model, dev, n),
                            "mamba": ssm_mod.init_mamba2(cfg, gen, dev, n)}
        params["shared_attn"] = _init_dense_block(
            cfg.replace(family="dense"), gen, dev)
    elif fam == "audio":
        params["blocks"] = _init_encdec_block(cfg, gen, dev, n, cross=True)
        params["encoder"] = {
            "blocks": _init_encdec_block(cfg, gen, dev,
                                         (cfg.encoder_layers,), cross=False),
            "norm": init_rms_norm(cfg.d_model, dev),
            "in_proj": normal(gen, (cfg.d_model, cfg.d_model),
                              1.0 / math.sqrt(cfg.d_model), dev)}
    else:
        raise ValueError(f"unknown family {fam!r}")
    return params


def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    """Closed-form parameter count (used for MODEL_FLOPS = 6·N·D)."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim_
    h, kv = cfg.n_heads, cfg.n_kv_heads
    attn = d * hd * (h + 2 * kv) + h * hd * d
    mlp = 3 * d * f
    if cfg.family == "moe":
        e = cfg.top_k if active_only else cfg.n_experts
        mlp = e * 3 * d * f + d * cfg.n_experts
    per_layer = attn + mlp + 2 * d
    if cfg.family == "ssm":
        lora = max(32, d // 16)
        tmix = 5 * d * d + 2 * d * lora + 3 * d
        cmix = 2 * d * f
        per_layer = tmix + cmix + 2 * d
    if cfg.family == "hybrid":
        d_inner, hs, _ = ssm_mod.mamba2_dims(cfg)
        n = cfg.ssm_state
        per_layer = (d * (2 * d_inner + 2 * n + hs) + d_inner * d
                     + cfg.ssm_conv * d_inner + 3 * hs + 2 * d_inner + d)
    total = cfg.n_layers * per_layer
    if cfg.family == "hybrid":
        total += attn + 3 * d * f + 2 * d      # one shared block
    if cfg.family == "audio":
        # decoder blocks use a 2-matrix gelu MLP (not swiglu) and carry an
        # extra cross-attention + its norm.
        total -= cfg.n_layers * (d * f)        # swiglu → gelu correction
        total += cfg.n_layers * (attn + d)     # cross attention + ln_x
        total += cfg.encoder_layers * (attn + 2 * d * f + 2 * d)
        total += d * d + d                     # encoder in_proj + final norm
    if cfg.family == "vlm":
        total += cfg.vision_dim * d + d * d
    total += cfg.padded_vocab * d * (1 if cfg.tie_embeddings else 2)
    return int(total)


# ===========================================================================
# Forward (train / prefill)
# ===========================================================================

def _sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[:, None].float() * freqs[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def _vlm_prefix(cfg: ModelConfig, params: Params, batch,
                x: torch.Tensor) -> torch.Tensor:
    """The projected patch embeddings written over the first P global
    positions (under zero_seq those of them that lie in the rank's
    slice)."""
    proj = gather_params(params["projector"], param_spec("projector"))
    patches = batch["patch_embeds"]
    if patches.shape[1] < cfg.n_patches:        # sequence-sharded patches
        patches = layers_mod.gather_seq(patches, "patch embeds")
    pe = einsum("bpv,vd->bpd", cast(patches), cast(proj["w1"]))
    pe = einsum("bpd,de->bpe", gelu(pe), cast(proj["w2"]))
    s = x.shape[1]
    off = layers_mod.seq_offset(s)
    n = max(0, min(pe.shape[1] - off, s))
    return torch.cat([pe[:, off:off + n].to(x.dtype), x[:, n:]], dim=1)


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _dense_block_fn(cfg: ModelConfig, bp: Params, x: torch.Tensor,
                    positions: torch.Tensor):
    h = attention_block(cfg, bp["attn"], rms_norm(x, bp["ln1"], cfg.norm_eps),
                        positions)
    x = x + h
    inner = rms_norm(x, bp["ln2"], cfg.norm_eps)
    if "moe" in bp:
        m, aux = moe_mod.moe_block(cfg, bp["moe"], inner)
    else:
        m, aux = mlp_block(bp["mlp"], inner), _zero(x)
    return x + m, aux


@layers_mod.sequence_whole
def _rwkv_block_fn(x, cfg, bp):
    h, _, _ = ssm_mod.rwkv6_time_mix(cfg, bp["tmix"],
                                     rms_norm(x, bp["ln1"], cfg.norm_eps))
    x = x + h
    c, _ = ssm_mod.rwkv6_channel_mix(cfg, bp["cmix"],
                                     rms_norm(x, bp["ln2"], cfg.norm_eps))
    return x + c, _zero(x)


@layers_mod.sequence_whole
def _mamba_block_fn(x, cfg, bp):
    h, _, _ = ssm_mod.mamba2_block(cfg, bp["mamba"],
                                   rms_norm(x, bp["ln"], cfg.norm_eps))
    return x + h


def _run_blocks(body, stacked: Params, x: torch.Tensor, remat: bool,
                specs=None):
    """``body(layer i's params, x) -> (x', aux)`` over the stacked layers,
    each checkpointed when ``remat``; returns (x, Σ aux).  ``specs`` (the
    stacked tree's storage specs, on a mesh) gathers each layer's weights
    inside the checkpointed body."""
    aux = _zero(x)
    lspecs = layer_specs(specs)
    wire = layers_mod.block_dtype()
    run = body if lspecs is None else \
        (lambda bp, h: body(gather_params(bp, lspecs, wire), h))
    for bp in layers(stacked):
        if remat:
            x, a = checkpoint(run, bp, x, use_reentrant=False)
        else:
            x, a = run(bp, x)
        aux = aux + a
    return x, aux


def _positions(s: int, device) -> torch.Tensor:
    """Global positions of the rank's ``s`` sequence positions."""
    off = layers_mod.seq_offset(s)
    return torch.arange(off, off + s, device=device)


def forward(cfg: ModelConfig, params: Params, batch: dict, *,
            remat: bool = True):
    """Returns (hidden (B, S, D), aux_loss).  ``batch`` needs "tokens" plus
    "patch_embeds" (vlm) or "frames" (audio)."""
    tokens = batch["tokens"]
    positions = _positions(tokens.shape[1], tokens.device)
    x = embed(gather_param(params["embed"], param_spec("embed")), tokens)

    fam = cfg.family
    if fam == "vlm":
        x = _vlm_prefix(cfg, params, batch, x)
    blocks = _maybe_cast_blocks(params["blocks"])
    specs = param_spec("blocks")
    if fam in ("dense", "moe", "vlm"):
        if fam == "moe":
            specs = moe_mod.block_gather_specs(cfg, specs, tokens.numel())
        x, aux = _run_blocks(
            lambda bp, h: _dense_block_fn(cfg, bp, h, positions),
            blocks, x, remat, specs)
    elif fam == "ssm":
        x, aux = _run_blocks(lambda bp, h: _rwkv_block_fn(h, cfg, bp),
                             blocks, x, remat, specs)
    elif fam == "hybrid":
        x, aux = _hybrid_forward(cfg, dict(params, blocks=blocks), x,
                                 positions, remat)
    elif fam == "audio":
        x, aux = _audio_forward(cfg, dict(params, blocks=blocks), x,
                                batch["frames"], positions, remat)
    else:
        raise ValueError(fam)
    final_norm = gather_param(params["final_norm"], param_spec("final_norm"))
    return rms_norm(x, final_norm, cfg.norm_eps), aux


def _grouped(cfg: ModelConfig, tree: Params) -> Params:
    """(L, ...) leaves as (L / attn_every, attn_every, ...)."""
    g = cfg.attn_every
    return map_tree(lambda a: a.reshape((cfg.n_layers // g, g) + a.shape[1:]),
                    tree)


def _hybrid_forward(cfg, params, x, positions, remat):
    """Zamba2: groups of ``attn_every`` mamba layers, each followed by the
    SHARED attention block (same weights every application, gathered at
    each)."""
    shared = _maybe_cast_blocks(params["shared_attn"])
    shared_specs = param_spec("shared_attn")
    specs = param_spec("blocks")
    if specs is not None:           # the group's leading dim, unsharded
        specs = map_tree(lambda sp: (None,) + tuple(sp), specs)

    def group_body(bp_group, h):
        for bp in layers(bp_group):
            h = _mamba_block_fn(h, cfg, bp)
        full = gather_params(shared, shared_specs, layers_mod.block_dtype())
        return _dense_block_fn(cfg, full, h, positions)[0], _zero(h)

    return _run_blocks(group_body, _grouped(cfg, params["blocks"]), x, remat,
                       specs)


def _encode(cfg, enc: Params, frames: torch.Tensor, remat: bool):
    """Whisper's encoder over the stub frame embeddings: the memory.  On a
    mesh its weights are gathered at use; sequence-sharded frames
    (zero_seq) are gathered, the encoder runs on all of them, and the rank
    keeps its slice of the memory."""
    specs = param_spec("encoder") or {}
    sharded = frames.shape[1] < cfg.n_frames
    if sharded:
        frames = layers_mod.gather_seq(frames, "frames")
    fpos = torch.arange(frames.shape[1], device=frames.device)
    wire = layers_mod.block_dtype()
    in_proj = gather_param(enc["in_proj"], specs.get("in_proj"), wire)
    mem = einsum("bfd,de->bfe", cast(frames), cast(in_proj))
    mem = mem + _sinusoidal(fpos, cfg.d_model)[None].to(mem.dtype)

    def enc_body(bp, h):
        a = attention_block(cfg, bp["attn"],
                            rms_norm(h, bp["ln1"], cfg.norm_eps), fpos,
                            causal=False, rope=False, seq_sharded=False)
        h = h + a
        m = mlp_block(bp["mlp"], rms_norm(h, bp["ln2"], cfg.norm_eps))
        return h + m, _zero(h)

    mem, _ = _run_blocks(enc_body, enc["blocks"], mem, remat,
                         specs.get("blocks"))
    mem = rms_norm(mem, gather_param(enc["norm"], specs.get("norm"), wire),
                   cfg.norm_eps)
    return layers_mod.local_seq(mem) if sharded else mem


def _cross_kv(bp: Params, mem: torch.Tensor):
    return (einsum("bfd,dhk->bfhk", mem, cast(bp["xattn"]["wk"])),
            einsum("bfd,dhk->bfhk", mem, cast(bp["xattn"]["wv"])))


def _audio_forward(cfg, params, x, frames, positions, remat):
    """Whisper: encode stub frame embeddings, then causal decoder with
    cross-attention.  Sinusoidal positions on both sides.  A rank holding
    a slice of the memory gathers the cross-attention's keys and values
    over the model group."""
    mem_sharded = frames.shape[1] < cfg.n_frames
    mem = _encode(cfg, _maybe_cast_blocks(params["encoder"]), frames, remat)
    x = x + _sinusoidal(positions, cfg.d_model)[None].to(x.dtype)

    def dec_body(bp, h):
        a = attention_block(cfg, bp["attn"],
                            rms_norm(h, bp["ln1"], cfg.norm_eps), positions,
                            causal=True, rope=False)
        h = h + a
        mk, mv = _cross_kv(bp, mem)
        if mem_sharded:
            mk = layers_mod.gather_seq(mk, "cross k")
            mv = layers_mod.gather_seq(mv, "cross v")
        c = cross_attention_block(cfg, bp["xattn"],
                                  rms_norm(h, bp["ln_x"], cfg.norm_eps),
                                  mk.to(h.dtype), mv.to(h.dtype))
        h = h + c
        m = mlp_block(bp["mlp"], rms_norm(h, bp["ln2"], cfg.norm_eps))
        return h + m, _zero(h)

    return _run_blocks(dec_body, params["blocks"], x, remat,
                       param_spec("blocks"))


def logits_fn(cfg: ModelConfig, params: Params,
              hidden: torch.Tensor) -> torch.Tensor:
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return unembed(table, hidden)


# ===========================================================================
# Decode (serve_step): one token against a preallocated cache
# ===========================================================================

def cache_len(cfg: ModelConfig, max_len: int) -> int:
    if cfg.sliding_window and cfg.sliding_window < max_len:
        return cfg.sliding_window
    return max_len


def _windowed(cfg: ModelConfig, max_len: int) -> bool:
    return bool(cfg.sliding_window and cfg.sliding_window < max_len)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Params:
    """Zeros/empty cache tree for :func:`decode_step`."""
    dev = device_mod.resolve(device)
    hd, kv = cfg.head_dim_, cfg.n_kv_heads
    s = cache_len(cfg, max_len)
    f32 = dict(dtype=torch.float32, device=dev)
    cache: Params = {"pos": torch.zeros((), dtype=torch.int32, device=dev)}
    if _windowed(cfg, max_len):
        cache["key_pos"] = torch.full((s,), -1, dtype=torch.int32, device=dev)

    def attn_cache(n, seq):
        return {"k": torch.zeros((n, batch, seq, kv, hd), dtype=dtype,
                                 device=dev),
                "v": torch.zeros((n, batch, seq, kv, hd), dtype=dtype,
                                 device=dev)}

    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        cache["layers"] = attn_cache(cfg.n_layers, s)
    elif fam == "ssm":
        h, p = ssm_mod.rwkv_dims(cfg)
        cache["layers"] = {
            "state": torch.zeros((cfg.n_layers, batch, h, p, p), **f32),
            "shift1": torch.zeros((cfg.n_layers, batch, 1, cfg.d_model),
                                  **f32),
            "shift2": torch.zeros((cfg.n_layers, batch, 1, cfg.d_model),
                                  **f32)}
    elif fam == "hybrid":
        d_inner, h, p = ssm_mod.mamba2_dims(cfg)
        cache["layers"] = {
            "state": torch.zeros((cfg.n_layers, batch, h, cfg.ssm_state, p),
                                 **f32),
            "conv": torch.zeros((cfg.n_layers, batch, cfg.ssm_conv - 1,
                                 d_inner), **f32)}
        cache["shared_attn"] = attn_cache(cfg.n_layers // cfg.attn_every, s)
    elif fam == "audio":
        cache["layers"] = attn_cache(cfg.n_layers, s)
        cache["cross"] = attn_cache(cfg.n_layers, cfg.n_frames)
    return cache


# ===========================================================================
# Prefill: full-sequence forward that also materializes the decode cache
# ===========================================================================

@torch.no_grad()
def prefill(cfg: ModelConfig, params: Params, batch: dict, max_len: int):
    """Run the prompt through the model and build the decode cache.

    Returns (last-token logits (B, 1, Vp), cache with pos = S).  For
    sliding-window configs only the last ``window`` keys are retained
    (ring-buffer layout, aligned so subsequent decode writes continue it).
    """
    tokens = batch["tokens"]
    b, s = tokens.shape
    dev = tokens.device
    positions = torch.arange(s, device=dev)
    x = embed(params["embed"], tokens)
    fam = cfg.family
    s_cache = cache_len(cfg, max_len)
    cache: Params = {"pos": torch.tensor(s, dtype=torch.int32, device=dev)}

    def clip_kv(k):  # keep the last s_cache positions, ring-aligned
        if s <= s_cache:
            pad = k.new_zeros((b, s_cache - s) + k.shape[2:])
            return torch.cat([k, pad], dim=1)
        return torch.roll(k[:, s - s_cache:], s % s_cache, dims=1)

    if _windowed(cfg, max_len):
        # Position stored in ring slot i is the largest p < s with
        # p % s_cache == i (or -1 if that slot is still empty).
        i = torch.arange(s_cache, device=dev)
        last = s - 1 - torch.remainder(s - 1 - i, s_cache)
        cache["key_pos"] = torch.where((last >= 0) & (last >= s - s_cache),
                                       last, -1).to(torch.int32)

    def attn_kv(bp, h, rope=True, window=0):
        """Self-attention of one block: (h + out, clipped k, clipped v)."""
        xn = rms_norm(h, bp["ln1"], cfg.norm_eps)
        q, k, v = qkv_project(cfg, bp["attn"], xn, positions, rope=rope)
        o = sdpa(q, k, v, causal=True, window=window)
        h = h + einsum("bshk,hkd->bsd", o, cast(bp["attn"]["wo"])).to(h.dtype)
        return h, clip_kv(k), clip_kv(v)

    def stack(kvs):
        return {"k": torch.stack([k for k, _ in kvs]).to(torch.bfloat16),
                "v": torch.stack([v for _, v in kvs]).to(torch.bfloat16)}

    if fam in ("dense", "moe", "vlm"):
        if fam == "vlm":
            x = _vlm_prefix(cfg, params, batch, x)
        kvs = []
        for bp in layers(params["blocks"]):
            x, k, v = attn_kv(bp, x, window=cfg.sliding_window)
            inner = rms_norm(x, bp["ln2"], cfg.norm_eps)
            if "moe" in bp:
                m, _ = moe_mod.moe_block(cfg, bp["moe"], inner)
            else:
                m = mlp_block(bp["mlp"], inner)
            x = x + m
            kvs.append((k, v))
        cache["layers"] = stack(kvs)

    elif fam == "ssm":
        st, s1, s2 = [], [], []
        for bp in layers(params["blocks"]):
            xn = rms_norm(x, bp["ln1"], cfg.norm_eps)
            o, sh1, state = ssm_mod.rwkv6_time_mix(cfg, bp["tmix"], xn)
            x = x + o
            xn2 = rms_norm(x, bp["ln2"], cfg.norm_eps)
            c, _ = ssm_mod.rwkv6_channel_mix(cfg, bp["cmix"], xn2)
            x = x + c
            st.append(state)
            s1.append(sh1)
            s2.append(xn2[:, -1:])
        cache["layers"] = {"state": torch.stack(st),
                           "shift1": torch.stack(s1).float(),
                           "shift2": torch.stack(s2).float()}

    elif fam == "hybrid":
        shared = params["shared_attn"]
        conv, st, kvs = [], [], []
        for i, bp in enumerate(layers(params["blocks"])):
            xn = rms_norm(x, bp["ln"], cfg.norm_eps)
            o, c, state = ssm_mod.mamba2_block(cfg, bp["mamba"], xn)
            x = x + o
            conv.append(c)
            st.append(state)
            if (i + 1) % cfg.attn_every == 0:
                x, k, v = attn_kv(shared, x, window=cfg.sliding_window)
                x = x + mlp_block(shared["mlp"],
                                  rms_norm(x, shared["ln2"], cfg.norm_eps))
                kvs.append((k, v))
        cache["layers"] = {"conv": torch.stack(conv).float(),
                           "state": torch.stack(st)}
        cache["shared_attn"] = stack(kvs)

    elif fam == "audio":
        mem = _encode(cfg, params["encoder"], batch["frames"], remat=False)
        x = x + _sinusoidal(positions, cfg.d_model)[None].to(x.dtype)
        kvs, xkvs = [], []
        for bp in layers(params["blocks"]):
            x, k, v = attn_kv(bp, x, rope=False)
            mk, mv = _cross_kv(bp, mem)
            x = x + cross_attention_block(
                cfg, bp["xattn"], rms_norm(x, bp["ln_x"], cfg.norm_eps),
                mk.to(x.dtype), mv.to(x.dtype))
            x = x + mlp_block(bp["mlp"], rms_norm(x, bp["ln2"], cfg.norm_eps))
            kvs.append((k, v))
            xkvs.append((mk, mv))
        cache["layers"] = stack(kvs)
        cache["cross"] = stack(xkvs)
    else:
        raise ValueError(fam)

    h = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return logits_fn(cfg, params, h), cache


def _attn_step(cfg, bp, x, k_cache, v_cache, pos, key_pos, rope=True):
    """One-token attention against a cache layer, the new key and value
    written into it in place; returns the block's output."""
    s_cache = k_cache.shape[1]
    windowed = key_pos is not None
    write_at = torch.remainder(pos, s_cache) if windowed else pos
    q, k, v = qkv_project(cfg, bp, x, pos.view(1, 1), rope=rope)
    at = write_at.view(1).long()
    k_cache.index_copy_(1, at, k.to(k_cache.dtype))
    v_cache.index_copy_(1, at, v.to(v_cache.dtype))
    if windowed:
        # ring buffer: mask by key_pos validity instead of a prefix length
        out = _ring_sdpa(q, k_cache, v_cache, key_pos, write_at)
    else:
        out = sdpa(q, k_cache, v_cache, causal=False, kv_len=pos + 1)
    return einsum("bshk,hkd->bsd", out, cast(bp["wo"])).to(x.dtype)


def _ring_sdpa(q, k_cache, v_cache, key_pos, write_at):
    b, _, h, hd = q.shape
    kv = k_cache.shape[2]
    qg = q.reshape(b, 1, kv, h // kv, hd)
    scores = einsum("bqgrh,bkgh->bgrqk", qg, k_cache).float()
    scores = scores / math.sqrt(hd)
    slots = torch.arange(k_cache.shape[1], device=q.device)
    valid = (key_pos >= 0) | (slots == write_at)
    scores = torch.where(valid, scores, -1e30)
    probs = torch.softmax(scores, -1)
    out = einsum("bgrqk,bkgh->bqgrh", probs.to(q.dtype), v_cache)
    return out.reshape(b, 1, h, hd)


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Params, cache: Params,
                tokens: torch.Tensor):
    """One decode step for a (B, 1) token batch.  Returns (logits, cache):
    the cache's tensors updated in place, ``pos`` advanced."""
    pos = cache["pos"]
    x = embed(params["embed"], tokens)
    fam = cfg.family
    key_pos = cache.get("key_pos")
    lay = cache["layers"]

    if fam in ("dense", "moe", "vlm"):
        for i, bp in enumerate(layers(params["blocks"])):
            x = x + _attn_step(cfg, bp["attn"],
                               rms_norm(x, bp["ln1"], cfg.norm_eps),
                               lay["k"][i], lay["v"][i], pos, key_pos)
            inner = rms_norm(x, bp["ln2"], cfg.norm_eps)
            if "moe" in bp:
                m, _ = moe_mod.moe_block(cfg, bp["moe"], inner)
            else:
                m = mlp_block(bp["mlp"], inner)
            x = x + m

    elif fam == "ssm":
        for i, bp in enumerate(layers(params["blocks"])):
            h, sh1, state = ssm_mod.rwkv6_time_mix_step(
                cfg, bp["tmix"], rms_norm(x, bp["ln1"], cfg.norm_eps),
                lay["shift1"][i], lay["state"][i])
            x = x + h
            xn = rms_norm(x, bp["ln2"], cfg.norm_eps)
            c, _ = ssm_mod.rwkv6_channel_mix(cfg, bp["cmix"], xn,
                                             shift_prev=lay["shift2"][i])
            x = x + c
            # the token shift carries the *normalized* stream of both mixes
            lay["state"][i].copy_(state)
            lay["shift1"][i].copy_(sh1)
            lay["shift2"][i].copy_(xn[:, -1:])

    elif fam == "hybrid":
        shared = params["shared_attn"]
        for i, bp in enumerate(layers(params["blocks"])):
            h, conv, state = ssm_mod.mamba2_step(
                cfg, bp["mamba"], rms_norm(x, bp["ln"], cfg.norm_eps),
                lay["conv"][i], lay["state"][i])
            x = x + h
            lay["conv"][i].copy_(conv)
            lay["state"][i].copy_(state)
            if (i + 1) % cfg.attn_every == 0:
                g = i // cfg.attn_every
                x = x + _attn_step(cfg, shared["attn"],
                                   rms_norm(x, shared["ln1"], cfg.norm_eps),
                                   cache["shared_attn"]["k"][g],
                                   cache["shared_attn"]["v"][g], pos, key_pos)
                x = x + mlp_block(shared["mlp"],
                                  rms_norm(x, shared["ln2"], cfg.norm_eps))

    elif fam == "audio":
        x = x + _sinusoidal(pos.view(1), cfg.d_model)[None].to(x.dtype)
        for i, bp in enumerate(layers(params["blocks"])):
            x = x + _attn_step(cfg, bp["attn"],
                               rms_norm(x, bp["ln1"], cfg.norm_eps),
                               lay["k"][i], lay["v"][i], pos, key_pos,
                               rope=False)
            x = x + cross_attention_block(
                cfg, bp["xattn"], rms_norm(x, bp["ln_x"], cfg.norm_eps),
                cache["cross"]["k"][i], cache["cross"]["v"][i])
            x = x + mlp_block(bp["mlp"], rms_norm(x, bp["ln2"], cfg.norm_eps))
    else:
        raise ValueError(fam)

    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_fn(cfg, params, h)
    if key_pos is not None:
        key_pos.index_copy_(0, torch.remainder(pos, key_pos.shape[0]).view(
            1).long(), pos.view(1).to(key_pos.dtype))
    cache["pos"] = pos + 1
    return logits, cache


# ===========================================================================
# The module
# ===========================================================================

class _Node(nn.Module):
    """One dict level of a parameter tree."""


def _register(module: nn.Module, tree: Params) -> None:
    for name, value in tree.items():
        if isinstance(value, dict):
            child = _Node()
            _register(child, value)
            module.add_module(name, child)
        else:
            module.register_parameter(name, nn.Parameter(value))


def _tree_of(module: nn.Module) -> Params:
    out: Params = dict(module._parameters)
    for name, child in module._modules.items():
        out[name] = _tree_of(child)
    return out


class LM(nn.Module):
    """A language model of one architecture, its parameters the
    reference's tree (``named_parameters`` reads ``blocks.attn.wq``).

    ``params`` (a tree of tensors, e.g. from
    :func:`repro_torch.bridge.lm_params_from`) is moved to the device;
    without it the weights come from :func:`init_params` with ``seed``.
    The device is ``cuda`` unless ``device="cpu"`` is passed."""

    def __init__(self, cfg: ModelConfig, params: Params | None = None, *,
                 seed: int = 0, device=None):
        super().__init__()
        dev = device_mod.resolve(device)
        if params is None:
            params = init_params(cfg, seed=seed, device=dev)
        else:
            params = map_tree(lambda t: t.detach().to(dev), params)
        self.cfg = cfg
        self.device = dev
        _register(self, params)

    def tree(self) -> Params:
        """The parameters as the reference's tree (the module's own
        ``nn.Parameter`` objects)."""
        return _tree_of(self)

    def forward(self, batch: dict, remat: bool = False):
        """(hidden (B, S, D), aux_loss) of a batch of numpy arrays or
        tensors."""
        return forward(self.cfg, self.tree(), to_batch(batch, self.device),
                       remat=remat)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return logits_fn(self.cfg, self.tree(), hidden)

    def init_cache(self, batch: int, max_len: int) -> Params:
        return init_cache(self.cfg, batch, max_len, device=self.device)

    def prefill(self, batch: dict, max_len: int):
        return prefill(self.cfg, self.tree(), to_batch(batch, self.device),
                       max_len)

    def decode_step(self, cache: Params, tokens):
        return decode_step(self.cfg, self.tree(), cache,
                           torch.as_tensor(tokens, device=self.device))
