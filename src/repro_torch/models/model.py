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
  each layer's weights are gathered at use inside the layer loop
  (``layers.block_params``; so a rank holds one block's weights at a
  time, again in remat's recomputation).  Under the zero modes they are
  gathered whole, in bf16 (:func:`_maybe_cast_blocks`); under megatron
  they are gathered over the batch axes and moved to their compute split
  over ``model``, each model rank computing its slice of every block
  product (attention by heads, the MLPs by d_ff, the MoE by experts, the
  tables by vocabulary, the SSM mixers by heads and RWKV-6's channel mix
  by d_ff).  The positions are global; under zero_seq every block runs
  on the rank's positions: the recurrences exchange their rank-boundary
  states and halos (``linear_attn.linear_attention``'s ``group``,
  ``layers.seq_halo``), and attention, whisper's encoder's included,
  gathers its keys and values.
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
from repro_torch.core import collectives
from repro_torch.models import layers as layers_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (attention_block, block_params, cast,
                                       cross_attention_block, einsum,
                                       einsum_f32, embed,
                                       gather_param, gather_params, gelu,
                                       get_activation_spec, init_attention,
                                       init_embed, init_mlp, init_rms_norm,
                                       layer_specs, mlp_block, normal,
                                       param_spec, qkv_project, rms_norm,
                                       sdpa, unembed, vocab_table)
from repro_torch.train import sharding

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
    return _build(tree, iter(flat))


def _build(t: Params, it) -> Params:
    """:func:`unflatten`'s recursion, at module level: a recursive closure
    over ``it`` would keep ``flat`` alive in a reference cycle until the
    garbage collector runs."""
    return {k: _build(t[k], it) if isinstance(t[k], dict) else next(it)
            for k in sorted(t)}


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
    proj = gather_params(params["projector"], param_spec("projector"),
                         what="projector weights")
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


def _rwkv_block_fn(x, cfg, bp):
    h, _, _ = ssm_mod.rwkv6_time_mix(cfg, bp["tmix"],
                                     rms_norm(x, bp["ln1"], cfg.norm_eps))
    x = x + h
    c, _ = ssm_mod.rwkv6_channel_mix(cfg, bp["cmix"],
                                     rms_norm(x, bp["ln2"], cfg.norm_eps))
    return x + c, _zero(x)


def _mamba_block_fn(x, cfg, bp):
    h, _, _ = ssm_mod.mamba2_block(cfg, bp["mamba"],
                                   rms_norm(x, bp["ln"], cfg.norm_eps))
    return x + h


def _run_blocks(body, stacked: Params, x: torch.Tensor, remat: bool,
                specs=None, cfg: ModelConfig | None = None):
    """``body(layer i's params, x) -> (x', aux)`` over the stacked layers,
    each checkpointed when ``remat``; returns (x, Σ aux).  ``specs`` (the
    stacked tree's storage specs, on a mesh) gathers each layer's weights
    for its products (``layers.block_params``) inside the checkpointed
    body."""
    aux = _zero(x)
    lspecs = layer_specs(specs)
    wire = layers_mod.block_dtype()
    run = body if lspecs is None else \
        (lambda bp, h: body(block_params(cfg, bp, lspecs, wire), h))
    for bp in layers(stacked):
        if remat:
            x, a = checkpoint(run, bp, x, use_reentrant=False)
        else:
            x, a = run(bp, x)
        aux = aux + a
    return x, aux


def _embed(cfg: ModelConfig, params: Params,
           tokens: torch.Tensor) -> torch.Tensor:
    """The tokens' embeddings (under the tensor-parallel layout from the
    rank's vocabulary range, summed over ``model``)."""
    table, lo = vocab_table(cfg, params, "embed")
    return embed(table, tokens, lo)


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
    x = _embed(cfg, params, tokens)

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
            blocks, x, remat, specs, cfg)
    elif fam == "ssm":
        x, aux = _run_blocks(lambda bp, h: _rwkv_block_fn(h, cfg, bp),
                             blocks, x, remat, specs, cfg)
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
    each; under megatron moved to its compute split at each)."""
    shared = _maybe_cast_blocks(params["shared_attn"])
    shared_specs = param_spec("shared_attn")
    specs = param_spec("blocks")
    if specs is not None:           # the group's leading dim, unsharded
        specs = map_tree(lambda sp: (None,) + tuple(sp), specs)

    def group_body(bp_group, h):
        for bp in layers(bp_group):
            h = _mamba_block_fn(h, cfg, bp)
        full = block_params(cfg, shared, shared_specs,
                            layers_mod.block_dtype())
        return _dense_block_fn(cfg, full, h, positions)[0], _zero(h)

    return _run_blocks(group_body, _grouped(cfg, params["blocks"]), x, remat,
                       specs, cfg)


def _encode(cfg, enc: Params, frames: torch.Tensor, remat: bool):
    """Whisper's encoder over the stub frame embeddings: the memory.  On a
    mesh its blocks' weights are taken at use (``layers.block_params``),
    its input projection gathered whole.  Frames split over ``model``
    (zero_seq, where ``data_specs`` splits them) stay split: the input
    projection, the norms and the MLPs run on the rank's frames, with the
    sinusoidal positions of their global indices, each layer's attention
    gathers its keys and values over the model group (the rank's queries
    local), and the rank's slice of the memory is returned."""
    specs = param_spec("encoder") or {}
    sharded = frames.shape[1] < cfg.n_frames
    off = layers_mod.seq_offset(frames.shape[1]) if sharded else 0
    fpos = torch.arange(off, off + frames.shape[1], device=frames.device)
    wire = layers_mod.block_dtype()
    in_proj = gather_param(enc["in_proj"], specs.get("in_proj"), wire,
                           "in_proj weights")
    mem = einsum("bfd,de->bfe", cast(frames), cast(in_proj))
    mem = mem + _sinusoidal(fpos, cfg.d_model)[None].to(mem.dtype)

    def enc_body(bp, h):
        a = attention_block(cfg, bp["attn"],
                            rms_norm(h, bp["ln1"], cfg.norm_eps), fpos,
                            causal=False, rope=False, seq_sharded=sharded)
        h = h + a
        m = mlp_block(bp["mlp"], rms_norm(h, bp["ln2"], cfg.norm_eps))
        return h + m, _zero(h)

    mem, _ = _run_blocks(enc_body, enc["blocks"], mem, remat,
                         specs.get("blocks"), cfg)
    return rms_norm(mem, gather_param(enc["norm"], specs.get("norm"), wire),
                    cfg.norm_eps)


def _cross_kv(bp: Params, mem: torch.Tensor):
    """The cross-attention's keys and values of the memory (under the
    tensor-parallel layout the rank's heads')."""
    if layers_mod.tensor_parallel():
        mem = layers_mod.replicated_in(mem, "cross in")
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
                       param_spec("blocks"), cfg)


def logits_fn(cfg: ModelConfig, params: Params,
              hidden: torch.Tensor) -> torch.Tensor:
    """Logits of ``hidden`` against the (tied or separate) table, gathered
    at use on a mesh; under the tensor-parallel layout the rank's
    vocabulary range's logits, put together whole by one all-gather over
    ``model``."""
    name = "embed" if cfg.tie_embeddings else "lm_head"
    table, lo = vocab_table(cfg, params, name)
    if lo is None:
        return unembed(table, hidden)
    logits = unembed(table, layers_mod.replicated_in(hidden, "logits in"))
    rng = collectives.one_each(layers_mod.split_ranges(
        cfg.padded_vocab, layers_mod.model_size()))
    return collectives.gather_ranges([(logits, logits.ndim - 1, rng)],
                                     layers_mod.model_group(), "logits")[0]


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
               dtype=torch.bfloat16, device=None, *, mesh=None) -> Params:
    """Zeros/empty cache tree for :func:`decode_step`; with ``mesh`` the
    rank's blocks of it under the serve layout (:func:`cache_layout`)."""
    dev = device_mod.resolve(device)
    if mesh is None:
        return _cache_tree(cfg, batch, max_len, dtype, dev)
    specs = cache_layout(cfg, mesh, batch, max_len)

    def block(path, leaf):
        shape = sharding.local_shape(leaf.shape, specs_at(specs, path), mesh)
        fill = -1 if path[-1] == "key_pos" else 0
        return torch.full(shape, fill, dtype=leaf.dtype, device=dev)

    return sharding.map_with_path(block, cache_shapes(cfg, batch, max_len,
                                                      dtype))


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int,
                 dtype=torch.bfloat16) -> Params:
    """The cache tree as meta tensors (shapes and dtypes, no storage)."""
    return _cache_tree(cfg, batch, max_len, dtype, torch.device("meta"))


def _cache_tree(cfg: ModelConfig, batch: int, max_len: int, dtype,
                dev) -> Params:
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
# Serving over a mesh: the serve layout
# ===========================================================================

def specs_at(specs, path: tuple):
    """The node of a tree at ``path`` (its keys)."""
    node = specs
    for k in path:
        node = node[k]
    return node


def serve_param_specs(cfg: ModelConfig, mesh) -> Params:
    """The serve layout's parameter specs: ``param_specs(fsdp=False)``
    (the weights over ``model`` only, replicated over the batch axes), as
    the reference's ``make_lowering_spec`` lays its bf16 serve weights."""
    return sharding.param_specs(param_shapes(cfg), mesh=mesh, fsdp=False)


def cache_layout(cfg: ModelConfig, mesh, batch: int,
                 max_len: int) -> Params:
    """``cache_specs`` of the global cache: rows over (pod, data), each
    attention cache's sequence over ``model`` (flash-decode), the SSM and
    conv states' and token shifts' trailing dim over ``model`` where it
    divides; ``pos`` and ``key_pos`` replicated."""
    return sharding.cache_specs(cache_shapes(cfg, batch, max_len), mesh)


def serve_params(cfg: ModelConfig, params: Params, mesh) -> Params:
    """The serving state's weights over ``mesh``: the rank's blocks under
    :func:`serve_param_specs` (bf16) with each leaf of the block products
    and the tables moved once to its compute split over ``model``
    (``layers.leaf_layout``, one all-to-all a stacked leaf), which
    :func:`prefill` and :func:`decode_step` take under :func:`serve_hooks`:
    a decode step then moves no weight of those.  A rank holds the bytes
    it held, save the K/V heads its query heads share with another rank's
    (GQA).  At one model rank ``params`` itself."""
    m = sharding.axis_sizes(mesh).get("model", 1)
    if m == 1:
        return params
    specs = serve_param_specs(cfg, mesh)
    group = mesh.get_group("model")

    def move(path, x):
        lay = layers_mod.leaf_layout(cfg, path, m)
        if lay is None:
            return x
        return layers_mod.to_compute(x, tuple(specs_at(specs, path)), lay,
                                     group, "/".join(path[-2:]))

    with torch.no_grad():
        return sharding.map_with_path(move, params)


def serve_layout(cfg: ModelConfig, mesh, *, batch: int, max_len: int,
                 seq: int = 1, mode: str = "megatron") -> tuple:
    """(parameter specs, serve layout) of :func:`serve_hooks`: the
    parameter blocks under :func:`serve_param_specs`; the rank's token
    rows, and under zero_seq its positions, as ``data_specs`` lays a
    (``batch``, ``seq``) batch in activation ``mode`` (already resolved by
    ``sharding.resolve_mode``; decode takes megatron's, ``seq`` 1); the
    cache blocks under :func:`cache_layout`."""
    probe = torch.empty((batch, seq), device="meta")
    tokens = sharding.data_specs(probe, mesh, mode)
    return serve_param_specs(cfg, mesh), {
        "tokens": tuple(tokens),
        "cache": cache_layout(cfg, mesh, batch, max_len)}


def serve_hooks(cfg: ModelConfig, mesh, *, batch: int, max_len: int,
                seq: int = 1, mode: str = "megatron"):
    """The hooks (``layers.mesh_hooks``) under which :func:`prefill` and
    :func:`decode_step` run over ``mesh`` in the serve layout
    (:func:`serve_layout`)."""
    pspecs, serve = serve_layout(cfg, mesh, batch=batch, max_len=max_len,
                                 seq=seq, mode=mode)
    return layers_mod.mesh_hooks(None, pspecs, mesh, serve)


def _cache_block(x: torch.Tensor, path: tuple) -> torch.Tensor:
    """The rank's block, under the serve layout's spec of the cache leaf at
    ``path``, of one layer's leaf ``x`` that holds the rank's token rows
    and is whole along its other dims (off a mesh ``x``).  Where the rows
    also lie over ``model`` (a zero_batch prefill) an all-to-all over the
    model group trades the rank's slice of its peers' rows for theirs of
    its own (or, the leaf not split over ``model``, the rows are
    gathered)."""
    spec = layers_mod.cache_spec(*path)
    if spec is None:
        return x
    rows = sharding.entry_axes(layers_mod.token_spec()[0])
    dims = layers_mod.model_split(spec)
    if "model" not in rows or layers_mod.model_size() == 1:
        return layers_mod.keep_model(x, spec)
    group = layers_mod.get_mesh().get_group("model")
    if not dims:
        return collectives.gather_leaves([x], [(group, False, {0: 0})],
                                         what="cache rows")[0]
    m, d = layers_mod.model_size(), dims[0]
    send = x.unflatten(d, (m, x.shape[d] // m)).movedim(d, 0)
    recv = collectives.all_to_all_dim0(send, group, "cache relayout")
    return recv.flatten(0, 1)


def _kv_cache_block(cfg: ModelConfig, x: torch.Tensor,
                    path: tuple) -> torch.Tensor:
    """The cache block, under the serve layout's spec of the K/V leaf at
    ``path``, of one layer's keys or values that the tensor-parallel
    layout computed (the rank's rows, whole sequence, its K/V heads): the
    heads that two ranks computed kept once, then one all-to-all to the
    rank's slice of the sequence over ``model`` (all heads), or, the
    sequence not split there, one gather of every head."""
    m = layers_mod.model_size()
    group = layers_mod.model_group()
    kvs = layers_mod.kv_ranges(cfg.n_heads, cfg.n_kv_heads, m)
    own = collectives.owned(kvs)
    r = layers_mod.get_mesh().get_local_rank("model")
    x = x.narrow(2, own[r][0] - kvs[r][0], own[r][1] - own[r][0])
    own = collectives.one_each(own)
    if 1 in layers_mod.model_split(layers_mod.cache_spec(*path)):
        rows = layers_mod.split_ranges(x.shape[1], m)
        return collectives.relayout(x, group, (2, own),
                                    (1, collectives.one_each(rows)),
                                    "cache " + path[-1])
    return collectives.gather_ranges([(x, 2, own)], group,
                                     "cache " + path[-1])[0]


def _ssm_cache_block(x: torch.Tensor, path: tuple, dim: int, heads: int,
                     unit: int = 1) -> torch.Tensor:
    """The cache block, under the serve layout's spec of the leaf at
    ``path``, of one layer's SSM state or conv carry: off the
    tensor-parallel layout :func:`_cache_block`; under it, computed for
    the rank's heads (of ``heads``, ``unit`` positions of ``dim`` a head),
    one all-to-all over ``model`` to the cache's split, or, the leaf not
    split over ``model``, one gather of every head; under zero_seq's split
    sequence :func:`_carry_block`."""
    if not layers_mod.tensor_parallel():
        return _carry_block(x, path)
    spec = layers_mod.cache_spec(*path)
    group = layers_mod.model_group()
    m = layers_mod.model_size()
    parts = [((lo * unit, hi * unit),)
             for lo, hi in layers_mod.split_ranges(heads, m)]
    full = heads * unit
    dims = layers_mod.model_split(spec)
    if not dims:
        return collectives.gather_ranges([(x, dim, parts)], group,
                                         "cache " + path[-1])[0]
    d = dims[0]
    n = full if d == dim else x.shape[d]
    split = collectives.one_each(layers_mod.split_ranges(n, m))
    if d == dim and parts == split:
        return x
    return collectives.relayout(x, group, (dim, parts), (d, split),
                                "cache " + path[-1])


def _carry_block(x: torch.Tensor, path: tuple) -> torch.Tensor:
    """The cache block, under the serve layout's spec of the leaf at
    ``path``, of one layer's recurrent carry (an SSM state, a conv window,
    a token shift) computed on the rank's token rows: under zero_seq's
    split sequence the last model rank's carry is the sequence's, and one
    all-to-all over ``model`` sends each rank its slice of it along the
    dim the spec splits over ``model`` (or the whole); else
    :func:`_cache_block`."""
    if layers_mod.seq_group() is None:
        return _cache_block(x, path)
    m, r = layers_mod.model_size(), layers_mod.model_rank()
    dims = layers_mod.model_split(layers_mod.cache_spec(*path))
    d = dims[0] if dims else 0
    n = x.shape[d]
    parts = collectives.one_each(layers_mod.split_ranges(n, m)) if dims \
        else [((0, n),)] * m
    held = [((0, 0),)] * (m - 1) + [((0, 1),)]
    x = x[None] if r == m - 1 else x[None][:0]
    return collectives.relayout(x, layers_mod.model_group(), (0, held),
                                (d + 1, parts), "cache " + path[-1])[0]


def _gather_heads(cfg: ModelConfig, q, k, v) -> list:
    """A decode step's new q, k, v of every head from the ranks' heads
    (tensor-parallel layout): one all-gather over ``model``."""
    m = layers_mod.model_size()
    heads = collectives.one_each(layers_mod.split_ranges(cfg.n_heads, m))
    kvs = collectives.one_each(layers_mod.kv_ranges(cfg.n_heads,
                                                    cfg.n_kv_heads, m))
    return collectives.gather_ranges([(q, 2, heads), (k, 2, kvs),
                                      (v, 2, kvs)],
                                     layers_mod.model_group(), "decode qkv")


def _heads_out(cfg: ModelConfig, p: Params, out: torch.Tensor,
               dtype) -> torch.Tensor:
    """The output projection of every head's attention output ``out``;
    under the tensor-parallel layout the rank's heads' share, summed over
    ``model``."""
    if not layers_mod.tensor_parallel():
        return einsum("bshk,hkd->bsd", out, cast(p["wo"])).to(dtype)
    h0, h1, _, _ = layers_mod.heads_of(cfg)
    return layers_mod.row_parallel("bshk,hkd->bsd", out[:, :, h0:h1],
                                   p["wo"], dtype, "attn out")


def _split_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  valid: torch.Tensor | None, scale: float) -> torch.Tensor:
    """Attention of ``q`` (B, Sq, H, hd) over keys and values split along
    their sequence over ``model`` (k, v: the rank's (B, Sk_local, KV, hd);
    ``valid``: which of its keys count, None for all): each rank's partial
    softmax (its running max, sum of exponentials and unnormalised
    output), gathered over the model group in one all-gather and combined
    by log-sum-exp in rank order, so every model rank gets the same
    output.  The keys and values never move."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, hd)
    scores = einsum_f32("bqgrh,bkgh->bgrqk", qg, k) * scale
    if valid is not None:
        scores = torch.where(valid, scores, -1e30)
    mx = scores.amax(-1, keepdim=True)
    e = torch.exp(scores - mx)
    part = torch.cat([mx, e.sum(-1, keepdim=True),
                      einsum_f32("bgrqk,bkgh->bgrqh", e.to(q.dtype), v)],
                     dim=-1)
    parts = collectives.all_gather(part, layers_mod.get_mesh().get_group(
        "model"), "decode softmax")
    top = torch.stack([p[..., :1] for p in parts]).amax(0)
    den = torch.zeros_like(top)
    num = torch.zeros_like(part[..., 2:])
    for p in parts:
        w = torch.exp(p[..., :1] - top)
        den = den + p[..., 1:2] * w
        num = num + p[..., 2:] * w
    out = (num / den).to(q.dtype)                        # (B, G, R, Sq, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)


# ===========================================================================
# Prefill: full-sequence forward that also materializes the decode cache
# ===========================================================================

def _rwkv_prefill_block(x, cfg, bp):
    xn = rms_norm(x, bp["ln1"], cfg.norm_eps)
    o, sh1, state = ssm_mod.rwkv6_time_mix(cfg, bp["tmix"], xn)
    x = x + o
    xn2 = rms_norm(x, bp["ln2"], cfg.norm_eps)
    c, _ = ssm_mod.rwkv6_channel_mix(cfg, bp["cmix"], xn2)
    return x + c, state, sh1, xn2[:, -1:]


def _mamba_prefill_block(x, cfg, bp):
    xn = rms_norm(x, bp["ln"], cfg.norm_eps)
    o, conv, state = ssm_mod.mamba2_block(cfg, bp["mamba"], xn)
    return x + o, conv, state


def _layer_params(cfg: ModelConfig, stacked: Params, specs,
                  n_tokens: int = 0):
    """Each layer's serve weights (:func:`serve_params`) for its products
    (``layers.block_params``): under the tensor-parallel layout where they
    are, else gathered whole at use (the MoE's expert dim kept local under
    its all-to-all)."""
    keep = cfg.family == "moe" and specs is not None and moe_mod.a2a_applies(
        cfg, n_tokens * layers_mod.token_ranks())
    lspecs = layer_specs(specs)
    for bp in layers(stacked):
        yield block_params(cfg, bp, lspecs, keep_experts=keep)


@torch.no_grad()
def prefill(cfg: ModelConfig, params: Params, batch: dict, max_len: int):
    """Run the prompt through the model and build the decode cache.

    Returns (last-token logits (B, 1, Vp), cache with pos = S).  For
    sliding-window configs only the last ``window`` keys are retained
    (ring-buffer layout, aligned so subsequent decode writes continue it).

    Over a mesh (:func:`serve_hooks`) ``params`` are the rank's serve
    weights (:func:`serve_params`), ``batch`` its token rows (and under
    zero_seq its positions), and the result its rows' logits and its
    blocks of the cache.  Under megatron each model rank computes its
    slice of every block product (its heads, its d_ff, its experts, its
    vocabulary), the partial sums combined over ``model``; each layer's
    keys and values, computed for the rank's heads, move to the cache's
    layout (the sequence over ``model``) by one all-to-all.  Under zero_seq
    and zero_batch the weights are gathered whole at use; zero_seq's
    attention gathers its keys and values over the model group, the
    recurrences run on the rank's positions (their carries, the
    sequence's on the last model rank, sent to the cache's layout by
    :func:`_carry_block`), and a rank keeps its own keys
    and values as its cache block where the cache is the sequence (else
    its slice of the whole sequence's); under zero_batch an all-to-all over
    ``model`` moves each leaf from the rank's rows to the cache's rows over
    (pod, data).
    """
    tokens = batch["tokens"]
    b, s_local = tokens.shape
    dev = tokens.device
    positions = _positions(s_local, dev)
    seq_sharded = layers_mod.sequence_sharded()
    s = s_local * (layers_mod.model_size() if seq_sharded else 1)
    tp = layers_mod.tensor_parallel()
    x = _embed(cfg, params, tokens)
    fam = cfg.family
    s_cache = cache_len(cfg, max_len)
    own_kv = seq_sharded and s == s_cache
    cache: Params = {"pos": torch.tensor(s, dtype=torch.int32, device=dev)}

    def clip_kv(k):  # keep the last s_cache positions, ring-aligned
        if s <= s_cache:
            pad = k.new_zeros((k.shape[0], s_cache - s) + k.shape[2:])
            return torch.cat([k, pad], dim=1)
        return torch.roll(k[:, s - s_cache:], s % s_cache, dims=1)

    if _windowed(cfg, max_len):
        # Position stored in ring slot i is the largest p < s with
        # p % s_cache == i (or -1 if that slot is still empty).
        i = torch.arange(s_cache, device=dev)
        last = s - 1 - torch.remainder(s - 1 - i, s_cache)
        cache["key_pos"] = torch.where((last >= 0) & (last >= s - s_cache),
                                       last, -1).to(torch.int32)

    def attn_kv(bp, h, path, rope=True, window=0):
        """Self-attention of one block: (h + out, k block, v block)."""
        xn = rms_norm(h, bp["ln1"], cfg.norm_eps)
        q, k, v = qkv_project(cfg, bp["attn"], xn, positions, rope=rope)
        if tp:
            o = sdpa(q, *layers_mod.expand_kv(cfg, k, v), causal=True,
                     window=window)
            h = h + layers_mod.row_parallel("bshk,hkd->bsd", o,
                                            bp["attn"]["wo"], h.dtype,
                                            "attn out")
            return (h, _kv_cache_block(cfg, clip_kv(k), path + ("k",)),
                    _kv_cache_block(cfg, clip_kv(v), path + ("v",)))
        if seq_sharded:
            kl, vl = k, v
            k = layers_mod.gather_seq(k, "prefill k")
            v = layers_mod.gather_seq(v, "prefill v")
            o = sdpa(q, k, v, causal=True, window=window,
                     q_offset=layers_mod.seq_offset(s_local))
        else:
            o = sdpa(q, k, v, causal=True, window=window)
        h = h + einsum("bshk,hkd->bsd", o, cast(bp["attn"]["wo"])).to(h.dtype)
        if own_kv:
            return h, kl, vl
        return (h, _cache_block(clip_kv(k), path + ("k",)),
                _cache_block(clip_kv(v), path + ("v",)))

    def stack(kvs):
        return {"k": torch.stack([k for k, _ in kvs]).to(torch.bfloat16),
                "v": torch.stack([v for _, v in kvs]).to(torch.bfloat16)}

    blocks = _layer_params(cfg, params["blocks"], param_spec("blocks"),
                           tokens.numel())
    if fam in ("dense", "moe", "vlm"):
        if fam == "vlm":
            x = _vlm_prefix(cfg, params, batch, x)
        kvs = []
        for bp in blocks:
            x, k, v = attn_kv(bp, x, ("layers",), window=cfg.sliding_window)
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
        for bp in blocks:
            x, state, sh1, sh2 = _rwkv_prefill_block(x, cfg, bp)
            st.append(_ssm_cache_block(state, ("layers", "state"), 1,
                                       ssm_mod.rwkv_dims(cfg)[0]))
            s1.append(_carry_block(sh1, ("layers", "shift1")))
            s2.append(_carry_block(sh2, ("layers", "shift2")))
        cache["layers"] = {"state": torch.stack(st),
                           "shift1": torch.stack(s1).float(),
                           "shift2": torch.stack(s2).float()}

    elif fam == "hybrid":
        shared = block_params(cfg, params["shared_attn"],
                              param_spec("shared_attn"))
        conv, st, kvs = [], [], []
        _, heads, hd = ssm_mod.mamba2_dims(cfg)
        for i, bp in enumerate(blocks):
            x, c, state = _mamba_prefill_block(x, cfg, bp)
            conv.append(_ssm_cache_block(c, ("layers", "conv"), 2, heads,
                                         hd))
            st.append(_ssm_cache_block(state, ("layers", "state"), 1,
                                       heads))
            if (i + 1) % cfg.attn_every == 0:
                x, k, v = attn_kv(shared, x, ("shared_attn",),
                                  window=cfg.sliding_window)
                x = x + mlp_block(shared["mlp"],
                                  rms_norm(x, shared["ln2"], cfg.norm_eps))
                kvs.append((k, v))
        cache["layers"] = {"conv": torch.stack(conv).float(),
                           "state": torch.stack(st)}
        cache["shared_attn"] = stack(kvs)

    elif fam == "audio":
        frames = batch["frames"]
        mem_sharded = frames.shape[1] < cfg.n_frames
        mem = _encode(cfg, params["encoder"], frames, remat=False)
        x = x + _sinusoidal(positions, cfg.d_model)[None].to(x.dtype)
        kvs, xkvs = [], []
        for bp in blocks:
            x, k, v = attn_kv(bp, x, ("layers",), rope=False)
            mk, mv = _cross_kv(bp, mem)
            if mem_sharded:
                mk = layers_mod.gather_seq(mk, "cross k")
                mv = layers_mod.gather_seq(mv, "cross v")
            x = x + cross_attention_block(
                cfg, bp["xattn"], rms_norm(x, bp["ln_x"], cfg.norm_eps),
                mk.to(x.dtype), mv.to(x.dtype))
            x = x + mlp_block(bp["mlp"], rms_norm(x, bp["ln2"], cfg.norm_eps))
            kvs.append((k, v))
            cache_of = (lambda t, p: _kv_cache_block(cfg, t, p)) if tp \
                else _cache_block
            xkvs.append((cache_of(mk, ("cross", "k")),
                         cache_of(mv, ("cross", "v"))))
        cache["layers"] = stack(kvs)
        cache["cross"] = stack(xkvs)
    else:
        raise ValueError(fam)

    last = x[:, -1:]
    if seq_sharded:             # the last position lies on the last rank
        last = layers_mod.gather_seq(last, "prefill last")[:, -1:]
    final_norm = gather_param(params["final_norm"], param_spec("final_norm"))
    h = rms_norm(last, final_norm, cfg.norm_eps)
    return logits_fn(cfg, params, h), cache


def _attn_step(cfg, bp, x, k_cache, v_cache, pos, key_pos, rope=True,
               spec=None):
    """One-token attention against a cache layer, the new key and value
    written into it in place; returns the block's output.  With ``spec``
    (the serve layout's spec of the layer's cache) splitting the sequence
    over ``model``, the rank holds a contiguous block of the slots: only
    the rank whose block holds the write slot writes it (the others write
    back what they hold), and the softmax spans the model group
    (:func:`_split_attend`).  Under the tensor-parallel layout the rank
    computes its heads' q, k and v, gathers every head's over ``model``
    (a few KiB) and projects its heads' share of the output."""
    split = 1 in layers_mod.model_split(spec)
    s_cache = k_cache.shape[1]
    total = s_cache * layers_mod.model_size() if split else s_cache
    windowed = key_pos is not None
    write_at = torch.remainder(pos, total) if windowed else pos
    q, k, v = qkv_project(cfg, bp, x, pos.view(1, 1), rope=rope)
    if layers_mod.tensor_parallel():
        q, k, v = _gather_heads(cfg, q, k, v)
    if not split:
        at = write_at.view(1).long()
        k_cache.index_copy_(1, at, k.to(k_cache.dtype))
        v_cache.index_copy_(1, at, v.to(v_cache.dtype))
        if windowed:
            # ring buffer: mask by key_pos validity instead of a prefix
            # length
            out = _ring_sdpa(q, k_cache, v_cache, key_pos, write_at)
        else:
            out = sdpa(q, k_cache, v_cache, causal=False, kv_len=pos + 1)
        return _heads_out(cfg, bp, out, x.dtype)
    first = layers_mod.get_mesh().get_local_rank("model") * s_cache
    local = write_at - first
    mine = (local >= 0) & (local < s_cache)
    at = local.clamp(0, s_cache - 1).view(1).long()
    for new, buf in ((k, k_cache), (v, v_cache)):
        buf.index_copy_(1, at, torch.where(mine, new.to(buf.dtype),
                                           buf.index_select(1, at)))
    slots = first + torch.arange(s_cache, device=q.device)
    if windowed:
        valid = (key_pos[first:first + s_cache] >= 0) | (slots == write_at)
    else:
        valid = slots < pos + 1
    out = _split_attend(q, k_cache, v_cache, valid,
                        1.0 / math.sqrt(q.shape[-1]))
    return _heads_out(cfg, bp, out, x.dtype)


def _ring_sdpa(q, k_cache, v_cache, key_pos, write_at):
    b, _, h, hd = q.shape
    kv = k_cache.shape[2]
    qg = q.reshape(b, 1, kv, h // kv, hd)
    scores = einsum_f32("bqgrh,bkgh->bgrqk", qg, k_cache)
    scores = scores / math.sqrt(hd)
    slots = torch.arange(k_cache.shape[1], device=q.device)
    valid = (key_pos >= 0) | (slots == write_at)
    scores = torch.where(valid, scores, -1e30)
    probs = torch.softmax(scores, -1)
    out = einsum("bgrqk,bkgh->bqgrh", probs.to(q.dtype), v_cache)
    return out.reshape(b, 1, h, hd)


def _shift(lay: Params, i: int, name: str) -> torch.Tensor:
    """Layer ``i``'s token shift ``name``, whole: gathered over ``model``
    where the serve layout splits it (``"decode shift"``; a (B, 1, D)
    activation)."""
    return layers_mod.gather_model(
        lay[name][i], layers_mod.cache_spec("layers", name), "decode shift")


def _keep_shift(lay: Params, i: int, name: str, x: torch.Tensor) -> None:
    """The rank's slice of the new token shift ``x`` (replicated over
    ``model``) written into layer ``i``'s block in place."""
    lay[name][i].copy_(layers_mod.keep_model(
        x, layers_mod.cache_spec("layers", name)))


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Params, cache: Params,
                tokens: torch.Tensor):
    """One decode step for a (B, 1) token batch.  Returns (logits, cache):
    the cache's tensors updated in place, ``pos`` advanced.

    Over a mesh (:func:`serve_hooks`, megatron's layout) ``params`` are the
    rank's serve weights (:func:`serve_params`), ``tokens`` and the logits
    its rows, ``cache`` its blocks: each model rank computes its slice of
    every block product with the weights it holds (no weight of those
    moves), the partial sums combined over ``model``; an attention cache's
    sequence split over ``model`` stays put, its softmax combined over the
    model group (:func:`_split_attend`); an SSM state stays in its block
    (every head, its value dim split over ``model``), each head's
    per-token inputs gathered for it and its output moved back to the
    rank's heads (``ssm.rwkv6_time_mix_step``, ``ssm.mamba2_step``); the
    token shifts, and the conv carry where its block is not the rank's
    heads' channels, are gathered at use ((B, W-1, d_inner) at most)."""
    pos = cache["pos"]
    tp = layers_mod.tensor_parallel()
    x = _embed(cfg, params, tokens)
    fam = cfg.family
    key_pos = cache.get("key_pos")
    lay = cache["layers"]
    kv_spec = layers_mod.cache_spec("layers", "k") if "k" in lay else None
    blocks = _layer_params(cfg, params["blocks"], param_spec("blocks"),
                           tokens.numel())

    if fam in ("dense", "moe", "vlm"):
        for i, bp in enumerate(blocks):
            x = x + _attn_step(cfg, bp["attn"],
                               rms_norm(x, bp["ln1"], cfg.norm_eps),
                               lay["k"][i], lay["v"][i], pos, key_pos,
                               spec=kv_spec)
            inner = rms_norm(x, bp["ln2"], cfg.norm_eps)
            if "moe" in bp:
                m, _ = moe_mod.moe_block(cfg, bp["moe"], inner)
            else:
                m = mlp_block(bp["mlp"], inner)
            x = x + m

    elif fam == "ssm":
        for i, bp in enumerate(blocks):
            h, sh1, new = ssm_mod.rwkv6_time_mix_step(
                cfg, bp["tmix"], rms_norm(x, bp["ln1"], cfg.norm_eps),
                _shift(lay, i, "shift1"), lay["state"][i])
            lay["state"][i].copy_(new)
            _keep_shift(lay, i, "shift1", sh1)
            x = x + h
            xn = rms_norm(x, bp["ln2"], cfg.norm_eps)
            c, _ = ssm_mod.rwkv6_channel_mix(cfg, bp["cmix"], xn,
                                             shift_prev=_shift(lay, i,
                                                               "shift2"))
            # the token shift carries the *normalized* stream of both mixes
            _keep_shift(lay, i, "shift2", xn[:, -1:])
            x = x + c

    elif fam == "hybrid":
        shared = block_params(cfg, params["shared_attn"],
                              param_spec("shared_attn"))
        shared_spec = layers_mod.cache_spec("shared_attn", "k")
        for i, bp in enumerate(blocks):
            h, conv, state = ssm_mod.mamba2_step(
                cfg, bp["mamba"], rms_norm(x, bp["ln"], cfg.norm_eps),
                lay["conv"][i], lay["state"][i])
            lay["conv"][i].copy_(conv)
            lay["state"][i].copy_(state)
            x = x + h
            if (i + 1) % cfg.attn_every == 0:
                g = i // cfg.attn_every
                x = x + _attn_step(cfg, shared["attn"],
                                   rms_norm(x, shared["ln1"], cfg.norm_eps),
                                   cache["shared_attn"]["k"][g],
                                   cache["shared_attn"]["v"][g], pos, key_pos,
                                   spec=shared_spec)
                x = x + mlp_block(shared["mlp"],
                                  rms_norm(x, shared["ln2"], cfg.norm_eps))

    elif fam == "audio":
        x = x + _sinusoidal(pos.view(1), cfg.d_model)[None].to(x.dtype)
        cross_split = 1 in layers_mod.model_split(
            layers_mod.cache_spec("cross", "k"))
        for i, bp in enumerate(blocks):
            x = x + _attn_step(cfg, bp["attn"],
                               rms_norm(x, bp["ln1"], cfg.norm_eps),
                               lay["k"][i], lay["v"][i], pos, key_pos,
                               rope=False, spec=kv_spec)
            xn = rms_norm(x, bp["ln_x"], cfg.norm_eps)
            mk, mv = cache["cross"]["k"][i], cache["cross"]["v"][i]
            if cross_split or tp:
                q = einsum("bsd,dhk->bshk", xn,
                           cast(bp["xattn"]["wq"])).to(xn.dtype)
                if tp:
                    q = collectives.gather_ranges(
                        [(q, 2, collectives.one_each(layers_mod.split_ranges(
                            cfg.n_heads, layers_mod.model_size())))],
                        layers_mod.model_group(), "decode q")[0]
                out = _split_attend(q, mk, mv, None,
                                    1.0 / math.sqrt(q.shape[-1])) \
                    if cross_split else sdpa(q, mk, mv, causal=False)
                x = x + _heads_out(cfg, bp["xattn"], out, x.dtype)
            else:
                x = x + cross_attention_block(cfg, bp["xattn"], xn, mk, mv)
            x = x + mlp_block(bp["mlp"], rms_norm(x, bp["ln2"], cfg.norm_eps))
    else:
        raise ValueError(fam)

    final_norm = gather_param(params["final_norm"], param_spec("final_norm"))
    h = rms_norm(x, final_norm, cfg.norm_eps)
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
