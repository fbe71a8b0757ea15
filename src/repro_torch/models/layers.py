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
  (attention scores, the MLP's and the experts' gate and up, RWKV-6's
  projections, the logits, the router) the port keeps it too
  (:func:`einsum_f32`: on the card one GEMM of the bf16 operands with a
  float32 result, elsewhere the operands widened), so the two packages'
  bf16 products differ only in the order of their f32 sums.  Mamba-2's
  in-projection is the exception: rounded to bf16, then widened
  (``ssm._mamba2_core`` says why).  With
  ``COMPUTE_DTYPE = torch.float32`` they compute the same products.  A
  product with one f32 operand runs in f32, as JAX promotes it.
- The mesh hooks (``set_activation_spec``, ``get_activation_spec``,
  ``get_block_specs``, ``get_mesh``, ``constrain``) carry the layout of a
  step over a ``torch.distributed`` (data, model) mesh
  (:mod:`repro_torch.train.sharding`): the activation spec, the
  parameters' storage specs and the mesh.  Every tensor of such a step is
  a rank's local block, so ``constrain`` is the identity; the helpers
  below gather what a computation needs across ranks (a weight at use,
  an attention's keys and values over the sequence, a token group; under
  zero_seq a recurrence's halo, :func:`seq_halo`, and an MoE token
  group's rows, moved to the model rank that dispatches it,
  :func:`seq_groups`) with
  the explicit collectives of ``core.collectives``, whose backward sums
  over the ranks that computed distinct slices (the gradient rule of
  ``train/train_step.py``).  Off a mesh every hook is unset and every
  helper is the identity.
- Megatron's tensor-parallel products (:func:`tensor_parallel`: a model
  axis of more than one rank whose ranks hold the same tokens, i.e.
  megatron's training step and its served prefill and decode).  Each leaf
  of a block's products has a compute split over ``model``
  (:func:`leaf_layout`): attention's query heads in contiguous uneven
  groups (rank r takes heads [⌈rH/m⌉, ⌈(r+1)H/m⌉)), its K/V heads those
  its query heads read (a KV head shared by two ranks' heads is computed on
  both), the MLPs' d_ff, the MoE's experts (E dividing m) else their d_ff,
  the tables' vocabulary, the SSM mixers' heads (RWKV-6's and Mamba-2's
  projections by their heads' channels, Mamba-2's B and C on every rank,
  RWKV-6's channel mix by d_ff, the decay LoRA by its columns).
  :func:`block_params` turns a layer's storage blocks into these:
  gathered over the batch axes as before, then moved from the storage
  split to the compute split by one all-to-all a leaf
  (:func:`collectives.relayout`); no such leaf is gathered whole over
  ``model``.  A block's replicated input enters its split products through
  ``collectives.all_reduce_grad`` (Megatron's "f") and the row-parallel
  partial sums leave through ``collectives.all_reduce_value`` ("g") as
  float32, rounded once after the sum (:func:`row_parallel`); a norm
  over channels split so completes its sum of squares over ``model``
  (:func:`rms_norm_split`).  Off a mesh
  and at one model rank the blocks run the code they ran before, bit for
  bit.
- Serving over a mesh (``model.serve_hooks``) sets the same hooks with no
  activation spec and a serve layout: the (B, S) layout of the rank's
  tokens (:func:`token_spec`) and the decode cache's specs
  (:func:`cache_spec`).  Its weights are bf16 and re-laid into the compute
  split once (``model.serve_params``); a zero_seq or zero_batch prefill,
  whose products are whole, gathers them whole at use.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives
from repro_torch.train import sharding

Params = dict[str, Any]

COMPUTE_DTYPE = torch.bfloat16


def cast(x: torch.Tensor) -> torch.Tensor:
    return x.to(COMPUTE_DTYPE)


# ---------------------------------------------------------------------------
# Mesh hooks (zero modes and the mesh step; see train/sharding.py)
# ---------------------------------------------------------------------------

_ACT_SPEC = None
_BLOCK_SPECS = None   # storage specs of the parameters ("blocks" etc.)
_MESH = None          # the DeviceMesh of the step
_SERVE = None         # serving: {"tokens": (B, S) spec, "cache": spec tree}


def set_activation_spec(spec, block_specs=None, mesh=None,
                        serve=None) -> None:
    global _ACT_SPEC, _BLOCK_SPECS, _MESH, _SERVE
    _ACT_SPEC = spec
    _BLOCK_SPECS = block_specs
    _MESH = mesh
    _SERVE = serve


def get_activation_spec():
    return _ACT_SPEC


def get_block_specs():
    return _BLOCK_SPECS


def get_mesh():
    return _MESH


@contextlib.contextmanager
def mesh_hooks(spec, block_specs=None, mesh=None, serve=None):
    """The hooks set for the ``with`` body (a step's forward and backward,
    remat's recomputation included; or a prefill or decode step), then
    restored."""
    saved = _ACT_SPEC, _BLOCK_SPECS, _MESH, _SERVE
    set_activation_spec(spec, block_specs, mesh, serve)
    try:
        yield
    finally:
        set_activation_spec(*saved)


def constrain(x: torch.Tensor) -> torch.Tensor:
    """The reference pins (B, S, D) activations to the activation spec;
    a rank's tensors here are already its block of that layout."""
    return x


def token_spec():
    """The (B, S) layout of the rank's tokens: the activation spec's first
    two entries, else the serve layout's, else the batch over (pod,
    data)."""
    if _ACT_SPEC is not None:
        return tuple(_ACT_SPEC[:2])
    if _SERVE is not None:
        return tuple(_SERVE["tokens"])
    ax = sharding.batch_axes(_MESH)
    return (ax if len(ax) > 1 else ax[0], None)


def token_axes() -> tuple[str, ...]:
    """The mesh axes whose ranks hold distinct tokens (off a mesh none):
    the axes over which a step's gradients are summed."""
    if _MESH is None:
        return ()
    spec = token_spec()
    return tuple(a for e in spec for a in sharding.entry_axes(e))


def token_group():
    return sharding.group_of(_MESH, token_axes())


def token_ranks() -> int:
    """How many ranks hold distinct tokens (1 off a mesh)."""
    sizes = sharding.axis_sizes(_MESH) if _MESH is not None else {}
    return math.prod(sizes[a] for a in token_axes())


def model_size() -> int:
    return sharding.axis_sizes(_MESH).get("model", 1) \
        if _MESH is not None else 1


def sequence_sharded() -> bool:
    """zero_seq: the sequence dim of the activations over ``model``."""
    return _MESH is not None and token_spec()[1] is not None


def cache_spec(*path):
    """The serve layout's spec of the cache leaf at ``path`` without its
    leading layer dim (None off a mesh)."""
    if _SERVE is None:
        return None
    node = _SERVE["cache"]
    for k in path:
        node = node[k]
    return tuple(node[1:])


def model_split(spec) -> list[int]:
    """The dims of ``spec`` split over ``model`` when the model axis has
    more than one rank."""
    if spec is None or model_size() == 1:
        return []
    return [d for d, e in enumerate(spec) if "model" in
            sharding.entry_axes(e)]


def gather_model(x: torch.Tensor, spec, what: str) -> torch.Tensor:
    """The whole of a leaf split over ``model`` under ``spec`` (its other
    dims as the rank holds them)."""
    dims = model_split(spec)
    if not dims:
        return x
    return collectives.gather_leaves(
        [x], [(_MESH.get_group("model"), False, {0: dims[0]})], what=what)[0]


def keep_model(x: torch.Tensor, spec) -> torch.Tensor:
    """The rank's slice of a leaf along the dims ``spec`` splits over
    ``model`` (no communication)."""
    for d in model_split(spec):
        x = collectives.local_chunk(x, d, _MESH.get_group("model"))
    return x


def seq_offset(s_local: int) -> int:
    """Global position of the rank's first sequence position."""
    if not sequence_sharded():
        return 0
    return _MESH.get_local_rank("model") * s_local


def gather_seq(x: torch.Tensor, what: str, dim: int = 1) -> torch.Tensor:
    """The whole sequence of a sequence-sharded tensor (over ``model``;
    backward: the reduce-scatter of the gradient)."""
    return collectives.gather_leaves(
        [x], [(_MESH.get_group("model"), True, {0: dim})], what=what)[0]


def seq_group():
    """The model group where zero_seq splits the sequence over more than
    one rank (contiguous equal ranges in rank order), else None: the
    recurrences then run on the rank's positions, exchanging only what
    crosses a rank's boundary (:func:`seq_halo`, the states of
    ``linear_attn.linear_attention``)."""
    if not sequence_sharded() or model_size() == 1:
        return None
    return model_group()


def seq_halo(x: torch.Tensor, n: int, prev: torch.Tensor | None,
             what: str = "seq halo") -> torch.Tensor:
    """The ``n`` positions before the rank's first of a sequence split over
    ``model`` (``x``: the rank's (B, S_local, ...)), for what looks back a
    fixed number of positions (a token shift, a causal conv): those of
    the ranks before it, however many ranks that takes, by one all-to-all
    (differentiable), and those before the sequence's start from the last
    rows of ``prev`` (a carry of the model's; zeros where None)."""
    m, s = model_size(), x.shape[1]
    own = collectives.one_each([(q * s, (q + 1) * s) for q in range(m)])
    want = collectives.one_each([(max(0, q * s - n), q * s)
                                 for q in range(m)])
    got = collectives.relayout(x, model_group(), (1, own), (1, want), what)
    short = n - got.shape[1]
    if short:
        head = x.new_zeros((x.shape[0], short) + x.shape[2:]) \
            if prev is None else prev[:, prev.shape[1] - short:].to(x.dtype)
        got = torch.cat([head, got], dim=1)
    return got


def gather_param(x: torch.Tensor, spec, wire=None,
                 what: str = "weights") -> torch.Tensor:
    """A parameter's full value from the ranks' blocks under its storage
    ``spec`` (see :func:`gather_params`)."""
    return gather_params({"x": x}, {"x": spec}, wire, what)["x"]


def gather_params(tree: Params, specs, wire=None,
                  what: str = "weights") -> Params:
    """A tree's full values from the ranks' blocks under its storage
    specs, one bucketed all-gather per mesh axis
    (``collectives.gather_leaves``).  Backward: along an axis whose ranks
    hold distinct tokens the reduce-scatter of the gradient, along another
    (megatron's ``model``: its ranks computed the same) the rank's chunk.
    With ``wire`` (bf16 for the zero modes' blocks, the reference's
    ``_maybe_cast_blocks``) float32 blocks are rounded to ``wire`` and
    gathered so; their gradients come back as the ranks' shares summed in
    float32, for the step to round once to ``wire`` after its last sum, as
    one process rounds the gradient of the cast weight."""
    if _MESH is None or specs is None:
        return tree
    # no recursive closure here: one over ``xs`` would keep the gathered
    # tensors alive in a reference cycle until the garbage collector runs
    found = list(_leaves_with_paths(tree, specs))
    names = [path for path, _, _ in found]
    xs = [x for _, x, _ in found]
    sps = [sp for _, _, sp in found]
    tok = token_axes()
    stages = []
    for a in _MESH.mesh_dim_names:
        group = _MESH.get_group(a)
        dims = {}
        for i, sp in enumerate(sps):
            for dim, entry in enumerate(sp):
                if a in sharding.entry_axes(entry):
                    if len(sharding.entry_axes(entry)) > 1:
                        raise NotImplementedError(f"{sp}: one axis a dim")
                    dims[i] = dim
        if dims:
            stages.append((group, a in tok, dims))
    stages = [st for st in stages if collectives.group_size(st[0]) > 1]
    take = [i for i, x in enumerate(xs)
            if any(i in d for _, _, d in stages)
            or (wire is not None and x.dtype == torch.float32)]
    if take:
        remap = {i: j for j, i in enumerate(take)}
        stages = [(g, r, {remap[i]: d for i, d in dims.items()
                          if i in remap}) for g, r, dims in stages]
        got = collectives.gather_leaves([xs[i] for i in take], stages, wire,
                                        what)
        for i, y in zip(take, got):
            xs[i] = y
    out: Params = {}
    for path, x in zip(names, xs):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x
    return out


# ---------------------------------------------------------------------------
# Tensor-parallel products (megatron)
# ---------------------------------------------------------------------------

def tensor_parallel() -> bool:
    """Megatron's products split over ``model``: a mesh whose model axis
    has more than one rank, and those ranks hold the same tokens."""
    return _MESH is not None and model_size() > 1 \
        and "model" not in token_axes()


def model_group():
    return _MESH.get_group("model")


def split_ranges(n: int, m: int) -> list:
    """[⌈rn/m⌉, ⌈(r+1)n/m⌉) for each of ``m`` ranks: contiguous, as even
    as they go, some empty where n < m."""
    return [(-(-r * n // m), -(-(r + 1) * n // m)) for r in range(m)]


def kv_ranges(h: int, kv: int, m: int) -> list:
    """The K/V heads each rank's query heads (:func:`split_ranges` of
    ``h``) read: query head j reads KV head j // (h / kv)."""
    rep = h // kv
    return [(lo // rep, -(-hi // rep)) if hi > lo else (lo // rep, lo // rep)
            for lo, hi in split_ranges(h, m)]


def leaf_layout(cfg: ModelConfig, path: tuple, m: int):
    """(dim counted from the end, each rank's range) of the compute split
    over ``m`` model ranks of the leaf at ``path`` (its keys; a layer's
    tree, or a whole parameter tree, stacked leaves included), or None
    where the leaf's products are not split (norms, the router, the token
    shifts' mixes, the projector).  A rank's part is a tuple of ranges, as
    ``collectives.relayout`` takes it: one range, save Mamba-2's ``w_in``
    (its heads' z, x and dt columns and all of B and C)."""
    name = path[-1]
    parent = path[-2] if len(path) > 1 else None
    if parent in ("tmix", "cmix", "mamba"):
        return _mixer_layout(cfg, parent, name, m)
    if parent in ("attn", "xattn"):
        heads = collectives.one_each(split_ranges(cfg.n_heads, m))
        kvs = collectives.one_each(kv_ranges(cfg.n_heads, cfg.n_kv_heads,
                                             m))
        return {"wq": (-2, heads), "bq": (-2, heads), "wk": (-2, kvs),
                "wv": (-2, kvs), "bk": (-2, kvs), "bv": (-2, kvs),
                "wo": (-3, heads)}.get(name)
    if parent == "mlp" or (parent == "moe" and cfg.n_experts % m):
        f = collectives.one_each(split_ranges(cfg.d_ff, m))
        return {"w_gate": (-1, f), "w_up": (-1, f),
                "w_down": (-2, f)}.get(name)
    if parent == "moe":
        e = collectives.one_each(split_ranges(cfg.n_experts, m))
        return {"w_gate": (-3, e), "w_up": (-3, e),
                "w_down": (-3, e)}.get(name)
    if parent is None and name in ("embed", "lm_head"):
        return (-2, collectives.one_each(split_ranges(cfg.padded_vocab,
                                                      m)))
    return None


def _mixer_layout(cfg: ModelConfig, parent: str, name: str, m: int):
    """:func:`leaf_layout` of an SSM mixer's leaf: split by heads (their
    channels, ``hd`` a head), as the recurrence is independent per head."""
    from repro_torch.models import ssm
    one_each = collectives.one_each
    if parent == "cmix":
        f = one_each(split_ranges(cfg.d_ff, m))
        return {"wk": (-1, f), "wv": (-2, f)}.get(name)
    if parent == "tmix":
        h, hd = ssm.rwkv_dims(cfg)
    else:
        d_inner, h, hd = ssm.mamba2_dims(cfg)
    heads = split_ranges(h, m)
    ch = [(lo * hd, hi * hd) for lo, hi in heads]
    if parent == "tmix":
        lora = one_each(split_ranges(ssm.rwkv_lora(cfg), m))
        heads, ch = one_each(heads), one_each(ch)
        return {"wr": (-1, ch), "wk": (-1, ch), "wv": (-1, ch),
                "wg": (-1, ch), "wb": (-1, ch), "w0": (-1, ch),
                "ln_out": (-1, ch), "u": (-2, heads), "wo": (-2, ch),
                "wa": (-1, lora)}.get(name)
    bc = 2 * d_inner + 2 * cfg.ssm_state       # [z | x | B | C | dt]
    w_in = [((lo, hi), (d_inner + lo, d_inner + hi), (2 * d_inner, bc),
             (bc + lo // hd, bc + hi // hd)) for lo, hi in ch]
    heads, ch = one_each(heads), one_each(ch)
    return {"w_in": (-1, w_in), "conv": (-1, ch), "conv_b": (-1, ch),
            "norm": (-1, ch), "a_log": (-1, heads), "dt_bias": (-1, heads),
            "d_skip": (-1, heads), "w_out": (-2, ch)}.get(name)


def _leaves_with_paths(tree, specs, pre=()):
    for k in tree:
        if isinstance(tree[k], dict):
            yield from _leaves_with_paths(tree[k], specs[k], pre + (k,))
        else:
            yield pre + (k,), tree[k], tuple(specs[k])


def _set(tree: Params, path: tuple, x) -> None:
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = x


def _model_dim(spec):
    dims = [d for d, e in enumerate(spec) if "model" in
            sharding.entry_axes(e)]
    return dims[0] if dims else None


def _strip_model(spec) -> tuple:
    return tuple(None if "model" in sharding.entry_axes(e) else e
                 for e in spec)


def to_compute(x: torch.Tensor, spec, layout, group,
               what: str) -> torch.Tensor:
    """The rank's compute slice ``layout`` = (dim from the end, ranges) of
    a leaf whose block ``x`` is split over the model ``group`` as ``spec``
    says and whole over every other axis: nothing moves where the storage
    split is the compute one; one all-to-all (:func:`collectives.
    relayout`) where it is another dim or other ranges; a slice of a leaf
    the model ranks all hold whole, its gradient summed over them."""
    m = collectives.group_size(group)
    dim, ranges = x.ndim + layout[0], layout[1]
    src = _model_dim(spec)
    if src == dim and list(ranges) == collectives.one_each(
            split_ranges(x.shape[dim] * m, m)):
        return x
    if src is None:
        mine = ranges[torch.distributed.get_rank(group)]
        x = collectives.all_reduce_grad(x, group, what)
        parts = [x.narrow(dim, lo, hi - lo) for lo, hi in mine]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim)
    n = x.shape[src] * m
    return collectives.relayout(
        x, group, (src, collectives.one_each(split_ranges(n, m))),
        (dim, ranges), "relayout " + what)


def block_params(cfg: ModelConfig, tree: Params, specs, wire=None, *,
                 keep_experts: bool = False) -> Params:
    """A layer's (or any subtree's) weights for its products, from the
    rank's blocks under their storage ``specs`` (in serving, the hooks'
    serve layout, from the serve weights already in their compute split,
    ``model.serve_params``).

    Off the tensor-parallel layout: the whole weights, gathered at use
    (:func:`gather_params`; a relaid leaf gathered whole from its compute
    slices, except the experts under the MoE's all-to-all when
    ``keep_experts``).  Under it: each leaf gathered over the batch axes
    (its FSDP blocks, backward the reduce-scatter); each leaf with a
    compute split (:func:`leaf_layout`) then moved to it
    (:func:`to_compute`), the q/k norms' scales made to sum their
    gradients over ``model`` (each rank's heads use them).  No leaf is
    gathered whole over ``model``."""
    if specs is None or _MESH is None:
        return tree
    relaid = _SERVE is not None
    m = model_size()
    group = model_group() if m > 1 else None
    paths = list(_leaves_with_paths(tree, specs))
    lays = {p: leaf_layout(cfg, p, m) for p, _, _ in paths} if m > 1 \
        else {}
    if not tensor_parallel():
        if not relaid or m == 1:
            return gather_params(tree, specs, wire)
        relaid_leaves = {p for p in lays if lays[p] is not None}
        split = sorted(p for p in relaid_leaves if not (
            keep_experts and len(p) > 1 and p[-2] == "moe"))
        out = gather_params(tree, _spec_tree(
            specs, lambda p, sp: _strip_model(sp) if p in relaid_leaves
            else sp), wire)
        got = collectives.gather_ranges(
            [(_get(out, p), _get(out, p).ndim + lays[p][0], lays[p][1])
             for p in split], group, "weights")
        for p, x in zip(split, got):
            _set(out, p, x)
        return out
    tp = {p for p in lays if lays[p] is not None}
    out = gather_params(tree, _spec_tree(specs, lambda p, sp:
                                         _strip_model(sp)), wire)
    for p, _, sp in paths:
        x = _get(out, p)
        if p in tp and not relaid:
            _set(out, p, to_compute(x, sp, lays[p], group,
                                    "/".join(p[-2:])))
        elif p[-1] in ("q_norm", "k_norm"):
            _set(out, p, collectives.all_reduce_grad(x, group, p[-1]))
        elif p not in tp and _model_dim(sp) is not None:
            raise NotImplementedError(f"{p}: split over model with no "
                                      "compute split")
    return out


def _get(tree: Params, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def _spec_tree(specs, fn, pre=()):
    return {k: _spec_tree(v, fn, pre + (k,)) if isinstance(v, dict)
            else fn(pre + (k,), tuple(v)) for k, v in specs.items()}


def model_rank() -> int:
    return _MESH.get_local_rank("model")


def tp_range(n: int) -> tuple:
    """This model rank's [lo, hi) of ``n`` heads (:func:`split_ranges`)
    under the tensor-parallel layout, else all of them."""
    if not tensor_parallel():
        return 0, n
    return split_ranges(n, model_size())[model_rank()]


def heads_of(cfg: ModelConfig) -> tuple:
    """(first query head, end, first KV head, end) of this model rank."""
    m, r = model_size(), _MESH.get_local_rank("model")
    h0, h1 = split_ranges(cfg.n_heads, m)[r]
    g0, g1 = kv_ranges(cfg.n_heads, cfg.n_kv_heads, m)[r]
    return h0, h1, g0, g1


def expand_kv(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor):
    """The rank's K/V heads (B, S, its KV heads, hd) laid one per its
    query head, for :func:`sdpa` (its query heads need not fill whole
    groups)."""
    h0, h1, g0, _ = heads_of(cfg)
    rep = cfg.n_heads // cfg.n_kv_heads
    idx = torch.tensor([j // rep - g0 for j in range(h0, h1)],
                       dtype=torch.long, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def row_parallel(spec: str, a: torch.Tensor, w: torch.Tensor, dtype,
                 what: str) -> torch.Tensor:
    """A product whose contracted dim is split over ``model``: the rank's
    float32 partial sum (:func:`einsum_f32`), summed over the model group
    and rounded once to ``dtype``, as the reference's partitioned
    ``einsum(..., preferred_element_type=f32).astype``."""
    part = einsum_f32(spec, a, cast(w))
    return collectives.all_reduce_value(part, model_group(),
                                        what).to(dtype)


def replicated_in(x: torch.Tensor, what: str) -> torch.Tensor:
    """A replicated tensor entering the rank's slice of split products:
    the identity, its gradient summed over ``model``."""
    return collectives.all_reduce_grad(x, model_group(), what)


def out_product(spec: str, a: torch.Tensor, w: torch.Tensor, dtype,
                what: str) -> torch.Tensor:
    """``einsum(spec, a, w)`` rounded to ``dtype``; under the
    tensor-parallel layout ``a`` and ``w`` hold the rank's slice of the
    contracted dim (:func:`row_parallel`)."""
    if tensor_parallel():
        return row_parallel(spec, a, w, dtype, what)
    return einsum(spec, a, cast(w)).to(dtype)


def model_sum(x: torch.Tensor, what: str) -> torch.Tensor:
    """A partial sum (of the rank's channels) summed over ``model``, for
    each rank's own slice to use: its gradient summed over ``model`` too
    (each rank's share of it)."""
    group = model_group()
    return collectives.all_reduce_value(
        collectives.all_reduce_grad(x, group, what), group, what)


def gather_heads(xs: list, h: int, what: str) -> list:
    """Every head's values of per-token tensors (B, the rank's heads, ...)
    of the tensor-parallel layout: one all-gather over ``model``
    (serving)."""
    heads = collectives.one_each(split_ranges(h, model_size()))
    return collectives.gather_ranges([(x, 1, heads) for x in xs],
                                     model_group(), what)


def vocab_table(cfg: ModelConfig, params: Params, name: str) -> tuple:
    """(the table for the rank's products, the first vocabulary id it
    holds): under the tensor-parallel layout the rank's vocabulary range
    (gathered over the batch axes only; in serving already the rank's),
    else the whole table and None."""
    tree = block_params(cfg, {name: params[name]}, {name: param_spec(name)}
                        if _BLOCK_SPECS is not None else None)
    if not tensor_parallel():
        return tree[name], None
    r = _MESH.get_local_rank("model")
    return tree[name], split_ranges(cfg.padded_vocab, model_size())[r][0]


def block_dtype():
    """The dtype the zero modes hold block weights in (bf16; the
    reference's ``_maybe_cast_blocks``), None in megatron and off a mesh.
    On a mesh they are gathered in it and arrive as float32 holding its
    values."""
    return torch.bfloat16 if _ACT_SPEC is not None else None


def param_spec(*path):
    """The storage spec (tree) at ``path`` of the step's parameter specs,
    None off a mesh."""
    node = _BLOCK_SPECS
    for k in path:
        if node is None:
            return None
        node = node.get(k)
    return node


def layer_specs(specs):
    """A stacked tree's specs without the leading layer dim."""
    if specs is None:
        return None
    return {k: layer_specs(v) if isinstance(v, dict) else tuple(v[1:])
            for k, v in specs.items()}


def tokens_sum(x: torch.Tensor, what: str) -> torch.Tensor:
    """``x`` summed over the ranks that hold distinct tokens, counted once
    in the loss (the gradient passes through to each rank's share)."""
    if _MESH is None or token_ranks() == 1:
        return x
    return collectives.all_reduce_value(x, token_group(), what)


def gather_tokens(x: torch.Tensor, what: str) -> torch.Tensor:
    """The global (B, S, ...) tensor from the ranks' token blocks (backward:
    each rank's block of the summed gradient)."""
    stages = [(sharding.group_of(_MESH, sharding.entry_axes(e)), True,
               {0: dim}) for dim, e in enumerate(token_spec()) if e]
    return collectives.gather_leaves([x], stages, what=what)[0]


def local_tokens(x: torch.Tensor) -> torch.Tensor:
    """The rank's block of a global (B, S, ...) tensor."""
    spec = token_spec() + (None,) * (x.ndim - 2)
    return sharding.local_shard(x, spec, _MESH)


def seq_groups(b: int, s: int, tg: int):
    """zero_seq's placement of token groups (``tg`` tokens each, contiguous
    in the global (B, S) row-major order) that each lie within one data
    rank's rows (``b`` of them, ``s`` positions a model rank): the data
    rank's groups split over its model ranks in contiguous blocks
    (:func:`split_ranges`), the reference's G over (data, model) where
    ``model`` divides them, else some ranks hold none.  Returns (have,
    want), each model rank's part of the data rank's b·S tokens in that
    order as :func:`collectives.relayout` takes parts: the positions it
    holds (a range a row) and the groups it dispatches.  None where the
    sequence is not split over ``model`` or a group spans data ranks."""
    if seq_group() is None:
        return None
    m = model_size()
    n = b * s * m
    if n % tg:
        return None
    have = [tuple((i * s * m + q * s, i * s * m + (q + 1) * s)
                  for i in range(b)) for q in range(m)]
    want = collectives.one_each([(lo * tg, hi * tg)
                                 for lo, hi in split_ranges(n // tg, m)])
    return have, want


def to_groups(x: torch.Tensor, parts, what: str) -> torch.Tensor:
    """The tokens of the groups the rank dispatches, (its groups · tg,
    ...), from its (B_local, S_local, ...) block: one all-to-all over
    ``model`` (:func:`seq_groups`' parts; differentiable)."""
    have, want = parts
    return collectives.relayout(x.reshape((-1,) + x.shape[2:]),
                                model_group(), (0, have), (0, want), what)


def from_groups(x: torch.Tensor, parts, b: int, what: str) -> torch.Tensor:
    """:func:`to_groups` the other way: the rank's (b, S_local, ...)
    block of its groups' tokens ``x``, one all-to-all over ``model``."""
    have, want = parts
    out = collectives.relayout(x, model_group(), (0, want), (0, have), what)
    return out.reshape((b, -1) + tuple(x.shape[1:]))


def einsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` of two operands in their common dtype: f32
    accumulation, one rounding to a ``COMPUTE_DTYPE`` result; f32 when
    either operand is f32 (JAX's promotion)."""
    if a.dtype != b.dtype:
        a, b = a.float(), b.float()
    return torch.einsum(spec, a, b)


def einsum_f32(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The reference's f32-kept product (``preferred_element_type=f32``
    with no ``.astype`` after it): the operands' exact products,
    accumulated in float32, a float32 result.  Two bf16 operands take
    :class:`_F32Product`, whose GEMM is chosen by their device
    (:func:`_gemm`); where an operand is float32 the operands are widened
    and multiplied in float32 (their products are exact there)."""
    if a.dtype == b.dtype == torch.bfloat16:
        return _F32Product.apply(spec, a, b)
    return torch.einsum(spec, a.float(), b.float())


def f32_sum_bound(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """2·k·2^-24·(|a|·|b|), elementwise in float64: the widest gap of two
    float32 sums of ``spec``'s k exact products (k the contracted letters'
    sizes) taken in any two orders, as :func:`einsum_f32` on the card and
    the widened product are."""
    ins, out = spec.split("->")
    sa, sb = ins.split(",")
    size = dict(zip(sa, a.shape)) | dict(zip(sb, b.shape))
    k = math.prod(size[c] for c in set(sa + sb) - set(out))
    return 2 * k * 2.0 ** -24 * torch.einsum(
        spec, a.detach().abs().double(), b.detach().abs().double())


@functools.lru_cache(maxsize=None)
def _mm_plan(spec: str) -> tuple:
    """An einsum of two operands as one (batched) matrix product: the
    permutations that lay ``a`` out as (batch, m, k) and ``b`` as (batch,
    k, n), the letters' counts, and the permutation from (batch, m, n) to
    the output.  Batch, m and n letters are taken in the output's order,
    so the usual specs need no permutation of the result."""
    ins, out = spec.split("->")
    sa, sb = ins.split(",")
    bat = [c for c in out if c in sa and c in sb]
    m = [c for c in out if c in sa and c not in sb]
    n = [c for c in out if c in sb and c not in sa]
    k = [c for c in sa if c in sb and c not in out]
    if sorted(sa) != sorted(bat + m + k) or sorted(sb) != sorted(bat + k + n) \
            or sorted(out) != sorted(bat + m + n):
        raise ValueError(f"einsum_f32: {spec!r} is not a matrix product")
    mid = bat + m + n
    return ([sa.index(c) for c in bat + m + k],
            [sb.index(c) for c in bat + k + n],
            [mid.index(c) for c in out], len(bat), len(m), len(k))


def _as_3d(x: torch.Tensor, perm, nb: int, n1: int) -> torch.Tensor:
    """``x`` permuted and flattened to (batch, rows, cols): its first
    ``nb`` permuted dims, the next ``n1``, the rest."""
    x = x.permute(perm)
    s = x.shape
    return x.reshape(math.prod(s[:nb]), math.prod(s[nb:nb + n1]),
                     math.prod(s[nb + n1:]))


def _inverse(perm) -> list:
    inv = [0] * len(perm)
    for i, d in enumerate(perm):
        inv[d] = i
    return inv


def _from_3d(y: torch.Tensor, shape, perm) -> torch.Tensor:
    """:func:`_as_3d` undone: ``y`` to the permuted ``shape``, then back
    to the order before ``perm``."""
    return y.reshape(shape).permute(_inverse(perm))


def _gemm(x: torch.Tensor, y: torch.Tensor, nb: int) -> torch.Tensor:
    """(batch, m, k) @ (batch, k, n) with a float32 result, ``mm`` where
    the spec has no batch letter.  bf16 operands on the card go into one
    GEMM on the tensor cores with ``out_dtype=float32``; elsewhere the
    operands are widened (a float32 operand already is)."""
    if x.is_cuda and x.dtype == torch.bfloat16:
        kw = {"out_dtype": torch.float32}
    else:
        x, y, kw = x.float(), y.float(), {}
    if nb:
        return torch.bmm(x, y, **kw)
    return torch.mm(x[0], y[0], **kw)[None]


class _F32Product(torch.autograd.Function):
    """:func:`einsum_f32` of two bf16 operands: laid out as (batch, m, k)
    and (batch, k, n) and multiplied by :func:`_gemm` with a float32
    result.  The card's overload has no derivative, so the backward is
    written here, the same on every device: the reference's transpose,
    each operand's gradient the float32 cotangent times the other operand
    widened, accumulated in float32 and rounded once to the operand's
    dtype.  The bf16 operands are what is saved for it."""

    @staticmethod
    def forward(ctx, spec, a, b):
        pa, pb, po, nb, nm, nk = _mm_plan(spec)
        ctx.spec = spec
        ctx.save_for_backward(a, b)
        a3, b3 = _as_3d(a, pa, nb, nm), _as_3d(b, pb, nb, nk)
        y = _gemm(a3, b3, nb)
        mid = [a.shape[d] for d in pa[:nb + nm]] + \
            [b.shape[d] for d in pb[nb + nk:]]
        return y.reshape(mid).permute(po)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        pa, pb, po, nb, nm, nk = _mm_plan(ctx.spec)
        g3 = _as_3d(g.float(), _inverse(po), nb, nm)
        a3, b3 = _as_3d(a, pa, nb, nm), _as_3d(b, pb, nb, nk)
        ga = gb = None
        if ctx.needs_input_grad[1]:
            ga = _from_3d(_gemm(g3, b3.float().transpose(1, 2), nb).to(
                a.dtype), [a.shape[d] for d in pa], pa)
        if ctx.needs_input_grad[2]:
            gb = _from_3d(_gemm(a3.float().transpose(1, 2), g3, nb).to(
                b.dtype), [b.shape[d] for d in pb], pb)
        return None, ga, gb


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * scale.float()).to(dt)


def rms_norm_split(x: torch.Tensor, scale: torch.Tensor, n: int,
                   eps: float, what: str) -> torch.Tensor:
    """:func:`rms_norm` over ``n`` channels; under the tensor-parallel
    layout ``x`` and ``scale`` hold the rank's channels, whose float32 sum
    of squares is completed over ``model`` (:func:`model_sum`)."""
    if not tensor_parallel():
        return rms_norm(x, scale, eps)
    dt = x.dtype
    xf = x.float()
    ss = model_sum(xf.square().sum(-1, keepdim=True), what)
    return ((xf * torch.rsqrt(ss / n + eps)) * scale.float()).to(dt)


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
    rep = h // kv if kv else 1      # kv 0: a model rank that holds no head
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, sq, kv, rep, hd)
    kpos = torch.arange(sk, device=q.device)

    def attend(q_blk: torch.Tensor, blk_offset: int) -> torch.Tensor:
        c = q_blk.shape[1]
        scores = einsum_f32("bqgrh,bkgh->bgrqk", q_blk, k) * scale
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

    if sq <= q_chunk or sequence_sharded():
        # zero_seq: the rank's queries are already S/model long; the
        # reference does not chunk them either.
        return attend(qg, 0)
    while sq % q_chunk:
        q_chunk -= 1
    outs = [checkpoint(attend, qg[:, i:i + q_chunk], i, use_reentrant=False)
            for i in range(0, sq, q_chunk)]
    return torch.cat(outs, dim=1)


def attention_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                    positions: torch.Tensor, *, causal: bool = True,
                    rope: bool = True, window: int | None = None,
                    seq_sharded: bool | None = None) -> torch.Tensor:
    """``positions`` are the global positions of ``x``'s rows.  Under
    zero_seq (``seq_sharded``, by default the hooks' layout) the rank's
    queries stay local and its keys and values are gathered over the
    model group; the causal mask and window use global positions.  Under
    the tensor-parallel layout ``p`` holds the rank's heads
    (:func:`block_params`) and the output is summed over ``model``."""
    w = cfg.sliding_window if window is None else window
    if tensor_parallel():
        q, k, v = qkv_project(cfg, p, replicated_in(x, "attn in"), positions,
                              rope=rope)
        k, v = expand_kv(cfg, k, v)
        out = sdpa(q, k, v, causal=causal, window=w)
        return row_parallel("bshk,hkd->bsd", out, p["wo"], x.dtype,
                            "attn out")
    q, k, v = qkv_project(cfg, p, x, positions, rope=rope)
    if sequence_sharded() if seq_sharded is None else seq_sharded:
        offset = seq_offset(x.shape[1])
        k, v = gather_seq(k, "attn k"), gather_seq(v, "attn v")
        out = sdpa(q, k, v, causal=causal, window=w, q_offset=offset)
    else:
        out = sdpa(q, k, v, causal=causal, window=w)
    return einsum("bshk,hkd->bsd", out, cast(p["wo"])).to(x.dtype)


def cross_attention_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                          mem_k: torch.Tensor, mem_v: torch.Tensor
                          ) -> torch.Tensor:
    """Decoder cross-attention over precomputed encoder K/V (no rope);
    under the tensor-parallel layout ``p`` and ``mem_k``, ``mem_v`` hold
    the rank's heads."""
    if tensor_parallel():
        xin = replicated_in(x, "xattn in")
        q = einsum("bsd,dhk->bshk", xin, cast(p["wq"])).to(x.dtype)
        k, v = expand_kv(cfg, mem_k, mem_v)
        out = sdpa(q, k, v, causal=False)
        return row_parallel("bshk,hkd->bsd", out, p["wo"], x.dtype,
                            "xattn out")
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
    """Under the tensor-parallel layout ``p`` holds the rank's d_ff slice
    and the output is summed over ``model``."""
    tp = tensor_parallel()
    out_dtype = x.dtype
    if tp:
        x = replicated_in(x, "mlp in")
    if "w_gate" in p:
        gate = einsum_f32("bsd,df->bsf", x, cast(p["w_gate"]))
        up = einsum_f32("bsd,df->bsf", x, cast(p["w_up"]))
        h = (F.silu(gate) * up).to(x.dtype)
    else:
        up = einsum_f32("bsd,df->bsf", x, cast(p["w_up"]))
        h = gelu(up).to(x.dtype)
    if tp:
        return row_parallel("bsf,fd->bsd", h, p["w_down"], out_dtype,
                            "mlp out")
    return einsum("bsf,fd->bsd", h, cast(p["w_down"])).to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embed(cfg: ModelConfig, gen: torch.Generator, device) -> torch.Tensor:
    return normal(gen, (cfg.padded_vocab, cfg.d_model),
                  1.0 / math.sqrt(cfg.d_model), device)


def embed(table: torch.Tensor, tokens: torch.Tensor,
          vocab_lo: int | None = None) -> torch.Tensor:
    """The tokens' rows of ``table``.  With ``vocab_lo`` (the
    tensor-parallel layout, :func:`vocab_table`) ``table`` holds the
    vocabulary from ``vocab_lo``: the rank looks up the tokens it holds,
    zero for the others, and the rows are summed over ``model``."""
    if vocab_lo is None:
        return F.embedding(tokens.long(), cast(table))
    local = tokens.long() - vocab_lo
    hit = (local >= 0) & (local < table.shape[0])
    rows = F.embedding(torch.where(hit, local, 0), cast(table))
    rows = torch.where(hit[..., None], rows, 0.0)
    return collectives.all_reduce_value(rows, model_group(), "embed")


def unembed(table: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Logits against the (possibly tied) embedding table: (B, S, Vp),
    f32."""
    return einsum_f32("bsd,vd->bsv", h, cast(table))
