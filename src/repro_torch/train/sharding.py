"""Sharding rules: parameter, batch, activation and cache layouts over a
(pod, data, model) mesh for train and serve (port of
``repro.train.sharding``).

Three modes, the reference's:

``mode="megatron"``: FSDP over ``data`` and storage sharding over
``model``; the batch over (pod, data).  Attention projections are (D, H,
hd): the greedy rule puts ``model`` on the last dim it divides, ``data``
on the first remaining one; MoE experts shard over ``model`` when E
divides it (expert parallel), else their d_ff; the embedding / lm_head
table is (Vp, D) with vocab over ``model``; 1-D leaves replicate; leaves
under a stacked ``blocks`` collection skip their leading layer dim.

``mode="zero_seq"``: ZeRO-3 storage sharding (``model`` on the largest
dim it divides, ``data`` on the next; experts keep expert parallelism;
the table keeps vocab over ``model``), activations (B → data, S → model).

``mode="zero_batch"``: the batch over every axis; parameters take
``zero_seq``'s specs (the launcher's rule).

A spec is the port's own :func:`P`: a tuple with one entry a dim, each
``None``, an axis name or a tuple of names, as ``jax.sharding.
PartitionSpec`` holds them.  The spec functions read only the mesh's axis
names and sizes, from a ``DeviceMesh`` or a plain ``{axis: size}``
mapping, and a tree's leaf shapes (tensors, meta tensors, anything with
``.shape``), so the 16×16 and 2×16×16 layouts of a 76 B-parameter model
are computed without allocating it.

The reference hands its specs to XLA's SPMD partitioner.  The port keeps
plain local tensors beside their specs: :func:`shard_tree` cuts a full
tree into a rank's shards, :func:`gather_tree` puts the full tree back
together (checkpoints, checks), and the model takes each leaf at use
with the explicit collectives of ``core.collectives``
(``models/layers.py``: gathered whole, or under megatron gathered over
``data`` and moved to its tensor-parallel compute split over ``model``).  DTensor is not used: the MoE's sort and scatter
and the chunked recurrences lie outside its propagation rules, and the
explicit form keeps every collective, and its gradient, in view.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

Spec = tuple


def P(*entries) -> Spec:
    """A partition spec: one entry a dim (``None``, an axis name or a
    tuple of names); ``P()`` replicates."""
    return tuple(entries)


def axis_sizes(mesh) -> dict[str, int]:
    """{axis: size} of a ``DeviceMesh`` or of a mapping (a mesh's read
    once and kept on it: under ``FakeTensorMode`` its rank table cannot be
    read)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    if "_axis_sizes" not in mesh.__dict__:
        mesh.__dict__["_axis_sizes"] = dict(zip(mesh.mesh_dim_names,
                                                mesh.mesh.shape))
    return dict(mesh.__dict__["_axis_sizes"])


def _names(mesh) -> tuple[str, ...]:
    return tuple(axis_sizes(mesh))


def _greedy_spec(shape: tuple[int, ...], start: int, mesh_sizes: dict[str, int],
                 fsdp_axis: str | None) -> Spec:
    assign: list[Any] = [None] * len(shape)
    # model on the last shardable dim
    for i in reversed(range(start, len(shape))):
        if shape[i] % mesh_sizes["model"] == 0:
            assign[i] = "model"
            break
    if fsdp_axis:
        for i in range(start, len(shape)):
            if assign[i] is None and shape[i] % mesh_sizes[fsdp_axis] == 0:
                assign[i] = fsdp_axis
                break
    return P(*assign)


def map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over a tree of nested dicts (path: the keys)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _is_stacked(path: tuple) -> bool:
    return "blocks" in path


def param_specs(params_or_shapes: Any, *, mesh, fsdp: bool = True,
                mode: str = "megatron") -> Any:
    """Spec tree for a parameter tree (tensors or shapes)."""
    mesh_sizes = axis_sizes(mesh)
    fsdp_axis = "data" if (fsdp and "data" in mesh_sizes) else None

    def zero_rule(path, leaf):
        """ZeRO-3 storage sharding: big dims over model/data wherever they
        divide; embeddings keep vocab over model; MoE experts keep expert
        parallelism when E divides the model axis."""
        shape = tuple(leaf.shape)
        name = path[-1]
        start = 1 if _is_stacked(path) else 0
        eff = shape[start:]
        if len(eff) <= 1:
            return P()
        if name in ("embed", "lm_head"):
            spec = [None] * len(shape)
            if shape[0] % mesh_sizes["model"] == 0:
                spec[0] = "model"
            if fsdp_axis and shape[1] % mesh_sizes[fsdp_axis] == 0:
                spec[1] = fsdp_axis
            return P(*spec)
        if name in ("w_gate", "w_up", "w_down") and len(eff) == 3 \
                and eff[0] % mesh_sizes["model"] == 0:
            spec = [None] * len(shape)
            spec[start] = "model"                  # expert parallel
            if fsdp_axis and eff[1] % mesh_sizes[fsdp_axis] == 0:
                spec[start + 1] = fsdp_axis
            return P(*spec)
        # generic ZeRO: model on the largest divisible dim, data on the
        # next largest remaining divisible dim
        spec = [None] * len(shape)
        order = sorted(range(start, len(shape)), key=lambda i: -shape[i])
        for i in order:
            if shape[i] % mesh_sizes["model"] == 0:
                spec[i] = "model"
                break
        if fsdp_axis:
            for i in order:
                if spec[i] is None and shape[i] % mesh_sizes[fsdp_axis] == 0:
                    spec[i] = fsdp_axis
                    break
        return P(*spec)

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        name = path[-1]
        start = 1 if _is_stacked(path) else 0
        eff = shape[start:]
        if len(eff) <= 1:
            return P()
        if name in ("embed", "lm_head"):
            spec = [None] * len(shape)
            if shape[0] % mesh_sizes["model"] == 0:
                spec[0] = "model"
            if fsdp_axis and shape[1] % mesh_sizes[fsdp_axis] == 0:
                spec[1] = fsdp_axis
            return P(*spec)
        if name == "router":
            # (L, D, E): E is small; shard D over fsdp only
            spec = [None] * len(shape)
            if fsdp_axis and shape[start] % mesh_sizes[fsdp_axis] == 0:
                spec[start] = fsdp_axis
            return P(*spec)
        if name in ("w_gate", "w_up", "w_down") and len(eff) == 3:
            # MoE expert weights (L, E, a, b)
            e = eff[0]
            spec = [None] * len(shape)
            if e % mesh_sizes["model"] == 0:
                spec[start] = "model"          # expert parallel
                if fsdp_axis and eff[1] % mesh_sizes[fsdp_axis] == 0:
                    spec[start + 1] = fsdp_axis
            else:
                # Megatron inside experts: shard the f dim over model
                f_dim = start + (2 if name != "w_down" else 1)
                other = start + (1 if name != "w_down" else 2)
                if shape[f_dim] % mesh_sizes["model"] == 0:
                    spec[f_dim] = "model"
                if fsdp_axis and shape[other] % mesh_sizes[fsdp_axis] == 0:
                    spec[other] = fsdp_axis
            return P(*spec)
        return _greedy_spec(shape, start, mesh_sizes, fsdp_axis)

    return map_with_path(zero_rule if mode == "zero_seq" else rule,
                         params_or_shapes)


def batch_axes(mesh) -> tuple[str, ...]:
    """Mesh axes that shard the global batch dimension."""
    names = _names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def data_specs(batch_template: Any, mesh, mode: str = "megatron") -> Any:
    """Batch arrays shard their leading dim over (pod, data); in zero_seq
    mode the sequence dim (dim 1) additionally shards over ``model``; in
    zero_batch mode the batch dim shards over ALL axes (pure ZeRO-DP)."""
    ax = batch_axes(mesh)
    model = axis_sizes(mesh).get("model", 1)
    all_ax = ax + ("model",) if model > 1 else ax

    def rule(leaf):
        shape = tuple(leaf.shape)
        spec: list[Any] = [None] * len(shape)
        if (mode == "zero_batch" and shape
                and shape[0] % _prod(mesh, all_ax) == 0):
            spec[0] = all_ax
            return P(*spec)
        if shape and shape[0] % _prod(mesh, ax) == 0:
            spec[0] = ax if len(ax) > 1 else ax[0]
        if (mode == "zero_seq" and len(shape) >= 2
                and shape[1] % model == 0 and model > 1):
            spec[1] = "model"
        return P(*spec)

    return {k: data_specs(v, mesh, mode) if isinstance(v, dict) else rule(v)
            for k, v in batch_template.items()} \
        if isinstance(batch_template, dict) else rule(batch_template)


def resolve_mode(mesh, mode: str, global_batch: int, seq_len: int = 0) -> str:
    """zero_batch needs B to divide the whole mesh; fall back to zero_seq
    (which needs S to divide the model axis; else megatron)."""
    sizes = axis_sizes(mesh)
    model = sizes.get("model", 1)
    if mode == "zero_batch":
        full = _prod(mesh, batch_axes(mesh)) * model
        if global_batch % full == 0:
            return "zero_batch"
        mode = "zero_seq"
    if mode == "zero_seq" and seq_len and seq_len % model:
        return "megatron"
    return mode


def activation_spec(mesh, mode: str = "megatron") -> Spec | None:
    """The (B, S, D) hidden-state layout of the forward pass.  zero_seq:
    batch over (pod, data), sequence over model.  zero_batch: batch over
    every axis.  megatron: None (the batch's own layout)."""
    ax = batch_axes(mesh)
    if mode == "zero_batch":
        model = axis_sizes(mesh).get("model", 1)
        all_ax = ax + ("model",) if model > 1 else ax
        return P(all_ax, None, None)
    if mode != "zero_seq":
        return None
    return P(ax if len(ax) > 1 else ax[0], "model", None)


def cache_specs(cache_template: Any, mesh) -> Any:
    """Decode caches: batch dim over (pod, data); attention K/V sequence dim
    over ``model`` (flash-decode layout); SSM states shard their trailing
    head_dim over ``model`` when divisible."""
    ax = batch_axes(mesh)
    nbatch = _prod(mesh, ax)
    model = axis_sizes(mesh).get("model", 1)
    bspec = ax if len(ax) > 1 else (ax[0] if ax else None)

    def rule(path, leaf):
        name = path[-1]
        shape = tuple(leaf.shape)
        if name in ("pos", "key_pos"):
            return P()
        spec: list[Any] = [None] * len(shape)
        if name in ("k", "v"):
            # (n, B, S, KV, hd)
            if shape[1] % nbatch == 0 and nbatch > 1:
                spec[1] = bspec
            if shape[2] % model == 0:
                spec[2] = "model"
            return P(*spec)
        # ssm state (L, B, H, K, P), conv (L, B, W-1, d_inner), shifts
        if len(shape) >= 2 and shape[1] % nbatch == 0 and nbatch > 1:
            spec[1] = bspec
        for i in reversed(range(2, len(shape))):
            if shape[i] % model == 0:
                spec[i] = "model"
                break
        return P(*spec)

    return map_with_path(rule, cache_template)


def _prod(mesh, axes: tuple[str, ...]) -> int:
    sizes = axis_sizes(mesh)
    out = 1
    for a in axes:
        out *= sizes[a]
    return out


# ---------------------------------------------------------------------------
# Local shards on a DeviceMesh
# ---------------------------------------------------------------------------

def entry_axes(entry) -> tuple[str, ...]:
    """The axes of one spec entry."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def spec_axes(spec: Spec) -> set[str]:
    """Every axis a spec names."""
    return {a for e in spec for a in entry_axes(e)}


def shard_index(mesh, axes: tuple[str, ...]) -> tuple[int, int]:
    """(this rank's chunk, the number of chunks) of a dim split over
    ``axes`` (major to minor, as JAX lays a tuple entry out)."""
    sizes = axis_sizes(mesh)
    idx, n = 0, 1
    for a in axes:
        idx = idx * sizes[a] + mesh.get_local_rank(a)
        n *= sizes[a]
    return idx, n


def local_shard(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of the full ``x`` under ``spec`` (a view)."""
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        if axes:
            idx, n = shard_index(mesh, axes)
            size = x.shape[dim] // n
            x = x.narrow(dim, idx * size, size)
    return x


def local_shape(shape, spec: Spec, mesh_or_sizes) -> tuple[int, ...]:
    """The shape of a rank's block of a leaf of ``shape`` under ``spec``."""
    sizes = axis_sizes(mesh_or_sizes)
    out = list(shape)
    for dim, entry in enumerate(spec):
        for a in entry_axes(entry):
            out[dim] //= sizes[a]
    return tuple(out)


def _map2(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


def shard_tree(tree: Any, specs: Any, mesh) -> Any:
    """The rank's local shards of a full tree: each leaf's block under its
    spec, copied so that the full leaf can be freed."""
    return _map2(lambda x, s: local_shard(x, s, mesh).clone(
        memory_format=torch.contiguous_format), tree, specs)


def group_of(mesh, axes: tuple[str, ...]):
    """The process group of the ranks that differ only along ``axes`` (any
    sub-tuple of the mesh's axes): one axis, its ``DeviceMesh`` group;
    every axis, the whole job (whose ranks ``make_host_mesh`` lays out in
    the mesh's row-major order); else the group of ``DeviceMesh``'s own
    flattening of those axes, e.g. (pod, data).  A flattened group is
    built once per mesh and kept on it: building one is collective, so
    every rank meets the same sequence of new axis tuples, which the
    layers' fixed order of calls gives."""
    names = _names(mesh)
    if set(axes) - set(names):
        raise ValueError(f"axes {axes} of a mesh {names}")
    axes = tuple(a for a in names if a in axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if axes == names:
        import torch.distributed as dist
        return dist.group.WORLD
    if not axes:
        raise ValueError("a group over no axis")
    cache = mesh.__dict__.setdefault("_groups_by_axes", {})
    if axes not in cache:
        cache[axes] = mesh[axes]._flatten().get_group()
    return cache[axes]


@torch.no_grad()
def gather_leaf(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The full leaf from every rank's block of it."""
    from repro_torch.core import collectives
    stages = [(group_of(mesh, entry_axes(e)), False, {0: dim})
              for dim, e in enumerate(spec) if e]
    return collectives.gather_leaves([x], stages, what="gather_tree")[0]


def gather_tree(tree: Any, specs: Any, mesh) -> Any:
    """The full tree from every rank's local shards (collective: every
    rank calls it and gets the whole tree; a replicated leaf is returned
    as it is, not copied)."""
    return _map2(lambda x, s: gather_leaf(x.detach(), s, mesh).contiguous(),
                 tree,
                 specs)
