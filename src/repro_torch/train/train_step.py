"""The training step: microbatched gradient accumulation, remat, mixed
precision, AdamW (port of ``repro.train.train_step``).

Gradients come from autograd over the parameter tree's leaves; the
microbatches run in a Python loop and their gradients are summed and
averaged as the reference's scan averages them.  The step updates the
parameters and the optimizer state in place (:func:`repro_torch.optim.
adamw.update`) and returns them with the metrics ``loss``, ``lr``,
``grad_norm``, ``ce`` and ``aux`` (device scalars; reading one syncs).

Over a (data, model) mesh (``mesh=``, a ``DeviceMesh`` of
``launch/mesh.py``; one process a rank) the step takes the reference's
layouts (:mod:`repro_torch.train.sharding`): the parameters, m and v are
the rank's blocks under ``param_specs`` (``zero_seq``'s specs for
``zero_batch``, as the reference's launcher chooses), the batch is the
global one on every rank, and the step computes what the one-card step
computes on it:

* the targets and mask are formed from the global rows, then each
  microbatch (global rows, as the reference splits them) is cut to the
  rank's block by ``data_specs``.  A microbatch must split over the
  ranks that hold distinct rows: where ``tcfg.microbatches`` would cut
  the batch finer (16 microbatches of a 256-row batch over the 32 (pod,
  data) ranks of a 2×16×16 mesh), consecutive microbatches are merged
  until they split (:func:`mesh_microbatches`), so a rank's share of a
  microbatch is what it would hold on the smaller mesh.  The
  reference's partitioner lays such a microbatch over part of the ranks
  instead; the mean loss is the same, the MoE's load-balance statistics
  and token groups span the merged rows;
* the forward takes each layer's weights at use (``models/model.py``,
  ``layers.block_params``): the zero modes gather them whole; megatron
  gathers them over ``data`` and moves each block product's leaf to its
  compute split over ``model`` (tensor parallelism, as GSPMD splits the
  reference's products by the weights' specs: attention by heads, the
  MLPs by d_ff, the MoE by experts, the tables and the loss's logits by
  vocabulary).  The loss is the global mean, the MoE's load-balance
  statistics global;
* the gradient rule: a leaf's gradient is the sum of the per-rank
  gradients over the ranks that computed distinct activation slices
  (megatron: over ``data``; the zero modes: over every rank), each rank
  keeping its block of that sum.  A gather's backward is the
  reduce-scatter over those axes; a leaf not sharded over one of them is
  all-reduced over it after the backward.  Under megatron a leaf split
  over ``model`` for its products gets the gradient of the rank's own
  slice, brought back to its storage block by the adjoint of its
  re-layout, with no sum over ``model``; a replicated leaf used on
  replicated activations gets the same gradient on every model rank, the
  split products' replicated inputs summing their gradients over
  ``model`` (``collectives.all_reduce_grad``);
* AdamW on the local blocks, the clipping norm global; the metrics are
  the global ones on every rank.
"""

from __future__ import annotations

import gc
import math
from dataclasses import dataclass

import torch

from repro_torch import device as device_mod
from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives
from repro_torch.models import layers
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw
from repro_torch.train import sharding
from repro_torch.train.loss import chunked_ce_loss
from torch._subclasses.fake_tensor import FakeTensor


@dataclass(frozen=True)
class TrainConfig:
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    microbatches: int = 1
    loss_chunk: int = 512


def shift_targets(tokens: torch.Tensor):
    """Next-token prediction: inputs (B, S), targets (B, S), mask.

    Sequence length is kept at S (targets roll left; the final position is
    masked out) so attention chunking stays aligned to the padded shape.
    """
    targets = torch.roll(tokens, -1, dims=1)
    mask = torch.ones(targets.shape, dtype=torch.float32,
                      device=tokens.device)
    mask[:, -1] = 0.0
    return tokens, targets, mask


def loss_fn(cfg: ModelConfig, tcfg: TrainConfig, params, batch):
    """(ce + aux, {"ce", "aux"}) of a batch of tensors, with remat."""
    inputs, targets, mask = shift_targets(batch["tokens"])
    return _loss(cfg, tcfg, params, dict(batch, tokens=inputs), targets,
                 mask)


def _loss(cfg, tcfg, params, batch, targets, mask):
    hidden, aux = model_lib.forward(cfg, params, batch, remat=True)
    ce = chunked_ce_loss(cfg, params, hidden, targets, mask,
                         chunk=tcfg.loss_chunk)
    return ce + aux, {"ce": ce, "aux": aux}


def _grads(params, loss, metrics):
    flat = model_lib.leaves(params)
    grads = model_lib.unflatten(params, torch.autograd.grad(loss, flat))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _track(params) -> None:
    for p in model_lib.leaves(params):
        if not p.requires_grad:
            p.requires_grad_(True)


def grads_of(cfg: ModelConfig, tcfg: TrainConfig, params, batch):
    """(loss, metrics, gradient tree) of one batch."""
    _track(params)
    return _grads(params, *loss_fn(cfg, tcfg, params, batch))


def param_layout(cfg: ModelConfig, mesh, mode: str = "megatron"):
    """The storage specs of ``cfg``'s parameters over ``mesh`` in
    ``mode``, as the reference's launcher takes them (FSDP on; zero_batch
    stores as zero_seq)."""
    return sharding.param_specs(
        model_lib.param_shapes(cfg), mesh=mesh, fsdp=True,
        mode="zero_seq" if mode == "zero_batch" else mode)


def mesh_microbatches(microbatches: int, global_batch: int, mesh,
                      mode: str = "megatron") -> int:
    """The microbatches the mesh step runs: the largest divisor of
    ``microbatches`` whose microbatch rows split evenly over the ranks
    that hold distinct rows in ``mode`` (``microbatches`` itself where
    they already do)."""
    act = sharding.activation_spec(mesh, mode)
    rows = act[0] if act is not None else sharding.batch_axes(mesh)
    sizes = sharding.axis_sizes(mesh)
    ranks = math.prod(sizes[a] for a in sharding.entry_axes(rows))
    for n in range(microbatches, 0, -1):
        if microbatches % n == 0 and global_batch % n == 0 \
                and (global_batch // n) % ranks == 0:
            return n
    return microbatches


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, device=None, *,
                    mesh=None, mode: str = "megatron",
                    repeat_second: bool = False):
    """Returns train_step(params, opt_state, batch) -> (params', opt',
    metrics), on ``device`` (``cuda`` unless the CPU is asked for); the
    batch may hold numpy arrays, which are moved there.

    The global batch splits into ``tcfg.microbatches`` microbatches run in
    sequence with gradient accumulation: the live activation set is one
    microbatch.

    With ``mesh`` (a (data, model) ``DeviceMesh``) the step runs on this
    rank's blocks in ``mode`` (``megatron``, ``zero_seq`` or
    ``zero_batch``; see the module docstring): ``params`` and the state
    are the rank's blocks under :func:`param_layout`, ``batch`` the
    global batch.  ``repeat_second`` (the pod dry run's fake step, whose
    numbers are not read): the mesh step runs its first two microbatches
    only and counts each later one in ``collectives.tally`` as a repeat of
    the second, whose shapes and live set every later one has.
    """
    dev = device_mod.resolve(device)
    if mesh is not None:
        return _mesh_step(cfg, tcfg, dev, mesh, mode, repeat_second)

    def train_step(params, opt_state: adamw.AdamWState, batch):
        batch = model_lib.to_batch(batch, dev)
        n_mb = tcfg.microbatches
        if n_mb == 1:
            loss, metrics, grads = grads_of(cfg, tcfg, params, batch)
        else:
            mbs = [{k: v.reshape((n_mb, v.shape[0] // n_mb) + v.shape[1:])[i]
                    for k, v in batch.items()} for i in range(n_mb)]
            grads, loss, per_mb = None, torch.zeros((), device=dev), []
            for mb in mbs:
                l, m, g = grads_of(cfg, tcfg, params, mb)
                grads = g if grads is None else model_lib.map2(
                    torch.add, grads, g)
                loss = loss + l
                per_mb.append(m)
            grads = model_lib.map_tree(lambda g: g / n_mb, grads)
            loss = loss / n_mb
            metrics = {k: torch.stack([m[k] for m in per_mb]).mean()
                       for k in per_mb[0]}

        lr = adamw.cosine_schedule(opt_state.step, peak_lr=tcfg.peak_lr,
                                   warmup=tcfg.warmup, total=tcfg.total_steps)
        grad_norm = adamw.global_norm(grads)
        new_params, new_opt = adamw.update(
            params, grads, opt_state, lr=lr,
            weight_decay=tcfg.weight_decay, grad_clip=tcfg.grad_clip)
        return new_params, new_opt, {"loss": loss, "lr": lr,
                                     "grad_norm": grad_norm, **metrics}

    return train_step


def _mesh_step(cfg: ModelConfig, tcfg: TrainConfig, dev, mesh, mode: str,
               repeat_second: bool = False):
    pspecs = param_layout(cfg, mesh, mode)
    act = sharding.activation_spec(mesh, mode)
    names = mesh.mesh_dim_names
    sizes = sharding.axis_sizes(mesh)

    def split(spec):       # the axes that split each dim (size-1 ones do not)
        return [tuple(a for a in sharding.entry_axes(e) if sizes[a] > 1)
                for e in spec]

    def local_batch(mb):
        dspecs = sharding.data_specs(mb, mesh, mode)
        if split(dspecs["tokens"]) != split(layers.token_spec()):
            raise ValueError(
                f"{mode} on a {sizes} mesh: a microbatch of "
                f"{tuple(mb['tokens'].shape)} tokens does not split into "
                f"the layout {layers.token_spec()}")
        return {k: sharding.local_shard(v, dspecs[k], mesh)
                for k, v in mb.items()}

    def sync(grads):
        """Sum each leaf's gradient over the token axes it is not sharded
        over (the reduce-scatters summed the others); under the zero modes
        round the block weights' sums to the bf16 they were gathered in."""
        tok = layers.token_axes()
        wire = layers.block_dtype()
        for key in grads:
            for g, sp in zip(model_lib.leaves({key: grads[key]}),
                             model_lib.leaves({key: pspecs[key]})):
                axes = tuple(a for a in names
                             if a in tok and a not in sharding.spec_axes(sp))
                if axes and any(sizes[a] > 1 for a in axes):
                    collectives.all_reduce_sum(
                        g, sharding.group_of(mesh, axes), "grad")
                if wire is not None and key in model_lib.CAST_TREES:
                    g.copy_(g.to(wire))
        return grads

    def grads_fn(params, batch):
        """(loss, metrics, gradient blocks): the metrics global, each
        block the rank's block of the global gradient."""
        batch = model_lib.to_batch(batch, dev)
        n_mb = mesh_microbatches(tcfg.microbatches,
                                 batch["tokens"].shape[0], mesh, mode)
        with layers.mesh_hooks(act, pspecs, mesh):
            ranks = layers.token_ranks()

            def global_sum(x):
                return x if ranks == 1 else collectives.all_reduce_sum(
                    x.clone(), layers.token_group(), "metric")

            inputs, targets, mask = shift_targets(batch["tokens"])
            full = dict(batch, tokens=inputs, targets=targets, mask=mask)
            _track(params)
            grads, loss, per_mb = None, torch.zeros((), device=dev), []
            fake = isinstance(inputs, FakeTensor)
            for i in range(min(n_mb, 2) if repeat_second else n_mb):
                if fake:
                    # the dry run: the last microbatch's cyclic garbage
                    # freed, so that the peak is the live tensors' and
                    # every microbatch after the first starts alike
                    gc.collect()
                mb = local_batch({k: v.reshape(
                    (n_mb, v.shape[0] // n_mb) + v.shape[1:])[i]
                    for k, v in full.items()})
                targets_mb, mask_mb = mb.pop("targets"), mb.pop("mask")
                with collectives.repeated(n_mb - 1 if repeat_second
                                          and i == 1 else 1):
                    _, m, g = _grads(params, *_loss(cfg, tcfg, params, mb,
                                                    targets_mb, mask_mb))
                    m = {"ce": global_sum(m["ce"]), "aux": m["aux"]}
                grads = g if grads is None else model_lib.map2(
                    torch.add, grads, g)
                del g       # not alive through the next microbatch
                loss = loss + (m["ce"] + m["aux"])
                per_mb.append(m)
            if n_mb == 1:
                loss, metrics = per_mb[0]["ce"] + per_mb[0]["aux"], per_mb[0]
            else:
                grads = model_lib.map_tree(lambda g: g / n_mb, grads)
                loss = loss / n_mb
                metrics = {k: torch.stack([m[k] for m in per_mb]).mean()
                           for k in per_mb[0]}
            return loss, metrics, sync(grads)

    def train_step(params, opt_state: adamw.AdamWState, batch):
        loss, metrics, grads = grads_fn(params, batch)
        lr = adamw.cosine_schedule(opt_state.step, peak_lr=tcfg.peak_lr,
                                   warmup=tcfg.warmup, total=tcfg.total_steps)
        grad_norm = adamw.global_norm(grads, specs=pspecs, mesh=mesh)
        new_params, new_opt = adamw.update(
            params, grads, opt_state, lr=lr, weight_decay=tcfg.weight_decay,
            grad_clip=tcfg.grad_clip, specs=pspecs, mesh=mesh)
        return new_params, new_opt, {"loss": loss, "lr": lr,
                                     "grad_norm": grad_norm, **metrics}

    return train_step
