"""Workload specifications for every (architecture × input shape) pair on a
mesh (port of ``repro.launch.specs``).

:func:`make_lowering_spec` builds what one rank runs for a workload: a
:class:`WorkloadSpec` holding the step (the mesh train step, a served
prefill or one served decode step), the rank's arguments (its parameter
and optimiser blocks, its batch, its cache blocks) and their specs, after
the reference's mode logic:

* the activation mode is the asked one for train and prefill, megatron for
  decode, then ``resolve_mode`` (zero_batch needs the batch to divide the
  mesh, else zero_seq; zero_seq the sequence the model axis, else
  megatron);
* an MoE's ``moe_groups`` is the mesh size under zero_batch (one token
  group a rank) and the global batch under zero_seq (a group a row);
* the parameters are stored in zero_seq's layout when the activations run
  zero_batch, with FSDP over ``data`` for train only;
* prefill and decode take the serve layout: bf16 weights over ``model``
  (``param_specs(fsdp=False)``) re-laid once into their compute split
  (``model.serve_params``, while the spec is built), caches under
  ``cache_specs``.

The arguments are built with ``torch.zeros`` of the rank's block shapes
(``sharding.local_shape``); under ``FakeTensorMode`` (``launch/dryrun.py``)
that allocates nothing.  Where the reference hands the train step its
global batch sharded, the port's mesh step takes the global batch on every
rank and cuts its own rows (``train/train_step.py``); prefill and decode
take the rank's rows.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from repro_torch import device as device_mod
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import layers
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw
from repro_torch.train import sharding as sh
from repro_torch.train.train_step import (TrainConfig, make_train_step,
                                          mesh_microbatches, param_layout)

# Per-shape config overrides (DESIGN.md §4): zamba2's shared attention is
# windowed at the long-context shape.
SHAPE_OVERRIDES: dict[tuple[str, str], dict[str, Any]] = {
    ("zamba2-2.7b", "long_500k"): {"sliding_window": 4096},
}


def default_microbatches(cfg: ModelConfig) -> int:
    """Microbatch counts for the train shape, keyed by parameter scale (the
    reference's; DESIGN.md §5)."""
    n = cfg.param_count()
    if n >= 40e9:
        return 16
    if n >= 10e9:
        return 8
    if n >= 2e9:
        return 4
    return 1


def skip_reason(cfg: ModelConfig, shape: InputShape) -> str | None:
    """Returns a reason string when this (arch, shape) pair is skipped."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return ("pure full-attention architecture: 500k-token decode is not "
                "sub-quadratic/bounded-state (DESIGN.md §4 skip list)")
    return None


def apply_overrides(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    over = SHAPE_OVERRIDES.get((cfg.name, shape.name))
    return cfg.replace(**over) if over else cfg


def batch_template(cfg: ModelConfig, shape: InputShape) -> dict:
    """Meta tensors (shapes and dtypes) of the data batch of a train or
    prefill shape."""
    b, s = shape.global_batch, shape.seq_len
    meta = torch.device("meta")
    batch = {"tokens": torch.empty((b, s), dtype=torch.int32, device=meta)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.empty(
            (b, cfg.n_patches, cfg.vision_dim), dtype=torch.bfloat16,
            device=meta)
    if cfg.family == "audio":
        batch["frames"] = torch.empty((b, cfg.n_frames, cfg.d_model),
                                      dtype=torch.bfloat16, device=meta)
    return batch


@dataclass
class WorkloadSpec:
    """What one rank runs for one workload: ``step(*args)``."""
    kind: str                  # train | prefill | decode
    step: Callable
    args: tuple                # the rank's arguments
    specs: tuple               # their specs (None: the whole of it)
    cfg: ModelConfig           # after the shape's overrides and moe_groups
    act_mode: str              # the activation mode after resolve_mode
    microbatches: int = 1      # the reference's count (the analytic model's)
    info: dict = field(default_factory=dict)   # microbatches_run: the
    # count the mesh step runs (``train_step.mesh_microbatches``)

    def run(self):
        return self.step(*self.args)

    def resident_bytes(self) -> dict[str, int]:
        """The bytes of the rank's arguments that stay resident across
        steps, by kind: the parameter blocks, the optimiser's and the
        cache's (the batch is transient)."""
        names = {"train": ("params", "opt", None),
                 "prefill": ("params", None),
                 "decode": ("params", "cache", None)}[self.kind]
        out: dict[str, int] = {}
        for name, arg in zip(names, self.args):
            if name is not None:
                out[name] = _tree_bytes(arg)
        return out


def _tree_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, adamw.AdamWState):
        return sum(_tree_bytes(x) for x in tree)
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return 0


def _blocks(shapes, specs, mesh, dev, dtype=None):
    """Zeros of the rank's block of each leaf of ``shapes`` under
    ``specs`` (``dtype``: in place of float32 leaves' own)."""
    def block(path, leaf):
        dt = dtype if dtype is not None and leaf.dtype == torch.float32 \
            else leaf.dtype
        return torch.zeros(sh.local_shape(leaf.shape,
                                          model_lib.specs_at(specs, path),
                                          mesh), dtype=dt, device=dev)
    return sh.map_with_path(block, shapes)


def make_lowering_spec(cfg: ModelConfig, shape: InputShape, mesh, *,
                       microbatches: int | None = None,
                       tcfg: TrainConfig | None = None,
                       mode: str = "megatron", device=None,
                       repeat_second: bool = False) -> WorkloadSpec:
    """The rank's :class:`WorkloadSpec` of ``cfg`` at ``shape`` on
    ``mesh`` (a ``DeviceMesh``) in ``mode``, its arguments on ``device``
    (``cuda`` unless the CPU is asked for).  ``repeat_second``: the train
    step runs two microbatches and counts the later ones as repeats of the
    second (``make_train_step``; the dry run)."""
    dev = device_mod.resolve(device)
    cfg = apply_overrides(cfg, shape)
    act_mode = mode if shape.kind in ("train", "prefill") else "megatron"
    act_mode = sh.resolve_mode(mesh, act_mode, shape.global_batch,
                               shape.seq_len)
    if act_mode == "zero_batch" and cfg.n_experts:
        # one token group a rank: the sort stays local and only the
        # expert all-to-all crosses ranks
        cfg = cfg.replace(moe_groups=math.prod(sh.axis_sizes(mesh).values()))
    elif act_mode == "zero_seq" and cfg.n_experts:
        # a group a (pod, data) batch row
        cfg = cfg.replace(moe_groups=int(shape.global_batch))
    shapes = model_lib.param_shapes(cfg)

    if shape.kind == "train":
        mb = microbatches or (1 if act_mode != "megatron"
                              else default_microbatches(cfg))
        tcfg = tcfg or TrainConfig(microbatches=mb)
        pspecs = param_layout(cfg, mesh, act_mode)
        params = _blocks(shapes, pspecs, mesh, dev)
        opt = adamw.AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            m=_blocks(shapes, pspecs, mesh, dev),
            v=_blocks(shapes, pspecs, mesh, dev))
        batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
                 for k, v in batch_template(cfg, shape).items()}
        step = make_train_step(cfg, tcfg, dev, mesh=mesh, mode=act_mode,
                               repeat_second=repeat_second)
        run = mesh_microbatches(tcfg.microbatches, shape.global_batch, mesh,
                                act_mode)
        return WorkloadSpec(
            kind="train", step=step, args=(params, opt, batch),
            specs=(pspecs, adamw.AdamWState(step=sh.P(), m=pspecs,
                                            v=pspecs), None),
            cfg=cfg, act_mode=act_mode, microbatches=tcfg.microbatches,
            info={"microbatches_run": run})

    # Inference: bf16 serve weights over ``model``, replicated over the
    # batch axes.
    serve_specs = model_lib.serve_param_specs(cfg, mesh)
    params = model_lib.serve_params(
        cfg, _blocks(shapes, serve_specs, mesh, dev, torch.bfloat16), mesh)
    b, s = shape.global_batch, shape.seq_len

    if shape.kind == "prefill":
        template = batch_template(cfg, shape)
        bspecs = sh.data_specs(template, mesh, act_mode)
        batch = _blocks(template, bspecs, mesh, dev)

        hooks = model_lib.serve_layout(cfg, mesh, batch=b, max_len=s,
                                       seq=s, mode=act_mode)

        def prefill_fn(params, batch):
            with layers.mesh_hooks(None, hooks[0], mesh, hooks[1]):
                return model_lib.prefill(cfg, params, batch, s)

        return WorkloadSpec(kind="prefill", step=prefill_fn,
                            args=(params, batch), specs=(serve_specs, bspecs),
                            cfg=cfg, act_mode=act_mode)

    # decode: one token a row against a cache of the shape's length
    cache = model_lib.init_cache(cfg, b, s, device=dev, mesh=mesh)
    cspecs = model_lib.cache_layout(cfg, mesh, b, s)
    tokens = torch.empty((b, 1), dtype=torch.int32, device="meta")
    tspec = sh.data_specs(tokens, mesh)
    tokens = torch.zeros(sh.local_shape(tokens.shape, tspec, mesh),
                         dtype=torch.int32, device=dev)

    hooks = model_lib.serve_layout(cfg, mesh, batch=b, max_len=s)

    def decode_fn(params, cache, tokens):
        with layers.mesh_hooks(None, hooks[0], mesh, hooks[1]):
            return model_lib.decode_step(cfg, params, cache, tokens)

    return WorkloadSpec(kind="decode", step=decode_fn,
                        args=(params, cache, tokens),
                        specs=(serve_specs, cspecs, tspec), cfg=cfg,
                        act_mode=act_mode)
