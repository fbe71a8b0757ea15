"""The training step: microbatched gradient accumulation, remat, mixed
precision, AdamW (port of ``repro.train.train_step``).

Gradients come from autograd over the parameter tree's leaves; the
microbatches run in a Python loop and their gradients are summed and
averaged as the reference's scan averages them.  The step updates the
parameters and the optimizer state in place (:func:`repro_torch.optim.
adamw.update`) and returns them with the metrics ``loss``, ``lr``,
``grad_norm``, ``ce`` and ``aux`` (device scalars; reading one syncs).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch import device as device_mod
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw
from repro_torch.train.loss import chunked_ce_loss


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
    hidden, aux = model_lib.forward(cfg, params, dict(batch, tokens=inputs),
                                    remat=True)
    ce = chunked_ce_loss(cfg, params, hidden, targets, mask,
                         chunk=tcfg.loss_chunk)
    return ce + aux, {"ce": ce, "aux": aux}


def grads_of(cfg: ModelConfig, tcfg: TrainConfig, params, batch):
    """(loss, metrics, gradient tree) of one batch."""
    flat = model_lib.leaves(params)
    for p in flat:
        if not p.requires_grad:
            p.requires_grad_(True)
    loss, metrics = loss_fn(cfg, tcfg, params, batch)
    grads = model_lib.unflatten(params, torch.autograd.grad(loss, flat))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, device=None):
    """Returns train_step(params, opt_state, batch) -> (params', opt',
    metrics), on ``device`` (``cuda`` unless the CPU is asked for); the
    batch may hold numpy arrays, which are moved there.

    The global batch splits into ``tcfg.microbatches`` microbatches run in
    sequence with gradient accumulation: the live activation set is one
    microbatch.
    """
    dev = device_mod.resolve(device)

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
