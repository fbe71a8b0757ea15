"""AdamW + LR schedules on trees of tensors (port of
``repro.optim.adamw``).

The optimizer state mirrors the parameter tree (m, v per leaf) beside a
step counter, the reference's ``(step, m, v)``, so a checkpoint stores it
under the reference's names.  :func:`update` works in place, leaf by
leaf, with the reference's arithmetic: it writes the new parameters and
moments into the given tensors and returns them, so a step holds one copy
of the state (a 16-byte-a-parameter step: weights, gradients, m, v).

Over a mesh each rank holds its blocks of the parameters, the gradients
and the moments under the parameters' storage specs
(:mod:`repro_torch.train.sharding`): the update is elementwise, so it runs
on the local blocks as they are, and only the clipping's global norm
needs the other ranks (:func:`global_norm` with ``specs`` and ``mesh``).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.models.model import leaves, map_tree


class AdamWState(NamedTuple):
    step: torch.Tensor      # () int32
    m: Any
    v: Any


def init(params) -> AdamWState:
    some = leaves(params)[0]
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=some.device),
                      m=map_tree(lambda p: torch.zeros_like(
                          p, memory_format=torch.contiguous_format), params),
                      v=map_tree(lambda p: torch.zeros_like(
                          p, memory_format=torch.contiguous_format), params))


@torch.no_grad()
def update(params, grads, state: AdamWState, *, lr: torch.Tensor | float,
           b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
           weight_decay: float = 0.1, grad_clip: float = 1.0,
           specs=None, mesh=None):
    """One AdamW step with global-norm gradient clipping, in place;
    returns (params, state).  ``grads`` is a tree like ``params``; on a
    mesh, local blocks under ``specs``."""
    g_leaves = leaves(grads)
    if grad_clip:
        gnorm = global_norm(grads, specs=specs, mesh=mesh)
        scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
        g_leaves = [g * scale for g in g_leaves]

    step = state.step + 1
    b1c = 1.0 - b1 ** step.float()
    b2c = 1.0 - b2 ** step.float()
    for p, m, v, g in zip(leaves(params), leaves(state.m), leaves(state.v),
                          g_leaves):
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g.square() * (1 - b2))
        upd = (m / b1c) / (torch.sqrt(v / b2c) + eps)
        # decoupled weight decay on matrices only (norms/biases excluded by
        # dimensionality — the standard heuristic)
        wd = weight_decay if p.ndim >= 2 else 0.0
        p.sub_(lr * (upd + wd * p))
    return params, AdamWState(step=step, m=state.m, v=state.v)


def global_norm(tree, *, specs=None, mesh=None) -> torch.Tensor:
    """The L2 norm of every leaf together.  With ``specs`` and ``mesh``,
    of the full tree from the ranks' blocks: each rank's sum of squares
    of the blocks it owns, summed over the job.  A leaf replicated along
    an axis (not named in its spec) is counted by the rank at coordinate
    0 of that axis only, so that each element counts once."""
    if mesh is None:
        return torch.sqrt(sum(x.float().square().sum()
                              for x in leaves(tree)))
    from repro_torch.core import collectives
    from repro_torch.train import sharding

    names = mesh.mesh_dim_names
    owned = [x for x, sp in zip(leaves(tree), leaves(specs))
             if all(mesh.get_local_rank(a) == 0
                    for a in names if a not in sharding.spec_axes(sp))]
    some = leaves(tree)[0]
    total = sum((x.float().square().sum() for x in owned),
                torch.zeros((), dtype=torch.float32, device=some.device))
    if mesh.size() > 1:
        import torch.distributed as dist
        total = collectives.all_reduce_sum(total, dist.group.WORLD,
                                           "grad norm")
    return torch.sqrt(total)


def cosine_schedule(step: torch.Tensor, *, peak_lr: float, warmup: int,
                    total: int, min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_ratio``·peak."""
    stepf = step.float()
    warm = stepf / max(warmup, 1)
    prog = torch.clamp((stepf - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return peak_lr * torch.where(stepf < warmup, warm, cos)
