"""The collectives of the mesh round over ``torch.distributed`` process
groups: a SUM ``all_reduce`` in place and an ``all_gather`` in rank order.

Each call runs inside a ``torch.profiler.record_function`` range named
``"<op> <what> (<bytes> B)"``, ``bytes`` being this rank's input, so a
profiler trace shows what each collective moved and how long it took;
with no profiler running the range costs the host a few microseconds.

Gloo runs these collectives on CUDA tensors as well as on CPU ones (the
several processes of a mesh on one card use it, since NCCL refuses two
ranks on one device); NCCL on CUDA tensors only.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.profiler import record_function


def _span(op: str, what: str, x: torch.Tensor) -> str:
    return f"{op} {what} ({x.numel() * x.element_size()} B)"


def all_reduce_sum(x: torch.Tensor, group, what: str = "") -> torch.Tensor:
    """Sum ``x`` over the ranks of ``group`` in place and return it: the
    callers pass a fresh contiguous tensor (a product or a column sum)."""
    with record_function(_span("all_reduce", what, x)):
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_gather(x: torch.Tensor, group, what: str = "") -> list[torch.Tensor]:
    """Every rank's ``x`` in the group's rank order (``x`` has the same
    shape on every rank)."""
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    with record_function(_span("all_gather", what, x)):
        dist.all_gather(out, x, group=group)
    return out
