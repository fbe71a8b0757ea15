"""The collectives of the mesh programs over ``torch.distributed`` process
groups: a SUM ``all_reduce`` in place and an ``all_gather`` in rank order
(the mesh round), and, for the LM side over a mesh, bucketed all-gathers
of several tensors along their dims (:func:`gather_leaves`, whose
backward is the reduce-scatter), a SUM all-reduce of a value counted once
(:func:`all_reduce_value`) and an ``all_to_all`` of equal chunks along
dim 0 (:func:`all_to_all`), each differentiable, its backward the adjoint
collective.

Each call runs inside a ``torch.profiler.record_function`` range named
``"<op> <what> (<bytes> B)"``, ``bytes`` being this rank's input, so a
profiler trace shows what each collective moved and how long it took;
with no profiler running the range costs the host a few microseconds.
Over a group of one rank the LM side's collectives are the identity and
are not called.  :func:`tally` counts the same calls without a profiler:
inside it every collective adds its calls, its input bytes and its output
bytes on this rank to its kind (``all_gather``, ``reduce_scatter``,
``all_reduce``, ``all_to_all``); with no tally open the count is one test
of an empty list.

Gloo runs these collectives on CUDA tensors as well as on CPU ones (the
several processes of a mesh on one card use it, since NCCL refuses two
ranks on one device): ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_to_all_single`` and ``all_reduce``, in float32 and bfloat16, were
seen to run on an H100 under torch 2.11; NCCL on CUDA tensors only.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
from torch.profiler import record_function

# torch 2.13 renamed the single-tensor forms (the old names warn there).
_gather_into = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


_TALLIES: list = []

# A collective's output bytes on a rank over its input bytes, by kind and
# group size n.
_OUT = {"all_gather": lambda n: n, "reduce_scatter": lambda n: 1 / n,
        "all_reduce": lambda n: 1, "all_to_all": lambda n: 1}


@contextlib.contextmanager
def tally(by: str = "kind"):
    """Count the collectives this rank calls in the ``with`` body: yields
    ``{kind: {"calls", "bytes", "out_bytes"}}``, filled as they run
    (``bytes``: the rank's input, as the ranges name it; ``out_bytes``:
    its output, the measure XLA's collective shapes give); ``by="what"``
    keys them by ``"<kind> <what>"``, the ranges' names."""
    counts: dict = {}
    entry = (by, counts)
    _TALLIES.append(entry)
    try:
        yield counts
    finally:
        del _TALLIES[next(i for i, e in enumerate(_TALLIES) if e is entry)]


def _span(op: str, what: str, x: torch.Tensor, group) -> str:
    nbytes = x.numel() * x.element_size()
    if _TALLIES:
        out = int(nbytes * _OUT[op](group_size(group)))
        for by, counts in _TALLIES:
            key = op if by == "kind" else f"{op} {what}"
            c = counts.setdefault(key, {"calls": 0, "bytes": 0,
                                        "out_bytes": 0})
            c["calls"] += 1
            c["bytes"] += nbytes
            c["out_bytes"] += out
    return f"{op} {what} ({nbytes} B)"


def group_size(group) -> int:
    return dist.get_world_size(group)


def all_reduce_sum(x: torch.Tensor, group, what: str = "") -> torch.Tensor:
    """Sum ``x`` over the ranks of ``group`` in place and return it: the
    callers pass a fresh contiguous tensor (a product or a column sum)."""
    with record_function(_span("all_reduce", what, x, group)):
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_gather(x: torch.Tensor, group, what: str = "") -> list[torch.Tensor]:
    """Every rank's ``x`` in the group's rank order (``x`` has the same
    shape on every rank)."""
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    with record_function(_span("all_gather", what, x, group)):
        dist.all_gather(out, x, group=group)
    return out


def all_to_all_dim0(x: torch.Tensor, group, what: str = "") -> torch.Tensor:
    """``x`` split along dim 0 into as many equal chunks as ranks; chunk j
    goes to rank j, and the result's chunk j is what rank j sent here."""
    if group_size(group) == 1:
        return x
    src = x.contiguous()
    out = torch.empty_like(src)
    with record_function(_span("all_to_all", what, src, group)):
        dist.all_to_all_single(out, src, group=group)
    return out


def local_chunk(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's chunk of ``x`` split equally along ``dim`` over the
    group (no communication)."""
    n = group_size(group)
    if n == 1:
        return x
    return x.chunk(n, dim)[dist.get_rank(group)]


def _rows(xs: list, dims: list, n: int) -> torch.Tensor:
    """(n, ·): row r holds every tensor's r-th block along its dim."""
    return torch.cat([x.movedim(d, 0).reshape(n, -1)
                      for x, d in zip(xs, dims)], dim=1)


def _split(flat: torch.Tensor, shapes: list, dims: list) -> list:
    """Tensors of ``shapes`` (each with its dim first, as ``_rows`` laid
    them out) from a (k, ·) buffer, back in place."""
    out, at = [], 0
    for shape, d in zip(shapes, dims):
        moved = (shape[d],) + tuple(shape[:d]) + tuple(shape[d + 1:])
        c = math.prod(moved) // flat.shape[0]
        out.append(flat[:, at:at + c].reshape(moved).movedim(0, d))
        at += c
    return out


BUCKET_BYTES = 256 << 20    # a bucket's input at most (one leaf may exceed it)


def _buckets(idx: list, nbytes: list) -> list:
    """``idx`` cut, in order, into runs of at most BUCKET_BYTES."""
    out, run, size = [], [], 0
    for i, b in zip(idx, nbytes):
        if run and size + b > BUCKET_BYTES:
            out.append(run)
            run, size = [], 0
        run.append(i)
        size += b
    return out + [run] if run else out


class _GatherLeaves(torch.autograd.Function):
    """Several tensors' all-gathers, bucketed: for each stage (group,
    reduce, {index: dim}) one ``all_gather_into_tensor`` a bucket (at most
    BUCKET_BYTES of inputs) of the named tensors' blocks along their dims.
    The tensors move as ``wire`` (None: as they are) and come out rounded
    to it in their own dtype.  Backward, stage by stage in reverse, in
    the tensors' dtype: one reduce-scatter a bucket where ``reduce`` (the
    ranks computed distinct things), else each tensor's own chunk; the
    ranks' shares are summed unrounded (a caller that gathered in ``wire``
    rounds the sum once, after its last sum)."""

    @staticmethod
    def forward(ctx, stages, wire, what, *xs):
        ctx.stages, ctx.what, ctx.device = stages, what, xs[0].device
        ctx.dtypes = [x.dtype for x in xs]
        last = {i: k for k, (_, _, dims) in enumerate(stages) for i in dims}
        ys = [x.to(wire) if wire is not None else x for x in xs]
        ys = [y if i in last else y.to(dt)
              for i, (y, dt) in enumerate(zip(ys, ctx.dtypes))]
        ctx.shapes = []
        for k, (group, _, dims) in enumerate(stages):
            n = group_size(group)
            ctx.shapes.append({i: tuple(ys[i].shape) for i in dims})
            for run in _buckets(sorted(dims), [ys[i].numel()
                                               * ys[i].element_size()
                                               for i in sorted(dims)]):
                dl = [dims[i] for i in run]
                flat = _rows([ys[i] for i in run], dl, 1).reshape(-1)
                out = flat.new_empty((n * flat.numel(),))
                with record_function(_span("all_gather", what, flat,
                                           group)):
                    _gather_into(out, flat, group=group)
                del flat
                full = [ctx.shapes[k][i][:d] + (n * ctx.shapes[k][i][d],)
                        + ctx.shapes[k][i][d + 1:] for i, d in zip(run, dl)]
                # rank r's block of every tensor is row r of the bucket
                for i, y in zip(run, _split(out.reshape(n, -1), full, dl)):
                    ys[i] = y.to(ctx.dtypes[i]) if last[i] == k else \
                        y.contiguous()
                del out
        return tuple(ys)

    @staticmethod
    def backward(ctx, *gs):
        gs = list(gs)
        for (group, reduce, dims), shapes in zip(reversed(ctx.stages),
                                                 reversed(ctx.shapes)):
            n = group_size(group)
            for i, d in dims.items():
                if gs[i] is None:
                    s = shapes[i]
                    gs[i] = torch.zeros(s[:d] + (n * s[d],) + s[d + 1:],
                                        dtype=ctx.dtypes[i],
                                        device=ctx.device)
            if not reduce:
                r = dist.get_rank(group)
                for i, d in dims.items():
                    gs[i] = gs[i].chunk(n, d)[r]
                continue
            for run in _buckets(sorted(dims), [shapes[i] and math.prod(
                    shapes[i]) * 4 for i in sorted(dims)]):
                dl = [dims[i] for i in run]
                flat = _rows([gs[i].float() for i in run], dl,
                             n).reshape(-1)
                for i in run:
                    gs[i] = None
                out = flat.new_empty((flat.numel() // n,))
                with record_function(_span("reduce_scatter",
                                           ctx.what + " grad", flat,
                                           group)):
                    _reduce_scatter(out, flat, group=group)
                del flat
                for i, g in zip(run, _split(out.reshape(1, -1),
                                            [shapes[i] for i in run], dl)):
                    gs[i] = g.to(ctx.dtypes[i])
        return (None, None, None) + tuple(
            g.contiguous() if g is not None else None for g in gs)


def gather_leaves(xs: list, stages: list, wire=None,
                  what: str = "") -> list:
    """Differentiable bucketed gathers of ``xs`` (see ``_GatherLeaves``);
    ``stages``: [(group, reduce, {index into xs: dim})], in order.  Every
    tensor passed either takes part in a stage or changes dtype
    (``wire``)."""
    stages = [st for st in stages if group_size(st[0]) > 1]
    if not stages and wire is None:
        return list(xs)
    return list(_GatherLeaves.apply(tuple(stages), wire, what, *xs))


class _AllReduceValue(torch.autograd.Function):
    """A SUM all-reduce whose backward passes the gradient through: the
    sum is a value every rank holds once, counted once in the global
    loss, so each rank's share of its gradient is the gradient itself."""

    @staticmethod
    def forward(ctx, x, group, what):
        return all_reduce_sum(x.clone(), group, what)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def all_reduce_value(x: torch.Tensor, group, what: str = "") -> torch.Tensor:
    """Differentiable SUM all-reduce (see ``_AllReduceValue``)."""
    if group_size(group) == 1:
        return x
    return _AllReduceValue.apply(x, group, what)


class _AllToAll(torch.autograd.Function):
    """:func:`all_to_all_dim0`; it is its own adjoint (chunk j of rank i
    becomes chunk i of rank j), so backward sends the gradient back."""

    @staticmethod
    def forward(ctx, x, group, what):
        ctx.group, ctx.what = group, what
        return all_to_all_dim0(x, group, what)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_dim0(g, ctx.group, ctx.what + " grad"), None, None


def all_to_all(x: torch.Tensor, group, what: str = "") -> torch.Tensor:
    """Differentiable :func:`all_to_all_dim0`."""
    if group_size(group) == 1:
        return x
    return _AllToAll.apply(x, group, what)
