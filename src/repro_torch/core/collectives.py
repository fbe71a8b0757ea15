"""The collectives of the mesh programs over ``torch.distributed`` process
groups: a SUM ``all_reduce`` in place and an ``all_gather`` in rank order
(the mesh round), and, for the LM side over a mesh, bucketed all-gathers
of several tensors along their dims (:func:`gather_leaves`, whose
backward is the reduce-scatter), a SUM all-reduce of a value counted once
(:func:`all_reduce_value`) and an ``all_to_all`` of equal chunks along
dim 0 (:func:`all_to_all`), each differentiable, its backward the adjoint
collective.  Megatron's tensor-parallel products add the conjugate of
``all_reduce_value`` (:func:`all_reduce_grad`: the identity forward, a SUM
all-reduce of the gradient backward, on the replicated input of a product
split over the group), a differentiable re-layout of a tensor from a split
along one dim to a split along another (:func:`relayout`, one
``all_to_all`` with uneven splits; the split it goes to may give a slice
to several ranks, whose gradients it sums backward), the gather of such
slices into the whole (:func:`gather_ranges`) and a MAX all-reduce.

Each call runs inside a ``torch.profiler.record_function`` range named
``"<op> <what> (<bytes> B)"``, ``bytes`` being this rank's input, so a
profiler trace shows what each collective moved and how long it took;
with no profiler running the range costs the host a few microseconds.
Over a group of one rank the LM side's collectives are the identity and
are not called.  :func:`tally` counts the same calls without a profiler:
inside it every collective adds its calls, its input bytes and its output
bytes on this rank to its kind (``all_gather``, ``reduce_scatter``,
``all_reduce``, ``all_to_all``); with no tally open the count is one test
of an empty list.  Inside :func:`repeated` each call counts as several
(the dry run's microbatches that repeat one run's shapes).

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
_WEIGHT = [1]   # how many times a call counts in the open tallies

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
    keys them by ``"<kind> <what>"``, the ranges' names; ``by="group"`` by
    ``"<kind> <what> @<the group's global ranks>"``."""
    counts: dict = {}
    entry = (by, counts)
    _TALLIES.append(entry)
    try:
        yield counts
    finally:
        del _TALLIES[next(i for i, e in enumerate(_TALLIES) if e is entry)]


@contextlib.contextmanager
def repeated(times: int):
    """Count every collective of the ``with`` body ``times`` times in the
    open tallies."""
    _WEIGHT.append(_WEIGHT[-1] * times)
    try:
        yield
    finally:
        _WEIGHT.pop()


def _span(op: str, what: str, x: torch.Tensor, group,
          out_bytes: int | None = None) -> str:
    nbytes = x.numel() * x.element_size()
    if _TALLIES:
        w = _WEIGHT[-1]
        out = int(nbytes * _OUT[op](group_size(group))) \
            if out_bytes is None else out_bytes
        for by, counts in _TALLIES:
            key = op if by == "kind" else f"{op} {what}"
            if by == "group":
                key += f" @{tuple(dist.get_process_group_ranks(group))}"
            c = counts.setdefault(key, {"calls": 0, "bytes": 0,
                                        "out_bytes": 0})
            c["calls"] += w
            c["bytes"] += nbytes * w
            c["out_bytes"] += out * w
    return f"{op} {what} ({nbytes} B)"


def group_size(group) -> int:
    return dist.get_world_size(group)


def all_reduce_sum(x: torch.Tensor, group, what: str = "") -> torch.Tensor:
    """Sum ``x`` over the ranks of ``group`` in place and return it: the
    callers pass a fresh contiguous tensor (a product or a column sum)."""
    with record_function(_span("all_reduce", what, x, group)):
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_reduce_max(x: torch.Tensor, group, what: str = "") -> torch.Tensor:
    """The elementwise largest ``x`` over the ranks of ``group``, in place
    (not differentiable)."""
    with record_function(_span("all_reduce", what, x, group)):
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
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


class _AllReduceGrad(torch.autograd.Function):
    """Megatron's "f": the identity forward; backward the SUM all-reduce of
    the gradient over the group.  On a replicated tensor that each rank
    uses in its own slice of a product: each rank's gradient is then the
    sum of every slice's."""

    @staticmethod
    def forward(ctx, x, group, what):
        ctx.group, ctx.what = group, what
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.clone(memory_format=torch.contiguous_format),
                              ctx.group, ctx.what + " grad"), None, None


def all_reduce_grad(x: torch.Tensor, group, what: str = "") -> torch.Tensor:
    """The identity, its backward the SUM all-reduce over ``group`` (see
    ``_AllReduceGrad``)."""
    if group_size(group) == 1:
        return x
    return _AllReduceGrad.apply(x, group, what)


def _partition(ranges: list, n: int) -> bool:
    """Whether ``ranges`` cut [0, n) into consecutive pieces in order."""
    at = 0
    for lo, hi in ranges:
        if lo != at:
            return False
        at = hi
    return at == n


def one_each(ranges) -> list:
    """Parts of one range a rank, as :func:`relayout` and
    :func:`gather_ranges` take them."""
    return [((lo, hi),) for lo, hi in ranges]


def span_len(sp) -> int:
    """The positions a part (a tuple of ranges) holds."""
    return sum(hi - lo for lo, hi in sp)


def _meet(have: tuple, want: tuple) -> list:
    """The global ranges of ``want`` that ``have`` holds, in ``want``'s
    order (then ``have``'s)."""
    out = []
    for wlo, whi in want:
        for hlo, hhi in have:
            lo, hi = max(wlo, hlo), min(whi, hhi)
            if hi > lo:
                out.append((lo, hi))
    return out


def _local(ranges: list, sp: tuple) -> list:
    """Global ``ranges``, each inside one range of ``sp``, as positions in
    the concatenation of ``sp``'s ranges."""
    out = []
    for lo, hi in ranges:
        at = 0
        for slo, shi in sp:
            if slo <= lo and hi <= shi:
                out.append((at + lo - slo, at + hi - slo))
                break
            at += shi - slo
    return out


def _take(x: torch.Tensor, dim: int, ranges: list) -> torch.Tensor:
    """``x``'s positions ``ranges`` along ``dim``, concatenated."""
    parts = [x.narrow(dim, lo, hi - lo) for lo, hi in ranges]
    if len(parts) == 1:
        return parts[0]
    return torch.cat(parts, dim) if parts else x.narrow(dim, 0, 0)


def _place(parts: list, dim: int, where: list, full: int) -> torch.Tensor:
    """The tensor of ``full`` positions along ``dim`` whose positions
    ``where[i]`` (ranges) hold ``parts[i]``'s, concatenated: the parts
    concatenated where their ranges cut [0, full) in order, else summed
    into zeros part by part (a position several parts hold)."""
    if _partition([r for w in where for r in w], full):
        return torch.cat(parts, dim)
    shape = list(parts[0].shape)
    shape[dim] = full
    acc = parts[0].new_zeros(shape)
    for p, w in zip(parts, where):
        at = 0
        for lo, hi in w:
            acc.narrow(dim, lo, hi - lo).add_(p.narrow(dim, at, hi - lo))
            at += hi - lo
    return acc


def _exchange(x: torch.Tensor, have: tuple, want: tuple, full: int, group,
              what: str) -> torch.Tensor:
    """One ``all_to_all_single``.  ``have`` = (dim, each rank's spans):
    the global positions along dim that each rank's ``x`` holds, in order;
    ``want`` = (dim', each rank's spans): the positions along dim' each
    rank is to get, in order.  Where dim' is another dim (``x`` whole
    along it), rank j gets every rank's block narrowed to its spans along
    dim', put together along dim (``full`` positions); where it is the
    same dim, rank j gets the positions of its spans that each rank
    holds.  A position several ranks send is summed."""
    n, me = group_size(group), dist.get_rank(group)
    (hd, hs), (wd, ws) = have, want
    if hd != wd:
        pieces = [_take(x, wd, list(ws[j])) for j in range(n)]
        lens = [span_len(hs[i]) for i in range(n)]
        where, at, size = [hs[i] for i in range(n)], hd, full
    else:
        pieces = [_take(x, hd, _local(_meet(hs[me], ws[j]), hs[me]))
                  for j in range(n)]
        meets = [_meet(hs[i], ws[me]) for i in range(n)]
        lens = [span_len(m) for m in meets]
        where, at, size = [_local(m, ws[me]) for m in meets], hd, \
            span_len(ws[me])
    shapes = []
    for i in range(n):
        s = list(x.shape)
        s[wd] = span_len(ws[me])
        s[hd] = lens[i]
        shapes.append(s)
    buf = torch.cat([p.reshape(-1) for p in pieces])
    splits_in = [p.numel() for p in pieces]
    del pieces
    splits_out = [math.prod(s) for s in shapes]
    out = buf.new_empty((sum(splits_out),))
    with record_function(_span("all_to_all", what, buf, group,
                               out.numel() * out.element_size())):
        dist.all_to_all_single(out, buf, splits_out, splits_in, group=group)
    del buf
    parts = [t.reshape(s) for t, s in zip(out.split(splits_out), shapes)]
    return _place(parts, at, where, size)


class _Relayout(torch.autograd.Function):
    """:func:`relayout`; backward the same exchange the other way, the
    gradients of a position several ranks held summed."""

    @staticmethod
    def forward(ctx, x, group, what, src, dst):
        ctx.group, ctx.what, ctx.src, ctx.dst = group, what, src, dst
        ctx.full = x.shape[dst[0]]
        full = max((hi for sp in src[1] for _, hi in sp), default=0)
        return _exchange(x, src, dst, full, group, what)

    @staticmethod
    def backward(ctx, g):
        return (_exchange(g.contiguous(), ctx.dst, ctx.src, ctx.full,
                          ctx.group, ctx.what + " grad"),
                None, None, None, None)


def relayout(x: torch.Tensor, group, src: tuple, dst: tuple,
             what: str = "") -> torch.Tensor:
    """``x`` moved from one split over ``group`` to another: ``src`` =
    (dim, parts) says which positions of ``dim`` each rank's ``x`` holds
    (a part a rank, in rank order: a tuple of ranges (lo, hi), concatenated,
    :func:`one_each` where a rank holds one; the parts cutting the dim;
    ``x`` whole along the other dims), ``dst``
    = (dim', parts') which positions of ``dim'`` each rank is to hold, in
    the order of its ranges (they may overlap other ranks' or be empty;
    the result whole along ``dim`` where dim' is another dim).  One
    ``all_to_all`` with uneven splits: a rank sends each peer the
    positions of its block that peer is to hold and receives its own from
    every peer.  Differentiable: backward the exchange the other way, the
    gradients of a position several ranks held summed."""
    if group_size(group) == 1:
        return x
    return _Relayout.apply(x, group, what,
                           (src[0], tuple(tuple(p) for p in src[1])),
                           (dst[0], tuple(tuple(p) for p in dst[1])))


def owned(ranges: list) -> list:
    """The ranges cut so that each index lies in the first range that
    holds it (ranges sorted by their start, covering [0, n))."""
    out, at = [], 0
    for lo, hi in ranges:
        lo2 = max(lo, at)
        hi2 = max(hi, lo2)
        out.append((lo2, hi2))
        at = hi2
    return out


@torch.no_grad()
def gather_ranges(xs: list, group, what: str = "") -> list:
    """The wholes of tensors split over ``group`` as ``relayout``'s result
    is: ``xs`` = [(x, dim, parts)], rank r holding ``parts[r]`` of ``dim``
    (a tuple of ranges, concatenated, as :func:`relayout` takes it;
    together covering the dim, possibly overlapping); one ``all_gather``
    of every tensor's block, padded to the longest part; a position
    several ranks held is taken from the first."""
    if not xs or group_size(group) == 1:
        return [x for x, _, _ in xs]
    flat, shapes = [], []
    for x, dim, parts in xs:
        longest = max(span_len(sp) for sp in parts)
        pad = list(x.shape)
        pad[dim] = longest - x.shape[dim]
        shapes.append(x.shape[:dim] + (longest,) + x.shape[dim + 1:])
        flat.append(torch.cat([x, x.new_zeros(pad)], dim).reshape(-1))
    got = all_gather(torch.cat(flat), group, what)
    out = []
    at = 0
    for (x, dim, parts), shape in zip(xs, shapes):
        size = math.prod(shape)
        whole = list(shape)
        whole[dim] = max(hi for sp in parts for _, hi in sp)
        acc = x.new_zeros(whole)
        for p, sp in reversed(list(zip(got, parts))):  # the first one wins
            blk = p[at:at + size].reshape(shape)
            pos = 0
            for lo, hi in sp:
                acc.narrow(dim, lo, hi - lo).copy_(blk.narrow(dim, pos,
                                                              hi - lo))
                pos += hi - lo
        out.append(acc)
        at += size
    return out
