"""Token-type segmentation: the word-major sorted layout (port of
``repro.data.segment``).

A shard's (D, L) token grid is flattened and sorted by token-type with a
stable sort; masked positions get the sentinel row ``vocab_size`` and sort
last.  The stream is padded to a multiple of ``tile_b``, which fixes its
length ``Bp`` and so the shape of the uniform streams a chunk draws.

``vstart``/``vcount``/``hist``/``offsets`` and :func:`pick_tile_vmem` only
manage TPU VMEM in the reference (the scalar-prefetched vocab-tile skip).
The port computes them for field parity; no CUDA kernel reads them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SortedLayout(NamedTuple):
    """Sorted token stream for one shard (see the reference for the
    tile-skip fields).

    order: (B,)  int32 — flat position of the i-th sorted draw.
    rows:  (Bp,) int32 — token-type per sorted draw; ``vocab_size`` marks
           padding (masked positions and the Bp-B fill).
    docs:  (Bp,) int32 — document id per sorted draw (0 for padding).
    real:  (Bp,) bool  — True for genuine (unmasked) tokens.
    """

    order: torch.Tensor
    rows: torch.Tensor
    docs: torch.Tensor
    real: torch.Tensor
    vstart: torch.Tensor
    vcount: torch.Tensor
    hist: torch.Tensor
    offsets: torch.Tensor


def chunk_bounds(l: int, n_chunks: int) -> tuple[int, ...]:
    """Chunk c covers positions [bounds[c], bounds[c+1])."""
    return tuple(round(i * l / n_chunks) for i in range(n_chunks + 1))


def pick_tile(n: int, target: int) -> int:
    """Largest divisor of ``n`` that is ≤ ``target``."""
    for t in range(min(target, n), 0, -1):
        if n % t == 0:
            return t
    return 1


def pick_tile_vmem(v: int, k: int, budget_elems: int = 65536,
                   tile_k: int | None = None) -> int:
    """The reference's vocab tile size (kept so layouts match field for
    field; it sizes no CUDA kernel)."""
    cols = k if tile_k is None else min(tile_k, k)
    return pick_tile(v, max(1, budget_elems // max(cols, 1)))


def build_layout(tokens: torch.Tensor, mask: torch.Tensor, vocab_size: int,
                 *, tile_v: int, tile_b: int) -> SortedLayout:
    """Sort a shard's token stream by token-type.

    tokens: (D, L) int in [0, vocab_size); mask: (D, L) bool.
    """
    if vocab_size % tile_v:
        raise ValueError(f"vocab_size={vocab_size} is not a multiple of "
                         f"tile_v={tile_v}")
    d, l = tokens.shape
    b = d * l
    bp = -(-b // tile_b) * tile_b
    nv = vocab_size // tile_v
    dev = tokens.device

    w = tokens.reshape(-1).to(torch.int32)
    key_rows = torch.where(mask.reshape(-1), w,
                           torch.full_like(w, vocab_size))   # sentinel last
    order = torch.argsort(key_rows, stable=True).to(torch.int32)
    rows = key_rows[order.long()]
    docs = torch.div(order, l, rounding_mode="floor").to(torch.int32)
    pad = bp - b
    if pad:
        rows = torch.cat([rows, torch.full((pad,), vocab_size,
                                           dtype=torch.int32, device=dev)])
        docs = torch.cat([docs, torch.zeros(pad, dtype=torch.int32,
                                            device=dev)])
    real = rows < vocab_size

    rs = rows.reshape(bp // tile_b, tile_b)
    has_real = rs[:, 0] < vocab_size
    last_real = torch.where(rs < vocab_size, rs, -1).amax(dim=1)
    vstart = torch.where(has_real, rs[:, 0] // tile_v, 0).to(torch.int32)
    vend = torch.where(has_real, last_real // tile_v, -1)
    vcount = (vend - vstart + 1).to(torch.int32)

    tile_of = torch.where(real, rows // tile_v, nv).long()
    hist = torch.bincount(tile_of, minlength=nv + 1)[:nv].to(torch.int32)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                         torch.cumsum(hist, 0).to(torch.int32)])
    return SortedLayout(order=order, rows=rows, docs=docs, real=real,
                        vstart=vstart, vcount=vcount, hist=hist,
                        offsets=offsets)


def build_chunked_layouts(tokens: torch.Tensor, mask: torch.Tensor,
                          vocab_size: int, *, bounds: tuple[int, ...],
                          tile_v: int, tile_b: int
                          ) -> tuple[SortedLayout, ...]:
    """One layout per position-chunk; build once per shard and reuse."""
    d = tokens.shape[0]
    return tuple(
        build_layout(tokens[:, s:e], mask[:, s:e], vocab_size,
                     tile_v=tile_v, tile_b=min(tile_b, d * (e - s)))
        for s, e in zip(bounds[:-1], bounds[1:]))


def sort_values(layout: SortedLayout, flat: torch.Tensor,
                fill=0) -> torch.Tensor:
    """Arrange a flat (B,) per-position array into sorted order (Bp,)."""
    sorted_b = flat[layout.order.long()]
    pad = layout.rows.shape[0] - sorted_b.shape[0]
    if pad:
        sorted_b = torch.cat([sorted_b, torch.full(
            (pad,), fill, dtype=sorted_b.dtype, device=sorted_b.device)])
    return sorted_b


def unsort_values(layout: SortedLayout, sorted_vals: torch.Tensor,
                  like: torch.Tensor) -> torch.Tensor:
    """Invert :func:`sort_values` onto a copy of the flat template ``like``."""
    b = layout.order.shape[0]
    out = like.clone()
    out[layout.order.long()] = sorted_vals[:b]
    return out
