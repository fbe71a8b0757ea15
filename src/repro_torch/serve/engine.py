"""Fold-in serving engine: continuous batching of documents (port of
``repro.serve.engine``).

Online inference folds an unseen document into a frozen model: the
document gets its own assignments ``z`` and counts ``n_dk``, the shared
statistics stay read-only, and after ``n_sweeps`` local-only MHW sweeps
its topic proportions are harvested from ``n_dk``.  Nothing is pushed.

The engine packs live documents into a slot grid ``(max_slots,
max_len)`` and runs one token-sorted sweep over every live slot per
:meth:`FoldInEngine.step`: ``ModelFamily.sweep_sorted``, the training
path, so one launch of the document-list build and of kernel 1 (LDA,
HDP) or kernel 4 (PDP) per position chunk.  A document is admitted while
its batch-mates are mid-chain and harvested as soon as its own chain has
run ``n_sweeps`` sweeps.

**Determinism.** A document's chain is a pure function of (snapshot,
tokens, request seed), whoever shares its batches.  Its streams are
keyed as every stream of the port is (:mod:`repro_torch.device`): the
initial state from the root key ``(seed, SERVE)``, the uniforms of sweep
s and chunk c from ``fold_in(root, s, c)``, each drawn by
``ops._step_uniforms`` at the width of the document's own one-document
layout, then moved through its one-document sorted order into the
batched sorted order (empty slots and the batched padding get slot 0 and
uniforms 0.5).  :func:`reference_fold_in`, the family's ``sweep`` on a
one-document shard with its deltas dropped, draws the same numbers, so
the two agree bit for bit.  A :class:`Streams` object is the seam: the
parity tests pass one that draws the reference's JAX streams.

On the card the per-step path stays on the device: each slot keeps the
inverse of its one-document orders as device tensors made at
:meth:`~FoldInEngine.admit`, a change of the live set rebuilds one gather
index a chunk, and :meth:`~FoldInEngine.step` moves the streams with
torch indexing.  Only :meth:`~FoldInEngine.harvest` copies ``n_dk`` and
``z`` to the host; ``theta`` is computed there with numpy, as the
reference computes it, so the two packages' checksums compare.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Iterable, Sequence

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.data import segment
from repro_torch.kernels import ops
from repro_torch.serve.snapshot import InferenceSnapshot


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine knobs; ``n_sweeps`` is the fold-in chain length (the
    training-time evaluators use 10)."""

    max_slots: int = 8
    max_len: int = 256
    n_sweeps: int = 10


@dataclasses.dataclass(frozen=True)
class InferRequest:
    """One document to fold in; ``seed`` fixes its chain."""

    uid: int
    tokens: Sequence[int]
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class InferResult:
    uid: int
    theta: np.ndarray        # (K,) topic proportions
    assignments: np.ndarray  # (doc_len,) final topic per token
    n_sweeps: int


def root_key(seed: int) -> device_mod.Key:
    """The root of a request's streams."""
    return (int(seed), device_mod.SERVE)


class Streams:
    """A request's random numbers: its chain's initial state and the
    uniform streams of each (sweep, chunk).  This default draws the
    port's torch streams; a replacement with the same two methods (the
    parity tests pass the reference's) changes the numbers and nothing
    else."""

    def init_state(self, fam, cfg, tokens: torch.Tensor, mask: torch.Tensor,
                   seed: int):
        """Local state of a one-document (1, L) shard."""
        local, _ = fam.init_state(cfg, tokens, mask, root_key(seed))
        return local

    def uniforms(self, seed: int, sweep: int, chunk: int, n_outcomes: int,
                 mh_steps: int, width: int, device: torch.device
                 ) -> tuple[torch.Tensor, ...]:
        """(slot, coin, u_mix, u_sparse, u_acc), each (mh_steps, width),
        in the one-document sorted order of the chunk."""
        gen = device_mod.generator(
            device_mod.fold_in(root_key(seed), sweep, chunk), device)
        return ops._step_uniforms(gen, n_outcomes, mh_steps, width, device)


@dataclasses.dataclass
class _Slot:
    uid: int
    length: int
    seed: int
    age: int                       # completed sweeps
    # Per chunk: the inverse of the one-document sorted order (device
    # int64, position → sorted index) and that layout's padded width.
    inv: tuple[torch.Tensor, ...]
    widths: tuple[int, ...]


def _theta(prior: np.ndarray, n_dk_row: np.ndarray, length: int
           ) -> np.ndarray:
    """Posterior-mean topic proportions from a folded-in doc's counts."""
    return (n_dk_row + prior) / (float(length) + float(prior.sum()))


def result_checksum(res: InferResult) -> str:
    """Digest of one result (uid, assignments, theta), as the reference
    computes it."""
    h = hashlib.sha256()
    h.update(np.int64(res.uid).tobytes())
    h.update(np.ascontiguousarray(res.assignments, np.int32).tobytes())
    h.update(np.ascontiguousarray(res.theta, np.float32).tobytes())
    return h.hexdigest()


def _one_doc(toks: np.ndarray, max_len: int, dev: torch.device
             ) -> tuple[torch.Tensor, torch.Tensor]:
    row_tok = np.zeros((1, max_len), np.int32)
    row_tok[0, :toks.size] = toks
    row_mask = np.zeros((1, max_len), bool)
    row_mask[0, :toks.size] = True
    return (torch.as_tensor(row_tok, device=dev),
            torch.as_tensor(row_mask, device=dev))


def _check_device(snap: InferenceSnapshot, dev: torch.device) -> None:
    if snap.device.type != dev.type:
        raise ValueError(f"snapshot lies on {snap.device}, but the engine "
                         f"runs on {dev}")


class FoldInEngine:
    """Slot-based continuous batching of fold-in chains over one frozen
    snapshot, on ``cuda`` unless ``device="cpu"`` is passed."""

    def __init__(self, snap: InferenceSnapshot,
                 scfg: ServeConfig | None = None, *,
                 streams: Streams | None = None, device=None):
        self.device = device_mod.resolve(device)
        _check_device(snap, self.device)
        self.snap = snap
        self.scfg = scfg or ServeConfig()
        self.streams = streams or Streams()
        self.fam = snap.family
        self.cfg = snap.cfg
        s, l = self.scfg.max_slots, self.scfg.max_len
        self._tokens = torch.zeros((s, l), dtype=torch.int32,
                                   device=self.device)
        self._mask = torch.zeros((s, l), dtype=torch.bool, device=self.device)
        # Rows are rewritten at admit, so these values reach no result.
        self._local, _ = self.fam.init_state(self.cfg, self._tokens,
                                             self._mask, (0,))
        self._slots: list[_Slot | None] = [None] * s
        self._layouts = None      # batched chunk layouts; rebuilt on change
        self._gather = None       # per chunk: batched position → stream
        self._live: list[_Slot] = []
        self._prior = np.asarray(snap.topic_prior().cpu().numpy(),
                                 np.float32)
        n_chunks = max(1, min(self.cfg.sorted_chunks, l))
        self._bounds = segment.chunk_bounds(l, n_chunks)
        self._e_out = self.fam.n_outcomes(self.cfg)
        self.sweeps_run = 0
        self.docs_admitted = 0
        self.docs_harvested = 0

    # ------------------------------------------------------------ occupancy
    @property
    def live(self) -> int:
        return sum(s is not None for s in self._slots)

    def free_slots(self) -> int:
        return sum(s is None for s in self._slots)

    # --------------------------------------------------------------- admit
    def admit(self, req: InferRequest) -> bool:
        """Pack a request into a free slot; False when the grid is full.
        Raises ``ValueError`` for an empty document, one longer than
        ``max_len``, or token ids outside the vocabulary."""
        toks = np.asarray(req.tokens, np.int32).reshape(-1)
        if toks.size == 0:
            raise ValueError("empty document")
        if toks.size > self.scfg.max_len:
            raise ValueError(
                f"document has {toks.size} tokens, max_len is "
                f"{self.scfg.max_len}")
        if toks.min() < 0 or toks.max() >= self.cfg.vocab_size:
            raise ValueError("token id out of range for vocab_size "
                             f"{self.cfg.vocab_size}")
        try:
            j = self._slots.index(None)
        except ValueError:
            return False
        dev = self.device
        tok1, mask1 = _one_doc(toks, self.scfg.max_len, dev)
        local0 = self.streams.init_state(self.fam, self.cfg, tok1, mask1,
                                         int(req.seed))
        grid = self.fam.local_dict(self._local)
        for name, row in self.fam.local_dict(local0).items():
            grid[name][j] = row[0]
        self._tokens[j] = tok1[0]
        self._mask[j] = mask1[0]
        inv = []
        lays = self.fam.build_sorted_layouts(self.cfg, tok1, mask1)
        for lay in lays:
            order = lay.order.long()
            iv = torch.empty_like(order)
            iv[order] = torch.arange(order.numel(), device=dev)
            inv.append(iv)
        self._slots[j] = _Slot(
            uid=req.uid, length=int(toks.size), seed=int(req.seed), age=0,
            inv=tuple(inv), widths=tuple(int(la.rows.shape[0])
                                         for la in lays))
        self._layouts = None
        self.docs_admitted += 1
        return True

    # ------------------------------------------------------------ streams
    def _rebuild(self) -> None:
        """Batched layouts and, per chunk, the gather index that takes a
        batched sorted position to its column in the live slots' streams
        laid side by side (a last column holds the fill)."""
        dev = self.device
        self._layouts = self.fam.build_sorted_layouts(self.cfg, self._tokens,
                                                      self._mask)
        self._live = [s for s in self._slots if s is not None]
        self._gather = []
        for c, lay in enumerate(self._layouts):
            clen = self._bounds[c + 1] - self._bounds[c]
            fill = sum(s.widths[c] for s in self._live)
            pieces, off = [], 0
            for slot in self._slots:
                if slot is None:
                    pieces.append(torch.full((clen,), fill, dtype=torch.long,
                                             device=dev))
                else:
                    pieces.append(slot.inv[c] + off)
                    off += slot.widths[c]
            idx = torch.cat(pieces)[lay.order.long()]
            pad = lay.rows.shape[0] - idx.shape[0]
            if pad:
                idx = torch.cat([idx, torch.full((pad,), fill,
                                                 dtype=torch.long,
                                                 device=dev)])
            self._gather.append(idx)

    def _chunk_uniforms(self, c: int, lay: segment.SortedLayout,
                        tile_b: int) -> tuple[torch.Tensor, ...]:
        """Batched chunk ``c``'s streams: each live slot's own, drawn at
        its one-document width and age, gathered into the batched sorted
        order."""
        mh = self.cfg.mh_steps
        drawn = [self.streams.uniforms(s.seed, s.age, c, self._e_out, mh,
                                       s.widths[c], self.device)
                 for s in self._live]
        out = []
        for i in range(5):
            like = drawn[0][i]
            fill = torch.full((mh, 1), 0 if i == 0 else 0.5,
                              dtype=like.dtype, device=self.device)
            side = torch.cat([d[i] for d in drawn] + [fill], dim=1)
            out.append(side[:, self._gather[c]])
        return tuple(out)

    # ---------------------------------------------------------------- step
    def step(self) -> int:
        """One local-only sweep across every live slot; the deltas are
        dropped.  Returns the number of live slots swept."""
        if self.live == 0:
            return 0
        if self._layouts is None:
            self._rebuild()
        local2, _deltas = self.fam.sweep_sorted(
            self.cfg, self._local, self.snap.shared, self.snap.tables,
            self.snap.stale, self._tokens, self._mask, (0,), self._layouts,
            chunk_uniforms=self._chunk_uniforms, device=self.device)
        self._local = self.fam.local_project(local2)
        for slot in self._live:
            slot.age += 1
        self.sweeps_run += 1
        return len(self._live)

    # ------------------------------------------------------------- harvest
    def harvest(self) -> list[InferResult]:
        """Free every slot whose chain has run ``n_sweeps`` sweeps and
        return its topic proportions and final assignments."""
        ready = [j for j, s in enumerate(self._slots)
                 if s is not None and s.age >= self.scfg.n_sweeps]
        if not ready:
            return []
        ld = self.fam.local_dict(self._local)
        rows = torch.as_tensor(ready, device=self.device)
        n_dk = ld["n_dk"][rows].cpu().numpy()
        z = ld["z"][rows].cpu().numpy()
        out = []
        for i, j in enumerate(ready):
            slot = self._slots[j]
            out.append(InferResult(
                uid=slot.uid, theta=_theta(self._prior, n_dk[i], slot.length),
                assignments=z[i, :slot.length].copy(), n_sweeps=slot.age))
            self._slots[j] = None
            self._mask[j] = False
            self.docs_harvested += 1
        self._layouts = None
        return out

    # ----------------------------------------------------------------- run
    def run(self, requests: Iterable[InferRequest]
            ) -> dict[int, InferResult]:
        """Admit as slots free up, sweep, harvest, until every request is
        served."""
        queue = list(requests)
        results: dict[int, InferResult] = {}
        while queue or self.live:
            while queue and self.admit(queue[0]):
                queue.pop(0)
            self.step()
            for res in self.harvest():
                results[res.uid] = res
        return results


# ---------------------------------------------------------------------------
# The oracle: fold-in through the training path with pushes dropped
# ---------------------------------------------------------------------------

def reference_fold_in(snap: InferenceSnapshot, tokens: Sequence[int],
                      seed: int, *, n_sweeps: int, max_len: int,
                      streams: Streams | None = None, device=None
                      ) -> tuple[Any, np.ndarray, np.ndarray]:
    """Fold one document in through the family's ``sweep`` (the call the
    Trainer makes) on a one-document shard, deltas dropped.  ``max_len``
    must be the engine's slot width: the chunk bounds follow from it.
    With ``streams`` the sweeps take their uniforms from it
    (``sweep_sorted``'s ``chunk_uniforms``), else the sweep draws them from
    ``fold_in(root, s)`` and its chunk.  Returns ``(local_state, theta,
    assignments)``."""
    dev = device_mod.resolve(device)
    _check_device(snap, dev)
    fam, cfg = snap.family, snap.cfg
    toks = np.asarray(tokens, np.int32).reshape(-1)
    if toks.size > max_len:
        raise ValueError(f"document has {toks.size} tokens > {max_len}")
    tok1, mask1 = _one_doc(toks, max_len, dev)
    root = root_key(seed)
    if streams is None:
        local, _ = fam.init_state(cfg, tok1, mask1, root)
    else:
        local = streams.init_state(fam, cfg, tok1, mask1, int(seed))
    layouts = fam.build_sorted_layouts(cfg, tok1, mask1)
    e_out = fam.n_outcomes(cfg)
    for s in range(n_sweeps):
        if streams is None:
            local, _ = fam.sweep(
                cfg, local, snap.shared, snap.tables, snap.stale, tok1,
                mask1, device_mod.fold_in(root, s), method="mhw",
                layout="sorted", sorted_layouts=layouts, device=dev)
        else:
            def chunk_uniforms(c, lay, tile_b, s=s):
                return streams.uniforms(int(seed), s, c, e_out, cfg.mh_steps,
                                        lay.rows.shape[0], dev)
            local, _ = fam.sweep_sorted(
                cfg, local, snap.shared, snap.tables, snap.stale, tok1,
                mask1, root, layouts, chunk_uniforms=chunk_uniforms,
                device=dev)
        local = fam.local_project(local)
    prior = np.asarray(snap.topic_prior().cpu().numpy(), np.float32)
    theta = _theta(prior, local.n_dk[0].cpu().numpy(), int(toks.size))
    z = local.z[0, :toks.size].cpu().numpy()
    return local, theta, z


# ---------------------------------------------------------------------------
# Fold-in quality: held-out perplexity of harvested proportions
# ---------------------------------------------------------------------------

def fold_in_perplexity(snap: InferenceSnapshot, thetas: np.ndarray,
                       tokens: np.ndarray, mask: np.ndarray) -> float:
    """Held-out perplexity of documents under their harvested proportions
    and the frozen word distributions, with numpy on CPU copies as the
    reference computes it; the serving counterpart of
    ``family.perplexity``."""
    phi = np.asarray(snap.language_model().cpu().numpy(), np.float32)
    k = thetas.shape[1]
    pw = np.einsum("dk,dlk->dl", np.asarray(thetas, np.float32),
                   phi[np.asarray(tokens)][..., :k])
    m = np.asarray(mask, bool)
    logs = np.log(np.maximum(pw, 1e-30))[m]
    return float(np.exp(-logs.sum() / max(1, m.sum())))
