"""Count the collectives of one mesh step by name, with no card: the port's
train step or served prefill or decode step of an architecture at a chosen
depth, batch and sequence, run once as rank 0 of a fake process group
under ``FakeTensorMode`` (``launch/dryrun.py``'s machinery), on a small
mesh.

    PYTHONPATH=src python3 tools/torch_mesh_tally.py --arch smollm-360m \\
        --layers 8 --kind train --batch 8 --seq 512 [--mesh 2,2] \\
        [--mode megatron] [--microbatches 1] [--top N]

It prints a line per collective name (calls, the rank's input bytes and
its output bytes a step), the totals, the rank's resident bytes, the
peak MemTracker saw and that peak by MemTracker's kind of reference
(``Activation``: made in the forward, ``Temp``: in the backward);
``--top N`` lists the N largest tensors the step made that are alive at
the highest total of them, each with the op that made it.  A decode
step's ``--seq`` is its cache's length.  These are the code's own byte
counts: the figures phases 17b, 17d, 18b and 18d of ``chip_smoke.py``
should read from ``collectives.tally`` on the card at the same shapes:
17b ``--arch smollm-360m --layers 8 --batch 8 --seq 512``, 18b the same with ``--kind decode --seq 516``; 17d
``--arch rwkv6-3b --layers 1 --batch 2 --seq 512`` and ``--arch
zamba2-2.7b --layers 6 --batch 2 --seq 512``, 18d each with ``--kind
decode --seq 516``; 17d's zero_seq steps the same with ``--mode
zero_seq``, and ``--arch whisper-large-v3 --layers 1 --encoder-layers 1
--batch 2 --seq 512 --mode zero_seq``; 17c's zero_seq train step
``--arch phi3.5-moe-42b-a6.6b --layers 1 --batch 4 --seq 512 --mode
zero_seq --mesh 1,2`` (under zero_seq the dry run gives an MoE a token
group a row: its ``moe seq`` exchanges).  An all-to-all's input bytes are the rank's whole
buffer, the part it keeps included.  :func:`step_record` is the same count
for a config built in code (the tests' reduced ones).
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs.base import InputShape
from repro_torch.configs.registry import ARCHITECTURES
from repro_torch.core import collectives
from repro_torch.launch import dryrun


class LiveTensors(TorchDispatchMode):
    """The storages the step makes, tracked while alive: at the highest
    total of them it saw (above those made before, the resident blocks),
    the ``top`` largest, each with the op that made it, its shape and
    dtype, and whether backward made it."""

    def __init__(self, top: int):
        super().__init__()
        self.top, self.live = top, WeakIdKeyDictionary()
        self.total = self.peak = 0
        self.at_peak: list = []

    def _gone(self, nbytes: int) -> None:
        self.total -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st in self.live:
                continue
            n = st.nbytes()
            self.live[st] = (n, str(func), tuple(t.shape), str(t.dtype),
                             torch._C._current_autograd_node() is not None)
            weakref.finalize(st, self._gone, n)
            self.total += n
        if self.total > self.peak * 1.01:
            self.peak = self.total
            self.at_peak = sorted(self.live.values(), reverse=True)[:self.top]
        return out


@contextlib.contextmanager
def live_tensors(top: int):
    """:class:`LiveTensors` around each dry-run step of the ``with`` body
    (yields it; empty where ``top`` is 0)."""
    tracker = LiveTensors(top)
    if not top:
        yield tracker
        return
    peak = dryrun._peak

    def tracked(step):
        with tracker:
            return peak(step)
    dryrun._peak = tracked
    try:
        yield tracker
    finally:
        dryrun._peak = peak


def step_record(cfg, kind: str, batch: int, seq: int, mesh=(2, 2),
                mode: str = "megatron", microbatches: int = 1) -> dict:
    """The dry run's record of one ``kind`` step of ``cfg`` at ``batch`` ×
    ``seq`` on a (data, model) ``mesh`` in ``mode``, as rank 0 of a fake
    group (this process must run none): its collectives by name."""
    data, model = mesh
    shape = InputShape(f"{kind}-{batch}x{seq}", seq, batch, kind)
    named = collectives.tally
    dryrun.collectives.tally = lambda by="kind": named(by="what")
    try:
        with dryrun.fake_group(data * model):
            return dryrun.run_one(cfg.name, shape, cfg=cfg,
                                  sharding_mode=mode, verbose=False,
                                  mesh_shape={"data": data, "model": model},
                                  microbatches=microbatches)
    finally:
        dryrun.collectives.tally = named


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--layers", type=int, default=0,
                    help="depth (0: the published one)")
    ap.add_argument("--encoder-layers", type=int, default=0,
                    help="an encoder's depth (0: the published one)")
    ap.add_argument("--kind", default="train",
                    choices=["train", "prefill", "decode"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--mesh", default="2,2", help="data,model")
    ap.add_argument("--mode", default="megatron",
                    choices=["megatron", "zero_seq", "zero_batch"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--top", type=int, default=0,
                    help="list the N largest tensors the step made that "
                         "are alive at the highest total of them")
    args = ap.parse_args(argv)

    cfg = ARCHITECTURES[args.arch]
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    if args.encoder_layers:
        cfg = cfg.replace(encoder_layers=args.encoder_layers)
    data, model = (int(n) for n in args.mesh.split(","))
    with live_tensors(args.top) as live:
        rec = step_record(cfg, args.kind, args.batch, args.seq,
                          (data, model), args.mode, args.microbatches)
    if rec["status"] != "ok":
        print(rec)
        return 1
    counts = rec["collectives"]
    for name, c in sorted(counts.items()):
        print(f"{name}: {c['calls']} calls, {c['bytes']} B in, "
              f"{c['out_bytes']} B out")
    print(f"total: {sum(c['calls'] for c in counts.values())} calls, "
          f"{sum(c['bytes'] for c in counts.values())} B in, "
          f"{sum(c['out_bytes'] for c in counts.values())} B out a step a "
          f"rank; resident {rec['resident_total_bytes']} B, peak "
          f"{rec['peak_bytes']} B ({args.mode}, mesh {args.mesh}, "
          f"{cfg.name} at {cfg.n_layers} layers, {args.kind} "
          f"{args.batch} x {args.seq})")
    print("peak by MemTracker's kind: " + ", ".join(
        f"{k} {n} B" for k, n in sorted(rec["peak_by_kind"].items())))
    if args.top:
        print(f"the step's tensors alive at their highest total, "
              f"{live.peak} B; the largest {args.top}:")
        for n, op, shape, dtype, back in live.at_peak:
            print(f"  {n} B {op} {list(shape)} {dtype}"
                  f"{' (backward)' if back else ''}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
