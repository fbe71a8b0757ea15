"""Count the collectives of one mesh step by name, with no card: the port's
train step or served prefill or decode step of an architecture at a chosen
depth, batch and sequence, run once as rank 0 of a fake process group
under ``FakeTensorMode`` (``launch/dryrun.py``'s machinery), on a small
mesh.

    PYTHONPATH=src python3 tools/torch_mesh_tally.py --arch smollm-360m \\
        --layers 8 --kind train --batch 8 --seq 512 [--mesh 2,2] \\
        [--mode megatron] [--microbatches 1]

It prints a line per collective name (calls, the rank's input bytes and
its output bytes a step), the totals, the rank's resident bytes and the
peak MemTracker saw.  A decode step's ``--seq`` is its cache's length.
These are the code's own byte counts: the figures phases 17b, 17d, 18b
and 18d of ``chip_smoke.py`` should read from ``collectives.tally`` on the
card at the same shapes: 17b ``--arch smollm-360m --layers 8 --batch 8
--seq 512``, 18b the same with ``--kind decode --seq 516``; 17d
``--arch rwkv6-3b --layers 1 --batch 2 --seq 512`` and ``--arch
zamba2-2.7b --layers 6 --batch 2 --seq 512``, 18d each with ``--kind
decode --seq 516``; 17d's zero_seq steps the same with ``--mode
zero_seq``, and ``--arch whisper-large-v3 --layers 1 --encoder-layers 1
--batch 2 --seq 512 --mode zero_seq``.  An all-to-all's input bytes are the rank's whole
buffer, the part it keeps included.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.configs.base import InputShape
from repro_torch.configs.registry import ARCHITECTURES
from repro_torch.core import collectives
from repro_torch.launch import dryrun


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
    args = ap.parse_args(argv)

    cfg = ARCHITECTURES[args.arch]
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    if args.encoder_layers:
        cfg = cfg.replace(encoder_layers=args.encoder_layers)
    data, model = (int(n) for n in args.mesh.split(","))
    shape = InputShape(f"{args.kind}-{args.batch}x{args.seq}", args.seq,
                       args.batch, args.kind)
    named = collectives.tally
    dryrun.collectives.tally = lambda by="kind": named(by="what")
    try:
        with dryrun.fake_group(data * model):
            rec = dryrun.run_one(args.arch, shape, cfg=cfg,
                                 sharding_mode=args.mode, verbose=False,
                                 mesh_shape={"data": data, "model": model},
                                 microbatches=args.microbatches)
    finally:
        dryrun.collectives.tally = named
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
