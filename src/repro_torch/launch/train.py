"""LM training launcher, one process on one card (port of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --steps 100 --batch 8 --seq 128 [--reduced] [--device cpu]

Builds the model (``--seed`` keys its initial weights), the microbatched
AdamW step and the synthetic token stream, and runs the loop with periodic
checkpoints (``--ckpt-dir``, ``--ckpt-every``; ``--resume`` restores the
newest one).  A checkpoint holds the reference's ``{"params", "opt"}``
tree under the reference's file names, so either package resumes the
other's.  It runs on ``cuda`` unless ``--device cpu`` is passed.

Only the one-card layout runs here: ``--mesh`` other than
``data=1,model=1`` and ``--sharding`` other than ``megatron`` are refused
at parse time; the mesh modes are ROADMAP A.13b.
"""

from __future__ import annotations

import argparse
import time

from repro_torch import device as device_mod
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import ARCHITECTURES
from repro_torch.data.synthetic import lm_batches
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw
from repro_torch.train.train_step import TrainConfig, make_train_step

MESH_MODES = "ROADMAP A.13b (sharding over a torch.distributed mesh)"


def parse_mesh(spec: str) -> dict[str, int]:
    out = {}
    for part in spec.split(","):
        k, v = part.split("=")
        out[k.strip()] = int(v)
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m",
                    choices=sorted(ARCHITECTURES))
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh", default="data=1,model=1")
    ap.add_argument("--sharding", default="megatron",
                    choices=["megatron", "zero_seq", "zero_batch"])
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the initial weights")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    mesh = parse_mesh(args.mesh)
    if any(n != 1 for n in mesh.values()):
        ap.error(f"--mesh {args.mesh}: only data=1,model=1 runs in this "
                 f"port; meshes are {MESH_MODES}")
    if args.sharding != "megatron":
        ap.error(f"--sharding {args.sharding}: only the one-card layout "
                 f"runs in this port; the zero modes are {MESH_MODES}")
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    dev = device_mod.resolve(args.device)
    cfg = ARCHITECTURES[args.arch]
    if args.reduced:
        cfg = reduced(cfg).replace(vocab_size=min(512, cfg.vocab_size))
    tcfg = TrainConfig(peak_lr=args.lr, warmup=min(10, args.steps // 5),
                       total_steps=args.steps,
                       microbatches=args.microbatches,
                       loss_chunk=min(512, args.seq))
    params = model_lib.init_params(cfg, seed=args.seed, device=dev)
    opt = adamw.init(params)

    start = 0
    if args.resume and args.ckpt_dir:
        step0 = ckpt.latest_step(args.ckpt_dir, cfg.name)
        if step0 is not None:
            state = ckpt.restore(args.ckpt_dir, cfg.name,
                                 {"params": params, "opt": opt._asdict()})
            params = model_lib.map_tree(lambda t: t.to(dev), state["params"])
            opt = adamw.AdamWState(
                step=state["opt"]["step"].to(dev),
                m=model_lib.map_tree(lambda t: t.to(dev), state["opt"]["m"]),
                v=model_lib.map_tree(lambda t: t.to(dev), state["opt"]["v"]))
            start = step0
            print(f"resumed from step {start}")

    step_fn = make_train_step(cfg, tcfg, device=dev)
    data = lm_batches(cfg.vocab_size, args.batch, args.seq,
                      args.steps - start, seed=1, kind="affine")
    t0 = time.time()
    for i, batch in enumerate(data):
        step = start + i
        params, opt, metrics = step_fn(params, opt, batch)
        if step % 10 == 0 or step == args.steps - 1:
            tok_s = ((i + 1) * args.batch * args.seq
                     / max(time.time() - t0, 1e-9))
            print(f"step {step:5d}  loss={float(metrics['loss']):8.4f}  "
                  f"gnorm={float(metrics['grad_norm']):7.3f}  "
                  f"{tok_s:9.0f} tok/s", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            path = ckpt.save(args.ckpt_dir, cfg.name, step + 1,
                             {"params": params, "opt": opt._asdict()})
            print(f"checkpoint: {path}", flush=True)
    print("training complete")


if __name__ == "__main__":
    main()
