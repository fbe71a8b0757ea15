"""LM training launcher (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --steps 100 --batch 8 --seq 128 [--reduced] [--device cpu] \
        [--mesh data=2,model=2 --sharding zero_batch]

Builds the model (``--seed`` keys its initial weights), the microbatched
AdamW step and the synthetic token stream, and runs the loop with periodic
checkpoints (``--ckpt-dir``, ``--ckpt-every``; ``--resume`` restores the
newest one).  A checkpoint holds the reference's ``{"params", "opt"}``
tree under the reference's file names, so either package resumes the
other's.  It runs on ``cuda`` unless ``--device cpu`` is passed.

``--mesh data=D,model=M`` beyond one rank trains over a (data, model)
``torch.distributed`` mesh, one process a rank (``launch.mesh.
run_on_mesh``), in ``--sharding``'s layout after the reference's
``resolve_mode`` (zero_batch needs the batch to divide the mesh, zero_seq
the sequence the model axis): every rank builds the full weights from the
seed and keeps its blocks (:mod:`repro_torch.train.sharding`), draws the
same global batches and runs the mesh step.  Rank 0 prints and writes the
checkpoints, the full tree gathered from every rank; ``--resume`` cuts the
restored full tree into each rank's blocks again, so a checkpoint moves
between meshes and the one-card launchers of both packages.  The ranks
talk over NCCL on ``cuda`` when there is a card a rank, else over gloo
with their tensors on the cards they share (NCCL refuses two ranks on one
device); over gloo on the CPU.
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
from repro_torch.train import sharding
from repro_torch.train.train_step import (TrainConfig, make_train_step,
                                          param_layout)


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
                    choices=["megatron", "zero_seq", "zero_batch"],
                    help="layout over the mesh (train/sharding.py)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the initial weights")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    mesh = parse_mesh(args.mesh)
    if set(mesh) - {"data", "model"}:
        ap.error(f"--mesh {args.mesh}: the axes are data and model")
    return args


def _config(args):
    cfg = ARCHITECTURES[args.arch]
    if args.reduced:
        cfg = reduced(cfg).replace(vocab_size=min(512, cfg.vocab_size))
    tcfg = TrainConfig(peak_lr=args.lr, warmup=min(10, args.steps // 5),
                       total_steps=args.steps,
                       microbatches=args.microbatches,
                       loss_chunk=min(512, args.seq))
    return cfg, tcfg


def _restore(args, cfg, params, opt, place):
    """(params, opt, start) from the newest checkpoint (``params`` and
    ``opt``, full, its template), each tree passed through ``place``; None
    when there is none."""
    step0 = ckpt.latest_step(args.ckpt_dir, cfg.name)
    if step0 is None:
        return None
    state = ckpt.restore(args.ckpt_dir, cfg.name,
                         {"params": params, "opt": opt._asdict()})
    step = state["opt"]["step"].to(opt.step.device)
    return (place(state["params"]), adamw.AdamWState(
        step=step, m=place(state["opt"]["m"]), v=place(state["opt"]["v"])),
        step0)


def _loop(args, cfg, step_fn, params, opt, start, save, say):
    data = lm_batches(cfg.vocab_size, args.batch, args.seq,
                      args.steps - start, seed=1, kind="affine")
    t0 = time.time()
    for i, batch in enumerate(data):
        step = start + i
        params, opt, metrics = step_fn(params, opt, batch)
        if step % 10 == 0 or step == args.steps - 1:
            tok_s = ((i + 1) * args.batch * args.seq
                     / max(time.time() - t0, 1e-9))
            say(f"step {step:5d}  loss={float(metrics['loss']):8.4f}  "
                f"gnorm={float(metrics['grad_norm']):7.3f}  "
                f"{tok_s:9.0f} tok/s")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            path = save(step + 1, params, opt)
            say(f"checkpoint: {path}")
    return params, opt


def main(argv=None) -> None:
    args = parse_args(argv)
    dev = device_mod.resolve(args.device)
    m = parse_mesh(args.mesh)
    data, model = m.get("data", 1), m.get("model", 1)
    if data * model > 1:
        _main_mesh(args, dev, data, model)
        return
    cfg, tcfg = _config(args)
    params = model_lib.init_params(cfg, seed=args.seed, device=dev)
    opt = adamw.init(params)
    start = 0
    if args.resume and args.ckpt_dir:
        got = _restore(args, cfg, params, opt, lambda tree: model_lib.map_tree(
            lambda t: t.to(dev), tree))
        if got is not None:
            params, opt, start = got
            print(f"resumed from step {start}")

    def save(step, params, opt):
        return ckpt.save(args.ckpt_dir, cfg.name, step,
                         {"params": params, "opt": opt._asdict()})

    _loop(args, cfg, make_train_step(cfg, tcfg, device=dev), params, opt,
          start, save, lambda line: print(line, flush=True))
    print("training complete")


def _main_mesh(args, dev, data: int, model: int) -> None:
    import torch

    from repro_torch.launch.mesh import run_on_mesh

    ranks = data * model
    backend = None
    if dev.type == "cuda" and torch.cuda.device_count() < ranks:
        backend = "gloo"
        print(f"mesh {data}x{model}: {ranks} ranks on "
              f"{torch.cuda.device_count()} card(s): gloo over CUDA tensors "
              "(NCCL refuses two ranks on one device)", flush=True)
    run_on_mesh(_rank, data, model, device=dev, backend=backend,
                args=(args,), timeout=24 * 3600.0)
    print("training complete")


def _rank(mesh, dev, args) -> None:
    """One rank of ``--mesh``: the layout, the blocks, the loop."""
    import torch.distributed as dist

    cfg, tcfg = _config(args)
    sizes = sharding.axis_sizes(mesh)
    mode = sharding.resolve_mode(sizes, args.sharding, args.batch, args.seq)
    me = dist.get_rank()
    say = (lambda line: print(line, flush=True)) if me == 0 else \
        (lambda line: None)
    say(f"mesh {sizes['data']}x{sizes['model']} ({dist.get_backend()}), "
        f"sharding {mode}" + (f" (asked {args.sharding})"
                              if mode != args.sharding else ""))
    specs = param_layout(cfg, mesh, mode)

    def cut(tree):
        return sharding.shard_tree(model_lib.map_tree(
            lambda t: t.to(dev), tree), specs, mesh)

    full = model_lib.init_params(cfg, seed=args.seed, device=dev)
    params = cut(full)
    opt = adamw.init(params)
    start = 0
    if args.resume and args.ckpt_dir:
        got = _restore(args, cfg, full, adamw.init(full), cut)
        if got is not None:
            params, opt, start = got
            say(f"resumed from step {start}")
    del full

    def save(step, params, opt):
        tree = {"params": sharding.gather_tree(params, specs, mesh),
                "opt": {"step": opt.step,
                        "m": sharding.gather_tree(opt.m, specs, mesh),
                        "v": sharding.gather_tree(opt.v, specs, mesh)}}
        path = ckpt.save(args.ckpt_dir, cfg.name, step, tree) \
            if me == 0 else None
        dist.barrier()
        return path

    _loop(args, cfg, make_train_step(cfg, tcfg, device=dev, mesh=mesh,
                                     mode=mode),
          params, opt, start, save, say)


if __name__ == "__main__":
    main()
