"""Train a language model end-to-end with the PyTorch port's training
substrate: any assigned architecture (``--arch``), microbatched AdamW,
remat, chunked loss, checkpointing, and the optional stale-synchronous
filtered gradient sync (the paper's PS pattern applied to training).
The counterpart of ``examples/train_lm.py``; it runs on ``cuda`` unless
``--device cpu`` is passed.

    # CI-sized run (reduced config, converges visibly in ~60 steps):
    PYTHONPATH=src python examples/train_lm_torch.py --steps 60 --device cpu

    # ~100M-parameter run:
    PYTHONPATH=src python examples/train_lm_torch.py --arch smollm-360m \
        --preset 100m --steps 300 --batch 8 --seq 512

    # paper-pattern sync: 2 simulated clients, top-k filtered, staleness 2:
    PYTHONPATH=src python examples/train_lm_torch.py --stale-sync --clients 2
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import ARCHITECTURES
from repro_torch.core import ps
from repro_torch.data.synthetic import lm_batches
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw
from repro_torch.train import sync as sync_lib
from repro_torch.train.train_step import (TrainConfig, grads_of,
                                          make_train_step)


def pick_config(args):
    cfg = ARCHITECTURES[args.arch]
    if args.preset == "tiny":
        cfg = reduced(cfg).replace(vocab_size=min(512, cfg.vocab_size))
    elif args.preset == "100m":
        # ~100M params of the same family (smollm-360m at 16 layers ≈ 100M
        # non-embedding + embeddings).
        cfg = cfg.replace(n_layers=min(cfg.n_layers, 16),
                          vocab_size=min(cfg.vocab_size, 16384))
    return cfg


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m",
                    choices=sorted(ARCHITECTURES))
    ap.add_argument("--preset", choices=["tiny", "100m", "full"],
                    default="tiny")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--stale-sync", action="store_true",
                    help="PS-pattern gradient sync (filtered, stale)")
    ap.add_argument("--clients", type=int, default=2)
    ap.add_argument("--sync-every", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = device_mod.resolve(args.device)
    cfg = pick_config(args)
    n_params = cfg.param_count()
    print(f"arch={cfg.name} preset={args.preset} params≈{n_params / 1e6:.1f}M "
          f"batch={args.batch}x{args.seq} device={dev}")

    tcfg = TrainConfig(peak_lr=args.lr, warmup=min(10, args.steps // 5),
                       total_steps=args.steps,
                       microbatches=args.microbatches,
                       loss_chunk=min(512, args.seq))
    params = model_lib.init_params(cfg, seed=args.seed, device=dev)
    opt = adamw.init(params)

    data = lm_batches(cfg.vocab_size, args.batch, args.seq, args.steps,
                      seed=1, kind="affine")

    if not args.stale_sync:
        step_fn = make_train_step(cfg, tcfg, device=dev)
        t0 = time.time()
        for step, batch in enumerate(data):
            params, opt, metrics = step_fn(params, opt, batch)
            if step % 10 == 0 or step == args.steps - 1:
                print(f"step {step:4d}  loss={float(metrics['loss']):7.4f}  "
                      f"lr={float(metrics['lr']):.2e}  "
                      f"gnorm={float(metrics['grad_norm']):7.3f}  "
                      f"{(step + 1) * args.batch * args.seq / (time.time() - t0):.0f} tok/s")
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                path = ckpt.save(args.ckpt_dir, cfg.name, step + 1,
                                 {"params": params, "opt": opt._asdict()})
                print(f"  checkpoint: {path}")
        return

    # ---- stale-synchronous PS-pattern training (paper §5.3 on gradients) --
    scfg = sync_lib.SyncConfig(
        sync_every=args.sync_every,
        filter=ps.FilterSpec(kind="topk", k_rows=64, random_rows=16))
    residuals = [model_lib.map_tree(torch.zeros_like, params)
                 for _ in range(args.clients)]
    t0 = time.time()
    for step, batch in enumerate(data):
        toks = batch["tokens"]
        shard = max(1, toks.shape[0] // args.clients)
        losses, grads_sum = [], None
        for c in range(args.clients):
            b = model_lib.to_batch(
                {"tokens": toks[c * shard:(c + 1) * shard]}, dev)
            loss, _, g = grads_of(cfg, tcfg, params, b)
            losses.append(float(loss))
            residuals[c] = model_lib.map2(torch.add, residuals[c], g)
        if (step + 1) % scfg.sync_every == 0:
            for c in range(args.clients):
                key = (args.seed, device_mod.FILTER, step, c)
                sent = sync_lib.filter_tree(residuals[c], scfg.filter, key)
                residuals[c] = model_lib.map2(torch.sub, residuals[c], sent)
                grads_sum = sent if grads_sum is None else model_lib.map2(
                    torch.add, grads_sum, sent)
            grads = model_lib.map_tree(
                lambda g: g / (args.clients * scfg.sync_every), grads_sum)
            lr = adamw.cosine_schedule(opt.step, peak_lr=tcfg.peak_lr,
                                       warmup=tcfg.warmup,
                                       total=tcfg.total_steps)
            params, opt = adamw.update(params, grads, opt, lr=lr,
                                       weight_decay=tcfg.weight_decay,
                                       grad_clip=tcfg.grad_clip)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss={np.mean(losses):7.4f}  "
                  f"({time.time() - t0:.1f}s)")
    dense_b, filt_b = sync_lib.sync_bytes_estimate(params, scfg.filter)
    print(f"sync traffic: {filt_b / scfg.sync_every / 1e6:.2f} MB/step "
          f"filtered vs {dense_b / 1e6:.2f} MB/step dense "
          f"({dense_b / (filt_b / scfg.sync_every):.1f}x reduction)")


if __name__ == "__main__":
    main()
