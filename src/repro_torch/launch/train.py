"""Training launcher: real execution on one device, any architecture.

A port of ``repro/launch/train.py`` with the same flags, plus
``--device`` (default ``cuda``: without a card it raises unless given
``cpu``).  It prints the reference's lines: ``params=…M devices=…``
once, and ``step= loss= tok/s= lr=`` every ``--log-every`` steps.
Checkpoint/restart is wired in: ``--resume`` restores the latest
committed step (fault-tolerance contract in training/checkpoint.py); as
in the reference, the data stream then starts again from its first
batch.  ``examples/train_small.py``'s argument list reproduces that
example here:

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
        --reduced --d-model 512 --layers 8 --vocab 32768 --steps 300 \\
        --batch 8 --seq 256 --lr 1e-3 --ckpt /tmp/ckpt --ckpt-every 100 \\
        --resume --log-every 20
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from .. import resolve_device
from ..configs import ShapeConfig, get_config
from ..data import batches_for_model
from ..models import build_model
from ..models.lm import param_count
from ..training import (AdamWConfig, Checkpointer, TrainConfig, init_adamw,
                        make_train_step)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU-trainable)")
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    return ap.parse_args(argv)


def configure(args: argparse.Namespace):
    """The model configuration, batch shape and TrainConfig the flags
    name: (cfg, shape, tcfg)."""
    cfg = get_config(args.arch)
    if args.reduced:
        heads = max(4, args.d_model // 64)
        cfg = cfg.reduced(n_repeats=max(1, args.layers // max(1, len(cfg.pattern))),
                          d_model=args.d_model, n_heads=heads,
                          d_ff=args.d_model * 3, vocab_size=args.vocab)
    shape = ShapeConfig("cli", seq_len=args.seq, global_batch=args.batch,
                        kind="train")
    tcfg = TrainConfig(
        adamw=AdamWConfig(learning_rate=args.lr, warmup_steps=20,
                          decay_steps=max(args.steps, 100),
                          state_dtype=cfg.train_state_dtype),
        grad_accum=args.grad_accum)
    return cfg, shape, tcfg


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg, shape, tcfg = configure(args)
    model = build_model(cfg)
    params = model.init(args.seed, device=dev)
    opt_state = init_adamw(tcfg.adamw, params)
    ckpt = Checkpointer(args.ckpt, async_save=True) if args.ckpt else None
    start_step = 0
    if ckpt and args.resume and ckpt.latest_step() is not None:
        restored = ckpt.restore(like={"params": params,
                                      "opt_state": opt_state})
        params = restored["tree"]["params"]
        opt_state = restored["tree"]["opt_state"]
        start_step = restored["step"]
        print(f"[train] resumed from step {start_step}")

    devices = torch.cuda.device_count() if dev.type == "cuda" else 1
    print(f"[train] arch={cfg.name} params={param_count(params) / 1e6:.1f}M "
          f"devices={devices}")

    step_fn = make_train_step(cfg, tcfg)
    data = batches_for_model(cfg, shape, seed=args.seed)
    t0 = time.perf_counter()
    tokens_per_step = args.batch * args.seq
    for step in range(start_step, args.steps):
        batch = {name: x.to(dev) for name, x in next(data).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            done = step + 1 - start_step
            print(f"[train] step={step + 1:5d} loss={loss:.4f} "
                  f"tok/s={done * tokens_per_step / max(dt, 1e-9):,.0f} "
                  f"lr={float(metrics['lr']):.2e}")
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, params, opt_state)
    if ckpt:
        ckpt.save(args.steps, params, opt_state)
        ckpt.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
