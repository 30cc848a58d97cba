#!/usr/bin/env python3
"""Trace ``examples/train_small_torch.py``'s train step on one card.

Run from the root of a checkout on a machine with a CUDA card::

    python3 tools/train_small_trace.py [--steps 4]

Builds the example's model with the launcher's own flags
(``repro_torch.launch.train``: llama3-8b reduced to d_model 512, 8
layers, vocab 32768, B = 8, S = 256, AdamW lr 1e-3, seed 0), runs three
warm-up steps, then ``--steps`` steps untraced and once more under
``torch.profiler`` (``chip_smoke._traced``), and prints one JSON line:
the host's ms to draw one batch from the synthetic corpus, wall ms,
host enqueue ms, device busy ms, idle share, launches and kernel records
per step, the top device kernels and host operators, and the card's
name and power limit.  No kernel of the port runs (the reduced config
keeps ``use_pallas_kernels`` off), so nothing is built.
"""

import argparse
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

FLAGS = ["--arch", "llama3-8b", "--reduced", "--d-model", "512",
         "--layers", "8", "--vocab", "32768", "--batch", "8", "--seq", "256",
         "--lr", "1e-3", "--steps", "300", "--device", "cuda"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=4,
                    help="steps timed and traced (default 4)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("train_small_trace: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.data import batches_for_model
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.training import init_adamw, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg, shape, tcfg = train.configure(train.parse_args(FLAGS))
    dev = torch.device("cuda")
    state = {"params": build_model(cfg).init(0, device=dev)}
    state["opt"] = init_adamw(tcfg.adamw, state["params"])
    step = make_train_step(cfg, tcfg)
    data = batches_for_model(cfg, shape, seed=0)
    n = 3 + 2 * args.steps
    t0 = time.perf_counter()
    host = [next(data) for _ in range(n)]
    batch_ms = (time.perf_counter() - t0) * 1e3 / n
    # the profiler may trace the steps again: the batches go round
    batches = itertools.cycle([{k: v.to(dev) for k, v in b.items()}
                               for b in host])

    def run(steps):
        for _ in range(steps):
            state["params"], state["opt"], _ = step(
                state["params"], state["opt"], next(batches))

    run(3)                                   # warm-up: cuBLAS, allocator
    rep = cs._traced(torch, lambda: run(args.steps), args.steps)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"config": cfg.name, "batch": [8, 256],
                      "host_batch_ms": batch_ms, "steps": args.steps,
                      **rep, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
