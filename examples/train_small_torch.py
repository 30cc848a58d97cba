"""Train a ~59M-parameter llama-style model for a few hundred steps on
the PyTorch port.

The end-to-end training run: synthetic (learnable) corpus, AdamW with
warmup+cosine, periodic checkpointing with the fault-tolerant commit
protocol, and resumption.  At d_model=512, 8 layers, vocab 32768 the
model has 58,728,960 parameters, as the reference's ``train_small.py``
builds it (whose docstring says ~101M) — big enough to be real, small
enough for one card (``--device cpu`` trains it on the CPU, slowly).

Run:  PYTHONPATH=src python examples/train_small_torch.py [--steps 300]
"""

import argparse
import sys

from repro_torch.launch.train import main


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default="/tmp/repro_torch_ckpt_100m")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.exit(main([
        "--arch", "llama3-8b", "--reduced",
        "--d-model", "512", "--layers", "8", "--vocab", "32768",
        "--steps", str(args.steps), "--batch", "8", "--seq", "256",
        "--lr", "1e-3", "--ckpt", args.ckpt, "--ckpt-every", "100",
        "--resume", "--log-every", "20", "--device", args.device,
    ]))
