"""Serving launcher: the full Packrat pipeline against a real PyTorch model.

A port of ``repro/launch/serve.py``.  Runs the estimator → optimizer →
allocator → dispatcher loop with *measured* instance latencies: each
batch size's latency is one ``decode_step`` of the reduced-config model
(``get_config(arch).reduced()``), run on ``--device``.  A step in the
request rate exercises online reconfiguration (paper Fig. 11).  The
reduced configs keep ``use_pallas_kernels=False``, as in the reference,
so the step runs the port's plain PyTorch attention and no CUDA kernel
of the port (MLA and MoE have none in either package).  Every
registered architecture runs; an encoder-decoder's cache holds a
``seq_len``-frame cross-attention memory, as the reference's does.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
        --duration 20 --rate-step 10                  # on a CUDA card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
        --duration 20 --rate-step 10 --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import statistics
import sys

import torch

from .. import resolve_device
from ..configs import get_config
from ..core.knapsack import PackratOptimizer
from ..models import build_model
from ..serving import (ArrivalProcess, EventLoop, JaxBackend, PackratServer,
                       Request, step_rate)


def make_torch_runner(arch: str, seq_len: int = 128, *, device="cuda"):
    """Real-model runner: decode one token for a batch of b requests.

    Each runner owns a KV cache and a stream (on a card): the step runs
    on that stream and the run waits for that stream only.  The step
    rewrites the same cache slot on every run, as the reference's
    jitted step at position 0 does.
    """
    dev = resolve_device(device)
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(0, device=dev)

    def make_runner(b: int):
        cache = model.init_cache(b, seq_len,
                                 seq_len if cfg.is_encdec else 0, device=dev)
        tokens = torch.zeros((b, 1), dtype=torch.long, device=dev)
        stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        if stream is not None:
            # the stream reads the weights, cache and tokens only after
            # the work that made them
            stream.wait_stream(torch.cuda.current_stream(dev))

        @torch.no_grad()
        def run():
            with (torch.cuda.stream(stream) if stream is not None
                  else contextlib.nullcontext()):
                model.decode_step(params, cache, tokens, 0)
            if stream is not None:
                stream.synchronize()

        return run

    return make_runner


def synth_profile(backend: JaxBackend, threads: int, max_batch: int):
    """Measured single-instance profile; thread scaling applies the
    paper's fitted intra-op curve (one device cannot vary t physically,
    as in the reference)."""
    from ..core.paper_profiles import RESNET50
    table = {}
    for b in [1 << k for k in range(max_batch.bit_length())]:
        base = backend.batch_latency(1, b)
        for t in range(1, threads + 1):
            table[(t, b)] = base / RESNET50.scaling(t)
    return table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--units", type=int, default=16)
    ap.add_argument("--duration", type=float, default=20.0)
    ap.add_argument("--rate-step", type=float, default=10.0,
                    help="time of the request-rate step")
    ap.add_argument("--initial-batch", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model step; 'cpu' runs it "
                         "on the CPU")
    args = ap.parse_args(argv)

    # JaxBackend's body only calls the runner and reads the clock; its
    # name stays because serving/instance.py is a copy of the reference's
    backend = JaxBackend(make_torch_runner(args.arch, device=args.device))
    profile = synth_profile(backend, args.units, args.max_batch)
    opt = PackratOptimizer(profile)

    loop = EventLoop()
    server = PackratServer(loop, total_units=args.units, optimizer=opt,
                           backend=backend, initial_batch=args.initial_batch)
    lo_cfg = opt.solve(args.units, args.initial_batch)
    hi_cfg = opt.solve(args.units, args.max_batch)
    # cap the rates so the event simulation stays tractable with real
    # measured (sub-millisecond, reduced-model) step latencies
    rate = step_rate(min(2000.0, args.initial_batch / lo_cfg.latency),
                     min(6000.0, 0.9 * args.max_batch / hi_cfg.latency),
                     args.rate_step)
    arrivals = ArrivalProcess.uniform(rate, args.duration)
    for i, t in enumerate(arrivals):
        loop.at(t, (lambda i=i, t=t: server.submit(Request(i, t))))
    loop.run_until(args.duration + 30.0)

    lats = [r.latency for r in server.responses]
    print(f"[serve] arch={args.arch} requests={len(arrivals)} "
          f"completed={len(server.responses)}")
    if lats:
        print(f"[serve] latency mean={statistics.mean(lats)*1e3:.1f}ms "
              f"p50={statistics.median(lats)*1e3:.1f}ms "
              f"p99={sorted(lats)[int(0.99 * (len(lats) - 1))]*1e3:.1f}ms")
    for t, b, cfg in server.reconfig_log:
        print(f"[serve] t={t:6.1f}s reconfig B={b:4d} -> {cfg}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
