#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA device, ``nvcc`` (``/usr/local/cuda`` or ``CUDA_HOME``) and no
network.  Four LM serving paths, each a registered configuration at
full width with seeded random weights, the micro models of the real
plane, and the kernels each one runs:

* gemma3-1b — ``flash_attention`` (prefill), ``decode_attention`` (decode);
* mamba2-130m — ``ssd_scan`` (prefill);
* recurrentgemma-9b — ``rglru_scan`` (prefill) and, in its local
  attention layers, ``flash_attention`` and ``decode_attention``;
* deepseek-v2-236b — no kernel: multi-head latent attention (blocked
  prefill attention, absorbed latent decode) and the capacity-tile MoE
  are plain PyTorch, as the reference has no Pallas kernel there.  Depth
  is cut to the dense MLA prefix layer and 2 of 59 MLA_MOE repeats
  (:data:`CUT`): ~9.3B parameters, 18.7 GB in bf16 and 37 GB in fp32,
  where 59 repeats would be ~470 GB;
* attn-tiny — ``flash_attention`` on its CUDA-core route (fp32, head
  dim 16); mlp-tiny and mlp run no kernel of the port.

Phases, each printing JSON lines; any failure raises and the script exits
non-zero:

1. **build** — compile the CUDA kernels from ``src/repro_torch/kernels/
   csrc`` (one ``nvcc`` per source, in parallel) into ``build/kernels``.
2. **kernels** — each kernel against its plain PyTorch version on the
   card, fp32 and bf16: the shape grids of ``tests/test_kernels.py``,
   head dim 8, GQA groups 1-16, windows, partial tiles, a single chunk,
   attn-tiny's shapes (fp32, 2 heads of 16, S = 16, 8 and 4 at B = 1,
  16 and 256; the wrapper pads 8 and 4 to 16, the forced route takes
  them as they are), and the serving shapes of the three LM paths at
  B = 1 and 4 (decode
   also at B = 8 and at the serve phase's cache lengths; decode lengths
   of 1, one split, one split + 1 and S; RG-LRU partial chunks and
   column tiles).  ``flash_attention``, ``decode_attention`` and
   ``ssd_scan`` have two routes each (CUDA cores, tensor cores for
   bf16): every case runs through the public wrapper and through each
   route that takes it, forced, and the wrapper's choice by shape must
   match the Python route rule bit for bit; ``rglru_scan`` has one
   kernel, the chunked scan.  Tolerances are ``tests/test_kernels.py``'s (atol = rtol =
   2e-5 fp32, 2e-2 bf16); the scans' final states are compared too, and
   the fp32 SSD kernel is held against the sequential recurrence in fp64
   (in fp32 it strays past 2e-5 from that at B = 4).  Times
   at the serving shapes: the wrapper and each route, its plain version,
   one PyTorch library call computing the same function where there is
   one (``scaled_dot_product_attention``, a yardstick the port never
   calls; no single call computes either scan) and the card's bound for
   the work.  ``time_ms`` times the device alone: a sleep kernel holds
   the device while the host queues the whole batch, so ``ms`` is not the
   host's cadence, which ``host_ms`` reports beside it.
3. **model** — per path, one prompt and 8 decode steps through the
   kernels against the same weights through the plain path: gemma3-1b
   1024 tokens (past its 512-token window, so the ring cache rolls),
   mamba2-130m 1000 tokens (not a chunk multiple, so the dt = 0 padding
   runs), recurrentgemma-9b 2100 tokens (past its 2048-token window)
   into a 4096-slot cache.  fp32 logits must agree to 1e-3 of their
   largest magnitude (summation order only); in bf16 the kernel path
   must stay within twice the plain bf16 path's distance from the fp32
   logits (floor 2e-2).  deepseek-v2-236b has no kernel, so its check
   holds a 512-token prefill (1024 slots) and 8 absorbed decode steps
   against a full-sequence ``forward`` over the same tokens (expanded
   attention): fp32 within 1e-3, bf16 within twice the bf16 forward's
   distance from the fp32 forward (floor 2e-2).  Its MoE is made
   dropless for the check (capacity factor :data:`DROPLESS_CF` ≥ E /
   top_k): a forward over S + 8 tokens and a prefill over S would
   otherwise drop different assignments.
   **moe** — deepseek-v2-236b's MoE at full width and the published
   capacity factor 1.25: ``moe_dispatch_indices`` on the card equals
   its CPU result bit for bit for the same router output (T = 2048, the
   serve prefill; the same tokens pushed toward one expert, which must
   drop; T = 4), and prints the drops; two ``apply_moe`` calls on one
   input are bit-identical (the combine uses no atomics), and each is
   timed at the serve prefill (4 × 512 tokens) and a B = 4 decode step.
4. **trace** — per path, where a full-width bf16 step spends its time:
   one 512-token prefill and 4 decode steps at batch 1, traced with
   ``torch.profiler``: wall time, host time to enqueue, device busy time,
   the device's idle share, CUDA launches and the top device kernels.
5. **serve** — the main path, per configuration: the full-width bf16
   ``LmEngine`` behind ``RealPlane``, per-phase profiles, then
   ``run_lm_policy`` for ``static`` and ``packrat`` over a seeded
   steady-poisson trace.  Every prompt must complete, every kernel of the
   path must launch, each only on the route ``PATHS`` requires for it
   (the tensor cores for the attention kernels and ``ssd_scan``, the
   chunked RG-LRU scan), no other kernel may launch, and no wrapper may
   take its CPU route.  The launch counts (by route) are reset just
   before each path and read just after it.
6. **micro** — per micro model: the card's step against the CPU plain
   step on the same weights (fp32, 2e-5), a trace of one runner step at
   b = 1 and 256, then the launcher's ``run_real_scenario`` on
   steady-poisson (4 s, 4 units, max batch 256, capped at 300 req/s)
   under both policies and both dispatches.  Every request must
   complete; the counts, reset just before the scenario and read just
   after, must show attn-tiny's flash calls on the CUDA-core route only,
   no kernel for the MLPs, and no CPU-route call.
7. **launcher** — ``repro_torch.launch.bench_serving`` on the fast
   simulated plane (step-up, 20 s), twice: the reports must be identical.
8. **serve_online** — ``repro_torch.launch.serve`` with
   ``examples/serve_online.py``'s arguments over 8 s (rate step at 4 s)
   on the card: every request must complete; the reduced model runs no
   kernel of the port, as in the reference.

Then the card's name and power limit, the ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``.  ``--kernels-only`` stops after
phase 2 (a quick check after editing a kernel).
"""

from __future__ import annotations

import functools
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MEM_BW = 3.35e12                       # H100 SXM HBM3 bytes/s
PEAK = {"float32": 67e12, "bfloat16": 989e12}   # fp32 CUDA cores; bf16 dense
TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 2e-2)}
SERVE_SECONDS = 8.0
# trace phase: one prefill of TRACE_PROMPT tokens, then TRACE_DECODE steps
TRACE_PROMPT, TRACE_DECODE, TRACE_MAX_LEN, TRACE_TOP = 512, 4, 1024, 8
# path -> {kernel its serve block must launch: the one route every bf16
# serving call of that kernel must take}; any other launch fails the path
PATHS = {"gemma3-1b": {"flash_attention": "tensor_core",
                       "decode_attention": "tensor_core"},
         "mamba2-130m": {"ssd_scan": "tensor_core"},
         "recurrentgemma-9b": {"rglru_scan": "chunked",
                               "flash_attention": "tensor_core",
                               "decode_attention": "tensor_core"},
         "deepseek-v2-236b": {}}
# path -> overrides that cut a configuration to one card: deepseek-v2-236b
# keeps its full width and its dense MLA prefix layer, and 2 of its 59
# MLA_MOE repeats (each ~3.97B parameters, 7.9 GB in bf16): 59 repeats
# are ~470 GB in bf16, and the fp32 model check needs ~37 GB for 2
CUT = {"deepseek-v2-236b": {"n_repeats": 2}}
# the model check's MoE capacity factor: >= n_experts / top_k (160 / 6),
# so no assignment is dropped and prefill + decode equals the forward
DROPLESS_CF = 32.0
ROUTES = ("cuda_core", "tensor_core", "chunked")
# the host calls that put a kernel on the device, as the profiler names them
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
# path -> (prompt tokens, cache slots) of the model check
MODEL_CHECK = {"gemma3-1b": (1024, 2048), "mamba2-130m": (1000, 2048),
               "recurrentgemma-9b": (2100, 4096),
               "deepseek-v2-236b": (512, 1024)}
# micro models of the real plane: model -> {kernel: the route its serving
# run must launch}; any other launch fails the path.  attn-tiny runs the
# fp32 flash kernel (2 heads of head dim 16), the MLPs no kernel
MICRO_PATHS = {"mlp-tiny": {}, "mlp": {},
               "attn-tiny": {"flash_attention": "cuda_core"}}
ATTN_TINY_HD = (2, 16)            # attn-tiny's (heads, head dim)
MICRO_MLP = {"mlp-tiny": (32, 2), "mlp": (128, 4)}   # width, depth
MICRO_SECONDS, MICRO_UNITS, MICRO_BATCHES = 4.0, 4, (1, 256)
# serve_online: examples/serve_online.py's arguments, a shorter run
SERVE_ONLINE_ARGS = ["--arch", "gemma3-1b", "--duration", "8",
                     "--rate-step", "4", "--initial-batch", "8",
                     "--max-batch", "32"]
# (row, source, the TPU kernel it replaces): one row per kernel, and the
# flash kernel's CUDA-core route (flash_fwd_kernel, attn-tiny's path) in
# a row of its own; each row's launches are those of its headline's route
KERNEL_ROWS = (
    ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:89"),
    ("flash_attention/cuda_core",
     "src/repro_torch/kernels/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:89"),
    ("decode_attention", "src/repro_torch/kernels/csrc/decode_attention.cu",
     "src/repro/kernels/decode_attention.py:125"),
    ("ssd_scan", "src/repro_torch/kernels/csrc/ssd_scan.cu",
     "src/repro/kernels/ssd_scan.py:72"),
    ("rglru_scan", "src/repro_torch/kernels/csrc/rglru_scan.cu",
     "src/repro/kernels/rglru_scan.py:51"),
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build the kernels and run the kernels phase "
                         "only (a quick check after editing a kernel); "
                         "prints no final ok line")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    # kernel and plain versions are compared in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import KERNEL_STATS, build

    t0 = time.perf_counter()
    build_s = build.build_kernels()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Function properties for" in ln]
             for name, log in build.build_log.items()}
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas})

    kernels_rep = phase_kernels(torch)
    emit({"phase": "kernels", **kernels_rep})
    if args.kernels_only:
        return 0
    for name in PATHS:
        emit({"phase": "model", **phase_model(torch, name)})
    emit({"phase": "moe", **phase_moe(torch)})
    for name in PATHS:
        emit({"phase": "trace", **phase_trace(torch, name)})

    launches = {n: {} for n in KERNEL_STATS}
    by_path = {n: {} for n in KERNEL_STATS}
    for path, needed in PATHS.items():
        _reset_counts()
        serve_rep = phase_serve(torch, path)
        counts, cpu_calls = _counts()
        _free(torch)                  # the engine went with phase_serve
        serve_rep["launches_by_route"] = counts
        serve_rep["cpu_calls"] = cpu_calls
        emit({"phase": "serve", **serve_rep})
        _check_launches(path, counts, cpu_calls, needed)
        _tally(counts, path, launches, by_path)
    for name in MICRO_PATHS:
        micro_rep = phase_micro(torch, name)
        _tally(micro_rep["launches_by_route"], name, launches, by_path)
        emit({"phase": "micro", **micro_rep})
    emit({"phase": "launcher", **phase_launcher()})
    emit({"phase": "serve_online", **phase_serve_online(torch)})

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else "nvidia-smi: no output", flush=True)
    headline = kernels_rep["headline"]
    rows = []
    for name, source, replaces in KERNEL_ROWS:
        h = headline[name]
        kernel = name.split("/")[0]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": launches[kernel].get(h["route"], 0),
                     "launches_by_route": launches[kernel],
                     "launches_by_path": by_path[kernel],
                     "kernel_route": h["route"],
                     "max_abs_err": h["max_abs_err"], "ms": h["ms"],
                     "host_ms": h["host_ms"],
                     "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
                     "bound_by": h["bound_by"],
                     "library_ms": h["library_ms"], "shape": h["shape"],
                     "routes": h.get("routes", {})})
    emit({"kernels": rows})
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


# --------------------------------------------------------------------- #
# helpers
# --------------------------------------------------------------------- #
def _compare(torch, got, want, dtype_name):
    """Max abs error, and whether every element is finite and within
    ``atol + rtol * |want|`` (numpy's allclose rule)."""
    atol, rtol = TOL[dtype_name]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool(torch.isfinite(g).all()) and bool(
        (err <= atol + rtol * w.abs()).all())
    return float(err.max()), ok


@functools.lru_cache(maxsize=None)
def _cycles_per_ms(torch) -> float:
    """Clock cycles of ``torch.cuda._sleep`` per ms on this card, timed
    once with CUDA events."""
    torch.cuda._sleep(1000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 20_000_000
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    return cycles / start.elapsed_time(end)


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> dict:
    """Device time of one call (``ms``) and the host's time to issue one
    (``host_ms``).

    The host time is ``iters`` calls issued back to back on the host
    clock.  Then a sleep kernel at least twice that long is enqueued
    before the start event, and the same calls are issued again between
    two CUDA events: the whole batch is queued while the device sleeps,
    so the events time the device alone, not the host's cadence.  If the
    host still took longer than the sleep, the sleep doubles and the
    batch repeats (at most 3 times; ``covered`` says whether it held).
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sleep_ms = max(2.0 * host_ms, 1.0)
    for _ in range(3):
        torch.cuda._sleep(int(sleep_ms * _cycles_per_ms(torch)))
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        issued_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        covered = issued_ms < sleep_ms
        if covered:
            break
        sleep_ms = 2.0 * max(sleep_ms, issued_ms)
    return {"ms": start.elapsed_time(end) / iters, "host_ms": host_ms / iters,
            "covered": covered}


def kernel_breakdown(torch, fn, iters: int = 20) -> dict:
    """Device ms per call of each CUDA kernel ``fn`` launches, from
    ``torch.profiler`` over ``iters`` calls."""
    import collections
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            by_name[name.split("(")[0][:60]] += e.device_time_total / 1e3
    return {name: ms / iters for name, ms in by_name.most_common()}


def _bound(bytes_moved: float, flops: float, dtype_name: str):
    t_bytes = bytes_moved / MEM_BW
    t_ops = flops / PEAK[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _visible_pairs(S: int, window: int) -> int:
    """Causal (optionally windowed) query-key pairs of one head."""
    return sum(min(i + 1, window) if window else i + 1 for i in range(S))


def _config(name: str):
    """The registered configuration of a path, cut to one card (CUT)."""
    from repro_torch.configs import get_config
    return get_config(name).with_overrides(**CUT.get(name, {}))


def _free(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()


def _tally(counts, path, launches, by_path) -> None:
    """Add one path's launch counts (kernel -> route -> n) to the run's."""
    for name, by_route in counts.items():
        for r, n in by_route.items():
            launches[name][r] = launches[name].get(r, 0) + n
        if by_route:
            by_path[name][path] = by_route


def _check_launches(path, counts, cpu_calls, needed) -> None:
    """Every kernel of the path launched, each only on the route ``needed``
    names; no other kernel launched; no wrapper took its CPU route."""
    for name, by_route in counts.items():
        want = needed.get(name)
        if want is None and by_route:
            raise AssertionError(f"{path}: {name} launched, but the "
                                 f"path has no call of it: {by_route}")
        if want is not None and (by_route.get(want, 0) <= 0
                                 or set(by_route) != {want}):
            raise AssertionError(f"{path}: every {name} call must take "
                                 f"the {want} route, got {by_route}")
    for name, n in cpu_calls.items():
        if n != 0:
            raise AssertionError(f"{path}: {name} took its CPU route "
                                 "on the card")


def _counts():
    """The launch counts by route and the CPU-route calls of every kernel
    wrapper since the last reset."""
    from repro_torch.kernels import KERNEL_STATS
    return ({n: dict(s.launches_by_route) for n, s in KERNEL_STATS.items()},
            {n: s.cpu_calls for n, s in KERNEL_STATS.items()})


def _reset_counts() -> None:
    from repro_torch.kernels import KERNEL_STATS
    for stats in KERNEL_STATS.values():
        stats.reset()


# --------------------------------------------------------------------- #
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------- #
def phase_kernels(torch):
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as decode_mod
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as ssd_mod
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    cases = []
    oracle = []        # the fp32 plain versions' own distance from fp64

    def check(kind, shape, dtype_name, got, want, **extra):
        err, ok = _compare(torch, got, want, dtype_name)
        cases.append({"kernel": kind, "shape": shape, "dtype": dtype_name,
                      "max_abs_err": err, "ok": ok, **extra})
        return err

    def same_route(kind, shape, dtype_name, rule, auto, forced):
        """The C entry's choice by shape launches the same kernel as the
        Python rule: the outputs agree bit for bit."""
        ok = all(torch.equal(a, f) for a, f in zip(auto, forced))
        cases.append({"kernel": kind, "shape": shape, "dtype": dtype_name,
                      "check": f"by shape == forced {rule}", "ok": ok})

    def routes_for(rule):
        """Every route that takes a case: the CUDA-core kernels take every
        shape the wrapper accepts, the tensor cores those of the rule."""
        return (("cuda_core", "tensor_core") if rule == "tensor_core"
                else ("cuda_core",))

    # flash: tests/test_kernels.py grids, head dim 8, GQA groups 1, 2, 4,
    # 8 and 16, windows 16/48/100, one partial 64-row tile (S = 16, 32,
    # 48 after padding), and the serving shapes of gemma3-1b (4 heads on
    # 1) and recurrentgemma-9b (16 heads on 1, window 2048) at B = 1, 4
    flash = []
    for dt in TOL:
        for B, S, H, Hkv, D in ((1, 64, 4, 4, 32), (2, 128, 4, 2, 32),
                                (1, 96, 8, 1, 16), (2, 256, 2, 2, 64),
                                (2, 64, 2, 1, 8), (1, 80, 4, 2, 8),
                                (2, 128, 4, 1, 64), (1, 128, 16, 1, 64)):
            flash.append((dt, B, S, H, Hkv, D, 0, 32))
        for window in (16, 48, 100):
            flash.append((dt, 2, 128, 4, 1, 32, window, 32))
        for S in (16, 32, 48):
            flash.append((dt, 2, S, 4, 2, 32, 0, 16))
        for B in (1, 4):
            for S in (512, 1024):
                for window in (0, 512):
                    flash.append((dt, B, S, 4, 1, 256, window, 512))
            flash.append((dt, B, 512, 16, 1, 256, 2048, 512))
    # attn-tiny (the micro path): fp32, 2 heads of 16, its rungs' S = 16,
    # 8 and 4 (the wrapper pads 8 and 4 to 16), at B = 1, 16 and 256
    for B in (1, 16, 256):
        for S in (16, 8, 4):
            flash.append(("float32", B, S, 2, 2, 16, 0, 512))
    timings = {"flash_attention": [], "decode_attention": [],
               "ssd_scan": [], "rglru_scan": []}
    for dt, B, S, H, Hkv, D, window, blk in flash:
        dtype = getattr(torch, dt)
        q = randn((B, S, H, D), dtype)
        k = randn((B, S, Hkv, D), dtype)
        v = randn((B, S, Hkv, D), dtype)
        want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
        got = ops.flash_attention(q, k, v, causal=True, window=window,
                                  block_q=blk, block_kv=blk)
        torch.cuda.synchronize()
        shape = {"B": B, "S": S, "H": H, "Hkv": Hkv, "D": D,
                 "window": window}
        rule = flash_mod.route(dt, D)
        err = check("flash_attention", shape, dt, got, want, route=rule,
                    via="ops.flash_attention")
        forced, errs = {}, {}
        for r in routes_for(rule):
            forced[r] = flash_mod.launch(q, k, v, causal=True,
                                         window=window, force=r)
            torch.cuda.synchronize()
            errs[r] = check("flash_attention", shape, dt, forced[r], want,
                            route=r)
        same_route("flash_attention", shape, dt, rule,
                   [flash_mod.launch(q, k, v, causal=True, window=window)],
                   [forced[rule]])
        if D == 256 or (H, D) == ATTN_TINY_HD:
            qt = q.transpose(1, 2)
            kt = torch.repeat_interleave(k, H // Hkv, 2).transpose(1, 2)
            vt = torch.repeat_interleave(v, H // Hkv, 2).transpose(1, 2)
            if window:
                i = torch.arange(S, device=dev)
                mask = (i[None, :] <= i[:, None]) & \
                    (i[None, :] > i[:, None] - window)

                def lib():
                    F.scaled_dot_product_attention(qt, kt, vt,
                                                   attn_mask=mask)
            else:
                def lib():
                    F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True)
            elem = q.element_size()
            flops = 4.0 * D * B * H * _visible_pairs(S, window)
            nbytes = elem * (2 * B * S * H * D + 2 * B * S * Hkv * D)
            bound_ms, bound_by = _bound(nbytes, flops, dt)
            wrapper = time_ms(torch, lambda: ops.flash_attention(
                q, k, v, causal=True, window=window, block_q=blk,
                block_kv=blk))
            plain = time_ms(torch, lambda: ref.flash_attention_ref(
                q, k, v, causal=True, window=window))
            library = time_ms(torch, lib)
            timings["flash_attention"].append({
                "shape": shape, "dtype": dt, "route": rule,
                "max_abs_err": err, "ms": wrapper["ms"],
                "host_ms": wrapper["host_ms"], "covered": wrapper["covered"],
                "routes": {r: {"max_abs_err": errs[r], **time_ms(
                    torch, lambda r=r: flash_mod.launch(
                        q, k, v, causal=True, window=window, force=r))}
                    for r in routes_for(rule)},
                "library_kernels_ms": kernel_breakdown(torch, lib),
                "plain_ms": plain["ms"], "library_ms": library["ms"],
                "library_host_ms": library["host_ms"],
                "bound_ms": bound_ms, "bound_by": bound_by})

    # decode: tests/test_kernels.py grid (random lengths), lengths of 1,
    # one split, one split + 1 and S at GQA groups 1, 2, 4, 8 and 16, and
    # the serving shapes: gemma3-1b's global cache (S = 1024, 520 valid
    # rows, as the serve phase's decode steps leave it) and its ring
    # cache (S = 512, full) at B = 1, 4; recurrentgemma-9b (16 heads on
    # 1) at S = 1024, 520 valid, B = 1, 4; B = 8 with random lengths
    split = decode_mod.SPLIT_ROWS
    decode = []
    for dt in TOL:
        for B, S, H, Hkv, D in ((2, 128, 4, 2, 32), (1, 256, 8, 8, 64),
                                (3, 96, 4, 1, 16), (2, 64, 2, 1, 8)):
            decode.append((dt, B, S, H, Hkv, D, 32, None))
        edges = (1, split, split + 1)
        for H in (1, 2, 4, 8, 16):
            decode.append((dt, 4, 256, H, 1, 64, 256, edges + (256,)))
        decode.append((dt, 4, 1024, 16, 1, 256, 1024, edges + (1024,)))
        decode.append((dt, 4, 128, 8, 2, 16, 128, edges + (128,)))
        for B in (1, 8):
            for S in (512, 1024):
                decode.append((dt, B, S, 4, 1, 256, 1024, None))
        decode.append((dt, 4, 1024, 16, 1, 256, 1024, None))
        for B in (1, 4):
            decode.append((dt, B, 1024, 4, 1, 256, 1024, (520,) * B))
            decode.append((dt, B, 512, 4, 1, 256, 512, (512,) * B))
            decode.append((dt, B, 1024, 16, 1, 256, 1024, (520,) * B))
    for dt, B, S, H, Hkv, D, blk, lens in decode:
        dtype = getattr(torch, dt)
        q = randn((B, 1, H, D), dtype)
        kc = randn((B, S, Hkv, D), dtype)
        vc = randn((B, S, Hkv, D), dtype)
        if lens is None:
            lengths = torch.randint(1, S + 1, (B,), generator=gen,
                                    device=dev, dtype=torch.int32)
        else:
            lengths = torch.tensor(lens, device=dev, dtype=torch.int32)
        got = ops.decode_attention(q, kc, vc, lengths, block_kv=blk)
        want = ref.decode_attention_ref(q, kc, vc, lengths)
        torch.cuda.synchronize()
        shape = {"B": B, "S": S, "H": H, "Hkv": Hkv, "D": D,
                 "lengths": lengths.tolist()}
        rule = decode_mod.route(dt, D, H // Hkv)
        err = check("decode_attention", shape, dt, got, want, route=rule,
                    via="ops.decode_attention")
        forced, errs = {}, {}
        for r in routes_for(rule):
            forced[r] = decode_mod.launch(q, kc, vc, lengths, force=r)
            torch.cuda.synchronize()
            errs[r] = check("decode_attention", shape, dt, forced[r], want,
                            route=r)
        same_route("decode_attention", shape, dt, rule,
                   [decode_mod.launch(q, kc, vc, lengths)], [forced[rule]])
        if D == 256:
            qt = q.transpose(1, 2)
            kt = torch.repeat_interleave(kc, H // Hkv, 2).transpose(1, 2)
            vt = torch.repeat_interleave(vc, H // Hkv, 2).transpose(1, 2)
            mask = (torch.arange(S, device=dev)[None, :]
                    < lengths[:, None])[:, None, None, :]
            elem = q.element_size()
            total = int(lengths.sum())
            flops = 4.0 * D * H * total
            nbytes = elem * (2 * B * H * D + 2 * Hkv * D * total) + 4 * B
            bound_ms, bound_by = _bound(nbytes, flops, dt)
            wrapper = time_ms(torch, lambda: ops.decode_attention(
                q, kc, vc, lengths, block_kv=blk), iters=50)
            library = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask), iters=50)
            timings["decode_attention"].append({
                "shape": shape, "dtype": dt, "route": rule,
                "max_abs_err": err, "ms": wrapper["ms"],
                "host_ms": wrapper["host_ms"], "covered": wrapper["covered"],
                "routes": {r: {"max_abs_err": errs[r], **time_ms(
                    torch, lambda r=r: decode_mod.launch(
                        q, kc, vc, lengths, force=r), iters=50),
                    "device_kernels_ms": kernel_breakdown(
                        torch, lambda r=r: decode_mod.launch(
                            q, kc, vc, lengths, force=r))}
                    for r in routes_for(rule)},
                "plain_ms": time_ms(torch, lambda: ref.decode_attention_ref(
                    q, kc, vc, lengths), iters=50)["ms"],
                "library_ms": library["ms"],
                "library_host_ms": library["host_ms"],
                "bound_ms": bound_ms, "bound_by": bound_by})

    # SSD: tests/test_kernels.py grid, a grouped case with P = 16 (the
    # tensor cores take it), one chunk (S = chunk), and mamba2-130m's
    # serving shape at B = 1, 4; the plain version is the sequential
    # recurrence, y and the final state (evaluated in fp64 for fp32)
    for dt in TOL:
        for B, S, H, P, G, N, Q in ((1, 64, 2, 8, 1, 16, 16),
                                    (2, 128, 4, 16, 1, 32, 32),
                                    (1, 64, 4, 8, 2, 16, 16),
                                    (1, 64, 4, 16, 2, 16, 16),
                                    (2, 64, 4, 16, 1, 32, 64),
                                    (1, 512, 24, 64, 1, 128, 64),
                                    (4, 512, 24, 64, 1, 128, 64)):
            dtype = getattr(torch, dt)
            x = randn((B, S, H, P), dtype)
            dts = F.softplus(randn((B, S, H), torch.float32))
            a_log = torch.log(torch.linspace(1.0, 4.0, H, device=dev))
            B_in = randn((B, S, G, N), dtype)
            C_in = randn((B, S, G, N), dtype)
            args = (x, dts, a_log, B_in, C_in)
            shape = {"B": B, "S": S, "H": H, "P": P, "G": G, "N": N,
                     "chunk": Q}
            want_y, want_h = ref.ssd_scan_ref(*args)
            if dt == "float32":
                # fp32 is held against the recurrence in fp64: at B = 4,
                # S = 512 the recurrence in fp32 strays up to ~1e-4 from
                # it (its distance is reported beside), past what 2e-5
                # allows
                plain_y, plain_h = want_y, want_h
                want_y, want_h = ref.ssd_scan_ref(
                    *(t.double() for t in args))
                oracle.append({"kernel": "ssd_scan", "shape": shape,
                               "plain_fp32_vs_fp64": {
                                   "y": _compare(torch, plain_y, want_y,
                                                 dt),
                                   "state": _compare(torch, plain_h,
                                                     want_h, dt)}})
            y, h = ops.ssd_scan(*args, chunk=Q)
            torch.cuda.synchronize()
            rule = ssd_mod.route(dt, P, N, Q)
            err = check("ssd_scan", shape, dt, y, want_y, output="y",
                        route=rule, via="ops.ssd_scan")
            err_h = check("ssd_scan", shape, dt, h, want_h, output="state",
                          route=rule, via="ops.ssd_scan")
            forced, errs = {}, {}
            for r in routes_for(rule):
                forced[r] = ssd_mod.launch(*args, chunk=Q, force=r)
                torch.cuda.synchronize()
                errs[r] = {
                    "y": check("ssd_scan", shape, dt, forced[r][0], want_y,
                               output="y", route=r),
                    "state": check("ssd_scan", shape, dt, forced[r][1],
                                   want_h, output="state", route=r)}
            same_route("ssd_scan", shape, dt, rule,
                       ssd_mod.launch(*args, chunk=Q), forced[rule])
            if S == 512:
                elem = x.element_size()
                nbytes = (elem * (2 * B * S * H * P + 2 * B * S * G * N)
                          + 4 * (B * S * H + H + B * H * P * N))
                flops = (2.0 * (Q * Q * N + Q * Q * P + 2 * Q * N * P)
                         * B * H * (S // Q))
                bound_ms, bound_by = _bound(nbytes, flops, dt)
                wrapper = time_ms(torch, lambda: ops.ssd_scan(
                    *args, chunk=Q), iters=50)
                timings["ssd_scan"].append({
                    "shape": shape, "dtype": dt, "route": rule,
                    "max_abs_err": max(err, err_h), "max_abs_err_y": err,
                    "max_abs_err_state": err_h, "ms": wrapper["ms"],
                    "host_ms": wrapper["host_ms"],
                    "covered": wrapper["covered"],
                    "routes": {r: {"max_abs_err": errs[r], **time_ms(
                        torch, lambda r=r: ssd_mod.launch(
                            *args, chunk=Q, force=r), iters=50)}
                        for r in routes_for(rule)},
                    "device_kernels_ms": kernel_breakdown(
                        torch, lambda: ops.ssd_scan(*args, chunk=Q)),
                    "plain_ms": time_ms(torch, lambda: ref.ssd_scan_ref(
                        *args), iters=3, warmup=1)["ms"],
                    "library_ms": None,
                    "bound_ms": bound_ms, "bound_by": bound_by})

    # RG-LRU: tests/test_kernels.py grid, S of 1 and 7 (inside one
    # chunk), a partial last chunk (S = 97) and group (S = 520), partial
    # 32-column tiles (W = 48, 100), and recurrentgemma-9b's serving shape
    # at B = 1, 4.  a in (0, 1), mostly 0.8-1 as Griffin's gates make it
    # (a^c in [0.9, 0.999] at init), so carries across chunks matter.  The
    # main path's dtype is fp32
    for dt in TOL:
        for B, S, W in ((1, 64, 16), (2, 128, 48), (1, 96, 32),
                        (1, 1, 48), (2, 7, 100), (2, 97, 48), (1, 97, 100),
                        (2, 520, 100), (1, 520, 48),
                        (1, 512, 4096), (4, 512, 4096)):
            dtype = getattr(torch, dt)
            a = torch.sigmoid(randn((B, S, W), torch.float32) + 3.0).to(
                dtype)
            b = randn((B, S, W), dtype)
            h = ops.rglru_scan(a, b)
            want, want_final = ref.rglru_scan_ref(a, b)
            torch.cuda.synchronize()
            shape = {"B": B, "S": S, "W": W}
            err = check("rglru_scan", shape, dt, h, want, route="chunked",
                        via="ops.rglru_scan")
            check("rglru_scan", shape, dt, h[:, -1], want_final,
                  output="final state", route="chunked", via="ops.rglru_scan")
            if W == 4096:
                elem = a.element_size()
                nbytes = 2 * elem * B * S * W + 4 * B * S * W
                bound_ms, bound_by = _bound(nbytes, 2.0 * B * S * W, dt)
                wrapper = time_ms(torch, lambda: ops.rglru_scan(a, b),
                                  iters=50)
                timings["rglru_scan"].append({
                    "shape": shape, "dtype": dt, "route": "chunked",
                    "max_abs_err": err, "ms": wrapper["ms"],
                    "host_ms": wrapper["host_ms"],
                    "covered": wrapper["covered"],
                    "plain_ms": time_ms(torch, lambda: ref.rglru_scan_ref(
                        a, b), iters=5, warmup=1)["ms"],
                    "library_ms": None,
                    "bound_ms": bound_ms, "bound_by": bound_by})

    failed = [c for c in cases if not c["ok"]]
    # headline: the serving phase's largest cells in the dtype its calls
    # pass — a 512-token bf16 prefill at b=4, a bf16 decode step at b=4
    # against gemma3-1b's 1024-slot global cache with 520 valid rows, the
    # bf16 SSD scan and the fp32 RG-LRU scan (the gates' output) at b=4
    # over a 512-token prompt
    headline = {
        "flash_attention": next(
            t for t in timings["flash_attention"]
            if t["dtype"] == "bfloat16" and t["shape"]["B"] == 4
            and t["shape"]["S"] == 512 and t["shape"]["H"] == 4
            and t["shape"]["window"] == 0),
        # attn-tiny's largest serving cell: the CUDA-core route's path
        "flash_attention/cuda_core": next(
            t for t in timings["flash_attention"]
            if t["dtype"] == "float32" and t["shape"]["B"] == 256
            and t["shape"]["S"] == 16
            and (t["shape"]["H"], t["shape"]["D"]) == ATTN_TINY_HD),
        "decode_attention": next(
            t for t in timings["decode_attention"]
            if t["dtype"] == "bfloat16" and t["shape"]["B"] == 4
            and t["shape"]["S"] == 1024 and t["shape"]["H"] == 4
            and t["shape"]["lengths"] == [520] * 4),
        "ssd_scan": next(t for t in timings["ssd_scan"]
                         if t["dtype"] == "bfloat16"
                         and t["shape"]["B"] == 4),
        "rglru_scan": next(t for t in timings["rglru_scan"]
                           if t["dtype"] == "float32"
                           and t["shape"]["B"] == 4),
    }
    rep = {"cases": len(cases), "failed": failed, "oracle": oracle,
           "max_abs_err": {f"{k}/{dt}/{r}": max(
               c["max_abs_err"] for c in cases if c["kernel"] == k
               and c["dtype"] == dt and c.get("route") == r
               and "max_abs_err" in c)
               for k in timings for dt in TOL
               for r in ROUTES
               if any(c["kernel"] == k and c["dtype"] == dt
                      and c.get("route") == r for c in cases)},
           "tolerance": {dt: {"atol": a, "rtol": r}
                         for dt, (a, r) in TOL.items()},
           "sleep_cycles_per_ms": _cycles_per_ms(torch),
           "timings": timings, "headline": headline}
    if failed:
        emit({"phase": "kernels", **rep})
        raise AssertionError(f"{len(failed)} kernel cases out of tolerance")
    return rep


# --------------------------------------------------------------------- #
# phase 3: full-width models, kernels vs the plain path
# --------------------------------------------------------------------- #
def phase_model(torch, name: str):
    if not PATHS[name]:
        return _model_check_incremental(torch, name)
    from repro_torch.models.lm import decode_step, init_params, prefill
    dev = torch.device("cuda")
    base = _config(name)
    S, max_len = MODEL_CHECK[name]
    n_dec = 8
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, base.vocab_size, (1, S + n_dec),
                           generator=gen).to(dev)

    def run(cfg, params):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": tokens[:, :S]}, cfg,
                                max_len=max_len)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        outs = [logits[:, 0]]
        t0 = time.perf_counter()
        for i in range(S, S + n_dec):
            logits, cache = decode_step(params, cache, tokens[:, i:i + 1],
                                        i, cfg)
            outs.append(logits[:, 0])
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / n_dec
        return torch.stack(outs), prefill_ms, decode_ms

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    rep = {"config": name, "layers": base.n_layers, "prompt": S,
           "decode_steps": n_dec, "max_len": max_len}
    with torch.no_grad():
        cfg = base.with_overrides(dtype="float32", use_pallas_kernels=True)
        params = init_params(cfg, 0, device=dev)
        k32, _, _ = run(cfg, params)
        p32, _, _ = run(cfg.with_overrides(use_pallas_kernels=False), params)
        del params
        _free(torch)
        err32 = rel(k32, p32)
        rep["fp32"] = {"rel_err": err32, "tolerance": 1e-3,
                       "finite": bool(torch.isfinite(k32).all())}

        cfg = base.with_overrides(use_pallas_kernels=True)       # bf16
        params = init_params(cfg, 0, device=dev)
        k16, _, _ = run(cfg, params)
        plain = cfg.with_overrides(use_pallas_kernels=False)
        p16, _, _ = run(plain, params)
        # second runs are the timed ones (the first pays cuBLAS set-up)
        _, k_pre, k_dec = run(cfg, params)
        _, p_pre, p_dec = run(plain, params)
        del params
        _free(torch)
    err_k, err_p = rel(k16, p32), rel(p16, p32)
    tol16 = max(2.0 * err_p, 2e-2)
    rep["bf16"] = {"rel_err_kernels_vs_fp32": err_k,
                   "rel_err_plain_vs_fp32": err_p,
                   "rel_err_kernels_vs_plain": rel(k16, p16),
                   "tolerance": tol16,
                   "finite": bool(torch.isfinite(k16).all()),
                   "prefill_ms": {"kernels": k_pre, "plain": p_pre},
                   "decode_step_ms": {"kernels": k_dec, "plain": p_dec}}
    if not (rep["fp32"]["finite"] and err32 <= 1e-3):
        emit({"phase": "model", **rep})
        raise AssertionError(f"{name}: fp32 logits differ: {err32}")
    if not (rep["bf16"]["finite"] and err_k <= tol16):
        emit({"phase": "model", **rep})
        raise AssertionError(f"{name}: bf16 logits differ: {err_k} > "
                             f"{tol16}")
    return rep


def _model_check_incremental(torch, name: str):
    """A path with no kernel: prefill + decode steps (the absorbed latent
    decode) against a full-sequence forward (expanded attention) over the
    same tokens, in fp32 and in bf16, on a dropless MoE."""
    import dataclasses
    from repro_torch.models.lm import (apply_head, decode_step, forward,
                                       init_params, param_count, prefill)
    dev = torch.device("cuda")
    published = _config(name)
    base = published.with_overrides(moe=dataclasses.replace(
        published.moe, capacity_factor=DROPLESS_CF))
    S, max_len = MODEL_CHECK[name]
    n_dec = 8
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, base.vocab_size, (1, S + n_dec),
                           generator=gen).to(dev)

    def run(cfg, params):
        """(forward logits, incremental logits) at positions S-1..S+7,
        and the incremental path's prefill ms and ms per decode step."""
        hidden = forward(params, {"tokens": tokens}, cfg)
        full = apply_head(params, hidden[:, S - 1:], cfg)[0]
        del hidden
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": tokens[:, :S]}, cfg,
                                max_len=max_len)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        outs = [logits[0, 0]]
        t0 = time.perf_counter()
        for i in range(S, S + n_dec):
            logits, cache = decode_step(params, cache, tokens[:, i:i + 1],
                                        i, cfg)
            outs.append(logits[0, 0])
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / n_dec
        return full, torch.stack(outs), prefill_ms, decode_ms

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    rep = {"config": name, "cut": CUT.get(name, {}), "layers": base.n_layers,
           "check": "prefill + decode vs forward",
           "capacity_factor_override": DROPLESS_CF, "prompt": S,
           "decode_steps": n_dec, "max_len": max_len}
    print(f"chip_smoke: {name} model check: MoE capacity_factor "
          f"{published.moe.capacity_factor} -> {DROPLESS_CF} (dropless)",
          flush=True)
    with torch.no_grad():
        cfg = base.with_overrides(dtype="float32")
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, 0, device=dev)
        rep["params"] = param_count(params)
        f32, i32, _, _ = run(cfg, params)
        rep["fp32_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del params
        _free(torch)
        err32 = rel(i32, f32)
        rep["fp32"] = {"rel_err": err32, "tolerance": 1e-3,
                       "finite": bool(torch.isfinite(i32).all())}

        cfg = base                                               # bf16
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, 0, device=dev)
        f16, i16, _, _ = run(cfg, params)
        # the second run is the timed one (the first pays cuBLAS set-up)
        _, _, pre_ms, dec_ms = run(cfg, params)
        rep["bf16_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del params
        _free(torch)
    err_i, err_f = rel(i16, f32), rel(f16, f32)
    tol16 = max(2.0 * err_f, 2e-2)
    rep["bf16"] = {"rel_err_incremental_vs_fp32": err_i,
                   "rel_err_forward_vs_fp32": err_f,
                   "rel_err_incremental_vs_forward": rel(i16, f16),
                   "tolerance": tol16,
                   "finite": bool(torch.isfinite(i16).all()),
                   "prefill_ms": pre_ms, "decode_step_ms": dec_ms}
    if not (rep["fp32"]["finite"] and err32 <= 1e-3):
        emit({"phase": "model", **rep})
        raise AssertionError(f"{name}: fp32 prefill + decode differs from "
                             f"the forward: {err32}")
    if not (rep["bf16"]["finite"] and err_i <= tol16):
        emit({"phase": "model", **rep})
        raise AssertionError(f"{name}: bf16 prefill + decode differs: "
                             f"{err_i} > {tol16}")
    return rep


def phase_moe(torch, name: str = "deepseek-v2-236b"):
    """The MoE layer at full width and its published capacity factor:
    dispatch on the card equals the CPU's, ``apply_moe`` repeats bit for
    bit, and its device time beside the card's bound."""
    from repro_torch.models.moe import (apply_moe, capacity, init_moe,
                                        moe_dispatch_indices, router_probs)
    dev = torch.device("cuda")
    cfg = _config(name)                                          # bf16
    moe, d, ff = cfg.moe, cfg.d_model, cfg.moe.expert_ff
    E, k = moe.n_experts, moe.top_k
    gen = torch.Generator().manual_seed(4)
    rep = {"config": name, "capacity_factor": moe.capacity_factor,
           "dispatch": {}, "apply": {}}
    failures = []
    with torch.no_grad():
        params = init_moe(torch.Generator(device=dev).manual_seed(3), cfg,
                          torch.bfloat16)
        # the serve prefill's token count; the same tokens pushed toward
        # expert 0, which then takes every token and drops all but its
        # capacity; a B = 4 decode step
        router_0 = params["router"][:, 0] / params["router"][:, 0].norm()
        for case, T, push in (("2048", 2048, 0.0),
                              ("2048-skewed", 2048, 10.0), ("4", 4, 0.0)):
            x = torch.randn((T, d), generator=gen).to(dev)
            x = (x + push * router_0).to(torch.bfloat16)
            gates, experts = router_probs(params, x, moe)
            cap = capacity(T, moe)
            idx, slot_gate = moe_dispatch_indices(experts, gates, E, cap)
            idx_c, gate_c = moe_dispatch_indices(experts.cpu(), gates.cpu(),
                                                 E, cap)
            equal = bool(torch.equal(idx.cpu(), idx_c)
                         and torch.equal(slot_gate.cpu(), gate_c))
            dropped = T * k - int((idx_c < T).sum())
            rep["dispatch"][case] = {"tokens": T, "capacity": cap,
                                       "assignments": T * k,
                                       "dropped": dropped, "equal": equal}
            print(f"chip_smoke: moe dispatch {case} capacity={cap}: "
                  f"{dropped} of {T * k} assignments dropped", flush=True)
            if not equal:
                failures.append(f"dispatch {case} differs from the CPU's")
        if rep["dispatch"]["2048-skewed"]["dropped"] <= 0:
            failures.append("the skewed tokens dropped nothing")
        expert_bytes = 3 * d * ff * 2                  # one expert, bf16
        shared_bytes = 3 * d * ff * moe.n_shared * 2 + d * E * 4
        for label, (B, S) in (("prefill", (4, 512)), ("decode", (4, 1))):
            T = B * S
            x = torch.randn((B, S, d), generator=gen).to(dev, torch.bfloat16)
            a, b = apply_moe(params, x, cfg), apply_moe(params, x, cfg)
            identical = bool(torch.equal(a, b))
            if not (identical and torch.isfinite(a).all()):
                failures.append(f"apply_moe at {label} is not repeatable "
                                "or not finite")
            t = time_ms(torch, lambda: apply_moe(params, x, cfg), iters=10)
            _, experts = router_probs(params, x.reshape(T, d), moe)
            cap = capacity(T, moe)
            idx, _ = moe_dispatch_indices(experts, torch.ones_like(
                experts, dtype=torch.float32), E, cap)
            kept = int((idx < T).sum())
            hit = int(((idx < T).sum(1) > 0).sum())
            # the least work for these tokens: the experts they reach,
            # read once, and their kept assignments' GLUs
            bytes_moved = (hit * expert_bytes + shared_bytes
                           + 2 * T * d * 2)
            flops = 6 * d * ff * (kept + T * moe.n_shared) + 2 * T * d * E
            bound_ms, bound_by = _bound(bytes_moved, flops, "bfloat16")
            rep["apply"][label] = {
                "tokens": T, "capacity": cap, "experts_hit": hit,
                "bit_identical": identical, **t, "bound_ms": bound_ms,
                "bound_by": bound_by,
                # capacity tiles run every expert: their weights alone
                "all_experts_read_ms": E * expert_bytes / MEM_BW * 1e3}
        del params
        _free(torch)
    if failures:
        emit({"phase": "moe", **rep})
        raise AssertionError(f"{name}: " + "; ".join(failures))
    return rep


# --------------------------------------------------------------------- #
# phase 4: host vs device time of a full-width step
# --------------------------------------------------------------------- #
def _trace_report(prof, wall_ms, enqueue_ms, steps):
    """``wall_ms``/``enqueue_ms`` come from an untraced run of the same
    steps; device time, launches and the host's time inside PyTorch
    operators (self time, so nested operators count once; the rest of
    the enqueue time is Python between them) from the traced one."""
    import collections
    from torch.autograd import DeviceType
    by_name = collections.Counter()
    host_ops = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name[:80]] += e.device_time_total / 1e3
        else:
            host_ops[e.name[:80]] += e.self_cpu_time_total / 1e3
    busy_ms = sum(by_name.values())
    # cuBLAS launches its GEMMs through cudaLaunchKernelExC
    launches = sum(1 for e in prof.events() if e.name in LAUNCH_CALLS)
    return {"wall_ms_per_step": wall_ms / steps,
            "host_enqueue_ms_per_step": enqueue_ms / steps,
            "device_busy_ms_per_step": busy_ms / steps,
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "launches_per_step": launches / steps,
            "top_kernels_ms_per_step": {
                name: ms / steps
                for name, ms in by_name.most_common(TRACE_TOP)},
            "host_op_self_ms_per_step": sum(host_ops.values()) / steps,
            "top_host_ops_ms_per_step": {
                name: ms / steps
                for name, ms in host_ops.most_common(TRACE_TOP)}}


def phase_trace(torch, name: str):
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.lm import decode_step, init_params, prefill
    dev = torch.device("cuda")
    cfg = _config(name).with_overrides(use_pallas_kernels=True)  # bf16
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size,
                           (1, TRACE_PROMPT + TRACE_DECODE),
                           generator=gen).to(dev)

    def run_prefill():
        return prefill(params, {"tokens": tokens[:, :TRACE_PROMPT]}, cfg,
                       max_len=TRACE_MAX_LEN)

    def run_decode(cache):
        for i in range(TRACE_PROMPT, TRACE_PROMPT + TRACE_DECODE):
            decode_step(params, cache, tokens[:, i:i + 1], i, cfg)

    def traced(fn, steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        enqueue = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return _trace_report(prof, wall * 1e3, enqueue * 1e3, steps)

    with torch.no_grad():
        params = init_params(cfg, 0, device=dev)
        for _ in range(2):                      # warm-up: cuBLAS, allocator
            _, cache = run_prefill()
            run_decode(cache)
        rep_prefill = traced(run_prefill, 1)
        # decode positions repeat across the two runs: the caches are
        # rewritten in place at the same slots (a recurrent state moves
        # on, which changes no shape and no launch)
        _, cache = run_prefill()
        rep_decode = traced(lambda: run_decode(cache), TRACE_DECODE)
        del params, cache
        _free(torch)
    if rep_prefill["device_busy_ms_per_step"] <= 0 or \
            rep_decode["device_busy_ms_per_step"] <= 0:
        raise AssertionError(f"{name}: the trace saw no device time")
    return {"config": name, "dtype": cfg.dtype, "batch": 1,
            "prompt": TRACE_PROMPT, "decode_steps": TRACE_DECODE,
            "prefill": rep_prefill, "decode": rep_decode}


# --------------------------------------------------------------------- #
# phase 5: the main path — serve through RealPlane
# --------------------------------------------------------------------- #
def phase_serve(torch, name: str):
    from repro_torch.core.knapsack import PackratOptimizer
    from repro_torch.core.profiler import ProfileSpec, phase_profiles
    from repro_torch.launch.bench_serving import (REAL_DRAIN_FACTOR,
                                                  _cap_rate, run_lm_policy)
    from repro_torch.models.serve_lm import (PHASE_DECODE, PHASE_PREFILL,
                                             PHASES, LmEngine)
    from repro_torch.serving import RealPlane
    from repro_torch.serving.scenarios import ScenarioContext, get_scenario
    units, max_batch, decode_steps, seed = 4, 4, 8, 0
    cfg = _config(name).with_overrides(use_pallas_kernels=True)   # bf16
    t0 = time.perf_counter()
    engine = LmEngine(cfg, seed=seed, max_seq=1024, default_seq_bucket=512)
    engine_s = time.perf_counter() - t0
    factory = engine.factory()
    prof_plane = RealPlane(factory, units)
    profiles = phase_profiles(
        prof_plane, ProfileSpec(units, max_batch, thread_values=(1, 2, 4)),
        PHASES, warmup=1, iters=3)
    profile_cells = prof_plane.runner_report()
    prof_plane.close()
    # the drain (REAL_DRAIN_FACTOR of the trace) must outlast a prompt's
    # whole chain: a prefill and its decode steps, each waiting up to the
    # dispatcher's coalesce window of four step times
    step_s = max(profiles[p][(units, 1)] for p in PHASES)
    chain_s = (1 + decode_steps) * 5.0 * step_s
    duration = max(SERVE_SECONDS, 1.25 * chain_s / REAL_DRAIN_FACTOR)
    opt = PackratOptimizer(profiles[PHASE_PREFILL])
    ctx = ScenarioContext(threads=units, optimizer=opt, duration=duration,
                          seed=seed, max_total_batch=units * max_batch)
    arrivals = get_scenario("steady-poisson").build(ctx).arrivals(
        duration, seed=seed)
    serial = (profiles[PHASE_PREFILL][(units, 1)]
              + decode_steps * profiles[PHASE_DECODE][(units, 1)])
    arrivals, capped = _cap_rate(arrivals, duration,
                                 min(300.0, 0.5 / max(serial, 1e-9)))
    b0 = max_batch
    slo = {p: 4.0 * profiles[p][(units, b0)] for p in PHASES}
    rep = {"config": name, "dtype": cfg.dtype, "layers": cfg.n_layers,
           "units": units, "max_batch": max_batch,
           "decode_steps": decode_steps, "duration_s": duration,
           "offered_prompts": len(arrivals), "rate_capped": capped,
           "engine_build_s": engine_s,
           "kernel_build_s": engine.kernel_build_s,
           "measured_profile_ms": {
               p: {f"{t},{b}": lat * 1e3
                   for (t, b), lat in sorted(profiles[p].items())}
               for p in PHASES},
           "profile_cells_compile_ms": profile_cells["compile_ms"],
           "policies": {}}
    for policy in ("static", "packrat"):
        r = run_lm_policy(policy, arrivals, factory=factory,
                          profiles=profiles, units=units, duration=duration,
                          initial_batch=b0, max_batch=max_batch,
                          decode_steps=decode_steps, slo_by_phase=slo,
                          reconfigure_timeout=2.0, dispatch="continuous",
                          real_model=name)
        done = r["phases"]
        rep["policies"][policy] = {
            "completed_prompts": done[PHASE_PREFILL]["completed"],
            "completed_decode_steps": done[PHASE_DECODE]["completed"],
            "incomplete": r["incomplete"],
            "ttft_ms": {q: r["ttft_ms"][q] for q in ("p50", "p95")},
            "tpot_ms": {q: r["tpot_ms"][q] for q in ("p50", "p95")},
            "unit_split": r["unit_split"],
            "reconfigurations": {p: r["servers"][p]["reconfigurations"]
                                 for p in PHASES},
            "compile_ms": r["runner_cache"]["compile_ms"]}
        if (done[PHASE_PREFILL]["completed"] != len(arrivals)
                or done[PHASE_DECODE]["completed"]
                != len(arrivals) * decode_steps or r["incomplete"]):
            emit({"phase": "serve", **rep})
            raise AssertionError(f"{name}, {policy}: not every prompt "
                                 "completed")
    return rep


# --------------------------------------------------------------------- #
# phase 6: the micro models through the launcher's real path
# --------------------------------------------------------------------- #
def phase_micro(torch, name: str):
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.bench_serving import (DISPATCHES, POLICIES,
                                                  policy_key,
                                                  run_real_scenario)
    from repro_torch.models import micro
    from repro_torch.serving.scenarios import get_scenario
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(3)
    # the card's step against the CPU plain step, same weights and inputs
    b = max(MICRO_BATCHES)
    if name == "attn-tiny":
        cpu_in = [torch.randn((b, 16, *ATTN_TINY_HD), generator=gen)
                  for _ in range(3)]
        want = micro.attn_step(*cpu_in)
        card_in = [t.to(dev) for t in cpu_in]
        got = micro.attn_step(*card_in)
    else:
        dim, depth = MICRO_MLP[name]
        params = micro.init_mlp_params(dim, depth, 0, "cpu")
        x = torch.randn((b, dim), generator=gen)
        want = micro.mlp_step(x, params)
        got = micro.mlp_step(x.to(dev), [(w.to(dev), c.to(dev))
                                         for w, c in params])
    torch.cuda.synchronize()
    err, ok = _compare(torch, got.cpu(), want, "float32")
    rep = {"model": name, "step_check": {
        "batch": b, "max_abs_err": err, "ok": ok,
        "tolerance": dict(zip(("atol", "rtol"), TOL["float32"]))}}
    if not ok:
        emit({"phase": "micro", **rep})
        raise AssertionError(f"{name}: the card's step differs from the "
                             f"CPU's: {err}")

    # one step through the runner, traced: wall per step (the runner
    # waits for its stream), the host's time to enqueue the bare step,
    # device busy time, idle share and launches, at b = 1 and 256
    make_runner = micro.make_micro_runner(name)
    steps = 50
    rep["trace"] = {}
    for bt in MICRO_BATCHES:
        if name == "attn-tiny":
            xs = [torch.randn((bt, 16, *ATTN_TINY_HD), generator=gen).to(dev)
                  for _ in range(3)]

            def step():
                micro.attn_step(*xs)
        else:
            w_dev = [(w.to(dev), c.to(dev)) for w, c in params]
            x_dev = torch.ones((bt, MICRO_MLP[name][0]), device=dev)

            def step():
                micro.mlp_step(x_dev, w_dev)
        run = make_runner(MICRO_UNITS, bt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        enqueue = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        wall = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                run()
            torch.cuda.synchronize()
        rep["trace"][str(bt)] = _trace_report(prof, wall, enqueue, steps)
        if rep["trace"][str(bt)]["device_busy_ms_per_step"] <= 0:
            raise AssertionError(f"{name}: the trace saw no device time")
    del make_runner, run

    # the main path: the launcher's real micro scenario, both policies x
    # both dispatches, counts reset just before and read just after
    _reset_counts()
    t0 = time.perf_counter()
    sc = run_real_scenario(
        get_scenario("steady-poisson"), real_model=name, units=MICRO_UNITS,
        duration=MICRO_SECONDS, seed=0, initial_batch=8, max_batch=256,
        slo_factor=4.0, reconfigure_timeout=1.0, dispatches=DISPATCHES,
        rate_cap=300.0, device="cuda")
    counts, cpu_calls = _counts()
    rep["serve_s"] = time.perf_counter() - t0
    rep["launches_by_route"] = counts
    rep["cpu_calls"] = cpu_calls
    profile_ms = sc["measured_profile_ms"]
    rep.update({"offered": sc["offered"], "rate_capped": sc["rate_capped"],
                "duration_s": MICRO_SECONDS, "units": MICRO_UNITS,
                "max_batch": 256, "slo_deadline_ms": sc["slo_deadline_ms"],
                "measured_profile_ms": {
                    cell: profile_ms[cell] for cell in
                    ("1,1", "4,1", "1,16", "4,16", "1,256", "4,256")},
                "profile_cells": len(profile_ms), "policies": {}})
    failed = []
    for policy in POLICIES:
        for dispatch in DISPATCHES:
            key = policy_key(policy, dispatch)
            r = sc[key]
            rep["policies"][key] = {
                "completed": r["completed"], "incomplete": r["incomplete"],
                "latency_ms": {q: r["latency_ms"][q]
                               for q in ("p50", "p95", "p99")},
                "reconfigurations": r["reconfigurations"],
                "final_config": r["final_config"],
                "calibration_ratio": r["calibration"]["global_ratio"],
                "optimizer_refreshes":
                    r["calibration"]["optimizer_refreshes"]}
            if r["completed"] != sc["offered"] or r["incomplete"]:
                failed.append(key)
    if failed:
        emit({"phase": "micro", **rep})
        raise AssertionError(f"{name}: not every request completed under "
                             f"{failed}")
    _check_launches(name, counts, cpu_calls, MICRO_PATHS[name])
    return rep


# --------------------------------------------------------------------- #
# phase 7: the launcher's simulated plane runs here, deterministically
# --------------------------------------------------------------------- #
def phase_launcher():
    import contextlib
    import io
    from repro_torch.launch import bench_serving
    argv = ["--execution", "fast", "--scenario", "step-up",
            "--duration", "20"]
    reports = []
    t0 = time.perf_counter()
    for _ in range(2):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            if bench_serving.main(argv) != 0:
                raise AssertionError("launcher: bench_serving failed")
        reports.append(out.getvalue())
    if reports[0] != reports[1]:
        raise AssertionError("launcher: two runs gave different reports")
    sc = json.loads(reports[0])["scenarios"]["step-up"]
    return {"argv": argv, "identical": True, "bytes": len(reports[0]),
            "seconds": time.perf_counter() - t0, "offered": sc["offered"],
            "p95_ms": {k: sc[k]["latency_ms"]["p95"]
                       for k in sc["policies"]}}


# --------------------------------------------------------------------- #
# phase 8: the serving launcher (examples/serve_online.py) on the card
# --------------------------------------------------------------------- #
def phase_serve_online(torch):
    import contextlib
    import io
    import re
    from repro_torch.launch import serve
    out = io.StringIO()
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = serve.main(SERVE_ONLINE_ARGS)
    seconds = time.perf_counter() - t0
    counts, cpu_calls = _counts()
    lines = out.getvalue().strip().splitlines()
    for ln in lines:
        print(ln, flush=True)
    m = re.match(r"\[serve\] arch=\S+ requests=(\d+) completed=(\d+)",
                 lines[0] if lines else "")
    rep = {"argv": SERVE_ONLINE_ARGS, "seconds": seconds,
           "requests": int(m.group(1)) if m else None,
           "completed": int(m.group(2)) if m else None,
           "latency": next((ln for ln in lines if "latency" in ln), None),
           "reconfigurations": sum("reconfig" in ln for ln in lines) - 1,
           "launches_by_route": counts, "cpu_calls": cpu_calls}
    if rc != 0 or m is None or rep["requests"] != rep["completed"]:
        emit({"phase": "serve_online", **rep})
        raise AssertionError("serve_online: not every request completed")
    # reduced configs keep use_pallas_kernels off, as in the reference
    _check_launches("serve_online", counts, cpu_calls, {})
    return rep


if __name__ == "__main__":
    sys.exit(main())
