#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA device, ``nvcc`` (``/usr/local/cuda`` or ``CUDA_HOME``) and no
network.  Phases, each printing one JSON line; any failure raises and the
script exits non-zero:

1. **build** — compile the CUDA kernels from ``src/repro_torch/kernels/
   csrc`` (one ``nvcc`` per source, in parallel) into ``build/kernels``.
2. **kernels** — each kernel against its plain PyTorch version on the
   card, fp32 and bf16: the shape grids of ``tests/test_kernels.py``,
   head dim 8, and the serving shapes of full-width gemma3-1b (D = 256,
   4 query heads on 1 KV head).  Tolerances are ``tests/test_kernels.py``'s
   (atol = rtol = 2e-5 fp32, 2e-2 bf16).  Times at the serving shapes:
   the kernel, its plain version, one PyTorch library call computing the
   same function (``scaled_dot_product_attention``, a yardstick the port
   never calls) and the card's bound for the work.
3. **model** — full-width gemma3-1b (26 layers, seeded random weights):
   prefill of 1024 tokens (past the 512-token window, so the ring cache's
   roll and the windowed kernel run) and 8 decode steps through the
   kernels, against the same weights through plain attention.  fp32
   logits must agree to 1e-3 of their largest magnitude (summation order
   only); in bf16 the kernel path must stay within twice the plain bf16
   path's distance from the fp32 logits (floor 2e-2), with timings.
4. **trace** — where a full-width bf16 step spends its time: one
   512-token prefill and 4 decode steps at batch 1, traced with
   ``torch.profiler``.  Per phase: wall time, host time to enqueue, device
   busy time, the device's idle share, CUDA launches and the top device
   kernels.
5. **serve** — the main path: the full-width bf16 ``LmEngine`` behind
   ``RealPlane``, per-phase profiles, then ``run_lm_policy`` for
   ``static`` and ``packrat`` over a seeded steady-poisson trace.  Every
   prompt must complete, both kernels must launch and no wrapper may take
   its CPU route.  The launch counts are reset just before this phase.

Then the card's name and power limit, the ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> int:
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
                    if "registers" in ln or "spill" in ln]
             for name, log in build.build_log.items()}
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas})

    kernels_rep = phase_kernels(torch)
    emit({"phase": "kernels", **kernels_rep})
    emit({"phase": "model", **phase_model(torch)})
    emit({"phase": "trace", **phase_trace(torch)})

    for stats in KERNEL_STATS.values():
        stats.reset()
    serve_rep = phase_serve(torch)
    launches = {n: s.launches for n, s in KERNEL_STATS.items()}
    cpu_calls = {n: s.cpu_calls for n, s in KERNEL_STATS.items()}
    serve_rep["launches"] = launches
    serve_rep["cpu_calls"] = cpu_calls
    emit({"phase": "serve", **serve_rep})
    for name in KERNEL_STATS:
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the main path")
        if cpu_calls[name] != 0:
            raise AssertionError(f"{name} took its CPU route on the card")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else "nvidia-smi: no output", flush=True)
    headline = kernels_rep["headline"]
    rows = []
    for name, source, replaces in (
            ("flash_attention",
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:89"),
            ("decode_attention",
             "src/repro_torch/kernels/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention.py:125")):
        h = headline[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": h["max_abs_err"], "ms": h["ms"],
                     "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
                     "bound_by": h["bound_by"],
                     "library_ms": h["library_ms"], "shape": h["shape"]})
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


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around ``iters``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(bytes_moved: float, flops: float, dtype_name: str):
    t_bytes = bytes_moved / MEM_BW
    t_ops = flops / PEAK[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _visible_pairs(S: int, window: int) -> int:
    """Causal (optionally windowed) query-key pairs of one head."""
    return sum(min(i + 1, window) if window else i + 1 for i in range(S))


# --------------------------------------------------------------------- #
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------- #
def phase_kernels(torch):
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    cases = []

    def check(kind, shape, dtype_name, got, want, **extra):
        err, ok = _compare(torch, got, want, dtype_name)
        cases.append({"kernel": kind, "shape": shape, "dtype": dtype_name,
                      "max_abs_err": err, "ok": ok, **extra})
        return err

    # flash: tests/test_kernels.py grids, head dim 8, serving shapes
    flash = []
    for dt in ("float32", "bfloat16"):
        for B, S, H, Hkv, D in ((1, 64, 4, 4, 32), (2, 128, 4, 2, 32),
                                (1, 96, 8, 1, 16), (2, 256, 2, 2, 64),
                                (2, 64, 2, 1, 8), (1, 80, 4, 2, 8)):
            flash.append((dt, B, S, H, Hkv, D, 0, 32))
    for window in (16, 48, 100):
        flash.append(("float32", 2, 128, 4, 1, 32, window, 32))
    for dt in ("float32", "bfloat16"):
        for B in (1, 4):
            for S in (512, 1024):
                for window in (0, 512):
                    flash.append((dt, B, S, 4, 1, 256, window, 512))
    timings = {"flash_attention": [], "decode_attention": []}
    for dt, B, S, H, Hkv, D, window, blk in flash:
        dtype = getattr(torch, dt)
        q = randn((B, S, H, D), dtype)
        k = randn((B, S, Hkv, D), dtype)
        v = randn((B, S, Hkv, D), dtype)
        got = ops.flash_attention(q, k, v, causal=True, window=window,
                                  block_q=blk, block_kv=blk)
        want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        shape = {"B": B, "S": S, "H": H, "Hkv": Hkv, "D": D,
                 "window": window}
        err = check("flash_attention", shape, dt, got, want)
        if D == 256:
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
            timings["flash_attention"].append({
                "shape": shape, "dtype": dt, "max_abs_err": err,
                "ms": time_ms(torch, lambda: ops.flash_attention(
                    q, k, v, causal=True, window=window, block_q=blk,
                    block_kv=blk)),
                "plain_ms": time_ms(torch, lambda: ref.flash_attention_ref(
                    q, k, v, causal=True, window=window)),
                "library_ms": time_ms(torch, lib),
                "bound_ms": bound_ms, "bound_by": bound_by})

    decode = []
    for dt in ("float32", "bfloat16"):
        for B, S, H, Hkv, D in ((2, 128, 4, 2, 32), (1, 256, 8, 8, 64),
                                (3, 96, 4, 1, 16), (2, 64, 2, 1, 8)):
            decode.append((dt, B, S, H, Hkv, D, 32))
        for B in (1, 8):
            for S in (512, 1024):
                decode.append((dt, B, S, 4, 1, 256, 1024))
    for dt, B, S, H, Hkv, D, blk in decode:
        dtype = getattr(torch, dt)
        q = randn((B, 1, H, D), dtype)
        kc = randn((B, S, Hkv, D), dtype)
        vc = randn((B, S, Hkv, D), dtype)
        lengths = torch.randint(1, S + 1, (B,), generator=gen, device=dev,
                                dtype=torch.int32)
        got = ops.decode_attention(q, kc, vc, lengths, block_kv=blk)
        want = ref.decode_attention_ref(q, kc, vc, lengths)
        torch.cuda.synchronize()
        shape = {"B": B, "S": S, "H": H, "Hkv": Hkv, "D": D,
                 "lengths": lengths.tolist()}
        err = check("decode_attention", shape, dt, got, want)
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
            timings["decode_attention"].append({
                "shape": shape, "dtype": dt, "max_abs_err": err,
                "ms": time_ms(torch, lambda: ops.decode_attention(
                    q, kc, vc, lengths, block_kv=1024), iters=50),
                "plain_ms": time_ms(torch, lambda: ref.decode_attention_ref(
                    q, kc, vc, lengths), iters=50),
                "library_ms": time_ms(torch, lambda:
                                      F.scaled_dot_product_attention(
                                          qt, kt, vt, attn_mask=mask),
                                      iters=50),
                "bound_ms": bound_ms, "bound_by": bound_by})

    failed = [c for c in cases if not c["ok"]]
    # headline: the serving phase's largest cells in its working dtype —
    # a 512-token bf16 prefill at b=4 and a bf16 decode step at b=8
    # against the 1024-slot global cache
    headline = {
        "flash_attention": next(
            t for t in timings["flash_attention"]
            if t["dtype"] == "bfloat16" and t["shape"]["B"] == 4
            and t["shape"]["S"] == 512 and t["shape"]["window"] == 0),
        "decode_attention": next(
            t for t in timings["decode_attention"]
            if t["dtype"] == "bfloat16" and t["shape"]["B"] == 8
            and t["shape"]["S"] == 1024),
    }
    rep = {"cases": len(cases), "failed": failed,
           "max_abs_err": {f"{k}/{dt}": max(c["max_abs_err"] for c in cases
                                           if c["kernel"] == k
                                           and c["dtype"] == dt)
                           for k in timings for dt in TOL},
           "tolerance": {dt: {"atol": a, "rtol": r}
                         for dt, (a, r) in TOL.items()},
           "timings": timings, "headline": headline}
    if failed:
        emit({"phase": "kernels", **rep})
        raise AssertionError(f"{len(failed)} kernel cases out of tolerance")
    return rep


# --------------------------------------------------------------------- #
# phase 3: full-width gemma3-1b, kernels vs plain attention
# --------------------------------------------------------------------- #
def phase_model(torch):
    from repro_torch.configs.gemma3_1b import GEMMA3_1B
    from repro_torch.models.lm import decode_step, init_params, prefill
    dev = torch.device("cuda")
    S, n_dec, max_len = 1024, 8, 2048
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, GEMMA3_1B.vocab_size, (1, S + n_dec),
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

    rep = {"config": "gemma3-1b", "layers": GEMMA3_1B.n_layers,
           "prompt": S, "decode_steps": n_dec, "max_len": max_len}
    with torch.no_grad():
        cfg = GEMMA3_1B.with_overrides(dtype="float32",
                                       use_pallas_kernels=True)
        params = init_params(cfg, 0, device=dev)
        k32, _, _ = run(cfg, params)
        p32, _, _ = run(cfg.with_overrides(use_pallas_kernels=False), params)
        del params
        torch.cuda.empty_cache()
        err32 = rel(k32, p32)
        rep["fp32"] = {"rel_err": err32, "tolerance": 1e-3,
                       "finite": bool(torch.isfinite(k32).all())}

        cfg = GEMMA3_1B.with_overrides(use_pallas_kernels=True)   # bf16
        params = init_params(cfg, 0, device=dev)
        k16, _, _ = run(cfg, params)
        plain = cfg.with_overrides(use_pallas_kernels=False)
        p16, _, _ = run(plain, params)
        # second runs are the timed ones (the first pays cuBLAS set-up)
        _, k_pre, k_dec = run(cfg, params)
        _, p_pre, p_dec = run(plain, params)
        del params
        torch.cuda.empty_cache()
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
        raise AssertionError(f"fp32 logits differ: {err32}")
    if not (rep["bf16"]["finite"] and err_k <= tol16):
        emit({"phase": "model", **rep})
        raise AssertionError(f"bf16 logits differ: {err_k} > {tol16}")
    return rep


# --------------------------------------------------------------------- #
# phase 4: host vs device time of a full-width step
# --------------------------------------------------------------------- #
def _trace_report(prof, wall_ms, enqueue_ms, steps):
    """``wall_ms``/``enqueue_ms`` come from an untraced run of the same
    steps; device time and launches from the traced one."""
    import collections
    from torch.autograd import DeviceType
    by_name = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name[:80]] += e.device_time_total / 1e3
    busy_ms = sum(by_name.values())
    launches = sum(1 for e in prof.events()
                   if e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                                 "cuLaunchKernelEx"))
    return {"wall_ms_per_step": wall_ms / steps,
            "host_enqueue_ms_per_step": enqueue_ms / steps,
            "device_busy_ms_per_step": busy_ms / steps,
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "launches_per_step": launches / steps,
            "top_kernels_ms_per_step": {
                name: ms / steps
                for name, ms in by_name.most_common(TRACE_TOP)}}


def phase_trace(torch):
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.gemma3_1b import GEMMA3_1B
    from repro_torch.models.lm import decode_step, init_params, prefill
    dev = torch.device("cuda")
    cfg = GEMMA3_1B.with_overrides(use_pallas_kernels=True)      # bf16
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
        # decode positions repeat across the two runs: the ring and full
        # caches are rewritten in place at the same slots
        _, cache = run_prefill()
        rep_decode = traced(lambda: run_decode(cache), TRACE_DECODE)
        del params, cache
        torch.cuda.empty_cache()
    if rep_prefill["device_busy_ms_per_step"] <= 0 or \
            rep_decode["device_busy_ms_per_step"] <= 0:
        raise AssertionError("the trace saw no device time")
    return {"config": "gemma3-1b", "dtype": cfg.dtype, "batch": 1,
            "prompt": TRACE_PROMPT, "decode_steps": TRACE_DECODE,
            "prefill": rep_prefill, "decode": rep_decode}


# --------------------------------------------------------------------- #
# phase 5: the main path — serve through RealPlane
# --------------------------------------------------------------------- #
def phase_serve(torch):
    from repro_torch.configs.gemma3_1b import GEMMA3_1B
    from repro_torch.core.knapsack import PackratOptimizer
    from repro_torch.core.profiler import ProfileSpec, phase_profiles
    from repro_torch.launch.bench_serving import _cap_rate, run_lm_policy
    from repro_torch.models.serve_lm import (PHASE_DECODE, PHASE_PREFILL,
                                             PHASES, LmEngine)
    from repro_torch.serving import RealPlane
    from repro_torch.serving.scenarios import ScenarioContext, get_scenario
    units, max_batch, decode_steps, seed = 4, 4, 8, 0
    duration = SERVE_SECONDS
    t0 = time.perf_counter()
    engine = LmEngine(GEMMA3_1B.with_overrides(use_pallas_kernels=True),
                      seed=seed, max_seq=1024, default_seq_bucket=512)
    engine_s = time.perf_counter() - t0
    factory = engine.factory()
    prof_plane = RealPlane(factory, units)
    profiles = phase_profiles(
        prof_plane, ProfileSpec(units, max_batch, thread_values=(1, 2, 4)),
        PHASES, warmup=1, iters=3)
    profile_cells = prof_plane.runner_report()
    prof_plane.close()
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
    rep = {"config": "gemma3-1b", "dtype": GEMMA3_1B.dtype,
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
                          real_model="gemma3-1b")
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
            raise AssertionError(f"{policy}: not every prompt completed")
    return rep


if __name__ == "__main__":
    sys.exit(main())
