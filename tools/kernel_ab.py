#!/usr/bin/env python3
"""Time two checkouts' decode, flash and SSD kernels at the same shapes,
in turns, on one card.

Run from the root of a checkout on a machine with a CUDA card::

    python3 tools/kernel_ab.py --parent DIR [--calls LOG] [--out FILE] \
        [--kernels decode,flash,ssd]

``DIR`` is the root of another checkout (for instance the parent commit,
unpacked with ``git archive`` into a directory that ``.gitignore``
lists).  The script runs itself as a worker four times, each in a fresh
process that imports one checkout's ``repro_torch``, builds its kernels
and times them: the other checkout, this one, this one, the other.
Every worker times, on the same seeded inputs:

* ``decode_attention`` forced onto its tensor-core route (bf16) at the
  serving shapes :data:`DECODE_SHAPES` and, with ``--calls``, at every
  shape the serving phases of a ``chip_smoke.py`` log called it with
  (its ``kernels`` line's ``calls_by_shape`` of the decode row; as many
  valid rows as there, at most S), so the call-weighted total can be
  compared;
* ``flash_attention`` forced onto its CUDA-core route (fp32) at
  :data:`FLASH_SHAPES`: row 1a's shape and the fp32 model checks';
* ``flash_attention`` forced onto its tensor-core route (bf16,
  ``flash_tc``) at :data:`FLASH_TC_SHAPES` (each serving head dim's
  prefill at B = 1 and 4) and, with ``--calls``, at every shape of the
  flash row's ``calls_by_shape`` (the serving phases' calls), so the
  call-weighted total can be compared;
* ``ssd_scan`` forced onto its tensor-core route (bf16) at
  :data:`SSD_SHAPES` (mamba2-130m's serving calls at B = 1, 2, 4 and
  ``chip_smoke.py``'s wide bf16 shapes) and, with ``--calls``, at every
  shape of the SSD row's ``calls_by_shape``, so the call-weighted total
  can be compared.

``--kernels`` picks which of the four each worker times (all by
default).  Each time is ``chip_smoke.time_ms`` (device ms by CUDA
events, host ms beside) and the profiler's kernel records per call.  A
worker of a checkout whose decode or SSD runs as one cluster launch also
times it at every cluster size it is built for and asks the library how
many clusters of each size the card holds at once.
The result, one JSON object with every worker's times, the means per
checkout and the ratio of the means, goes to standard output (and to
``--out``).  Needs no network; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (B, S, H, Hkv, D): row 2a (gemma3-1b's global cache) at B = 4 and 1,
# recurrentgemma-9b's group of 16, the head-dim-64 paths (16 on 16, 14
# on 2) at B = 1 and 4, the dense paths' 32 heads on 8 (stablelm-12b's
# head dim 160 at B = 1 and 4, llama3-8b's and minitron-8b's 128);
# chip_smoke.DECODE_VALID valid rows, as the serve phase leaves them
DECODE_SHAPES = ((4, 1024, 4, 1, 256), (1, 1024, 4, 1, 256),
                 (1, 1024, 16, 1, 256), (4, 1024, 16, 1, 256),
                 (1, 1024, 16, 16, 64), (4, 1024, 16, 16, 64),
                 (1, 1024, 14, 2, 64), (4, 1024, 14, 2, 64),
                 (1, 1024, 32, 8, 160), (4, 1024, 32, 8, 160),
                 (4, 1024, 32, 8, 128))
# (B, S, H, Hkv, D, window), causal: row 1a's shape in fp32, gemma3-1b's
# fp32 model check (1024 positions, global and its 512 window), the
# head-dim-64 model checks (1000 positions), recurrentgemma-9b's (2100
# positions, window 2048), stablelm-12b's (1024 positions, 32 heads on 8
# of 160) and its prefill's shape at B = 4
FLASH_SHAPES = ((4, 512, 4, 1, 256, 0), (1, 1024, 4, 1, 256, 0),
                (1, 1024, 4, 1, 256, 512), (1, 1000, 16, 16, 64, 0),
                (1, 1000, 14, 2, 64, 0), (1, 2100, 16, 1, 256, 2048),
                (1, 1024, 32, 8, 160, 0), (4, 512, 32, 8, 160, 0))
# (B, S, H, Hkv, D), causal, bf16: each serving head dim's prefill at
# B = 1 and 4 over a 512-token prompt: gemma3-1b's 4 heads on 1 and
# recurrentgemma-9b's 16 on 1 at 256, the head-dim-64 paths' groups
# (seamless-m4t-medium's 16 on 16, internvl2-1b's 14 on 2), llama3-8b's
# and minitron-8b's 32 on 8 at 128, stablelm-12b's at 160
FLASH_TC_SHAPES = tuple(
    (B, 512, H, Hkv, D) for B in (1, 4)
    for H, Hkv, D in ((4, 1, 256), (16, 1, 256), (16, 16, 64), (14, 2, 64),
                      (32, 8, 128), (32, 8, 160)))
# (B, S, H, P, G, N, chunk): mamba2-130m's prefill at B = 1, 2, 4 (row 3a
# at B = 4), then chip_smoke.py's wide bf16 shapes
SSD_SHAPES = ((1, 512, 24, 64, 1, 128, 64), (2, 512, 24, 64, 1, 128, 64),
              (4, 512, 24, 64, 1, 128, 64), (8, 1024, 48, 64, 1, 128, 64),
              (2, 2048, 24, 64, 2, 64, 128), (2, 256, 4, 80, 1, 64, 64),
              (1, 256, 4, 64, 1, 256, 128), (1, 256, 4, 64, 1, 272, 64),
              (2, 256, 4, 128, 1, 64, 64), (1, 256, 4, 64, 1, 512, 32))
KERNELS = ("decode", "flash", "ssd", "flash_tc")


def _serving_calls(log: Path) -> dict:
    """The decode, SSD and flash rows' ``calls_by_shape`` from a
    chip_smoke log."""
    for line in log.read_text().splitlines():
        if line.startswith('{"kernels"'):
            rows = {r["name"]: r for r in json.loads(line)["kernels"]}
            return {k: rows[name].get("calls_by_shape", [])
                    for k, name in (("decode", "decode_attention"),
                                    ("ssd", "ssd_scan"),
                                    ("flash_tc", "flash_attention"))}
    raise SystemExit(f"kernel_ab: no kernels line in {log}")


def _time_ssd(torch, cs, inputs, calls: list) -> list:
    """The SSD forced onto the tensor cores at :data:`SSD_SHAPES` and the
    serving calls' bf16 shapes."""
    from repro_torch.kernels import KERNEL_STATS, build, ref
    from repro_torch.kernels import ssd_scan as ssd_mod
    sizes = getattr(ssd_mod, "CLUSTERS", ())
    dev = torch.device("cuda")
    shapes = [(*shape, None) for shape in SSD_SHAPES]
    shapes += [(*(c["shape"][x] for x in ("B", "S", "H", "P", "G", "N",
                                          "chunk")), c["calls"])
               for c in calls if c["dtype"] == "bfloat16"]
    rows = []
    for B, S, H, P, G, N, Q, n_calls in shapes:
        x, B_in, C_in = inputs(B + S + H + P + N,
                               ((B, S, H, P), (B, S, G, N), (B, S, G, N)),
                               torch.bfloat16)
        dt = torch.nn.functional.softplus(
            inputs(S + H, ((B, S, H),), torch.float32)[0])
        a_log = torch.log(torch.linspace(1.0, 4.0, H, device=dev))
        args = (x, dt, a_log, B_in, C_in)
        want_y, want_h = ref.ssd_scan_ref(*args)

        def call(**kw):
            return ssd_mod.launch(*args, chunk=Q, force="tensor_core", **kw)
        y, h = call()
        err = max(float((y.float() - want_y.float()).abs().max()),
                  float((h - want_h).abs().max()))
        t = cs.time_ms(torch, call, iters=50)
        rec = cs._kernel_records(torch, call, KERNEL_STATS["ssd_scan"])
        row = {"shape": {"B": B, "S": S, "H": H, "P": P, "G": G, "N": N,
                         "chunk": Q}, "calls": n_calls,
               "ms": t["ms"], "host_ms": t["host_ms"],
               "covered": t["covered"], "max_abs_err": err,
               "profiler_ms": sum(rec["kernels_ms"].values()),
               "kernels_ms": rec["kernels_ms"],
               "records_per_call": rec["records_per_call"],
               "launches_per_call": rec["launches_per_call"]}
        if sizes:
            # the size the shape takes, what the card holds of each size,
            # and every size the kernel launches (None: refused there)
            lib = build.library("ssd_scan")
            row["cluster"] = lib.ssd_scan_tc_cluster(B, S, H, P, N, Q)
            row["max_active_clusters"] = {
                c: lib.ssd_scan_max_active_clusters(P, N, Q, c,
                                                    int(S // Q > c))
                for c in sizes}
            row["ms_by_cluster"] = {}
            for c in sizes:
                try:
                    row["ms_by_cluster"][c] = cs.time_ms(
                        torch, lambda c=c: call(cluster=c), iters=50)["ms"]
                except RuntimeError:
                    row["ms_by_cluster"][c] = None
        rows.append(row)
        del args, x, B_in, C_in, dt, want_y, want_h
    return rows


def _time_flash_tc(torch, cs, inputs, calls: list) -> list:
    """Flash forced onto its tensor cores at :data:`FLASH_TC_SHAPES` and
    the serving calls' bf16 shapes."""
    from repro_torch.kernels import KERNEL_STATS, build, ref
    from repro_torch.kernels import flash_attention as flash_mod
    shapes = [(B, S, S, H, Hkv, D, 0, None)
              for B, S, H, Hkv, D in FLASH_TC_SHAPES]
    shapes += [(*(c["shape"][x] for x in ("B", "Sq", "Sk", "H", "Hkv", "D",
                                          "window")), c["calls"])
               for c in calls if c["dtype"] == "bfloat16"]
    rows = []
    for B, Sq, Sk, H, Hkv, D, window, n_calls in shapes:
        if D not in build.TENSOR_CORE_HEAD_DIMS:
            continue
        q, k, v = inputs(B + Sq + H + D + window,
                         ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)),
                         torch.bfloat16)

        def call():
            return flash_mod.launch(q, k, v, causal=True, window=window,
                                    force="tensor_core")
        want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
        err = float((call().float() - want.float()).abs().max())
        t = cs.time_ms(torch, call, iters=50)
        rec = cs._kernel_records(torch, call,
                                 KERNEL_STATS["flash_attention"])
        rows.append({"shape": {"B": B, "Sq": Sq, "Sk": Sk, "H": H,
                               "Hkv": Hkv, "D": D, "window": window},
                     "calls": n_calls, "ms": t["ms"],
                     "host_ms": t["host_ms"], "covered": t["covered"],
                     "max_abs_err": err,
                     "profiler_ms": sum(rec["kernels_ms"].values()),
                     "kernels_ms": rec["kernels_ms"],
                     "records_per_call": rec["records_per_call"],
                     "launches_per_call": rec["launches_per_call"]})
        del q, k, v, want
    return rows


def worker(src: str, calls: dict, kernels=KERNELS) -> dict:
    import torch
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, src)
    import chip_smoke as cs
    from repro_torch.kernels import KERNEL_STATS, build, ref
    from repro_torch.kernels import decode_attention as decode_mod
    from repro_torch.kernels import flash_attention as flash_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    build_s = build.build_kernels()
    dev = torch.device("cuda")

    def inputs(seed, shapes, dtype):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return [torch.randn(s, generator=gen, device=dev).to(dtype)
                for s in shapes]

    sizes = getattr(decode_mod, "CLUSTERS", ())
    decode = []
    shapes = [(B, S, H, Hkv, D, None) for B, S, H, Hkv, D in DECODE_SHAPES]
    shapes += [(*(c["shape"][x] for x in ("B", "S", "H", "Hkv", "D")),
                c["calls"]) for c in calls.get("decode", [])
               if c["dtype"] == "bfloat16"]
    if "decode" not in kernels:
        shapes = []
    for B, S, H, Hkv, D, n_calls in shapes:
        if D not in build.HEAD_DIMS:      # a checkout without that kernel
            continue
        q, kc, vc = inputs(B + S + H + D, ((B, 1, H, D), (B, S, Hkv, D),
                                           (B, S, Hkv, D)), torch.bfloat16)
        valid = min(cs.DECODE_VALID, S)
        lengths = torch.full((B,), valid, dtype=torch.int32, device=dev)
        want = ref.decode_attention_ref(q, kc, vc, lengths)

        def call(**kw):
            return decode_mod.launch(q, kc, vc, lengths, force="tensor_core",
                                     **kw)
        err = float((call().float() - want.float()).abs().max())
        t = cs.time_ms(torch, call, iters=50)
        rec = cs._kernel_records(torch, call,
                                 KERNEL_STATS["decode_attention"])
        row = {"shape": {"B": B, "S": S, "H": H, "Hkv": Hkv, "D": D,
                         "valid": valid}, "calls": n_calls,
               "ms": t["ms"], "host_ms": t["host_ms"],
               "covered": t["covered"], "max_abs_err": err,
               "profiler_ms": sum(rec["kernels_ms"].values()),
               "kernels_ms": rec["kernels_ms"],
               "records_per_call": rec["records_per_call"],
               "launches_per_call": rec["launches_per_call"]}
        if sizes:
            # the size the shape takes, and every size the kernel has
            row["cluster"] = decode_mod._cluster_for(B * Hkv, S, D)
            row["ms_by_cluster"] = {
                c: cs.time_ms(torch, lambda c=c: call(cluster=c),
                              iters=50)["ms"]
                for c in sizes if c <= D // 2}
        decode.append(row)
    flash = []
    for B, S, H, Hkv, D, window in (FLASH_SHAPES if "flash" in kernels
                                    else ()):
        if D not in build.HEAD_DIMS:
            continue
        q, k, v = inputs(B + S + H + D + window,
                         ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)),
                         torch.float32)

        def call():
            return flash_mod.launch(q, k, v, causal=True, window=window,
                                    force="cuda_core")
        want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
        err = float((call() - want).abs().max())
        t = cs.time_ms(torch, call, iters=10)
        rec = cs._kernel_records(torch, call, iters=10)
        flash.append({"shape": {"B": B, "S": S, "H": H, "Hkv": Hkv, "D": D,
                                "window": window},
                      "ms": t["ms"], "host_ms": t["host_ms"],
                      "covered": t["covered"], "max_abs_err": err,
                      "profiler_ms": sum(rec["kernels_ms"].values())})
        del q, k, v, want
    ssd = (_time_ssd(torch, cs, inputs, calls.get("ssd", []))
           if "ssd" in kernels else [])
    flash_tc = (_time_flash_tc(torch, cs, inputs, calls.get("flash_tc", []))
                if "flash_tc" in kernels else [])
    occupancy = {}
    lib = build.library("decode_attention")
    if sizes and "decode" in kernels:
        for D in (64, 160, 256):
            if D not in build.HEAD_DIMS:
                continue
            for S in (512, 1024, 4096):
                for c in sizes:
                    occupancy[f"D{D}/S{S}/cluster{c}"] = \
                        lib.decode_attention_max_active_clusters(D, S, c)
    return {"src": src, "build_s": build_s, "decode": decode,
            "flash": flash, "ssd": ssd, "flash_tc": flash_tc,
            "max_active_clusters": occupancy,
            "ptxas": {n: [ln.strip() for ln in log.splitlines()
                          if "registers" in ln or "spill" in ln
                          or "Function properties for" in ln]
                      for n, log in build.build_log.items()}}


def _mean(xs):
    return sum(xs) / len(xs)


def _rows(run: dict, kind: str) -> dict:
    """A worker's rows of one kind by (shape, calls)."""
    return {(json.dumps(r["shape"], sort_keys=True), r.get("calls")): r
            for r in run[kind]}


def summarize(runs: dict) -> dict:
    """Means per checkout of each shape's ms, host ms and profiler ms, the
    ratio this / other, and the call-weighted decode, SSD and bf16 flash
    totals, over the shapes both checkouts have a kernel for."""
    out = {kind: [] for kind in KERNELS}
    for kind in KERNELS:
        by_tree = {tree: [_rows(r, kind) for r in runs[tree]]
                   for tree in ("other", "this")}
        for key, row in by_tree["this"][0].items():
            if any(key not in rows for t in by_tree.values() for rows in t):
                continue
            entry = {"shape": row["shape"]}
            if kind != "flash":
                entry["calls"] = row["calls"]
                entry["records_per_call"] = {
                    tree: [rows[key]["records_per_call"] for rows in t]
                    for tree, t in by_tree.items()}
            if kind in ("decode", "ssd"):
                entry["cluster"] = row.get("cluster")
                entry["max_active_clusters"] = row.get("max_active_clusters")
                entry["this_ms_by_cluster"] = [
                    rows[key].get("ms_by_cluster") for rows in by_tree["this"]]
            for tree in ("other", "this"):
                rs = [rows[key] for rows in by_tree[tree]]
                entry[tree] = {m: [r[m] for r in rs]
                               for m in ("ms", "host_ms", "profiler_ms")}
                entry[tree]["mean_ms"] = _mean(entry[tree]["ms"])
            entry["this_over_other"] = (entry["this"]["mean_ms"]
                                        / entry["other"]["mean_ms"])
            out[kind].append(entry)
    for kind in ("decode", "ssd", "flash_tc"):
        weighted = [e for e in out[kind] if e["calls"]]
        if weighted:
            out[f"{kind}_weighted_ms"] = {
                tree: sum(e["calls"] * e[tree]["mean_ms"] for e in weighted)
                for tree in ("other", "this")}
            out[f"{kind}_weighted_calls"] = sum(e["calls"] for e in weighted)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of the checkout to compare with")
    ap.add_argument("--calls", type=Path,
                    help="a chip_smoke.py log: time decode at its serving "
                         "calls' shapes too")
    ap.add_argument("--out", type=Path)
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="which kernels to time, of " + ",".join(KERNELS))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--calls-json", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    kernels = tuple(args.kernels.split(","))
    if set(kernels) - set(KERNELS):
        ap.error(f"--kernels: pick from {','.join(KERNELS)}")
    if args.worker:
        print(json.dumps(worker(args.worker, json.loads(args.calls_json),
                                kernels)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    if not args.parent:
        ap.error("--parent is required")
    calls = _serving_calls(args.calls) if args.calls else {}
    trees = {"other": str(Path(args.parent).resolve() / "src"),
             "this": str(ROOT / "src")}
    runs = {"other": [], "this": []}
    for tree in ("other", "this", "this", "other"):
        proc = subprocess.run(
            [sys.executable, __file__, "--worker", trees[tree],
             "--calls-json", json.dumps(calls), "--kernels", args.kernels],
            capture_output=True, text=True, timeout=1200,
            env={**os.environ, "PYTHONPATH": ""})
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            return 1
        runs[tree].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    result = {"card": smi, "order": ["other", "this", "this", "other"],
              "summary": summarize(runs), "runs": runs}
    text = json.dumps(result)
    if args.out:
        args.out.write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
