#!/usr/bin/env python3
"""Take the design of flash's tensor-core pair kernel apart at head dim
128 or 160, on one card: each variant undoes or changes one choice of
``flash_tc_pair_kernel<D>``, or adds clock stamps to it, and all are
timed in turns against the kernel as it is.

Run from the root of a checkout on a machine with a CUDA card::

    python3 tools/flash_pair_probe.py [--head-dim 128|160] \\
        [--variants exp2f,noturns,...] [--out FILE]

Each variant is a copy of this checkout's ``src`` under
``build/pair_probe/<variant>`` (``.gitignore`` lists ``build/``) with its
edits to ``csrc/flash_attention.cu`` (and ``csrc/hopper.cuh``), built
into its own directory and timed in a fresh process
(``chip_smoke.time_ms``: device ms by CUDA events) at :data:`SHAPES` at
the chosen head dim, with its largest error against the plain version
and ptxas's register and spill lines.  The variants (:func:`variants`):

* ``base``: the kernel as it is (timed first and last);
* ``exp2f``: the softmax's 2^x by ``exp2f`` in place of ``ex2.approx``;
* ``noturns``: no turns: both groups issue their products when ready;
* ``roundrobin``: a persistent block takes query tiles i, i + G, ...
  in place of the zig-zag i, 2G - 1 - i, ...;
* ``stages2``, ``stages3``, ``stages4``: a ring of that many K/V stages
  at the head dim;
* ``box32``, ``box64``: 32-column boxes in the 64-byte swizzle, or
  64-column ones in the 128-byte swizzle, at the head dim (P V still one
  wgmma over every column, LBO a box; the epilogue writes O in the
  boxes' swizzle);
* ``kv128``: 128-row KV tiles at the head dim (S = Q K^T one
  ``m64n128k16`` a 16-deep step, eight P V steps a tile) in a ring of
  two stages, the most that fits beside the two Q buffers;
* ``trace``: the kernel with ``clock64`` stamps around each stage of a
  steady round (the full-tile wait, the turn, the issue of S and P V, the
  wait for S, the softmax, the wait for P V, then pack, rescale and
  release) in both groups of block 0's first query tile, written over
  its output rows (the output is not checked); the worker prints each
  stage's mean cycles over the rounds.

An edit that no longer finds its anchor in the source raises: the probe
follows the kernel's code and has to be brought up to date with it.
The result, one JSON object, goes to standard output (and ``--out``).
Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CU = "repro_torch/kernels/csrc/flash_attention.cu"
HOPPER = "repro_torch/kernels/csrc/hopper.cuh"
# (B, S): the dense paths' prefill (32 heads on 8: stablelm-12b at head dim
# 160, llama3-8b and minitron-8b at 128) at B = 1..4 over a 512-token
# prompt, and their model checks' 1024 positions
SHAPES = ((1, 512), (2, 512), (3, 512), (4, 512), (1, 1024))
HEADS, KV_HEADS = 32, 8
HEAD_DIMS = (128, 160)
# stages a steady round of the trace variant stamps, in order
TRACE_STAGES = ("full_wait", "turn_wait", "issue", "s_wait", "softmax",
                "pv_wait", "pack_rescale_release")

# TcPair's constants, each found once by its line (and, for W, the lines
# after it, which tell it from TcTile's)
_STAGES = r"static constexpr int STAGES = ([^;]*);"
_W = (r"static constexpr int W = ([^;]*);(\n  static constexpr int NB = D / W;"
      r"\n  static_assert\(NB \* W == D && D <= 256)")
_BKV = r"static constexpr int BKV = ([^;]*);( +// KV rows a tile)"


def _wgmma_ss_128() -> str:
    """wgmma_ss's m64n128k16 case (S of a 128-row KV tile), for kv128."""
    regs = ", ".join(f"%{i}" for i in range(64))
    outs = ", ".join(f"D8({i})" for i in range(0, 64, 8))
    return (
        "  if constexpr (N == 128) {\n    asm volatile(\n"
        '        "{\\n.reg .pred p;\\nsetp.ne.b32 p, %66, 0;\\n"\n'
        '        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"\n'
        f'        "{regs}"\n'
        '        "}, %64, %65, p, 1, 1, %67, %68;\\n}\\n"\n'
        f"        : {outs}\n"
        '        : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));\n'
        "  }\n")


def _at(hd: int, value: str) -> str:
    """A constant's new expression: ``value`` at head dim ``hd``, the old
    one (the regex's group 1) elsewhere."""
    return rf"D == {hd} ? {value} : (\1)"


def variants(hd: int) -> dict:
    """Each variant's edits at head dim ``hd``: (file, regex, replacement),
    every regex matching the source exactly once."""
    lit = re.escape
    stages = {f"stages{n}": [(CU, _STAGES, "static constexpr int STAGES = "
                              + _at(hd, str(n)) + ";")]
              for n in (2, 3, 4)}
    return {
        "base": [],
        "exp2f": [(CU, lit(
            '  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));\n'),
            "  y = exp2f(x);\n")],
        "noturns": [
            (CU, lit('  asm volatile("bar.sync %0, 256;\\n" :: "r"(4 + grp) '
                     ': "memory");'), ""),
            (CU, lit('  asm volatile("bar.arrive %0, 256;\\n" :: '
                     '"r"(5 - grp) : "memory");'), "")],
        "roundrobin": [(CU, lit(
            "    return n * G + (n % 2 ? G - 1 - (int)blockIdx.x : "
            "(int)blockIdx.x);"),
            "    return n * G + (int)blockIdx.x;")],
        **stages,
        **{f"box{w}": [(CU, _W, "static constexpr int W = "
                        + _at(hd, str(w)) + r";\2")] for w in (32, 64)},
        "kv128": [
            (CU, _BKV, "static constexpr int BKV = " + _at(hd, "128")
             + r";\2"),
            (CU, _STAGES, "static constexpr int STAGES = " + _at(hd, "2")
             + ";"),
            (HOPPER, lit('  static_assert(N == 32 || N == 64, '
                         '"wgmma_ss: N is 32 or 64");\n'),
             lambda m: '  static_assert(N == 32 || N == 64 || N == 128, '
                       '"wgmma_ss: N is 32, 64 or 128");\n'
                       + _wgmma_ss_128())],
        "trace": [(CU, lit(a), b.replace("\\", "\\\\")) for a, b in (
            ("  const int tid = threadIdx.x;\n\n  if (tid == 0) {\n"
             "    for (int qb = 0; qb < 2; ++qb) {",
             "  const int tid = threadIdx.x;\n"
             "  unsigned tr[128];\n  int ntr = 0;\n"
             "  const bool rec = blockIdx.x == 0 && tid % 128 == 0;\n"
             "#define TR() do { if (rec && ntr < 128) "
             "tr[ntr++] = (unsigned)clock64(); } while (0)\n\n"
             "  if (tid == 0) {\n    for (int qb = 0; qb < 2; ++qb) {"),
            ("        wait_tile(r);\n        turn_wait(grp);",
             "        TR();\n        wait_tile(r);\n        TR();\n"
             "        turn_wait(grp);\n        TR();"),
            ("        pass(r);\n        hopper::wgmma_wait<1>();",
             "        pass(r);\n        TR();\n        hopper::wgmma_wait<1>();"
             "\n        TR();"),
            ("                          causal, window, scale_log2);\n"
             "        hopper::wgmma_wait<0>();",
             "                          causal, window, scale_log2);\n"
             "        TR();\n        hopper::wgmma_wait<0>();\n        TR();"),
            ("      // round e: P_{e-1} V_{e-1} alone\n",
             "      TR();\n      // round e: P_{e-1} V_{e-1} alone\n"),
            ("        hopper::bulk_wait_read();\n      }\n    }\n"
             "    if (wt == 0) hopper::mbar_arrive(&q_empty[qb]);\n",
             "        hopper::bulk_wait_read();\n"
             '        asm volatile("cp.async.bulk.wait_group 0;\\n" ::: '
             '"memory");\n      }\n    }\n'
             "    if (wt == 0) hopper::mbar_arrive(&q_empty[qb]);\n"
             "    if (rec && n == 0) {\n"
             "      uint32_t* dst = reinterpret_cast<uint32_t*>(\n"
             "          o_dbg + ((size_t)(it.b * Sq + g_lo) * H + it.h) * D);\n"
             "      for (int k = 0; k < ntr && k < D / 2 - 1; ++k) "
             "dst[k] = tr[k];\n"
             "      dst[D / 2 - 1] = ntr;\n    }\n"),
            ("                     const __grid_constant__ CUtensorMap tm_o, "
             "int B, int Sq,",
             "                     const __grid_constant__ CUtensorMap tm_o,\n"
             "                     bf16* o_dbg, int B, int Sq,"),
            ("      mq, mk, mv, mo, B, Sq, Sk, H, Hkv, causal, window, "
             "scale * kLog2e);",
             "      mq, mk, mv, mo, static_cast<bf16*>(o), B, Sq, Sk, H, Hkv, "
             "causal, window, scale * kLog2e);"))],
    }


VARIANTS = tuple(variants(HEAD_DIMS[0]))


def edited(name: str, edits, src: Path = ROOT / "src") -> dict:
    """The sources a variant edits, as {path under src: edited text};
    raises where an anchor is not in its file exactly once."""
    texts = {}
    for rel, pattern, repl in edits:
        text = texts.get(rel) or (src / rel).read_text()
        texts[rel], n = re.subn(pattern, repl, text)
        if n != 1:
            raise SystemExit(f"flash_pair_probe: variant {name}: the anchor "
                             f"{pattern[:60]!r} is in {rel} {n} times, "
                             "not once")
    return texts


def make_variant(name: str, edits) -> Path:
    """A copy of this checkout's src with the variant's edits, under
    build/pair_probe/<name>; returns its src directory."""
    dst = ROOT / "build" / "pair_probe" / name
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(ROOT / "src", dst / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, text in edited(name, edits).items():
        (dst / "src" / rel).write_text(text)
    return dst / "src"


def _trace_stages(stamps: list) -> dict:
    """Mean cycles of each steady-round stage from one group's stamps:
    seven a round (before the tile's wait, after it, after the turn, after
    the issue, after S, after the softmax, after P V), each round closed
    by the next one's first stamp (the last by the stamp before the round
    that issues P V alone)."""
    n_rounds = (len(stamps) - 1) // 7
    out = {s: [] for s in TRACE_STAGES}
    for r in range(n_rounds):
        x = stamps[7 * r:7 * r + 8]
        for k, s in enumerate(TRACE_STAGES):
            out[s].append((x[k + 1] - x[k]) & 0xFFFFFFFF)
    return {s: sum(v) / len(v) for s, v in out.items() if v}


def worker(name: str, hd: int) -> dict:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "build" / "pair_probe" / name / "src"))
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(
        ROOT / "build" / "pair_probe" / name / "kernels")
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as flash_mod
    build.build_kernels()
    out = {"variant": name, "head_dim": hd, "rows": [],
           "ptxas": cs.ptxas_of(build.build_log.get("flash_attention", ""),
                                f"flash_tc_pair_kernelILi{hd}E")}
    dev = torch.device("cuda")
    words = hd // 2                        # 32-bit words of an output row
    for B, S in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(B + S)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).bfloat16()
                   for shape in ((B, S, HEADS, hd), (B, S, KV_HEADS, hd),
                                 (B, S, KV_HEADS, hd)))

        def call():
            return flash_mod.launch(q, k, v, causal=True, window=0,
                                    force="tensor_core")
        row = {"shape": {"B": B, "S": S}}
        o = call()
        torch.cuda.synchronize()
        if name == "trace":
            # block 0's first query tile is the last of (b, h) = (0, 0)
            q_lo = ((S + 127) // 128 - 1) * 128
            row["stages"] = {}
            for g in (0, 1):
                w = o[0, q_lo + 64 * g, 0].contiguous().view(
                    torch.int32).cpu().tolist()
                stamps = [x & 0xFFFFFFFF
                          for x in w[:min(w[words - 1], words - 1)]]
                row["stages"][g] = _trace_stages(stamps)
        else:
            want = ref.flash_attention_ref(q, k, v, causal=True)
            row["max_abs_err"] = float((o.float() - want.float()).abs().max())
        row["ms"] = cs.time_ms(torch, call, iters=50)["ms"]
        out["rows"].append(row)
        del q, k, v, o
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--head-dim", type=int, choices=HEAD_DIMS, default=160)
    ap.add_argument("--variants", default="exp2f,noturns,roundrobin,stages2,"
                    "trace",
                    help="variants to time between two runs of base, of "
                         + ",".join(VARIANTS))
    ap.add_argument("--out", type=Path)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker, args.head_dim)))
        return 0
    names = [v for v in args.variants.split(",") if v]
    if set(names) - set(VARIANTS):
        ap.error(f"--variants: pick from {','.join(VARIANTS)}")
    import torch
    if not torch.cuda.is_available():
        print("flash_pair_probe: no CUDA device", file=sys.stderr)
        return 2
    order = ["base", *names, "base"]
    edits = variants(args.head_dim)
    for name in set(order):
        make_variant(name, edits[name])
    runs = []
    for name in order:
        proc = subprocess.run(
            [sys.executable, __file__, "--worker", name, "--head-dim",
             str(args.head_dim)], capture_output=True,
            text=True, timeout=900, env={**os.environ, "PYTHONPATH": ""})
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            return 1
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    text = json.dumps({"card": smi, "head_dim": args.head_dim,
                       "order": order, "runs": runs})
    if args.out:
        args.out.write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
