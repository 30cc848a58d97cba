"""Render EXPERIMENTS.md tables from results/torch_dryrun JSON records.

The counterpart of ``repro/launch/report.py`` over the port's dry-run
records (``launch/dryrun.py``): the same tables, whose residency column
says whether a cell fits one H100 (``tests/test_torch_isolation.py``
holds the table functions to the reference's syntax trees).

Usage:
    python -m repro_torch.launch.report [all|dryrun|multi|roofline|perf]
"""

from __future__ import annotations

import json
import pathlib
import sys

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / \
    "torch_dryrun"
GIB = 1 << 30


def fmt_bytes(n):
    return f"{n / GIB:.2f}"


def load(pattern: str):
    out = []
    for f in sorted(RESULTS.glob(pattern)):
        rec = json.loads(f.read_text())
        if "error" not in rec:
            out.append(rec)
    return out


def dryrun_table(mesh: str = "single") -> str:
    rows = ["| arch | shape | chips | peak GiB/dev | fits H100 | "
            "HLO GFLOPs/dev | coll GB/chip |",
            "|---|---|---:|---:|:--:|---:|---:|"]
    for rec in load(f"*__{mesh}.json"):
        mem = rec.get("memory", {})
        r = rec.get("roofline", {})
        flops = r.get("hlo_flops_total", 0) / rec["chips"] / 1e9 \
            if r else 0
        rows.append(
            f"| {rec['arch']} | {rec['shape']} | {rec['chips']} "
            f"| {fmt_bytes(mem.get('peak_bytes_per_device', 0))} "
            f"| {'yes' if rec.get('fits_hbm') else 'no'} "
            f"| {flops:,.0f} "
            f"| {r.get('collective_bytes_per_chip', 0) / 1e9:.2f} |")
    return "\n".join(rows)


def roofline_table() -> str:
    rows = ["| arch | shape | compute s | memory s | collective s | "
            "dominant | MODEL/HLO FLOPs | roofline frac |",
            "|---|---|---:|---:|---:|---|---:|---:|"]
    for rec in load("*__single.json"):
        r = rec.get("roofline")
        if not r:
            continue
        rows.append(
            f"| {rec['arch']} | {rec['shape']} "
            f"| {r['compute_s']:.3f} | {r['memory_s']:.3f} "
            f"| {r['collective_s']:.3f} | **{r['dominant']}** "
            f"| {r['model_flops_ratio']:.2f} "
            f"| {r['roofline_fraction'] * 100:.1f}% |")
    return "\n".join(rows)


def perf_table() -> str:
    rows = ["| cell | variant | L (ms) | compute | memory | collective | "
            "peak GiB | roofline frac |",
            "|---|---|---:|---:|---:|---:|---:|---:|"]
    cells = {}
    for f in sorted(RESULTS.glob("*.json")):
        rec = json.loads(f.read_text())
        if "error" in rec or "roofline" not in rec:
            continue
        key = (rec["arch"], rec["shape"])
        tag = rec.get("tag") or "baseline"
        if rec["mesh"] != "16x16":
            continue
        cells.setdefault(key, {})[tag] = rec
    for (arch, shape), variants in sorted(cells.items()):
        if len(variants) < 2:
            continue
        order = ["baseline"] + sorted(t for t in variants if t != "baseline")
        for tag in order:
            rec = variants[tag]
            r = rec["roofline"]
            mem = rec.get("memory", {})
            rows.append(
                f"| {arch}:{shape} | {tag} | {r['latency_s'] * 1e3:,.1f} "
                f"| {r['compute_s'] * 1e3:,.1f} | {r['memory_s'] * 1e3:,.1f} "
                f"| {r['collective_s'] * 1e3:,.1f} "
                f"| {fmt_bytes(mem.get('peak_bytes_per_device', 0))} "
                f"| {r['roofline_fraction'] * 100:.2f}% |")
    return "\n".join(rows)


def multi_pod_table() -> str:
    rows = ["| arch | shape | chips | compiled | peak GiB/dev |",
            "|---|---|---:|:--:|---:|"]
    for rec in load("*__multi.json"):
        mem = rec.get("memory", {})
        rows.append(f"| {rec['arch']} | {rec['shape']} | {rec['chips']} "
                    f"| yes | {fmt_bytes(mem.get('peak_bytes_per_device', 0))} |")
    return "\n".join(rows)


def main() -> int:
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which in ("all", "dryrun"):
        print("### Dry-run (single pod)\n")
        print(dryrun_table("single"))
    if which in ("all", "multi"):
        print("\n### Dry-run (multi pod 2x16x16)\n")
        print(multi_pod_table())
    if which in ("all", "roofline"):
        print("\n### Roofline\n")
        print(roofline_table())
    if which in ("all", "perf"):
        print("\n### Perf iterations\n")
        print(perf_table())
    return 0


if __name__ == "__main__":
    sys.exit(main())
