"""§Perf hillclimb: baseline vs optimized count per cell.

The counterpart of ``repro/launch/hillclimb.py``, over the port's
:func:`.dryrun.analyze_cell` (a meta-tensor count on the fake production
mesh in place of a compile).  Each iteration is a (hypothesis → change →
re-count → re-analyse) cycle on one cell; results go to
``results/torch_dryrun/<cell>__<tag>.json``.  The optimizations are
config-gated (ModelConfig.seq_sharding / decode_seq_shard / moe_ep /
xent_chunk / remat) so the paper-faithful baseline stays intact.

Usage:
    python -m repro_torch.launch.hillclimb --cell llama3-8b:decode_32k \\
        --opts decode_seq_shard --tag opt1
"""

import argparse
import json
import sys

from ..configs import get_config
from .dryrun import RESULTS_DIR, analyze_cell

OPTS = {
    "seq_sharding": dict(seq_sharding=True),
    "decode_seq_shard": dict(decode_seq_shard=True),
    "moe_ep": dict(moe_ep=True),
    "xent_chunk": dict(xent_chunk=512),
    "no_remat": dict(remat=False),
    "bf16_opt": dict(train_state_dtype="bfloat16"),
    "small_attn_tiles": dict(attn_block_q=512, attn_block_kv=1024),
    "sp_gather_heads": dict(sp_gather_heads=True),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cell", required=True, help="arch:shape")
    ap.add_argument("--opts", nargs="*", default=[], choices=sorted(OPTS))
    ap.add_argument("--tag", default="opt")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--skip-validation", action="store_true")
    args = ap.parse_args(argv)

    arch, shape = args.cell.split(":")
    from ..configs import SHAPES
    overrides = {"remat": SHAPES[shape].kind == "train",
                 "attn_block_q": 2048, "attn_block_kv": 4096}
    for o in args.opts:
        overrides.update(OPTS[o])
    cfg = get_config(arch).with_overrides(**overrides)
    rec = analyze_cell(arch, shape, multi_pod=args.multi_pod,
                       skip_validation=args.skip_validation,
                       cfg_override=cfg, tag=args.tag)
    rec["opts"] = args.opts
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    out = RESULTS_DIR / (f"{arch}__{shape}__"
                         f"{'multi' if args.multi_pod else 'single'}"
                         f"__{args.tag}.json")
    out.write_text(json.dumps(rec, indent=2))
    r = rec["roofline"]
    mem = rec.get("memory", {})
    print(f"[{args.tag}] {args.cell}: dominant={r['dominant']} "
          f"L={r['latency_s']*1e3:.2f}ms "
          f"c={r['compute_s']*1e3:.2f} m={r['memory_s']*1e3:.2f} "
          f"k={r['collective_s']*1e3:.2f} "
          f"mfu={r['roofline_fraction']*100:.2f}% "
          f"peak/dev={mem.get('peak_bytes_per_device', 0)/2**30:.2f}GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
