"""Readings that a cell's check limit is set from, in one process.

    python3 servebench/calibrate.py --workload <cell> --seeds a,b,c \\
        --seconds <s>

For each seed: weights, prompts and the engine from that seed (the
phase profiles are measured once, for the first), a window of the
cell's traffic, then the check's sample (``harness/check.py``) read
twice: ``gap_max`` of the tokens the program served, and
``control_gap_max`` of the tokens the fp8 control puts first at the same
positions.  One JSON line a seed.  The limit lies between the largest
program reading over a dozen seeds or more and the smallest control
reading (see PERF.md).
"""

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=int, default=20)
    args = ap.parse_args(argv)
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "kernels")
    sys.path[:0] = [str(ROOT / "src"), str(HERE)]
    import torch
    from harness import check, run_cell, traffic
    parts = run_cell.cell(args.workload)
    conf, tr = parts["conf"], parts["traffic"]
    profiles = None
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        served = run_cell.Served(conf, tr, seed, "cuda", profiles=profiles)
        profiles = served.profiles
        arrivals = traffic.arrivals(tr, args.seconds, seed)
        rep, coll = served.window(arrivals, args.seconds, tr, "calibrate")
        r = run_cell.Readings(conf, tr, coll, rep, served.rec, args.seconds,
                              0.0)
        rec, pool, w = served.rec, served.pool, served.weights
        coll.plane = None
        served.release()
        got = check.compare(conf, w, check.sample(rec, pool, coll.epoch,
                                                  seed), control=True)
        print(json.dumps({"seed": seed, "gap_max": got["gap_max"],
                          "control_gap_max": got["control_gap_max"],
                          "served": got["served"], "failed": r.failed,
                          "items": got["items"],
                          "seconds": time.perf_counter() - t0}), flush=True)
        del served, rec, pool, w, coll, rep, r
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
