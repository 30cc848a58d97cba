"""Find a cell's knee: one set-up, then windows at fixed rates.

    python3 servebench/sweep.py --workload <cell> --seed <n> \\
        --seconds <s> --rates 2,3,4,... [--seeds a,b,...] \\
        [--reconfigure-timeout <s>]

Sets the cell's program up once (weights, engine, phase profiles), then
serves the cell's traffic at each rate in turn for ``--seconds`` (and
the launcher's drain) and prints one JSON line a rate: prompts offered
and completed, the TTFT and TPOT tails, and the prefill backlog (prompts
arrived, first token not yet served) at the window's middle and end.
With ``--seeds`` each rate is served once for each of those seeds'
arrivals (the weights stay those of ``--seed``); ``--reconfigure-timeout``
replaces the traffic file's re-planning period.
The knee is the highest rate at which every prompt completes and the
backlog at the end is no larger than at the middle; a cell's rate is
set at about 0.8 of it, once, and written into its traffic file.
"""

import argparse
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
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, default=20)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seeds", default=None)
    ap.add_argument("--reconfigure-timeout", type=float, default=None)
    args = ap.parse_args(argv)
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "kernels")
    sys.path[:0] = [str(ROOT / "src"), str(HERE)]
    from harness import run_cell, traffic
    parts = run_cell.cell(args.workload)
    tr = parts["traffic"]
    if args.reconfigure_timeout is not None:
        tr = dict(tr, reconfigure_timeout_s=args.reconfigure_timeout)
    seeds = [int(s) for s in args.seeds.split(",")] if args.seeds \
        else [args.seed]
    t0 = time.perf_counter()
    served = run_cell.Served(parts["conf"], tr, args.seed, "cuda")
    print(json.dumps({"setup_s": time.perf_counter() - t0}), flush=True)
    for rate, seed in ((float(r), s) for r in args.rates.split(",")
                       for s in seeds):
        tr_r = dict(tr, phases=[{"seconds": None, "rate": rate}])
        arrivals = traffic.arrivals(tr_r, args.seconds, seed)
        rep, coll = served.window(arrivals, args.seconds, tr_r, "sweep")
        r = run_cell.Readings(parts["conf"], tr_r, coll, rep, served.rec,
                              args.seconds, 0.0)
        first = [x[3] for x in coll.done if x[1] == "prefill"]
        arr = list(coll.offered_at.values())
        print(json.dumps({
            "rate": rate, "seed": seed,
            "reconfigure_timeout_s": tr["reconfigure_timeout_s"],
            **r.summary(),
            "backlog_mid": traffic.backlog(arr, first, args.seconds / 2),
            "backlog_end": traffic.backlog(arr, first, args.seconds),
            "prefill_batch_mean": len(first) / max(1e-9, sum(
                1.0 / x[4] for x in coll.done if x[1] == "prefill")),
            "unit_split": rep["unit_split"],
            "reconfigurations": {p: rep["servers"][p]["reconfigurations"]
                                 for p in run_cell.PHASES}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
