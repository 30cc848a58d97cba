"""The serving benchmark of ``repro_torch`` on one H100.

    python3 servebench/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` once: builds the program's kernels
(once per checkout, under ``build/kernels``), makes the weights and
prompts from the seed on the card, sets up ``LmEngine`` and Packrat's
phase profiles, serves the cell's arrivals through ``run_lm_policy``'s
packrat path for ``--seconds`` (and the launcher's drain), then checks
what was served against the plain reference.  The last line of standard
output is the result's JSON object; the numbers compared, with their
limits, are the last lines of standard error.  With ``--trace 1`` the
metrics are the cell's per-layer ones, read from a profiled slice of the
window.  Exits non-zero without a CUDA card, or if JAX or the JAX
package was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seconds < 1:
        ap.error("--seconds must be at least 1")
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("servebench: needs a CUDA card", file=sys.stderr)
        return 2
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "kernels")
    sys.path[:0] = [str(ROOT / "src"), str(HERE)]
    from harness import run_cell
    result = run_cell.run(
        args.workload, args.seed, args.seconds, bool(args.trace),
        t_process=T_PROCESS,
        log=lambda line: print(line, file=sys.stderr, flush=True))
    found = run_cell.forbidden_modules()
    if found:
        print(f"servebench: loaded {found}", file=sys.stderr)
        return 3
    for name, v in result["check"].items():
        print(f"{name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
