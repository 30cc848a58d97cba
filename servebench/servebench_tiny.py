"""Tiny stand-ins of the benchmark's cells for the CPU tests.

The configuration keeps the file's block (norms, activation, partial
rotary, the GQA group) at widths a CPU test can run; the traffic keeps the
cell's shape (prompts, output tokens, units, batch cells) at a short
prompt.  ``LIMIT`` is the tiny cells' check limit: tiny bfloat16 runs of
the program read gap_max up to 0.006 (seeds 1-4) and the fp8 control
0.040 and more, so the limit lies between.
"""

import json
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
CELL = "minitron-8b.longdoc-4k-poisson"    # the cell whose metrics a run reads
TRAFFIC = "longdoc-4k-poisson"
CONFIG = "minitron-8b"
LIMIT = 0.02


def conf(config: str = CONFIG) -> dict:
    c = json.loads((HERE / "configs" / f"{config}.json").read_text())
    group = c["n_heads"] // c["n_kv_heads"]
    c.update(d_model=64, n_heads=2 * group, n_kv_heads=2, head_dim=16,
             d_ff=128, vocab_size=512, n_layers=2)
    return c


def traffic() -> dict:
    t = json.loads((HERE / "traffic" / f"{TRAFFIC}.json").read_text())
    t.update(prompt_tokens=64, max_seq=128, max_batch=4, pool=8,
             output_tokens=4, phases=[{"seconds": None, "rate": 20.0}])
    return t


def parts(config: str) -> dict:
    return {"conf": conf(config), "traffic": traffic(),
            "limits": {"gap_max": LIMIT}}


def run(config: str, seed: int, *, engine_hook=None, seconds: int = 3):
    """One tiny run of the cell on the CPU with ``config``'s block;
    returns the result's object."""
    import torch
    from harness import run_cell
    torch.set_num_threads(1)
    return run_cell.run(CELL, seed, seconds, False,
                        t_process=time.perf_counter(), device="cpu",
                        parts=parts(config), engine_hook=engine_hook,
                        log=lambda line: None)


def readings(config: str, seed: int, *, engine_hook=None,
             seconds: int = 3):
    """A tiny window on the CPU, then the check's sample read by the
    reference and by the fp8 control (as ``calibrate.py`` does)."""
    import torch
    from harness import check, run_cell, traffic as gen
    torch.set_num_threads(1)
    p = parts(config)
    served = run_cell.Served(p["conf"], p["traffic"], seed, "cpu",
                             engine_hook=engine_hook)
    _, coll = served.window(gen.arrivals(p["traffic"], seconds, seed),
                            seconds, p["traffic"], CELL)
    items = check.sample(served.rec, served.pool, coll.epoch, seed)
    return check.compare(p["conf"], served.weights, items, control=True)
