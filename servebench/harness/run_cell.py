"""One run of one cell: set-up, the window, the readings, the check.

``run(...)`` returns the result's object and the lines of numbers
compared.  ``run.py`` is the command around it; the CPU tests call it
with ``device="cpu"`` at a tiny size, and the sweep and calibration
tools call its pieces.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from . import check, hooks, traffic, weights
from .trace import SLICE_S, SliceProfiler, load, view

ROOT = Path(__file__).resolve().parents[2]          # the checkout
BENCH = Path(__file__).resolve().parents[1]         # servebench/
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
PHASES = ("prefill", "decode")
# keys of a configuration file that set the program's ModelConfig
WIDTHS = {"d_model": "d_model", "n_heads": "n_heads",
          "n_kv_heads": "n_kv_heads", "head_dim": "head_dim",
          "d_ff": "d_ff", "vocab_size": "vocab_size",
          "n_layers": "n_repeats", "norm": "norm", "norm_eps": "norm_eps",
          "act": "act", "rope_theta": "rope_theta", "rope_pct": "rope_pct",
          "qk_norm": "qk_norm", "dtype": "dtype"}


# --------------------------------------------------------------------- #
# what a cell is made of, found by name
# --------------------------------------------------------------------- #
def bench_file() -> Dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(name: str, bench: Optional[Dict] = None) -> Dict:
    """The cell's entry, configuration, traffic and check limits."""
    bench = bench or bench_file()
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise SystemExit(f"servebench: no workload {name!r} in "
                         "BENCHMARK.json")
    conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    return {"entry": entry,
            "conf": json.loads((ROOT / conf["file"]).read_text()),
            "traffic": json.loads(
                (BENCH / "traffic" / f"{entry['traffic']}.json").read_text()),
            "limits": json.loads(
                (BENCH / "checks" / f"{name}.json").read_text())["limits"]}


def readers(names) -> Dict[str, Callable]:
    """``servebench/metrics/<name>.py``'s ``read`` for each name."""
    out = {}
    for n in names:
        spec = importlib.util.spec_from_file_location(
            f"servebench_metric_{n.replace('.', '_')}",
            BENCH / "metrics" / f"{n}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[n] = mod.read
    return out


def cell_metrics(bench: Dict, name: str, trace: bool) -> List[Dict]:
    """The metrics this cell reports in this kind of run."""
    if not trace:
        return [m for m in bench["end_to_end"]
                if name in m.get("workloads", [name])]
    reported = {m["name"] for m in cell_metrics(bench, name, False)}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in reported
                             else [])]


def drain_s(seconds: float) -> float:
    """The launcher's drain after a window of ``seconds``."""
    from repro_torch.launch.bench_serving import (REAL_DRAIN_FACTOR,
                                                  REAL_DRAIN_MIN_S)
    return max(REAL_DRAIN_MIN_S, REAL_DRAIN_FACTOR * seconds)


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in FORBIDDEN)


# --------------------------------------------------------------------- #
# set-up
# --------------------------------------------------------------------- #
def model_config(conf: Dict):
    """The program's ModelConfig of a configuration file."""
    from repro_torch.configs import get_config
    over = {WIDTHS[k]: conf[k] for k in WIDTHS}
    return get_config(conf["arch"]).with_overrides(use_pallas_kernels=True,
                                                   **over)


def prompt_pool(conf: Dict, tr: Dict, seed: int, device) -> torch.Tensor:
    """POOL prompts of the cell's length, drawn on the device."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return torch.randint(0, conf["vocab_size"],
                         (tr["pool"], tr["prompt_tokens"]), generator=gen,
                         device=device)


class Served:
    """The program set up for a cell: engine, hooks and profiles."""

    def __init__(self, conf: Dict, tr: Dict, seed: int, device: str, *,
                 engine_hook=None, profiles=None) -> None:
        from repro_torch.core.profiler import ProfileSpec, phase_profiles
        from repro_torch.models.lm import param_specs
        from repro_torch.models.serve_lm import LmEngine
        from repro_torch.serving import RealPlane
        self.device = torch.device(device)
        cfg = model_config(conf)
        self.weights = weights.make(conf, seed, self.device)
        self.engine = LmEngine(cfg, seed=seed, max_seq=tr["max_seq"],
                               default_seq_bucket=tr["prompt_tokens"],
                               device=self.device)
        tree = weights.program_params(self.weights, conf)
        weights.same_layout(tree, param_specs(cfg))
        self.engine.params = tree              # the engine's own are freed
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        if engine_hook is not None:
            engine_hook(self.engine)
        self.pool = prompt_pool(conf, tr, seed, self.device)
        self.rec = hooks.Recorder(self.engine, self.pool)
        self.factory = self.rec.factory(self.engine.factory())
        if profiles is None:
            plane = RealPlane(self.factory, tr["units"])
            profiles = phase_profiles(
                plane, ProfileSpec(tr["units"], tr["max_batch"],
                                   thread_values=tuple(tr["thread_values"])),
                PHASES, warmup=1, iters=3)
            self.profile_cells = plane.runner_report()
            plane.close()
        self.profiles = profiles
        if self.device.type == "cuda":
            # the profile's blocks are cached on the streams it ran on; the
            # window's runner threads take other streams, whose first
            # allocations would otherwise find the memory held
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def window(self, arrivals, seconds: float, tr: Dict, name: str):
        """``run_lm_policy``'s packrat path over the arrivals; returns its
        report and the recording collector of the window."""
        from repro_torch.launch import bench_serving
        rc = hooks.RecordingCollector(bench_serving.MetricsCollector)
        with rc.installed(bench_serving):
            rep = bench_serving.run_lm_policy(
                "packrat", arrivals, factory=self.factory,
                profiles=self.profiles, units=tr["units"], duration=seconds,
                initial_batch=tr["max_batch"], max_batch=tr["max_batch"],
                decode_steps=tr["output_tokens"] - 1,
                slo_by_phase={p: tr["slo_ms"][p] * 1e-3 for p in PHASES},
                reconfigure_timeout=tr["reconfigure_timeout_s"],
                dispatch="continuous", real_model=name)
        return rep, rc.instances[0]

    def release(self) -> None:
        """Free the program's state; the weights stay for the check."""
        self.engine = self.factory = None
        self.rec.release()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


# --------------------------------------------------------------------- #
# the readings of a window
# --------------------------------------------------------------------- #
class Readings:
    """What the metric readers read: the requests, the runner calls, the
    trace view, the cell.  Times are on ``time.perf_counter``."""

    def __init__(self, conf, tr, coll, rep, rec, seconds, setup_s,
                 view=None) -> None:
        self.conf, self.traffic, self.report = conf, tr, rep
        self.setup_s = setup_s
        self.epoch = coll.epoch
        self.seconds = seconds
        self.end = seconds + drain_s(seconds)
        self.arrivals = coll.offered_at                   # id -> arrival
        self.responses = coll.done
        if coll.epoch is None:
            raise RuntimeError("the window served no request")
        self.calls = [c for c in rec.calls if c.t0 >= coll.epoch]
        self.view = view
        first = {r[0]: r[3] for r in coll.done if r[1] == "prefill"}
        self.ttft_s = [first.get(i, max(self.end, a)) - a
                       for i, a in self.arrivals.items()]
        self.tpot_s = [r[3] - r[2] for r in coll.done if r[1] == "decode"]
        self.prefill_done = len(first)
        self.chains_done = sum(1 for r in coll.done
                               if r[1] == "decode" and r[5] == 1)

    def summary(self) -> Dict:
        """Counts and tails of the window, for the log."""
        from .stats import percentile
        return {"offered": len(self.arrivals),
                "prefill_done": self.prefill_done,
                "decode_done": len(self.tpot_s),
                "chains_done": self.chains_done, "failed": self.failed,
                "ttft_ms": [percentile(self.ttft_s, q) * 1e3
                            for q in (50, 95, 100)],
                "tpot_ms": [percentile(self.tpot_s, q) * 1e3
                            for q in (50, 95, 100)] if self.tpot_s else None,
                "ttft_mean_p90_ms": [sum(self.ttft_s) / len(self.ttft_s)
                                     * 1e3,
                                     percentile(self.ttft_s, 90) * 1e3],
                "tpot_mean_p90_ms": [sum(self.tpot_s) / len(self.tpot_s)
                                     * 1e3,
                                     percentile(self.tpot_s, 90) * 1e3]
                if self.tpot_s else None,
                "calls": {p: len(self.phase_calls(p)) for p in PHASES}}

    def phase_calls(self, phase: str):
        return [c for c in self.calls if c.phase == phase]

    def items(self, phase: str) -> List[int]:
        """Batch sizes of the phase's responses (one per request)."""
        return [r[4] for r in self.responses if r[1] == phase]

    @property
    def failed(self) -> int:
        if self.traffic["output_tokens"] > 1:
            return len(self.arrivals) - self.chains_done
        return len(self.arrivals) - self.prefill_done


# --------------------------------------------------------------------- #
def device_info(device) -> Dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    import subprocess
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = "unread"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "power_limit": limit}


def run(name: str, seed: int, seconds: int, trace: bool, *,
        t_process: float, device: str = "cuda", bench: Optional[Dict] = None,
        parts: Optional[Dict] = None, engine_hook=None,
        log=print) -> Dict:
    """One run; returns the result's object (``check`` last)."""
    bench = bench or bench_file()
    parts = parts or cell(name, bench)
    conf, tr, limits = parts["conf"], parts["traffic"], parts["limits"]
    wanted = cell_metrics(bench, name, trace)
    read = readers([m["name"] for m in wanted])
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    served = Served(conf, tr, seed, device, engine_hook=engine_hook)
    arrivals = traffic.arrivals(tr, seconds, seed)
    info = device_info(dev)
    log(json.dumps({"servebench": "setup", "cell": name, "seed": seed,
                    "kernel_build_s": served.engine.kernel_build_s,
                    "profile_cells_compile_ms":
                        served.profile_cells["compile_ms"],
                    "profiles_ms": {p: {f"{t},{b}": v * 1e3 for (t, b), v
                                        in sorted(served.profiles[p].items())}
                                    for p in PHASES},
                    "offered": len(arrivals), "device": info}))
    t_window = time.perf_counter()
    setup_s = t_window - t_process
    prof = None
    if trace:
        prof = SliceProfiler(t_window + 0.5 * seconds - 0.5 * SLICE_S)
        prof.begin()
    rep, coll = served.window(arrivals, seconds, tr, name)
    if prof is not None:
        prof.join()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        info["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    readings = Readings(conf, tr, coll, rep, served.rec, seconds, setup_s)
    log(json.dumps({"servebench": "window", **readings.summary(),
                    "redispatched": rep.get("redispatched"),
                    "profiler_blocked_s": prof.blocked if prof else None,
                    "runner_cache": rep["runner_cache"],
                    "unit_split": rep["unit_split"],
                    "reconfigurations": {p: rep["servers"][p][
                        "reconfigurations"] for p in PHASES},
                    "memory_peak_bytes": info.get("memory_peak_bytes")}))

    tv = None
    if prof is not None:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export(path)
            tv = view(load(path), prof.marks, prof.bounds, served.rec.calls)
        log(json.dumps({"servebench": "trace", "records": len(tv.device),
                        "launches": len(tv.launches),
                        "launches_in_a_call": tv.attributed,
                        "threads": tv.threads}))
    readings.view = tv
    metrics = {}
    for m in wanted:
        value = read[m["name"]](readings)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    rec, pool = served.rec, served.pool
    coll.plane = None
    served.release()
    items = check.sample(rec, pool, coll.epoch, seed)
    got = check.compare(conf, served.weights, items)
    log(json.dumps({"servebench": "check", **got}))
    compared = {"gap_max": {"value": got["gap_max"],
                            "limit": limits["gap_max"]}}
    correct = all(v["value"] <= v["limit"] for v in compared.values())
    result = {"correct": correct, "attempted": len(arrivals),
              "failed": readings.failed, "metrics": metrics, "device": info}
    if tv is not None:
        info["busy_s"] = tv.busy_s
        info["window_s"] = tv.window_s
        result["breakdown"] = {"device_ops": tv.top_ops(),
                               "idle_gaps": tv.idle_gaps(readings.calls)}
    result["check"] = compared
    return result
