"""One whole run of a cell on the CPU at a tiny size, and the command's
refusals: no card, or no program beside the benchmark."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(ROOT / "src"), str(HERE)]

pytest.importorskip("torch")

import servebench_tiny  # noqa: E402

KEYS = ("correct", "attempted", "failed", "metrics", "device")


def test_tiny_run_has_the_contracts_keys():
    res = servebench_tiny.run(servebench_tiny.CONFIG, 2 ** 31 + 77)
    assert list(res)[:5] == list(KEYS) and list(res)[-1] == "check"
    assert res["correct"] is True
    assert res["attempted"] == 60 and res["failed"] == 0
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(res["metrics"]) == {m["name"] for m in bench["end_to_end"]}
    for m in res["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert res["check"]["gap_max"]["limit"] == servebench_tiny.LIMIT
    json.dumps(res)


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "servebench/run.py", "--workload",
         "minitron-8b.longdoc-4k-poisson", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _run(ROOT)
    assert p.returncode != 0 and p.stdout == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "servebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    p = _run(tmp_path, env)
    assert p.returncode != 0 and p.stdout == ""
