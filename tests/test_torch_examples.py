"""The port's counterparts of the ``examples/`` scripts on the CPU.

* ``quickstart_torch.py`` and ``reconfigure_live_torch.py`` print, byte
  for byte, what ``quickstart.py`` and ``reconfigure_live.py`` print;
  ``bench_scenarios_torch.py`` writes ``bench_scenarios.py``'s JSON
  report byte for byte.  Both sides run as subprocesses, as a user runs
  them (``PYTHONPATH=src python examples/<name>.py``).
* ``serve_online_torch.py --device cpu`` with a shorter run completes
  every request and prints the reference launcher's three kinds of
  line.

``train_small_torch.py`` has a file of its own
(``test_torch_examples_train.py``): it trains the example's full-width
model.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
# the reference launcher's lines (repro/launch/serve.py)
SERVE_LINES = {
    "count": re.compile(r"\[serve\] arch=(\S+) requests=(\d+) "
                        r"completed=(\d+)$"),
    "latency": re.compile(r"\[serve\] latency mean=\d+\.\dms "
                          r"p50=\d+\.\dms p99=\d+\.\dms$"),
    "reconfig": re.compile(r"\[serve\] t= *\d+\.\ds reconfig B= *\d+ -> "
                           r"\[.+\] L=\d+\.\d+ms$"),
}


def run_example(script: str, *args: str, timeout: float = 300.0):
    """``python examples/<script> <args>`` from the repo's root with
    ``PYTHONPATH=src`` and one intra-op thread (test workers share the
    host): the finished process."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, str(EXAMPLES / script), *args],
                          capture_output=True, text=True, cwd=ROOT,
                          env=env, timeout=timeout)


@pytest.mark.parametrize("name", ["quickstart", "reconfigure_live",
                                  "bench_scenarios"])
def test_simulated_example_matches_the_reference_byte_for_byte(name):
    ref = run_example(f"{name}.py")
    port = run_example(f"{name}_torch.py")
    assert ref.returncode == 0, ref.stderr
    assert port.returncode == 0, port.stderr
    assert ref.stdout and port.stdout == ref.stdout
    if name == "bench_scenarios":
        report = json.loads(port.stdout)
        sc = report["scenarios"]["diurnal"]
        assert {"static", "packrat"} <= set(sc["policies"])
    if name == "reconfigure_live":
        m = re.search(r"completed (\d+)/(\d+) requests; "
                      r"reconfigurations: (\d+)", port.stdout)
        assert m and m.group(1) == m.group(2) and int(m.group(3)) >= 1


def test_serve_online_counterpart_completes_every_request_on_cpu():
    out = run_example("serve_online_torch.py", "--device", "cpu",
                      "--duration", "4", "--rate-step", "2")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    kinds = [next((k for k, rx in SERVE_LINES.items() if rx.match(ln)), ln)
             for ln in lines]
    assert kinds[:2] == ["count", "latency"]
    assert set(kinds[2:]) == {"reconfig"} and len(kinds) >= 4
    arch, requests, completed = SERVE_LINES["count"].match(lines[0]).groups()
    assert arch == "gemma3-1b" and int(requests) == int(completed) > 0
