"""The benchmark loads neither JAX nor the JAX package ``repro`` (top
names compared whole: the port's ``repro_torch`` begins with
``repro``), and reads nothing of the frozen folder of the earlier benchmark."""

import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

PROBE = """
import importlib.util, json, sys
from pathlib import Path
here = Path(sys.argv[1])
sys.path[:0] = [str(here.parent / "src"), str(here)]
spec = importlib.util.spec_from_file_location("run", here / "run.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
import harness.run_cell as rc, harness.check, harness.trace, harness.hooks
import repro_torch.launch.bench_serving, repro_torch.models.serve_lm
names = [p.stem for p in (here / "metrics").glob("*.py")]
rc.readers(names)
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                               "repro"))))
"""


def test_no_jax_and_no_reference_package():
    env = {"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"}
    p = subprocess.run([sys.executable, "-c", PROBE, str(HERE)],
                       capture_output=True, text=True, timeout=300, env=env)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_nothing_reads_the_frozen_folder():
    frozen = "bench" + "marks"
    pattern = re.compile(rf"\b{frozen}\b")
    for path in HERE.rglob("*.py"):
        assert not pattern.search(path.read_text()), path
