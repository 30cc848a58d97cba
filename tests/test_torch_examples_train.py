"""``examples/train_small_torch.py`` on the CPU, at the example's full
width (d_model 512, 8 layers, vocab 32768, B = 8, S = 256).

Two steps, then a third with the same ``--ckpt``: the second run
resumes from the first's checkpoint.  The ``params=`` count it prints
is the reference model's for the same reduced configuration, counted
through the JAX package's parameter shapes (``jax.eval_shape`` of its
``init``); the port's exact count equals it too.
"""

import functools
import math
import re
import shutil

import pytest

torch = pytest.importorskip("torch")

from test_torch_examples import run_example  # noqa: E402

# examples/train_small.py's flags for the model
ARCH, D_MODEL, LAYERS, VOCAB = "llama3-8b", 512, 8, 32768
FLAGS = ["--arch", ARCH, "--reduced", "--d-model", str(D_MODEL),
         "--layers", str(LAYERS), "--vocab", str(VOCAB), "--batch", "8",
         "--seq", "256", "--lr", "1e-3"]
PARAMS = re.compile(r"\[train\] arch=(\S+) params=(\d+\.\d)M devices=1$",
                    re.M)
STEP = re.compile(r"\[train\] step= *(\d+) loss=(\d+\.\d+) ", re.M)


@functools.cache
def reference_param_count() -> int:
    """The reference launcher's model for these flags
    (``repro/launch/train.py``'s reduction), counted by
    ``jax.eval_shape``: no parameter is materialised."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config
    from repro.models import build_model
    cfg = get_config(ARCH)
    cfg = cfg.reduced(n_repeats=max(1, LAYERS // max(1, len(cfg.pattern))),
                      d_model=D_MODEL, n_heads=max(4, D_MODEL // 64),
                      d_ff=D_MODEL * 3, vocab_size=VOCAB)
    shapes = jax.eval_shape(build_model(cfg).init, jax.random.PRNGKey(0))
    return sum(math.prod(x.shape) for x in jax.tree_util.tree_leaves(shapes))


def test_port_parameter_count_equals_the_reference_exactly():
    from repro_torch.launch import train
    from repro_torch.models.lm import param_count, param_specs
    cfg, _, _ = train.configure(train.parse_args(FLAGS))
    assert param_count(param_specs(cfg)) == reference_param_count()


def test_train_small_counterpart_resumes_from_its_checkpoint(tmp_path):
    ckpt = tmp_path / "ckpt"
    try:
        first = run_example("train_small_torch.py", "--device", "cpu",
                            "--steps", "2", "--ckpt", str(ckpt),
                            timeout=600)
        assert first.returncode == 0, first.stderr
        assert "resumed" not in first.stdout
        second = run_example("train_small_torch.py", "--device", "cpu",
                             "--steps", "3", "--ckpt", str(ckpt),
                             timeout=600)
        assert second.returncode == 0, second.stderr
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    assert "[train] resumed from step 2\n" in second.stdout
    want = f"{reference_param_count() / 1e6:.1f}"
    for out in (first, second):
        arch, millions = PARAMS.search(out.stdout).groups()
        assert arch == f"{ARCH}-smoke" and millions == want
    steps = [(int(s), float(loss)) for s, loss in
             STEP.findall(first.stdout + second.stdout)]
    assert [s for s, _ in steps] == [2, 3]
    assert all(math.isfinite(loss) for _, loss in steps)
