"""One train step of the port against the JAX reference on the reduced
configurations that ``tests/test_torch_training.py`` leaves out (a file
of their own, so that the test workers share the seven):
recurrentgemma-9b, deepseek-v2-236b (MLA, MoE with its dense prefix),
seamless-m4t-medium (encoder-decoder over frames) and internvl2-1b
(vision prefix, whose labels are -100 over the patches); and
gemma3-1b's step with ``remat=True`` against the reference's, and
twenty of the launcher's steps.

The check and its tolerances are ``test_torch_training.check_train_step``'s:
fp32, every parameter perturbed, the loss within 1e-5 relative, each
gradient leaf within 1e-4 of its largest |g|, the parameters after the
step within the bound AdamW's first step allows.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.data import pipeline as jpipe  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_loop as jtl  # noqa: E402
from repro_torch.configs import ShapeConfig  # noqa: E402
from repro_torch.data import batches_for_model  # noqa: E402
from repro_torch.training import (AdamWConfig, TrainConfig,  # noqa: E402
                                  init_adamw, make_train_step)
from test_torch_training import _pair, check_train_step  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """Tiny CPU ops run far slower under an oversubscribed intra-op pool
    (several test workers share the host); the tests need one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["recurrentgemma-9b", "deepseek-v2-236b",
                                  "seamless-m4t-medium", "internvl2-1b"])
def test_train_step_matches_reference(name, monkeypatch):
    check_train_step(name, monkeypatch)


def test_remat_train_step_matches_reference(monkeypatch):
    check_train_step("gemma3-1b", monkeypatch, remat=True)


def test_twenty_launcher_steps_follow_the_reference():
    """Twenty steps of the launcher's schedule (AdamW lr 1e-3, warmup 20)
    on reduced gemma3-1b over the synthetic corpus, from the same weights:
    the port's losses and grad norms are the reference's at every step
    (fp32; 1e-4 relative, the steps compound the rounding), so the
    port's training dynamics are the reference's."""
    (jcfg, jp), (tcfg, tp) = _pair("gemma3-1b", scan_layers=True)
    shape = ShapeConfig("t", seq_len=32, global_batch=4, kind="train")
    kw = dict(learning_rate=1e-3, warmup_steps=20, decay_steps=100)
    jstep = jax.jit(jtl.make_train_step(
        jcfg, jtl.TrainConfig(adamw=jopt.AdamWConfig(**kw))))
    tstep = make_train_step(tcfg, TrainConfig(adamw=AdamWConfig(**kw)))
    js = jopt.init_adamw(jopt.AdamWConfig(**kw), jp)
    ts = init_adamw(AdamWConfig(**kw), tp)
    jdata = jpipe.batches_for_model(jcfg, shape, seed=0)
    tdata = batches_for_model(tcfg, shape, seed=0)
    for _ in range(20):
        jp, js, jm = jstep(jp, js, next(jdata))
        tp, ts, tm = tstep(tp, ts, next(tdata))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-4, err_msg=key)
