"""The plain reference against the port's model, on the CPU in float32:
a full forward, and a prefill then decode steps through the cache, for
the configuration's block (and GQA group) at a tiny width."""

import sys
from pathlib import Path

import pytest

sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                str(Path(__file__).resolve().parent)]

torch = pytest.importorskip("torch")

import servebench_tiny  # noqa: E402
from harness import weights  # noqa: E402
from harness.reference import Reference  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("S", [24, 37])
def test_reference_matches_the_port(S):
    from harness.run_cell import model_config
    from repro_torch.models.lm import (apply_head, decode_step, forward,
                                       param_specs, prefill)
    conf = dict(servebench_tiny.conf(), dtype="float32")
    cfg = model_config(conf)
    w = weights.make(conf, 11, "cpu")
    params = weights.program_params(w, conf)
    weights.same_layout(params, param_specs(cfg))
    steps = 4
    tokens = torch.randint(0, conf["vocab_size"], (1, S + steps),
                           generator=torch.Generator().manual_seed(5))
    ref = Reference(conf, w).logits([tokens[0]],
                                    [torch.arange(S + steps)])[0]
    with torch.no_grad():
        full = apply_head(params, forward(params, {"tokens": tokens}, cfg),
                          cfg)[0]
        torch.testing.assert_close(full, ref, rtol=1e-4, atol=1e-4)
        last, cache = prefill(params, {"tokens": tokens[:, :S]}, cfg,
                              max_len=S + steps)
        torch.testing.assert_close(last[0, -1], ref[S - 1], rtol=1e-4,
                                   atol=1e-4)
        for i in range(steps - 1):
            lg, cache = decode_step(params, cache, tokens[:, S + i:S + i + 1],
                                    S + i, cfg)
            torch.testing.assert_close(lg[0, -1], ref[S + i], rtol=1e-4,
                                       atol=1e-4)


def test_layout_mismatch_raises():
    conf = servebench_tiny.conf()
    w = weights.make(conf, 1, "cpu")
    tree = weights.program_params(w, conf)
    other = weights.program_params(weights.make(
        dict(conf, d_ff=64), 1, "cpu"), conf)
    with pytest.raises(ValueError):
        weights.same_layout(tree, other)


def test_weights_follow_the_seed():
    conf = servebench_tiny.conf()
    a, b = weights.make(conf, 2 ** 40 + 3, "cpu"), weights.make(
        conf, 2 ** 40 + 3, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = weights.make(conf, 4, "cpu")
    assert not torch.equal(a["layers.wq"], c["layers.wq"])


@pytest.mark.parametrize("block", [{"act": "silu"}, {"qk_norm": True}],
                         ids=["silu", "qk_norm"])
def test_a_block_the_reference_lacks_raises(block):
    with pytest.raises(ValueError):
        weights.specs(dict(servebench_tiny.conf(), **block))
