"""``correct`` comes out false for the control and for each fault a
serving cell can have, planted under the benchmark's hooks at a tiny
size on the CPU (the exchange between chips has no place on one card).
"""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent / "src"), str(HERE)]

torch = pytest.importorskip("torch")

import servebench_tiny  # noqa: E402



def _tree(fn, t):
    if isinstance(t, dict):
        return {k: _tree(fn, v) for k, v in t.items()}
    if isinstance(t, list):
        return [_tree(fn, v) for v in t]
    return None if t is None else fn(t)


def state_unchanged(engine):
    """Each decode step runs on a copy: the resident cache never moves."""
    step = engine.decode_step

    def decode_step(cache, tokens, pos):
        logits, _ = step(_tree(torch.clone, cache), tokens, pos)
        return logits, cache
    engine.decode_step = decode_step


def half_batch(engine):
    """A prefill computes the first half of its rows; the rest get the
    mean of that half."""
    prefill = engine.prefill

    def run(tokens, **kw):
        b = tokens.shape[0]
        if b < 2:
            return prefill(tokens, **kw)
        logits, cache = prefill(tokens[:b // 2], **kw)

        def fill(x, dim):
            mean = x.float().mean(dim, keepdim=True).to(x.dtype)
            shape = list(x.shape)
            shape[dim] = b - b // 2
            return torch.cat([x, mean.expand(shape)], dim)
        # cache leaves are (layers, batch, ...), the logits (batch, ...)
        return fill(logits, 0), _tree(lambda x: fill(x, 1), cache)
    engine.prefill = run


def token_altered(engine):
    """Every decode step's best token loses to its neighbour in the
    vocabulary."""
    step = engine.decode_step

    def decode_step(cache, tokens, pos):
        logits, cache = step(cache, tokens, pos)
        logits = logits.clone()
        best = logits.argmax(-1, keepdim=True)
        top = logits.gather(-1, best)
        logits.scatter_(-1, (best + 1) % logits.shape[-1], top + 1.0)
        return logits, cache
    engine.decode_step = decode_step


@pytest.mark.parametrize("seed", [2 ** 33 + 5, 2 ** 33 + 6])
def test_control_fails_the_limit(seed):
    got = servebench_tiny.readings(servebench_tiny.CONFIG, seed)
    assert got["gap_max"] <= servebench_tiny.LIMIT
    assert got["control_gap_max"] > servebench_tiny.LIMIT


@pytest.mark.parametrize("fault", [state_unchanged, half_batch,
                                   token_altered],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(fault):
    res = servebench_tiny.run("minitron-8b", 2 ** 32 + 9, engine_hook=fault)
    assert res["correct"] is False, res["check"]
