"""The port's data pipeline against the JAX reference's, on the CPU.

``tokens`` and ``labels`` come from numpy on both sides, so they must be
byte-identical for the same ``DataConfig`` (seed, host sharding, label
prefix), batch after batch, and through ``batches_for_model`` for the
plain, the vision-prefix and the encoder-decoder configurations.  The
frontend stubs (``vision_embeds``, ``frames``) are drawn by
``torch.Generator`` in the port and by ``jax.random`` in the reference:
only their keys, shapes and dtypes are compared, and that the port's
are reproducible from the seed.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import ShapeConfig as JShapeConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402

DATA_CASES = {
    "seed-0": dict(vocab_size=256, seq_len=16, batch_size=4),
    "seed-7": dict(vocab_size=1000, seq_len=33, batch_size=3, seed=7),
    "host-0-of-2": dict(vocab_size=512, seq_len=16, batch_size=2, seed=7,
                        host_id=0, host_count=2),
    "host-1-of-2": dict(vocab_size=512, seq_len=16, batch_size=2, seed=7,
                        host_id=1, host_count=2),
    "host-3-of-4": dict(vocab_size=100_000, seq_len=24, batch_size=2,
                        seed=3, host_id=3, host_count=4),
}


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    assert got.numpy().tobytes() == want.tobytes()


def test_corpus_matches_reference():
    for vocab in (100, 70_000):
        t, j = tpipe.SyntheticCorpus(vocab, seed=5), jpipe.SyntheticCorpus(
            vocab, seed=5)
        np.testing.assert_array_equal(t.succ, j.succ)
        np.testing.assert_array_equal(t.w, j.w)


@pytest.mark.parametrize("case", sorted(DATA_CASES))
@pytest.mark.parametrize("ignore_prefix", [0, 3])
def test_token_batches_byte_identical(case, ignore_prefix):
    kw = DATA_CASES[case]
    t = tpipe.token_batches(tpipe.DataConfig(**kw),
                            ignore_prefix=ignore_prefix)
    j = jpipe.token_batches(jpipe.DataConfig(**kw),
                            ignore_prefix=ignore_prefix)
    for tb, jb in itertools.islice(zip(t, j), 3):
        assert set(tb) == set(jb) == {"tokens", "labels"}
        _same(tb["tokens"], jb["tokens"])
        _same(tb["labels"], jb["labels"])


def test_token_batches_without_labels_and_host_shards_differ():
    kw = DATA_CASES["host-0-of-2"]
    tb = next(tpipe.token_batches(tpipe.DataConfig(**kw), with_labels=False))
    jb = next(jpipe.token_batches(jpipe.DataConfig(**kw), with_labels=False))
    assert set(tb) == set(jb) == {"tokens"}
    _same(tb["tokens"], jb["tokens"])
    other = next(tpipe.token_batches(tpipe.DataConfig(**DATA_CASES[
        "host-1-of-2"])))
    assert not torch.equal(tb["tokens"], other["tokens"])


@pytest.mark.parametrize("name", ["gemma3-1b", "internvl2-1b",
                                  "seamless-m4t-medium"])
def test_batches_for_model_match_reference(name):
    """Tokens and labels byte-identical (a vision prefix's labels -100),
    the frontend leaves with the reference's keys, shapes and dtypes."""
    jcfg, tcfg = jget_config(name).reduced(), get_config(name).reduced()
    jshape = JShapeConfig("t", seq_len=24, global_batch=2, kind="train")
    tshape = ShapeConfig("t", seq_len=24, global_batch=2, kind="train")
    t = tpipe.batches_for_model(tcfg, tshape, seed=4)
    j = jpipe.batches_for_model(jcfg, jshape, seed=4)
    again = next(tpipe.batches_for_model(tcfg, tshape, seed=4))
    for i, (tb, jb) in enumerate(itertools.islice(zip(t, j), 2)):
        assert list(tb) == list(jb)
        _same(tb["tokens"], jb["tokens"])
        _same(tb["labels"], jb["labels"])
        assert tb["labels"].shape == (2, 24)
        for key in set(tb) - {"tokens", "labels"}:
            assert tuple(tb[key].shape) == tuple(jb[key].shape), key
            assert str(tb[key].dtype).removeprefix("torch.") == str(
                jnp.dtype(jb[key].dtype)), key
            assert bool(torch.isfinite(tb[key].float()).all())
            if i == 0:
                assert torch.equal(tb[key], again[key])
    if tcfg.frontend is not None and tcfg.frontend.kind == "vision":
        P = tcfg.frontend.n_prefix_tokens
        assert bool((tb["labels"][:, :P] == -100).all())
