"""The port's encoder-decoder and vision-prefix models against the JAX
reference, on the CPU.

Configurations: reduced seamless-m4t-medium (pattern (ENC, DEC) × 2:
a bidirectional encoder over precomputed audio frames, a causal decoder
with cross-attention over the encoder's memory and a ``cross_k`` /
``cross_v`` cache; LayerNorm, ReLU) and reduced internvl2-1b (8
precomputed patch embeddings in front of the text, GQA, qkv bias, tied
embeddings), both in fp32, in both parameter layouts.

The reference builds its parameters (``jax.random.PRNGKey(0)``), and
seeded noise is added to every leaf of the numpy tree before it goes to
*both* sides: both packages initialise the qkv biases and LayerNorm
biases to zero, so without it a dropped bias, a bias wrongly added to
the cross-attention query or a swapped norm would pass unseen.

Tolerance (fp32): 2e-4 of the largest logit magnitude, as
``tests/test_torch_models.py``; cache leaves 2e-5.  Both sides compute
in fp32 and differ only in summation order.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import all_configs as jall_configs  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import DEC, ENC, SHAPES  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models.lm import apply_head as japply_head  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.lm import apply_head  # noqa: E402

jax.config.update("jax_enable_x64", False)

TOL = 2e-4
NAMES = ["seamless-m4t-medium", "internvl2-1b"]
NOISE = 0.05


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """Tiny CPU ops run far slower under an oversubscribed intra-op pool
    (several test workers share the host); the tests need one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturb(tree, seed):
    """Every leaf of a reference tree as numpy, plus seeded noise."""
    rng = np.random.default_rng(seed)

    def one(a):
        a = np.asarray(a)
        return (a + NOISE * rng.standard_normal(a.shape)).astype(a.dtype)

    return jax.tree_util.tree_map(one, tree)


class _Jitted:
    """The reference model's entry points under ``jax.jit``."""

    def __init__(self, cfg):
        model = jbuild_model(cfg)
        self.forward = jax.jit(model.forward)
        self.prefill = jax.jit(model.prefill, static_argnames="max_len")
        self.decode_step = jax.jit(model.decode_step)
        self.init = model.init


@functools.lru_cache(maxsize=None)
def _pair(name, *, kernels=False, **kw):
    """Reference model + perturbed params and the port model + the same
    params bridged, built once per module."""
    jcfg = jget_config(name).reduced(dtype="float32", **kw).with_overrides(
        use_pallas_kernels=kernels)
    tcfg = get_config(name).reduced(dtype="float32", **kw).with_overrides(
        use_pallas_kernels=kernels)
    jmodel = _Jitted(jcfg)
    tree = _perturb(jmodel.init(jax.random.PRNGKey(0)), seed=11)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = params_from_numpy(tcfg, tree, device="cpu")
    return (jcfg, jmodel, jparams), (tcfg, build_model(tcfg), tparams)


def _batch(cfg, B, S, seed=0, n_frames=None):
    """A prompt of S positions, as numpy: a vision prompt is P patch
    embeddings then S - P tokens; an enc-dec prompt S tokens over
    ``n_frames`` frames (default: the config's frame count)."""
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.frontend.kind == "vision":
        P = cfg.frontend.n_prefix_tokens
        batch["vision_embeds"] = rng.standard_normal(
            (B, P, cfg.d_model)).astype(np.float32)
        S -= P
    else:
        batch["frames"] = rng.standard_normal(
            (B, n_frames or cfg.frontend.n_frames, cfg.d_model)).astype(
                np.float32)
    batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, S),
                                   dtype=np.int32)
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v).long() if k == "tokens"
            else torch.from_numpy(v) for k, v in batch.items()}


def _rel(got, want, scale):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.max(np.abs(got - np.asarray(want)))) / scale


def _leaves(tree):
    """Leaves in a fixed order, with their paths."""
    if isinstance(tree, dict):
        return [(f"{k}/{p}", x) for k in sorted(tree)
                for p, x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [(f"{i}/{p}", x) for i, v in enumerate(tree)
                for p, x in _leaves(v)]
    return [] if tree is None else [("", tree)]


def _prefill_then_decode(model, params, batch, n_dec, max_len):
    """Logits of prefill(the prompt minus its last n_dec tokens), then one
    decode step per held-back token."""
    is_torch = isinstance(params["embed"], torch.Tensor)
    tok = batch["tokens"]
    prompt = dict(batch, tokens=tok[:, :tok.shape[1] - n_dec])
    start = (prompt["tokens"].shape[1]
             + (batch["vision_embeds"].shape[1] if "vision_embeds" in batch
                else 0))
    logits, cache = model.prefill(params, prompt, max_len=max_len)
    outs = [logits[:, 0]]
    for i in range(n_dec):
        j = tok.shape[1] - n_dec + i
        pos = start + i if is_torch else jnp.int32(start + i)
        logits, cache = model.decode_step(params, cache, tok[:, j:j + 1],
                                          pos)
        outs.append(logits[:, 0])
    return (torch.stack(outs, 1) if is_torch else jnp.stack(outs, 1)), cache


LAYOUTS = [False, True]


@pytest.mark.parametrize("scan_layers", LAYOUTS)
@pytest.mark.parametrize("name", NAMES)
def test_forward_logits_match_reference(name, scan_layers):
    (jcfg, jm, jp), (tcfg, tm, tp) = _pair(name, scan_layers=scan_layers)
    batch = _batch(jcfg, 2, 40)
    want = japply_head(jp, jm.forward(jp, _jax(batch)), jcfg)
    with torch.no_grad():
        got = apply_head(tp, tm.forward(tp, _torch(batch)), tcfg)
    assert got.shape == (2, 40, tcfg.vocab_size)
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want, float(jnp.max(jnp.abs(want)))) < TOL


@pytest.mark.parametrize("scan_layers", LAYOUTS)
@pytest.mark.parametrize("name", NAMES)
def test_prefill_logits_and_every_cache_leaf_match_reference(name,
                                                             scan_layers):
    (jcfg, jm, jp), (tcfg, tm, tp) = _pair(name, scan_layers=scan_layers)
    batch = _batch(jcfg, 2, 36, seed=1, n_frames=24)
    want_logits, want_cache = jm.prefill(jp, _jax(batch), max_len=48)
    with torch.no_grad():
        got_logits, got_cache = tm.prefill(tp, _torch(batch), max_len=48)
    assert _rel(got_logits, want_logits,
                float(jnp.max(jnp.abs(want_logits)))) < TOL
    jl, tl = _leaves(want_cache), _leaves(got_cache)
    assert [p for p, _ in tl] == [p for p, _ in jl] and tl
    if tcfg.is_encdec:
        assert sum("cross_k" in p for p, _ in tl) == (
            1 if scan_layers else tcfg.n_repeats)
    for (path, a), (_, b) in zip(jl, tl):
        assert tuple(b.shape) == tuple(a.shape), path
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-5,
                                   rtol=2e-5, err_msg=path)


@pytest.mark.parametrize("scan_layers", LAYOUTS)
@pytest.mark.parametrize("name", NAMES)
def test_prefill_then_decode_matches_forward_and_reference(name,
                                                           scan_layers):
    (jcfg, jm, jp), (tcfg, tm, tp) = _pair(name, scan_layers=scan_layers)
    n_dec, S = 8, 32
    batch = _batch(jcfg, 2, S, seed=2)
    with torch.no_grad():
        full = apply_head(tp, tm.forward(tp, _torch(batch)), tcfg)
        got, _ = _prefill_then_decode(tm, tp, _torch(batch), n_dec, 40)
    want, _ = _prefill_then_decode(jm, jp, _jax(batch), n_dec, 40)
    scale = float(full.abs().max())
    assert got.shape == (2, n_dec + 1, tcfg.vocab_size)
    # the port's incremental path equals its own full forward ...
    assert _rel(got, full[:, S - n_dec - 1:].numpy(), scale) < TOL
    # ... and the reference's incremental path
    assert _rel(got, want, scale) < TOL


@pytest.mark.parametrize("name", NAMES)
def test_kernel_route_matches_reference_kernels(name):
    """Kernels on both sides: the reference's Pallas kernels in interpret
    mode, the port's wrappers on their CPU route.  Only the decoder's
    self-attention reaches them; encoder and cross-attention stay
    blocked on both sides."""
    (jcfg, jm, jp), (tcfg, tm, tp) = _pair(name, kernels=True)
    assert jcfg.use_pallas_kernels and tcfg.use_pallas_kernels
    batch = _batch(jcfg, 1, 20, seed=4, n_frames=16)
    from repro_torch.kernels import KERNEL_STATS
    before = {n: s.cpu_calls for n, s in KERNEL_STATS.items()}
    with torch.no_grad():
        got, _ = _prefill_then_decode(tm, tp, _torch(batch), 4, 32)
    calls = {n: s.cpu_calls - before[n] for n, s in KERNEL_STATS.items()}
    # one flash call per decoder layer, one decode call per layer a step
    assert calls["flash_attention"] == tcfg.n_repeats
    assert calls["decode_attention"] == 4 * tcfg.n_repeats
    want, _ = _prefill_then_decode(jm, jp, _jax(batch), 4, 32)
    assert _rel(got, want, float(jnp.max(jnp.abs(want)))) < TOL


def test_bridge_carries_the_encoder_norm_and_cross_trees():
    """convert's generic walk: ``enc_final_norm`` and every DEC block's
    ``pre_cross``/``cross`` arrive with the reference's shapes and
    values, in both layouts."""
    for scan_layers in LAYOUTS:
        (jcfg, _, jp), (tcfg, _, tp) = _pair("seamless-m4t-medium",
                                             scan_layers=scan_layers)
        jl, tl = _leaves(jp), _leaves(tp)
        assert [p for p, _ in tl] == [p for p, _ in jl]
        for (path, a), (_, b) in zip(jl, tl):
            assert np.array_equal(b.numpy(), np.asarray(a)), path
        paths = {p for p, _ in tl}
        assert {"enc_final_norm/scale/", "enc_final_norm/bias/"} <= paths
        assert sum("/cross/wq/" in p for p in paths) == (
            1 if scan_layers else tcfg.n_repeats)


# --------------------------------------------------------------------- #
# ENC and DEC blocks alone
# --------------------------------------------------------------------- #
BLOCK_CASES = [(ENC, "train"), (DEC, "train"), (DEC, "prefill"),
               (DEC, "decode")]


@pytest.mark.parametrize("qkv_bias", [False, True])
@pytest.mark.parametrize("kind,mode", BLOCK_CASES)
def test_block_matches_reference(kind, mode, qkv_bias):
    """One block under ``apply_block``.  With ``qkv_bias`` the cross
    tree holds biases too, which the reference never adds: the port must
    not either.  decode runs after a prefill over the same cache."""
    kw = dict(dtype="float32", qkv_bias=qkv_bias)
    jcfg = jget_config("seamless-m4t-medium").reduced(**kw)
    tcfg = get_config("seamless-m4t-medium").reduced(**kw)
    tree = _perturb(jblocks.init_block(jax.random.PRNGKey(3), jcfg, kind),
                    seed=5)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = params_from_numpy(tcfg, {"pattern": [tree] * tcfg.n_repeats},
                           device="cpu")["pattern"][0]
    assert ("cross" in tp) == (kind == DEC)
    if qkv_bias and kind == DEC:
        assert "bq" in tp["cross"]
    rng = np.random.default_rng(6)
    B, S, M, L = 2, 12, 10, 16
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((B, M, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))

    def jrun(m, xx, cache, **k):
        return jax.jit(functools.partial(
            jblocks.apply_block, cfg=jcfg, kind=kind, mode=m,
            **k))(jp, xx, cache=cache)

    def trun(m, xx, cache, **k):
        with torch.no_grad():
            return blocks.apply_block(tp, xx, tcfg, kind, mode=m,
                                      cache=cache, **k)

    jmem = jnp.asarray(mem) if kind == DEC else None
    tmem = torch.from_numpy(mem) if kind == DEC else None
    jcache = tcache = None
    if mode != "train":
        jcache = jblocks.init_block_cache(jcfg, kind, B, L, M)
        tcache = blocks.init_block_cache(tcfg, kind, B, L, M)
    want, jcache = jrun("train" if mode == "train" else "prefill",
                        jnp.asarray(x), jcache, positions=jnp.asarray(pos),
                        memory=jmem)
    got, tcache = trun("train" if mode == "train" else "prefill",
                       torch.from_numpy(x), tcache,
                       positions=torch.from_numpy(pos.copy()), memory=tmem)
    if mode == "decode":
        x1 = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
        want, jcache = jrun("decode", jnp.asarray(x1), jcache,
                            pos=jnp.int32(S))
        got, tcache = trun("decode", torch.from_numpy(x1), tcache, pos=S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    if mode != "train":
        jl, tl = _leaves(jcache), _leaves(tcache)
        assert [p for p, _ in tl] == [p for p, _ in jl] == [
            "cross_k/", "cross_v/", "k/", "v/"]
        for (path, a), (_, b) in zip(jl, tl):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-5,
                                       rtol=2e-5, err_msg=path)


def test_enc_block_has_no_cache_and_dec_needs_memory():
    cfg = get_config("seamless-m4t-medium").reduced(dtype="float32")
    assert blocks.init_block_cache(cfg, ENC, 1, 8, 4) is None
    params = blocks.init_block(torch.Generator(), cfg, DEC)
    x = torch.zeros((1, 4, cfg.d_model))
    with pytest.raises(ValueError, match="memory"):
        blocks.apply_block(params, x, cfg, DEC, mode="train",
                           positions=torch.zeros((1, 4), dtype=torch.int32))


# --------------------------------------------------------------------- #
# input specs, caches, every registered configuration
# --------------------------------------------------------------------- #
ALL = sorted(jall_configs())


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("name", ALL)
def test_input_specs_match_reference(name, shape):
    want = jbuild_model(jget_config(name)).input_specs(SHAPES[shape])
    got = build_model(get_config(name)).input_specs(SHAPES[shape])
    assert list(got) == list(want)
    for key, spec in got.items():
        assert spec.device.type == "meta"
        assert tuple(spec.shape) == tuple(want[key].shape), key
        assert str(spec.dtype).removeprefix("torch.") == str(
            want[key].dtype), key


@pytest.mark.parametrize("scan_layers", LAYOUTS)
@pytest.mark.parametrize("name", ALL)
def test_reduced_config_builds_and_caches_match_reference(name,
                                                          scan_layers):
    """Every registered configuration builds in the port, and
    ``init_cache(memory_len=)`` has the reference's structure, shapes
    and dtypes (None at an ENC position)."""
    jcfg = jget_config(name).reduced(scan_layers=scan_layers)
    tcfg = get_config(name).reduced(scan_layers=scan_layers)
    memory_len = 6 if tcfg.is_encdec else 0
    model = build_model(tcfg)
    params = model.init(0, device="cpu")
    assert params["pattern"]
    want = jax.eval_shape(lambda: jbuild_model(jcfg).init_cache(
        2, 16, memory_len=memory_len))
    got = model.init_cache(2, 16, memory_len, device="cpu")
    wl, gl = _leaves(want), _leaves(got)
    assert [p for p, _ in gl] == [p for p, _ in wl] and gl
    for (path, a), (_, b) in zip(wl, gl):
        assert tuple(b.shape) == tuple(a.shape), path
        assert str(b.dtype).removeprefix("torch.") == str(a.dtype), path
    if tcfg.is_encdec:
        enc = tcfg.pattern.index(ENC)
        layers = [got["pattern"]] if scan_layers else got["pattern"]
        assert all(layer[enc] is None for layer in layers)


# --------------------------------------------------------------------- #
# the serving engine
# --------------------------------------------------------------------- #
def test_engine_prefill_matches_reference_on_the_same_frames():
    """``LmEngine(seamless reduced)``'s functional prefill on the
    reference's weights, tokens and frames: logits and the cross cache."""
    from repro_torch.models.serve_lm import LmEngine
    (jcfg, jm, jp), (tcfg, _, tp) = _pair("seamless-m4t-medium")
    eng = LmEngine(tcfg.with_overrides(use_pallas_kernels=True),
                   max_seq=32, default_seq_bucket=16, device="cpu")
    eng.params = tp
    batch = _batch(jcfg, 2, 16, seed=9)
    want_logits, want_cache = jm.prefill(jp, _jax(batch), max_len=32)
    got_logits, got_cache = eng.prefill(
        batch["tokens"], frames=torch.from_numpy(batch["frames"]))
    assert _rel(got_logits, want_logits,
                float(jnp.max(jnp.abs(want_logits)))) < TOL
    for (path, a), (_, b) in zip(_leaves(want_cache), _leaves(got_cache)):
        assert tuple(b.shape) == tuple(a.shape), path
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-5,
                                   rtol=2e-5, err_msg=path)


@pytest.mark.parametrize("name", NAMES)
def test_engine_serves_every_cell_on_cpu(name):
    """The engine's prompt batches carry the inputs ``input_specs``
    names and fill the bucket; every runner cell runs, through the
    kernels' CPU route."""
    from repro_torch.kernels import KERNEL_STATS
    from repro_torch.models.serve_lm import (PHASE_DECODE, PHASE_PREFILL,
                                             LmEngine)
    cfg = get_config(name).reduced(dtype="float32", use_pallas_kernels=True)
    eng = LmEngine(cfg, max_seq=32, default_seq_bucket=16, device="cpu")
    batch = eng._sample_batch(2, 16)
    fe = cfg.frontend
    if fe.kind == "vision":
        assert batch["vision_embeds"].shape == (2, fe.n_prefix_tokens,
                                                cfg.d_model)
        assert batch["tokens"].shape == (2, 16 - fe.n_prefix_tokens)
    else:
        assert batch["frames"].shape == (2, 16, cfg.d_model)
        assert batch["tokens"].shape == (2, 16)
    before = KERNEL_STATS["flash_attention"].cpu_calls
    make = eng.factory()
    for b in (1, 4):
        assert make(1, b, PHASE_PREFILL)() is None
        assert make(1, b, PHASE_DECODE)() is None
    assert KERNEL_STATS["flash_attention"].cpu_calls > before
    cache, pos = eng._resident[4]
    assert pos == 18        # the prompt's 16 positions, then two steps


def test_vision_bucket_must_exceed_the_patch_prefix():
    from repro_torch.models.serve_lm import LmEngine
    cfg = get_config("internvl2-1b").reduced(dtype="float32",
                                             use_pallas_kernels=True)
    P = cfg.frontend.n_prefix_tokens
    eng = LmEngine(cfg, max_seq=32, default_seq_bucket=P, device="cpu")
    for make in (lambda: eng.prefill_runner(1, 1, P),
                 lambda: eng.decode_runner(1, 1)):
        with pytest.raises(ValueError, match="patch embeddings"):
            make()
    assert eng.prefill_runner(1, 1, 2 * P)() is None
