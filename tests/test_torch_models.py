"""The port's decoder models against the JAX reference, on the CPU.

The reference builds its parameters (``jax.random.PRNGKey(0)``); the
weight bridge (``repro_torch.models.convert.params_from_numpy``) carries
them over as numpy arrays, so both sides run the same weights on the
same seeded tokens.  Configurations: ``lm-tiny`` (reduced gemma3-1b:
5 local + 1 global layer, window 64, qk-norm, sandwich norms, tied and
scaled embeddings, head dim 16), reduced llama3-8b (GQA, SwiGLU) and
reduced deepseek-v2-236b / deepseek-v3-671b (MLA with q-LoRA, dense
prefix layers, 8 routed experts top-2 with shared experts; the reduced
capacity factor is dropless, as the reference's ``reduced()`` sets it).

Tolerance (fp32): 2e-4 of the largest logit magnitude, the reference's
own bound for prefill + decode == forward (``tests/test_models.py``).
Both sides compute in fp32; they differ only in summation order (XLA's
and PyTorch's CPU matmuls and einsums, the port's kernel route vs the
reference's blocked attention), which moves logits by ~1e-6 here.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models.lm import apply_head as japply_head  # noqa: E402
from repro.models.serve_lm import lm_tiny_config as jlm_tiny  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.lm import apply_head  # noqa: E402
from repro_torch.models.serve_lm import lm_tiny_config  # noqa: E402

jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """Tiny CPU ops run far slower under an oversubscribed intra-op pool
    (several test workers share the host); the tests need one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 2e-4


def _configs(name, **kw):
    """(reference cfg, port cfg) of one architecture, reduced alike."""
    if name == "lm-tiny":
        return jlm_tiny().with_overrides(**kw), lm_tiny_config() \
            .with_overrides(**kw)
    return (jget_config(name).reduced(dtype="float32", **kw),
            get_config(name).reduced(dtype="float32", **kw))


class _Jitted:
    """The reference model's entry points under ``jax.jit`` (the suite's
    CPU budget: eager JAX dispatches op by op)."""

    def __init__(self, cfg):
        model = jbuild_model(cfg)
        self.forward = jax.jit(model.forward)
        self.prefill = jax.jit(model.prefill, static_argnames="max_len")
        self.decode_step = jax.jit(model.decode_step)
        self.init = model.init


@functools.lru_cache(maxsize=None)
def _pair(name, *, jax_kernels=False, **kw):
    """Reference model + params and the port model + bridged params, built
    once per module (nothing mutates parameters).  The port routes
    attention through its kernels' CPU route whenever its config says so;
    the reference runs its jnp path unless asked."""
    jcfg, tcfg = _configs(name, **kw)
    jcfg = jcfg.with_overrides(use_pallas_kernels=jax_kernels)
    jmodel = _Jitted(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return (jcfg, jmodel, jparams), (tcfg, build_model(tcfg), tparams)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S),
                                                dtype=np.int32)


def _rel(got, want, scale):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.max(np.abs(got - np.asarray(want)))) / scale


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


ARCHS = ["lm-tiny", "llama3-8b", "deepseek-v2-236b", "deepseek-v3-671b"]


@pytest.mark.parametrize("name", ARCHS)
def test_forward_logits_match_reference(name):
    (jcfg, jm, jp), (tcfg, tm, tp) = _pair(name)
    tok = _tokens(jcfg, 2, 96)
    want = japply_head(jp, jm.forward(jp, {"tokens": jnp.asarray(tok)}),
                       jcfg)
    with torch.no_grad():
        got = apply_head(tp, tm.forward(tp, {"tokens": torch.from_numpy(
            tok).long()}), tcfg)
    assert got.shape == (2, 96, tcfg.vocab_size)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    scale = float(jnp.max(jnp.abs(want)))
    assert _rel(got, want, scale) < TOL


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_logits_and_cache_match_reference(name):
    (jcfg, jm, jp), (tcfg, tm, tp) = _pair(name)
    tok = _tokens(jcfg, 2, 80, seed=1)         # > the reduced window (64)
    want_logits, want_cache = jm.prefill(jp, {"tokens": jnp.asarray(tok)},
                                         max_len=96)
    with torch.no_grad():
        got_logits, got_cache = tm.prefill(
            tp, {"tokens": torch.from_numpy(tok).long()}, max_len=96)
    scale = float(jnp.max(jnp.abs(want_logits)))
    assert _rel(got_logits, want_logits, scale) < TOL
    jl, tl = _leaves(want_cache), _leaves(got_cache)
    assert len(jl) == len(tl) > 0
    for a, b in zip(jl, tl):
        assert tuple(b.shape) == tuple(a.shape)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-5,
                                   rtol=2e-5)


def _prefill_then_decode(model, params, cfg, tok, n_pre, max_len):
    """Logits of prefill(tok[:, :n_pre]) then one decode per token."""
    is_torch = isinstance(params["embed"], torch.Tensor)
    if is_torch:
        tok = torch.from_numpy(tok).long()
    else:
        tok = jnp.asarray(tok)
    logits, cache = model.prefill(params, {"tokens": tok[:, :n_pre]},
                                  max_len=max_len)
    outs = [logits[:, 0]]
    for i in range(n_pre, tok.shape[1]):
        pos = i if is_torch else jnp.int32(i)
        logits, cache = model.decode_step(params, cache, tok[:, i:i + 1],
                                          pos)
        outs.append(logits[:, 0])
    if is_torch:
        return torch.stack(outs, 1)
    return jnp.stack(outs, 1)


@pytest.mark.parametrize("name,B,S,n_dec", [
    ("lm-tiny", 2, 24, 4),
    ("llama3-8b", 2, 24, 4),
    ("lm-tiny", 1, 96, 8),         # decodes past the sliding window (64)
    ("deepseek-v2-236b", 2, 24, 4),    # absorbed latent decode
    ("deepseek-v3-671b", 2, 24, 4),
])
def test_prefill_then_decode_matches_forward_and_reference(name, B, S,
                                                           n_dec):
    (jcfg, jm, jp), (tcfg, tm, tp) = _pair(name)
    tok = _tokens(jcfg, B, S, seed=2)
    n_pre = S - n_dec
    with torch.no_grad():
        full = apply_head(tp, tm.forward(tp, {"tokens": torch.from_numpy(
            tok).long()}), tcfg)
        got = _prefill_then_decode(tm, tp, tcfg, tok, n_pre, S)
    want = _prefill_then_decode(jm, jp, jcfg, tok, n_pre, S)
    scale = float(full.abs().max())
    # the port's incremental path equals its own full forward ...
    assert _rel(got, full[:, n_pre - 1:].numpy(), scale) < TOL
    # ... and the reference's incremental path
    assert _rel(got, want, scale) < TOL


def test_stacked_params_through_the_bridge():
    """scan_layers parameters (leaves (R, ...)) bridge and run unchanged,
    and the stacked cache is written in place through its views."""
    (jcfg, jm, jp), (tcfg, tm, tp) = _pair("gemma3-1b", n_repeats=2,
                                           scan_layers=True)
    assert tcfg.scan_layers and tp["pattern"][0]["attn"]["wq"].shape[0] == 2
    tok = _tokens(jcfg, 2, 40, seed=3)
    want = japply_head(jp, jm.forward(jp, {"tokens": jnp.asarray(tok)}),
                       jcfg)
    with torch.no_grad():
        full = apply_head(tp, tm.forward(tp, {"tokens": torch.from_numpy(
            tok).long()}), tcfg)
        inc = _prefill_then_decode(tm, tp, tcfg, tok, 36, 40)
    scale = float(jnp.max(jnp.abs(want)))
    assert _rel(full, want, scale) < TOL
    assert _rel(inc, full[:, 35:].numpy(), scale) < TOL


def test_kernel_route_matches_reference_kernels():
    """lm-tiny with kernels on both sides: the reference's Pallas
    kernels (interpret mode) and the port's kernel wrappers (their plain
    versions on the CPU) give the same prefill + decode logits."""
    (jcfg, jm, jp), (tcfg, tm, tp) = _pair("lm-tiny", jax_kernels=True)
    assert jcfg.use_pallas_kernels and tcfg.use_pallas_kernels
    tok = _tokens(jcfg, 1, 20, seed=4)
    with torch.no_grad():
        got = _prefill_then_decode(tm, tp, tcfg, tok, 16, 32)
    want = _prefill_then_decode(jm, jp, jcfg, tok, 16, 32)
    scale = float(jnp.max(jnp.abs(want)))
    assert _rel(got, want, scale) < TOL


def test_stacked_moe_params_through_the_bridge():
    """deepseek-v2's stacked layout: the MLA and MoE leaves, the fp32
    router and the (R, E, d, ff) experts, bridge and run unchanged; the
    stacked c_kv/k_rope caches are written through their views."""
    (jcfg, jm, jp), (tcfg, tm, tp) = _pair("deepseek-v2-236b",
                                           scan_layers=True)
    moe = tp["pattern"][0]["moe"]
    assert tcfg.scan_layers and moe["router"].dtype == torch.float32
    assert tuple(moe["gate"].shape) == (2, 8, 64, 64)
    assert "mlp" in tp["prefix"][0] and "moe" not in tp["prefix"][0]
    tok = _tokens(jcfg, 2, 40, seed=3)
    want = japply_head(jp, jm.forward(jp, {"tokens": jnp.asarray(tok)}),
                       jcfg)
    with torch.no_grad():
        full = apply_head(tp, tm.forward(tp, {"tokens": torch.from_numpy(
            tok).long()}), tcfg)
        inc = _prefill_then_decode(tm, tp, tcfg, tok, 36, 40)
    scale = float(jnp.max(jnp.abs(want)))
    assert _rel(full, want, scale) < TOL
    assert _rel(inc, full[:, 35:].numpy(), scale) < TOL


@pytest.mark.parametrize("name", ["llama3-8b", "deepseek-v2-236b",
                                  "deepseek-v3-671b"])
@pytest.mark.parametrize("scan_layers", [False, True])
def test_param_counts_match_reference(name, scan_layers):
    from repro.models.lm import active_param_count as jactive
    from repro.models.lm import param_count as jcount
    from repro_torch.models.lm import active_param_count, param_count
    kw = {"scan_layers": True} if scan_layers else {}
    (jcfg, _, jp), (tcfg, _, tp) = _pair(name, **kw)
    assert param_count(tp) == jcount(jp) > 0
    assert active_param_count(tcfg, tp) == jactive(jcfg, jp)
    if tcfg.moe is not None:
        assert active_param_count(tcfg, tp) < param_count(tp)


def test_unported_kinds_raise():
    """An unknown block kind raises ``not yet ported``; ``cfg.moe_ep`` is
    ported (``distributed.expert_parallel``) and, with no mesh, is the
    dense-dispatch MoE block, as in the reference."""
    from repro_torch.configs.base import MLA_MOE
    from repro_torch.models.blocks import apply_block, init_block
    cfg = get_config("deepseek-v2-236b").reduced(dtype="float32")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        init_block(torch.Generator(), cfg, "no-such-kind")
    params = init_block(torch.Generator().manual_seed(0), cfg, MLA_MOE)
    x = torch.randn((1, 4, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    pos = torch.arange(4, dtype=torch.int32)[None]
    want, _ = apply_block(params, x, cfg, MLA_MOE, mode="train",
                          positions=pos)
    got, _ = apply_block(params, x, cfg.with_overrides(moe_ep=True), MLA_MOE,
                         mode="train", positions=pos)
    assert torch.equal(got, want)
