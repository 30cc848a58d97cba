"""The port's RG-LRU slice against the JAX reference, on the CPU.

* ``ops.rglru_scan`` (its plain version on the CPU) against the
  reference's Pallas kernel in interpret mode, at ``tests/test_kernels.py``'s
  grid, in fp32 (atol = rtol = 2e-5) and bf16 inputs (2e-2), with the
  block-halving rule of the reference wrapper; the final state against
  the reference's sequential ``rglru_scan_ref``.
* The model's scan (Hillis–Steele in place of ``lax.associative_scan``,
  and the kernel route) against the reference's, with and without an
  initial state, at lengths that are not powers of two; the gates and
  the decode step.
* Reduced recurrentgemma-9b (pattern (RG-LRU, RG-LRU, local attention)
  × 2 + two RG-LRU, d_model 64, window 64, fp32) with the reference's
  weights carried by ``params_from_numpy``, unrolled and stacked:
  forward, prefill and prefill + decode past the window against the JAX
  ``Model`` to ``tests/test_torch_models.py``'s tolerance (2e-4 of the
  largest logit), and the kernel-routed ``LmEngine`` against the JAX
  ``LmEngine``.
* The RG-LRU cache is written in place, so views into a stacked cache
  see prefill and decode.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models.lm import apply_head as japply_head  # noqa: E402
from repro.models.serve_lm import LmEngine as JLmEngine  # noqa: E402
from repro_torch.configs import RGLRU, get_config  # noqa: E402
from repro_torch.kernels import KERNEL_STATS, ops, ref  # noqa: E402
from repro_torch.kernels.rglru_scan import \
    rglru_scan as raw_rglru_scan  # noqa: E402
from repro_torch.models import rglru  # noqa: E402
from repro_torch.models.blocks import (apply_block,  # noqa: E402
                                       init_block, init_block_cache)
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.serve_lm import LmEngine  # noqa: E402
from test_torch_kernels import _close  # noqa: E402
from test_torch_models import (TOL, _leaves, _pair,  # noqa: E402
                               _prefill_then_decode, _rel, _tokens)

jax.config.update("jax_enable_x64", False)

NAME = "recurrentgemma-9b"


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """Tiny CPU ops run far slower under an oversubscribed intra-op pool
    (several test workers share the host); the tests need one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ab(seed, B, S, W):
    """Gate a = sigmoid(normal) in (0, 1) and input b = normal, as numpy."""
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, W))))).astype(
        np.float32)
    b = rng.standard_normal((B, S, W)).astype(np.float32)
    return a, b


def _t(x, dtype="float32"):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _j(x, dtype="float32"):
    return jnp.asarray(x, getattr(jnp, dtype))


# --------------------------------------------------------------------- #
# the kernel wrapper: tests/test_kernels.py's grid
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,W,bs,bw", [
    (1, 64, 16, 16, 16),
    (2, 128, 48, 32, 16),
    (1, 96, 32, 32, 32),
    (2, 96, 48, 64, 32),          # blocks halve to 32 and 16
])
def test_rglru_scan_matches_pallas_kernel(B, S, W, bs, bw, dtype):
    a, b = _ab(B * 100 + S + W, B, S, W)
    h = ops.rglru_scan(_t(a, dtype), _t(b, dtype), block_s=bs, block_w=bw)
    assert h.shape == (B, S, W) and h.dtype == torch.float32
    want = jops.rglru_scan(_j(a, dtype), _j(b, dtype), block_s=bs,
                           block_w=bw)
    assert want.dtype == jnp.float32
    _close(h, want, dtype)
    _, want_final = jref.rglru_scan_ref(_j(a, dtype).astype(jnp.float32),
                                        _j(b, dtype).astype(jnp.float32))
    _, final = ref.rglru_scan_ref(_t(a, dtype), _t(b, dtype))
    _close(final, want_final, dtype)
    _close(h[:, -1], want_final, dtype)


def test_rglru_scan_raw_wrapper_keeps_the_block_rule():
    """The wrapper under ``ops`` refuses blocks that do not divide S and W
    (the reference kernel's assertion); ``ops`` halves them first."""
    a, b = (_t(x) for x in _ab(1, 1, 96, 48))
    with pytest.raises(ValueError, match="must\\s+divide"):
        raw_rglru_scan(a, b, block_s=64, block_w=16)
    with pytest.raises(ValueError, match="must\\s+divide"):
        raw_rglru_scan(a, b, block_s=32, block_w=32)
    with pytest.raises(ValueError, match="one shape"):
        ops.rglru_scan(a, b[:, :48])
    assert ops.rglru_scan(a, b, block_s=64, block_w=32).shape == (1, 96, 48)


def test_rglru_scan_counts_its_cpu_route():
    stats = KERNEL_STATS["rglru_scan"]
    before = (stats.launches, stats.cpu_calls)
    ops.rglru_scan(*(_t(x) for x in _ab(2, 1, 16, 8)))
    assert (stats.launches, stats.cpu_calls) == (before[0], before[1] + 1)


# --------------------------------------------------------------------- #
# the model's scan, gates and step
# --------------------------------------------------------------------- #
def _block_params(seed=0, width=32):
    """The reference's RG-LRU block parameters (fp32), on both sides."""
    cfg = jget_config(NAME).reduced(dtype="float32", d_model=width)
    jp = jrglru.init_rglru_block(jax.random.PRNGKey(seed), cfg, jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return cfg.rglru.c_constant, jp, tp


@pytest.mark.parametrize("S", [64, 37])
@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("kernel", [False, True])
def test_rglru_model_scan_matches_reference(S, with_init, kernel):
    c, jp, tp = _block_params()
    rng = np.random.default_rng(S + 2 * with_init)
    x = rng.standard_normal((2, S, 32)).astype(np.float32)
    init = rng.standard_normal((2, 32)).astype(np.float32) \
        if with_init else None
    jy, jh = jrglru.rglru_scan(jp, jnp.asarray(x), c,
                               None if init is None else jnp.asarray(init))
    ty, th = rglru.rglru_scan(tp, torch.from_numpy(x), c,
                              None if init is None else torch.from_numpy(init),
                              kernel=kernel)
    assert ty.dtype == torch.float32 and th.dtype == torch.float32
    _close(ty, jy, "float32")
    _close(th, jh, "float32")


def test_rglru_scan_keeps_the_final_state_in_fp32():
    """y comes back in x's dtype, the final state stays fp32 (the
    reference's ``h.astype(x.dtype), h[:, -1]``)."""
    c, _, tp = _block_params()
    tp = {k: (v.to(torch.bfloat16) if v.dim() > 1 or k == "conv_b" else v)
          for k, v in tp.items()}
    x = torch.randn((1, 20, 32), generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    for kernel in (False, True):
        y, h = rglru.rglru_scan(tp, x, c, kernel=kernel)
        assert y.dtype == torch.bfloat16 and h.dtype == torch.float32


def test_linear_scan_matches_sequential_reference():
    a, b = _ab(9, 2, 45, 8)
    a_cum, h = rglru.linear_scan(_t(a), _t(b))
    want, _ = jref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b))
    _close(h, want, "float32")
    _close(a_cum, np.cumprod(a, axis=1), "float32")


def test_rglru_gates_and_step_match_reference():
    c, jp, tp = _block_params(seed=1)
    rng = np.random.default_rng(10)
    x = rng.standard_normal((3, 32)).astype(np.float32)
    h = rng.standard_normal((3, 32)).astype(np.float32)
    ja, jb = jrglru.rglru_gates(jp, jnp.asarray(x), c)
    ta, tb = rglru.rglru_gates(tp, torch.from_numpy(x), c)
    _close(ta, ja, "float32")
    _close(tb, jb, "float32")
    jy, jh = jrglru.rglru_step(jp, jnp.asarray(x), jnp.asarray(h), c)
    ty, th = rglru.rglru_step(tp, torch.from_numpy(x), torch.from_numpy(h), c)
    _close(ty, jy, "float32")
    _close(th, jh, "float32")


def test_deterministic_leaves_match_reference():
    """lam (the paper's formula) and the zero biases equal the
    reference's; every leaf has the reference's shape and dtype."""
    tcfg = get_config(NAME).reduced(dtype="bfloat16", d_model=64)
    jcfg = jget_config(NAME).reduced(dtype="bfloat16", d_model=64)
    tp = rglru.init_rglru_block(torch.Generator().manual_seed(0), tcfg,
                                torch.bfloat16)
    jp = jrglru.init_rglru_block(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    assert sorted(tp) == sorted(jp)
    for k, v in jp.items():
        assert tuple(tp[k].shape) == tuple(v.shape), k
        assert str(tp[k].dtype).removeprefix("torch.") == str(v.dtype), k
    for k in ("lam", "b_a", "b_x", "conv_b"):
        _close(tp[k], np.asarray(jp[k], np.float32), "float32")


# --------------------------------------------------------------------- #
# reduced recurrentgemma-9b against the JAX model
# --------------------------------------------------------------------- #
LAYOUTS = [False, True]             # unrolled, stacked (scan_layers)


@pytest.mark.parametrize("stacked", LAYOUTS)
def test_forward_prefill_and_decode_match_reference(stacked):
    (jcfg, jm, jp), (tcfg, tm, tp) = _pair(NAME, scan_layers=stacked)
    assert tcfg.sliding_window == 64 and len(tcfg.suffix) == 2
    if stacked:
        assert tp["pattern"][0]["mixer"]["w_a"].shape[0] == 2
    tok = _tokens(jcfg, 2, 80, seed=5)
    n_pre = 72                       # past the window: the ring rolls
    with torch.no_grad():
        full = tm.logits(tp, tm.forward(tp, {"tokens": torch.from_numpy(
            tok).long()}))
        got_logits, got_cache = tm.prefill(
            tp, {"tokens": torch.from_numpy(tok[:, :n_pre]).long()},
            max_len=80)
        inc = _prefill_then_decode(tm, tp, tcfg, tok, n_pre, 80)
    want_full = japply_head(jp, jm.forward(jp, {"tokens": jnp.asarray(
        tok)}), jcfg)
    want_logits, want_cache = jm.prefill(
        jp, {"tokens": jnp.asarray(tok[:, :n_pre])}, max_len=80)
    want_inc = _prefill_then_decode(jm, jp, jcfg, tok, n_pre, 80)
    scale = float(jnp.max(jnp.abs(want_full)))
    assert _rel(full, want_full, scale) < TOL
    assert _rel(got_logits, want_logits, scale) < TOL
    jl, tl = _leaves(want_cache), _leaves(got_cache)
    assert len(jl) == len(tl) > 0
    for a, b in zip(jl, tl):
        assert tuple(b.shape) == tuple(a.shape)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-5,
                                   rtol=2e-5)
    assert _rel(inc, want_inc, scale) < TOL
    assert _rel(inc, full[:, n_pre - 1:].numpy(), scale) < TOL


def test_kernel_routed_engine_matches_reference_engine():
    """``LmEngine`` with the flag set, on the CPU (the kernels' plain
    versions), against the JAX ``LmEngine`` with the same weights."""
    jcfg = jget_config(NAME).reduced(dtype="float32",
                                     use_pallas_kernels=True)
    cfg = get_config(NAME).reduced(dtype="float32", use_pallas_kernels=True)
    jeng = JLmEngine(jcfg, max_seq=48, default_seq_bucket=16)
    teng = LmEngine(cfg, max_seq=48, default_seq_bucket=16, device="cpu")
    teng.params = params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jeng.params), device="cpu")
    tok = _tokens(cfg, 2, 24, seed=6)
    scans, flash = KERNEL_STATS["rglru_scan"], KERNEL_STATS["flash_attention"]
    calls = (scans.cpu_calls, flash.cpu_calls)
    got, cache = teng.prefill(tok[:, :20])
    n_rglru = sum(k == RGLRU for k in cfg.pattern) * cfg.n_repeats \
        + sum(k == RGLRU for k in cfg.suffix)
    assert (scans.cpu_calls, flash.cpu_calls) == (
        calls[0] + n_rglru, calls[1] + cfg.n_repeats)
    want, jcache = jeng.prefill(tok[:, :20])
    outs = [(got[:, 0], want[:, 0])]
    for i in range(20, 24):
        got, cache = teng.decode_step(cache, tok[:, i:i + 1], i)
        want, jcache = jeng.decode_step(jcache, tok[:, i:i + 1], i)
        outs.append((got[:, 0], want[:, 0]))
    scale = max(float(jnp.max(jnp.abs(w))) for _, w in outs)
    for g, w in outs:
        assert _rel(g, w, scale) < TOL


def test_rglru_cache_is_written_in_place():
    """Prefill and decode write the caller's tensors: a cache dict of
    views into a stacked (R, ...) cache, as ``lm._run_pattern`` hands each
    layer, sees both.  Reassigning a key would leave the stack zero."""
    cfg = get_config(NAME).reduced(dtype="float32")
    params = init_block(torch.Generator().manual_seed(0), cfg, RGLRU)
    stacked = {k: v.new_zeros((2, *v.shape))
               for k, v in init_block_cache(cfg, RGLRU, 1, 16).items()}
    views = {k: v[1] for k, v in stacked.items()}
    leaves = dict(views)
    x = torch.randn((1, 20, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    with torch.no_grad():
        _, out = apply_block(params, x, cfg, RGLRU, mode="prefill",
                             cache=views)
        assert out is views and all(views[k] is leaves[k] for k in views)
        after_prefill = {k: v[1].clone() for k, v in stacked.items()}
        for k in stacked:
            assert after_prefill[k].abs().sum() > 0, k
            assert stacked[k][0].abs().sum() == 0, k
        apply_block(params, x[:, :1], cfg, RGLRU, mode="decode", pos=20,
                    cache=views)
    for k in stacked:
        assert views[k] is leaves[k]
        assert not torch.equal(stacked[k][1], after_prefill[k]), k
