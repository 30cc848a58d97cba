"""The port's Mamba2 SSM slice against the JAX reference, on the CPU.

* ``ops.ssd_scan`` (its plain version on the CPU) against the reference's
  Pallas kernel in interpret mode, at ``tests/test_kernels.py``'s grid
  and tolerances (atol = rtol = 2e-5 fp32, 2e-2 bf16); its final state
  against the reference's sequential ``ssd_scan_ref``.
* ``ssd_chunked`` and ``ssd_decode_step`` against the reference's, with
  and without an initial state, at aligned and ragged lengths.
* Reduced mamba2-130m (2 layers, d_model 64, fp32) with the reference's
  weights carried by ``params_from_numpy``, unrolled and stacked:
  forward, prefill and prefill + decode against the JAX ``Model`` to
  ``tests/test_torch_models.py``'s tolerance (2e-4 of the largest logit),
  and the kernel-routed ``LmEngine`` against the JAX ``LmEngine``.
* The SSM cache is written in place, so views into a stacked cache see
  prefill and decode.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.lm import apply_head as japply_head  # noqa: E402
from repro.models.serve_lm import LmEngine as JLmEngine  # noqa: E402
from repro_torch.configs import SSM, get_config  # noqa: E402
from repro_torch.kernels import KERNEL_STATS, ops, ref  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.blocks import (apply_block,  # noqa: E402
                                       init_block, init_block_cache)
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.serve_lm import LmEngine  # noqa: E402
from test_torch_kernels import _close  # noqa: E402
from test_torch_models import (TOL, _leaves, _pair,  # noqa: E402
                               _prefill_then_decode, _rel, _tokens)

jax.config.update("jax_enable_x64", False)

NAME = "mamba2-130m"


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """Tiny CPU ops run far slower under an oversubscribed intra-op pool
    (several test workers share the host); the tests need one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ssd_inputs(seed, B, S, H, P, G, N):
    """x, dt (softplus of a normal, fp32), a_log, B_in, C_in as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 4.0, H)).astype(np.float32)
    B_in = rng.standard_normal((B, S, G, N)).astype(np.float32)
    C_in = rng.standard_normal((B, S, G, N)).astype(np.float32)
    return x, dt, a_log, B_in, C_in


def _as(dtype, x, dt, a_log, B_in, C_in, *, lib):
    """The five inputs for one side: x, B, C in ``dtype``; dt, a_log fp32."""
    if lib == "jax":
        cast = lambda a, d: jnp.asarray(a, getattr(jnp, d))  # noqa: E731
    else:
        cast = lambda a, d: torch.from_numpy(a).to(  # noqa: E731
            getattr(torch, d))
    return (cast(x, dtype), cast(dt, "float32"), cast(a_log, "float32"),
            cast(B_in, dtype), cast(C_in, dtype))


# --------------------------------------------------------------------- #
# the kernel wrapper: tests/test_kernels.py's grid
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (1, 64, 2, 8, 1, 16, 16),
    (2, 128, 4, 16, 1, 32, 32),
    (1, 64, 4, 8, 2, 16, 16),    # grouped B/C
])
def test_ssd_scan_matches_pallas_kernel(B, S, H, P, G, N, chunk, dtype):
    arrays = _ssd_inputs(B * 100 + S + H, B, S, H, P, G, N)
    y, h = ops.ssd_scan(*_as(dtype, *arrays, lib="torch"), chunk=chunk)
    assert y.shape == (B, S, H, P) and y.dtype == getattr(torch, dtype)
    assert h.shape == (B, H, P, N) and h.dtype == torch.float32
    jin = _as(dtype, *arrays, lib="jax")
    _close(y, jops.ssd_scan(*jin, chunk=chunk), dtype)
    _, want_h = jref.ssd_scan_ref(*jin)
    _close(h, want_h, dtype)


def test_ssd_scan_rejects_unaligned_length():
    arrays = _ssd_inputs(1, 1, 40, 2, 8, 1, 16)
    with pytest.raises(ValueError, match="multiple of chunk=16"):
        ops.ssd_scan(*_as("float32", *arrays, lib="torch"), chunk=16)


def test_ssd_scan_counts_its_cpu_route():
    stats = KERNEL_STATS["ssd_scan"]
    before = (stats.launches, stats.cpu_calls)
    ops.ssd_scan(*_as("float32", *_ssd_inputs(2, 1, 16, 2, 8, 1, 16),
                      lib="torch"), chunk=16)
    assert (stats.launches, stats.cpu_calls) == (before[0], before[1] + 1)


# --------------------------------------------------------------------- #
# the model's scans
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("S", [96, 90])            # aligned, ragged
@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_chunked_matches_reference(S, with_init):
    B, H, P, G, N, chunk = 2, 4, 8, 2, 16, 16
    arrays = _ssd_inputs(S + with_init, B, S, H, P, G, N)
    init = (np.random.default_rng(3).standard_normal((B, H, P, N))
            .astype(np.float32) if with_init else None)
    jy, jh = jssm.ssd_chunked(
        *_as("float32", *arrays, lib="jax"), chunk=chunk,
        init_state=None if init is None else jnp.asarray(init))
    ty, th = ssm.ssd_chunked(
        *_as("float32", *arrays, lib="torch"), chunk=chunk,
        init_state=None if init is None else torch.from_numpy(init))
    assert ty.shape == (B, S, H, P) and th.dtype == torch.float32
    _close(ty, jy, "float32")
    _close(th, jh, "float32")


@pytest.mark.parametrize("S", [96, 90])
def test_kernel_route_pads_and_matches_chunked(S):
    """The block's kernel route (dt = 0 padding to a chunk multiple, then
    ``ops.ssd_scan``) gives ``ssd_chunked``'s y and final state, which
    ``ref.ssd_chunked_ref`` re-exports as the reference's ref does."""
    arrays = _as("float32", *_ssd_inputs(S, 2, S, 4, 8, 1, 16),
                 lib="torch")
    y, h = ssm.ssd_scan_padded(*arrays, chunk=16)
    want_y, want_h = ref.ssd_chunked_ref(*arrays, chunk=16)
    assert y.shape == want_y.shape
    _close(y, want_y.numpy(), "float32")
    _close(h, want_h.numpy(), "float32")


def test_deterministic_leaves_match_reference():
    """a_log = log(linspace(1, 16)), dt_bias 0, d_skip 1 and the norm
    scale 0 equal the reference's; every leaf has its shape and dtype."""
    tcfg = get_config(NAME).reduced(dtype="bfloat16")
    jcfg = jget_config(NAME).reduced(dtype="bfloat16")
    tp = ssm.init_ssm_block(torch.Generator().manual_seed(0), tcfg,
                            torch.bfloat16)
    jp = jssm.init_ssm_block(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    assert sorted(tp) == sorted(jp)
    for k, v in jp.items():
        v = v["scale"] if k == "norm" else v
        t = tp[k]["scale"] if k == "norm" else tp[k]
        assert tuple(t.shape) == tuple(v.shape), k
        assert str(t.dtype).removeprefix("torch.") == str(v.dtype), k
    for k in ("a_log", "dt_bias", "d_skip", "conv_b"):
        _close(tp[k], np.asarray(jp[k], np.float32), "float32")
    _close(tp["norm"]["scale"], np.asarray(jp["norm"]["scale"]), "float32")


def test_ssd_decode_step_matches_reference():
    B, H, P, G, N = 2, 4, 8, 2, 16
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, H)))).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 4.0, H)).astype(np.float32)
    Bt, Ct = (rng.standard_normal((B, G, N)).astype(np.float32)
              for _ in range(2))
    state = rng.standard_normal((B, H, P, N)).astype(np.float32)
    jy, jst = jssm.ssd_decode_step(*(jnp.asarray(a) for a in
                                     (x, dt, a_log, Bt, Ct, state)))
    ty, tst = ssm.ssd_decode_step(*(torch.from_numpy(a) for a in
                                    (x, dt, a_log, Bt, Ct, state)))
    _close(ty, jy, "float32")
    _close(tst, jst, "float32")


# --------------------------------------------------------------------- #
# reduced mamba2-130m against the JAX model
# --------------------------------------------------------------------- #
LAYOUTS = [False, True]             # unrolled, stacked (scan_layers)


@pytest.mark.parametrize("stacked", LAYOUTS)
def test_forward_prefill_and_decode_match_reference(stacked):
    (jcfg, jm, jp), (tcfg, tm, tp) = _pair(NAME, scan_layers=stacked)
    if stacked:
        assert tp["pattern"][0]["mixer"]["in_proj"].shape[0] == 2
    tok = _tokens(jcfg, 2, 40, seed=5)     # 2.5 chunks of 16: ragged
    with torch.no_grad():
        full = tm.logits(tp, tm.forward(tp, {"tokens": torch.from_numpy(
            tok).long()}))
        got_logits, got_cache = tm.prefill(
            tp, {"tokens": torch.from_numpy(tok[:, :34]).long()},
            max_len=40)
        inc = _prefill_then_decode(tm, tp, tcfg, tok, 34, 40)
    want_full = japply_head(jp, jm.forward(jp, {"tokens": jnp.asarray(
        tok)}), jcfg)
    want_logits, want_cache = jm.prefill(
        jp, {"tokens": jnp.asarray(tok[:, :34])}, max_len=40)
    want_inc = _prefill_then_decode(jm, jp, jcfg, tok, 34, 40)
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
    assert _rel(inc, full[:, 33:].numpy(), scale) < TOL


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
    stats = KERNEL_STATS["ssd_scan"]
    calls = stats.cpu_calls
    got, cache = teng.prefill(tok[:, :20])
    assert stats.cpu_calls == calls + cfg.n_layers
    want, jcache = jeng.prefill(tok[:, :20])
    outs = [(got[:, 0], want[:, 0])]
    for i in range(20, 24):
        got, cache = teng.decode_step(cache, tok[:, i:i + 1], i)
        want, jcache = jeng.decode_step(jcache, tok[:, i:i + 1], i)
        outs.append((got[:, 0], want[:, 0]))
    scale = max(float(jnp.max(jnp.abs(w))) for _, w in outs)
    for g, w in outs:
        assert _rel(g, w, scale) < TOL


def test_ssm_cache_is_written_in_place():
    """Prefill and decode write the caller's tensors: a cache dict of
    views into a stacked (R, ...) cache, as ``lm._run_pattern`` hands each
    layer, sees both.  Reassigning a key would leave the stack zero."""
    cfg = get_config(NAME).reduced(dtype="float32")
    params = init_block(torch.Generator().manual_seed(0), cfg, SSM)
    stacked = {k: v.new_zeros((2, *v.shape))
               for k, v in init_block_cache(cfg, SSM, 1, 16).items()}
    views = {k: v[1] for k, v in stacked.items()}
    leaves = dict(views)
    x = torch.randn((1, 20, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    with torch.no_grad():
        _, out = apply_block(params, x, cfg, SSM, mode="prefill",
                             cache=views)
        assert out is views and all(views[k] is leaves[k] for k in views)
        after_prefill = {k: v[1].clone() for k, v in stacked.items()}
        for k in stacked:
            assert after_prefill[k].abs().sum() > 0, k
            assert stacked[k][0].abs().sum() == 0, k
        apply_block(params, x[:, :1], cfg, SSM, mode="decode", pos=20,
                    cache=views)
    for k in stacked:
        assert views[k] is leaves[k]
        assert not torch.equal(stacked[k][1], after_prefill[k]), k
