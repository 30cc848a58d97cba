"""The port's kernels against the JAX reference.

On the CPU the port's wrappers compute their plain PyTorch versions; the
same seeded numpy inputs go through the reference's Pallas kernels (in
interpret mode, as ``tests/test_kernels.py`` runs them) and its jnp
oracles.  Grids and tolerances are ``tests/test_kernels.py``'s (atol =
rtol = 2e-5 fp32, 2e-2 bf16), plus head dim 8 (the ``lm-tiny`` fidelity
rungs 1-2).  The kernels themselves are held against their plain
versions on a card by ``tests/test_torch_card.py``, which imports no JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import \
    decode_attention as jraw_decode  # noqa: E402
from repro_torch.kernels import KERNEL_STATS  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.decode_attention import \
    decode_attention as raw_decode  # noqa: E402

jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """Tiny CPU ops run far slower under an oversubscribed intra-op pool
    (several test workers share the host); the tests need one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DTYPES = ("float32", "bfloat16")


def tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-5)


def _close(got, want, dtype):
    if isinstance(got, torch.Tensor):
        got = got.float().numpy()
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol(dtype))


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _j(x, dtype):
    return jnp.asarray(x, getattr(jnp, dtype))


def _t(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


FLASH_GRID = [
    (1, 64, 4, 4, 32),      # MHA
    (2, 128, 4, 2, 32),     # GQA
    (1, 96, 8, 1, 16),      # MQA, ragged seq (padding path)
    (2, 256, 2, 2, 64),
    (2, 64, 2, 1, 8),       # head dim 8 (lm-tiny rungs 1-2)
]
DECODE_GRID = [
    (2, 128, 4, 2, 32),
    (1, 256, 8, 8, 64),
    (3, 96, 4, 1, 16),      # ragged cache length (padding path)
    (2, 64, 2, 1, 8),       # head dim 8
]


# --------------------------------------------------------------------- #
# flash attention
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,Hkv,D", FLASH_GRID)
def test_flash_attention_causal_matches_reference(B, S, H, Hkv, D, dtype):
    q, k, v = _inputs(B * 1000 + S + D, (B, S, H, D), (B, S, Hkv, D),
                      (B, S, Hkv, D))
    got = ops.flash_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                              causal=True, block_q=32, block_kv=32)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, S, H, D)
    want = jref.flash_attention_ref(_j(q, dtype), _j(k, dtype),
                                    _j(v, dtype), causal=True)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_matches_pallas_kernel(dtype):
    """One ragged GQA case against the Pallas kernel itself (interpret)."""
    B, S, H, Hkv, D = 1, 96, 4, 2, 16
    q, k, v = _inputs(11, (B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D))
    got = ops.flash_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                              causal=True, window=48, block_q=32,
                              block_kv=32)
    want = jops.flash_attention(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                                causal=True, window=48, block_q=32,
                                block_kv=32)
    _close(got, want, dtype)


@pytest.mark.parametrize("window", [16, 48, 100])
def test_flash_attention_window(window):
    B, S, H, Hkv, D = 2, 128, 4, 1, 32
    q, k, v = _inputs(window, (B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D))
    got = ops.flash_attention(_t(q, "float32"), _t(k, "float32"),
                              _t(v, "float32"), causal=True, window=window,
                              block_q=32, block_kv=32)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True,
                                    window=window)
    _close(got, want, "float32")


def test_flash_attention_non_causal_alignment_rule():
    B, S, H, D = 1, 64, 2, 16
    q, k, v = _inputs(5, (B, S, H, D), (B, S, H, D), (B, S, H, D))
    got = ops.flash_attention(_t(q, "float32"), _t(k, "float32"),
                              _t(v, "float32"), causal=False)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=False)
    _close(got, want, "float32")
    # 40 rows pad to a 64-row block: non-causal refuses, as the reference
    msgs = []
    for mod, conv in ((ops, lambda x: _t(x, "float32")),
                      (jops, jnp.asarray)):
        with pytest.raises(ValueError, match="aligned shapes") as e:
            mod.flash_attention(conv(q[:, :40]), conv(k[:, :40]),
                                conv(v[:, :40]), causal=False)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_flash_attention_matches_port_model_blocked_path():
    """The port's blocked attention (model path) and the kernel agree."""
    from repro.models.common import blocked_attention as jblocked
    from repro_torch.models.common import blocked_attention
    B, S, H, Hkv, D = 1, 128, 4, 2, 32
    q, k, v = _inputs(2, (B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D))
    qt, kt, vt = (_t(x, "float32") for x in (q, k, v))
    got = ops.flash_attention(qt, kt, vt, causal=True, block_q=32,
                              block_kv=32)
    want = blocked_attention(qt, kt, vt, causal=True, window=48,
                             block_q=32, block_kv=32)
    jwant = jblocked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=True, window=48, block_q=32, block_kv=32)
    _close(want, jwant, "float32")
    _close(got, blocked_attention(qt, kt, vt, causal=True, block_q=32,
                                  block_kv=32), "float32")


# --------------------------------------------------------------------- #
# decode attention
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,Hkv,D", DECODE_GRID)
def test_decode_attention_matches_reference(B, S, H, Hkv, D, dtype):
    q, kc, vc = _inputs(B * 100 + S + D, (B, 1, H, D), (B, S, Hkv, D),
                        (B, S, Hkv, D))
    lengths = np.random.default_rng(S).integers(1, S + 1, (B,),
                                                dtype=np.int32)
    got = ops.decode_attention(_t(q, dtype), _t(kc, dtype), _t(vc, dtype),
                               torch.from_numpy(lengths), block_kv=32)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, 1, H, D)
    want = jref.decode_attention_ref(_j(q, dtype), _j(kc, dtype),
                                     _j(vc, dtype), jnp.asarray(lengths))
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_matches_pallas_kernel(dtype):
    B, S, H, Hkv, D = 3, 96, 4, 1, 16
    q, kc, vc = _inputs(12, (B, 1, H, D), (B, S, Hkv, D), (B, S, Hkv, D))
    lengths = np.array([1, 50, 96], np.int32)
    got = ops.decode_attention(_t(q, dtype), _t(kc, dtype), _t(vc, dtype),
                               torch.from_numpy(lengths), block_kv=32)
    want = jops.decode_attention(_j(q, dtype), _j(kc, dtype), _j(vc, dtype),
                                 jnp.asarray(lengths), block_kv=32)
    _close(got, want, dtype)


def test_decode_attention_matches_port_model_decode():
    """Model decode_attention (full cache) == kernel at length = pos+1."""
    from repro_torch.models.common import decode_attention as model_decode
    B, S, H, Hkv, D = 2, 64, 4, 2, 32
    q, kc, vc = (_t(x, "float32") for x in _inputs(
        4, (B, 1, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    pos = 37
    got = ops.decode_attention(q, kc, vc, torch.full((B,), pos + 1),
                               block_kv=32)
    _close(got, model_decode(q, kc, vc, pos), "float32")


def _validation_cases(q, kc, vc, lengths, B, S, D, *, repeat, astype_bf16,
                      full):
    return [
        (dict(q=q[:, 0]), "must be \\(B, 1, H, D\\)"),
        (dict(q=repeat(q, 2, 1)), "must be \\(B, 1, H, D\\)"),
        (dict(vc=vc[:, : S // 2]), "shapes differ"),
        (dict(q=q[:1]), "batch mismatch"),
        (dict(q=q[..., : D // 2]), "head dim mismatch"),
        (dict(kc=kc[:, :, :1], vc=vc[:, :, :1]), None),     # MQA is valid
        (dict(kc=repeat(kc, 3, 2), vc=repeat(vc, 3, 2)), "multiple"),
        (dict(q=astype_bf16(q)), "dtype mismatch"),
        (dict(lengths=full((B, 1), S)), "lengths must be"),
    ]


def test_decode_attention_validates_arguments_like_reference():
    B, S, H, Hkv, D = 2, 64, 4, 2, 32
    q, kc, vc = _inputs(7, (B, 1, H, D), (B, S, Hkv, D), (B, S, Hkv, D))
    port = _validation_cases(
        _t(q, "float32"), _t(kc, "float32"), _t(vc, "float32"), None, B, S,
        D, repeat=lambda x, n, d: torch.repeat_interleave(x, n, d),
        astype_bf16=lambda x: x.to(torch.bfloat16),
        full=lambda s, v: torch.full(s, v))
    refc = _validation_cases(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), None, B, S, D,
        repeat=lambda x, n, d: jnp.repeat(x, n, axis=d),
        astype_bf16=lambda x: x.astype(jnp.bfloat16),
        full=lambda s, v: jnp.full(s, v))
    base_t = dict(q=_t(q, "float32"), kc=_t(kc, "float32"),
                  vc=_t(vc, "float32"), lengths=torch.full((B,), S))
    base_j = dict(q=jnp.asarray(q), kc=jnp.asarray(kc), vc=jnp.asarray(vc),
                  lengths=jnp.full((B,), S))
    for (ov_t, match), (ov_j, _) in zip(port, refc):
        kw_t, kw_j = dict(base_t, **ov_t), dict(base_j, **ov_j)
        args_t = (kw_t["q"], kw_t["kc"], kw_t["vc"], kw_t["lengths"])
        if match is None:
            ops.decode_attention(*args_t, block_kv=32)
            continue
        with pytest.raises(ValueError, match=match) as e_t:
            ops.decode_attention(*args_t, block_kv=32)
        with pytest.raises(ValueError) as e_j:
            jops.decode_attention(kw_j["q"], kw_j["kc"], kw_j["vc"],
                                  kw_j["lengths"], block_kv=32)
        assert str(e_t.value) == str(e_j.value)


def test_decode_attention_rejects_unpadded_cache_length():
    B, S, H, Hkv, D = 1, 48, 2, 1, 16
    q, kc, vc = _inputs(8, (B, 1, H, D), (B, S, Hkv, D), (B, S, Hkv, D))
    with pytest.raises(ValueError, match="multiple of\\s+block_kv") as e_t:
        raw_decode(_t(q, "float32"), _t(kc, "float32"), _t(vc, "float32"),
                   torch.full((B,), S), block_kv=32)
    with pytest.raises(ValueError) as e_j:
        jraw_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                    jnp.full((B,), S), block_kv=32, interpret=True)
    assert str(e_t.value) == str(e_j.value)


def test_cpu_tensors_take_the_plain_route_and_launch_nothing():
    B, S, H, D = 1, 32, 2, 16
    q, k, v = (_t(x, "float32") for x in _inputs(
        9, (B, S, H, D), (B, S, 1, D), (B, S, 1, D)))
    before = {n: (s.launches, s.cpu_calls) for n, s in KERNEL_STATS.items()}
    ops.flash_attention(q, k, v)
    ops.decode_attention(q[:, :1], k, v, torch.full((B,), S))
    x = q.reshape(B, S, H * D // 8, 8)
    ops.ssd_scan(x, torch.rand((B, S, x.shape[2])), torch.zeros(x.shape[2]),
                 k[:, :, :, :8], v[:, :, :, :8], chunk=16)
    ops.rglru_scan(torch.sigmoid(k[..., 0]), v[..., 0])
    assert sorted(KERNEL_STATS) == ["decode_attention", "flash_attention",
                                    "rglru_scan", "ssd_scan"]
    for name, stats in KERNEL_STATS.items():
        assert stats.launches == before[name][0]
        assert stats.cpu_calls == before[name][1] + 1


@pytest.mark.parametrize("name", ("flash_attention", "decode_attention",
                                  "ssd_scan", "rglru_scan"))
def test_cpu_route_carries_gradients(name):
    """On CPU tensors each wrapper computes its plain version, which
    autograd differentiates: every input that requires grad gets a
    finite, nonzero gradient (on a card the wrappers refuse such inputs;
    ``tests/test_torch_card.py``)."""
    B, S, H, D = 1, 32, 2, 16
    q, k, v, a, b = (_t(x, "float32").requires_grad_() for x in _inputs(
        13, (B, S, H, D), (B, S, 1, D), (B, S, 1, D), (B, S, 64), (B, S, 64)))
    x, Bi, Ci = (_t(x, "float32").requires_grad_() for x in _inputs(
        14, (B, S, 4, 8), (B, S, 1, 8), (B, S, 1, 8)))
    dt = torch.full((B, S, 4), 0.1, requires_grad=True)
    a_log = torch.zeros(4, requires_grad=True)
    inputs, out = {
        "flash_attention": lambda: ((q, k, v), ops.flash_attention(q, k, v)),
        "decode_attention": lambda: ((q, k, v), ops.decode_attention(
            q[:, :1], k, v, torch.full((B,), S))),
        "ssd_scan": lambda: ((x, dt, a_log, Bi, Ci), ops.ssd_scan(
            x, dt, a_log, Bi, Ci, chunk=16)),
        "rglru_scan": lambda: ((a, b), ops.rglru_scan(torch.sigmoid(a), b)),
    }[name]()
    outs = out if isinstance(out, tuple) else (out,)
    sum(o.square().sum() for o in outs).backward()
    for t in inputs:
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())
        assert float(t.grad.abs().max()) > 0
