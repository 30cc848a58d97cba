"""The port's kernels against the JAX reference.

On the CPU the port's wrappers compute their plain PyTorch versions; the
same seeded numpy inputs go through the reference's Pallas kernels (in
interpret mode, as ``tests/test_kernels.py`` runs them) and its jnp
oracles.  Grids and tolerances are ``tests/test_kernels.py``'s (atol =
rtol = 2e-5 fp32, 2e-2 bf16), plus head dim 8 (the ``lm-tiny`` fidelity
rungs 1-2).  On a CUDA host the kernels are also held against their
plain versions; here those tests skip.
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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


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


# --------------------------------------------------------------------- #
# on a card: each CUDA kernel against its plain version
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,Hkv,D", FLASH_GRID + [(1, 512, 4, 1, 256)])
def test_cuda_flash_attention_matches_plain(cuda, B, S, H, Hkv, D, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    q, k, v = (_t(x, dtype).to(cuda) for x in _inputs(
        3, (B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    for window in (0, 48):
        got = ops.flash_attention(q, k, v, causal=True, window=window,
                                  block_q=32, block_kv=32)
        want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
        _close(got.cpu(), want.cpu().float().numpy(), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,Hkv,D", DECODE_GRID + [(8, 1024, 4, 1, 256)])
def test_cuda_decode_attention_matches_plain(cuda, B, S, H, Hkv, D, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    q, kc, vc = (_t(x, dtype).to(cuda) for x in _inputs(
        4, (B, 1, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    lengths = torch.from_numpy(np.random.default_rng(S).integers(
        1, S + 1, (B,), dtype=np.int32)).to(cuda)
    got = ops.decode_attention(q, kc, vc, lengths, block_kv=32)
    want = ref.decode_attention_ref(q, kc, vc, lengths)
    _close(got.cpu(), want.cpu().float().numpy(), dtype)


SSD_GRID = [
    (1, 64, 2, 8, 1, 16, 16),
    (2, 128, 4, 16, 1, 32, 32),
    (1, 64, 4, 8, 2, 16, 16),       # grouped B/C
    (4, 512, 24, 64, 1, 128, 64),   # mamba2-130m serving shape
]
RGLRU_GRID = [
    (1, 64, 16),
    (2, 128, 48),
    (1, 96, 32),
    (4, 512, 4096),                 # recurrentgemma-9b serving shape
]


def _ssd_want(*args):
    """What the SSD kernel is held against: for fp32 inputs the recurrence
    evaluated in fp64 (in fp32 it strays up to ~1e-4 from fp64 at the
    mamba2-130m shape, past the fp32 tolerance, as ``chip_smoke.py``
    reports), for bf16 inputs the plain version as it is."""
    if args[0].dtype == torch.float32:
        y, h = ref.ssd_scan_ref(*(t.double() for t in args))
        return y.float(), h.float()
    return ref.ssd_scan_ref(*args)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,P,G,N,chunk", SSD_GRID)
def test_cuda_ssd_scan_matches_plain(cuda, B, S, H, P, G, N, chunk, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    x, B_in, C_in, dt = _inputs(6, (B, S, H, P), (B, S, G, N), (B, S, G, N),
                                (B, S, H))
    x, B_in, C_in = (_t(a, dtype).to(cuda) for a in (x, B_in, C_in))
    dt = torch.nn.functional.softplus(_t(dt, "float32")).to(cuda)
    a_log = torch.log(torch.linspace(1.0, 4.0, H)).to(cuda)
    y, h = ops.ssd_scan(x, dt, a_log, B_in, C_in, chunk=chunk)
    want_y, want_h = _ssd_want(x, dt, a_log, B_in, C_in)
    _close(y.cpu(), want_y.cpu().float().numpy(), dtype)
    _close(h.cpu(), want_h.cpu().numpy(), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,W", RGLRU_GRID)
def test_cuda_rglru_scan_matches_plain(cuda, B, S, W, dtype):
    a, b = _inputs(7, (B, S, W), (B, S, W))
    a = torch.sigmoid(_t(a, "float32")).to(dtype).to(cuda)
    b = _t(b, dtype).to(cuda)
    h = ops.rglru_scan(a, b)
    assert h.dtype == torch.float32
    want, final = ref.rglru_scan_ref(a, b)
    _close(h.cpu(), want.cpu().numpy(), dtype)
    _close(h[:, -1].cpu(), final.cpu().numpy(), dtype)


# --------------------------------------------------------------------- #
# on a card: both routes of each kernel that has two, forced
# --------------------------------------------------------------------- #
def _routes(rule):
    """The routes that take a case: the CUDA cores take every shape the
    wrapper accepts, the tensor cores those of the rule."""
    return ("cuda_core", "tensor_core") if rule == "tensor_core" \
        else ("cuda_core",)


FLASH_ROUTE_GRID = [
    # B, S, H, Hkv, D, window, block
    (2, 128, 4, 1, 32, 16, 32),      # windows (bf16 tile skipping)
    (2, 128, 4, 1, 32, 48, 32),
    (2, 128, 4, 1, 32, 100, 32),
    (2, 16, 4, 2, 32, 0, 16),        # one partial 64-row tile
    (2, 32, 4, 2, 32, 0, 16),
    (2, 48, 4, 2, 32, 0, 16),
    (1, 128, 4, 4, 64, 0, 32),       # GQA groups 1, 2, 4, 16
    (1, 128, 4, 2, 64, 0, 32),
    (2, 128, 4, 1, 64, 0, 32),
    (1, 128, 16, 1, 64, 0, 32),
    (1, 512, 4, 1, 256, 0, 512),     # gemma3-1b, B = 1
    (1, 512, 16, 1, 256, 2048, 512),  # recurrentgemma-9b, B = 1
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,Hkv,D,window,blk", FLASH_ROUTE_GRID)
def test_cuda_flash_attention_routes_match_plain(cuda, B, S, H, Hkv, D,
                                                 window, blk, dtype):
    from repro_torch.kernels import flash_attention as flash_mod
    q, k, v = (_t(x, dtype).to(cuda) for x in _inputs(
        5, (B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    got = ops.flash_attention(q, k, v, causal=True, window=window,
                              block_q=blk, block_kv=blk)
    _close(got.cpu(), want.cpu().float().numpy(), dtype)
    rule = flash_mod.route(dtype, D)
    for r in _routes(rule):
        out = flash_mod.launch(q, k, v, causal=True, window=window, force=r)
        _close(out.cpu(), want.cpu().float().numpy(), dtype)
        if r == rule:      # the C entry's choice by shape is the rule's
            assert torch.equal(out, flash_mod.launch(
                q, k, v, causal=True, window=window))


SSD_ROUTE_GRID = SSD_GRID + [
    (1, 64, 4, 16, 2, 16, 16),      # grouped, P = 16: tensor cores
    (2, 64, 4, 16, 1, 32, 64),      # one chunk (S = chunk)
    (1, 512, 24, 64, 1, 128, 64),   # mamba2-130m serving shape, B = 1
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,P,G,N,chunk", SSD_ROUTE_GRID)
def test_cuda_ssd_scan_routes_match_plain(cuda, B, S, H, P, G, N, chunk,
                                          dtype):
    from repro_torch.kernels import ssd_scan as ssd_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    x, B_in, C_in, dt = _inputs(8, (B, S, H, P), (B, S, G, N), (B, S, G, N),
                                (B, S, H))
    x, B_in, C_in = (_t(a, dtype).to(cuda) for a in (x, B_in, C_in))
    dt = torch.nn.functional.softplus(_t(dt, "float32")).to(cuda)
    a_log = torch.log(torch.linspace(1.0, 4.0, H)).to(cuda)
    args = (x, dt, a_log, B_in, C_in)
    want_y, want_h = _ssd_want(*args)
    rule = ssd_mod.route(dtype, P, N, chunk)
    for r in _routes(rule):
        y, h = ssd_mod.launch(*args, chunk=chunk, force=r)
        _close(y.cpu(), want_y.cpu().float().numpy(), dtype)
        _close(h.cpu(), want_h.cpu().numpy(), dtype)
        if r == rule:
            y0, h0 = ssd_mod.launch(*args, chunk=chunk)
            assert torch.equal(y, y0) and torch.equal(h, h0)


DECODE_EDGES = (1, 64, 65)          # one row, one split, one split + 1
DECODE_ROUTE_GRID = [(*case, None) for case in DECODE_GRID] + [
    # B, S, H, Hkv, D, lengths (None: random in 1..S)
    *[(4, 256, H, 1, 64, DECODE_EDGES + (256,)) for H in (1, 2, 4, 8, 16)],
    (4, 1024, 16, 1, 256, DECODE_EDGES + (1024,)),
    (4, 128, 8, 2, 16, DECODE_EDGES + (128,)),
    (4, 1024, 4, 1, 256, (520,) * 4),     # gemma3-1b global cache
    (4, 512, 4, 1, 256, (512,) * 4),      # gemma3-1b ring cache, full
    (1, 1024, 16, 1, 256, (520,)),        # recurrentgemma-9b
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,Hkv,D,lens", DECODE_ROUTE_GRID)
def test_cuda_decode_attention_routes_match_plain(cuda, B, S, H, Hkv, D,
                                                  lens, dtype):
    from repro_torch.kernels import decode_attention as decode_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    q, kc, vc = (_t(x, dtype).to(cuda) for x in _inputs(
        9, (B, 1, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    if lens is None:
        lens = np.random.default_rng(S).integers(1, S + 1, (B,))
    lengths = torch.tensor(np.asarray(lens, np.int32)).to(cuda)
    want = ref.decode_attention_ref(q, kc, vc, lengths).cpu().float()
    got = ops.decode_attention(q, kc, vc, lengths, block_kv=32)
    _close(got.cpu(), want.numpy(), dtype)
    rule = decode_mod.route(dtype, D, H // Hkv)
    for r in _routes(rule):
        out = decode_mod.launch(q, kc, vc, lengths, force=r)
        _close(out.cpu(), want.numpy(), dtype)
        if r == rule:
            assert torch.equal(out, decode_mod.launch(q, kc, vc, lengths))


RGLRU_EDGE_GRID = RGLRU_GRID + [
    (1, 1, 48),                     # inside one chunk
    (2, 7, 100),                    # and a partial 32-column tile
    (2, 97, 48),                    # a partial last chunk
    (1, 97, 100),
    (2, 520, 100),                  # a partial last group of chunks
    (1, 512, 4096),                 # recurrentgemma-9b serving, B = 1
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,W", RGLRU_EDGE_GRID)
def test_cuda_rglru_scan_chunk_edges_match_plain(cuda, B, S, W, dtype):
    a, b = _inputs(10, (B, S, W), (B, S, W))
    # mostly 0.8-1, as Griffin's gates make a: carries across chunks matter
    a = torch.sigmoid(_t(a, "float32") + 3.0).to(dtype).to(cuda)
    b = _t(b, dtype).to(cuda)
    want, final = ref.rglru_scan_ref(a, b)
    h = ops.rglru_scan(a, b)
    assert h.dtype == torch.float32
    _close(h.cpu(), want.cpu().numpy(), dtype)
    _close(h[:, -1].cpu(), final.cpu().numpy(), dtype)
