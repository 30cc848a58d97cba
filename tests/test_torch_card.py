"""The port's CUDA kernels against their plain versions, on a card.

Each kernel is held against its plain PyTorch version only, as
``chip_smoke.py`` does (the fp32 SSD scan against the sequential
recurrence evaluated in fp64), so the file imports no JAX and nothing
of the reference package: the machine with the card has neither.  Every
test takes the ``cuda`` fixture, which skips without a card; there, run
``python -m pytest tests/test_torch_card.py -q``.  Grids and tolerances
are ``tests/test_kernels.py``'s (atol = rtol = 2e-5 fp32, 2e-2 bf16),
plus head dim 8, the serving shapes, and attn-tiny's flash shapes (fp32,
head dim 16, S = 16, 8, 4, B up to 256).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import KERNEL_STATS  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

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


def _t(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    # kernel and plain versions are compared in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    a = torch.sigmoid(_t(a, "float32")).to(getattr(torch, dtype)).to(cuda)
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
    a = torch.sigmoid(_t(a, "float32") + 3.0).to(getattr(torch, dtype))
    a = a.to(cuda)
    b = _t(b, dtype).to(cuda)
    want, final = ref.rglru_scan_ref(a, b)
    h = ops.rglru_scan(a, b)
    assert h.dtype == torch.float32
    _close(h.cpu(), want.cpu().numpy(), dtype)
    _close(h[:, -1].cpu(), final.cpu().numpy(), dtype)


# --------------------------------------------------------------------- #
# on a card: attn-tiny's flash shapes and the micro steps
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("B", (1, 16, 256))
@pytest.mark.parametrize("S", (16, 8, 4))
def test_cuda_flash_attention_attn_tiny_shapes(cuda, B, S):
    """attn-tiny's rungs (S = 16, 8, 4; the wrapper pads 8 and 4 to 16)
    at the serving batches, through the wrapper and the CUDA-core route
    forced, against the plain version."""
    from repro_torch.kernels import flash_attention as flash_mod
    q, k, v = (_t(x, "float32").to(cuda) for x in _inputs(
        11, (B, S, 2, 16), (B, S, 2, 16), (B, S, 2, 16)))
    want = ref.flash_attention_ref(q, k, v, causal=True).cpu().numpy()
    assert flash_mod.route("float32", 16) == "cuda_core"
    before = dict(KERNEL_STATS["flash_attention"].launches_by_route)
    _close(ops.flash_attention(q, k, v, causal=True).cpu(), want, "float32")
    after = KERNEL_STATS["flash_attention"].launches_by_route
    assert after.get("cuda_core", 0) == before.get("cuda_core", 0) + 1
    out = flash_mod.launch(q, k, v, causal=True, window=0, force="cuda_core")
    _close(out.cpu(), want, "float32")


@pytest.mark.parametrize("name", ("mlp-tiny", "mlp", "attn-tiny"))
def test_cuda_micro_step_matches_cpu(cuda, name):
    """The card's micro step against the CPU plain step on the same
    weights and inputs, within fp32 2e-5, and its runner's contract."""
    from repro_torch.models import micro
    if name == "attn-tiny":
        q, k, v = (_t(x, "float32") for x in _inputs(
            12, (256, 16, 2, 16), (256, 16, 2, 16), (256, 16, 2, 16)))
        want = micro.attn_step(q, k, v)
        got = micro.attn_step(q.to(cuda), k.to(cuda), v.to(cuda))
    else:
        dim, depth = {"mlp-tiny": (32, 2), "mlp": (128, 4)}[name]
        params = micro.init_mlp_params(dim, depth, 0, "cpu")
        x = _t(_inputs(12, (256, dim))[0], "float32")
        want = micro.mlp_step(x, params)
        got = micro.mlp_step(x.to(cuda), [(w.to(cuda), c.to(cuda))
                                          for w, c in params])
    _close(got.cpu(), want.numpy(), "float32")
    before = KERNEL_STATS["flash_attention"].launches
    make_runner = micro.make_micro_runner(name)
    run = make_runner(1, 16)
    assert run() is None and make_runner(4, 16) is run
    launched = KERNEL_STATS["flash_attention"].launches - before
    assert launched == (2 if name == "attn-tiny" else 0)   # warm + run


def _grad_cases(dev):
    """name -> (inputs that require grad, the kernel wrapper's call on
    them): small fp32 shapes every wrapper takes."""
    B, S, H, D = 1, 32, 2, 16
    q, k, v, a, b = (_t(x, "float32").to(dev).requires_grad_() for x in
                     _inputs(13, (B, S, H, D), (B, S, 1, D), (B, S, 1, D),
                             (B, S, 64), (B, S, 64)))
    x, Bi, Ci = (_t(x, "float32").to(dev).requires_grad_() for x in
                 _inputs(14, (B, S, 4, 8), (B, S, 1, 8), (B, S, 1, 8)))
    dt = torch.full((B, S, 4), 0.1, device=dev, requires_grad=True)
    a_log = torch.zeros(4, device=dev, requires_grad=True)
    lengths = torch.full((B,), S, device=dev)
    return {
        "flash_attention": ((q, k, v), lambda: ops.flash_attention(q, k, v)),
        "decode_attention": ((q, k, v), lambda: ops.decode_attention(
            q[:, :1], k, v, lengths)),
        "ssd_scan": ((x, dt, a_log, Bi, Ci), lambda: ops.ssd_scan(
            x, dt, a_log, Bi, Ci, chunk=16)),
        "rglru_scan": ((a, b), lambda: ops.rglru_scan(torch.sigmoid(a), b)),
    }


@pytest.mark.parametrize("name", ("flash_attention", "decode_attention",
                                  "ssd_scan", "rglru_scan"))
def test_cuda_kernels_refuse_inputs_that_require_grad(cuda, name):
    """A kernel's outputs have no grad_fn: under grad mode, an input that
    requires grad raises instead of losing its gradient at the kernel;
    under no_grad the same call launches."""
    _, call = _grad_cases(cuda)[name]
    before = KERNEL_STATS[name].launches
    with pytest.raises(RuntimeError, match="no backward"):
        call()
    assert KERNEL_STATS[name].launches == before
    with torch.no_grad():
        out = call()
    assert KERNEL_STATS[name].launches > before
    out = out[0] if isinstance(out, tuple) else out
    assert out.device.type == "cuda" and bool(torch.isfinite(out).all())
