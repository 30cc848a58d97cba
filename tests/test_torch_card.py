"""The port's CUDA kernels against their plain versions, on a card.

Each kernel is held against its plain PyTorch version only, as
``chip_smoke.py`` does (the fp32 SSD scan against the sequential
recurrence evaluated in fp64), so the file imports no JAX and nothing
of the reference package: the machine with the card has neither.  Every
test takes the ``cuda`` fixture, which skips without a card; there, run
``python -m pytest tests/test_torch_card.py -q``.  Grids and tolerances
are ``tests/test_kernels.py``'s (atol = rtol = 2e-5 fp32, 2e-2 bf16),
plus head dim 8, the serving shapes (head dim 64 at GQA groups 1 and 7
for seamless-m4t-medium and internvl2-1b), and attn-tiny's flash
shapes (fp32, head dim 16, S = 16, 8, 4, B up to 256) on flash's short
route: its limits, unpadded calls against padded ones bit for bit, and
the CUDA-core kernel forced beside it.  Decode also runs at lm-tiny's
shapes (fp32, 2 heads on 1, D = 16 and 8, B up to 8 over 64 slots), at
GQA groups 10, 17, 24 and 32 and at lengths 0, 1, 64, 65 and S (a row
of length 0 is 0, as from the TPU kernel), and the SSD at a chunk of
40; every route of decode and the SSD is forced and counted (an SSD
call is one cluster launch on the tensor cores and three passes on the
CUDA cores; a decode call one on the tensor cores, two past one split on
the CUDA cores).  The bf16 tensor-core kernels run at every
head dim 16-256, 160 included (GQA groups 1, 4, 7 and 16, windows,
partial tiles; stablelm-12b's 32 heads on 8 at 160, across its 128-row
blocks at S = 129, 257, 1000 and 1024), and,
for the SSD, at mamba2-130m's serving calls, at one chunk, 5, 12, 16
and 32 chunks, at chunk 128, N up to 272 and with the state in tiles (P
= 96 and 128 in row tiles, N = 512 in column tiles, P = N = 256 in
both); the SSD's cluster kernel at every cluster size, one kernel record
a call; decode's cluster
kernel also at lengths below the cluster size, mid-tile and over 4096
slots (several tiles a rank), at both cluster sizes.  The fp32 flash
kernel (the CUDA-core route) runs at every head dim, with windows,
Sq != Sk and S not a multiple of its 32-row query tiles, and takes head
dim 8 in both dtypes when forced.
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
    wrapper accepts, the tensor cores (or flash's short route) those of
    the rule."""
    return ("cuda_core",) if rule == "cuda_core" else ("cuda_core", rule)


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
    (1, 512, 16, 16, 64, 0, 512),    # seamless-m4t-medium decoder
    (1, 512, 14, 2, 64, 0, 512),     # internvl2-1b: a group of 7
    (2, 100, 14, 2, 64, 0, 512),     # group 7, ragged (padding path)
    (1, 512, 32, 8, 160, 0, 512),    # stablelm-12b: head dim 160
    (2, 100, 32, 8, 160, 48, 32),    # and ragged, windowed
    (1, 512, 32, 8, 128, 0, 512),    # llama3-8b, minitron-8b
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
    rule = flash_mod.route(dtype, D, S, S)
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
    (2, 120, 4, 12, 2, 20, 40),     # a chunk of 40: padded 16-row pieces
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
    stats = KERNEL_STATS["ssd_scan"]
    for r in _routes(rule):
        before = stats.launches_by_route.get(r, 0)
        y, h = ssd_mod.launch(*args, chunk=chunk, force=r)
        # three passes, or the tensor cores' one cluster launch
        assert stats.launches_by_route[r] - before == \
            ssd_mod.kernels_per_call(dtype, P, N, chunk, r)
        _close(y.cpu(), want_y.cpu().float().numpy(), dtype)
        _close(h.cpu(), want_h.cpu().numpy(), dtype)
        if r == rule:
            y0, h0 = ssd_mod.launch(*args, chunk=chunk)
            assert torch.equal(y, y0) and torch.equal(h, h0)


# the bf16 tensor-core kernels: every head dim, GQA groups 1, 7 and 16,
# windows, partial tiles (S = 100: a 64-row tile and a 36-row one)
@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (14, 2), (16, 1)])
@pytest.mark.parametrize("D", [16, 32, 64, 128, 160, 256])
def test_cuda_flash_tensor_core_head_dims_groups_windows(cuda, D, H, Hkv,
                                                         window):
    from repro_torch.kernels import flash_attention as flash_mod
    B, S = 2, 100
    q, k, v = (_t(x, "bfloat16").to(cuda) for x in _inputs(
        D + H, (B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    got = flash_mod.launch(q, k, v, causal=True, window=window,
                           force="tensor_core")
    _close(got.cpu(), want.cpu().float().numpy(), "bfloat16")
    assert torch.equal(got, flash_mod.launch(q, k, v, causal=True,
                                             window=window))


# the pair kernel (head dims 160 and 128): 128-row blocks (a 64-row tile
# a warpgroup) at the dense paths' 32 heads on 8 (stablelm-12b at 160,
# llama3-8b and minitron-8b at 128), at lengths one row into a block
# (129), one past two (257) and inside a group's tile (1000), causal and
# windowed, at B = 1 and 3; and their model checks' prompt
@pytest.mark.parametrize("D", [128, 160])
@pytest.mark.parametrize("B,S,window", [
    (B, S, window) for B in (1, 3) for S in (129, 257, 1000)
    for window in (0, 100)] + [(1, 1024, 0)])
def test_cuda_flash_tensor_core_head_dim_160_pairs(cuda, B, S, window, D):
    from repro_torch.kernels import flash_attention as flash_mod
    H, Hkv = 32, 8
    q, k, v = (_t(x, "bfloat16").to(cuda) for x in _inputs(
        S + B + window + D, (B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    stats = KERNEL_STATS["flash_attention"]
    before = stats.launches_by_route.get("tensor_core", 0)
    got = flash_mod.launch(q, k, v, causal=True, window=window,
                           force="tensor_core")
    assert stats.launches_by_route["tensor_core"] - before == 1
    _close(got.cpu(), want.cpu().float().numpy(), "bfloat16")
    assert torch.equal(got, flash_mod.launch(q, k, v, causal=True,
                                             window=window))


SSD_TC_GRID = [
    # B, S, H, P, G, N, chunk
    # mamba2-130m's serving calls: clusters of 8, 4 and 2 on an H100
    (1, 512, 24, 64, 1, 128, 64),
    (2, 512, 24, 64, 1, 128, 64),
    (4, 512, 24, 64, 1, 128, 64),
    (1, 320, 24, 64, 1, 128, 64),     # 5 chunks: idle ranks
    (2, 768, 24, 64, 1, 128, 64),     # 12 chunks: a partial round
    (1, 2048, 24, 64, 1, 128, 64),    # 32 chunks: several rounds
    (2, 64, 4, 64, 1, 128, 64),       # one chunk
    (8, 1024, 48, 64, 1, 128, 64),    # 16 chunks, 6144 blocks
    (2, 2048, 24, 64, 2, 128, 128),   # a chunk of 128
    (2, 256, 4, 80, 1, 64, 64),       # P = 80
    (1, 512, 8, 64, 1, 256, 64),      # N = 256
    (1, 256, 4, 64, 1, 256, 128),     # N = 256 at a chunk of 128
    (1, 256, 4, 64, 1, 272, 64),      # N past 256
    (3, 192, 6, 32, 3, 48, 48),       # chunk 48, N 48, groups of 2
    # the state in tiles
    (2, 64, 4, 128, 1, 16, 16),       # P = 128: two row tiles
    (2, 256, 4, 96, 1, 16, 64),       # P = 96: two row tiles of 48
    (1, 64, 2, 64, 1, 512, 16),       # N = 512: two column tiles
    (1, 512, 4, 256, 1, 256, 64),     # 4 x 2 tiles, one round
    (1, 1024, 2, 256, 1, 256, 64),    # 4 x 2 tiles, two rounds
]


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", SSD_TC_GRID)
def test_cuda_ssd_tensor_core_shapes_match_plain(cuda, B, S, H, P, G, N,
                                                 chunk):
    from repro_torch.kernels import ssd_scan as ssd_mod
    x, B_in, C_in, dt = _inputs(10, (B, S, H, P), (B, S, G, N), (B, S, G, N),
                                (B, S, H))
    x, B_in, C_in = (_t(a, "bfloat16").to(cuda) for a in (x, B_in, C_in))
    dt = torch.nn.functional.softplus(_t(dt, "float32")).to(cuda)
    a_log = torch.log(torch.linspace(1.0, 4.0, H)).to(cuda)
    args = (x, dt, a_log, B_in, C_in)
    assert ssd_mod.route("bfloat16", P, N, chunk) == "tensor_core"
    want_y, want_h = ref.ssd_scan_ref(*args)
    y, h = ssd_mod.launch(*args, chunk=chunk, force="tensor_core")
    _close(y.cpu(), want_y.cpu().float().numpy(), "bfloat16")
    _close(h.cpu(), want_h.cpu().numpy(), "bfloat16")


# mamba2-130m's serving shape at B = 1 and 4 (8 chunks), and 12 chunks
SSD_CLUSTER_CASES = [(B, S, c) for B, S in ((1, 512), (4, 512), (2, 768))
                     for c in (0, 1, 2, 4, 8)]


@pytest.mark.parametrize("B,S,cluster", SSD_CLUSTER_CASES)
def test_cuda_ssd_tensor_core_cluster_matches_plain(cuda, B, S, cluster):
    """The one-launch cluster kernel at every size it launches (0: the
    rule's), against the plain version: one launch and one kernel record a
    call, and the same bits from the route chosen by shape."""
    from repro_torch.kernels import build
    from repro_torch.kernels import ssd_scan as ssd_mod
    H, P, G, N, chunk = 24, 64, 1, 128, 64
    x, B_in, C_in, dt = _inputs(11, (B, S, H, P), (B, S, G, N),
                                (B, S, G, N), (B, S, H))
    x, B_in, C_in = (_t(a, "bfloat16").to(cuda) for a in (x, B_in, C_in))
    dt = torch.nn.functional.softplus(_t(dt, "float32")).to(cuda)
    a_log = torch.log(torch.linspace(1.0, 4.0, H)).to(cuda)
    args = (x, dt, a_log, B_in, C_in)
    want_y, want_h = ref.ssd_scan_ref(*args)
    stats = KERNEL_STATS["ssd_scan"]
    before = stats.launches_by_route.get("tensor_core", 0)
    y, h = ssd_mod.launch(*args, chunk=chunk, force="tensor_core",
                          cluster=cluster)
    assert stats.launches_by_route["tensor_core"] - before == 1
    _close(y.cpu(), want_y.cpu().float().numpy(), "bfloat16")
    _close(h.cpu(), want_h.cpu().numpy(), "bfloat16")
    lib = build.library("ssd_scan")
    chosen = lib.ssd_scan_tc_cluster(B, S, H, P, N, chunk)
    held = {c: lib.ssd_scan_max_active_clusters(P, N, chunk, c,
                                                int(S // chunk > c))
            for c in ssd_mod.CLUSTERS}
    # the library's rule is the Python plan's on this card's occupancy
    assert chosen == ssd_mod.cluster_plan(
        B, S, H, P, N, chunk, lambda c, carry: lib.ssd_scan_max_active_clusters(
            P, N, chunk, c, int(carry)))["cluster"]
    assert all(n > 0 for n in held.values()), held
    if cluster in (0, chosen):
        y0, h0 = ssd_mod.ssd_scan(*args, chunk=chunk)
        assert torch.equal(y, y0) and torch.equal(h, h0)
    assert _kernel_records(
        lambda: ssd_mod.launch(*args, chunk=chunk, force="tensor_core",
                               cluster=cluster), "ssd_", 3) == 3


def test_cuda_ssd_cluster_smem_matches_the_python_mirror(cuda):
    """The library's cluster block bytes are ``cluster_smem_bytes``'s."""
    from repro_torch.kernels import build
    from repro_torch.kernels import ssd_scan as ssd_mod
    lib = build.library("ssd_scan")
    for P, N, chunk in ((64, 128, 64), (64, 256, 128), (80, 64, 128),
                        (64, 272, 64), (32, 48, 48), (128, 16, 16),
                        (64, 512, 16), (256, 256, 64)):
        for c in ssd_mod.CLUSTERS:
            for carry in (False, True):
                assert lib.ssd_scan_tc_smem_bytes(P, N, chunk, c, carry) == \
                    ssd_mod.cluster_smem_bytes(P, N, chunk, c, carry)


DECODE_EDGES = (1, 64, 65)          # one row, one split, one split + 1
DECODE_ROUTE_GRID = [(*case, None) for case in DECODE_GRID] + [
    # B, S, H, Hkv, D, lengths (None: random in 1..S)
    *[(4, 256, H, 1, 64, DECODE_EDGES + (256,)) for H in (1, 2, 4, 8, 16)],
    (4, 1024, 16, 1, 256, DECODE_EDGES + (1024,)),
    (4, 128, 8, 2, 16, DECODE_EDGES + (128,)),
    (4, 1024, 4, 1, 256, (520,) * 4),     # gemma3-1b global cache
    (4, 512, 4, 1, 256, (512,) * 4),      # gemma3-1b ring cache, full
    (1, 1024, 16, 1, 256, (520,)),        # recurrentgemma-9b
    # seamless-m4t-medium (16 heads on 16) and internvl2-1b (14 on 2, a
    # group of 7), head dim 64
    (4, 1024, 16, 16, 64, DECODE_EDGES + (1024,)),
    (4, 1024, 14, 2, 64, DECODE_EDGES + (1024,)),
    (4, 1024, 14, 2, 64, (520,) * 4),
    # lm-tiny: fp32 on the CUDA cores, 2 heads on 1, D = 16 (8 on its
    # rungs), 64 slots; rows of length 0; GQA groups 17 and 32 (the
    # CUDA-core route's blocks of query heads)
    *[(B, 64, 2, 1, D, (64,) * B) for B in (1, 2, 4, 8) for D in (16, 8)],
    *[(5, 64, 2, 1, D, (0, 1, 2, 65, 64)) for D in (16, 8)],
    *[(5, 256, 2, 1, D, (0,) + DECODE_EDGES + (256,)) for D in (16, 8)],
    (5, 1024, 16, 1, 256, (0,) + DECODE_EDGES + (1024,)),
    (3, 256, 17, 1, 64, (0, 65, 256)),
    (3, 256, 32, 1, 64, (1, 64, 256)),
    (3, 256, 32, 1, 256, (1, 130, 256)),
    # groups 17 and 32 at lm-tiny's head dims, 24 (a partial row block
    # past 16) and 17 across 16 splits, and a group of 10 on 2 KV heads
    *[(3, 64, H, 1, D, (0, 1, 64)) for H in (17, 32) for D in (16, 8)],
    (3, 256, 24, 1, 64, (1, 65, 256)),
    (3, 256, 24, 1, 256, (0, 64, 256)),
    (3, 1024, 17, 1, 256, (1, 520, 1024)),
    (2, 512, 20, 2, 128, (65, 512)),
    # the dense paths, 32 heads on 8: stablelm-12b at head dim 160 (the
    # CUDA-core kernel's 5 chunks a lane), its model check's 2048 slots,
    # and llama3-8b / minitron-8b at 128
    (5, 1024, 32, 8, 160, (0,) + DECODE_EDGES + (1024,)),
    (4, 1024, 32, 8, 160, (520,) * 4),
    (2, 2048, 32, 8, 160, (1032, 2048)),
    (4, 1024, 32, 8, 128, (520,) * 4),
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
    # a row of length 0 is 0, as from the TPU kernel (the plain version
    # averages V there)
    want[torch.as_tensor(np.asarray(lens)) == 0] = 0
    got = ops.decode_attention(q, kc, vc, lengths, block_kv=32)
    _close(got.cpu(), want.numpy(), dtype)
    rule = decode_mod.route(dtype, D, H // Hkv)
    stats = KERNEL_STATS["decode_attention"]
    for r in _routes(rule):
        before = stats.launches_by_route.get(r, 0)
        out = decode_mod.launch(q, kc, vc, lengths, force=r)
        # the cluster kernel alone; the split kernel, and the combine past
        # one split
        assert stats.launches_by_route[r] - before == _decode_kernels(r, S)
        _close(out.cpu(), want.numpy(), dtype)
        if r == rule:
            assert torch.equal(out, decode_mod.launch(q, kc, vc, lengths))


def _decode_kernels(route, S):
    """Kernels one decode call puts on the card on ``route``."""
    from repro_torch.kernels import decode_attention as decode_mod
    if route == "tensor_core":
        return 1
    return 2 if decode_mod.num_splits(S) > 1 else 1


# decode's tensor-core cluster kernel: lengths 0, 1, below the cluster
# size, mid-tile (a rank's range ends inside a 16-row piece) and S; 4096
# slots (four tiles a rank); every head dim; GQA groups 1, 7 and 16; more
# than one KV head
DECODE_TC_GRID = [
    # B, S, H, Hkv, D, lengths
    *[(5, 1024, 4, 1, D, (0, 1, 5, 520, 1024)) for D in (16, 32, 64, 128,
                                                         160, 256)],
    (3, 4096, 16, 1, 256, (2100, 4096, 9)),
    (3, 4096, 32, 8, 160, (2100, 4096, 9)),
    (3, 4096, 7, 1, 16, (4096, 1, 3000)),
    (4, 256, 14, 2, 64, (0, 7, 100, 256)),
    (2, 512, 16, 16, 32, (333, 512)),
    (2, 48, 1, 1, 128, (47, 48)),
]


# each case at the cluster size the shape takes (0) and at every size the
# kernel is built for that the head dim allows (at most D / 2)
DECODE_TC_CASES = [(*case, c) for case in DECODE_TC_GRID
                   for c in (0, 1, 2, 4, 8, 16) if c <= case[4] // 2]


@pytest.mark.parametrize("B,S,H,Hkv,D,lens,cluster", DECODE_TC_CASES)
def test_cuda_decode_tensor_core_cluster_matches_plain(cuda, B, S, H, Hkv, D,
                                                       lens, cluster):
    """The one-launch cluster kernel against the plain version (rows of
    length 0 are 0), one launch and one kernel record a call, and the
    same bits from the route chosen by shape."""
    from repro_torch.kernels import decode_attention as decode_mod
    q, kc, vc = (_t(x, "bfloat16").to(cuda) for x in _inputs(
        12 + D, (B, 1, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    lengths = torch.tensor(np.asarray(lens, np.int32)).to(cuda)
    want = ref.decode_attention_ref(q, kc, vc, lengths).cpu().float()
    want[torch.as_tensor(np.asarray(lens)) == 0] = 0
    stats = KERNEL_STATS["decode_attention"]
    before = stats.launches_by_route.get("tensor_core", 0)
    out = decode_mod.launch(q, kc, vc, lengths, force="tensor_core",
                            cluster=cluster)
    assert stats.launches_by_route["tensor_core"] - before == 1
    _close(out.cpu(), want.numpy(), "bfloat16")
    if cluster == 0:
        assert torch.equal(out, decode_mod.launch(q, kc, vc, lengths))
    assert _kernel_records(
        lambda: decode_mod.launch(q, kc, vc, lengths, force="tensor_core",
                                  cluster=cluster), "decode_tc_kernel",
        3) == 3


def _kernel_records(fn, name, calls, tries=5):
    """``fn`` ``calls`` times under the profiler: the device records of
    kernels whose name holds ``name``.  The tracer can drop records late in
    a process (never add them), so a session that holds other than
    ``calls`` records is run again, at most ``tries`` times, a second
    later where it held no record at all (late in a process, sessions
    taken back to back have all come back empty); each session starts
    with a warm-up step of empty kernels, whose records it does not
    keep."""
    import time
    from torch.profiler import ProfilerActivity, profile, schedule
    records = None
    for _ in range(tries):
        if records == 0:
            time.sleep(1.0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(4):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
            prof.step()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        records = sum(e.device_type == torch.autograd.DeviceType.CUDA
                      and name in e.name for e in prof.events())
        if records == calls:
            break
    return records


# the fp32 flash kernel (CUDA cores) at every head dim, windows, Sq != Sk
# (queries at positions 0 .. Sq - 1 against Sk keys) and S that is not a
# multiple of its 32-row query tiles or its KV tiles
FLASH_CC_GRID = [
    # B, Sq, Sk, H, Hkv, D, causal, window
    *[(2, 100, 100, 4, 2, D, True, 0) for D in (8, 16, 32, 64, 128, 160,
                                                 256)],
    *[(1, 77, 77, 14, 2, D, True, 33) for D in (16, 64, 160, 256)],
    (2, 40, 130, 4, 1, 64, True, 0),
    (2, 130, 40, 4, 4, 32, True, 0),
    (1, 90, 50, 2, 1, 256, False, 0),
    (1, 50, 90, 8, 2, 128, False, 24),
    (1, 1000, 1000, 16, 16, 64, True, 0),
    (1, 257, 257, 16, 1, 256, True, 100),
]


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal,window", FLASH_CC_GRID)
def test_cuda_flash_cuda_core_route_matches_plain(cuda, B, Sq, Sk, H, Hkv,
                                                  D, causal, window):
    """fp32 by shape (the CUDA-core route past the short route's limits),
    and head dim 8 forced onto it in both dtypes."""
    from repro_torch.kernels import flash_attention as flash_mod
    for dtype in DTYPES:
        if dtype == "bfloat16" and D != 8:
            continue
        q, k, v = (_t(x, dtype).to(cuda) for x in _inputs(
            13 + D, (B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))
        want = ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window)
        stats = KERNEL_STATS["flash_attention"]
        before = stats.launches_by_route.get("cuda_core", 0)
        got = flash_mod.launch(q, k, v, causal=causal, window=window,
                               force="cuda_core")
        assert stats.launches_by_route["cuda_core"] - before == 1
        _close(got.cpu(), want.cpu().float().numpy(), dtype)
        if flash_mod.route(dtype, D, Sq, Sk) == "cuda_core":
            assert torch.equal(got, flash_mod.launch(
                q, k, v, causal=causal, window=window))


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
    """attn-tiny's rungs (S = 16, 8, 4; on a card unpadded) at the
    serving batches: the wrapper's one launch lands on the short route;
    it, the short route and the CUDA-core route forced match the plain
    version, and short and CUDA cores agree within fp32's 2e-5."""
    from repro_torch.kernels import flash_attention as flash_mod
    q, k, v = (_t(x, "float32").to(cuda) for x in _inputs(
        11, (B, S, 2, 16), (B, S, 2, 16), (B, S, 2, 16)))
    want = ref.flash_attention_ref(q, k, v, causal=True).cpu().numpy()
    assert flash_mod.route("float32", 16, S, S) == "short"
    before = dict(KERNEL_STATS["flash_attention"].launches_by_route)
    got = ops.flash_attention(q, k, v, causal=True)
    _close(got.cpu(), want, "float32")
    after = dict(KERNEL_STATS["flash_attention"].launches_by_route)
    before["short"] = before.get("short", 0) + 1
    assert after == before
    short = flash_mod.launch(q, k, v, causal=True, window=0, force="short")
    assert torch.equal(short, got)
    old = flash_mod.launch(q, k, v, causal=True, window=0,
                           force="cuda_core")
    _close(old.cpu(), want, "float32")
    _close(short.cpu(), old.cpu().numpy(), "float32")


@pytest.mark.parametrize("B", (1, 16, 256))
@pytest.mark.parametrize("S", (8, 4))
def test_cuda_flash_unpadded_equals_padded_bit_for_bit(cuda, B, S):
    """The wrapper's unpadded call at attn-tiny's short rungs gives the
    bits of the same call padded with zeros to 16 (the reference's rule)
    on the short route and by shape."""
    from repro_torch.kernels import flash_attention as flash_mod
    q, k, v = (_t(x, "float32").to(cuda) for x in _inputs(
        15, (B, S, 2, 16), (B, S, 2, 16), (B, S, 2, 16)))
    assert not ops.flash_pads("cuda", "float32", True, S, S, 16)
    got = ops.flash_attention(q, k, v, causal=True)

    def pad(x):
        return torch.cat([x, x.new_zeros((B, 16 - S, 2, 16))], 1)

    qp, kp, vp = pad(q), pad(k), pad(v)
    for force in ("short", ""):
        padded = flash_mod.launch(qp, kp, vp, causal=True, window=0,
                                  force=force)
        assert torch.equal(got, padded[:, :S])


FLASH_SHORT_GRID = [
    # B, Sq, Sk, H, Hkv, D, causal, window: the short route's limits
    (3, 16, 16, 4, 1, 32, True, 0),
    (3, 16, 16, 4, 2, 8, True, 5),
    (2, 1, 16, 2, 2, 16, True, 0),
    (2, 1, 1, 2, 2, 16, True, 0),
    (2, 16, 3, 2, 1, 16, True, 0),
    (2, 16, 16, 2, 2, 16, False, 0),
    (301, 13, 13, 3, 1, 16, True, 0),    # a block with an idle warp
]


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal,window", FLASH_SHORT_GRID)
def test_cuda_flash_short_route_limits_match_plain(cuda, B, Sq, Sk, H, Hkv,
                                                   D, causal, window):
    from repro_torch.kernels import flash_attention as flash_mod
    q, k, v = (_t(x, "float32").to(cuda) for x in _inputs(
        16, (B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))
    want = ref.flash_attention_ref(q, k, v, causal=causal,
                                   window=window).cpu().numpy()
    assert flash_mod.route("float32", D, Sq, Sk) == "short"
    outs = {}
    for force in ("short", "cuda_core"):
        outs[force] = flash_mod.launch(q, k, v, causal=causal,
                                       window=window, force=force)
        _close(outs[force].cpu(), want, "float32")
    assert torch.equal(outs["short"], flash_mod.launch(
        q, k, v, causal=causal, window=window))
    _close(ops.flash_attention(q, k, v, causal=causal, window=window,
                               block_q=16, block_kv=16).cpu(), want,
           "float32")


@pytest.mark.parametrize("dtype,Sq,Sk,D", [
    ("float32", 17, 17, 16), ("float32", 16, 17, 16),
    ("float32", 17, 16, 16), ("float32", 16, 16, 64),
    ("bfloat16", 16, 16, 16), ("bfloat16", 8, 8, 8)])
def test_cuda_flash_short_route_refuses_past_its_limits(cuda, dtype, Sq, Sk,
                                                        D):
    """One past the limits the short route, forced, raises and counts no
    launch; by shape the call takes the CUDA cores or the tensor cores."""
    from repro_torch.kernels import flash_attention as flash_mod
    q, k, v = (_t(x, dtype).to(cuda) for x in _inputs(
        17, (2, Sq, 2, D), (2, Sk, 2, D), (2, Sk, 2, D)))
    assert flash_mod.route(dtype, D, Sq, Sk) != "short"
    before = dict(KERNEL_STATS["flash_attention"].launches_by_route)
    with pytest.raises(ValueError, match="no CUDA kernel"):
        flash_mod.launch(q, k, v, causal=True, window=0, force="short")
    assert dict(KERNEL_STATS["flash_attention"].launches_by_route) == before
    want = ref.flash_attention_ref(q, k, v, causal=True)
    _close(flash_mod.launch(q, k, v, causal=True, window=0).cpu(),
           want.cpu().float().numpy(), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_head_dim_without_a_kernel_raises(cuda, dtype):
    """A CUDA call at a head dim outside ``build.HEAD_DIMS`` (96) raises
    ``ValueError`` in both wrappers before any launch, and nothing falls
    back to the plain version."""
    from repro_torch.kernels import build
    assert 96 not in build.HEAD_DIMS
    q, kc = (_t(x, dtype).to(cuda) for x in _inputs(
        20, (1, 64, 4, 96), (1, 64, 2, 96)))
    lengths = torch.full((1,), 64, device=cuda, dtype=torch.int32)
    before = {n: (dict(s.launches_by_route), s.cpu_calls)
              for n, s in KERNEL_STATS.items()}
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, kc, kc, causal=True)
    with pytest.raises(ValueError, match="head dim"):
        ops.decode_attention(q[:, :1], kc, kc, lengths)
    assert {n: (dict(s.launches_by_route), s.cpu_calls)
            for n, s in KERNEL_STATS.items()} == before


def test_cuda_short_route_is_flash_only(cuda):
    """The decode and SSD entries refuse the short route's code."""
    from repro_torch.kernels import decode_attention as decode_mod
    from repro_torch.kernels import ssd_scan as ssd_mod
    q, kc, x, Bi = (_t(a, "float32").to(cuda) for a in _inputs(
        18, (1, 1, 2, 16), (1, 64, 2, 16), (1, 64, 2, 8), (1, 64, 1, 16)))
    lengths = torch.full((1,), 64, device=cuda, dtype=torch.int32)
    with pytest.raises(ValueError, match="no CUDA kernel"):
        decode_mod.launch(q, kc, kc, lengths, force="short")
    dt = torch.full((1, 64, 2), 0.1, device=cuda)
    with pytest.raises(ValueError, match="no CUDA kernel"):
        ssd_mod.launch(x, dt, torch.zeros(2, device=cuda), Bi, Bi, chunk=16,
                       force="short")


def test_cuda_flash_never_computes_the_plain_version(cuda, monkeypatch):
    """A CUDA tensor never reaches ``flash_attention_ref``: at every
    attn-tiny rung the wrapper launches a kernel or raises."""
    from repro_torch.kernels import flash_attention as flash_mod

    def refuse(*a, **kw):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(flash_mod, "flash_attention_ref", refuse)
    for S in (16, 8, 4):
        q = _t(_inputs(19, (4, S, 2, 16))[0], "float32").to(cuda)
        assert ops.flash_attention(q, q, q, causal=True).shape == q.shape
    with pytest.raises(ValueError, match="aligned"):
        ops.flash_attention(q, q, q, causal=False)


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


def _reduced_train(dtype="float32", **overrides):
    """Reduced gemma3-1b (2 repeats, d_model 64, vocab 512), a TrainConfig
    and one seeded batch from the synthetic corpus."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data import batches_for_model
    from repro_torch.training import AdamWConfig, TrainConfig
    cfg = get_config("gemma3-1b").reduced(dtype=dtype).with_overrides(
        **overrides)
    batch = next(batches_for_model(
        cfg, ShapeConfig("t", seq_len=64, global_batch=2, kind="train")))
    return cfg, TrainConfig(adamw=AdamWConfig(learning_rate=1e-3,
                                              warmup_steps=1)), batch


def test_cuda_train_step_refuses_the_kernels(cuda):
    """Training through the kernels would lose gradients at them: the
    step raises the wrappers' RuntimeError and launches nothing."""
    from repro_torch.models.lm import init_params
    from repro_torch.training import init_adamw, make_train_step
    cfg, tcfg, batch = _reduced_train(use_pallas_kernels=True)
    params = init_params(cfg, 0, device=cuda)
    step = make_train_step(cfg, tcfg)
    before = KERNEL_STATS["flash_attention"].launches
    with pytest.raises(RuntimeError, match="no backward"):
        step(params, init_adamw(tcfg.adamw, params),
             {k: v.to(cuda) for k, v in batch.items()})
    assert KERNEL_STATS["flash_attention"].launches == before


def test_cuda_train_moves_the_params_and_matches_cpu(cuda):
    """``train`` on the card: every parameter stays on the card and
    moves, and two steps repeat the CPU's losses (fp32, 1e-5 relative)."""
    import itertools
    from repro_torch.models import build_model
    from repro_torch.models.lm import init_params
    from repro_torch.training import train
    from repro_torch.training.tree import leaves_with_path, tree_map
    cfg, tcfg, batch = _reduced_train()
    model = build_model(cfg)
    start = init_params(cfg, 0, device="cpu")
    losses = {}
    for dev in ("cpu", cuda):
        got = []
        out, opt, _ = train(
            model, tcfg, itertools.repeat(batch), steps=2, device=dev,
            params=tree_map(lambda t: t.to(dev, copy=True), start),
            on_step=lambda s, m: got.append(float(m["loss"])))
        losses[str(dev)] = got
        assert int(opt.step) == 2
    for (name, new), (_, old) in zip(leaves_with_path(out),
                                     leaves_with_path(start)):
        assert new.device.type == "cuda", name
        assert not torch.equal(new.cpu(), old), name
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)


# --------------------------------------------------------------------- #
# distribution on the card: blockwise int8, a one-rank NCCL group
# --------------------------------------------------------------------- #
@pytest.fixture
def nccl_world(cuda):
    """A one-rank NCCL group on the card (NCCL takes one rank per
    device), destroyed after the test."""
    import socket
    import torch.distributed as dist
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


@pytest.mark.parametrize("shape", [(1000,), (4, 256), (3, 7, 37),
                                   (1 << 20,)])
def test_cuda_quantize_blockwise_equals_cpu(cuda, shape):
    from repro_torch.distributed.compression import (dequantize_blockwise,
                                                     quantize_blockwise)
    x = _t(_inputs(11, shape)[0], "float32") * 3.0
    x.reshape(-1)[:256] = 0.0                  # an all-zero block
    q, s, pad = quantize_blockwise(x.to(cuda))
    q_c, s_c, pad_c = quantize_blockwise(x)
    assert pad == pad_c
    assert torch.equal(q.cpu(), q_c)
    assert torch.equal(s.cpu().view(torch.int32), s_c.view(torch.int32))
    back = dequantize_blockwise(q, s, pad, shape).cpu()
    assert torch.equal(back.view(torch.int32),
                       dequantize_blockwise(q_c, s_c, pad_c, shape).view(
                           torch.int32))


def test_cuda_compressed_psum_on_one_nccl_rank(nccl_world, cuda):
    """Over one rank the shared scale is the rank's own: the sum is its
    quantize → dequantize, bit for bit, and the CPU's bits."""
    from repro_torch.distributed.compression import (compressed_psum,
                                                     dequantize_blockwise,
                                                     quantize_blockwise)
    x = _t(_inputs(12, (37, 300))[0], "float32")
    got = compressed_psum(x.to(cuda), nccl_world)
    want = dequantize_blockwise(*quantize_blockwise(x), x.shape)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


def test_cuda_shard_hints_are_exact_on_a_one_rank_mesh(nccl_world, cuda):
    """``shard_seq``, ``shard_heads`` and ``shard_decode_scores`` on a
    (1, 1) CUDA mesh change no value; without the mesh they return their
    input itself."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.distributed import use_mesh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import (shard_decode_scores, shard_heads,
                                           shard_seq)
    mesh = make_mesh((1, 1), ("data", "model"))
    x = _t(_inputs(13, (2, 8, 4, 16))[0], "float32").to(cuda)
    d = DTensor.from_local(x, mesh, [Replicate(), Replicate()])
    for hint in (shard_seq, shard_heads, shard_decode_scores):
        assert hint(x) is x and hint(d) is d
        with use_mesh(mesh):
            got = hint(d)
            assert hint(x) is x
        assert isinstance(got, DTensor)
        assert torch.equal(got.full_tensor().view(torch.int32),
                           x.view(torch.int32))

