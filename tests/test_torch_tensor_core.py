"""The tensor-core routes of the port's flash_attention and ssd_scan.

* The route rules (pure Python, mirrored by the C entries): bf16 at the
  serving shapes takes the tensor cores; fp32, head dim 8 and P = 8 take
  the CUDA cores.  CPU tensors take the plain version and launch nothing.
* Launch counts are kept by route, and an edited shared header renames
  the built library.
* The flash tensor-core kernel's schedule (``_tc_tiles``, a mirror of
  ``flash_tc_kernel``'s tile loop): every (query, key)
  pair the causal and window masks leave visible lies in exactly one
  loaded KV tile, no loaded tile is wholly masked for its query tile,
  and the two warpgroups take alternate tiles.  The same for the fp32
  CUDA-core kernel's schedule (``_cc_blocks``: 32-row query tiles, the
  heaviest first under causal masking, the KV tiles of each alternating
  between the two blocks of a cluster).
* A test-local PyTorch mirror of that kernel's arithmetic: per 64-row
  query tile, each warpgroup's online softmax (log2 domain, the finite
  mask) over its tiles with P rounded to bf16 before P V, then the two
  states merged; held against ``ref.flash_attention_ref`` and the JAX
  package's ``flash_attention`` (the Pallas kernel in interpret mode) at
  bf16's tolerance, at sequence lengths that are not multiples of the
  tiles.
* A test-local PyTorch model of the SSD tensor-core route's arithmetic as
  three passes (chunk states, the state pass, the chunk scan) with the
  kernel's rounding points: x·w, the masked score matrix and the state entering a
  chunk each carried as a bf16 pair hi + lo.  It is held against
  ``ref.ssd_scan_ref`` and the JAX package's ``ssd_scan`` (the Pallas
  kernel in interpret mode, as ``tests/test_kernels.py`` runs it) at the
  grid's small shapes and at mamba2-130m's widths, with bf16's tolerance
  (atol = rtol = 2e-2) on y and the final state.  The cluster kernel's
  schedule (``ssd_mod.cluster_plan``: cluster size, rounds, state tiles,
  each rank's rows) produces every entering state once, and its sliced,
  tiled exchange equals the three-pass model bit for bit.

The kernels themselves run only on a card (``tests/test_torch_kernels.py``,
``chip_smoke.py``).
"""

import importlib.util
import itertools
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import KERNEL_STATS, build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402
from test_torch_kernels import _close  # noqa: E402
from test_torch_ssm import _as, _ssd_inputs  # noqa: E402

jax.config.update("jax_enable_x64", False)

BF16_TOL = dict(atol=2e-2, rtol=2e-2)   # tests/test_kernels.py's bf16
ROOT_SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """Tiny CPU ops run far slower under an oversubscribed intra-op pool
    (several test workers share the host); the tests need one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------- #
# route rules
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype,D,sq,sk,want", [
    ("bfloat16", 256, 512, 512, "tensor_core"),  # gemma3-1b, recurrentgemma
    ("bfloat16", 16, 64, 64, "tensor_core"),
    ("bfloat16", 64, 512, 512, "tensor_core"),
    ("bfloat16", 16, 16, 16, "tensor_core"),   # short bf16: tensor cores
    ("bfloat16", 160, 512, 512, "tensor_core"),  # stablelm-12b
    ("bfloat16", 128, 512, 512, "tensor_core"),  # llama3-8b, minitron-8b
    ("bfloat16", 96, 512, 512, "cuda_core"),   # no kernel: the wrapper
    ("float32", 160, 1024, 1024, "cuda_core"),  # stablelm-12b's check
    ("bfloat16", 8, 64, 64, "cuda_core"),      # below mma's depth of 16
    ("bfloat16", 8, 16, 16, "cuda_core"),      # the short route is fp32
    ("float32", 256, 512, 512, "cuda_core"),   # TF32 misses fp32's 2e-5
    ("float32", 8, 64, 64, "cuda_core"),
    ("float32", 16, 16, 16, "short"),          # attn-tiny's three rungs
    ("float32", 16, 8, 8, "short"),
    ("float32", 16, 4, 4, "short"),
    ("float32", 8, 1, 16, "short"),            # the route's limits
    ("float32", 32, 16, 1, "short"),
    ("float32", 16, 17, 17, "cuda_core"),      # one past them
    ("float32", 16, 16, 17, "cuda_core"),
    ("float32", 16, 17, 16, "cuda_core"),
    ("float32", 64, 16, 16, "cuda_core"),
    ("float32", 16, 0, 16, "cuda_core"),
])
def test_flash_route_rule(dtype, D, sq, sk, want):
    assert flash_mod.route(dtype, D, sq, sk) == want


class _FakeFlashLib:
    """Stands in for the built library: records the C entry's arguments."""

    def __init__(self):
        self.calls = []

    def flash_attention_fwd(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("dtype,B,Sq,Sk,H,Hkv,D,window,taken", [
    ("bfloat16", 4, 512, 512, 32, 8, 160, 0, "tensor_core"),  # stablelm-12b
    ("bfloat16", 1, 512, 512, 4, 1, 256, 512, "tensor_core"),  # a local layer
    ("float32", 256, 16, 16, 2, 2, 16, 0, "short"),           # attn-tiny
    ("float32", 1, 1000, 1000, 14, 2, 64, 0, "cuda_core"),
])
def test_flash_wrapper_counts_calls_by_shape(monkeypatch, dtype, B, Sq, Sk,
                                             H, Hkv, D, window, taken):
    """Each launching call is counted under its route and by its shape,
    (dtype, B, Sq, Sk, H, Hkv, D, window), the key ``chip_smoke.py`` times
    the serving paths' flash calls at; the C entry gets the same sizes."""
    lib = _FakeFlashLib()

    class _Stream:
        cuda_stream = 0
    monkeypatch.setattr(build, "library", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    q = torch.zeros((B, Sq, H, D), dtype=getattr(torch, dtype))
    kv = torch.zeros((B, Sk, Hkv, D), dtype=q.dtype)
    stats = KERNEL_STATS["flash_attention"]
    key = (dtype, B, Sq, Sk, H, Hkv, D, window)
    before = (stats.launches_by_route.get(taken, 0),
              stats.calls_by_shape.get(key, 0))
    flash_mod.launch(q, kv, kv, causal=True, window=window)
    assert lib.calls[-1][4:12] == (B, Sq, Sk, H, Hkv, D, 1, window)
    assert stats.launches_by_route[taken] - before[0] == 1
    assert stats.calls_by_shape[key] - before[1] == 1


def test_head_dims_the_kernels_are_built_for():
    """The C entries' head dims: every one the registered configurations
    use on one card (8 for lm-tiny's rungs, 160 for stablelm-12b), and
    the tensor cores all but 8, below mma's depth of 16."""
    assert build.HEAD_DIMS == (8, 16, 32, 64, 128, 160, 256)
    assert build.TENSOR_CORE_HEAD_DIMS == (16, 32, 64, 128, 160, 256)
    assert build.SHORT_HEAD_DIMS == (8, 16, 32)


@pytest.mark.parametrize("dtype,P,N,chunk,want", [
    ("bfloat16", 64, 128, 64, "tensor_core"),   # mamba2-130m
    ("bfloat16", 16, 16, 16, "tensor_core"),    # the grouped grid case
    ("bfloat16", 16, 32, 48, "tensor_core"),
    ("bfloat16", 8, 16, 16, "cuda_core"),       # P = 8
    ("bfloat16", 64, 12, 64, "cuda_core"),      # N not a multiple of 16
    ("bfloat16", 64, 128, 256, "cuda_core"),    # chunk above 128
    ("bfloat16", 256, 512, 128, "cuda_core"),   # over one SM's memory
    ("bfloat16", 80, 64, 128, "tensor_core"),   # P = 80
    ("bfloat16", 64, 192, 128, "tensor_core"),
    ("bfloat16", 64, 256, 128, "tensor_core"),  # 231,968 bytes a block
    ("bfloat16", 64, 272, 64, "tensor_core"),   # N past 256
    ("bfloat16", 128, 16, 16, "tensor_core"),   # P = 128: two row tiles
    ("bfloat16", 64, 512, 16, "tensor_core"),   # N = 512: two column tiles
    ("bfloat16", 256, 256, 64, "tensor_core"),  # 4 x 2 tiles
    ("float32", 64, 128, 64, "cuda_core"),
])
def test_ssd_route_rule(dtype, P, N, chunk, want):
    assert ssd_mod.route(dtype, P, N, chunk) == want


@pytest.mark.parametrize("P,N,chunk,tiles", [
    (64, 128, 64, (64, 128)),       # mamba2-130m: the state is one tile
    (64, 128, 128, (64, 128)),
    (80, 64, 64, (48, 64)), (80, 64, 128, (80, 64)),
    (64, 256, 64, (64, 256)), (64, 256, 128, (64, 256)),
    (64, 272, 64, (64, 272)),
    (32, 48, 48, (32, 48)), (16, 16, 16, (16, 16)),
    (96, 16, 64, (48, 16)),         # 2 column pairs a warp at chunk <= 64
    (112, 16, 64, (64, 16)),        # row tiles of 64 and 48
    (96, 16, 128, (48, 16)),        # 5 pairs at one warp a slab
    (128, 16, 16, (64, 16)),
    (64, 512, 16, (64, 256)),       # the increments of N = 512 in halves
    (64, 512, 64, (64, 128)),
    (256, 256, 64, (64, 128)),
])
def test_ssd_tensor_core_shapes_take_one_launch_and_their_tiles(P, N, chunk,
                                                               tiles):
    """Every shape the tensor cores take runs as one cluster launch, its
    state cut into the fewest row tiles a slab's warps hold in registers
    and the fewest column tiles whose block fits an SM; chosen by
    shape."""
    assert ssd_mod.route("bfloat16", P, N, chunk) == "tensor_core"
    assert ssd_mod.cluster_tiles(P, N, chunk) == tiles
    assert ssd_mod.tc_smem_bytes(P, N, chunk) <= build.MAX_SMEM_BYTES
    assert ssd_mod.kernels_per_call("bfloat16", P, N, chunk) == 1
    assert ssd_mod.kernels_per_call("bfloat16", P, N, chunk,
                                    "cuda_core") == 3
    assert ssd_mod.kernels_per_call("float32", P, N, chunk) == 3


def _passes_smem_bytes(P, N, chunk):
    """The larger block of the three tensor-core passes the cluster
    kernel replaced, whose fit was the route's rule before it."""
    state = 16 * chunk + 2 * (chunk * (N + 8) + 2 * chunk * (P + 8))
    scan = 16 * chunk + 2 * (2 * chunk * (N + 8) + chunk * (P + 8)
                             + 2 * P * (N + 8))
    return max(state, scan)


def test_ssd_tensor_cores_keep_every_shape_the_passes_took():
    """Every shape the three passes took (multiples of 16, chunk <= 128,
    their blocks within an SM) has a tiling whose cluster block fits,
    so it stays on the tensor cores."""
    for chunk in range(16, 129, 16):
        for P in range(16, 1041, 16):
            for N in range(16, 1041, 16):
                if _passes_smem_bytes(P, N, chunk) <= build.MAX_SMEM_BYTES:
                    assert ssd_mod.route("bfloat16", P, N, chunk) == \
                        "tensor_core", (P, N, chunk)


def test_ssd_tensor_core_shared_memory_at_the_serving_shape():
    # the cluster block: cs (fp64), dt, exp(cs), w, 8 cs_end; x (Q x
    # P+8), C (Q x N+8), B or h_in's pair (max(Q, 2P) x N+8) in bf16; the
    # round's increments (P x N+8 fp32); the carry (P / C x N fp32)
    Q, P, N = 64, 64, 128
    base = (20 * Q + 32 + 2 * Q * (P + 8) + 2 * Q * (N + 8)
            + 2 * 2 * P * (N + 8) + 4 * P * (N + 8))
    assert ssd_mod.cluster_tiles(P, N, Q) == (P, N)
    assert ssd_mod.cluster_smem_bytes(P, N, Q, 8, False) == base == 97_568
    assert ssd_mod.cluster_smem_bytes(P, N, Q, 4, True) == \
        base + 4 * 16 * N
    assert ssd_mod.tc_smem_bytes(P, N, Q) == base + 4 * 8 * N
    assert ssd_mod.tc_smem_bytes(P, N, Q) <= build.MAX_SMEM_BYTES
    # tiled (N = 512 at a chunk of 16: two column tiles of 256): B keeps
    # its buffer and h_in's pair and the increments take a tile each
    Q, N, NB = 16, 512, 256
    assert ssd_mod.cluster_tiles(P, N, Q) == (P, NB)
    assert ssd_mod.cluster_smem_bytes(P, N, Q, 8, False) == (
        20 * Q + 32 + 2 * Q * (P + 8) + 2 * 2 * Q * (N + 8)
        + 2 * 2 * P * (NB + 8) + 4 * P * (NB + 8))


def test_bf16_cpu_tensors_take_the_plain_route_and_launch_nothing():
    """At shapes the tensor cores take, CPU tensors still compute the
    plain versions and count no launch on either route."""
    rng = np.random.default_rng(0)
    before = {n: (dict(s.launches_by_route), s.cpu_calls)
              for n, s in KERNEL_STATS.items()}
    q = torch.from_numpy(rng.standard_normal((1, 32, 4, 16),
                                             dtype=np.float32)).bfloat16()
    k = q[:, :, :1].contiguous()
    out = ops.flash_attention(q, k, k, block_q=16, block_kv=16)
    _close(out, ref.flash_attention_ref(q, k, k).float().numpy(),
           "bfloat16")
    arrays = _ssd_inputs(1, 1, 32, 2, 16, 1, 16)
    y, h = ops.ssd_scan(*_as("bfloat16", *arrays, lib="torch"), chunk=16)
    want_y, want_h = ref.ssd_scan_ref(*_as("bfloat16", *arrays, lib="torch"))
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    for name in ("flash_attention", "ssd_scan"):
        stats = KERNEL_STATS[name]
        assert stats.launches_by_route == before[name][0]
        assert stats.cpu_calls == before[name][1] + 1


def test_launch_counts_are_kept_by_route():
    stats = build.KernelStats()
    stats.launched(3, route="tensor_core")
    stats.launched()
    stats.launched(2, route="tensor_core")
    assert stats.launches_by_route == {"tensor_core": 5, "cuda_core": 1}
    assert stats.launches == 6
    stats.cpu_call()
    stats.reset()
    assert (stats.launches, stats.launches_by_route, stats.cpu_calls) == \
        (0, {}, 0)


def test_an_edited_header_renames_the_library(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build._lib_path("k")
    assert build._lib_path("k") == first
    (tmp_path / "h.cuh").write_text("// two\n")
    assert build._lib_path("k") != first


def test_the_real_header_enters_the_hash():
    assert (build.CSRC / "mma.cuh").is_file()
    assert build._lib_path("flash_attention").name.startswith(
        "libflash_attention-")


# --------------------------------------------------------------------- #
# the SSD tensor-core route's algebra, with its rounding points
# --------------------------------------------------------------------- #
def _pair(v):
    """v as the kernels carry it: hi = bf16(v), lo = bf16(v - hi)."""
    hi = v.bfloat16().float()
    return hi + (v - hi).bfloat16().float()


def _single(v):
    """v rounded once to bf16 (what the kernels do not do)."""
    return v.bfloat16().float()


def _ssd_chunk_terms(x, dt, a_log, B_in, C_in, *, chunk, carry=_pair):
    """What every chunk computes before the state passes between chunks:
    the fp64 cumsum of the fp32 dA, its end, and dS_c = (x o w)^T B with
    w_j = dt_j exp(cs_end - cs_j), x o w carried by ``carry``."""
    Bb, S, H, P = x.shape
    G, N = B_in.shape[2], B_in.shape[3]
    nc, Q = S // chunk, chunk
    A = -torch.exp(a_log.float())
    xf = x.float().reshape(Bb, nc, Q, H, P)
    dtc = dt.float().reshape(Bb, nc, Q, H)
    grp = torch.arange(H) // (H // G)            # B/C read per group
    Bc = B_in.float()[:, :, grp].reshape(Bb, nc, Q, H, N)
    Cc = C_in.float()[:, :, grp].reshape(Bb, nc, Q, H, N)
    # fp64 cumsum of the fp32 dA; the decays' differences in fp64
    cs = torch.cumsum((dtc * A).double(), 2)                  # (B,nc,Q,H)
    cs_end = cs[:, :, -1]
    w = torch.exp((cs_end[:, :, None] - cs).float()) * dtc
    dS = torch.einsum("bcqhp,bcqhn->bchpn", carry(xf * w[..., None]), Bc)
    return dict(xf=xf, dtc=dtc, Bc=Bc, Cc=Cc, cs=cs, cs_end=cs_end, dS=dS)


def _ssd_y(terms, h_in, x, *, carry=_pair):
    """y = (C B^T o L o dt) x + exp(cs) o (C h_in^T), h_in (B, nc, H, P,
    N) as the chunks receive it (``carry`` already applied)."""
    xf, dtc, Bc, Cc, cs = (terms[k] for k in ("xf", "dtc", "Bc", "Cc", "cs"))
    Bb, nc, Q, H, P = xf.shape
    scores = torch.einsum("bcihn,bcjhn->bchij", Cc, Bc)
    csh = cs.permute(0, 1, 3, 2)                              # (B,nc,H,Q)
    L = torch.exp((csh[..., :, None] - csh[..., None, :]).float())
    lower = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    M = torch.where(lower, scores * L * dtc.permute(0, 1, 3, 2)[..., None, :],
                    0.0)
    y = torch.einsum("bchij,bcjhp->bcihp", carry(M), xf)
    y = y + torch.einsum("bcihn,bchpn->bcihp", Cc, h_in) \
        * torch.exp(cs.float())[..., None]
    return y.reshape(Bb, nc * Q, H, P).to(x.dtype)


def _ssd_three_pass(x, dt, a_log, B_in, C_in, *, chunk, carry=_pair):
    """y (x's dtype) and the final state (fp32) by ``ssd_scan.cu``'s
    tensor-core passes, in PyTorch; ``carry`` rounds the three operands
    the kernels compute."""
    Bb, S, H, P = x.shape
    N = B_in.shape[3]
    t = _ssd_chunk_terms(x, dt, a_log, B_in, C_in, chunk=chunk, carry=carry)
    # pass 2: h_c = exp(cs_end,c) h_{c-1} + dS_c; h_in is the entering state
    h = torch.zeros(Bb, H, P, N)
    h_in = []
    for c in range(S // chunk):
        h_in.append(h)
        h = torch.exp(t["cs_end"][:, c].float())[..., None, None] * h \
            + t["dS"][:, c]
    h_in = carry(torch.stack(h_in, 1))                       # (B,nc,H,P,N)
    # pass 3: y = (C B^T o L o dt) x + exp(cs) o (C h_in^T)
    return _ssd_y(t, h_in, x, carry=carry), h


def _ssd_cluster_model(x, dt, a_log, B_in, C_in, *, chunk, plan,
                       carry=_pair):
    """y and the final state by ``ssd_cluster_kernel``'s schedule
    (``plan``: :func:`ssd_mod.cluster_plan`): per tile of the state, each
    rank walks its rows of the tile round by round over the round's chunks from the carry the
    previous round left it, writing the state entering each chunk (chunk
    0 enters with zeros), and the last round writes its rows of the final
    state; every chunk's own terms and y as in the three passes."""
    Bb, S, H, P = x.shape
    N, nc, C = B_in.shape[3], S // chunk, plan["cluster"]
    t = _ssd_chunk_terms(x, dt, a_log, B_in, C_in, chunk=chunk, carry=carry)
    h_in = torch.zeros(Bb, nc, H, P, N)
    final = torch.empty(Bb, H, P, N)
    col_tiles = sorted({ct for _, ct in plan["tiles"]})
    for lo, hi in (rows for rank in plan["rows"] for rows in rank):
        for a, z in col_tiles:
            hv = None
            for k in range(plan["rounds"]):
                for c in range(k * C, min(nc, (k + 1) * C)):
                    if c == 0:
                        hv = t["dS"][:, 0, :, lo:hi, a:z]
                        continue
                    h_in[:, c, :, lo:hi, a:z] = hv
                    hv = torch.exp(t["cs_end"][:, c].float())[
                        ..., None, None] * hv + t["dS"][:, c, :, lo:hi, a:z]
            final[:, :, lo:hi, a:z] = hv
    return _ssd_y(t, carry(h_in), x, carry=carry), final


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (1, 64, 2, 16, 1, 16, 16),
    (2, 128, 4, 16, 1, 32, 32),
    (1, 64, 4, 16, 2, 16, 16),      # grouped B/C, P = 16
    (2, 64, 4, 16, 1, 32, 64),      # one chunk (S = chunk)
    (1, 256, 24, 64, 1, 128, 64),   # mamba2-130m's widths
    (1, 256, 2, 80, 1, 32, 128),    # a chunk of 128, P = 80
    (1, 1024, 2, 16, 1, 16, 64),    # 16 chunks
])
def test_ssd_three_pass_algebra_matches_references(B, S, H, P, G, N, chunk):
    arrays = _ssd_inputs(B * 7 + S + P, B, S, H, P, G, N)
    tin = _as("bfloat16", *arrays, lib="torch")
    y, h = _ssd_three_pass(*tin, chunk=chunk)
    assert y.dtype == torch.bfloat16 and h.shape == (B, H, P, N)
    want_y, want_h = ref.ssd_scan_ref(*tin)
    # bf16's tolerance, on y and on the final state
    np.testing.assert_allclose(y.float().numpy(), want_y.float().numpy(),
                               **BF16_TOL)
    np.testing.assert_allclose(h.numpy(), want_h.numpy(), **BF16_TOL)
    jy = jops.ssd_scan(*_as("bfloat16", *arrays, lib="jax"), chunk=chunk)
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy, np.float32), **BF16_TOL)


def test_one_bf16_rounding_would_miss_the_tolerance():
    """Why the kernels carry x·w, the masked scores and h_in as bf16
    pairs: rounded once to bf16, y leaves bf16's tolerance at
    mamba2-130m's widths, while the pairs stay inside it."""
    B, S, H, P, G, N, chunk = 1, 256, 24, 64, 1, 128, 64
    tin = _as("bfloat16", *_ssd_inputs(B * 7 + S + P, B, S, H, P, G, N),
              lib="torch")
    want_y, _ = ref.ssd_scan_ref(*tin)
    limit = BF16_TOL["atol"] + BF16_TOL["rtol"] * want_y.float().abs()

    def worst(carry):
        y, _ = _ssd_three_pass(*tin, chunk=chunk, carry=carry)
        return float(((y.float() - want_y.float()).abs() / limit).max())

    assert worst(_pair) <= 1.0 < worst(_single)


# --------------------------------------------------------------------- #
# the SSD cluster kernel's schedule and its exchange
# --------------------------------------------------------------------- #
# an H100 SM's shared memory, and what each resident block reserves of it
SM_SMEM_BYTES, BLOCK_RESERVED_BYTES = 233_472, 1024
MAMBA2_130M = dict(H=24, P=64, N=128, chunk=64, S=512)

# the shapes the tensor cores take on the card (tests/test_torch_card.py's
# grid and chip_smoke.py's), and chunk counts of 5, 12 and 32
SSD_CLUSTER_SHAPES = [
    # B, S, H, P, N, chunk
    (1, 512, 24, 64, 128, 64), (2, 512, 24, 64, 128, 64),
    (4, 512, 24, 64, 128, 64),
    (2, 64, 4, 64, 128, 64),        # one chunk
    (8, 1024, 48, 64, 128, 64),     # 16 chunks
    (2, 2048, 24, 64, 128, 128),    # a chunk of 128
    (2, 256, 4, 80, 64, 64),        # P = 80
    (1, 512, 8, 64, 256, 64),       # N = 256
    (1, 256, 4, 64, 256, 128),      # N = 256 at a chunk of 128
    (1, 256, 4, 64, 272, 64),       # N past 256
    (3, 192, 6, 32, 48, 48),        # chunk 48
    (1, 320, 24, 64, 128, 64),      # 5 chunks
    (2, 768, 24, 64, 128, 64),      # 12 chunks
    (1, 2048, 24, 64, 128, 64),     # 32 chunks
    (2, 64, 4, 128, 16, 16),        # P = 128: two row tiles
    (2, 256, 4, 96, 16, 64),        # P = 96: two row tiles of 48
    (1, 64, 2, 64, 512, 16),        # N = 512: two column tiles
    (1, 512, 4, 256, 256, 64),      # 4 x 2 tiles
]


def _held(table):
    """A stand-in occupancy query: clusters held at once by size."""
    return lambda c, carry: table[c]


@pytest.mark.parametrize("cluster", [0, 1, 2, 4, 8])
@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_CLUSTER_SHAPES)
def test_ssd_cluster_schedule_covers_each_entering_state_once(
        B, S, H, P, N, chunk, cluster):
    """``ssd_cluster_kernel``'s schedule, as its loops walk it: rank r
    holds chunk k C + r in round k; per tile of the state (row tiles
    outer), each owned chunk pushes row p of the tile's increment to rank
    p / RP, slot r, row p % RP (RP: the tile's rows over C), and each rank
    reads back exactly the increments of its rows for the round's chunks;
    each rank then writes, thread by thread (4 columns each), the state
    entering every chunk of the round at its rows of the tile.  So every
    (chunk, row, column) entering state is produced exactly once, chunk 0
    never (it enters with zeros), and every element of the final state
    once."""
    nc = S // chunk
    plan = ssd_mod.cluster_plan(B, S, H, P, N, chunk, cluster=cluster)
    C, rounds = plan["cluster"], plan["rounds"]
    assert C in ssd_mod.CLUSTERS and P % C == 0
    assert C == (cluster or min(ssd_mod.CLUSTER, 1 << (nc - 1).bit_length()))
    assert rounds == -(-nc // C) and plan["carry"] == (rounds > 1)
    assert sorted(c for cs in plan["chunks"] for c in cs) == list(range(nc))
    rows, cols = ssd_mod.cluster_tiles(P, N, chunk)
    row_tiles = sorted({rt for rt, _ in plan["tiles"]})
    assert [ct for rt, ct in plan["tiles"] if rt == row_tiles[0]] == \
        [(lo, min(N, lo + cols)) for lo in range(0, N, cols)]
    assert row_tiles == [(lo, min(P, lo + rows)) for lo in range(0, P, rows)]
    entering = np.zeros((nc, P, N), np.int64)
    final = np.zeros((P, N), np.int64)
    for k in range(rounds):
        nv = min(C, nc - k * C)
        for r in range(C):                     # chunk of rank r this round
            owned = [c for c in plan["chunks"][r] if c // C == k]
            assert owned == ([k * C + r] if r < nv else [])
        for (plo, phi), (nlo, nhi) in plan["tiles"]:
            RP, per_row = (phi - plo) // C, (nhi - nlo) // 4
            in_ds = np.zeros((C, C, RP), np.int64)     # owner, slot, row
            for j in range(nv):
                for p in range(phi - plo):
                    in_ds[p // RP, j, p % RP] += 1
            for r in range(C):
                lo, hi = plan["rows"][r][row_tiles.index((plo, phi))]
                assert (lo, hi) == (plo + r * RP, plo + (r + 1) * RP)
                assert (in_ds[r, :nv] == 1).all() and \
                    (in_ds[r, nv:] == 0).all()
                for i in range(RP * per_row):         # the rank's threads
                    p, n = lo + i // per_row, nlo + 4 * (i % per_row)
                    for c in range(k * C + (k == 0), k * C + nv):
                        entering[c, p, n:n + 4] += 1
                    if k == rounds - 1:
                        final[p, n:n + 4] += 1
    assert (entering[0] == 0).all() and (entering[1:] == 1).all()
    assert (final == 1).all()


# clusters of 1 / 2 / 4 / 8 an H100 holds at once at mamba2-130m's widths
# (1 with its 32 KB carry: one block a SM); chip_smoke.py prints them
HELD_130M = {1: 132, 2: 132, 4: 62, 8: 30}


@pytest.mark.parametrize("B,S,H,want", [
    (1, 512, 24, 8),      # 24 clusters: one wave of one round
    (2, 512, 24, 4),      # 48: two waves of 8 or two rounds of 4
    (4, 512, 24, 2),      # 96: 4 waves x 1, 2 x 2 or 1 x 4
    (8, 1024, 48, 2),     # 384 over 16 chunks: 3 waves x 8 rounds
])
def test_ssd_cluster_size_takes_the_fewest_waves_times_rounds(B, S, H,
                                                              want):
    """At mamba2-130m's widths the size is the one with the fewest waves
    (clusters over those held at once) times rounds, the smaller on a
    tie; the rounds and the carry follow."""
    m = MAMBA2_130M
    plan = ssd_mod.cluster_plan(B, S, H, m["P"], m["N"], m["chunk"],
                                _held(HELD_130M))
    nc = S // m["chunk"]
    assert plan["cluster"] == want
    assert plan["rounds"] == nc // want and plan["carry"] == (want < nc)
    # without the occupancy query: the fewest rounds
    assert ssd_mod.cluster_plan(B, S, H, m["P"], m["N"],
                                m["chunk"])["cluster"] == min(8, nc)


def test_ssd_cluster_size_skips_sizes_whose_carry_does_not_fit():
    """N = 256 at a chunk of 128, 16 chunks: a cluster of 8 with its carry
    fits an SM, one of 4, 2 or 1 would not, so 8 it is however few the
    card holds; a single chunk takes a cluster of 1 and no carry; a card
    that holds no cluster of any size that fits is refused."""
    plan = ssd_mod.cluster_plan(4, 2048, 24, 64, 256, 128,
                                _held({8: 1, 4: 60, 2: 120, 1: 240}))
    assert (plan["cluster"], plan["rounds"], plan["carry"]) == (8, 2, True)
    assert plan["smem_bytes"] <= build.MAX_SMEM_BYTES
    for c in (1, 2, 4):
        assert ssd_mod.cluster_smem_bytes(64, 256, 128, c, True) > \
            build.MAX_SMEM_BYTES
    one = ssd_mod.cluster_plan(1, 128, 4, 64, 256, 128, _held({1: 1}))
    assert (one["cluster"], one["rounds"], one["carry"]) == (1, 1, False)
    with pytest.raises(ValueError, match="no cluster size fits"):
        ssd_mod.cluster_plan(1, 2048, 4, 64, 256, 128, _held({8: 0}))


@pytest.mark.parametrize("cluster", [2, 4, 8])
@pytest.mark.parametrize("carry", [False, True])
def test_ssd_cluster_block_leaves_two_blocks_an_sm_at_mamba2_130m(cluster,
                                                                  carry):
    """At mamba2-130m's serving widths every cluster size the rule can
    pick for B·24 clusters (2 to 8) leaves room for two blocks an SM,
    with or without the carry of several rounds."""
    m = MAMBA2_130M
    smem = ssd_mod.cluster_smem_bytes(m["P"], m["N"], m["chunk"], cluster,
                                      carry)
    assert 2 * (smem + BLOCK_RESERVED_BYTES) <= SM_SMEM_BYTES


@pytest.mark.parametrize("cluster", [0, 1, 2, 4, 8])
@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (1, 64, 2, 16, 1, 16, 16),
    (2, 128, 4, 16, 1, 32, 32),
    (1, 64, 4, 16, 2, 16, 16),      # grouped B/C
    (2, 64, 4, 16, 1, 32, 64),      # one chunk
    (1, 80, 2, 16, 1, 16, 16),      # 5 chunks
    (1, 192, 2, 16, 1, 16, 16),     # 12 chunks
    (1, 512, 2, 16, 1, 16, 16),     # 32 chunks
    (1, 256, 2, 80, 1, 32, 128),    # a chunk of 128, P = 80
    (1, 64, 2, 128, 1, 16, 16),     # P = 128: two row tiles
    (1, 64, 2, 16, 1, 512, 16),     # N = 512 at P = 16: one tile
    (1, 128, 2, 64, 1, 512, 32),    # two column tiles
])
def test_ssd_cluster_exchange_equals_the_three_passes(B, S, H, P, G, N,
                                                      chunk, cluster):
    """The sliced, round-by-round exchange gives the three passes' y and
    final state bit for bit (the same fp32 chain per element)."""
    tin = _as("bfloat16", *_ssd_inputs(B * 7 + S + P, B, S, H, P, G, N),
              lib="torch")
    plan = ssd_mod.cluster_plan(B, S, H, P, N, chunk, cluster=cluster)
    y, h = _ssd_cluster_model(*tin, chunk=chunk, plan=plan)
    want_y, want_h = _ssd_three_pass(*tin, chunk=chunk)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)


@pytest.mark.parametrize("B,cluster", [(1, 0), (2, 4), (4, 2)])
def test_ssd_cluster_exchange_meets_the_references_at_mamba2_130m(B,
                                                                  cluster):
    """At mamba2-130m's widths (S = 256 here: 4 chunks, so clusters of 4
    and 2 take 1 and 2 rounds), the exchange's y and final state against
    ``ref.ssd_scan_ref`` and the JAX package's ``ssd_scan`` (the Pallas
    kernel in interpret mode) at bf16's tolerance."""
    m = MAMBA2_130M
    S, chunk = 256, m["chunk"]
    arrays = _ssd_inputs(B * 7 + S + m["P"], B, S, m["H"], m["P"], 1,
                         m["N"])
    tin = _as("bfloat16", *arrays, lib="torch")
    plan = ssd_mod.cluster_plan(B, S, m["H"], m["P"], m["N"], chunk,
                                cluster=cluster)
    assert plan["rounds"] == (2 if cluster == 2 else 1)
    y, h = _ssd_cluster_model(*tin, chunk=chunk, plan=plan)
    want_y, want_h = ref.ssd_scan_ref(*tin)
    np.testing.assert_allclose(y.float().numpy(), want_y.float().numpy(),
                               **BF16_TOL)
    np.testing.assert_allclose(h.numpy(), want_h.numpy(), **BF16_TOL)
    jy = jops.ssd_scan(*_as("bfloat16", *arrays, lib="jax"), chunk=chunk)
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy, np.float32), **BF16_TOL)


# --------------------------------------------------------------------- #
# the flash tensor-core kernel's schedule and arithmetic
# --------------------------------------------------------------------- #
# the tensor-core kernels' query rows a warpgroup (wgmma's M): a block is
# two warpgroups on one such tile (flash_tc_kernel), or, at the head dims
# of PAIR_HEAD_DIMS, a pair of such tiles, one a warpgroup, sharing one
# K/V ring (flash_tc_pair_kernel)
TC_BLOCK_Q = 64
PAIR_HEAD_DIMS = (128, 160)


def _tc_stages(head_dim):
    """K/V stages of a ring: ``TcPair<D>::STAGES``, four at head dim 128
    and three at 160 (four do not fit beside its two Q buffers);
    ``kTcStages``, three, in each warpgroup's ring elsewhere."""
    return 4 if head_dim == 128 else 3


def _tc_block_rows(head_dim):
    """Query rows a block: 128 at the pair kernel's head dims, else 64."""
    return 2 * TC_BLOCK_Q if head_dim in PAIR_HEAD_DIMS else TC_BLOCK_Q


def _tc_block_kv(head_dim):
    """KV rows a tile: ``TcPair<D>::BKV``, 64, at head dims 128 and 160;
    ``TcTile<D>::BKV`` elsewhere: 64, and 32 at 256, where the two
    warpgroups' six 64-row stages would not fit an SM."""
    if head_dim in PAIR_HEAD_DIMS:
        return 64
    return 32 if head_dim > 128 else 64


def _tc_column_block(head_dim):
    """Columns of one TMA box (``W``): 32 at head dim 160 (five boxes,
    64-byte swizzled), else 64 where they divide D (two 128-byte swizzled
    boxes in the pair kernel at 128), else D (16, 32)."""
    if head_dim == 160:
        return 32
    return 64 if head_dim % 64 == 0 else head_dim


def _tc_pv_widths(head_dim):
    """The N of each P V ``wgmma`` a 16-key step: one over every column
    at the pair kernel's head dims (B spans the boxes, LBO a box apart),
    else one a column box."""
    if head_dim in PAIR_HEAD_DIMS:
        return [head_dim]
    W = _tc_column_block(head_dim)
    return [W] * (head_dim // W)


def _tc_smem_bytes(head_dim):
    """The block's shared memory (``SMEM``): alignment slack, the Q
    tiles, the K/V stages, the barriers (Q's and each stage's)."""
    q = _tc_block_rows(head_dim) * head_dim * 2
    stage = 2 * _tc_block_kv(head_dim) * head_dim * 2
    st = _tc_stages(head_dim)
    if head_dim in PAIR_HEAD_DIMS:
        # two query tiles' Q (one in use, the next landing), the ring, a
        # full and an empty barrier a Q buffer and a stage
        return 1024 + 2 * q + st * stage + 8 * (4 + 2 * st)
    return 1024 + q + 2 * st * stage + 8 * (1 + 2 * st)


@pytest.mark.parametrize("D", build.TENSOR_CORE_HEAD_DIMS)
def test_flash_tc_column_blocks_cover_every_column(D):
    """The column boxes of the tensor-core kernels tile the head dim: no
    column goes unloaded or unmultiplied (64-column boxes would leave 32
    of D = 160's columns over); each box's bytes are a TMA swizzle width
    (32, 64 or 128); the scores' 16-deep k-steps stay inside one box;
    every P V ``wgmma`` has a legal N (a multiple of 8 up to 256) and
    together they cover D once; and the block's shared memory fits the
    card, in the two-tile kernel with the merge of the two warpgroups'
    states inside the idle rings."""
    W = _tc_column_block(D)
    assert D % W == 0 and 2 * W in (32, 64, 128)
    cols = [nb * W + c for nb in range(D // W) for c in range(W)]
    assert cols == list(range(D))
    for kk in range(D // 16):
        assert (kk * 16) // W == (kk * 16 + 15) // W
    widths = _tc_pv_widths(D)
    assert all(n % 8 == 0 and 8 <= n <= 256 for n in widths)
    assert sum(widths) == D
    assert _tc_smem_bytes(D) <= build.MAX_SMEM_BYTES
    if D not in PAIR_HEAD_DIMS:
        merge = 16 * 128 * (D // 8 + 1)
        assert merge <= 2 * 3 * 2 * _tc_block_kv(D) * D * 2


def _tc_visible(r_lo, r_hi, sq, sk, bkv, causal, window):
    """The pair kernel's ``tc_visible``: the KV tiles query rows [r_lo,
    r_hi) see, as range(lo, hi); empty where no row is below sq."""
    r_hi = min(r_hi, sq)
    if r_lo >= r_hi:
        return range(0)
    n_tiles = -(-sk // bkv)
    hi = min(n_tiles, (r_hi - 1) // bkv + 1) if causal else n_tiles
    lo = (r_lo - window + 1) // bkv if window > 0 and r_lo - window + 1 > 0 \
        else 0
    return range(lo, max(lo, hi))


def _tc_tiles(sq, sk, causal, window, head_dim):
    """The tensor-core kernels' schedule, one entry a block in row order:
    its first row, the KV tiles through its ring in order, and for each
    warpgroup its rows and the tiles it computes on.  ``flash_tc_kernel``
    (64-row blocks): both groups own the block's rows and take alternate
    tiles (0, 1, 0, ...), merging at the end.  ``flash_tc_pair_kernel``
    (head dims 128 and 160, 128-row blocks): group g owns rows 64g..64g +
    63 and computes on the run of the ring's tiles its own rows see."""
    bkv, rows = _tc_block_kv(head_dim), _tc_block_rows(head_dim)
    blocks = []
    for q_lo in range(0, sq, rows):
        if head_dim in PAIR_HEAD_DIMS:
            ring = list(_tc_visible(q_lo, q_lo + rows, sq, sk, bkv, causal,
                                    window))
            groups = [(range(g_lo, min(sq, g_lo + TC_BLOCK_Q)),
                       list(_tc_visible(g_lo, g_lo + TC_BLOCK_Q, sq, sk, bkv,
                                        causal, window)))
                      for g_lo in (q_lo, q_lo + TC_BLOCK_Q)]
        else:
            n_tiles = -(-sk // bkv)
            hi = n_tiles
            if causal:
                hi = min(n_tiles, (q_lo + rows - 1) // bkv + 1)
            lo = 0
            if window > 0 and q_lo - window + 1 > 0:
                lo = (q_lo - window + 1) // bkv
            ring = list(range(lo, hi))
            own = range(q_lo, min(sq, q_lo + rows))
            groups = [(own, ring[g::2]) for g in (0, 1)]
        blocks.append({"q_lo": q_lo, "ring": ring, "groups": groups})
    return blocks


def _visible(q, k, causal, window):
    return (not causal or k <= q) and (window == 0 or k > q - window)


@pytest.mark.parametrize("D", [64, 128, 160, 256])  # KV tiles of 64 but 32
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 16, 100])
@pytest.mark.parametrize("S", [1, 33, 64, 100, 129, 257])
def test_flash_tc_schedule_covers_each_visible_pair_once(S, window, causal,
                                                          D):
    """Every (query, key) pair the masks leave visible lies in exactly one
    tile computed for its row; no tile through a ring is wholly masked
    for the block's rows.  The two-tile kernel's groups take alternate
    tiles of the ring; the pair kernel's groups each compute on a
    contiguous run of it (their union is the ring, so every loaded tile is
    read), none on a tile wholly masked for its own rows, and its blocks
    are 128 rows."""
    BKV = _tc_block_kv(D)
    blocks = _tc_tiles(S, S, causal, window, D)
    assert len(blocks) == -(-S // _tc_block_rows(D))
    for blk in blocks:
        ring = blk["ring"]
        assert ring == list(range(ring[0], ring[0] + len(ring)))  # once each
        for q in range(blk["q_lo"], min(S, blk["q_lo"] + _tc_block_rows(D))):
            mine = [kt for rows, kts in blk["groups"] if q in rows
                    for kt in kts]
            for k in range(S):
                if _visible(q, k, causal, window):
                    assert sum(kt * BKV <= k < kt * BKV + BKV
                               for kt in mine) == 1
        rows = range(blk["q_lo"], min(S, blk["q_lo"] + _tc_block_rows(D)))
        for kt in ring:                              # no tile wholly masked
            assert any(_visible(q, k, causal, window) for q in rows
                       for k in range(kt * BKV, min(S, kt * BKV + BKV)))
        if D not in PAIR_HEAD_DIMS:
            assert [g[1] for g in blk["groups"]] == [ring[0::2], ring[1::2]]
            continue
        assert set(kt for _, kts in blk["groups"] for kt in kts) == set(ring)
        for g_rows, kts in blk["groups"]:
            assert len(g_rows) <= TC_BLOCK_Q
            if kts:
                start = ring.index(kts[0])
                assert ring[start:start + len(kts)] == kts   # a run
            for kt in kts:
                assert any(_visible(q, k, causal, window) for q in g_rows
                           for k in range(kt * BKV, min(S, kt * BKV + BKV)))


H100_SMS = 132


def _tc_pair_items(sq, heads, batch, causal, sms=H100_SMS):
    """The pair kernel's persistent grid: G = min(items, sms) blocks, block
    i walking items i, 2G - 1 - i, 2G + i, 4G - 1 - i, ... (a zig-zag:
    after one of the heaviest, one of the lightest) while they exist;
    item z * heads * batch + b * heads + h is query tile z of (b, h), the
    last first under causal masking.  Returns each block's (query tile,
    b, h) in its order."""
    n_qt = -(-sq // 128)
    items = n_qt * heads * batch
    grid = min(items, sms)
    blocks = []
    for i in range(grid):
        walk = []
        for n in itertools.count():
            it = n * grid + (grid - 1 - i if n % 2 else i)
            if it >= items:
                break
            z, hb = divmod(it, heads * batch)
            walk.append((n_qt - 1 - z if causal else z, hb // heads,
                         hb % heads))
        blocks.append(walk)
    return blocks


def _ring_run(blks, rng, st):
    """One persistent block of the pair kernel (its query tiles ``blks``,
    from ``_tc_tiles``, in its order) under one random interleaving of its
    producer and two warpgroups, step by step as the kernel's code orders
    them.  The producer loads each query tile's Q into buffer n % 2 (from
    the third on, once both groups have stored the O of the tile two
    before from it) and then its KV tiles through the one ring, ring tile
    jg >= STAGES once both groups have released tile jg - STAGES (its
    stage's empty barrier, waited on by phase parity).  The groups take
    turns in rounds 0..n_vis of each query tile, group 0 first: group 1
    passes the block's first turn at its start, and after its last round
    of a query tile passes the next one's first turn (none after the
    block's last); in round r a group waits for tile r if it computes S_r
    (for Q too in its first round), waits for its turn, issues, passes,
    then releases tile r - 1; after its rounds it stores O and hands its Q
    buffer back.  Returns the tiles each group read in order and the
    order of the rounds' issues; raises on a deadlock, a wait that passes
    on the wrong tile or Q, or a load over a tile or Q still in use.
    ``st``: the ring's stages."""
    full, empty = [0] * st, [0] * st       # phases completed
    qfull, qempty = [0, 0], [0, 0]
    holds, qholds = [None] * st, [None, None]
    freed = {0: set(), 1: set()}
    qfreed = {0: set(), 1: set()}
    released, qreleased = [0] * st, [0, 0]
    passes = {0: 0, 1: 0}
    waits = {0: 0, 1: 0}
    read, issues = {0: [], 1: []}, []

    def run(g):
        ops = [("pass", None)] if g == 1 else []
        jg0 = 0
        for n, blk in enumerate(blks):
            ring = blk["ring"]
            n_vis = len(ring)
            kts = blk["groups"][g][1]
            a = ring.index(kts[0]) if kts else n_vis + 1
            e = a + len(kts)
            more = n + 1 < len(blks)
            for r in range(n_vis + 1):
                if r == a:
                    ops.append(("qfull", n))
                if a <= r < e:
                    ops.append(("wait", (jg0 + r, ring[r])))
                ops += [("turn", None), ("issue", (n, r))]
                if g == 0 or r < n_vis or more:
                    ops.append(("pass", None))
                if r > 0:
                    ops.append(("release", jg0 + r - 1))
            ops.append(("qempty", n))
            jg0 += n_vis
        return ops

    def produce():
        ops, jg = [], 0
        for n, blk in enumerate(blks):
            ops.append(("qload", n))
            for kt in blk["ring"]:
                ops.append(("load", (jg, kt)))
                jg += 1
        return ops
    progs = {0: run(0), 1: run(1), "p": produce()}
    pos = {k: 0 for k in progs}

    def ready(k):
        op, x = progs[k][pos[k]]
        if op == "wait":
            return full[x[0] % st] % 2 != (x[0] // st) % 2
        if op == "qfull":
            return qfull[x % 2] % 2 != (x // 2) % 2
        if op == "turn":
            return passes[1 - k] > waits[k]
        if op == "load" and x[0] >= st:
            return empty[x[0] % st] % 2 != (x[0] // st - 1) % 2
        if op == "qload" and x >= 2:
            return qempty[x % 2] % 2 != (x // 2 - 1) % 2
        return True

    while any(pos[k] < len(progs[k]) for k in progs):
        live = [k for k in progs if pos[k] < len(progs[k]) and ready(k)]
        assert live, "deadlock"
        k = live[rng.integers(len(live))]
        op, x = progs[k][pos[k]]
        pos[k] += 1
        if op == "load":
            s = x[0] % st
            if holds[s] is not None:
                assert holds[s] in freed[0] and holds[s] in freed[1]
            holds[s] = x[0]
            full[s] += 1
        elif op == "qload":
            if qholds[x % 2] is not None:
                assert qholds[x % 2] in qfreed[0] and qholds[x % 2] in qfreed[1]
            qholds[x % 2] = x
            qfull[x % 2] += 1
        elif op == "wait":
            assert holds[x[0] % st] == x[0]
            read[k].append(x[1])
        elif op == "qfull":
            assert qholds[x % 2] == x
        elif op == "turn":
            waits[k] += 1
        elif op == "issue":
            issues.append((k, x))
        elif op == "pass":
            passes[k] += 1
        elif op == "release":
            freed[k].add(x)
            released[x % st] += 1
            if released[x % st] == 2:
                released[x % st] = 0
                empty[x % st] += 1
        else:
            qfreed[k].add(x)
            qreleased[x % 2] += 1
            if qreleased[x % 2] == 2:
                qreleased[x % 2] = 0
                qempty[x % 2] += 1
    assert passes[0] == waits[1] and passes[1] == waits[0]
    return read, issues


@pytest.mark.parametrize("D", PAIR_HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 16, 100])
@pytest.mark.parametrize("S", [1, 64, 100, 129, 257, 1000])
def test_flash_tc_pair_ring_never_deadlocks(S, window, causal, D):
    """Under many random interleavings of the producer and the two
    warpgroups, a persistent block of the pair kernel walking several
    query tiles (S's tiles of 2 heads, few SMs, so a block holds up to 8)
    loads every tile of each query tile's ring and each Q once, never
    refills a stage or a Q buffer still in use, never lets a wait pass on
    the wrong tile or Q, hands each group exactly its runs, and the groups
    issue their products in alternate turns, group 0 first, every turn
    waited for passed once; with the ring's stages at each head dim."""
    rng = np.random.default_rng(S + window + D)
    tiles = _tc_tiles(S, S, causal, window, D)
    for walk in _tc_pair_items(S, 2, 1, causal, sms=3):
        blks = [tiles[qt] for qt, _, _ in walk]
        for _ in range(10):
            read, issues = _ring_run(blks, rng, _tc_stages(D))
            for g in (0, 1):
                assert read[g] == [kt for blk in blks
                                   for kt in blk["groups"][g][1]]
            assert issues == [(g, (n, r)) for n, blk in enumerate(blks)
                              for r in range(len(blk["ring"]) + 1)
                              for g in (0, 1)]


def _pair_probe():
    """``tools/flash_pair_probe.py`` as a module (it imports neither torch
    nor JAX at its top)."""
    path = Path(__file__).resolve().parents[1] / "tools" / \
        "flash_pair_probe.py"
    spec = importlib.util.spec_from_file_location("flash_pair_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("D", PAIR_HEAD_DIMS)
@pytest.mark.parametrize("variant", _pair_probe().VARIANTS)
def test_flash_pair_probe_variants_find_the_kernel(variant, D):
    """Each variant of the pair kernel's probe finds every anchor of its
    edits in the kernel's sources exactly once at both head dims (the
    probe follows the code), changes them (``base`` changes nothing), and
    a variant that sets one of ``TcPair``'s constants sets it at that head
    dim alone."""
    probe = _pair_probe()
    edits = probe.variants(D)[variant]
    texts = probe.edited(variant, edits, ROOT_SRC)
    assert (variant == "base") == (not edits)
    for rel, text in texts.items():
        assert text != (ROOT_SRC / rel).read_text()
    for name, const in (("stages", "STAGES"), ("box", "W"),
                        ("kv128", "BKV")):
        if variant.startswith(name):
            line = next(ln for ln in texts[probe.CU].splitlines()
                        if f"static constexpr int {const} = D == {D} ?"
                        in ln)
            assert ": (" in line


@pytest.mark.parametrize("S,heads,batch,causal", [
    (512, 32, 1, True), (512, 32, 4, True), (100, 8, 3, False),
    (1024, 32, 1, True), (2048, 32, 2, True)])
def test_flash_tc_pair_items_cover_each_query_tile_once(S, heads, batch,
                                                        causal):
    """The persistent grid has min(items, SMs) blocks; every (query tile,
    b, h) is walked by exactly one block; under causal masking each block
    walks its tiles heaviest first, the first wave holds the heaviest
    tiles of the launch, and no block's KV tiles exceed the average by
    more than a quarter of the heaviest query tile's (a round robin gave
    24 against an average of 17.5 at B = 1, S = 1024, and 144 against
    131.9 at B = 2, S = 2048; the zig-zag gives 18 and 136)."""
    blocks = _tc_pair_items(S, heads, batch, causal)
    n_qt = -(-S // 128)
    assert len(blocks) == min(n_qt * heads * batch, H100_SMS)
    walked = [it for walk in blocks for it in walk]
    assert sorted(walked) == sorted((qt, b, h) for qt in range(n_qt)
                                    for b in range(batch)
                                    for h in range(heads))
    if causal:
        for walk in blocks:
            assert [qt for qt, _, _ in walk] == sorted(
                (qt for qt, _, _ in walk), reverse=True)
        first = [walk[0][0] for walk in blocks]
        later = [qt for walk in blocks for qt, _, _ in walk[1:]]
        if later:
            assert min(first) >= max(later)
        loads = [sum(2 * qt + 2 for qt, _, _ in walk) for walk in blocks]
        heaviest = 2 * n_qt
        assert max(loads) <= max(sum(loads) / len(loads) + heaviest / 4,
                                 heaviest)


@pytest.mark.parametrize("B", [1, 4])
def test_flash_tc_pair_grid_at_stablelm_12b(B):
    """At stablelm-12b's prefill (S = 512, 32 heads): 128-row query
    tiles, so B = 1 is 128 of them, one a block in one wave of the H100's
    132 SMs, and B = 4 is 512 over 132 persistent blocks (3 or 4 each);
    under causal masking the heaviest tile (walked first) reads 8 KV tiles
    of 64 rows, its group 0 computing on 7 and group 1 on 8; and one
    block a SM fits (two 40 KB Q buffers, a ring of 3 stages of 40 KB)."""
    S, H, D = 512, 32, 160
    blocks = _tc_tiles(S, S, True, 0, D)
    assert len(blocks) * H * B == 128 * B
    walks = _tc_pair_items(S, H, B, True)
    assert len(walks) == min(128 * B, H100_SMS)
    assert sorted(len(w) for w in walks) == ([1] * 128 if B == 1 else
                                             [3] * 16 + [4] * 116)
    heaviest = blocks[-1]
    assert walks[0][0][0] == len(blocks) - 1
    assert len(heaviest["ring"]) == 8
    assert [len(kts) for _, kts in heaviest["groups"]] == [7, 8]
    assert _tc_smem_bytes(D) == 1024 + 2 * 40960 + 3 * 40960 + 8 * 10
    assert 2 * (_tc_smem_bytes(D) + 1024) > 228 * 1024


@pytest.mark.parametrize("B", [1, 4])
def test_flash_tc_pair_grid_at_llama3_8b(B):
    """At llama3-8b's and minitron-8b's prefill (S = 512, 32 heads on 8,
    head dim 128): 128-row query tiles, so B = 1 is 128 of them in one
    wave of the H100's 132 SMs and B = 4 is 512 over 132 persistent
    blocks (3 or 4 each); under causal masking the heaviest tile (walked
    first) reads 8 KV tiles of 64 rows, group 0 computing on 7 and group
    1 on 8; and the kept shared memory fits one block a SM and not two
    (two 32 KB Q buffers, a ring of 4 stages of 32 KB: 197,728 bytes of
    the 232,448 a block may have)."""
    S, H, D = 512, 32, 128
    blocks = _tc_tiles(S, S, True, 0, D)
    assert len(blocks) * H * B == 128 * B
    walks = _tc_pair_items(S, H, B, True)
    assert len(walks) == min(128 * B, H100_SMS)
    assert sum(len(w) for w in walks) == 128 * B
    assert sorted(len(w) for w in walks) == ([1] * 128 if B == 1 else
                                             [3] * 16 + [4] * 116)
    heaviest = blocks[-1]
    assert walks[0][0][0] == len(blocks) - 1
    assert len(heaviest["ring"]) == 8
    assert [len(kts) for _, kts in heaviest["groups"]] == [7, 8]
    assert _tc_stages(D) == 4
    assert _tc_smem_bytes(D) == 1024 + 2 * 32768 + 4 * 32768 + 8 * 12
    assert _tc_smem_bytes(D) == 197_728 <= build.MAX_SMEM_BYTES
    assert 2 * (_tc_smem_bytes(D) + 1024) > 228 * 1024


# the CUDA-core (fp32) kernel's query rows a tile, and the blocks (a
# cluster) that split each tile's KV tiles
CC_BLOCK_Q = 32
CC_SPLIT = 2


def _cc_block_kv(head_dim):
    """KV rows a tile of ``flash_fwd_kernel`` (``CcTile<T, D>::BKV``): 32,
    and 16 above head dim 128: at 256 two 32-row stages would not leave
    room for two blocks an SM, at 160 they measured slower."""
    return 16 if head_dim > 128 else 32


def _cc_lanes(head_dim):
    """``CcTile<T, D>``'s lane split of one warp's 8 rows: for the scores
    SD lanes across d (4 elements a load, DPL loads a row) and KG key
    groups; for P V, LPR lanes across a row of O, CPL columns each, where
    a lane's c-th column is ``col_of``'s (float4 runs LPR apart when CPL
    is a multiple of 4, else CPL adjacent columns)."""
    sd = min(head_dim // 4, 8)
    lpr = min(head_dim, 32)
    cpl = head_dim // lpr
    if cpl % 4 == 0:
        def col(lc, c):
            return 4 * (lc + lpr * (c // 4)) + c % 4
    else:
        def col(lc, c):
            return cpl * lc + c
    return {"SD": sd, "KG": 32 // sd, "DPL": head_dim // sd // 4,
            "LPR": lpr, "CPL": cpl, "col": col}


def _cc_smem_bytes(head_dim, elem):
    """``CcTile<T, D>::SMEM``: the Q tile, two stages of K (rows padded)
    and V, and each warp's P and its 16 floats."""
    bkv, kg = _cc_block_kv(head_dim), _cc_lanes(head_dim)["KG"]
    ks = head_dim + (32 if kg == 4 else 16) // elem
    p_floats = 8 * (bkv + 4) + 16
    return (elem * (CC_BLOCK_Q * head_dim + 2 * bkv * ks
                    + 2 * bkv * head_dim) + 4 * 4 * p_floats)


@pytest.mark.parametrize("D", build.HEAD_DIMS)
def test_flash_cc_lanes_cover_every_column_once(D):
    """Every element of d is summed by the scores' lanes (DPL loads of 4
    at SD lanes), every column of O is held by exactly one P V lane (CPL =
    5 at D = 160, whose float4 runs would reach past D), and two fp32
    blocks share an SM (each at most half of its 228 KB, less 1 KB
    reserved a block), so the fp32 model checks keep two blocks a SM."""
    lanes = _cc_lanes(D)
    assert lanes["DPL"] * lanes["SD"] * 4 == D
    held = sorted(lanes["col"](lc, c) for lc in range(lanes["LPR"])
                  for c in range(lanes["CPL"]))
    assert held == list(range(D))
    for elem in (4, 2):
        assert 2 * (_cc_smem_bytes(D, elem) + 1024) <= 228 * 1024


def _cc_blocks(sq, sk, causal, window, head_dim):
    """``flash_fwd_kernel``'s schedule: the 32-row query tiles in launch
    order (the last first under causal masking), each with the KV tiles
    its cluster loads, in order (those the causal and window masks leave
    partly visible), each with the block of the cluster that takes it (0,
    1, 0, ...)."""
    bkv = _cc_block_kv(head_dim)
    n_qt = -(-sq // CC_BLOCK_Q)
    n_tiles = -(-sk // bkv)
    blocks = []
    for z in range(n_qt):
        qt = n_qt - 1 - z if causal else z
        q_lo = qt * CC_BLOCK_Q
        hi = n_tiles
        if causal:
            hi = min(n_tiles, (q_lo + CC_BLOCK_Q - 1) // bkv + 1)
        lo = 0
        if window > 0 and q_lo - window + 1 > 0:
            lo = (q_lo - window + 1) // bkv
        blocks.append((qt, [(kt, (kt - lo) % CC_SPLIT)
                            for kt in range(lo, hi)]))
    return blocks


@pytest.mark.parametrize("D", [64, 160, 256])  # 32-, 16-, 16-row KV tiles
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 16, 100])
@pytest.mark.parametrize("S", [1, 33, 64, 100, 257])
def test_flash_cc_schedule_covers_each_visible_pair_once(S, window, causal,
                                                          D):
    """Every query tile is launched once, the last first under causal
    masking (without a window the heaviest first); every visible (query,
    key) pair lies in exactly one loaded KV tile of its query tile, no
    loaded tile is wholly masked, and the two blocks of a cluster take
    alternate tiles (so their shares differ by at most one)."""
    BQ, BKV = CC_BLOCK_Q, _cc_block_kv(D)
    blocks = _cc_blocks(S, S, causal, window, D)
    order = [qt for qt, _ in blocks]
    assert sorted(order) == list(range(-(-S // BQ)))
    if causal:
        assert order == sorted(order, reverse=True)
    if causal and not window:
        loads = [len(listed) for _, listed in blocks]
        assert loads == sorted(loads, reverse=True)
    for qt, listed in blocks:
        kts = [kt for kt, _ in listed]
        assert kts == sorted(set(kts))                 # each tile once
        assert [p for _, p in listed] == [i % CC_SPLIT
                                          for i in range(len(kts))]
        rows = range(qt * BQ, min(S, qt * BQ + BQ))
        for q in rows:
            for k in range(S):
                if _visible(q, k, causal, window):
                    assert sum(kt * BKV <= k < kt * BKV + BKV
                               for kt in kts) == 1
        for kt in kts:                                 # no tile wholly masked
            assert any(_visible(q, k, causal, window) for q in rows
                       for k in range(kt * BKV, min(S, kt * BKV + BKV)))


def test_flash_cc_schedule_at_gemma3_1b_model_check():
    """At gemma3-1b's fp32 model check (B = 1, S = 1024, 4 heads, causal)
    the CUDA-core grid has at least 128 blocks, and its heaviest block's
    chain (query rows x keys it loads) is at most half that of 64-row
    query tiles in one block (a quarter, with the KV tiles split over two
    blocks)."""
    S, H = 1024, 4
    blocks = _cc_blocks(S, S, True, 0, 256)
    assert len(blocks) * CC_SPLIT * H >= 128
    qt, listed = blocks[0]
    tiles = max(sum(p == part for _, p in listed)
                for part in range(CC_SPLIT))
    heaviest = tiles * CC_BLOCK_Q * _cc_block_kv(256)
    assert qt == S // CC_BLOCK_Q - 1 and heaviest == 64 * S // 4


def _flash_tc_model(q, k, v, *, causal, window):
    """(B, Sq, H, D) in q's dtype by the tensor-core kernels' arithmetic,
    in PyTorch, over ``_tc_tiles``' schedule: each warpgroup runs an
    online softmax in fp32 in the log2 domain over its tiles (masked
    scores at -0.7 FLT_MAX, so a tile wholly masked for a row before its
    first visible one is wiped by alpha = 0) with P rounded to bf16 before
    P V.  In the two-tile kernel both groups hold the block's 64 rows and
    their states are merged; in the pair kernel (head dims 128, 160) group g
    holds rows 64g..64g + 63 of the 128-row block and writes them alone
    (off the edge tiles it folds the scale into the exponent, one rounding
    fewer, and its 2^x is the hardware's approximation: differences far
    inside bf16's tolerance)."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    BQ, BKV = TC_BLOCK_Q, _tc_block_kv(D)
    pair = D in PAIR_HEAD_DIMS
    neg = torch.tensor(-0.7 * np.finfo(np.float32).max, dtype=torch.float32)
    scale_log2 = np.float32(1.0 / np.sqrt(D)) * np.float32(1.4426950408889634)
    grp = torch.arange(H) // (H // Hkv)
    kf = torch.zeros(B, -(-Sk // BKV) * BKV, H, D)
    vf = torch.zeros_like(kf)
    kf[:, :Sk] = k.float()[:, :, grp]
    vf[:, :Sk] = v.float()[:, :, grp]
    out = torch.zeros(B, Sq, H, D)
    for blk in _tc_tiles(Sq, Sk, causal, window, D):
        states = []
        for g, (_, kts) in enumerate(blk["groups"]):
            r_lo = blk["q_lo"] + (BQ * g if pair else 0)
            n = max(0, min(Sq, r_lo + BQ) - r_lo)
            rows = torch.arange(r_lo, r_lo + BQ)
            qf = torch.zeros(B, BQ, H, D)
            qf[:, :n] = q.float()[:, r_lo:r_lo + n]
            m = neg.expand(B, H, BQ).clone()
            l = torch.zeros(B, H, BQ)
            acc = torch.zeros(B, H, BQ, D)
            for kt in kts:
                keys = torch.arange(kt * BKV, kt * BKV + BKV)
                kk, vv = kf[:, kt * BKV:kt * BKV + BKV], vf[:, kt * BKV:
                                                            kt * BKV + BKV]
                x = torch.einsum("bqhd,bkhd->bhqk", qf, kk) * scale_log2
                keep = keys[None, :] < Sk
                if causal:
                    keep = keep & (keys[None, :] <= rows[:, None])
                if window:
                    keep = keep & (keys[None, :] > rows[:, None] - window)
                x = torch.where(keep, x, neg)
                m_new = torch.maximum(m, x.amax(-1))
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(x - m_new[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum(
                    "bhqk,bkhd->bhqd", p.bfloat16().float(), vv)
                m = m_new
            states.append((r_lo, n, m, l, acc))
        if pair:
            for r_lo, n, m, l, acc in states:
                o = acc / torch.clamp(l, min=1e-30)[..., None]
                out[:, r_lo:r_lo + n] = o.permute(0, 2, 1, 3)[:, :n]
            continue
        (r_lo, n, m0, l0, a0), (_, _, m1, l1, a1) = states
        mm = torch.maximum(m0, m1)
        w0, w1 = torch.exp2(m0 - mm), torch.exp2(m1 - mm)
        o = (a0 * w0[..., None] + a1 * w1[..., None]) / torch.clamp(
            l0 * w0 + l1 * w1, min=1e-30)[..., None]
        out[:, r_lo:r_lo + n] = o.permute(0, 2, 1, 3)[:, :n]
    return out.to(q.dtype)


@pytest.mark.parametrize("B,S,H,Hkv,D,window,jax_too", [
    (1, 96, 4, 2, 16, 48, True),     # the Pallas test's ragged GQA case
    (1, 130, 4, 1, 32, 0, True),     # one row past two query tiles
    (1, 200, 14, 2, 64, 0, False),   # a group of 7 (internvl2-1b)
    (2, 100, 2, 2, 64, 33, True),
    (1, 70, 2, 1, 128, 16, False),
    (1, 100, 4, 1, 256, 0, False),   # gemma3-1b's head dim
    (1, 100, 8, 2, 160, 0, True),    # stablelm-12b's head dim: a pair
])
def test_flash_tc_model_matches_references(B, S, H, Hkv, D, window,
                                           jax_too):
    arrays = [np.random.default_rng(S + D).standard_normal(sh).astype(
        np.float32) for sh in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D))]
    q, k, v = (torch.from_numpy(a).bfloat16() for a in arrays)
    got = _flash_tc_model(q, k, v, causal=True, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, H, D)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               **BF16_TOL)
    if jax_too:
        import jax.numpy as jnp
        jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrays)
        jo = jops.flash_attention(jq, jk, jv, causal=True, window=window,
                                  block_q=32, block_kv=32)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(jo, np.float32), **BF16_TOL)


@pytest.mark.parametrize("D", PAIR_HEAD_DIMS)
@pytest.mark.parametrize("H,Hkv", [(8, 2), (32, 8)])
@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("S", [100, 129, 200, 257])
def test_flash_tc_pair_model_matches_references(S, window, H, Hkv, D):
    """The pair kernel's arithmetic (head dims 128 and 160: 128-row
    blocks, a 64-row tile a warpgroup, 64-row KV tiles, no merge) against
    ``ref.flash_attention_ref`` and the JAX package's ``flash_attention``
    (the Pallas kernel in interpret mode) at bf16's tolerance, at lengths
    that end inside a group's tile (100, 200), one row into a block (129)
    and one row past two blocks (257), with GQA groups of 4."""
    arrays = [np.random.default_rng(S + H + window + D).standard_normal(
        sh).astype(np.float32)
        for sh in ((1, S, H, D), (1, S, Hkv, D), (1, S, Hkv, D))]
    q, k, v = (torch.from_numpy(a).bfloat16() for a in arrays)
    got = _flash_tc_model(q, k, v, causal=True, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == (1, S, H, D)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               **BF16_TOL)
    import jax.numpy as jnp
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrays)
    jo = jops.flash_attention(jq, jk, jv, causal=True, window=window,
                              block_q=32, block_kv=32)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jo, np.float32), **BF16_TOL)


def test_ssd_forced_cluster_needs_the_cluster_kernel():
    """A forced cluster size is refused before any launch where the cluster
    kernel does not run: fp32 forced onto the tensor cores, the CUDA
    cores, and sizes it does not launch (3, and 16)."""
    x = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16)
    dt = torch.zeros((1, 64, 2))
    a_log = torch.zeros(2)
    Bc = torch.zeros((1, 64, 1, 128), dtype=torch.bfloat16)
    cases = [((x.float(), dt, a_log, Bc.float(), Bc.float()),
              dict(chunk=64, force="tensor_core", cluster=8)),
             ((x, dt, a_log, Bc, Bc), dict(chunk=64, force="cuda_core",
                                           cluster=8)),
             ((x, dt, a_log, Bc, Bc), dict(chunk=64, cluster=3)),
             ((x, dt, a_log, Bc, Bc), dict(chunk=64, cluster=16))]
    before = dict(KERNEL_STATS["ssd_scan"].launches_by_route)
    for args, kw in cases:
        with pytest.raises(ValueError, match="cluster"):
            ssd_mod.launch(*args, **kw)
    assert KERNEL_STATS["ssd_scan"].launches_by_route == before
