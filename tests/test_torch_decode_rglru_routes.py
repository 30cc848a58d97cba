"""The port's redesigned decode_attention and rglru_scan.

* The decode route rule (pure Python, mirrored by the C entry): bf16 at
  both serving GQA groups takes the tensor cores, fp32, head dim 8 and
  groups above 16 the CUDA cores; the cache splits into one block per 64
  rows.  A forced route must be one the kernels have.  CPU tensors take
  the plain versions and launch nothing.
* Test-local PyTorch mirrors of the two new algorithms, run on the CPU:
  the decode split kernels (one 64-row split per block, one softmax over
  it, partials m / l / acc, with P rounded to bf16 before P·V on the
  tensor cores) and their combine (weights exp(m_s - max m) over the
  live splits), and the chunked RG-LRU scan (chunk products and end
  states, the carry folded over chunks, the rescan from each chunk's
  entering state, with separately rounded multiplies and adds).  Each is
  held against the JAX package's Pallas kernel (interpret mode, as
  ``tests/test_kernels.py`` runs it) and the port's plain version, at
  bf16's tolerance (atol = rtol = 2e-2) for the bf16 decode and fp32's
  (atol = rtol = 2e-5) for the fp32 decode at lm-tiny's shapes and for
  the scan.
* A mirror of the tensor-core route's one cluster launch (each rank's
  rows from ``rank_rows``, an online softmax over its tiles with P
  rounded to bf16, the ranks merged in rank order), held against the
  Pallas kernel and the plain version at bf16's tolerance, and the rank
  ranges, which cover each valid row once.
* The decode wrapper's contract with the C entry: the shared memory of
  the route it takes at the tensors' dtype; on the CUDA cores the splits,
  a workspace only past one split, and one launch a call (two with the
  combine); on the tensor cores the cluster size, no workspace and one
  launch.

The kernels themselves run only on a card (``tests/test_torch_kernels.py``,
``chip_smoke.py``).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import KERNEL_STATS, build, ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as decode_mod  # noqa: E402
from repro_torch.kernels import rglru_scan as rglru_mod  # noqa: E402

jax.config.update("jax_enable_x64", False)

BF16_TOL = dict(atol=2e-2, rtol=2e-2)   # tests/test_kernels.py's bf16
FP32_TOL = dict(atol=2e-5, rtol=2e-5)   # and its fp32
NEG_INF = -0.7 * float(np.finfo(np.float32).max)


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """Tiny CPU ops run far slower under an oversubscribed intra-op pool
    (several test workers share the host); the tests need one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else x, np.float32)


# --------------------------------------------------------------------- #
# route rules
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype,D,rep,want", [
    ("bfloat16", 256, 4, "tensor_core"),     # gemma3-1b
    ("bfloat16", 256, 16, "tensor_core"),    # recurrentgemma-9b
    ("bfloat16", 64, 1, "tensor_core"),
    ("bfloat16", 16, 2, "tensor_core"),
    ("bfloat16", 8, 4, "cuda_core"),         # below mma's depth of 16
    ("bfloat16", 256, 32, "cuda_core"),      # beyond mma's 16 rows
    ("bfloat16", 160, 4, "tensor_core"),     # stablelm-12b
    ("bfloat16", 128, 4, "tensor_core"),     # llama3-8b, minitron-8b
    ("float32", 160, 4, "cuda_core"),        # stablelm-12b's model check
    ("float32", 256, 4, "cuda_core"),        # TF32 misses fp32's 2e-5
    ("float32", 8, 1, "cuda_core"),
])
def test_decode_route_rule(dtype, D, rep, want):
    assert decode_mod.route(dtype, D, rep) == want


@pytest.mark.parametrize("S,want", [(512, 8), (1024, 16), (64, 1), (65, 2),
                                    (1, 1)])
def test_decode_splits_one_per_tile(S, want):
    assert decode_mod.num_splits(S) == want


def test_route_codes_name_each_kernels_two_routes():
    assert build.ROUTE_CODES == {"cuda_core": 1, "tensor_core": 2,
                                 "short": 3}
    assert build.ROUTE_BY_SHAPE == 0
    assert build.route_code("decode_attention", "") == 0
    assert build.route_code("decode_attention", "cuda_core") == 1
    assert build.route_code("decode_attention", "tensor_core") == 2
    assert build.route_code("flash_attention", "short") == 3


def _launch_args(mod):
    """CPU tensors of a small valid shape for ``mod.launch``: the forced
    route's name is checked before anything touches them."""
    x = torch.zeros((1, 64, 2, 16))
    if mod == "flash_attention":
        return (x, x, x), dict(causal=True, window=0)
    if mod == "decode_attention":
        return (x[:, :1], x, x, torch.full((1,), 64)), {}
    return (x, x[..., 0], torch.zeros(2), x, x), dict(chunk=16)


@pytest.mark.parametrize("bad", ["sequential", "chunked", "tensorcore"])
@pytest.mark.parametrize("mod", ["flash_attention", "decode_attention",
                                 "ssd_scan"])
def test_a_forced_route_must_be_one_the_kernel_has(mod, bad):
    """A mistyped or foreign route name raises before any launch, and
    no launch is counted."""
    import importlib
    module = importlib.import_module(f"repro_torch.kernels.{mod}")
    before = dict(KERNEL_STATS[mod].launches_by_route)
    args, kw = _launch_args(mod)
    with pytest.raises(ValueError, match=f"{mod}: no route '{bad}'"):
        module.launch(*args, force=bad, **kw)
    assert dict(KERNEL_STATS[mod].launches_by_route) == before


def test_cpu_tensors_take_the_plain_route_at_new_route_shapes():
    """At shapes the tensor-core decode and the chunked scan take, CPU
    tensors still compute the plain versions and launch nothing."""
    rng = np.random.default_rng(0)
    names = ("decode_attention", "rglru_scan")
    before = {n: (dict(KERNEL_STATS[n].launches_by_route),
                  KERNEL_STATS[n].cpu_calls) for n in names}
    q = torch.from_numpy(rng.standard_normal((1, 1, 16, 256))).bfloat16()
    kc = torch.from_numpy(rng.standard_normal((1, 128, 1, 256))).bfloat16()
    assert decode_mod.route("bfloat16", 256, 16) == "tensor_core"
    got = ops.decode_attention(q, kc, kc, torch.tensor([70]), block_kv=128)
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    a = torch.from_numpy(rng.uniform(0.1, 0.9, (1, 512, 16))).float()
    h = ops.rglru_scan(a, a)
    assert h.shape == a.shape and h.dtype == torch.float32
    for n in names:
        assert dict(KERNEL_STATS[n].launches_by_route) == before[n][0]
        assert KERNEL_STATS[n].cpu_calls == before[n][1] + 1


# --------------------------------------------------------------------- #
# decode: a mirror of the tensor-core split kernel and the combine
# --------------------------------------------------------------------- #
def decode_cc_lanes(D, elem):
    """``decode_kernel``'s lane layout (``csrc/decode_attention.cu``) at
    head dim D and ``elem`` bytes an element: 16-byte chunks of VEC
    elements, CH a row; LPK lanes a dot product (the largest power of two
    up to 32 that divides CH), each summing its CPL chunks lp, lp + LPK,
    ...; for P V key groups of PL lanes (the largest power of two dividing
    CH), each taking its PC chunks lp, lp + PL, ... one after the other,
    KG groups a 256-thread block, NP partial sums an output."""
    vec = 16 // elem
    ch = D // vec
    p2 = ch & -ch
    lpk = min(p2, 32)
    kg = 256 // p2
    return {"VEC": vec, "CH": ch, "LPK": lpk, "CPL": ch // lpk,
            "GPW": 32 // lpk, "PL": p2, "PC": ch // p2, "KG": kg,
            "NP": 8 if p2 < 32 else kg}


def decode_split_mirror(q, kc, vc, lengths, split=decode_mod.SPLIT_ROWS):
    """The split kernels and combine, in fp32 on the CPU.

    Per (row, KV head): each live split (start < length) scores its 64
    rows with the group's heads (fp32 sums), masks rows at or past the
    length with the finite -0.7·FLT_MAX, keeps m = its max, p = exp(s -
    m), l = sum p, and acc = p @ V, with p rounded to bf16 first for bf16
    tensors (the tensor-core kernel's P operand); the combine weighs each
    split by exp(m_s - max m), sums l and acc, and divides (l at least
    1e-30).  A row with no live split is 0.  The sums follow the
    CUDA-core kernel's lanes (:func:`decode_cc_lanes`): a score is the sum
    of its LPK lanes' partial dot products over their chunks, and each
    16-byte chunk of acc comes from the one lane that owns it, so a
    layout that left a chunk without a lane would leave it out here too.
    """
    B, _, H, D = q.shape
    S, Hkv = kc.shape[1], kc.shape[2]
    rep = H // Hkv
    scale = 1.0 / math.sqrt(D)
    lanes = decode_cc_lanes(D, q.element_size())
    vec = lanes["VEC"]

    def chunk(c):
        return list(range(c * vec, (c + 1) * vec))
    # the columns each scoring lane sums, and the P V lanes' chunks
    score_cols = [sum((chunk(lp + lanes["LPK"] * i)
                       for i in range(lanes["CPL"])), [])
                  for lp in range(lanes["LPK"])]
    pv_chunks = [lp + lanes["PL"] * i for lp in range(lanes["PL"])
                 for i in range(lanes["PC"])]
    out = torch.zeros((B, H, D), dtype=torch.float32)
    for b in range(B):
        length = min(int(lengths[b]), S)
        n_live = -(-length // split) if length > 0 else 0
        for hk in range(Hkv):
            qg = q[b, 0, hk * rep:(hk + 1) * rep].float()
            ms, ls, accs = [], [], []
            for sp in range(n_live):
                lo = sp * split
                hi = min(lo + split, length)
                k = kc[b, lo:hi, hk].float()
                v = vc[b, lo:hi, hk].float()
                s = sum(qg[:, cols] @ k[:, cols].T for cols in score_cols)
                s = torch.cat([s * scale, torch.full((rep, lo + split - hi),
                                                     NEG_INF)], 1)
                m = s.max(-1).values
                p = torch.exp(s - m[:, None])
                ls.append(p.sum(-1))
                ms.append(m)
                pr = p[:, :hi - lo].to(q.dtype).float()
                acc = torch.zeros((rep, D))
                for c in pv_chunks:
                    acc[:, chunk(c)] = pr @ v[:, chunk(c)]
                accs.append(acc)
            if not ms:
                continue
            m = torch.stack(ms)                          # (n_live, rep)
            w = torch.exp(m - m.max(0).values)
            l_tot = (torch.stack(ls) * w).sum(0).clamp_min(1e-30)
            acc = (torch.stack(accs) * w[..., None]).sum(0)
            out[b, hk * rep:(hk + 1) * rep] = acc / l_tot[:, None]
    return out.to(q.dtype)[:, None]


def _decode_inputs(seed, B, S, H, Hkv, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, 1, H, D), (B, S, Hkv, D), (B, S, Hkv, D))]


DECODE_MIRROR_CASES = [
    # B, S, H, Hkv, D, lengths
    (3, 256, 4, 1, 64, (1, 150, 256)),       # ragged, a row of length 1
    (2, 256, 8, 2, 32, (64, 128)),           # ends on a split boundary
    (2, 192, 2, 1, 16, (65, 191)),           # one split + 1 row
    (2, 1024, 4, 1, 256, (520, 1024)),       # gemma3-1b's group
    (2, 1024, 16, 1, 256, (1, 520)),         # recurrentgemma-9b's group
]


@pytest.mark.parametrize("B,S,H,Hkv,D,lens", DECODE_MIRROR_CASES)
def test_decode_split_mirror_matches_pallas_and_plain(B, S, H, Hkv, D, lens):
    q, kc, vc = _decode_inputs(B * 7 + S + H, B, S, H, Hkv, D)
    lengths = np.asarray(lens, np.int32)
    qt, kt, vt = (torch.from_numpy(x).bfloat16() for x in (q, kc, vc))
    got = decode_split_mirror(qt, kt, vt, torch.from_numpy(lengths))
    plain = ref.decode_attention_ref(qt, kt, vt, torch.from_numpy(lengths))
    np.testing.assert_allclose(_np(got), _np(plain), **BF16_TOL)
    want = jops.decode_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(kc, jnp.bfloat16),
        jnp.asarray(vc, jnp.bfloat16), jnp.asarray(lengths),
        block_kv=min(512, S))
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **BF16_TOL)


LM_TINY_MIRROR_CASES = [
    # lm-tiny's decode on the CUDA-core route: fp32, 2 heads on 1, a
    # 64-slot cache (one split), head dim 16 and its rungs' 8
    (8, 64, 2, 1, 16, (64, 17, 40, 1, 64, 63, 24, 33)),
    (4, 64, 2, 1, 8, (64, 17, 1, 50)),
    # past one split: the combine; a group of 32 (the route's row blocks)
    (2, 256, 2, 1, 16, (65, 256)),
    (2, 256, 32, 1, 64, (130, 256)),
    # stablelm-12b's head dim 160 (40 chunks: 8 lanes of 5), 4 heads on 1
    # and 8 on 2, past one split and within one
    (2, 256, 8, 2, 160, (65, 256)),
    (3, 192, 4, 1, 160, (1, 64, 191)),
]


@pytest.mark.parametrize("B,S,H,Hkv,D,lens", LM_TINY_MIRROR_CASES)
def test_decode_split_mirror_fp32_matches_pallas_and_plain(B, S, H, Hkv, D,
                                                           lens):
    """The split and combine algebra of the CUDA-core route in fp32 (one
    softmax per 64-row split, no rounding of P) against the JAX package's
    Pallas kernel and the plain version, at fp32's tolerance."""
    q, kc, vc = _decode_inputs(B * 5 + S + H, B, S, H, Hkv, D)
    lengths = np.asarray(lens, np.int32)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, kc, vc))
    got = decode_split_mirror(tq, tk, tv, torch.from_numpy(lengths))
    assert got.dtype == torch.float32
    plain = ref.decode_attention_ref(tq, tk, tv, torch.from_numpy(lengths))
    np.testing.assert_allclose(_np(got), _np(plain), **FP32_TOL)
    want = jops.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                 jnp.asarray(vc), jnp.asarray(lengths),
                                 block_kv=min(64, S))
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **FP32_TOL)


@pytest.mark.parametrize("B,S,H,Hkv,D,lens", [
    (3, 64, 2, 1, 16, (0, 1, 64)),           # lm-tiny's shape
    (3, 256, 4, 1, 64, (0, 65, 256)),        # past one split
])
def test_decode_rows_of_length_zero_are_zero(B, S, H, Hkv, D, lens):
    """A row with no valid position is 0 from the JAX package's Pallas
    kernel and from the split algebra of the card's kernels; the plain
    versions average V there instead, so the card's checks hold such
    rows to 0.  The other rows agree at fp32's tolerance."""
    q, kc, vc = _decode_inputs(B * 3 + S + H, B, S, H, Hkv, D)
    lengths = np.asarray(lens, np.int32)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, kc, vc))
    got = _np(decode_split_mirror(tq, tk, tv, torch.from_numpy(lengths)))
    want = np.asarray(jops.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(lengths), block_kv=min(64, S)), np.float32)
    plain = _np(ref.decode_attention_ref(tq, tk, tv,
                                         torch.from_numpy(lengths)))
    empty = lengths == 0
    assert not got[empty].any() and not want[empty].any()
    assert np.abs(plain[empty]).max() > 0.01
    np.testing.assert_allclose(got, want, **FP32_TOL)
    np.testing.assert_allclose(got[~empty], plain[~empty], **FP32_TOL)


class _FakeDecodeLib:
    """Stands in for the built library: records the C entry's arguments."""

    def __init__(self):
        self.smem_args, self.calls = [], []

    def decode_attention_smem_bytes(self, *args):
        self.smem_args.append(args)
        return 0

    def decode_attention_fwd(self, *args):
        self.calls.append(args)
        return 0

    def decode_attention_max_active_clusters(self, D, S, cluster):
        return 15                   # D = 256's answer for clusters of 8


@pytest.mark.parametrize("dtype,S,H,D,taken,kernels", [
    ("float32", 64, 2, 16, "cuda_core", 1),      # lm-tiny: one split
    ("float32", 1024, 4, 256, "cuda_core", 2),   # split + combine
    ("bfloat16", 1024, 4, 256, "tensor_core", 1),  # one cluster launch
    ("bfloat16", 128, 32, 64, "cuda_core", 2),   # a group above 16
])
def test_decode_wrapper_sizes_each_route_by_dtype(monkeypatch, dtype, S, H,
                                                  D, taken, kernels):
    """The wrapper asks the library for the shared memory of the route it
    takes at the tensors' dtype.  On the CUDA cores it hands the library
    ceil(S / 64) splits and a workspace only past one split, and counts
    the split kernel (and the combine); on the tensor cores the cluster
    size and no workspace, and counts one kernel.  Each call is counted
    by its shape."""
    lib = _FakeDecodeLib()

    class _Stream:
        cuda_stream = 0
    monkeypatch.setattr(build, "library", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    caches = (decode_mod._smem_bytes, decode_mod._max_clusters,
              decode_mod._cluster_for)
    for cache in caches:
        cache.cache_clear()
    B, Hkv = 2, 1
    q = torch.zeros((B, 1, H, D), dtype=getattr(torch, dtype))
    kc = torch.zeros((B, S, Hkv, D), dtype=q.dtype)
    stats = KERNEL_STATS["decode_attention"]
    before = stats.launches_by_route.get(taken, 0)
    assert decode_mod.route(dtype, D, H // Hkv) == taken
    decode_mod.launch(q, kc, kc, torch.full((B,), S))
    for cache in caches:
        cache.cache_clear()
    assert lib.smem_args == [(H // Hkv, D, build.DTYPE_CODES[dtype],
                              build.ROUTE_CODES[taken])]
    args = lib.calls[-1]
    if taken == "tensor_core":
        assert args[5] is None
        assert args[6:12] == (decode_mod.CLUSTER, B, S, H, Hkv, D)
    else:
        n_split = decode_mod.num_splits(S)
        assert (args[5] is None) == (n_split == 1)
        assert args[6:12] == (n_split, B, S, H, Hkv, D)
    assert stats.launches_by_route[taken] - before == kernels
    assert stats.calls_by_shape[(dtype, B, S, H, Hkv, D)] >= 1


@pytest.mark.parametrize("D", build.HEAD_DIMS)
@pytest.mark.parametrize("elem", [4, 2])
def test_decode_cc_lanes_split_every_chunk_evenly(D, elem):
    """The CUDA-core kernel's lane layout at every head dim it is built
    for, in fp32 and bf16, as its static asserts require: the scoring
    lanes hold every chunk of a row once (at D = 160, min(CH, 32) lanes
    would give fp32's 40 chunks 32 lanes of one chunk and drop 8), the
    lanes of a dot product and of a key group meet within a warp or fill
    whole warps, the key groups tile the 256 threads, and P V's partial
    sums fit over the 64-row K tile."""
    lanes = decode_cc_lanes(D, elem)
    ch, lpk, pl = lanes["CH"], lanes["LPK"], lanes["PL"]
    held = sorted(lp + lpk * i for lp in range(lpk)
                  for i in range(lanes["CPL"]))
    assert held == list(range(ch))
    assert sorted(lp + pl * i for lp in range(pl)
                  for i in range(lanes["PC"])) == list(range(ch))
    assert 32 % lpk == 0 and lanes["GPW"] * lpk == 32
    assert 256 % pl == 0 and (32 % pl == 0 or pl % 32 == 0)
    assert lanes["KG"] * pl == 256
    assert lanes["NP"] * 4 * D * 4 <= 64 * D * elem
    if D == 160:
        assert (lanes["LPK"], lanes["CPL"]) == ((8, 5) if elem == 4
                                                else (4, 5))


def test_decode_split_mirror_gives_zero_for_an_empty_row():
    """A row of length 0 is 0, as the TPU kernel gives it (the plain
    versions of both packages average V there, so the Pallas kernel is
    the reference)."""
    B, S, H, Hkv, D = 2, 128, 4, 1, 32
    q, kc, vc = _decode_inputs(3, B, S, H, Hkv, D)
    lengths = np.asarray([0, 37], np.int32)
    got = decode_split_mirror(*(torch.from_numpy(x).bfloat16()
                                for x in (q, kc, vc)),
                              torch.from_numpy(lengths))
    want = jops.decode_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(kc, jnp.bfloat16),
        jnp.asarray(vc, jnp.bfloat16), jnp.asarray(lengths), block_kv=64)
    assert not np.asarray(want, np.float32)[0].any()
    assert not _np(got)[0].any()
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **BF16_TOL)


# --------------------------------------------------------------------- #
# decode: a mirror of the tensor-core route's one cluster launch
# --------------------------------------------------------------------- #
def decode_cluster_mirror(q, kc, vc, lengths, cluster):
    """The cluster kernel's algebra, in fp32 on the CPU.

    Per (row, KV head): rank r of the cluster takes the rows
    ``rank_rows`` gives it, in tiles of ``tile_rows(S)``, with an online
    softmax over its tiles (fp32 scores, running max m, p = exp(s - m)
    with P rounded to q's dtype before P V, l the sum of the unrounded
    p); a rank with no rows keeps m = -0.7·FLT_MAX, l = 0, acc = 0.  The
    ranks merge in rank order with weights exp(m_r - max m), the sum of l
    clamped at 1e-30, so a row of length 0 is 0.
    """
    B, _, H, D = q.shape
    S, Hkv = kc.shape[1], kc.shape[2]
    rep = H // Hkv
    scale = 1.0 / math.sqrt(D)
    tile = decode_mod.tile_rows(S, cluster)
    out = torch.zeros((B, H, D), dtype=torch.float32)
    for b in range(B):
        ranges = decode_mod.rank_rows(int(lengths[b]), S, cluster)
        for hk in range(Hkv):
            qg = q[b, 0, hk * rep:(hk + 1) * rep].float()
            ms, ls, accs = [], [], []
            for lo, hi in ranges:
                m = torch.full((rep,), NEG_INF)
                l = torch.zeros(rep)
                acc = torch.zeros((rep, D))
                for t0 in range(lo, hi, tile):
                    t1 = min(t0 + tile, hi)
                    s = qg @ kc[b, t0:t1, hk].float().T * scale
                    m_new = torch.maximum(m, s.max(-1).values)
                    alpha = torch.exp(m - m_new)
                    p = torch.exp(s - m_new[:, None])
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[:, None] + (
                        p.to(q.dtype).float() @ vc[b, t0:t1, hk].float())
                    m = m_new
                ms.append(m)
                ls.append(l)
                accs.append(acc)
            m_all = torch.stack(ms)                      # (cluster, rep)
            w = torch.exp(m_all - m_all.max(0).values)
            l_tot = torch.zeros(rep)
            acc = torch.zeros((rep, D))
            for r in range(cluster):                     # rank order
                l_tot = l_tot + ls[r] * w[r]
                acc = acc + accs[r] * w[r][:, None]
            out[b, hk * rep:(hk + 1) * rep] = acc / l_tot.clamp_min(
                1e-30)[:, None]
    return out.to(q.dtype)[:, None]


DECODE_CLUSTER_CASES = [
    # B, S, H, Hkv, D, lengths (0, 1, below the cluster size, 520, S),
    # cluster size
    (5, 1024, 7, 1, 256, (0, 1, 5, 520, 1024), 8),   # a group of 7
    (5, 1024, 16, 1, 16, (0, 1, 5, 520, 1024), 8),   # a group of 16
    (2, 4096, 1, 1, 16, (4096, 2100), 8),            # several tiles a rank
    (1, 4096, 16, 1, 256, (3001,), 16),
    (2, 512, 14, 2, 64, (333, 512), 4),              # two KV heads
    (2, 1024, 16, 16, 64, (520, 9), 2),
    (3, 256, 4, 1, 32, (0, 200, 256), 1),            # one block
    # stablelm-12b's head dim 160: 10 slabs over 8 warps, 10 columns a
    # rank at a cluster of 16
    (5, 1024, 8, 2, 160, (0, 1, 5, 100, 1024), 16),
    (2, 4096, 4, 1, 160, (4096, 2100), 8),
    (2, 512, 4, 1, 160, (333, 512), 2),
]


@pytest.mark.parametrize("B,S,H,Hkv,D,lens,cluster", DECODE_CLUSTER_CASES)
def test_decode_cluster_mirror_matches_pallas_and_plain(B, S, H, Hkv, D,
                                                        lens, cluster):
    """The one-launch algebra against the JAX package's Pallas kernel
    (interpret mode; a row of length 0 is 0 there too) and, on rows with
    a valid position, the plain version, at bf16's tolerance."""
    q, kc, vc = _decode_inputs(B * 11 + S + H + D, B, S, H, Hkv, D)
    lengths = np.asarray(lens, np.int32)
    qt, kt, vt = (torch.from_numpy(x).bfloat16() for x in (q, kc, vc))
    got = _np(decode_cluster_mirror(qt, kt, vt, torch.from_numpy(lengths),
                                    cluster))
    want = np.asarray(jops.decode_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(kc, jnp.bfloat16),
        jnp.asarray(vc, jnp.bfloat16), jnp.asarray(lengths),
        block_kv=min(512, S)), np.float32)
    np.testing.assert_allclose(got, want, **BF16_TOL)
    empty = lengths == 0
    assert not got[empty].any()
    plain = _np(ref.decode_attention_ref(qt, kt, vt,
                                         torch.from_numpy(lengths)))
    np.testing.assert_allclose(got[~empty], plain[~empty], **BF16_TOL)


# clusters the card holds at once (the occupancy query's answers on an
# H100 at S = 1024: D = 256 one 150 KB block a SM, D = 64 three)
OCCUPANCY = {256: {1: 132, 2: 66, 4: 30, 8: 15, 16: 14},
             64: {1: 396, 2: 198, 4: 92, 8: 45, 16: 21},
             16: {1: 396, 2: 198, 4: 92, 8: 45, 16: 21}}


@pytest.mark.parametrize("pairs,S,D,want", [
    (4, 1024, 256, 8),        # gemma3-1b at B = 4: the portable 8
    (1, 1024, 256, 8),
    (8, 1024, 64, 8),         # internvl2-1b at B = 4 (2 KV heads)
    (16, 1024, 64, 8),        # seamless-m4t-medium at B = 1
    (64, 1024, 64, 4),        # and at B = 4: 45 clusters of 8 fit
    (16, 1024, 256, 4),       # 15 clusters of 8 fit at D = 256
    (2, 4096, 256, 16),       # 8 ranks would loop over tiles
    (1, 4096, 16, 8),         # at most D / 2
    (1000, 1024, 256, 1),     # more than fit at any size
])
def test_decode_cluster_size_rule(pairs, S, D, want):
    assert decode_mod.cluster_size(
        pairs, S, D, lambda c: OCCUPANCY[D][c]) == want


@pytest.mark.parametrize("cluster", decode_mod.CLUSTERS)
@pytest.mark.parametrize("S", [1, 16, 64, 100, 512, 1024, 4096])
def test_decode_rank_rows_cover_each_valid_row_once(S, cluster):
    """For every length 0..S (and one past S, clamped): the ranks' rows,
    in rank order, are [0, length) exactly, each rank's range starts on a
    16-row piece, and none holds more rows than ``tile_rows`` allows a
    tile times the tiles it loops over; the ranks' loads stay within the
    valid rows."""
    tile = decode_mod.tile_rows(S, cluster)
    assert tile % 16 == 0 and 16 <= tile <= decode_mod.TC_MAX_TILE
    for length in range(S + 2):
        n = min(length, S)
        ranges = decode_mod.rank_rows(length, S, cluster)
        assert len(ranges) == cluster
        rows = [i for lo, hi in ranges for i in range(lo, hi)]
        assert rows == list(range(n))                    # once, in order
        pieces = -(-n // 16)
        for lo, hi in ranges:
            assert 0 <= lo <= hi <= n and lo % 16 == 0
            assert hi - lo <= 16 * -(-pieces // cluster)
        if n:
            busiest = max(hi - lo for lo, hi in ranges)
            assert busiest <= tile or S > decode_mod.TC_MAX_TILE * cluster


# --------------------------------------------------------------------- #
# RG-LRU: a mirror of the chunked scan
# --------------------------------------------------------------------- #
def rglru_chunked_mirror(a, b, chunk=rglru_mod.CHUNK_STEPS, chunks=8):
    """The chunked kernel's arithmetic on fp32 CPU tensors.

    Groups of ``chunks`` chunks of ``chunk`` steps, padded past S with
    a = 1, b = 0.  Pass 1 scans each chunk from 0 for its end state e and
    keeps its product A; the carry folds (A, e) over the group's chunks
    in order from the state entering the group, giving each chunk's
    entering state; pass 2 rescans each chunk from it.  Every update is a
    multiply, then an add, each rounded to fp32.
    """
    B, S, W = a.shape
    G = chunk * chunks
    pad = -S % G
    a = torch.cat([a.float(), torch.ones((B, pad, W))], 1)
    b = torch.cat([b.float(), torch.zeros((B, pad, W))], 1)
    out = torch.empty_like(a)
    carry = torch.zeros((B, W))
    for g0 in range(0, S + pad, G):
        ag = a[:, g0:g0 + G].reshape(B, chunks, chunk, W)
        bg = b[:, g0:g0 + G].reshape(B, chunks, chunk, W)
        e = torch.zeros((B, chunks, W))
        prod = torch.ones((B, chunks, W))
        for u in range(chunk):                              # pass 1
            e = ag[:, :, u] * e + bg[:, :, u]
            prod = prod * ag[:, :, u]
        h_in, h = [], carry
        for j in range(chunks):                             # carry
            h_in.append(h)
            h = prod[:, j] * h + e[:, j]
        carry = h
        h = torch.stack(h_in, 1)
        og = out[:, g0:g0 + G].view(B, chunks, chunk, W)
        for u in range(chunk):                              # pass 2
            h = ag[:, :, u] * h + bg[:, :, u]
            og[:, :, u] = h
    return out[:, :S]


def _gate(rng, shape):
    """a in (0, 1), mostly 0.8-1 with a tail toward 0: Griffin's gates
    start with a^c in [0.9, 0.999], so a chunk's product stays large and
    the carry across chunks and groups matters."""
    return (rng.uniform(0.0, 1.0, shape) ** 0.05).astype(np.float32)


RGLRU_MIRROR_CASES = [
    (1, 1, 16), (2, 7, 48), (1, 64, 16), (2, 64, 48), (2, 97, 48),
    (1, 97, 4096), (2, 512, 16), (1, 512, 4096),
]


@pytest.mark.parametrize("B,S,W", RGLRU_MIRROR_CASES)
def test_rglru_chunked_mirror_matches_pallas_and_plain(B, S, W):
    rng = np.random.default_rng(B * 100 + S + W)
    a = _gate(rng, (B, S, W))
    b = rng.standard_normal((B, S, W)).astype(np.float32)
    got = rglru_chunked_mirror(torch.from_numpy(a), torch.from_numpy(b))
    plain, final = ref.rglru_scan_ref(torch.from_numpy(a),
                                      torch.from_numpy(b))
    np.testing.assert_allclose(_np(got), _np(plain), **FP32_TOL)
    np.testing.assert_allclose(_np(got[:, -1]), _np(final), **FP32_TOL)
    want = jops.rglru_scan(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **FP32_TOL)


def test_rglru_chunked_mirror_is_sequential_within_one_chunk():
    """With S inside the first chunk the mirror is the sequential
    recurrence bit for bit: only the entering states are reassociated."""
    rng = np.random.default_rng(5)
    S = rglru_mod.CHUNK_STEPS
    a = torch.from_numpy(_gate(rng, (2, S, 48)))
    b = torch.from_numpy(rng.standard_normal((2, S, 48)).astype(np.float32))
    assert torch.equal(rglru_chunked_mirror(a, b),
                       ref.rglru_scan_ref(a, b)[0])


def test_ssd_plain_version_evaluates_fp64_inputs_in_fp64():
    """``chip_smoke.py`` holds the fp32 SSD kernel against the sequential
    recurrence in fp64; fp32 and bf16 inputs still compute in fp32."""
    rng = np.random.default_rng(1)
    B, S, H, P, G, N = 1, 32, 2, 8, 1, 16
    x = torch.from_numpy(rng.standard_normal((B, S, H, P)))
    dt = torch.nn.functional.softplus(
        torch.from_numpy(rng.standard_normal((B, S, H))))
    a_log = torch.log(torch.linspace(1.0, 4.0, H, dtype=torch.float64))
    B_in = torch.from_numpy(rng.standard_normal((B, S, G, N)))
    C_in = torch.from_numpy(rng.standard_normal((B, S, G, N)))
    y64, h64 = ref.ssd_scan_ref(x, dt, a_log, B_in, C_in)
    assert y64.dtype == h64.dtype == torch.float64
    y32, h32 = ref.ssd_scan_ref(x.float(), dt.float(), a_log.float(),
                                B_in.float(), C_in.float())
    assert y32.dtype == h32.dtype == torch.float32
    np.testing.assert_allclose(_np(y32), _np(y64), **FP32_TOL)
    np.testing.assert_allclose(_np(h32), _np(h64), **FP32_TOL)
    yb, hb = ref.ssd_scan_ref(x.bfloat16(), dt.float(), a_log.float(),
                              B_in.bfloat16(), C_in.bfloat16())
    assert yb.dtype == torch.bfloat16 and hb.dtype == torch.float32
