"""Flash-decode (one query token vs a KV cache): CUDA kernels and wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py``
(``decode_attention``, body ``_decode_kernel``, ``_validate``).  The
kernels are ``csrc/decode_attention.cu`` (built for sm_90a by
:mod:`.build`); its source note says what bounds them on an H100 and how
the design answers.

The library has two routes for the split kernel, chosen by dtype, head
dim and GQA group before the launch (:func:`route`): bf16 with a head
dim of 16..256 and at most 16 query heads per KV head runs the
tensor-core kernel (``mma.sync``), everything else the CUDA-core kernel.
Both split the cache into :data:`SPLIT_ROWS`-row pieces and share one
combine kernel.  :func:`decode_attention` always lets the shape decide;
:func:`launch` can force a route, which only ``chip_smoke.py`` and the
card tests do, to time and check both kernels on the same inputs.

``_validate`` raises the reference's ``ValueError`` messages.  For a
CUDA tensor the wrapper then launches the kernels or raises; for a CPU
tensor it computes the plain version, :func:`.ref.decode_attention_ref`.
``stats`` counts both, launches by route.
"""

from __future__ import annotations

import functools
import math

import torch

from . import build
from .ref import decode_attention_ref

SPLIT_ROWS = 64                   # cache rows per split (one tile)
TC_MAX_GROUP = 16                 # query heads per KV head: mma's 16 rows

stats = build.KernelStats()


def num_splits(S: int) -> int:
    """How many blocks share one (batch row, KV head)'s cache: one per
    :data:`SPLIT_ROWS` rows, so a block's chain is one tile.  Decided from
    the shape only (the valid lengths live on the card); splits past a
    row's length exit at once and the combine skips them."""
    return max(1, -(-S // SPLIT_ROWS))


def route(dtype: str, head_dim: int, rep: int) -> str:
    """The route the C entry takes by shape: ``"tensor_core"`` for bf16
    with a head dim mma can take and a GQA group of at most 16 heads
    (mma's 16 rows), else ``"cuda_core"`` (fp32 needs more than TF32's
    precision; head dim 8 is below mma's depth of 16)."""
    if (dtype == "bfloat16" and head_dim in build.TENSOR_CORE_HEAD_DIMS
            and 1 <= rep <= TC_MAX_GROUP):
        return "tensor_core"
    return "cuda_core"


@functools.lru_cache(maxsize=None)
def _smem_bytes(rep: int, D: int, taken: str) -> int:
    """Shared memory of one split block, asked of the library once per
    (group, head dim, route)."""
    return build.library("decode_attention").decode_attention_smem_bytes(
        rep, D, build.ROUTE_CODES[taken])


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _validate(q, k_cache, v_cache, lengths, block_kv: int) -> None:
    """Shape/dtype checks with the reference's actionable errors."""
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(
            f"decode_attention: q must be (B, 1, H, D), got {tuple(q.shape)}")
    if k_cache.ndim != 4 or v_cache.ndim != 4:
        raise ValueError(
            "decode_attention: caches must be (B, S, Hkv, D), got "
            f"k={tuple(k_cache.shape)} v={tuple(v_cache.shape)}")
    if k_cache.shape != v_cache.shape:
        raise ValueError(
            f"decode_attention: k/v cache shapes differ: "
            f"{tuple(k_cache.shape)} vs {tuple(v_cache.shape)}")
    B, _, H, D = q.shape
    Bk, S, Hkv, Dk = k_cache.shape
    if Bk != B:
        raise ValueError(
            f"decode_attention: batch mismatch: q has B={B}, cache has "
            f"B={Bk}")
    if Dk != D:
        raise ValueError(
            f"decode_attention: head dim mismatch: q has D={D}, cache has "
            f"D={Dk}")
    if Hkv > H or H % Hkv != 0:
        raise ValueError(
            f"decode_attention: q heads H={H} must be a multiple of cache "
            f"kv heads Hkv={Hkv} (GQA groups)")
    if q.dtype != k_cache.dtype:
        raise ValueError(
            f"decode_attention: dtype mismatch: q is {_dtype_name(q.dtype)}, "
            f"cache is {_dtype_name(k_cache.dtype)}")
    bkv = min(block_kv, S)
    if S % bkv != 0:
        raise ValueError(
            f"decode_attention: cache length S={S} must be a multiple of "
            f"block_kv={bkv}; pad the cache (ops.decode_attention does "
            "this automatically)")
    if tuple(lengths.shape) != (B,):
        raise ValueError(
            f"decode_attention: lengths must be ({B},), got "
            f"{tuple(lengths.shape)}")


def decode_attention(q, k_cache, v_cache, lengths, *, block_kv: int = 512):
    """q: (B, 1, H, D); caches: (B, S, Hkv, D); lengths: (B,) int.

    Returns (B, 1, H, D).  Cache positions >= lengths[b] are masked.
    ``block_kv`` is the reference's tile; it sets only the validation
    rule, not the CUDA tile.
    """
    _validate(q, k_cache, v_cache, lengths, block_kv)
    if q.device.type == "cpu":
        stats.cpu_call()
        return decode_attention_ref(q, k_cache, v_cache, lengths)
    dev = q.device
    if dev.type != "cuda" or k_cache.device != dev or v_cache.device != dev:
        raise ValueError(f"decode_attention: q and caches must share one "
                         f"CUDA device, got {dev}, {k_cache.device}, "
                         f"{v_cache.device}")
    dtype = _dtype_name(q.dtype)
    if dtype not in build.DTYPE_CODES or v_cache.dtype != q.dtype:
        raise ValueError(f"decode_attention: q and caches must be float32 "
                         f"or bfloat16, got {q.dtype}, {v_cache.dtype}")
    D = q.shape[3]
    if D not in build.HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {D} has no CUDA "
                         f"kernel; supported: {build.HEAD_DIMS}")
    return launch(q, k_cache, v_cache, lengths)


def launch(q, k_cache, v_cache, lengths, *, force: str = ""):
    """Launch the CUDA kernels on checked CUDA tensors.  ``force`` ``""``
    lets the shape decide (:func:`route`); ``"cuda_core"`` or
    ``"tensor_core"`` forces the split kernel's route, and one that
    cannot take the shape raises."""
    build.refuse_grad("decode_attention", q, k_cache, v_cache)
    code = build.route_code("decode_attention", force)
    B, _, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    rep = H // Hkv
    dev = q.device
    dtype = _dtype_name(q.dtype)
    taken = force or route(dtype, D, rep)
    if _smem_bytes(rep, D, taken) > build.MAX_SMEM_BYTES:
        raise ValueError(f"decode_attention: a GQA group of {rep} heads at "
                         f"D={D} does not fit one block")
    q, k_cache, v_cache = build.aligned(q), build.aligned(k_cache), \
        build.aligned(v_cache)
    lengths = lengths.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    n_split = num_splits(S)
    ws = (torch.empty((B, Hkv, n_split, rep, D + 2), dtype=torch.float32,
                      device=dev)
          if n_split > 1 else None)
    err = build.library("decode_attention").decode_attention_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None, n_split, B, S, H, Hkv, D,
        1.0 / math.sqrt(D), build.DTYPE_CODES[dtype], code,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check("decode_attention", err)
    # the split kernel, then (n_split > 1) the combine kernel
    stats.launched(2 if n_split > 1 else 1, route=taken)
    return out
