"""Flash-decode (one query token vs a KV cache): CUDA kernel and wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py``
(``decode_attention``, body ``_decode_kernel``, ``_validate``).  The
kernel is ``csrc/decode_attention.cu`` (built for sm_90a by
:mod:`.build`); its source note says what bounds it on an H100 and how
the design answers.

``_validate`` raises the reference's ``ValueError`` messages.  For a
CUDA tensor the wrapper then launches the kernel or raises; for a CPU
tensor it computes the plain version, :func:`.ref.decode_attention_ref`.
``stats`` counts both.
"""

from __future__ import annotations

import math

import torch

from . import build
from .ref import decode_attention_ref

TARGET_BLOCKS = 264               # two blocks per SM on an H100
MIN_SPLIT_ROWS = 64               # two 32-row tiles

stats = build.KernelStats()


def num_splits(B: int, S: int, Hkv: int) -> int:
    """How many blocks share one (batch row, KV head)'s cache length.

    Enough splits for about two blocks per SM of an H100 (132 SMs), but
    no split shorter than two 32-row tiles, so the combine pass stays
    small.  Decided from shapes only: the valid lengths live on the card.
    """
    return max(1, min(-(-S // MIN_SPLIT_ROWS),
                      -(-TARGET_BLOCKS // (B * Hkv))))


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
    B, _, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    dev = q.device
    if dev.type != "cuda" or k_cache.device != dev or v_cache.device != dev:
        raise ValueError(f"decode_attention: q and caches must share one "
                         f"CUDA device, got {dev}, {k_cache.device}, "
                         f"{v_cache.device}")
    dtype = _dtype_name(q.dtype)
    if dtype not in build.DTYPE_CODES or v_cache.dtype != q.dtype:
        raise ValueError(f"decode_attention: q and caches must be float32 "
                         f"or bfloat16, got {q.dtype}, {v_cache.dtype}")
    if D not in build.HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {D} has no CUDA "
                         f"kernel; supported: {build.HEAD_DIMS}")
    lib = build.library("decode_attention")
    if lib.decode_attention_smem_bytes(H // Hkv, D) > build.MAX_SMEM_BYTES:
        raise ValueError(f"decode_attention: a GQA group of {H // Hkv} "
                         f"heads at D={D} does not fit one block")
    q, k_cache, v_cache = q.contiguous(), k_cache.contiguous(), \
        v_cache.contiguous()
    lengths = lengths.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    n_split = num_splits(B, S, Hkv)
    ws = (torch.empty((B, Hkv, n_split, H // Hkv, D + 2),
                      dtype=torch.float32, device=dev)
          if n_split > 1 else None)
    err = lib.decode_attention_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None, n_split, B, S, H, Hkv, D,
        1.0 / math.sqrt(D), build.DTYPE_CODES[dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    build.check("decode_attention", err)
    # the split kernel, then (n_split > 1) the combine kernel
    stats.launched(2 if n_split > 1 else 1)
    return out
