"""Public wrappers for the port's attention kernels.

Ports of ``repro/kernels/ops.py``'s ``flash_attention`` and
``decode_attention`` with the same signatures and observable semantics:
ragged sequences are zero-padded to the reference's block rule and the
output is sliced back; a non-causal call with unaligned shapes raises;
the decode cache is padded to a ``block_kv`` multiple.  ``block_q`` and
``block_kv`` keep their meaning for padding and validation only: the
CUDA kernels choose their own tiles.

Each call runs the CUDA kernel for tensors on a card and the kernel's
plain version for tensors on the CPU (see the kernel modules).
"""

from __future__ import annotations

import torch

from .decode_attention import decode_attention as _decode_attention
from .flash_attention import flash_attention as _flash_attention


def _pad_to(x, multiple: int, axis: int):
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x, n
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis), n


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    block_q: int = 512, block_kv: int = 512):
    """Flash attention with automatic sequence padding.

    Padded KV positions are masked by causality (query padding rows are
    discarded); for non-causal use the kernel requires aligned shapes.
    """
    B, Sq, H, D = q.shape
    bq = min(block_q, max(16, 1 << (Sq - 1).bit_length() if Sq < block_q else block_q))
    bkv = min(block_kv, max(16, 1 << (k.shape[1] - 1).bit_length()
                            if k.shape[1] < block_kv else block_kv))
    qp, sq = _pad_to(q, bq, 1)
    kp, sk = _pad_to(k, bkv, 1)
    vp, _ = _pad_to(v, bkv, 1)
    if not causal and (qp.shape[1] != Sq or kp.shape[1] != k.shape[1]):
        raise ValueError("non-causal flash_attention requires aligned shapes")
    out = _flash_attention(qp, kp, vp, causal=causal, window=window)
    return out[:, :sq]


def decode_attention(q, k_cache, v_cache, lengths, *, block_kv: int = 512):
    """Flash-decode against a KV cache with per-batch valid lengths."""
    S = k_cache.shape[1]
    bkv = min(block_kv, S)
    kp, _ = _pad_to(k_cache, bkv, 1)
    vp, _ = _pad_to(v_cache, bkv, 1)
    return _decode_attention(q, kp, vp, lengths, block_kv=bkv)
