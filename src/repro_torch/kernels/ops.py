"""Public wrappers for the port's kernels.

Ports of ``repro/kernels/ops.py``'s four wrappers with the same
signatures and observable semantics: ragged attention sequences are
zero-padded to the reference's block rule and the output is sliced
back; a non-causal call with unaligned shapes raises; the decode cache
is padded to a ``block_kv`` multiple; ``ssd_scan`` needs S to be a chunk
multiple; ``rglru_scan`` halves its blocks until they divide S and W.
Block sizes keep their meaning for padding and validation only: the
CUDA kernels choose their own tiles.  Two divergences: ``ssd_scan``
returns ``(y, final_state)`` where the reference returns y, and on a
card a causal flash call that the short route takes is not padded
(:func:`flash_pads`; same output bits, no copies).

Each call runs the CUDA kernel for tensors on a card and the kernel's
plain version for tensors on the CPU (see the kernel modules).
"""

from __future__ import annotations

import torch

from .decode_attention import decode_attention as _decode_attention
from .flash_attention import flash_attention as _flash_attention
from .flash_attention import route as _flash_route
from .rglru_scan import rglru_scan as _rglru_scan
from .ssd_scan import ssd_scan  # noqa: F401  (no padding to add)


def _pad_to(x, multiple: int, axis: int):
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x, n
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis), n


def flash_pads(device: str, dtype: str, causal: bool, sq: int, sk: int,
               head_dim: int) -> bool:
    """Whether :func:`flash_attention` pads a call's sequences to the
    reference's block rule: always, but for a causal call on a card whose
    shapes flash's short route takes.  That kernel masks rows and keys
    past the true lengths by position, and a masked key adds an exact
    zero in a slot order that does not depend on the length, so the
    unpadded call gives the padded call's bits without its copies.  The
    CPU keeps the reference's rule."""
    return not (device == "cuda" and causal
                and _flash_route(dtype, head_dim, sq, sk) == "short")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    block_q: int = 512, block_kv: int = 512):
    """Flash attention with automatic sequence padding.

    Padded KV positions are masked by causality (query padding rows are
    discarded); for non-causal use the kernel requires aligned shapes.
    Calls :func:`flash_pads` exempts go to the kernel as they are.
    """
    B, Sq, H, D = q.shape
    if not flash_pads(q.device.type, str(q.dtype).removeprefix("torch."),
                      causal, Sq, k.shape[1], D):
        return _flash_attention(q, k, v, causal=causal, window=window)
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


def rglru_scan(a, b, *, block_s: int = 128, block_w: int = 512):
    """RG-LRU linear recurrence h_t = a_t·h_{t-1} + b_t over (B, S, W)."""
    B, S, W = a.shape
    bs = min(block_s, S)
    bw = min(block_w, W)
    while S % bs:
        bs //= 2
    while W % bw:
        bw //= 2
    return _rglru_scan(a, b, block_s=max(1, bs), block_w=max(1, bw))
