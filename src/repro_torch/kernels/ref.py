"""Plain PyTorch versions of the port's attention kernels.

Ports of ``repro/kernels/ref.py``'s two attention oracles.  They are the
plain versions the kernel wrappers compute for tensors on the CPU, the
ground truth ``chip_smoke.py`` holds each CUDA kernel against on the
card, and what the CPU tests compare with the reference.  (The SSD and
RG-LRU oracles come with the slices that port those models.)
"""

from __future__ import annotations

import math

import torch

from ..models.common import naive_attention


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """Oracle for kernels.flash_attention. q: (B, Sq, H, D); k/v: (B, Sk, Hkv, D)."""
    return naive_attention(q, k, v, causal=causal, window=window)


def decode_attention_ref(q, k_cache, v_cache, lengths):
    """Oracle for kernels.decode_attention.

    q: (B, 1, H, D); caches: (B, S, Hkv, D); lengths: (B,) valid kv counts.
    """
    B, _, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    rep = H // Hkv
    k = torch.repeat_interleave(k_cache, rep, dim=2)
    v = torch.repeat_interleave(v_cache, rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(D)
    valid = (torch.arange(S, device=q.device)[None, None, None, :]
             < lengths.to(q.device)[:, None, None, None])
    s = torch.where(valid, s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return out.to(q.dtype)
