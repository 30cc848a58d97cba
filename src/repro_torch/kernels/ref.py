"""Plain PyTorch versions of the port's kernels.

Ports of ``repro/kernels/ref.py``'s oracles: the two attention oracles,
the sequential SSD recurrence, the model's chunked SSD and the
sequential RG-LRU recurrence.  They are the plain versions the kernel
wrappers compute for tensors on the CPU, the ground truth
``chip_smoke.py`` holds each CUDA kernel against on the card, and what
the CPU tests compare with the reference.
"""

from __future__ import annotations

import math

import torch

from ..models.common import naive_attention
from ..models.ssm import ssd_chunked as _ssd_chunked


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


def ssd_scan_ref(x, dt, a_log, B_in, C_in, *, chunk: int = 64):
    """Oracle for kernels.ssd_scan (sequential recurrence, not chunked).

    x: (B, S, H, P); dt: (B, S, H) fp32; a_log: (H,); B_in/C_in:
    (B, S, G, N).  Returns y (B, S, H, P) in x's dtype and the final
    state h (B, H, P, N), both computed in fp32 (in fp64 for fp64
    inputs: ``chip_smoke.py`` holds the fp32 kernel against that).
    ``chunk`` is unused, as in the reference.
    """
    Bb, S, H, P = x.shape
    G, N = B_in.shape[2], B_in.shape[3]
    ft = torch.promote_types(x.dtype, torch.float32)
    A = -torch.exp(a_log.to(ft))
    Bh = torch.repeat_interleave(B_in, H // G, dim=2).to(ft)    # (B,S,H,N)
    Ch = torch.repeat_interleave(C_in, H // G, dim=2).to(ft)
    xf, dt = x.to(ft), dt.to(ft)
    h = torch.zeros((Bb, H, P, N), dtype=ft, device=x.device)
    ys = []
    for t in range(S):
        da = torch.exp(dt[:, t] * A)                             # (B,H)
        h = h * da[..., None, None] + (dt[:, t, :, None, None]
                                       * xf[:, t, ..., None]
                                       * Bh[:, t, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    return torch.stack(ys, 1).to(x.dtype), h


def ssd_chunked_ref(x, dt, a_log, B_in, C_in, *, chunk: int = 64):
    """The model's chunked SSD (itself validated against ssd_scan_ref)."""
    return _ssd_chunked(x, dt, a_log, B_in, C_in, chunk=chunk)


def rglru_scan_ref(a, b, *, init_h=None):
    """Oracle for kernels.rglru_scan: h_t = a_t·h_{t-1} + b_t, sequential.

    a/b: (B, S, W) → (h_all (B, S, W), h_final (B, W)), both fp32.
    """
    B, S, W = a.shape
    h = (torch.zeros((B, W), dtype=torch.float32, device=a.device)
         if init_h is None else init_h.float())
    a, b = a.float(), b.float()
    hs = []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, 1), h
