"""Shared model components in PyTorch: norms, RoPE, MLPs, attention.

A port of ``repro/models/common.py``.  Layouts are the reference's
(activations (B, S, d), heads (B, S, H, D), weights stored as the
reference stores them), so parameters bridged from the reference
(:mod:`repro_torch.models.convert`) drop in unchanged and the tests
compare like with like.  Attention keeps the reference's finite mask
constant and its casting points: scores and softmax in fp32, the
probabilities cast to the value dtype before the PV product.

Initializers draw from a ``torch.Generator`` on the target device; they
do not reproduce JAX's random bits (the parity tests bridge the
reference's weights instead).
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -0.7 * float(np.finfo(np.float32).max)


# ----------------------------------------------------------------------- #
# initializers
# ----------------------------------------------------------------------- #
def dense_init(gen: torch.Generator, shape, in_axis=0,
               dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal fan-in init (LeCun-style), drawn in fp32."""
    fan_in = shape[in_axis] if isinstance(in_axis, int) else int(
        np.prod([shape[a] for a in in_axis]))
    std = 1.0 / math.sqrt(max(1, fan_in))
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(std).to(dtype)     # in place: one fp32 copy of a leaf


def embed_init(gen: torch.Generator, shape,
               dtype=torch.float32) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    t.normal_(generator=gen)
    return t.mul_(0.02).to(dtype)


# ----------------------------------------------------------------------- #
# norms
# ----------------------------------------------------------------------- #
def rms_norm(x, weight, eps: float):
    """x * rsqrt(mean(x²) + eps) * (1 + weight), in fp32."""
    dtype = x.dtype
    out = F.rms_norm(x.float(), (x.shape[-1],), eps=eps)
    return (out * (1.0 + weight.float())).to(dtype)


def layer_norm(x, weight, bias, eps: float):
    dtype = x.dtype
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(dtype)


def init_norm(d: int, kind: str, device=None):
    if kind == "rmsnorm":
        return {"scale": torch.zeros((d,), dtype=torch.float32,
                                     device=device)}
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def apply_norm(params, x, kind: str, eps: float):
    if kind == "rmsnorm":
        return rms_norm(x, params["scale"], eps)
    return layer_norm(x, params["scale"], params["bias"], eps)


# ----------------------------------------------------------------------- #
# rotary position embeddings
# ----------------------------------------------------------------------- #
@functools.lru_cache(maxsize=64)
def rope_frequencies(head_dim: int, theta: float, rope_pct: float = 1.0,
                     device=None) -> Tuple[int, torch.Tensor]:
    """Number of rotated dims (even) and their inverse frequencies.

    Cached per (head_dim, theta, rope_pct, device): every layer of every
    step asks for the same few tables, and computing one costs four
    kernel launches on a card.  Callers must not write to the tensor.
    """
    rot = int(head_dim * rope_pct)
    rot -= rot % 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return rot, 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float, rope_pct: float = 1.0):
    """x: (..., S, H, D) or (..., S, D); positions: (..., S)."""
    rot, inv = rope_frequencies(x.shape[-1], theta, rope_pct, x.device)
    if rot == 0:
        return x
    angles = positions[..., :, None].float() * inv      # (..., S, rot/2)
    if x.dim() == angles.dim() + 1:       # (..., S, H, D): broadcast heads
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., ::2], x_rot[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rotated = torch.stack([r1, r2], dim=-1).reshape(x_rot.shape)
    return torch.cat([rotated.to(x.dtype), x_pass], dim=-1)


# ----------------------------------------------------------------------- #
# MLPs
# ----------------------------------------------------------------------- #
_ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "relu2": lambda x: torch.square(F.relu(x)),
}


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, *, gated: bool,
             dtype):
    p = {"down": dense_init(gen, (d_ff, d_model), dtype=dtype)}
    if gated:
        p["gate"] = dense_init(gen, (d_model, d_ff), dtype=dtype)
    p["up"] = dense_init(gen, (d_model, d_ff), dtype=dtype)
    return p


def apply_mlp(params, x, act: str, *, gated: bool):
    fn = _ACTS[act]
    if gated:
        h = fn(x @ params["gate"]) * (x @ params["up"])
    else:
        h = fn(x @ params["up"])
    return h @ params["down"]


# ----------------------------------------------------------------------- #
# attention
# ----------------------------------------------------------------------- #
def _repeat_kv(k, n_rep: int):
    return k if n_rep == 1 else torch.repeat_interleave(k, n_rep, dim=2)


def _attend_tile(q, k, v, scale, bias):
    """One (q-tile × kv-tile) step: (scores_max, exp_scores@v, sumexp)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return m, o, p.sum(dim=-1)


def naive_attention(q, k, v, *, causal: bool, window: int = 0,
                    q_offset: int = 0, kv_len=None):
    """Reference attention (materializes scores). q:(B,Sq,H,D) k/v:(B,Sk,Hkv,D).

    ``q_offset`` is the absolute position of q[0] (for decode/windows).
    ``kv_len`` optionally masks cache positions >= kv_len (decode).
    """
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    k = _repeat_kv(k, H // Hkv)
    v = _repeat_kv(v, H // Hkv)
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    if kv_len is not None:
        mask &= kpos < kv_len
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return out.to(q.dtype)


def blocked_attention(q, k, v, *, causal: bool, window: int = 0,
                      block_q: int = 512, block_kv: int = 1024):
    """Flash-pattern attention: online softmax over KV tiles.

    Only tiles that can contain unmasked entries are visited.  Falls back
    to :func:`naive_attention` when the sequence is smaller than one tile
    or not a tile multiple, as the reference does.
    """
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if Sq <= block_q or Sk <= block_kv or Sq % block_q or Sk % block_kv:
        return naive_attention(q, k, v, causal=causal, window=window)
    n_rep = H // Hkv
    scale = 1.0 / math.sqrt(D)
    kr = _repeat_kv(k, n_rep)
    vr = _repeat_kv(v, n_rep)
    kv_tiles = Sk // block_kv
    dev = q.device

    outs = []
    for qi in range(Sq // block_q):
        q_blk = q[:, qi * block_q:(qi + 1) * block_q]
        q_lo, q_hi = qi * block_q, (qi + 1) * block_q
        lo_tile, hi_tile = 0, kv_tiles
        if causal:
            hi_tile = min(kv_tiles, (q_hi + block_kv - 1) // block_kv)
        if window:
            lo_tile = max(0, (q_lo - window) // block_kv)
        m = torch.full((B, H, block_q), NEG_INF, dtype=torch.float32,
                       device=dev)
        o = torch.zeros((B, block_q, H, v.shape[-1]), dtype=torch.float32,
                        device=dev)
        l = torch.zeros((B, H, block_q), dtype=torch.float32, device=dev)
        for tile in range(lo_tile, hi_tile):
            start = tile * block_kv
            k_blk = kr[:, start:start + block_kv]
            v_blk = vr[:, start:start + block_kv]
            bias = None
            if causal or window:
                qpos = q_lo + torch.arange(block_q, device=dev)[:, None]
                kpos = start + torch.arange(block_kv, device=dev)[None, :]
                keep = torch.ones((block_q, block_kv), dtype=torch.bool,
                                  device=dev)
                if causal:
                    keep &= kpos <= qpos
                if window:
                    keep &= kpos > qpos - window
                bias = torch.where(keep, 0.0, NEG_INF)[None, None]
            m_new, o_new, l_new = _attend_tile(q_blk, k_blk, v_blk, scale,
                                               bias)
            m_max = torch.maximum(m, m_new)
            a_prev = torch.exp(m - m_max)
            a_new = torch.exp(m_new - m_max)
            o = (o * a_prev.transpose(1, 2)[..., None]
                 + o_new * a_new.transpose(1, 2)[..., None])
            l = l * a_prev + l_new * a_new
            m = m_max
        l = torch.clamp_min(l, 1e-37)
        outs.append((o / l.transpose(1, 2)[..., None]).to(q.dtype))
    return torch.cat(outs, dim=1)


def decode_attention(q, k_cache, v_cache, pos: int, *, window: int = 0):
    """Single-token attention against a (possibly ring-buffered) KV cache.

    q: (B, 1, H, D); caches: (B, S_cache, Hkv, D); pos: count of tokens
    already written (the new token's kv must already be in the cache).
    For windowed layers the cache is a ring buffer and every slot
    < min(pos+1, S_cache) is valid.  The grouped GQA einsum contracts
    against the Hkv-cache without a rep×-replicated copy.
    """
    B, _, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    rep = H // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, 1, Hkv, rep, D)
    s = torch.einsum("bqhrd,bkhd->bhrqk", qg.float(), k_cache.float()) * scale
    s = s.reshape(B, H, 1, S)
    idx = torch.arange(S, device=q.device)[None, None, None, :]
    valid = idx <= pos if not window else idx < min(pos + 1, S)
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    pg = p.reshape(B, Hkv, rep, 1, S)
    out = torch.einsum("bhrqk,bkhd->bqhrd", pg.to(v_cache.dtype), v_cache)
    return out.reshape(B, 1, H, D).to(q.dtype)
