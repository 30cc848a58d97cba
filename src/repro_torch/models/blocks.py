"""Attention-family layer blocks in PyTorch and the block dispatcher.

A port of the attention half of ``repro/models/blocks.py``: the global
(ATTN) and sliding-window (LOCAL_ATTN) decoder blocks with qkv bias,
qk-norm, sandwich norms, the full KV cache and the ring cache.  The
other kinds (ENC/DEC, MLA, SSM, RG-LRU) come with later slices and raise
``NotImplementedError`` here.

The functional contract is the reference's:

    params            = init_block(gen, cfg, kind)
    cache             = init_block_cache(cfg, kind, batch, max_len, device)
    x', cache'        = apply_block(params, x, cfg, kind, mode=..., ...)

except that caches are updated **in place** (the reference's jitted
decode donates its cache buffers to the same effect); the returned cache
is the same dict, written.

``cfg.use_pallas_kernels`` keeps its name: in the port it routes prefill
through the CUDA flash-attention kernel and decode through the CUDA
flash-decode kernel (``repro_torch.kernels.ops``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..configs.base import ATTN, LOCAL_ATTN, ModelConfig
from .common import (apply_mlp, apply_norm, apply_rope, blocked_attention,
                     decode_attention, dense_init, init_mlp, init_norm,
                     rms_norm)

_PORTED = (ATTN, LOCAL_ATTN)


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _gated(cfg: ModelConfig) -> bool:
    return cfg.act in ("silu", "gelu")


def _rope_theta(cfg: ModelConfig, kind: str) -> float:
    return cfg.rope_local_theta if kind == LOCAL_ATTN else cfg.rope_theta


def _not_ported(kind: str) -> NotImplementedError:
    return NotImplementedError(f"{kind} not yet ported")


# ===================================================================== #
# standard attention family
# ===================================================================== #
def _init_attention(gen, cfg: ModelConfig, dtype) -> Dict:
    d, H, Hkv, Dh = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
    p = {
        "wq": dense_init(gen, (d, H, Dh), dtype=dtype),
        "wk": dense_init(gen, (d, Hkv, Dh), dtype=dtype),
        "wv": dense_init(gen, (d, Hkv, Dh), dtype=dtype),
        "wo": dense_init(gen, (H, Dh, d), in_axis=(0, 1), dtype=dtype),
    }
    dev = gen.device
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, Dh), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((Hkv, Dh), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((Hkv, Dh), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = {"scale": torch.zeros((Dh,), device=dev)}
        p["k_norm"] = {"scale": torch.zeros((Dh,), device=dev)}
    return p


def _project(x, w):
    """einsum("bsd,dhk->bshk") as one matmul; the result is contiguous."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).view(*x.shape[:-1], h, k)


def _qkv(p, x, cfg: ModelConfig, kind: str, positions):
    q, k, v = _project(x, p["wq"]), _project(x, p["wk"]), _project(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"]["scale"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"]["scale"], cfg.norm_eps)
    theta = _rope_theta(cfg, kind)
    q = apply_rope(q, positions, theta, cfg.rope_pct)
    k = apply_rope(k, positions, theta, cfg.rope_pct)
    return q, k, v


def init_attn_block(gen, cfg: ModelConfig, kind: str) -> Dict:
    dtype = torch_dtype(cfg)
    dev = gen.device
    p = {
        "pre_attn": init_norm(cfg.d_model, cfg.norm, dev),
        "attn": _init_attention(gen, cfg, dtype),
        "pre_mlp": init_norm(cfg.d_model, cfg.norm, dev),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, gated=_gated(cfg),
                        dtype=dtype),
    }
    if cfg.post_norms:
        p["post_attn"] = init_norm(cfg.d_model, cfg.norm, dev)
        p["post_mlp"] = init_norm(cfg.d_model, cfg.norm, dev)
    return p


def _attn_cache_len(cfg: ModelConfig, kind: str, max_len: int) -> int:
    if kind == LOCAL_ATTN and cfg.sliding_window:
        return min(max_len, cfg.sliding_window)
    return max_len


def init_attn_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                    device=None) -> Dict:
    dtype = torch_dtype(cfg)
    Hkv, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    L = _attn_cache_len(cfg, kind, max_len)
    return {
        "k": torch.zeros((batch, L, Hkv, Dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, L, Hkv, Dh), dtype=dtype, device=device),
    }


def _write_full_cache(cache_arr, new, pos: int) -> None:
    """Write a (B,S,...) slab at sequence offset pos, in place (the start
    clamps into range, as ``lax.dynamic_update_slice`` does)."""
    S, L = new.shape[1], cache_arr.shape[1]
    start = min(max(pos, 0), L - S)
    cache_arr[:, start:start + S] = new.to(cache_arr.dtype)


def _write_ring(cache_arr, new, pos: int, window: int) -> None:
    """Write one token at slot pos % window (decode), in place."""
    _write_full_cache(cache_arr, new, pos % window)


def _prefill_ring(cache_arr, k_seq, window: int) -> None:
    """Store the last `window` tokens so that token p sits in slot p%window."""
    S = k_seq.shape[1]
    if S <= window:
        _write_full_cache(cache_arr, k_seq, 0)
        return
    tail = k_seq[:, -window:].to(cache_arr.dtype)
    cache_arr.copy_(torch.roll(tail, shifts=S % window, dims=1))


def apply_attn_block(params, x, cfg: ModelConfig, kind: str, *, mode: str,
                     positions=None, pos: Optional[int] = None,
                     cache: Optional[Dict] = None):
    """x: (B, S, d). decode: S == 1 and `pos` is the int write position."""
    window = cfg.sliding_window if kind == LOCAL_ATTN else 0
    res = x
    h = apply_norm(params["pre_attn"], x, cfg.norm, cfg.norm_eps)

    if mode == "decode":
        if cache is None or pos is None:
            raise ValueError("decode needs a cache and a position")
        positions = torch.full((1, 1), pos, dtype=torch.int32,
                               device=x.device)
        q, k, v = _qkv(params["attn"], h, cfg, kind, positions)
        ck, cv = cache["k"], cache["v"]
        if window:
            _write_ring(ck, k, pos, window)
            _write_ring(cv, v, pos, window)
        else:
            _write_full_cache(ck, k, pos)
            _write_full_cache(cv, v, pos)
        if cfg.use_pallas_kernels:
            # CUDA flash-decode: position mask → per-batch valid length.
            # Full cache: slots 0..pos hold tokens 0..pos.  Ring cache
            # (window): the last min(pos+1, L) tokens occupy some
            # permutation of the first min(pos+1, L) slots — softmax is
            # permutation-invariant over KV, so a plain length mask is
            # exact for both layouts.
            from ..kernels import ops as kernel_ops
            L = ck.shape[1]
            lengths = torch.full((q.shape[0],), min(pos + 1, L),
                                 dtype=torch.int32, device=x.device)
            attn = kernel_ops.decode_attention(
                q.to(ck.dtype), ck, cv, lengths, block_kv=cfg.attn_block_kv)
        else:
            attn = decode_attention(q, ck, cv, pos, window=window)
    else:
        q, k, v = _qkv(params["attn"], h, cfg, kind, positions)
        if cfg.use_pallas_kernels:
            from ..kernels import ops as kernel_ops
            attn = kernel_ops.flash_attention(
                q.to(v.dtype), k.to(v.dtype), v, causal=True,
                window=window, block_q=cfg.attn_block_q,
                block_kv=cfg.attn_block_kv)
        else:
            attn = blocked_attention(q, k, v, causal=True, window=window,
                                     block_q=cfg.attn_block_q,
                                     block_kv=cfg.attn_block_kv)
        if mode == "prefill":
            if cache is None:
                raise ValueError("prefill needs a cache")
            if window:
                _prefill_ring(cache["k"], k, window)
                _prefill_ring(cache["v"], v, window)
            else:
                _write_full_cache(cache["k"], k, 0)
                _write_full_cache(cache["v"], v, 0)

    wo = params["attn"]["wo"]
    B, S = attn.shape[0], attn.shape[1]
    out = attn.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])
    if cfg.post_norms:
        out = apply_norm(params["post_attn"], out, cfg.norm, cfg.norm_eps)
    x = res + out

    res = x
    h = apply_norm(params["pre_mlp"], x, cfg.norm, cfg.norm_eps)
    out = apply_mlp(params["mlp"], h, cfg.act, gated=_gated(cfg))
    if cfg.post_norms:
        out = apply_norm(params["post_mlp"], out, cfg.norm, cfg.norm_eps)
    return res + out, cache


# ===================================================================== #
# dispatcher
# ===================================================================== #
def init_block(gen, cfg: ModelConfig, kind: str) -> Dict:
    if kind in _PORTED:
        return init_attn_block(gen, cfg, kind)
    raise _not_ported(kind)


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     device=None) -> Optional[Dict]:
    if kind in _PORTED:
        return init_attn_cache(cfg, kind, batch, max_len, device)
    raise _not_ported(kind)


def apply_block(params, x, cfg: ModelConfig, kind: str, *, mode: str,
                positions=None, pos=None, cache=None):
    if kind in _PORTED:
        return apply_attn_block(params, x, cfg, kind, mode=mode,
                                positions=positions, pos=pos, cache=cache)
    raise _not_ported(kind)
