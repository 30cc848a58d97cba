"""Layer blocks in PyTorch and the block dispatcher.

A port of ``repro/models/blocks.py`` for every kind: the global (ATTN)
and sliding-window (LOCAL_ATTN) decoder blocks with qkv bias, qk-norm,
sandwich norms, the full KV cache and the ring cache; the bidirectional
encoder block (ENC, no cache) and the decoder block with
cross-attention over the encoder's memory (DEC, whose cache adds the
memory's ``cross_k``/``cross_v``); the DeepSeek multi-head latent
attention blocks (MLA with a dense MLP, MLA_MOE with the MoE of
:mod:`.moe`) with their ``c_kv``/``k_rope`` latent cache; the Mamba2
(SSM) and Griffin RG-LRU (RGLRU) blocks with their state and conv
caches.  ``cfg.moe_ep`` routes the MoE through
``distributed.expert_parallel.apply_moe_ep``; ``cfg.seq_sharding`` with
``cfg.sp_gather_heads`` and ``cfg.decode_seq_shard`` place the
reference's sharding hints (``common.shard_*``), which act on DTensors
under an ambient mesh only.

The functional contract is the reference's:

    params            = init_block(gen, cfg, kind, dense_layer=...)
    cache             = init_block_cache(cfg, kind, batch, max_len,
                                         memory_len, device)
    x', cache'        = apply_block(params, x, cfg, kind, mode=..., ...,
                                    memory=...)

except that caches are updated **in place** (the reference's jitted
decode donates its cache buffers to the same effect); the returned cache
is the same dict, written.

``cfg.use_pallas_kernels`` keeps its name: in the port it routes prefill
through the CUDA flash-attention kernel, decode through the CUDA
flash-decode kernel, and the SSD and RG-LRU scans of prefill and
training through the CUDA ``ssd_scan`` and ``rglru_scan`` kernels
(``repro_torch.kernels.ops``).  The flash kernel takes causal
attention only, as the reference's does: the ENC block and the DEC
cross-attention run ``blocked_attention`` whatever the flag says.  The
reference's recurrent blocks ignore the flag, and so do both sides' MLA
blocks: prefill runs ``blocked_attention`` over the expanded K/V (a qk
head dim of nope + rope, a v head dim of its own) and decode an
absorbed softmax in latent space.
"""

from __future__ import annotations

from typing import Dict, Optional

import math

import torch
from torch.distributed.tensor import DTensor

from ..configs.base import (ATTN, DEC, ENC, LOCAL_ATTN, MLA, MLA_MOE, RGLRU,
                            SSM, ModelConfig)
from .common import (apply_mlp, apply_norm, apply_rope, blocked_attention,
                     decode_attention, dense_init, init_mlp, init_norm,
                     rms_norm, shard_heads)
from .moe import apply_moe, init_moe
from .rglru import apply_rglru_block, init_rglru_block, init_rglru_cache
from .ssm import apply_ssm_block, init_ssm_block, init_ssm_cache

_ATTN_FAMILY = (ATTN, LOCAL_ATTN, ENC, DEC)
_MLA_FAMILY = (MLA, MLA_MOE)
_RECURRENT = (SSM, RGLRU)


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
    if kind == DEC:
        p["pre_cross"] = init_norm(cfg.d_model, cfg.norm, dev)
        p["cross"] = _init_attention(gen, cfg, dtype)
    return p


def _attn_cache_len(cfg: ModelConfig, kind: str, max_len: int) -> int:
    if kind == LOCAL_ATTN and cfg.sliding_window:
        return min(max_len, cfg.sliding_window)
    return max_len


def init_attn_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                    memory_len: int = 0, device=None) -> Dict:
    dtype = torch_dtype(cfg)
    Hkv, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    L = _attn_cache_len(cfg, kind, max_len)
    lens = {"k": L, "v": L}
    if kind == DEC:
        lens.update(cross_k=memory_len, cross_v=memory_len)
    return {name: torch.zeros((batch, n, Hkv, Dh), dtype=dtype,
                              device=device)
            for name, n in lens.items()}


def _write_full_cache(cache_arr, new, pos: int) -> None:
    """Write a (B,S,...) slab at sequence offset pos, in place (the start
    clamps into range, as ``lax.dynamic_update_slice`` does)."""
    S, L = new.shape[1], cache_arr.shape[1]
    start = min(max(pos, 0), L - S)
    if isinstance(cache_arr, DTensor):
        _write_sharded_cache(cache_arr, new, start)
        return
    cache_arr[:, start:start + S] = new.to(cache_arr.dtype)


def _write_sharded_cache(cache_arr, new, start: int) -> None:
    """:func:`_write_full_cache` into a DTensor cache, whose sequence dim
    may be sharded (``cache_pspecs``): DTensor cannot slice a sharded dim
    in place, so each rank writes the part of the slab that falls in its
    own shard, ``new`` laid out as the cache with its sequence whole."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, placements = cache_arr.device_mesh, cache_arr.placements
    if not isinstance(new, DTensor):
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    src = new.redistribute(mesh, [Replicate() if p.is_shard(1) else p
                                  for p in placements]).to_local()
    shape, offset = compute_local_shape_and_global_offset(
        cache_arr.shape, mesh, placements)
    lo, hi = offset[1], offset[1] + shape[1]
    a, b = max(start, lo), min(start + new.shape[1], hi)
    if a < b:
        cache_arr.to_local()[:, a - lo:b - lo] = \
            src[:, a - start:b - start].to(cache_arr.dtype)


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
                     cache: Optional[Dict] = None, memory=None):
    """x: (B, S, d). decode: S == 1 and `pos` is the int write position.
    A DEC block reads ``memory`` (B, M, d), the encoder's output, in
    train and prefill, and its cache's ``cross_k``/``cross_v`` in decode.
    """
    causal = kind != ENC
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
            attn = decode_attention(
                q, ck, cv, pos, window=window,
                seq_shard=cfg.decode_seq_shard and not window)
    else:
        q, k, v = _qkv(params["attn"], h, cfg, kind, positions)
        if cfg.seq_sharding and cfg.sp_gather_heads:
            q, k, v = shard_heads(q), shard_heads(k), shard_heads(v)
        if cfg.use_pallas_kernels and causal:
            from ..kernels import ops as kernel_ops
            attn = kernel_ops.flash_attention(
                q.to(v.dtype), k.to(v.dtype), v, causal=True,
                window=window, block_q=cfg.attn_block_q,
                block_kv=cfg.attn_block_kv)
        else:
            attn = blocked_attention(q, k, v, causal=causal, window=window,
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

    out = _out_proj(attn, params["attn"]["wo"])
    if cfg.post_norms:
        out = apply_norm(params["post_attn"], out, cfg.norm, cfg.norm_eps)
    x = res + out

    if kind == DEC:
        x = x + _cross_attention(params, x, cfg, mode=mode, cache=cache,
                                 memory=memory)

    res = x
    h = apply_norm(params["pre_mlp"], x, cfg.norm, cfg.norm_eps)
    out = apply_mlp(params["mlp"], h, cfg.act, gated=_gated(cfg))
    if cfg.post_norms:
        out = apply_norm(params["post_mlp"], out, cfg.norm, cfg.norm_eps)
    return res + out, cache


def _out_proj(attn, wo):
    """einsum("bshk,hkd->bsd") as one matmul."""
    B, S = attn.shape[0], attn.shape[1]
    return attn.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])


def _cross_attention(params, x, cfg: ModelConfig, *, mode: str, cache,
                     memory):
    """A DEC block's cross-attention over the encoder's memory, without
    its residual: no bias and no RoPE on q, k or v, non-causal.  Prefill
    writes the memory's K/V into the cache; decode reads them back."""
    if memory is None and mode != "decode":
        raise ValueError("a DEC block needs the encoder's memory outside "
                         "decode")
    h = apply_norm(params["pre_cross"], x, cfg.norm, cfg.norm_eps)
    cp = params["cross"]
    q = _project(h, cp["wq"])
    if mode == "decode":
        mk, mv = cache["cross_k"], cache["cross_v"]
    else:
        mk, mv = _project(memory, cp["wk"]), _project(memory, cp["wv"])
        if mode == "prefill":     # the self-attention checked the cache
            _write_full_cache(cache["cross_k"], mk, 0)
            _write_full_cache(cache["cross_v"], mv, 0)
    attn = blocked_attention(q, mk, mv, causal=False,
                             block_q=cfg.attn_block_q,
                             block_kv=cfg.attn_block_kv)
    return _out_proj(attn, cp["wo"])


# ===================================================================== #
# multi-head latent attention (DeepSeek V2/V3)
# ===================================================================== #
def init_mla_block(gen, cfg: ModelConfig, kind: str, dense_layer: bool
                   ) -> Dict:
    dtype = torch_dtype(cfg)
    dev = gen.device
    mla = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk_dim = mla.qk_nope_head_dim + mla.qk_rope_head_dim
    p: Dict = {
        "pre_attn": init_norm(d, cfg.norm, dev),
        "pre_mlp": init_norm(d, cfg.norm, dev),
        "wkv_a": dense_init(gen, (d, mla.kv_lora_rank + mla.qk_rope_head_dim),
                            dtype=dtype),
        "kv_norm": {"scale": torch.zeros((mla.kv_lora_rank,), device=dev)},
        "wk_b": dense_init(gen, (mla.kv_lora_rank, H, mla.qk_nope_head_dim),
                           dtype=dtype),
        "wv_b": dense_init(gen, (mla.kv_lora_rank, H, mla.v_head_dim),
                           dtype=dtype),
        "wo": dense_init(gen, (H, mla.v_head_dim, d), in_axis=(0, 1),
                         dtype=dtype),
    }
    if mla.q_lora_rank:
        p["wq_a"] = dense_init(gen, (d, mla.q_lora_rank), dtype=dtype)
        p["q_norm"] = {"scale": torch.zeros((mla.q_lora_rank,), device=dev)}
        p["wq_b"] = dense_init(gen, (mla.q_lora_rank, H, qk_dim), dtype=dtype)
    else:
        p["wq"] = dense_init(gen, (d, H, qk_dim), dtype=dtype)
    if dense_layer or kind == MLA:
        ff = cfg.dense_ff or cfg.d_ff
        p["mlp"] = init_mlp(gen, d, ff, gated=_gated(cfg), dtype=dtype)
    else:
        p["moe"] = init_moe(gen, cfg, dtype)
    return p


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   device=None) -> Dict:
    mla = cfg.mla
    dtype = torch_dtype(cfg)
    return {
        "c_kv": torch.zeros((batch, max_len, mla.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, max_len, mla.qk_rope_head_dim),
                              dtype=dtype, device=device),
    }


def _mla_q(params, h, cfg: ModelConfig, positions):
    mla = cfg.mla
    if mla.q_lora_rank:
        qa = rms_norm(h @ params["wq_a"], params["q_norm"]["scale"],
                      cfg.norm_eps)
        q = _project(qa, params["wq_b"])
    else:
        q = _project(h, params["wq"])
    q_nope = q[..., :mla.qk_nope_head_dim]
    q_rope = apply_rope(q[..., mla.qk_nope_head_dim:], positions,
                        cfg.rope_theta)
    return q_nope, q_rope


def _mla_kv_latent(params, h, cfg: ModelConfig, positions):
    mla = cfg.mla
    kv = h @ params["wkv_a"]
    c_kv = rms_norm(kv[..., :mla.kv_lora_rank], params["kv_norm"]["scale"],
                    cfg.norm_eps)
    k_rope = apply_rope(kv[..., mla.kv_lora_rank:], positions, cfg.rope_theta)
    return c_kv, k_rope


def apply_mla_block(params, x, cfg: ModelConfig, kind: str, *, mode: str,
                    positions=None, pos: Optional[int] = None,
                    cache: Optional[Dict] = None):
    """x: (B, S, d). decode: S == 1 and `pos` is the int write position."""
    mla = cfg.mla
    scale = 1.0 / math.sqrt(mla.qk_nope_head_dim + mla.qk_rope_head_dim)
    res = x
    h = apply_norm(params["pre_attn"], x, cfg.norm, cfg.norm_eps)

    if mode == "decode":
        if cache is None or pos is None:
            raise ValueError("decode needs a cache and a position")
        posv = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
        q_nope, q_rope = _mla_q(params, h, cfg, posv)          # (B,1,H,·)
        c_t, kr_t = _mla_kv_latent(params, h, cfg, posv)       # (B,1,·)
        c_kv, k_rope = cache["c_kv"], cache["k_rope"]
        _write_full_cache(c_kv, c_t, pos)
        _write_full_cache(k_rope, kr_t, pos)
        # absorbed attention: score in latent space, expand after combine
        q_lat = torch.einsum("bqhn,lhn->bqhl", q_nope, params["wk_b"])
        s = (torch.einsum("bqhl,bsl->bhqs", q_lat.float(), c_kv.float())
             + torch.einsum("bqhr,bsr->bhqs", q_rope.float(),
                            k_rope.float())) * scale
        S = c_kv.shape[1]
        valid = torch.arange(S, device=x.device)[None, None, None, :] <= pos
        s = torch.where(valid, s, -1e30)
        p_attn = torch.softmax(s, dim=-1)
        o_lat = torch.einsum("bhqs,bsl->bqhl", p_attn.to(c_kv.dtype), c_kv)
        attn = torch.einsum("bqhl,lhv->bqhv", o_lat, params["wv_b"])
    else:
        q_nope, q_rope = _mla_q(params, h, cfg, positions)
        c_kv, k_rope = _mla_kv_latent(params, h, cfg, positions)
        k_nope = _project(c_kv, params["wk_b"])
        v = _project(c_kv, params["wv_b"])
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            *k_nope.shape[:3], k_rope.shape[-1])], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        if cfg.seq_sharding and cfg.sp_gather_heads:
            q, k, v = shard_heads(q), shard_heads(k), shard_heads(v)
        attn = blocked_attention(q, k, v, causal=True,
                                 block_q=cfg.attn_block_q,
                                 block_kv=cfg.attn_block_kv)
        if mode == "prefill":
            if cache is None:
                raise ValueError("prefill needs a cache")
            _write_full_cache(cache["c_kv"], c_kv, 0)
            _write_full_cache(cache["k_rope"], k_rope, 0)

    x = res + _out_proj(attn, params["wo"])
    res = x
    h = apply_norm(params["pre_mlp"], x, cfg.norm, cfg.norm_eps)
    if "mlp" in params:
        out = apply_mlp(params["mlp"], h, cfg.act, gated=_gated(cfg))
    elif cfg.moe_ep:
        from ..distributed.expert_parallel import apply_moe_ep
        out = apply_moe_ep(params["moe"], h, cfg)
    else:
        out = apply_moe(params["moe"], h, cfg)
    return res + out, cache


# ===================================================================== #
# recurrent kinds: thin wrappers adding pre-norm + MLP halves
# ===================================================================== #
def init_recurrent_block(gen, cfg: ModelConfig, kind: str) -> Dict:
    dtype = torch_dtype(cfg)
    dev = gen.device
    if kind == SSM:
        # Mamba2 blocks are norm + mixer only (no separate MLP)
        return {
            "pre_mix": init_norm(cfg.d_model, cfg.norm, dev),
            "mixer": init_ssm_block(gen, cfg, dtype),
        }
    return {
        "pre_mix": init_norm(cfg.d_model, cfg.norm, dev),
        "mixer": init_rglru_block(gen, cfg, dtype),
        "pre_mlp": init_norm(cfg.d_model, cfg.norm, dev),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, gated=_gated(cfg),
                        dtype=dtype),
    }


def apply_recurrent_block(params, x, cfg: ModelConfig, kind: str, *,
                          mode: str, cache: Optional[Dict] = None):
    res = x
    h = apply_norm(params["pre_mix"], x, cfg.norm, cfg.norm_eps)
    if kind == SSM:
        out, cache = apply_ssm_block(params["mixer"], h, cfg, mode=mode,
                                     cache=cache)
        return res + out, cache
    out, cache = apply_rglru_block(params["mixer"], h, cfg, mode=mode,
                                   cache=cache)
    x = res + out
    res = x
    h = apply_norm(params["pre_mlp"], x, cfg.norm, cfg.norm_eps)
    return res + apply_mlp(params["mlp"], h, cfg.act, gated=_gated(cfg)), cache


# ===================================================================== #
# dispatcher
# ===================================================================== #
def init_block(gen, cfg: ModelConfig, kind: str, *,
               dense_layer: bool = False) -> Dict:
    if kind in _ATTN_FAMILY:
        return init_attn_block(gen, cfg, kind)
    if kind in _MLA_FAMILY:
        return init_mla_block(gen, cfg, kind, dense_layer)
    if kind in _RECURRENT:
        return init_recurrent_block(gen, cfg, kind)
    raise _not_ported(kind)


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     memory_len: int = 0, device=None) -> Optional[Dict]:
    if kind == ENC:
        return None
    if kind in _ATTN_FAMILY:
        return init_attn_cache(cfg, kind, batch, max_len, memory_len, device)
    if kind in _MLA_FAMILY:
        return init_mla_cache(cfg, batch, max_len, device)
    if kind == SSM:
        return init_ssm_cache(cfg, batch, torch_dtype(cfg), device)
    if kind == RGLRU:
        return init_rglru_cache(cfg, batch, torch_dtype(cfg), device)
    raise _not_ported(kind)


def apply_block(params, x, cfg: ModelConfig, kind: str, *, mode: str,
                positions=None, pos=None, cache=None, memory=None):
    if kind in _ATTN_FAMILY:
        return apply_attn_block(params, x, cfg, kind, mode=mode,
                                positions=positions, pos=pos, cache=cache,
                                memory=memory)
    if kind in _MLA_FAMILY:
        return apply_mla_block(params, x, cfg, kind, mode=mode,
                               positions=positions, pos=pos, cache=cache)
    if kind in _RECURRENT:
        return apply_recurrent_block(params, x, cfg, kind, mode=mode,
                                     cache=cache)
    raise _not_ported(kind)
