"""RG-LRU recurrent block in PyTorch (RecurrentGemma / Griffin — arXiv:2402.19427).

A port of ``repro/models/rglru.py``.  The temporal mixer is the
Real-Gated Linear Recurrent Unit:

    r_t = σ(W_a x_t + b_a)                    (recurrence gate)
    i_t = σ(W_x x_t + b_x)                    (input gate)
    a_t = exp(-c · softplus(Λ) ⊙ r_t)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

Training and prefill evaluate the recurrence with a log-depth
Hillis–Steele scan over time (the reference's
``lax.associative_scan``), or, with ``cfg.use_pallas_kernels`` set,
with the CUDA ``rglru_scan`` kernel on the fp32 (a, b) of the gates;
the reference's block ignores the flag.  Decode is the O(1) update.
The block wraps the RG-LRU in Griffin's recurrent block: a parallel
gelu gate branch, a causal depthwise conv on the recurrent branch, and
an output projection.  Caches are written in place (``copy_``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .common import dense_init
from .ssm import causal_conv, conv_decode, write_conv_state


def rglru_width(cfg: ModelConfig) -> int:
    assert cfg.rglru is not None
    return cfg.rglru.lru_width or cfg.d_model


def init_rglru_block(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict:
    d = cfg.d_model
    w = rglru_width(cfg)
    rg = cfg.rglru
    nb = rg.gate_blocks
    assert w % nb == 0
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "gate_proj": dense_init(gen, (d, w), dtype=dtype),
        "rec_proj": dense_init(gen, (d, w), dtype=dtype),
        "conv_w": dense_init(gen, (rg.conv_kernel, w), dtype=dtype),
        "conv_b": torch.zeros((w,), dtype=dtype, device=dev),
        # Griffin uses block-diagonal gate matrices (nb blocks)
        "w_a": dense_init(gen, (nb, w // nb, w // nb), in_axis=1,
                          dtype=dtype),
        "b_a": torch.zeros((w,), **f32),
        "w_x": dense_init(gen, (nb, w // nb, w // nb), in_axis=1,
                          dtype=dtype),
        "b_x": torch.zeros((w,), **f32),
        # Λ init so that a ∈ (0.9, 0.999) at r=1 (paper init)
        "lam": torch.log(torch.expm1(
            -torch.log(torch.linspace(0.9, 0.999, w, **f32))
            / rg.c_constant)),
        "out_proj": dense_init(gen, (w, d), dtype=dtype),
    }


def _block_diag_matmul(x, w):
    """x: (..., W) @ block-diagonal w: (nb, W/nb, W/nb) → (..., W)."""
    nb, bs, _ = w.shape
    xb = x.reshape(*x.shape[:-1], nb, bs)
    yb = torch.einsum("...nb,nbc->...nc", xb, w)
    return yb.reshape(x.shape)


def rglru_gates(params, x, c_constant: float):
    """Per-step gate computation. x: (..., W) → fp32 (a, b) of the
    recurrence h' = a ⊙ h + b  with  b = sqrt(1-a²) ⊙ i ⊙ x."""
    r = torch.sigmoid(_block_diag_matmul(x, params["w_a"]).float()
                      + params["b_a"])
    i = torch.sigmoid(_block_diag_matmul(x, params["w_x"]).float()
                      + params["b_x"])
    log_a = -c_constant * F.softplus(params["lam"]) * r
    a = torch.exp(log_a)
    # sqrt(1 - a^2) computed in log space for stability near a→1
    sq = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    b = sq * i * x.float()
    return a, b


def linear_scan(a, b):
    """Inclusive scan of h_t = a_t·h_{t-1} + b_t over axis 1 from h = 0,
    by Hillis–Steele doubling (log2 S steps).  Returns (a_cum, h)."""
    S = a.shape[1]
    d = 1
    while d < S:
        # element t combines with element t-d (the earlier one)
        a_prev, b_prev = a[:, :-d], b[:, :-d]
        a_new = torch.cat([a[:, :d], a[:, d:] * a_prev], dim=1)
        b = torch.cat([b[:, :d], a[:, d:] * b_prev + b[:, d:]], dim=1)
        a = a_new
        d *= 2
    return a, b


def rglru_scan(params, x, c_constant: float,
               init_h: Optional[torch.Tensor] = None, *,
               kernel: bool = False):
    """Scan over time. x: (B, S, W) → (y in x's dtype, h_final fp32).

    ``kernel`` runs the recurrence through the CUDA ``rglru_scan``
    kernel; an ``init_h`` then folds into the first step's b (exact:
    h_0 = a_0·init_h + b_0)."""
    a, b = rglru_gates(params, x, c_constant)
    if kernel:
        from ..kernels import ops as kernel_ops
        if init_h is not None:
            b = torch.cat([b[:, :1] + a[:, :1] * init_h[:, None], b[:, 1:]],
                          dim=1)
        h = kernel_ops.rglru_scan(a, b)
    else:
        a_cum, h = linear_scan(a, b)
        if init_h is not None:
            h = h + a_cum * init_h[:, None]
    return h.to(x.dtype), h[:, -1]


def rglru_step(params, x_t, h, c_constant: float):
    """O(1) decode update. x_t: (B, W); h: (B, W) fp32."""
    a, b = rglru_gates(params, x_t, c_constant)
    h = a * h + b
    return h.to(x_t.dtype), h


def apply_rglru_block(params, x, cfg: ModelConfig, *, mode: str,
                      cache: Optional[Dict] = None):
    """Griffin recurrent block. x: (B, S, d) (S=1 for decode).

    Prefill and decode write ``cache["h"]`` and ``cache["conv"]`` in place
    and return the same dict."""
    rg = cfg.rglru
    assert rg is not None
    gate = F.gelu(x @ params["gate_proj"], approximate="tanh")
    rec = x @ params["rec_proj"]

    if mode == "decode":
        if cache is None:
            raise ValueError("decode needs a cache")
        rec1, conv_state = conv_decode(rec[:, 0], cache["conv"],
                                       params["conv_w"], params["conv_b"])
        y, h = rglru_step(params, rec1, cache["h"], rg.c_constant)
        out = (y[:, None] * gate) @ params["out_proj"]
        cache["h"].copy_(h)
        cache["conv"].copy_(conv_state)
        return out, cache

    conv = causal_conv(rec, params["conv_w"], params["conv_b"])
    y, h_final = rglru_scan(params, conv, rg.c_constant,
                            kernel=cfg.use_pallas_kernels)
    out = (y * gate) @ params["out_proj"]
    if mode == "prefill":
        if cache is None:
            raise ValueError("prefill needs a cache")
        cache["h"].copy_(h_final)
        write_conv_state(cache["conv"], rec)
        return out, cache
    return out, None


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype,
                     device=None) -> Dict:
    w = rglru_width(cfg)
    rg = cfg.rglru
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, rg.conv_kernel - 1, w), dtype=dtype,
                            device=device),
    }
