"""Mamba2 SSD (state-space duality) mixer in PyTorch — arXiv:2405.21060.

A port of ``repro/models/ssm.py``.  Training and prefill use the chunked
SSD algorithm: quadratic attention-like work within chunks of length Q,
and a recurrence over the per-chunk states, here a Python loop over the
chunks where the reference runs ``lax.associative_scan``.  Decode is the
O(1) recurrent update.

With ``cfg.use_pallas_kernels`` set, prefill and train-mode SSD go
through the CUDA ``ssd_scan`` kernel (``repro_torch.kernels.ops``); the
reference's block ignores the flag and always runs its jnp scan.  The
block pads the sequence to a chunk multiple with dt = 0 before the call,
as ``ssd_chunked`` does, so the padding leaves outputs and state alone.

dtypes follow the reference's promotions: dt, ``a_log``, ``dt_bias``,
``d_skip`` and the SSM state are fp32, everything else is in the model
dtype; where JAX promotes a bf16 × fp32 product to fp32, the port casts
the bf16 side up first.  Caches are written **in place** (``copy_``), so
a cache dict that holds views into a stacked cache sees the update.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .common import dense_init, rms_norm


def ssm_dims(cfg: ModelConfig) -> Dict[str, int]:
    ssm = cfg.ssm
    assert ssm is not None
    d_inner = ssm.expand * cfg.d_model
    n_heads = d_inner // ssm.head_dim
    conv_dim = d_inner + 2 * ssm.n_groups * ssm.d_state
    return dict(d_inner=d_inner, n_heads=n_heads, conv_dim=conv_dim,
                d_state=ssm.d_state, head_dim=ssm.head_dim,
                n_groups=ssm.n_groups, conv_kernel=ssm.conv_kernel,
                chunk=ssm.chunk_size)


def init_ssm_block(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict:
    dims = ssm_dims(cfg)
    d = cfg.d_model
    di, nh, cd = dims["d_inner"], dims["n_heads"], dims["conv_dim"]
    proj_out = 2 * di + 2 * dims["n_groups"] * dims["d_state"] + nh
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "in_proj": dense_init(gen, (d, proj_out), dtype=dtype),
        "conv_w": dense_init(gen, (dims["conv_kernel"], cd), dtype=dtype),
        "conv_b": torch.zeros((cd,), dtype=dtype, device=dev),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "dt_bias": torch.zeros((nh,), **f32),
        "d_skip": torch.ones((nh,), **f32),
        "norm": {"scale": torch.zeros((di,), **f32)},
        "out_proj": dense_init(gen, (di, d), dtype=dtype),
    }


def causal_conv(x, w, b):
    """Depthwise causal conv via K shifted adds. x: (B,S,C); w: (K,C)."""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = pad[:, 0:S] * w[0]
    for k in range(1, K):
        out = out + pad[:, k:k + S] * w[k]
    return out + b


def conv_decode(x_t, conv_state, w, b):
    """One-token depthwise conv. x_t: (B,C); conv_state: (B,K-1,C).

    Returns (y (B,C), the new conv state (B,K-1,C))."""
    hist = torch.cat([conv_state, x_t[:, None]], dim=1)          # (B,K,C)
    y = torch.einsum("bkc,kc->bc", hist, w) + b
    return y, hist[:, 1:]


def _split_proj(cfg: ModelConfig, proj):
    dims = ssm_dims(cfg)
    di, gn = dims["d_inner"], dims["n_groups"] * dims["d_state"]
    z = proj[..., :di]
    xbc = proj[..., di:2 * di + 2 * gn]
    dt = proj[..., 2 * di + 2 * gn:]
    return z, xbc, dt


def _pad_seq(x, pad: int):
    """Zero-pad axis 1 of x by ``pad`` rows at the end."""
    widths = [0, 0] * (x.dim() - 2) + [0, pad]
    return F.pad(x, widths)


def ssd_chunked(x, dt, a_log, B_in, C_in, *, chunk: int,
                init_state: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    x:  (B, S, H, P)    dt: (B, S, H)     a_log: (H,)
    B_in/C_in: (B, S, G, N)
    Returns y (B, S, H, P) in x's dtype and the final state (B, H, P, N)
    in fp32.
    """
    Bb, S, H, P = x.shape
    G, N = B_in.shape[2], B_in.shape[3]
    out_dtype = x.dtype
    S_orig = S
    if S % chunk:
        # pad to a chunk multiple; dt=0 on pads makes them inert (dA=0,
        # zero state contribution) and padded outputs are sliced off.
        pad = chunk - S % chunk
        x, dt, B_in, C_in = (_pad_seq(t, pad) for t in (x, dt, B_in, C_in))
        S = S + pad
    nc, Q = S // chunk, chunk
    rep = H // G
    # JAX promotes every bf16 × fp32 product here to fp32
    x, B_in, C_in, dt = x.float(), B_in.float(), C_in.float(), dt.float()

    A = -torch.exp(a_log.float())                            # (H,) negative
    dA = dt * A                                              # (B,S,H)
    xc = x.reshape(Bb, nc, Q, H, P)
    dtc = dt.reshape(Bb, nc, Q, H)
    dAc = dA.reshape(Bb, nc, Q, H)
    Bc = B_in.reshape(Bb, nc, Q, G, N)
    Cc = C_in.reshape(Bb, nc, Q, G, N)

    cs = torch.cumsum(dAc, dim=2)                            # inclusive
    # ---- intra-chunk (attention-like) ------------------------------- #
    scores = torch.einsum("bcqgn,bckgn->bcgqk", Cc, Bc)      # (B,nc,G,Q,Q)
    scores = torch.repeat_interleave(scores, rep, dim=2)     # (B,nc,H,Q,Q)
    csh = cs.transpose(2, 3)                                 # (B,nc,H,Q)
    decay = csh[..., :, None] - csh[..., None, :]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    # masked before the exp: above the diagonal decay = cs_i - cs_j > 0
    # can overflow, and where(tri, exp(decay), 0) then has a 0 · inf =
    # NaN gradient (the reference's does); the values are the same
    L = torch.exp(torch.where(tri, decay, -torch.inf))       # (B,nc,H,Q,Q)
    dtx = xc * dtc[..., None]                                # (B,nc,Q,H,P)
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", scores * L, dtx)

    # ---- per-chunk states: Σ_j exp(cs_end - cs_j)·dt_j·B_j⊗x_j ------- #
    seg = torch.exp(cs[:, :, -1:, :] - cs)                   # (B,nc,Q,H)
    Bh = torch.repeat_interleave(Bc, rep, dim=3)             # (B,nc,Q,H,N)
    states = torch.einsum("bcqh,bcqhn,bcqhp->bchpn", seg * dtc, Bh, xc)

    # ---- inter-chunk recurrence (a loop over chunks) ----------------- #
    chunk_decay = torch.exp(cs[:, :, -1, :])                 # (B,nc,H)
    h = (torch.zeros_like(states[:, 0]) if init_state is None
         else init_state.float())
    h_before = []
    for c in range(nc):
        h_before.append(h)
        h = chunk_decay[:, c, :, None, None] * h + states[:, c]
    h_before = torch.stack(h_before, 1)                      # (B,nc,H,P,N)

    # ---- inter-chunk contribution ------------------------------------ #
    Ch = torch.repeat_interleave(Cc, rep, dim=3)             # (B,nc,Q,H,N)
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp", Ch, h_before) \
        * torch.exp(cs)[..., None]
    y = (y_intra + y_inter).reshape(Bb, S, H, P)[:, :S_orig]
    return y.to(out_dtype), h


def ssd_scan_padded(x, dt, a_log, B_in, C_in, *, chunk: int):
    """The CUDA ``ssd_scan`` kernel over any S: pads S to a chunk multiple
    with dt = 0 (inert, as in :func:`ssd_chunked`) and slices y back.
    Returns (y, final state) like :func:`ssd_chunked`."""
    from ..kernels import ops as kernel_ops
    S = x.shape[1]
    pad = (-S) % chunk
    if pad:
        x, dt, B_in, C_in = (_pad_seq(t, pad) for t in (x, dt, B_in, C_in))
    y, h = kernel_ops.ssd_scan(x, dt, a_log, B_in, C_in, chunk=chunk)
    return y[:, :S], h


def ssd_decode_step(x_t, dt_t, a_log, B_t, C_t, state):
    """O(1) recurrent update.  x_t: (B,H,P); dt_t: (B,H); B_t/C_t: (B,G,N);
    state: (B,H,P,N) → (y (B,H,P), state')."""
    H = x_t.shape[1]
    G = B_t.shape[1]
    A = -torch.exp(a_log.float())
    da = torch.exp(dt_t * A)                                  # (B,H)
    Bh = torch.repeat_interleave(B_t, H // G, dim=1).float()  # (B,H,N)
    Ch = torch.repeat_interleave(C_t, H // G, dim=1).float()
    contrib = (dt_t[..., None, None] * x_t.float()[..., None]
               * Bh[:, :, None, :])                           # (B,H,P,N)
    state = state * da[..., None, None] + contrib
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    return y.to(x_t.dtype), state


def _gated_norm(params, y, z, cfg: ModelConfig):
    """rms_norm(y · silu(z)) with the reference's casts: y is fp32 here
    (d_skip promoted it), silu(z) is taken in fp32 and cast to y's dtype."""
    return rms_norm(y * F.silu(z.float()).to(y.dtype),
                    params["norm"]["scale"], cfg.norm_eps)


def _out_proj(params, y, x):
    """(y @ out_proj) in y's dtype (JAX promotes the bf16 weight), cast to
    the block input's dtype."""
    w = params["out_proj"]
    return (y @ w.to(y.dtype)).to(x.dtype)


def apply_ssm_block(params, x, cfg: ModelConfig, *, mode: str,
                    cache: Optional[Dict] = None):
    """Full Mamba2 block: in_proj → conv → SSD → gated norm → out_proj.

    Prefill and decode write ``cache["state"]`` and ``cache["conv"]`` in
    place and return the same dict."""
    dims = ssm_dims(cfg)
    di, nh, P = dims["d_inner"], dims["n_heads"], dims["head_dim"]
    G, N = dims["n_groups"], dims["d_state"]
    gn = G * N

    if mode == "decode":
        if cache is None:
            raise ValueError("decode needs a cache")
        B = x.shape[0]
        proj = x[:, 0] @ params["in_proj"]                    # (B, proj)
        z, xbc, dt_raw = _split_proj(cfg, proj)
        xbc, conv_state = conv_decode(xbc, cache["conv"], params["conv_w"],
                                      params["conv_b"])
        xbc = F.silu(xbc)
        xs, B_t, C_t = xbc[:, :di], xbc[:, di:di + gn], xbc[:, di + gn:]
        dt = F.softplus(dt_raw.float() + params["dt_bias"])
        y, state = ssd_decode_step(
            xs.reshape(B, nh, P), dt, params["a_log"],
            B_t.reshape(B, G, N), C_t.reshape(B, G, N), cache["state"])
        y = y + params["d_skip"][None, :, None] * xs.reshape(B, nh, P)
        y = _gated_norm(params, y.reshape(B, 1, di), z[:, None], cfg)
        cache["state"].copy_(state)
        cache["conv"].copy_(conv_state)
        return _out_proj(params, y, x), cache

    B, S, _ = x.shape
    proj = x @ params["in_proj"]
    z, xbc_raw, dt_raw = _split_proj(cfg, proj)
    xbc = F.silu(causal_conv(xbc_raw, params["conv_w"], params["conv_b"]))
    xs, B_in, C_in = xbc[..., :di], xbc[..., di:di + gn], xbc[..., di + gn:]
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    scan = ssd_scan_padded if cfg.use_pallas_kernels else ssd_chunked
    y, state = scan(
        xs.reshape(B, S, nh, P), dt, params["a_log"],
        B_in.reshape(B, S, G, N), C_in.reshape(B, S, G, N),
        chunk=dims["chunk"])
    y = y + params["d_skip"][None, None, :, None] * xs.reshape(B, S, nh, P)
    y = _gated_norm(params, y.reshape(B, S, di), z, cfg)
    out = _out_proj(params, y, x)
    if mode == "prefill":
        if cache is None:
            raise ValueError("prefill needs a cache")
        cache["state"].copy_(state)
        write_conv_state(cache["conv"], xbc_raw)
        return out, cache
    return out, None


def write_conv_state(conv, raw):
    """The conv ring state is the last K-1 **pre-activation** conv inputs
    of the prompt (zeros before its start, as the causal conv pads)."""
    k1 = conv.shape[1]
    tail = raw[:, -k1:]
    conv.zero_()
    conv[:, k1 - tail.shape[1]:] = tail.to(conv.dtype)


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device=None) -> Dict:
    dims = ssm_dims(cfg)
    return {
        "state": torch.zeros((batch, dims["n_heads"], dims["head_dim"],
                              dims["d_state"]), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros((batch, dims["conv_kernel"] - 1,
                             dims["conv_dim"]), dtype=dtype, device=device),
    }
