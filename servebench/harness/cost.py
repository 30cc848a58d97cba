"""Operations, bytes and the H100's peaks: the benchmark's own count.

The peaks are NVIDIA's H100 SXM data sheet (dense, no sparsity; a card
set below 700 W reaches less, so every result carries the card's power
limit).  The counts follow from a configuration's widths and a call's
shapes alone, whatever implements the call; ``bound_s`` and
``visible_pairs`` copy ``chip_smoke.py``'s ``_bound`` and
``_visible_pairs``.
"""

from __future__ import annotations

from typing import Dict

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
MEM_BW = 3.35e12                      # bytes/s, HBM3
ELEM_BYTES = {"bfloat16": 2, "float32": 4}


def bound_s(bytes_moved: float, flops: float, dtype: str) -> float:
    """Least seconds a call can take: bytes over the HBM rate or the
    operations over the peak of their type, whichever is longer."""
    return max(bytes_moved / MEM_BW, flops / PEAK_FLOPS[dtype])


def visible_pairs(S: int, window: int = 0, sk: int = 0) -> int:
    """Causal (optionally windowed) query-key pairs of one head: S query
    rows against ``sk`` keys (S by default), positions from 0."""
    sk = sk or S
    return sum(max(0, min(i + 1, sk) - (max(0, i - window + 1) if window
                                        else 0)) for i in range(S))


def flash_call(conf: Dict, B: int, S: int) -> Dict[str, float]:
    """A causal prefill attention call over B sequences of S positions:
    each input byte read once (q, k, v), each output byte written once,
    and 4·D operations a visible (query, key) pair and head."""
    H, Hkv, D = conf["n_heads"], conf["n_kv_heads"], conf["head_dim"]
    elem = ELEM_BYTES[conf["dtype"]]
    return {"bytes": elem * (2 * B * S * H * D + 2 * B * S * Hkv * D),
            "flops": 4.0 * D * B * H * visible_pairs(S)}


def decode_call(conf: Dict, B: int, valid: int) -> Dict[str, float]:
    """A decode attention call of B one-token queries over ``valid``
    cache rows each: q and the output once, the valid K and V rows
    once, the int32 lengths."""
    H, Hkv, D = conf["n_heads"], conf["n_kv_heads"], conf["head_dim"]
    elem = ELEM_BYTES[conf["dtype"]]
    return {"bytes": elem * (2 * B * H * D + 2 * Hkv * D * B * valid)
            + 4 * B,
            "flops": 4.0 * D * H * B * valid}


def _linear_flops_per_token(conf: Dict) -> float:
    """Multiply-adds (×2) of one token through one layer's projections
    and MLP."""
    d, H, Hkv, D, ff = (conf["d_model"], conf["n_heads"],
                        conf["n_kv_heads"], conf["head_dim"], conf["d_ff"])
    attn = d * H * D + 2 * d * Hkv * D + H * D * d
    mlp = 2 * d * ff
    return 2.0 * (attn + mlp)


def prefill_flops(conf: Dict, S: int) -> float:
    """Model operations of one S-token prompt: every layer's projections,
    MLP and causal attention, and the head at the last position (norms,
    RoPE and the embedding lookup are not counted)."""
    L, H, D = conf["n_layers"], conf["n_heads"], conf["head_dim"]
    per_layer = S * _linear_flops_per_token(conf) \
        + 4.0 * H * D * visible_pairs(S)
    return L * per_layer + 2.0 * conf["d_model"] * conf["vocab_size"]


def decode_flops(conf: Dict, pos: int) -> float:
    """Model operations of one decode token written at ``pos``, attending
    pos + 1 keys, through the head."""
    L, H, D = conf["n_layers"], conf["n_heads"], conf["head_dim"]
    per_layer = _linear_flops_per_token(conf) + 4.0 * H * D * (pos + 1)
    return L * per_layer + 2.0 * conf["d_model"] * conf["vocab_size"]


def param_count(conf: Dict) -> int:
    """Parameters of the configuration (norms included)."""
    d, H, Hkv, D, ff, V, L = (conf["d_model"], conf["n_heads"],
                              conf["n_kv_heads"], conf["head_dim"],
                              conf["d_ff"], conf["vocab_size"],
                              conf["n_layers"])
    layer = d * H * D + 2 * d * Hkv * D + H * D * d \
        + 2 * d * ff + 4 * d
    return L * layer + 2 * V * d + 2 * d

