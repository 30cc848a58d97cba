"""stablelm-12b [dense] — hf:stabilityai/stablelm-2-12b.

40L, d_model=5120, 32 heads (GQA kv=8), d_ff=13824, vocab=100352,
LayerNorm, partial rotary 25%, per-head qk norm, SwiGLU.
"""

from .base import ATTN, ModelConfig, register

STABLELM_12B = register(ModelConfig(
    name="stablelm-12b",
    family="dense",
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=100_352,
    head_dim=160,
    pattern=(ATTN,),
    n_repeats=40,
    rope_theta=10_000.0,
    rope_pct=0.25,
    norm="layernorm",
    norm_eps=1e-5,
    act="silu",
    qk_norm=True,
))
