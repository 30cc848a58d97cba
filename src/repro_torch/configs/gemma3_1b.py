"""gemma3-1b [dense] — hf:google/gemma-3-1b-pt.

26L, d_model=1152, 4 heads (GQA kv=1), d_ff=6912, vocab=262144,
head_dim=256, 5:1 local:global attention (sliding window 512),
local RoPE θ=10k / global θ=1M, GeGLU, qk-norm, sandwich norms,
tied + scaled embeddings.  Layer stack: (5×local + global) × 4 + 2 local.
"""

from .base import ATTN, LOCAL_ATTN, ModelConfig, register

GEMMA3_1B = register(ModelConfig(
    name="gemma3-1b",
    family="dense",
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_ff=6912,
    vocab_size=262_144,
    head_dim=256,
    pattern=(LOCAL_ATTN, LOCAL_ATTN, LOCAL_ATTN, LOCAL_ATTN, LOCAL_ATTN, ATTN),
    n_repeats=4,
    suffix=(LOCAL_ATTN, LOCAL_ATTN),
    sliding_window=512,
    rope_theta=1_000_000.0,
    rope_local_theta=10_000.0,
    norm="rmsnorm",
    act="gelu",
    qk_norm=True,
    post_norms=True,
    scale_embedding=True,
    tie_embeddings=True,
))
