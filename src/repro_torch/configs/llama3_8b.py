"""llama3-8b [dense] — arXiv:2407.21783.

32L, d_model=4096, 32 heads (GQA kv=8), d_ff=14336, vocab=128256,
head_dim=128, RoPE θ=500k, SwiGLU, RMSNorm.
"""

from .base import ATTN, ModelConfig, register

LLAMA3_8B = register(ModelConfig(
    name="llama3-8b",
    family="dense",
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    head_dim=128,
    pattern=(ATTN,),
    n_repeats=32,
    rope_theta=500_000.0,
    norm="rmsnorm",
    norm_eps=1e-5,
    act="silu",
))
