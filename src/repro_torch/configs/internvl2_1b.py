"""internvl2-1b [vlm] — arXiv:2404.16821.

Transformer backbone only (Qwen2-0.5B-style LM): 24L, d_model=896,
14 heads (GQA kv=2), d_ff=4864, vocab=151655, qkv bias, RoPE θ=1M,
tied embeddings.  The InternViT frontend is a stub per the assignment:
``input_specs()`` provides 256 precomputed patch embeddings per image,
prepended to the text tokens.
"""

from .base import ATTN, FrontendConfig, ModelConfig, register

INTERNVL2_1B = register(ModelConfig(
    name="internvl2-1b",
    family="vlm",
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151_655,
    head_dim=64,
    pattern=(ATTN,),
    n_repeats=24,
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    act="silu",
    qkv_bias=True,
    tie_embeddings=True,
    frontend=FrontendConfig(kind="vision", n_prefix_tokens=256),
))
