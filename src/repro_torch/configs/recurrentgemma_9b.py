"""recurrentgemma-9b [hybrid] — arXiv:2402.19427 (Griffin).

38L in a (RG-LRU, RG-LRU, local-attention) 2:1 pattern (12 repeats + 2
trailing recurrent blocks), d_model=4096, 16 heads MQA (kv=1,
head_dim=256), window=2048, d_ff=12288 (GeGLU), lru_width=4096,
vocab=256000, scaled embeddings.
"""

from .base import LOCAL_ATTN, RGLRU, ModelConfig, RGLRUConfig, register

RECURRENTGEMMA_9B = register(ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256_000,
    head_dim=256,
    pattern=(RGLRU, RGLRU, LOCAL_ATTN),
    n_repeats=12,
    suffix=(RGLRU, RGLRU),
    sliding_window=2048,
    rope_theta=10_000.0,
    norm="rmsnorm",
    act="gelu",
    scale_embedding=True,
    tie_embeddings=True,
    rglru=RGLRUConfig(lru_width=4096, conv_kernel=4, c_constant=8.0,
                      gate_blocks=16),
))
