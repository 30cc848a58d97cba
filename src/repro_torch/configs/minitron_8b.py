"""minitron-8b [dense] — arXiv:2407.14679 (pruned Nemotron-4).

32L, d_model=4096, 32 heads (GQA kv=8), d_ff=16384, vocab=256000.
Nemotron family: squared-ReLU MLP (non-gated), partial rotary (50%),
head_dim=128.  Adaptation note (DESIGN.md): LayerNorm→RMSNorm kept as
published in the HF config (norm: LayerNorm1p ≈ zero-centered RMS).
"""

from .base import ATTN, ModelConfig, register

MINITRON_8B = register(ModelConfig(
    name="minitron-8b",
    family="dense",
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=256_000,
    head_dim=128,
    pattern=(ATTN,),
    n_repeats=32,
    rope_theta=10_000.0,
    rope_pct=0.5,
    norm="layernorm",
    norm_eps=1e-5,
    act="relu2",
))
