"""seamless-m4t-medium [audio] — arXiv:2308.11596.

12 encoder + 12 decoder layers, d_model=1024, 16 heads (kv=16),
d_ff=4096 (ReLU, non-gated), vocab=256206, LayerNorm.  The speech
frontend is a stub per the assignment: ``input_specs()`` provides
precomputed frame embeddings (B, frames, d_model); shapes interpret
``seq_len`` as the decoder length with encoder frames = min(seq, 4096).
"""

from .base import DEC, ENC, FrontendConfig, ModelConfig, register

SEAMLESS_M4T_MEDIUM = register(ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256_206,
    head_dim=64,
    pattern=(ENC, DEC),
    n_repeats=12,
    rope_theta=10_000.0,
    norm="layernorm",
    act="relu",
    frontend=FrontendConfig(kind="audio", n_frames=4096),
))
