"""mamba2-130m [ssm] — arXiv:2405.21060 (SSD / state-space duality).

24L attention-free, d_model=768, d_state=128, expand=2 (d_inner=1536,
24 SSD heads of head_dim 64), conv kernel 4, vocab=50280, tied
embeddings.  n_heads/n_kv_heads are unused by the SSM family.
"""

from .base import SSM, ModelConfig, SSMConfig, register

MAMBA2_130M = register(ModelConfig(
    name="mamba2-130m",
    family="ssm",
    d_model=768,
    n_heads=24,
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50_280,
    head_dim=64,
    pattern=(SSM,),
    n_repeats=24,
    norm="rmsnorm",
    act="silu",
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, conv_kernel=4,
                  chunk_size=64, n_groups=1),
))
