"""deepseek-v2-236b [moe] — arXiv:2405.04434.

60L (1 dense + 59 MoE), d_model=5120, 128 heads, MLA (kv_lora=512,
q_lora=1536, qk_nope=128, qk_rope=64, v=128), 2 shared + 160 routed
experts top-6, expert_ff=1536, dense layer d_ff=12288, vocab=102400.
"""

from .base import MLA, MLA_MOE, MLAConfig, ModelConfig, MoEConfig, register

DEEPSEEK_V2_236B = register(ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=1536,
    dense_ff=12288,
    vocab_size=102_400,
    prefix=(MLA,),
    pattern=(MLA_MOE,),
    n_repeats=59,
    rope_theta=10_000.0,
    norm="rmsnorm",
    act="silu",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, n_shared=2, expert_ff=1536,
                  capacity_factor=1.25),
))
