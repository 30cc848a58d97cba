"""deepseek-v3-671b [moe] — arXiv:2412.19437.

61L (3 dense + 58 MoE), d_model=7168, 128 heads, MLA (kv_lora=512,
q_lora=1536), 1 shared + 256 routed experts top-8, expert_ff=2048,
dense layer d_ff=18432, vocab=129280.  The MTP (multi-token-prediction)
auxiliary head is out of scope for serving (DESIGN.md §Arch-applicability).
"""

from .base import MLA, MLA_MOE, MLAConfig, ModelConfig, MoEConfig, register

DEEPSEEK_V3_671B = register(ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=2048,
    dense_ff=18432,
    vocab_size=129_280,
    prefix=(MLA, MLA, MLA),
    pattern=(MLA_MOE,),
    n_repeats=58,
    rope_theta=10_000.0,
    norm="rmsnorm",
    act="silu",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, n_shared=1, expert_ff=2048,
                  capacity_factor=1.25),
))
