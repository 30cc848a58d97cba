"""Configuration dataclasses for models, input shapes and meshes.

Every assigned architecture is expressed as a :class:`ModelConfig` whose
layer stack is a *pattern* of block kinds repeated ``n_repeats`` times,
optionally with fixed prefix/suffix blocks.  This uniform structure is
what lets the dry-run cost analyzer recover per-layer roofline terms by
differencing two small unrolled compiles (see launch/hlo_analysis.py):
``cost(total) = cost(base) + n_repeats · cost(pattern)``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

# ----------------------------------------------------------------------- #
# block kinds
# ----------------------------------------------------------------------- #
ATTN = "attn"            # global-attention transformer block (attn + mlp)
LOCAL_ATTN = "local"     # sliding-window attention block
MLA = "mla"              # multi-head latent attention + dense mlp
MLA_MOE = "mla_moe"      # multi-head latent attention + MoE mlp
RGLRU = "rglru"          # RG-LRU recurrent block (+ mlp)
SSM = "ssm"              # Mamba2 SSD block
ENC = "enc"              # bidirectional encoder block
DEC = "dec"              # decoder block with cross-attention

BLOCK_KINDS = (ATTN, LOCAL_ATTN, MLA, MLA_MOE, RGLRU, SSM, ENC, DEC)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0
    expert_ff: int = 0            # d_ff of each routed expert
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0          # 0 = full-rank query projection
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    conv_kernel: int = 4
    chunk_size: int = 64          # SSD chunk length
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0            # 0 = d_model
    conv_kernel: int = 4
    c_constant: float = 8.0       # the paper's fixed c in a_t = a^{c·r_t}
    gate_blocks: int = 1          # block-diagonal gate matrices (Griffin)


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Stub modality frontend: input_specs() provides precomputed embeddings."""

    kind: str                     # "vision" | "audio"
    n_prefix_tokens: int = 0      # vision: patch tokens prepended to text
    n_frames: int = 0             # audio: encoder frames (enc-dec source length)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | encdec | hybrid | ssm | vlm
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    # layer stack: prefix + pattern × n_repeats + suffix
    pattern: Tuple[str, ...]
    n_repeats: int
    prefix: Tuple[str, ...] = ()
    suffix: Tuple[str, ...] = ()

    head_dim: int = 0             # 0 = d_model // n_heads
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    norm_eps: float = 1e-6
    act: str = "silu"             # silu (SwiGLU mlp) | gelu (plain mlp)
    rope_theta: float = 10_000.0
    rope_local_theta: float = 10_000.0   # theta for LOCAL_ATTN blocks (gemma3)
    rope_pct: float = 1.0         # partial rotary (stablelm: 0.25)
    qkv_bias: bool = False        # qwen2/internvl2-style attention bias
    qk_norm: bool = False         # gemma3 query/key RMSNorm
    post_norms: bool = False      # gemma3 sandwich norms around attn/mlp
    scale_embedding: bool = False # gemma-style sqrt(d_model) embedding scale
    tie_embeddings: bool = False
    logit_softcap: float = 0.0    # gemma-style final-logit soft-capping
    sliding_window: int = 0       # window for LOCAL_ATTN blocks
    dense_ff: int = 0             # d_ff of dense prefix layers (deepseek)

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    frontend: Optional[FrontendConfig] = None

    dtype: str = "bfloat16"
    scan_layers: bool = True      # lax.scan over pattern repeats
    remat: bool = False           # checkpoint each block in training
    train_state_dtype: str = "float32"  # AdamW moments (bf16 at 671B scale)
    # beyond-paper performance knobs (EXPERIMENTS.md §Perf):
    seq_sharding: bool = False    # Megatron-SP: shard activations' seq dim
    sp_gather_heads: bool = False # SP: gather seq once pre-attention (helps
                                  # many-head MLA; hurts small-seq GQA)
    decode_seq_shard: bool = False  # keep decode scores sharded on cache S
    moe_ep: bool = False          # shard_map expert parallelism (all_to_all)
    use_pallas_kernels: bool = False  # TPU target: pallas kernels for hot ops
    attn_block_q: int = 512       # blocked-attention q tile (jnp flash pattern)
    attn_block_kv: int = 1024     # blocked-attention kv tile
    xent_chunk: int = 0           # 0 = unchunked cross-entropy

    # ------------------------------------------------------------------ #
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def layers(self) -> Tuple[str, ...]:
        return self.prefix + self.pattern * self.n_repeats + self.suffix

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    @property
    def is_encdec(self) -> bool:
        return ENC in self.pattern or DEC in self.pattern

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic archs eligible for the long_500k shape."""
        kinds = set(self.layers)
        if kinds <= {SSM, RGLRU, LOCAL_ATTN}:
            return True
        # gemma3-style local:global hybrids: global layers are a small
        # minority and decode cost is linear-per-token.
        n_global = sum(1 for k in self.layers if k == ATTN)
        return (LOCAL_ATTN in kinds or RGLRU in kinds or SSM in kinds) \
            and n_global * 3 <= self.n_layers

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self, *, n_repeats: int = 2, d_model: int = 64,
                n_heads: int = 4, d_ff: int = 128, vocab_size: int = 512,
                **kw) -> "ModelConfig":
        """A smoke-test-sized config of the same family/pattern."""
        updates: Dict = dict(
            name=self.name + "-smoke",
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=max(1, min(self.n_kv_heads, n_heads // 2)),
            d_ff=d_ff,
            vocab_size=vocab_size,
            n_repeats=n_repeats,
            head_dim=d_model // n_heads,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            dense_ff=d_ff if self.dense_ff else 0,
            scan_layers=False,
            attn_block_q=32,
            attn_block_kv=32,
        )
        if self.moe is not None:
            # capacity high enough to be dropless: smoke tests validate
            # the math; capacity-drop behaviour is covered separately
            updates["moe"] = dataclasses.replace(
                self.moe, n_experts=8, top_k=2, expert_ff=d_ff // 2,
                capacity_factor=8.0)
        if self.mla is not None:
            updates["mla"] = MLAConfig(kv_lora_rank=32, q_lora_rank=32,
                                       qk_nope_head_dim=16, qk_rope_head_dim=8,
                                       v_head_dim=16)
        if self.ssm is not None:
            updates["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=8, chunk_size=16)
        if self.rglru is not None:
            updates["rglru"] = dataclasses.replace(self.rglru, lru_width=d_model)
        if self.frontend is not None:
            updates["frontend"] = dataclasses.replace(
                self.frontend,
                n_prefix_tokens=min(self.frontend.n_prefix_tokens, 8),
                n_frames=min(self.frontend.n_frames, 32))
        updates.update(kw)
        return dataclasses.replace(self, **updates)


# ----------------------------------------------------------------------- #
# input shapes
# ----------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32,
                          kind="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32_768, global_batch=128,
                         kind="decode")
LONG_500K = ShapeConfig("long_500k", seq_len=524_288, global_batch=1,
                        kind="decode")

SHAPES: Dict[str, ShapeConfig] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


def applicable_shapes(cfg: ModelConfig) -> List[ShapeConfig]:
    """The assigned shape set for one architecture, with documented skips
    (DESIGN.md §4): long_500k only for sub-quadratic archs."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.supports_long_context:
        out.append(LONG_500K)
    return out


# ----------------------------------------------------------------------- #
# registry
# ----------------------------------------------------------------------- #
_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch config {cfg.name!r}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(_REGISTRY)}") from None


def all_configs() -> Dict[str, ModelConfig]:
    _ensure_loaded()
    return dict(_REGISTRY)


def _ensure_loaded() -> None:
    # import the per-arch modules for their registration side effects
    from . import archs  # noqa: F401
