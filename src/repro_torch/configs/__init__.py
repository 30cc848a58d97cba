"""Config registry: one module per assigned architecture + shape/mesh defs."""

from .base import (ATTN, DEC, ENC, LOCAL_ATTN, MLA, MLA_MOE, RGLRU, SSM,
                   DECODE_32K, LONG_500K, PREFILL_32K, SHAPES, TRAIN_4K,
                   FrontendConfig, MLAConfig, ModelConfig, MoEConfig,
                   RGLRUConfig, SSMConfig, ShapeConfig, all_configs,
                   applicable_shapes, get_config, register)

__all__ = [
    "ATTN", "DEC", "ENC", "LOCAL_ATTN", "MLA", "MLA_MOE", "RGLRU", "SSM",
    "DECODE_32K", "LONG_500K", "PREFILL_32K", "SHAPES", "TRAIN_4K",
    "FrontendConfig", "MLAConfig", "ModelConfig", "MoEConfig", "RGLRUConfig",
    "SSMConfig", "ShapeConfig", "all_configs", "applicable_shapes",
    "get_config", "register",
]
