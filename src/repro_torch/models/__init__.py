"""Decoder models in PyTorch: the attention family of the reference zoo."""

from .lm import (Model, build_model, decode_step, forward, init_cache,
                 init_params, prefill)

__all__ = ["Model", "build_model", "decode_step", "forward", "init_cache",
           "init_params", "prefill"]
