"""Models in PyTorch: the attention family of the reference zoo, the
recurrent blocks and the micro models of the real execution plane."""

from .lm import (Model, build_model, decode_step, forward, init_cache,
                 init_params, prefill)
from .micro import MICRO_MODELS, make_micro_runner

__all__ = ["MICRO_MODELS", "Model", "build_model", "decode_step", "forward",
           "init_cache", "init_params", "make_micro_runner", "prefill"]
