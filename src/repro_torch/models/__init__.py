"""Models in PyTorch: every family of the reference zoo (the attention
family, DeepSeek MLA with dense and MoE FFNs, Mamba2 SSM, RG-LRU, the
encoder-decoder and the vision prefix, whose frontends are stubs as in
the reference) and the micro models of the real execution plane."""

from .lm import (Model, active_param_count, build_model, cache_specs,
                 decode_step, forward, init_cache, init_params, input_specs,
                 param_count, param_specs, prefill)
from .micro import MICRO_MODELS, make_micro_runner

__all__ = ["MICRO_MODELS", "Model", "active_param_count", "build_model",
           "cache_specs", "decode_step", "forward", "init_cache",
           "init_params", "input_specs", "make_micro_runner", "param_count",
           "param_specs", "prefill"]
