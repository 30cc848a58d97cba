"""Models in PyTorch: every family of the reference zoo (the attention
family, DeepSeek MLA with dense and MoE FFNs, Mamba2 SSM, RG-LRU, the
encoder-decoder and the vision prefix, whose frontends are stubs as in
the reference) and the micro models of the real execution plane."""

from .lm import (Model, build_model, decode_step, forward, init_cache,
                 init_params, prefill)
from .micro import MICRO_MODELS, make_micro_runner

__all__ = ["MICRO_MODELS", "Model", "build_model", "decode_step", "forward",
           "init_cache", "init_params", "make_micro_runner", "prefill"]
