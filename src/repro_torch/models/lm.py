"""Decoder LM assembly in PyTorch: embeddings → layer stack → head.

A port of ``repro/models/lm.py`` for decoder-only configurations: the
attention family, the DeepSeek MLA / MoE stacks (dense prefix layers
included), Mamba2 SSM and RG-LRU.  Encoder-decoder and vision inputs
come with a later slice and raise ``NotImplementedError``.

The layer stack is ``prefix + pattern × n_repeats + suffix``.  Both
parameter layouts of the reference are accepted: unrolled (a list of
repeats, each a list of per-position block trees) and stacked
(``cfg.scan_layers``: one tree per pattern position with leaves
(n_repeats, ...)), where a Python loop over the repeats takes the place
of ``lax.scan`` and reads each repeat's slice as a view.

Caches are written in place (see ``blocks``).  The public surface is
:class:`Model` (build with :func:`build_model`):

    params                    = model.init(seed, device=...)
    hidden                    = model.forward(params, batch)   # (B,S,d)
    logits                    = model.logits(params, hidden)
    logits_last, cache        = model.prefill(params, batch)
    logits, cache             = model.decode_step(params, cache, tokens, pos)
    cache                     = model.init_cache(batch, max_len, device=...)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import torch

from .. import resolve_device
from ..configs.base import MLA_MOE, ModelConfig
from .blocks import apply_block, init_block, init_block_cache, torch_dtype
from .common import apply_norm, embed_init, init_norm

PyTree = Any


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.is_encdec:
        raise NotImplementedError("encoder-decoder models not yet ported")
    if cfg.frontend is not None:
        raise NotImplementedError(f"{cfg.frontend.kind} frontends not yet "
                                  "ported")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _stack(trees: List[PyTree]) -> PyTree:
    """Stack same-structured trees leaf by leaf.  The source dicts give up
    each leaf as it is stacked, so at most one leaf is held twice (a
    full-width 9B model would otherwise peak at twice its weights; for an
    MoE layer that leaf is one (R, E, d, ff) expert stack)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t.pop(k) for t in trees]) for k in list(first)}
    return torch.stack(trees)


# --------------------------------------------------------------------- #
# parameter construction
# --------------------------------------------------------------------- #
def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> Dict:
    """Seeded random parameters in the reference's tree layout."""
    _check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = torch_dtype(cfg)
    params: Dict = {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype=dtype),
        "final_norm": init_norm(cfg.d_model, cfg.norm, dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = embed_init(gen, (cfg.d_model, cfg.vocab_size),
                                    dtype=dtype)
    # prefix and suffix blocks take a dense MLP; pattern blocks do not
    params["prefix"] = [init_block(gen, cfg, k, dense_layer=True)
                        for k in cfg.prefix]
    params["suffix"] = [init_block(gen, cfg, k, dense_layer=True)
                        for k in cfg.suffix]
    layers = [[init_block(gen, cfg, kind) for kind in cfg.pattern]
              for _ in range(cfg.n_repeats)]
    if cfg.scan_layers:
        # one stacked tree per pattern position: leaves (R, ...)
        params["pattern"] = [_stack([layers[r][j]
                                     for r in range(cfg.n_repeats)])
                             for j in range(len(cfg.pattern))]
    else:
        params["pattern"] = layers
    return params


def param_count(params: PyTree) -> int:
    return sum(t.numel() for t in _leaves(params))


def active_param_count(cfg: ModelConfig, params: PyTree) -> int:
    """Parameters touched per token (MoE: top_k + shared experts only)."""
    total = param_count(params)
    if cfg.moe is None:
        return total
    moe = cfg.moe
    n_moe_layers = sum(1 for k in cfg.layers if k == MLA_MOE)
    per_expert = 3 * cfg.d_model * moe.expert_ff
    inactive = n_moe_layers * (moe.n_experts - moe.top_k) * per_expert
    return total - inactive


# --------------------------------------------------------------------- #
# caches
# --------------------------------------------------------------------- #
def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda") -> Dict:
    _check_supported(cfg)
    dev = resolve_device(device)

    def one(kind):
        return init_block_cache(cfg, kind, batch, max_len, dev)

    cache: Dict = {
        "prefix": [one(k) for k in cfg.prefix],
        "suffix": [one(k) for k in cfg.suffix],
    }
    if cfg.scan_layers:
        cache["pattern"] = [
            _tree_map(lambda a: a.new_zeros((cfg.n_repeats, *a.shape)),
                      one(k))
            for k in cfg.pattern]
    else:
        cache["pattern"] = [[one(k) for k in cfg.pattern]
                            for _ in range(cfg.n_repeats)]
    return cache


# --------------------------------------------------------------------- #
# stack execution
# --------------------------------------------------------------------- #
def _run_stack(params_list, kinds, x, cfg, *, mode, positions=None,
               pos=None, caches=None):
    for i, kind in enumerate(kinds):
        c = caches[i] if caches is not None else None
        x, _ = apply_block(params_list[i], x, cfg, kind, mode=mode,
                           positions=positions, pos=pos, cache=c)
    return x


def _run_pattern(params, x, cfg: ModelConfig, *, mode, positions=None,
                 pos=None, caches=None):
    """Run the pattern × n_repeats segment (stacked or unrolled)."""
    kinds = cfg.pattern
    if not kinds or cfg.n_repeats == 0:
        return x
    stacked = params["pattern"]
    for r in range(cfg.n_repeats):
        if cfg.scan_layers:
            layer_params = [_tree_map(lambda a: a[r], p) for p in stacked]
            layer_caches = ([_tree_map(lambda a: a[r], c) for c in caches]
                            if caches is not None else None)
        else:
            layer_params = stacked[r]
            layer_caches = caches[r] if caches is not None else None
        x = _run_stack(layer_params, kinds, x, cfg, mode=mode,
                       positions=positions, pos=pos, caches=layer_caches)
    return x


# --------------------------------------------------------------------- #
# embeddings / head
# --------------------------------------------------------------------- #
def embed_tokens(params, tokens, cfg: ModelConfig):
    dtype = torch_dtype(cfg)
    x = params["embed"][tokens].to(dtype)
    if cfg.scale_embedding:
        # the scale is rounded to the model dtype first, as the reference
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=dtype))
    return x


def head_weights(params, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["head"]


def apply_head(params, hidden, cfg: ModelConfig):
    logits = (hidden @ head_weights(params, cfg)).float()
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


# --------------------------------------------------------------------- #
# forward passes
# --------------------------------------------------------------------- #
def _decoder_positions(x):
    B, S = x.shape[0], x.shape[1]
    return torch.arange(S, dtype=torch.int32,
                        device=x.device)[None].expand(B, S)


def forward(params, batch, cfg: ModelConfig):
    """Full-sequence forward → final hidden states (B, S, d)."""
    _check_supported(cfg)
    mode = "train"
    x = embed_tokens(params, batch["tokens"], cfg)
    positions = _decoder_positions(x)
    x = _run_stack(params["prefix"], cfg.prefix, x, cfg, mode=mode,
                   positions=positions)
    x = _run_pattern(params, x, cfg, mode=mode, positions=positions)
    x = _run_stack(params["suffix"], cfg.suffix, x, cfg, mode=mode,
                   positions=positions)
    return apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)


def prefill(params, batch, cfg: ModelConfig, max_len: Optional[int] = None):
    """Process the prompt, build the cache, return last-token logits."""
    _check_supported(cfg)
    mode = "prefill"
    x = embed_tokens(params, batch["tokens"], cfg)
    B, S = x.shape[0], x.shape[1]
    cache = init_cache(cfg, B, max_len or S, device=x.device)
    positions = _decoder_positions(x)
    x = _run_stack(params["prefix"], cfg.prefix, x, cfg, mode=mode,
                   positions=positions, caches=cache["prefix"])
    x = _run_pattern(params, x, cfg, mode=mode, positions=positions,
                     caches=cache["pattern"])
    x = _run_stack(params["suffix"], cfg.suffix, x, cfg, mode=mode,
                   positions=positions, caches=cache["suffix"])
    hidden = apply_norm(params["final_norm"], x[:, -1:], cfg.norm,
                        cfg.norm_eps)
    return apply_head(params, hidden, cfg), cache


def decode_step(params, cache, tokens, pos: int, cfg: ModelConfig):
    """One decode step. tokens: (B, 1); pos: int write position.  The
    cache is updated in place and returned."""
    _check_supported(cfg)
    mode = "decode"
    pos = int(pos)
    x = embed_tokens(params, tokens, cfg)
    x = _run_stack(params["prefix"], cfg.prefix, x, cfg, mode=mode,
                   pos=pos, caches=cache["prefix"])
    x = _run_pattern(params, x, cfg, mode=mode, pos=pos,
                     caches=cache["pattern"])
    x = _run_stack(params["suffix"], cfg.suffix, x, cfg, mode=mode,
                   pos=pos, caches=cache["suffix"])
    hidden = apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    return apply_head(params, hidden, cfg), cache


# --------------------------------------------------------------------- #
# model facade
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, seed: int = 0, *, device="cuda") -> Dict:
        return init_params(self.cfg, seed, device=device)

    def forward(self, params, batch):
        return forward(params, batch, self.cfg)

    def logits(self, params, hidden):
        return apply_head(params, hidden, self.cfg)

    def prefill(self, params, batch, max_len: Optional[int] = None):
        return prefill(params, batch, self.cfg, max_len)

    def decode_step(self, params, cache, tokens, pos):
        return decode_step(params, cache, tokens, pos, self.cfg)

    def init_cache(self, batch: int, max_len: int, *, device="cuda"):
        return init_cache(self.cfg, batch, max_len, device=device)


def build_model(cfg: ModelConfig) -> Model:
    _check_supported(cfg)
    return Model(cfg)


__all__ = ["Model", "active_param_count", "apply_head", "build_model",
           "decode_step", "embed_tokens", "forward", "head_weights",
           "init_cache", "init_params", "param_count", "prefill"]
