"""Model assembly in PyTorch: embeddings → layer stack → head.

A port of ``repro/models/lm.py`` for every family of the reference zoo:
the attention family, the DeepSeek MLA / MoE stacks (dense prefix layers
included), Mamba2 SSM, RG-LRU, the encoder-decoder (pattern ``(ENC,
DEC)``: two stacks that share ``n_repeats``, the encoder over
precomputed audio frames) and the vision prefix (precomputed patch
embeddings in front of the text).  The frontends are stubs, as in the
reference: :func:`input_specs` names the embeddings a batch carries.

The layer stack is ``prefix + pattern × n_repeats + suffix``.  Both
parameter layouts of the reference are accepted: unrolled (a list of
repeats, each a list of per-position block trees) and stacked
(``cfg.scan_layers``: one tree per pattern position with leaves
(n_repeats, ...)), where a Python loop over the repeats takes the place
of ``lax.scan`` and reads each repeat's slice as a view.

Caches are written in place (see ``blocks``); an encoder-decoder cache
holds ``None`` at the ENC positions, and its DEC caches are written
through the full-pattern structure, so nothing is merged back.  The
public surface is :class:`Model` (build with :func:`build_model`):

    params                    = model.init(seed, device=...)
    hidden                    = model.forward(params, batch)   # (B,S,d)
    logits                    = model.logits(params, hidden)
    logits_last, cache        = model.prefill(params, batch)
    logits, cache             = model.decode_step(params, cache, tokens, pos)
    cache                     = model.init_cache(batch, max_len,
                                                 memory_len=..., device=...)
    batch_specs               = model.input_specs(shape)   # meta tensors
    cache_specs               = model.cache_specs(shape)   # meta tensors
    param_specs               = model.param_specs()        # meta tensors

``cfg.remat`` recomputes each block of a train-mode forward in the
backward (``torch.utils.checkpoint``), as the reference rematerialises
each block.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..configs.base import DEC, ENC, MLA_MOE, ModelConfig, ShapeConfig
from .blocks import apply_block, init_block, init_block_cache, torch_dtype
from .common import apply_norm, embed_init, init_norm, shard_seq

PyTree = Any


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
class _MetaGenerator:
    """Stands in for a ``torch.Generator`` on the meta device, which has
    none: the initializers read its ``device`` and draw nothing there."""
    device = torch.device("meta")


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> Dict:
    """Seeded random parameters in the reference's tree layout; on
    ``device="meta"`` their shapes and dtypes only (:func:`param_specs`)."""
    dev = resolve_device(device)
    gen = (_MetaGenerator() if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    dtype = torch_dtype(cfg)
    params: Dict = {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype=dtype),
        "final_norm": init_norm(cfg.d_model, cfg.norm, dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = embed_init(gen, (cfg.d_model, cfg.vocab_size),
                                    dtype=dtype)
    if cfg.is_encdec:
        params["enc_final_norm"] = init_norm(cfg.d_model, cfg.norm, dev)
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
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               memory_len: int = 0, *, device="cuda") -> Dict:
    """Zeroed caches of ``max_len`` slots; a DEC block's also holds the
    K/V of ``memory_len`` encoder frames, and an ENC position is None."""
    dev = resolve_device(device)

    def one(kind):
        return init_block_cache(cfg, kind, batch, max_len, memory_len, dev)

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
               pos=None, caches=None, memory=None):
    """Run blocks in turn.  ``cfg.remat`` in train mode recomputes each
    block in the backward instead of keeping its activations (the
    reference's per-block ``jax.checkpoint``); a train block has no
    cache."""
    remat = cfg.remat and mode == "train"
    # the sequence-parallel activation constraint between blocks
    sp = cfg.seq_sharding and mode in ("train", "prefill")
    for i, kind in enumerate(kinds):
        c = caches[i] if caches is not None else None
        if remat:
            def block(p, h, kind=kind):
                h = apply_block(p, h, cfg, kind, mode=mode,
                                positions=positions, pos=pos, cache=None,
                                memory=memory)[0]
                return shard_seq(h) if sp else h
            x = checkpoint(block, params_list[i], x, use_reentrant=False)
        else:
            x, _ = apply_block(params_list[i], x, cfg, kind, mode=mode,
                               positions=positions, pos=pos, cache=c,
                               memory=memory)
            if sp:
                x = shard_seq(x)
    return x


def _run_pattern(params, x, cfg: ModelConfig, *, mode, positions=None,
                 pos=None, caches=None, memory=None, kinds=None,
                 pattern_params=None):
    """Run the pattern × n_repeats segment (stacked or unrolled).
    ``kinds`` and ``pattern_params`` select one stack of an
    encoder-decoder pattern (see :func:`_encdec_pattern_params`)."""
    kinds = kinds if kinds is not None else cfg.pattern
    stacked = (pattern_params if pattern_params is not None
               else params["pattern"])
    if not kinds or cfg.n_repeats == 0:
        return x
    for r in range(cfg.n_repeats):
        if cfg.scan_layers:
            layer_params = [_tree_map(lambda a: a[r], p) for p in stacked]
            layer_caches = ([_tree_map(lambda a: a[r], c) for c in caches]
                            if caches is not None else None)
        else:
            layer_params = stacked[r]
            layer_caches = caches[r] if caches is not None else None
        x = _run_stack(layer_params, kinds, x, cfg, mode=mode,
                       positions=positions, pos=pos, caches=layer_caches,
                       memory=memory)
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


def _assemble_inputs(params, batch, cfg: ModelConfig):
    """tokens (+ modality prefix) → embedded sequence (B, S, d)."""
    x = embed_tokens(params, batch["tokens"], cfg)
    if cfg.frontend is not None and cfg.frontend.kind == "vision" \
            and "vision_embeds" in batch:
        x = torch.cat([batch["vision_embeds"].to(x.dtype), x], dim=1)
    return x


def _positions_of(cfg: ModelConfig, kind: str):
    return [j for j, k in enumerate(cfg.pattern) if k == kind]


def _encdec_pattern_params(params, cfg: ModelConfig):
    """Split the interleaved (ENC, DEC) pattern params into two stacks."""
    enc_idx, dec_idx = _positions_of(cfg, ENC), _positions_of(cfg, DEC)
    if cfg.scan_layers:
        return ([params["pattern"][j] for j in enc_idx],
                [params["pattern"][j] for j in dec_idx])
    enc = [[layer[j] for j in enc_idx] for layer in params["pattern"]]
    dec = [[layer[j] for j in dec_idx] for layer in params["pattern"]]
    return enc, dec


def _dec_caches(caches, cfg: ModelConfig):
    """Select the DEC positions from a full-pattern cache structure (the
    same dicts: a write through them lands in the full cache)."""
    dec_idx = _positions_of(cfg, DEC)
    if cfg.scan_layers:
        return [caches[j] for j in dec_idx]
    return [[layer[j] for j in dec_idx] for layer in caches]


def encode(params, batch, cfg: ModelConfig):
    """Encoder stack over precomputed frame embeddings (audio stub)."""
    mem = batch["frames"].to(torch_dtype(cfg))
    enc_params, _ = _encdec_pattern_params(params, cfg)
    mem = _run_pattern(params, mem, cfg, mode="train",
                       positions=_decoder_positions(mem), kinds=(ENC,),
                       pattern_params=enc_params)
    return apply_norm(params["enc_final_norm"], mem, cfg.norm, cfg.norm_eps)


def _run_layers(params, x, cfg: ModelConfig, cache, **kw):
    """prefix + pattern + suffix; an encoder-decoder runs its DEC stack
    only (the encoder ran in :func:`encode`)."""
    caches = cache or {}
    x = _run_stack(params["prefix"], cfg.prefix, x, cfg,
                   caches=caches.get("prefix"), **kw)
    if cfg.is_encdec:
        _, dec_params = _encdec_pattern_params(params, cfg)
        pattern = caches.get("pattern")
        x = _run_pattern(params, x, cfg, kinds=(DEC,),
                         pattern_params=dec_params,
                         caches=(_dec_caches(pattern, cfg)
                                 if pattern is not None else None), **kw)
    else:
        x = _run_pattern(params, x, cfg, caches=caches.get("pattern"), **kw)
    return _run_stack(params["suffix"], cfg.suffix, x, cfg,
                      caches=caches.get("suffix"), **kw)


def forward(params, batch, cfg: ModelConfig):
    """Full-sequence forward → final hidden states (B, S, d)."""
    memory = encode(params, batch, cfg) if cfg.is_encdec else None
    x = _assemble_inputs(params, batch, cfg)
    x = _run_layers(params, x, cfg, None, mode="train",
                    positions=_decoder_positions(x), memory=memory)
    return apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)


def prefill(params, batch, cfg: ModelConfig, max_len: Optional[int] = None):
    """Process the prompt, build the cache, return last-token logits.  An
    encoder-decoder's cross cache holds its ``frames``' length.  DTensor
    parameters (``distributed.sharding``'s ``params_pspecs``) run the
    step on their mesh, as :func:`decode_step`: the cache is then built
    as DTensors laid out by ``cache_pspecs`` and the logits come back
    laid out by ``batch_pspecs`` (the reference's ``out_shardings``)."""
    from ..distributed.sharding import (batch_pspecs, cache_pspecs,
                                        current_mesh, sharded_step,
                                        sharded_zeros, to_placements)
    with sharded_step(params["embed"]):
        memory = encode(params, batch, cfg) if cfg.is_encdec else None
        x = _assemble_inputs(params, batch, cfg)
        B, S = x.shape[0], x.shape[1]
        mem_len = memory.shape[1] if memory is not None else 0
        mesh = current_mesh() if isinstance(x, DTensor) else None
        if mesh is None:
            cache = init_cache(cfg, B, max_len or S, mem_len,
                               device=x.device)
        else:
            shapes = init_cache(cfg, B, max_len or S, mem_len,
                                device="meta")
            cache = sharded_zeros(shapes, cache_pspecs(cfg, shapes, mesh),
                                  mesh, device=x.device)
        x = _run_layers(params, x, cfg, cache, mode="prefill",
                        positions=_decoder_positions(x), memory=memory)
        hidden = apply_norm(params["final_norm"], x[:, -1:], cfg.norm,
                            cfg.norm_eps)
        logits = apply_head(params, hidden, cfg)
        if mesh is not None:
            logits = logits.redistribute(mesh, to_placements(
                mesh, batch_pspecs(logits, mesh)))
        return logits, cache


def decode_step(params, cache, tokens, pos: int, cfg: ModelConfig):
    """One decode step. tokens: (B, 1); pos: int write position.  The
    cache is updated in place and returned.  DTensor parameters and
    cache (``distributed.sharding``'s ``params_pspecs`` and
    ``cache_pspecs``) run the step on their mesh; the logits are then a
    DTensor with the plain step's values."""
    from ..distributed.sharding import sharded_step
    with sharded_step(params["embed"]):
        x = embed_tokens(params, tokens, cfg)
        x = _run_layers(params, x, cfg, cache, mode="decode", pos=int(pos))
        hidden = apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
        return apply_head(params, hidden, cfg), cache


# --------------------------------------------------------------------- #
# input specs (shapes and dtypes only: meta tensors, no allocation)
# --------------------------------------------------------------------- #
def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, torch.Tensor]:
    """The batch a step of ``shape`` takes, as meta tensors: the
    reference's ``jax.ShapeDtypeStruct``s.  A vision prompt is
    ``n_prefix_tokens`` patch embeddings then S − P tokens; an
    encoder-decoder prompt is min(S, n_frames) frames and S tokens."""
    B, S = shape.global_batch, shape.seq_len
    i32, dt = torch.int32, torch_dtype(cfg)

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind == "decode":
        return {"tokens": spec((B, 1), i32)}
    specs: Dict[str, torch.Tensor] = {}
    if cfg.frontend is not None and cfg.frontend.kind == "vision":
        P = cfg.frontend.n_prefix_tokens
        specs["vision_embeds"] = spec((B, P, cfg.d_model), dt)
        specs["tokens"] = spec((B, S - P), i32)
    elif cfg.is_encdec:
        n_frames = min(S, cfg.frontend.n_frames) if cfg.frontend else S
        specs["frames"] = spec((B, n_frames, cfg.d_model), dt)
        specs["tokens"] = spec((B, S), i32)
    else:
        specs["tokens"] = spec((B, S), i32)
    if shape.kind == "train":
        specs["labels"] = spec((B, S), i32)
    return specs


def param_specs(cfg: ModelConfig) -> PyTree:
    """The parameter tree as meta tensors (the reference's
    ``eval_shape`` of ``init``): built on the meta device, no storage."""
    return init_params(cfg, device="meta")


def cache_specs(cfg: ModelConfig, shape: ShapeConfig) -> PyTree:
    """The decode cache of ``shape`` as meta tensors (dry-run stand-ins);
    an encoder-decoder's cross cache holds min(4096, S) frames, as the
    reference's."""
    B, S = shape.global_batch, shape.seq_len
    mem_len = min(4096, S) if cfg.is_encdec else 0
    return init_cache(cfg, B, S, mem_len, device="meta")


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

    def init_cache(self, batch: int, max_len: int, memory_len: int = 0, *,
                   device="cuda"):
        return init_cache(self.cfg, batch, max_len, memory_len,
                          device=device)

    def input_specs(self, shape: ShapeConfig):
        return input_specs(self.cfg, shape)

    def cache_specs(self, shape: ShapeConfig):
        return cache_specs(self.cfg, shape)

    def param_specs(self):
        return param_specs(self.cfg)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)


__all__ = ["Model", "active_param_count", "apply_head", "build_model",
           "cache_specs", "decode_step", "embed_tokens", "encode", "forward",
           "head_weights", "init_cache", "init_params", "input_specs",
           "param_count", "param_specs", "prefill"]
