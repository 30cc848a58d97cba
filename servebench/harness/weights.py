"""Seeded weights, made by the benchmark and handed to both sides.

The weights are drawn on the device from ``--seed`` in one call a leaf
(the layers' leaves are stacked, so a model is ~15 calls), in the type
they are served in.  Matrices are normal with a fan-in scale (embedding
and head 0.02, as the program's own initializer); the norms' scales and
biases are perturbed (LayerNorm scale 1 + 0.1·N, bias 0.1·N) so that
the comparison sees every norm parameter at work.

Names are the benchmark's: ``layers.<leaf>`` holds a leaf of every layer
stacked on a leading axis.  :func:`program_params` lays them out as the
program's parameter tree; the reference reads them by name.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def specs(conf: Dict) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, kind, scale) of every leaf; kind is "normal" (scaled
    normal in the model dtype), "scale" (1 + scale·N, float32) or
    "noise" (scale·N, float32).  The block is the configurations' own:
    squared-ReLU MLP, no query/key norms; another raises."""
    if conf["act"] != "relu2" or conf["qk_norm"]:
        raise ValueError("servebench: the reference has no block with "
                         f"act={conf['act']!r}, qk_norm={conf['qk_norm']}")
    d, H, Hkv, D, ff, V, L = (conf["d_model"], conf["n_heads"],
                              conf["n_kv_heads"], conf["head_dim"],
                              conf["d_ff"], conf["vocab_size"],
                              conf["n_layers"])
    out = [("embed", (V, d), "normal", 0.02),
           ("head", (d, V), "normal", 0.02),
           ("final_norm.scale", (d,), "scale", 0.1),
           ("final_norm.bias", (d,), "noise", 0.1)]
    for norm in ("pre_attn", "pre_mlp"):
        out += [(f"layers.{norm}.scale", (L, d), "scale", 0.1),
                (f"layers.{norm}.bias", (L, d), "noise", 0.1)]
    out += [("layers.wq", (L, d, H, D), "normal", 1 / math.sqrt(d)),
            ("layers.wk", (L, d, Hkv, D), "normal", 1 / math.sqrt(d)),
            ("layers.wv", (L, d, Hkv, D), "normal", 1 / math.sqrt(d)),
            ("layers.wo", (L, H, D, d), "normal", 1 / math.sqrt(H * D))]
    out += [("layers.up", (L, d, ff), "normal", 1 / math.sqrt(d)),
            ("layers.down", (L, ff, d), "normal", 1 / math.sqrt(ff))]
    return out


def make(conf: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf, drawn from one generator on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = getattr(torch, conf["dtype"])
    out = {}
    for name, shape, kind, scale in specs(conf):
        if kind == "normal":
            t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
            out[name] = t.mul_(scale)
        else:
            t = torch.randn(shape, generator=gen, device=device)
            out[name] = t.mul_(scale).add_(1.0) if kind == "scale" \
                else t.mul_(scale)
    return out


def program_params(w: Dict[str, torch.Tensor], conf: Dict) -> Dict:
    """The program's parameter tree (``repro_torch.models.lm``, stacked
    layers of one ATTN pattern position) over the same tensors."""
    def norm(prefix):
        return {"scale": w[prefix + ".scale"], "bias": w[prefix + ".bias"]}

    attn = {k: w[f"layers.{k}"] for k in ("wq", "wk", "wv", "wo")}
    mlp = {k: w[f"layers.{k}"] for k in ("up", "down")}
    block = {"pre_attn": norm("layers.pre_attn"), "attn": attn,
             "pre_mlp": norm("layers.pre_mlp"), "mlp": mlp}
    return {"embed": w["embed"], "final_norm": norm("final_norm"),
            "head": w["head"], "prefix": [], "suffix": [],
            "pattern": [block]}


def same_layout(tree, spec_tree, path: str = "") -> None:
    """Raise unless ``tree`` has the structure, shapes and dtypes of the
    program's ``param_specs`` tree."""
    if isinstance(spec_tree, dict):
        if not isinstance(tree, dict) or set(tree) != set(spec_tree):
            raise ValueError(f"parameter tree differs at {path or '/'}: "
                             f"{sorted(tree)} vs {sorted(spec_tree)}")
        for k in spec_tree:
            same_layout(tree[k], spec_tree[k], f"{path}/{k}")
    elif isinstance(spec_tree, (list, tuple)):
        if len(tree) != len(spec_tree):
            raise ValueError(f"parameter tree differs at {path}")
        for i, (a, b) in enumerate(zip(tree, spec_tree)):
            same_layout(a, b, f"{path}/{i}")
    elif tuple(tree.shape) != tuple(spec_tree.shape) \
            or tree.dtype != spec_tree.dtype:
        raise ValueError(f"{path}: {tuple(tree.shape)} {tree.dtype} vs the "
                         f"program's {tuple(spec_tree.shape)} "
                         f"{spec_tree.dtype}")
