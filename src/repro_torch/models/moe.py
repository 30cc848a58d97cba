"""Mixture-of-experts layer in PyTorch (DeepSeek-V2/V3: shared + routed).

A port of ``repro/models/moe.py`` with the reference's capacity-tile
semantics: token→expert assignments become per-expert index lists
(capacity-bounded, leftmost token first), tokens are gathered into
(E, C, d) tiles through a zero sentinel row, every expert's tile runs
through its stacked GLU, and the results are combined weighted by the
router gates.  Same drops, same outputs; every expert's tile is computed.

Two points differ in how, not in what:

* Top-k takes the first k of a **stable** descending sort, so tied
  probabilities go to the lower expert index, as ``jax.lax.top_k``
  breaks them (``torch.topk`` promises no order).
* The combine gathers each token's k slots and sums them in ascending
  expert order, in the output dtype, instead of a scatter-add over
  (T+1, d): ``index_add_`` uses atomics on CUDA, so its sums would vary
  from run to run.  The order is the reference's (its scatter adds the
  flattened (E, C) rows in turn, and a token's k experts are distinct).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..configs.base import ModelConfig, MoEConfig
from .common import _ACTS, dense_init


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict:
    """The reference's tree: ``router`` fp32 (d, E), ``gate``/``up``
    (E, d, ff), ``down`` (E, ff, d) and ``shared.{gate,up,down}``."""
    moe = cfg.moe
    if moe is None:
        raise ValueError(f"{cfg.name}: init_moe needs cfg.moe")
    d, ff, e = cfg.d_model, moe.expert_ff, moe.n_experts
    params = {
        "router": dense_init(gen, (d, e), dtype=torch.float32),
        "gate": dense_init(gen, (e, d, ff), in_axis=1, dtype=dtype),
        "up": dense_init(gen, (e, d, ff), in_axis=1, dtype=dtype),
        "down": dense_init(gen, (e, ff, d), in_axis=1, dtype=dtype),
    }
    if moe.n_shared:
        sff = moe.expert_ff * moe.n_shared
        params["shared"] = {
            "gate": dense_init(gen, (d, sff), dtype=dtype),
            "up": dense_init(gen, (d, sff), dtype=dtype),
            "down": dense_init(gen, (sff, d), dtype=dtype),
        }
    return params


def router_probs(params, x, moe: MoEConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing with renormalized softmax gates (DeepSeek style).

    x: (T, d) → gates (T, k) fp32, experts (T, k) int64.
    """
    logits = x.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = gates[:, :moe.top_k], experts[:, :moe.top_k]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return gates, experts


def capacity(n_tokens: int, moe: MoEConfig) -> int:
    c = int(math.ceil(n_tokens * moe.top_k * moe.capacity_factor / moe.n_experts))
    return max(4, min(n_tokens, c))


def _dispatch(experts, gates, n_experts: int, cap: int):
    """:func:`moe_dispatch_indices`, plus each assignment's slot in its
    expert's tile: pos (T·k,) its rank among the assignments to its
    expert in token order (leftmost token first) and keep (T·k,) pos < cap.
    """
    T, k = experts.shape
    dev = experts.device
    flat_e = experts.reshape(-1).long()
    onehot = torch.nn.functional.one_hot(flat_e, n_experts)     # (T·k, E)
    pos_in_expert = torch.cumsum(onehot, dim=0) - onehot
    pos = torch.gather(pos_in_expert, 1, flat_e[:, None])[:, 0]
    keep = pos < cap                                   # capacity drop
    # dropped assignments write the extra row/column that is cut off; each
    # kept one has a cell of its own, so no result depends on write order
    rows = torch.where(keep, flat_e, n_experts)
    cols = torch.where(keep, pos, cap)
    flat_t = torch.arange(T, dtype=torch.int32, device=dev).repeat_interleave(k)
    idx = torch.full((n_experts + 1, cap + 1), T, dtype=torch.int32,
                     device=dev)
    idx[rows, cols] = flat_t
    gate_grid = torch.zeros((n_experts + 1, cap + 1), dtype=torch.float32,
                            device=dev)
    gate_grid[rows, cols] = gates.reshape(-1).float()
    return idx[:n_experts, :cap], gate_grid[:n_experts, :cap], pos, keep


def moe_dispatch_indices(experts, gates, n_experts: int, cap: int):
    """Build per-expert gather indices from (T, k) assignments.

    Returns idx (E, C) int32 token ids (T = sentinel for empty slots),
    slot_gate (E, C) fp32 gather weights.
    """
    return _dispatch(experts, gates, n_experts, cap)[:2]


def apply_moe(params, x, cfg: ModelConfig):
    """x: (B, S, d) → (B, S, d)."""
    moe = cfg.moe
    B, S, d = x.shape
    T, E = B * S, moe.n_experts
    xt = x.reshape(T, d)
    gates, experts = router_probs(params, xt, moe)
    cap = capacity(T, moe)
    idx, slot_gate, pos, keep = _dispatch(experts, gates, E, cap)

    # gather tokens into (E, C, d); sentinel slots gather the zero row
    xp = torch.cat([xt, xt.new_zeros((1, d))])
    tiles = xp[idx.reshape(-1)].view(E, cap, d)
    act = _ACTS[cfg.act]
    h = act(torch.bmm(tiles, params["gate"])) * torch.bmm(tiles, params["up"])
    y = torch.bmm(h, params["down"])
    y = y * slot_gate[..., None].to(y.dtype)

    # combine: each token's k slots (a dropped one reads the zero row),
    # summed in ascending expert order in y's dtype
    slot = torch.where(keep, experts.reshape(-1) * cap + pos, E * cap)
    slot = torch.sort(slot.view(T, moe.top_k), dim=-1).values
    yp = torch.cat([y.reshape(E * cap, d), y.new_zeros((1, d))])
    picked = yp[slot.reshape(-1)].view(T, moe.top_k, d)
    out = picked[:, 0]
    for j in range(1, moe.top_k):
        out = out + picked[:, j]

    if moe.n_shared:
        sp = params["shared"]
        out = out + (act(xt @ sp["gate"]) * (xt @ sp["up"])) @ sp["down"]
    return out.reshape(B, S, d).to(x.dtype)


def moe_model_flops(cfg: ModelConfig, n_tokens: int) -> float:
    """Algorithmic FLOPs of one MoE layer on n_tokens (forward)."""
    moe = cfg.moe
    d, ff = cfg.d_model, moe.expert_ff
    routed = 6 * n_tokens * moe.top_k * d * ff       # 3 matmuls × 2 FLOP/MAC
    shared = 6 * n_tokens * d * ff * moe.n_shared
    router = 2 * n_tokens * d * moe.n_experts
    return routed + shared + router


__all__ = ["apply_moe", "capacity", "init_moe", "moe_dispatch_indices",
           "moe_model_flops", "router_probs"]
