"""AdamW with dtype-configurable state, over the port's parameter trees.

A port of ``repro/training/optimizer.py`` in its functional form: the
update takes (grads, state, params) and returns new params and a new
state, leaving its inputs as they were.  The arithmetic is the
reference's, in fp32: the gradients are clipped by their global norm,
the moments are stored in ``state_dtype`` (bf16 at 671B scale) and,
with ``master_weights``, an fp32 copy of low-precision parameters is
kept and updated in their place.  ``torch.optim.AdamW`` does none of
these three as the reference does.  The step, learning rate and norms
are 0-d tensors on the parameters' device, so a step needs no host
synchronisation.  DTensor parameters and moments (the moments laid out
by ``distributed.sharding.optimizer_pspecs``, ZeRO over "data") come
back each in the layout it came in.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from .tree import PyTree, tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"      # moments dtype ("bfloat16" at 671B scale)
    master_weights: bool = False      # keep fp32 master copy of bf16 params
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor               # 0-d int32
    mu: PyTree
    nu: PyTree
    master: Optional[PyTree]


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio (fp32)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp((step + 1.0) / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.decay_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.learning_rate * warm * frac


def init_adamw(cfg: AdamWConfig, params: PyTree) -> AdamWState:
    sdt = getattr(torch, cfg.state_dtype)
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None

    def zeros(p):
        return torch.zeros(p.shape, dtype=sdt, device=p.device)

    master = tree_map(lambda p: p.float(), params) \
        if cfg.master_weights else None
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                      master=master)


def _laid_out_as(new: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``new`` in the DTensor layout of ``like`` (the reference's
    ``out_shardings``): moments laid out by ``optimizer_pspecs`` (ZeRO)
    meet parameters laid out otherwise, and the update's results would
    keep whatever layout its ops left them in (``Partial`` included)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(like, DTensor) or (
            isinstance(new, DTensor) and new.placements == like.placements):
        return new
    return new.redistribute(like.device_mesh, like.placements)


def global_norm(tree: PyTree) -> torch.Tensor:
    sums = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: PyTree, state: AdamWState,
                 params: PyTree) -> Tuple[PyTree, AdamWState, dict]:
    """One AdamW step; returns (new_params, new_state, metrics)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp_min(gnorm, 1e-12),
                        max=1.0) if cfg.grad_clip else 1.0
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    sdt = getattr(torch, cfg.state_dtype)

    ref = state.master if state.master is not None else params

    def upd(g, mu, nu, p):
        g = g.float() * scale
        mu32 = b1 * mu.float() + (1 - b1) * g
        nu32 = b2 * nu.float() + (1 - b2) * torch.square(g)
        mhat = mu32 / bc1
        vhat = nu32 / bc2
        p32 = p.float()
        newp = p32 - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                           + cfg.weight_decay * p32)
        return newp, mu32.to(sdt), nu32.to(sdt)

    flat = [tree_leaves(t) for t in (grads, state.mu, state.nu, ref)]
    if any(len(f) != len(flat[3]) for f in flat):
        raise ValueError("grads, moments and params differ in structure")
    outs = [upd(*xs) for xs in zip(*flat)]
    new_master32 = [_laid_out_as(o[0], r) for o, r in zip(outs, flat[3])]
    new_mu = tree_unflatten(state.mu, [_laid_out_as(o[1], m) for o, m in
                                       zip(outs, flat[1])])
    new_nu = tree_unflatten(state.nu, [_laid_out_as(o[2], n) for o, n in
                                       zip(outs, flat[2])])
    new_params = tree_unflatten(params, [
        _laid_out_as(m.to(p.dtype), p)
        for m, p in zip(new_master32, tree_leaves(params))])
    new_master = tree_unflatten(state.master, new_master32) \
        if state.master is not None else None
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_params, AdamWState(step, new_mu, new_nu, new_master), metrics


__all__ = ["AdamWConfig", "AdamWState", "adamw_update", "global_norm",
           "init_adamw", "lr_schedule"]
