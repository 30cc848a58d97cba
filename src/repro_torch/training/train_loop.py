"""Training step + loop: cross-entropy LM training for every architecture.

A port of ``repro/training/train_loop.py``.  ``make_train_step`` builds
the (params, opt_state, batch) → (params, opt_state, metrics) function
with optional gradient accumulation; per-block rematerialisation is
``cfg.remat`` inside the model (``models.lm``).  Gradients come from
``torch.autograd.grad`` over the leaves of the parameter tree, which
stays the plain dict/list tree the models read.

Train with ``cfg.use_pallas_kernels`` off, as the reference must: the
CUDA kernels have no backward, and on a card their wrappers raise when
an input requires grad.  Evaluating trained weights through them under
``torch.no_grad()`` is fine.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch

from .. import resolve_device
from ..configs.base import ModelConfig
from ..models.common import cross_entropy_loss
from ..models.lm import Model, forward, head_weights
from .optimizer import AdamWConfig, AdamWState, adamw_update, init_adamw
from .tree import PyTree, tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    grad_accum: int = 1               # microbatches per optimizer step
    remat: bool = False               # unused, as in the reference:
                                      # cfg.remat rematerialises blocks


def loss_fn(params, batch, cfg: ModelConfig):
    # cfg.remat checkpoints each block inside the model (models.lm); a
    # vision batch's labels already cover its prefix with -100
    hidden = forward(params, batch, cfg)
    return cross_entropy_loss(hidden, head_weights(params, cfg),
                              batch["labels"], chunk=cfg.xent_chunk,
                              softcap=cfg.logit_softcap)


def value_and_grad(params, batch, cfg: ModelConfig):
    """(loss, grads) of :func:`loss_fn`; grads have params' structure and
    dtypes, and a parameter the loss does not reach gets zeros."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        live = [p.detach().requires_grad_() for p in leaves]
        loss = loss_fn(tree_unflatten(params, live), batch, cfg)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig
                    ) -> Callable[[PyTree, AdamWState, Dict], Tuple]:
    """Build the train step (grad, accumulation, AdamW update).  DTensor
    parameters (``distributed.sharding.params_pspecs``) run it on their
    mesh: the returned parameters and moments are DTensors laid out as
    given, the loss a DTensor with the plain step's value."""
    from ..distributed.sharding import sharded_step

    def train_step(params, opt_state: AdamWState, batch: Dict):
        with sharded_step(params["embed"]):
            return _train_step(params, opt_state, batch)

    def _train_step(params, opt_state: AdamWState, batch: Dict):
        if tcfg.grad_accum > 1:
            # microbatches over the leading batch axis; losses and grads
            # are summed in fp32 and divided by k (a mean of microbatch
            # means, as the reference's scan)
            k = tcfg.grad_accum
            B = batch["tokens"].shape[0]
            mbs = {name: x.reshape(k, B // k, *x.shape[1:])
                   for name, x in batch.items()}
            loss = 0.0
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(k):
                mb_loss, mb_grads = value_and_grad(
                    params, {name: x[i] for name, x in mbs.items()}, cfg)
                grads = tree_map(torch.add, grads, mb_grads)
                loss = loss + mb_loss
            loss = loss / k
            grads = tree_map(lambda g: g / k, grads)
        else:
            loss, grads = value_and_grad(params, batch, cfg)
        params, opt_state, metrics = adamw_update(
            tcfg.adamw, grads, opt_state, params)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def shift_labels(tokens: torch.Tensor, ignore_prefix: int = 0
                 ) -> torch.Tensor:
    """Next-token labels: labels[t] = tokens[t+1]; last and prefix = -100."""
    labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -100)],
                       dim=1)
    if ignore_prefix:
        labels[:, :ignore_prefix] = -100
    return labels


def train(model: Model, tcfg: TrainConfig, data: Iterator[Dict], *,
          steps: int, seed: int = 0, device="cuda", params=None,
          opt_state=None, log_every: int = 10,
          on_step: Optional[Callable[[int, Dict], None]] = None,
          checkpointer=None, checkpoint_every: int = 0):
    """Single-device training loop.  ``seed`` and ``device`` make the
    parameters when none are given (the reference takes an rng); every
    batch moves to ``device``, which must hold ``params``."""
    dev = resolve_device(device)
    if params is None:
        params = model.init(seed, device=dev)
    if opt_state is None:
        opt_state = init_adamw(tcfg.adamw, params)
    step_fn = make_train_step(model.cfg, tcfg)
    history = []
    t0 = time.perf_counter()
    start_step = int(opt_state.step)
    for step in range(start_step, steps):
        batch = {name: x.to(dev) for name, x in next(data).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if on_step is not None:
            on_step(step, metrics)
        if (step + 1) % log_every == 0 or step == steps - 1:
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            history.append({"step": step + 1, "loss": loss,
                            "elapsed_s": dt})
        if checkpointer is not None and checkpoint_every \
                and (step + 1) % checkpoint_every == 0:
            checkpointer.save(step + 1, params, opt_state)
    return params, opt_state, history


__all__ = ["TrainConfig", "loss_fn", "make_train_step", "shift_labels",
           "train", "value_and_grad"]
