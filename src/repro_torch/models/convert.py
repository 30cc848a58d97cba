"""The weight bridge: the reference's parameters → the port's.

The reference's parameters are a tree of nested dicts and lists with JAX
array leaves.  A caller that has both packages (the parity tests) turns
the leaves into numpy arrays (``jax.tree_util.tree_map(np.asarray,
params)``) and hands the tree here; the port never sees JAX.  Stacked
(``scan_layers``) and unrolled layouts pass through unchanged, since the
port reads both.  The micro MLPs' parameters, a list of ``(w, c)`` pairs,
cross with :func:`micro_params_from_numpy`.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import ModelConfig


def _to_tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a)                  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 has no numpy equivalent torch understands;
        # the bits are torch.bfloat16's
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(cfg: ModelConfig, tree: Any, device="cuda") -> Any:
    """Copy a reference parameter tree with numpy leaves onto ``device``.

    The tree keeps its structure (dicts, lists, stacked leaves); each leaf
    keeps its dtype.  ``cfg`` names the layout the tree was made for.
    """
    dev = resolve_device(device)
    if "pattern" not in tree or len(tree["pattern"]) != (
            len(cfg.pattern) if cfg.scan_layers else cfg.n_repeats):
        raise ValueError(f"parameter tree does not match {cfg.name!r} with "
                         f"scan_layers={cfg.scan_layers}")

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return _to_tensor(node, dev)

    return walk(tree)


def micro_params_from_numpy(params: Sequence[Tuple[Any, Any]], device="cuda"
                            ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Copy a micro MLP's parameters, ``[(w (d, d), c (d,)), ...]`` with
    numpy leaves as ``repro/models/micro.py`` draws them, onto ``device``
    as fp32 tensors for ``models.micro``'s factories and ``mlp_step``."""
    dev = resolve_device(device)
    out = []
    for w, c in params:
        w, c = np.asarray(w), np.asarray(c)
        if w.ndim != 2 or w.shape[0] != w.shape[1] or c.shape != w.shape[:1]:
            raise ValueError(f"micro MLP layer must be w (d, d) and c (d,), "
                             f"got {w.shape} and {c.shape}")
        out.append((_to_tensor(w.astype(np.float32), dev),
                    _to_tensor(c.astype(np.float32), dev)))
    return out
