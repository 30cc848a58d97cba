"""The weight bridge: the reference's parameter tree → the port's.

The reference's parameters are a tree of nested dicts and lists with JAX
array leaves.  A caller that has both packages (the parity tests) turns
the leaves into numpy arrays (``jax.tree_util.tree_map(np.asarray,
params)``) and hands the tree here; the port never sees JAX.  Stacked
(``scan_layers``) and unrolled layouts pass through unchanged, since the
port reads both.
"""

from __future__ import annotations

from typing import Any

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
