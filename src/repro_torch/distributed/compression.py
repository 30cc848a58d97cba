"""Gradient compression for cross-pod all-reduce: blockwise int8.

A port of ``repro/distributed/compression.py``.  Quantize per 256-value
block (scale = max-abs / 127), all-reduce the int8 payload widened to
int32 (an exact sum), dequantize: 4× fewer bytes over the slow axis.
The round trip gives the reference's bytes: the same int8 values and
bit-identical fp32 scales (``torch.round``, like ``jnp.round``, rounds
half to even, and every step is one IEEE fp32 operation in the same
order).  :func:`compressed_psum` takes a process group where the
reference takes a ``shard_map`` axis name: every rank of ``group``
calls it with its own ``x``, as every shard runs the reference's body.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.nn.functional as F

from ..training.tree import tree_leaves, tree_map

PyTree = Any

BLOCK = 256


def _blocks(x: torch.Tensor, block: int) -> Tuple[torch.Tensor, int]:
    """x flattened to fp32, zero-padded to a multiple of ``block``, as
    (n_blocks, block) rows, and the pad."""
    flat = x.float().reshape(-1)
    pad = (-flat.numel()) % block
    return F.pad(flat, (0, pad)).view(-1, block), pad


def _div127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 as one IEEE division on every device: PyTorch's CUDA
    division by a Python number multiplies by its reciprocal, which
    differs in the last bit for some values, so the divisor is a tensor
    on t's device."""
    return t / t.new_full((), 127.0)


def quantize_blockwise(x: torch.Tensor, block: int = BLOCK
                       ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """x (any shape) → (int8 values, fp32 scales, pad). Blocks of `block`."""
    blocks, pad = _blocks(x, block)
    scale = _div127(blocks.abs().amax(dim=1, keepdim=True))
    scale = torch.clamp_min(scale, 1e-30)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0], pad


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor, pad: int,
                         shape) -> torch.Tensor:
    flat = (q.float() * scale[:, None]).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Int8-quantized sum of ``x`` over the ranks of ``group``.

    Every rank quantizes against a *shared* per-block scale (an
    ``all_reduce(MAX)`` of the local max-abs, a small fp32 collective),
    so the int8 payload sums exactly in int32 and dequantization is
    unbiased; the only error is per-rank rounding ≤ scale/2.  Bytes over
    the group: 1·N (values, carried as int32 here) + 4·N/256 (scales).
    """
    import torch.distributed as dist
    blocks, pad = _blocks(x, BLOCK)
    shared = blocks.abs().amax(dim=1)
    dist.all_reduce(shared, op=dist.ReduceOp.MAX, group=group)
    shared = _div127(torch.clamp_min(shared, 1e-30))
    q = torch.clamp(torch.round(blocks / shared[:, None]), -127, 127
                    ).to(torch.int8)
    total_q = q.to(torch.int32)
    dist.all_reduce(total_q, op=dist.ReduceOp.SUM, group=group)
    return dequantize_blockwise(total_q, shared, pad, x.shape)


def compressed_psum_tree(tree: PyTree, group=None) -> PyTree:
    return tree_map(lambda x: compressed_psum(x, group), tree)


def psum_bytes_saved(tree: PyTree) -> Tuple[int, int]:
    """(fp32 bytes, compressed bytes) for reporting."""
    n = sum(int(x.numel()) for x in tree_leaves(tree))
    return 4 * n, n + 4 * (n // BLOCK + 1)


__all__ = ["BLOCK", "compressed_psum", "compressed_psum_tree",
           "dequantize_blockwise", "psum_bytes_saved", "quantize_blockwise"]
