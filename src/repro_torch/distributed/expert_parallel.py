"""Expert parallelism with two all-to-alls (DeepSeek-style EP).

A port of ``repro/distributed/expert_parallel.py``.  Tokens are routed
locally on each rank, sent with one ``all_to_all_single`` to the ranks
that own their experts (the expert ids and a valid mask go with them),
processed there, and returned with a second; collective bytes per layer
are O(2·tokens·k·d·capacity_factor) instead of the activation
all-gathers a dense-dispatch layout needs.

Experts shard over the largest suffix of ("data", "model") that divides
n_experts (:func:`.sharding.ep_axes`).  Over both axes the all-to-alls
run on one process group spanning the data × model grid of each pod,
made with ``dist.new_subgroups_by_enumeration`` from the mesh's rank
layout (once per mesh and axes).  Tokens enter with their natural
layout (batch over ("pod","data"), sequence over "model"), as the
reference's ``shard_map`` specs have them.

What the reference's ``shard_map`` hands each shard, this module takes
from the arguments: the rank's block of a DTensor (redistributed to the
spec first), or its slice of a plain tensor, which every rank then
holds whole.  Expert weights are best DTensors sharded by
``params_pspecs`` with ``cfg.moe_ep``: a rank then holds only its own
experts.  The output is a DTensor for a DTensor ``x`` and a plain
tensor (gathered) for a plain one.

Two points differ in how, not in what:

* A rank's experts run one at a time over the rows sent to them (index
  select, three matmuls, index copy) instead of gathering one weight
  matrix per row, which at full width would be (rows, d, ff) per layer.
* The gate-weighted return sums each token's k slots in ascending slot
  order (the reference's scatter-add order) through a gather, not with
  ``index_add_``, whose CUDA atomics would sum in no fixed order.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..models.common import _ACTS
from ..models.moe import router_probs
from .sharding import P, current_mesh, mesh_sizes, to_placements
from .sharding import ep_axes as _ep_axes


@functools.lru_cache(maxsize=None)
def _ep_group(mesh, axes: Tuple[str, ...]):
    """The process group over ``axes`` that holds this rank, its ranks in
    the axes' row-major order (the reference's shard index)."""
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    import torch.distributed as dist
    names = list(mesh.mesh_dim_names)
    rest = [i for i, n in enumerate(names) if n not in axes]
    order = rest + [names.index(a) for a in axes]
    n = math.prod(mesh_sizes(mesh)[a] for a in axes)
    layout = mesh.mesh.permute(order).reshape(-1, n)
    group, _ = dist.new_subgroups_by_enumeration(layout.tolist())
    return group


def _local(t: torch.Tensor, mesh, spec: P, token_dims=()) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (``shard_map``'s view):
    a DTensor's local shard once laid out by ``spec``, or the slice of a
    plain tensor that every rank holds whole.  A DTensor's gradient is
    a partial sum over ``token_dims`` (the mesh dims the tokens shard
    over) where ``spec`` replicates it: each rank there saw other tokens."""
    from torch.distributed.tensor import DTensor, Partial
    if isinstance(t, DTensor):
        placements = to_placements(mesh, spec)
        grads = [Partial() if i in token_dims and p.is_replicate() else p
                 for i, p in enumerate(placements)]
        return t.redistribute(mesh, placements).to_local(
            grad_placements=grads)
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    sizes = mesh_sizes(mesh)
    for d, entry in enumerate(spec):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        if not axes:
            continue
        idx, n = 0, 1
        for a in axes:                     # row-major over the axes
            idx = idx * sizes[a] + coord[names.index(a)]
            n *= sizes[a]
        step = t.shape[d] // n
        t = t.narrow(d, idx * step, step)
    return t


def ep_dispatch(experts, gates, n_shards: int, e_local: int, cap: int):
    """One rank's routing grids from its router output (T, k): per
    destination shard, ``cap`` slots in first-come order, assignments
    past ``cap`` dropped.  Returns tok_idx (shards, cap) int32 local token
    ids (T for an empty slot), eids (shards, cap) int32 expert ids on the
    destination, gvals (shards, cap) fp32 gates, and slot (T·k,) each
    assignment's row of the flattened grid (shards · cap if dropped)."""
    T, k = experts.shape
    dev = experts.device
    flat_e = experts.reshape(-1).long()
    flat_t = torch.arange(T, dtype=torch.int32, device=dev
                          ).repeat_interleave(k)
    dest = flat_e // e_local
    onehot = F.one_hot(dest, n_shards)
    pos = torch.gather(torch.cumsum(onehot, dim=0) - onehot, 1,
                       dest[:, None])[:, 0]
    keep = pos < cap
    # dropped assignments write the extra row/column that is cut off
    rows = torch.where(keep, dest, n_shards)
    cols = torch.where(keep, pos, cap)
    tok_grid = torch.full((n_shards + 1, cap + 1), T, dtype=torch.int32,
                          device=dev)
    tok_grid[rows, cols] = flat_t
    eid_grid = torch.zeros((n_shards + 1, cap + 1), dtype=torch.int32,
                           device=dev)
    eid_grid[rows, cols] = (flat_e % e_local).to(torch.int32)
    gate_grid = torch.zeros((n_shards + 1, cap + 1), dtype=torch.float32,
                            device=dev)
    gate_grid[rows, cols] = gates.reshape(-1).float()
    slot = torch.where(keep, dest * cap + pos, n_shards * cap)
    return (tok_grid[:n_shards, :cap], eid_grid[:n_shards, :cap].contiguous(),
            gate_grid[:n_shards, :cap], slot)


def apply_moe_ep(params, x, cfg: ModelConfig, *, mesh=None):
    """Drop-in for ``models.moe.apply_moe`` with explicit EP collectives.

    x: (B, S, d) with B sharded over ("pod","data") and S over "model"
    (those axes that exist and divide).  Every rank of the mesh calls it.
    """
    from ..models.moe import apply_moe

    moe = cfg.moe
    if moe is None:
        raise ValueError(f"{cfg.name}: apply_moe_ep needs cfg.moe")
    if mesh is None:
        mesh = current_mesh()
    # the reference's rule (expert_parallel.py:59-63), not a device
    # fallback: with no mesh, or no EP axis that divides n_experts, the
    # layer is the dense-dispatch MoE
    if mesh is None or not mesh.mesh_dim_names:
        return apply_moe(params, x, cfg)
    ep = _ep_axes(mesh, moe.n_experts)
    if not ep:
        return apply_moe(params, x, cfg)
    sizes = mesh_sizes(mesh)
    n_shards = math.prod(sizes[a] for a in ep)
    e_local = moe.n_experts // n_shards

    B, S, d = x.shape
    names = mesh.mesh_dim_names
    batch_axes = tuple(a for a in ("pod", "data") if a in names)
    bprod = math.prod(sizes[a] for a in batch_axes) if batch_axes else 1
    if B % bprod:
        batch_axes, bprod = (), 1
    seq_axis = "model" if "model" in names and S % sizes["model"] == 0 \
        else None
    sprod = sizes["model"] if seq_axis else 1
    t_local = (B // bprod) * (S // sprod)
    cap = max(4, int(math.ceil(
        t_local * moe.top_k * moe.capacity_factor / n_shards)))
    act = _ACTS[cfg.act]
    k = moe.top_k
    x_spec = P(batch_axes if batch_axes else None, seq_axis, None)
    w_spec = P(ep, None, None)
    group = _ep_group(mesh, ep)

    token_dims = tuple(names.index(a) for a in batch_axes + (
        (seq_axis,) if seq_axis else ()))
    xs = _local(x, mesh, x_spec)
    router_w = _local(params["router"], mesh, P(None, None),
                      token_dims).float()
    gate_w, up_w, down_w = (_local(params[n], mesh, w_spec, token_dims)
                            for n in ("gate", "up", "down"))

    # xs: (B_local, S_local, d) → (t_local, d)
    xt = xs.reshape(-1, d)
    gates, experts = router_probs({"router": router_w}, xt, moe)
    tok_idx, eids, gvals, slot = ep_dispatch(experts, gates, n_shards,
                                             e_local, cap)

    xp = torch.cat([xt, xt.new_zeros((1, d))])
    send = xp[tok_idx.reshape(-1).long()].view(n_shards, cap, d)
    recv = _all_to_all(send, group)
    recv_eids = _all_to_all(eids, group)
    valid = _all_to_all((tok_idx < t_local).to(torch.int32), group)

    flat_in = recv.reshape(-1, d)
    flat_eid = recv_eids.reshape(-1)
    live = valid.reshape(-1).bool()
    y = flat_in.new_zeros(flat_in.shape)           # invalid rows stay 0
    for e in range(e_local):
        sel = torch.nonzero(live & (flat_eid == e))[:, 0]
        if sel.numel():
            xin = flat_in[sel]
            h = act(xin @ gate_w[e]) * (xin @ up_w[e])
            y[sel] = (h @ down_w[e]).to(y.dtype)
    back = _all_to_all(y.view(n_shards, cap, d), group)

    # gate-weighted return: each token's k slots (a dropped one reads the
    # zero row), summed in ascending slot order in back's dtype
    weighted = (back * gvals[..., None].to(back.dtype)).reshape(-1, d)
    wp = torch.cat([weighted, weighted.new_zeros((1, d))])
    slot = torch.sort(slot.view(t_local, k), dim=-1).values
    picked = wp[slot.reshape(-1)].view(t_local, k, d)
    out_local = picked[:, 0]
    for j in range(1, k):
        out_local = out_local + picked[:, j]
    out_local = out_local.reshape(xs.shape)

    from torch.distributed.tensor import DTensor
    out = DTensor.from_local(out_local, mesh, to_placements(mesh, x_spec))
    if not isinstance(x, DTensor):
        out = out.full_tensor()

    if moe.n_shared:
        sp = params["shared"]
        xt_all = x.reshape(B * S, d)
        shared = (act(xt_all @ sp["gate"]) * (xt_all @ sp["up"])) \
            @ sp["down"]
        out = out + shared.reshape(B, S, d).to(out.dtype)
    return out


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Block i of dim 0 goes to rank i of ``group``; block j of the
    result came from rank j (``lax.all_to_all(..., 0, 0, tiled=False)``).
    Differentiable: the exchange is its own transpose."""
    return _AllToAll.apply(t, group)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed as dist
        ctx.group = group
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllToAll.apply(grad, ctx.group), None


__all__ = ["apply_moe_ep", "ep_dispatch"]
