"""Sharding rules: tree path → PartitionSpec for every architecture.

A port of ``repro/distributed/sharding.py``.  Axes: ``pod`` (across
pods), ``data`` (within-pod data parallel), ``model`` (tensor parallel).
Batch dims shard over ("pod", "data"); weights shard over "model"
following Megatron conventions (column-parallel up-projections,
row-parallel down-projections, head-sharded attention).  MoE experts
shard over "model" on E and over "data" on ff (the expert-parallel
layout, ``cfg.moe_ep``, shards E over :func:`ep_axes`, the axes
:mod:`.expert_parallel` exchanges tokens over).  A dimension is only sharded when divisible.
ZeRO-style optimizer-state sharding adds "data" on the largest
replicated dimension (``zero=True``).

The rules read nothing of a mesh but ``mesh.mesh_dim_names`` and
``mesh.shape`` (a ``torch.distributed.device_mesh.DeviceMesh``), so a
256- or 512-rank production mesh can be built in one process on the
``"fake"`` process-group backend to ask them.  Keys are the key-path
strings of ``training.tree.leaves_with_path``, which prints them as
``jax.tree_util.keystr`` does (``['pattern'][0]['attn']['wq']``).

:class:`PartitionSpec` is the reference's ``jax.sharding.PartitionSpec``:
one entry per tensor dim, each None, an axis name or a tuple of axis
names (a one-name tuple is stored as the name, as JAX normalises it), and
it compares equal to the same entries written as a tuple.
:func:`to_placements` turns one into a DTensor ``placements`` list and
:func:`distribute_tree` lays a tree out by its specs.  :func:`use_mesh`
is the counterpart of ``with mesh:``: the ambient mesh that
``models.common``'s ``shard_*`` hints and
``expert_parallel.apply_moe_ep`` read.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import re
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..training.tree import leaves_with_path, tree_map, tree_unflatten

PyTree = Any

BATCH_AXES = ("pod", "data")   # multi-pod; single-pod meshes lack "pod"
MODEL_AXIS = "model"
DATA_AXIS = "data"


class PartitionSpec:
    """Per-dim mesh axes of one tensor (``jax.sharding.PartitionSpec``)."""

    __slots__ = ("_parts",)

    def __init__(self, *parts):
        norm = []
        for p in parts:
            if isinstance(p, (tuple, list)):
                p = tuple(p)
                if len(p) == 1:
                    p = p[0]
            norm.append(p)
        self._parts = tuple(norm)

    def __iter__(self):
        return iter(self._parts)

    def __len__(self):
        return len(self._parts)

    def __getitem__(self, i):
        return self._parts[i]

    def __eq__(self, other):
        if isinstance(other, PartitionSpec):
            return self._parts == other._parts
        if isinstance(other, (tuple, list)):
            return self._parts == PartitionSpec(*other)._parts
        return NotImplemented

    def __hash__(self):
        return hash(self._parts)

    def __repr__(self):
        return f"PartitionSpec{self._parts!r}"


P = PartitionSpec


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh (the reference's ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names or (), tuple(mesh.shape)))


def _axes_in(mesh, *names: str) -> Tuple[str, ...]:
    return tuple(n for n in names if n in (mesh.mesh_dim_names or ()))


def batch_axes(mesh) -> Tuple[str, ...]:
    return _axes_in(mesh, "pod", "data")


def _axis_size(mesh, name: str) -> int:
    return mesh_sizes(mesh).get(name, 1)


def _maybe(mesh, dim_size: int, axis: str) -> Optional[str]:
    """Shard `dim_size` over `axis` only if divisible (else replicate)."""
    n = _axis_size(mesh, axis)
    return axis if n > 1 and dim_size % n == 0 else None


def ep_axes(mesh, n_experts: int) -> Tuple[str, ...]:
    """The largest suffix of ("data", "model") whose size divides
    ``n_experts`` (both, then "model", then "data"); () if none does."""
    sizes = mesh_sizes(mesh)
    cands = [a for a in ("data", "model") if a in sizes]
    for axes in ([tuple(cands)] if len(cands) == 2 else []) + \
            [(a,) for a in reversed(cands)]:
        n = math.prod(sizes[a] for a in axes)
        if n > 1 and n_experts % n == 0:
            return axes
    return ()


# --------------------------------------------------------------------- #
# parameter rules
# --------------------------------------------------------------------- #
def param_pspec(path: str, leaf, cfg: ModelConfig, mesh) -> P:
    """PartitionSpec for one parameter leaf, keyed on its path string."""
    shape = tuple(leaf.shape)
    ndim = len(shape)
    m = lambda d: _maybe(mesh, d, MODEL_AXIS)      # noqa: E731
    dta = lambda d: _maybe(mesh, d, DATA_AXIS)     # noqa: E731

    # ---- embeddings / head ---------------------------------------- #
    if re.search(r"\['embed'\]$", path):
        return P(m(shape[0]), None)                 # (V, d): vocab-sharded
    if re.search(r"\['head'\]$", path):
        return P(None, m(shape[1]))                 # (d, V)

    # ---- norms / small vectors ------------------------------------ #
    if ndim <= 1:
        return P(*([None] * ndim))

    # ---- MoE ------------------------------------------------------- #
    if "['moe']" in path:
        if re.search(r"\['router'\]$", path):
            return P(None, m(shape[1]))             # (d, E)
        if "['shared']" in path:
            if re.search(r"\['down'\]$", path):
                return P(m(shape[0]), None)         # (sff, d)
            return P(None, m(shape[1]))             # (d, sff)
        if cfg.moe_ep:
            # expert-parallel layout: E over the largest ("data","model")
            # suffix that divides (expert_parallel's axes)
            ep = ep_axes(mesh, shape[0])
            if ep and re.search(r"\['(gate|up|down)'\]$", path):
                return P(ep, None, None)
        if re.search(r"\['(gate|up)'\]$", path):
            return P(m(shape[0]), None, dta(shape[2]))   # (E, d, ff)
        if re.search(r"\['down'\]$", path):
            return P(m(shape[0]), dta(shape[1]), None)   # (E, ff, d)

    # ---- MLA -------------------------------------------------------- #
    if re.search(r"\['wq_b'\]$", path) or re.search(r"\['wk_b'\]$", path) \
            or re.search(r"\['wv_b'\]$", path):
        return P(None, m(shape[1]), None)           # (rank, H, dh)
    if re.search(r"\['(wq_a|wkv_a)'\]$", path):
        return P(None, None)

    # ---- attention --------------------------------------------------- #
    if re.search(r"\['wq'\]$", path):
        return P(None, m(shape[1]), None)           # (d, H, dh)
    if re.search(r"\['(wk|wv)'\]$", path):
        return P(None, m(shape[1]), None)           # (d, Hkv, dh) if divisible
    if re.search(r"\['wo'\]$", path):
        return P(m(shape[0]), None, None)           # (H, dh, d) row-parallel
    if re.search(r"\['b(q|k|v)'\]$", path):
        return P(m(shape[0]), None)

    # ---- dense MLP --------------------------------------------------- #
    if re.search(r"\['(gate|up)'\]$", path):
        return P(None, m(shape[1]))                 # (d, ff) column
    if re.search(r"\['down'\]$", path):
        return P(m(shape[0]), None)                 # (ff, d) row

    # ---- SSM (mamba2) ------------------------------------------------ #
    if re.search(r"\['(in_proj|out_proj)'\]$", path) and cfg.ssm is not None:
        return P(None, None)                        # tiny model: replicate
    if re.search(r"\['conv_w'\]$", path) and cfg.ssm is not None:
        return P(None, None)

    # ---- RG-LRU ------------------------------------------------------ #
    if re.search(r"\['(gate_proj|rec_proj)'\]$", path):
        return P(None, m(shape[1]))                 # (d, w) column
    if re.search(r"\['(w_a|w_x)'\]$", path):
        return P(None, m(shape[1]))                 # (w, w) output-sharded
    if re.search(r"\['out_proj'\]$", path):
        return P(m(shape[0]), None)                 # (w, d) row
    if re.search(r"\['conv_w'\]$", path):
        return P(None, m(shape[1]))                 # (K, w)

    return P(*([None] * ndim))


def params_pspecs(cfg: ModelConfig, params_shape: PyTree, mesh) -> PyTree:
    """PartitionSpec tree matching ``params_shape`` (tensors of any
    device: meta, real or DTensors), stacked ``(n_repeats, ...)``
    pattern leaves taking the rule of one repeat behind a None."""
    specs = []
    for ps, leaf in leaves_with_path(params_shape):
        shape = tuple(leaf.shape)
        stacked = "['pattern']" in ps and cfg.scan_layers and len(shape) >= 1
        inner = shape[1:] if stacked else shape
        base = tuple(param_pspec(
            ps, torch.empty(inner, device="meta"), cfg, mesh))
        # pad/trim to the (unstacked) leaf rank
        base = (base + (None,) * len(inner))[:len(inner)]
        specs.append(P(None, *base) if stacked else P(*base))
    return tree_unflatten(params_shape, specs)


def optimizer_pspecs(param_specs: PyTree, params_shape: PyTree, mesh, *,
                     zero: bool = True) -> PyTree:
    """Moment/master shardings = param shardings (+ ZeRO over "data")."""
    if not zero or "data" not in (mesh.mesh_dim_names or ()):
        return param_specs

    def zero_spec(spec: P, leaf):
        shape = tuple(leaf.shape)
        dims = list(spec) + [None] * (len(shape) - len(spec))
        if DATA_AXIS in dims:
            return P(*dims)
        n = _axis_size(mesh, DATA_AXIS)
        # shard the largest replicated dim that divides the data axis
        order = sorted(range(len(shape)), key=lambda i: -shape[i])
        for i in order:
            if dims[i] is None and shape[i] % n == 0 and shape[i] >= n:
                dims[i] = DATA_AXIS
                break
        return P(*dims)

    return tree_map(zero_spec, param_specs, params_shape)


# --------------------------------------------------------------------- #
# activations / inputs / caches
# --------------------------------------------------------------------- #
def _divisible_batch_axes(mesh, batch: int) -> Tuple[str, ...]:
    """Largest prefix of ("pod","data") whose product divides the batch."""
    axes = []
    prod = 1
    for a in batch_axes(mesh):
        n = _axis_size(mesh, a)
        if batch % (prod * n) == 0:
            axes.append(a)
            prod *= n
    return tuple(axes)


def batch_pspecs(batch_specs: PyTree, mesh) -> PyTree:
    """Inputs shard their leading batch dim over ("pod","data")."""

    def spec(leaf):
        axes = _divisible_batch_axes(mesh, leaf.shape[0])
        return P(axes if axes else None, *([None] * (leaf.dim() - 1)))

    return tree_map(spec, batch_specs)


def cache_pspecs(cfg: ModelConfig, cache_shape: PyTree, mesh) -> PyTree:
    """Decode-cache shardings.

    Full-length attention KV caches (B, S, Hkv, D) shard batch over
    ("pod","data") and *sequence* over "model" (the flash-decode layout
    that sidesteps kv_heads < model axis).  Ring buffers, MLA latent
    caches and recurrent states shard batch only.
    """
    specs = []
    window = cfg.sliding_window or 0
    for ps, leaf in leaves_with_path(cache_shape):
        stacked = "['pattern']" in ps and cfg.scan_layers
        dims = tuple(leaf.shape[1:] if stacked else leaf.shape)
        lead = (None,) if stacked else ()
        axes0 = _divisible_batch_axes(mesh, dims[0]) if dims else ()
        axes = axes0 if axes0 else None
        if re.search(r"\['(k|v|cross_k|cross_v)'\]$", ps) and len(dims) == 4:
            seq = dims[1]
            seq_axis = _maybe(mesh, seq, MODEL_AXIS)
            if window and seq <= window:
                seq_axis = None                    # ring buffers replicate S
            spec = P(*lead, axes, seq_axis, None, None)
        elif re.search(r"\['(c_kv|k_rope)'\]$", ps) and len(dims) == 3:
            spec = P(*lead, axes, _maybe(mesh, dims[1], MODEL_AXIS), None)
        elif len(dims) >= 1:
            spec = P(*lead, axes, *([None] * (len(dims) - 1)))
        else:
            spec = P()
        specs.append(spec)
    return tree_unflatten(cache_shape, specs)


# --------------------------------------------------------------------- #
# specs → DTensor placements
# --------------------------------------------------------------------- #
def to_placements(mesh, spec) -> List:
    """The DTensor ``placements`` of ``spec`` on ``mesh``: ``Shard(d)`` on
    each mesh dim of size > 1 that tensor dim d names, ``Replicate()`` on
    the rest (a shard over one rank is the whole tensor, and DTensor
    refuses some reshapes of a dim so "sharded").  A dim sharded over
    several axes names them in mesh order, the order in which DTensor
    nests its shards (and JAX its tuple's axes)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names or ())
    sizes = tuple(mesh.shape)
    placements: List = [Replicate()] * len(names)
    used: set = set()
    for d, entry in enumerate(spec):
        idx = [names.index(a) for a in _axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: dim {d} names its axes out of mesh "
                             f"order {names}")
        for i in idx:
            if i in used:
                raise ValueError(f"{spec}: axis {names[i]} used twice")
            used.add(i)
            if sizes[i] > 1:
                placements[i] = Shard(d)
    return placements


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> List:
        return to_placements(self.mesh, self.spec)


def to_named(mesh, spec_tree: PyTree) -> PyTree:
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree)


def distribute_tree(tree: PyTree, spec_tree: PyTree, mesh) -> PyTree:
    """Every tensor of ``tree`` as a DTensor laid out by its spec
    (``distribute_tensor``: each rank passes the same global values)."""
    from torch.distributed.tensor import distribute_tensor
    return tree_map(lambda t, s: distribute_tensor(
        t, mesh, to_placements(mesh, s)), tree, spec_tree)


def sharded_zeros(tree: PyTree, spec_tree: PyTree, mesh, *,
                  device=None) -> PyTree:
    """A DTensor of zeros for every tensor of ``tree`` (its shape and
    dtype; a meta tree will do), laid out by its spec: each rank
    allocates its own shard on ``device`` (the leaf's by default), and
    nothing is communicated."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    def one(t, spec):
        placements = to_placements(mesh, spec)
        local, _ = compute_local_shape_and_global_offset(t.shape, mesh,
                                                         placements)
        return DTensor.from_local(
            torch.zeros(local, dtype=t.dtype, device=device or t.device),
            mesh, placements, run_check=False, shape=t.shape,
            stride=t.stride())

    return tree_map(one, tree, spec_tree)


# --------------------------------------------------------------------- #
# the ambient mesh
# --------------------------------------------------------------------- #
# a context variable, so each thread (and asyncio task) has its own
_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                       default=None)


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator:
    """Make ``mesh`` the ambient mesh inside the block (``with mesh:``)."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh():
    """The innermost :func:`use_mesh` mesh, or None."""
    return _MESH.get()


@contextlib.contextmanager
def sharded_step(param) -> Iterator:
    """The context of a step whose parameters include ``param`` (the
    steps pass their ``embed``): when it is a DTensor, its mesh is
    ambient (unless a mesh already is) and plain tensors mixed with
    DTensors count as replicated (``implicit_replication``: positions,
    masks, tokens); otherwise nothing changes.  ``lm.prefill``,
    ``lm.decode_step`` and the train step enter it, so they take DTensor
    parameters as they are."""
    from torch.distributed.tensor import DTensor
    if not isinstance(param, DTensor):
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    with contextlib.ExitStack() as stack:
        if current_mesh() is None:
            stack.enter_context(use_mesh(param.device_mesh))
        stack.enter_context(implicit_replication())
        yield


__all__ = ["BATCH_AXES", "DATA_AXIS", "MODEL_AXIS", "NamedSharding",
           "PartitionSpec", "batch_axes", "batch_pspecs", "cache_pspecs",
           "current_mesh", "distribute_tree", "ep_axes", "mesh_sizes",
           "optimizer_pspecs", "param_pspec", "params_pspecs",
           "sharded_step", "sharded_zeros", "to_named", "to_placements",
           "use_mesh"]
