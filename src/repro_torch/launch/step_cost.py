"""Step cost: per-rank FLOPs, HBM bytes, collectives, launches and memory
of one eager step.

The counterpart of ``repro/launch/hlo_analysis.py``.  The reference reads
a compiled XLA program: ``cost_analysis()`` for FLOPs and bytes,
``memory_analysis()`` for residency, the optimized HLO text for
collectives.  The port has no compiled program, so :func:`program_cost`
runs the step eagerly, under a dispatch mode that sees every aten
op the step issues on the tensors that really hold the data (a DTensor
op is seen as the ops its sharding rule runs on the local shards, and
as the collectives its redistributions need).  On meta tensors (DTensor
arguments on torch's ``"fake"`` process group) nothing is allocated or
computed, so a full-width step on a 256-rank production mesh is counted
in one process; the same count on a card's real tensors gives the same
numbers: ``F.rms_norm``, which CUDA runs as one fused kernel where meta
decomposes it, is counted as the card runs it.

Per rank, for one (warm) run of the step:

* ``flops`` — the matmul, convolution and attention FLOPs of
  ``torch.utils.flop_counter``'s table (elementwise ops count none);
* ``hbm_bytes`` — every device op's tensor inputs read once and outputs
  written once, on local shapes;
* collectives — by the reference's HLO op names, each one's result
  bytes (the ring approximation of :func:`collective_stats`); counted by
  ``CommDebugMode``;
* ``launches`` — the device ops: aten ops on the arguments' device
  that are not views, allocations or waits;
* ``argument_bytes`` (the local shards' storage of every tensor
  argument), ``temp_bytes`` (the peak of storages the step creates and
  holds at once, less what it returns) and ``output_bytes`` (the storage
  of every returned tensor; ``alias_bytes`` of it is an argument's, as
  a cache written in place).

:class:`CollectiveStats`, :func:`collective_stats` and
:class:`ProgramCost` are the reference's (``tests/test_torch_isolation.py``
compares their syntax trees), so the reference's HLO parser runs here
too and :class:`ProgramCost` differences as there.  A custom op is
opaque to the FLOP table: the port's CUDA kernels count no FLOPs, so
count steps with ``cfg.use_pallas_kernels`` off, as the reference's
sharded steps run.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import re
import weakref
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..core.hardware import H100, NVLINK_LINKS
from ..core.roofline import HardwareSpec, RooflineTerms

_COLLECTIVE_RE = re.compile(
    r"=\s*(?P<rtype>[^=]*?)\s*"
    r"(?P<op>all-gather|all-reduce|reduce-scatter|all-to-all|"
    r"collective-permute)(?:-start|-done)?\(")

_SHAPE_RE = re.compile(r"(?P<dt>[a-z]+[0-9]+)\[(?P<dims>[0-9,]*)\]")

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "f8": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}


def _shape_bytes(type_str: str) -> int:
    total = 0
    for m in _SHAPE_RE.finditer(type_str):
        dt = m.group("dt")
        size = _DTYPE_BYTES.get(dt)
        if size is None:
            m2 = re.match(r"[a-z]+([0-9]+)", dt)
            size = int(m2.group(1)) // 8 if m2 else 4
        dims = m.group("dims")
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * size
    return total


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_op: Dict[str, int]
    count_by_op: Dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_op.values())

    def __sub__(self, other: "CollectiveStats") -> "CollectiveStats":
        keys = set(self.bytes_by_op) | set(other.bytes_by_op)
        return CollectiveStats(
            {k: self.bytes_by_op.get(k, 0) - other.bytes_by_op.get(k, 0)
             for k in keys},
            {k: self.count_by_op.get(k, 0) - other.count_by_op.get(k, 0)
             for k in keys})

    def scaled_add(self, other: "CollectiveStats", factor: float
                   ) -> "CollectiveStats":
        keys = set(self.bytes_by_op) | set(other.bytes_by_op)
        return CollectiveStats(
            {k: int(self.bytes_by_op.get(k, 0)
                    + factor * other.bytes_by_op.get(k, 0)) for k in keys},
            {k: int(self.count_by_op.get(k, 0)
                    + factor * other.count_by_op.get(k, 0)) for k in keys})


def collective_stats(hlo_text: str) -> CollectiveStats:
    """Sum result bytes of every collective op in optimized HLO text.

    ``-start``/``-done`` pairs are counted once (the ``-done`` result
    repeats the ``-start`` payload); result bytes ≈ per-device bytes
    received, the ring-collective approximation used for the roofline
    collective term.
    """
    bytes_by_op: Dict[str, int] = {}
    count_by_op: Dict[str, int] = {}
    for line in hlo_text.splitlines():
        if "-done(" in line:
            continue
        m = _COLLECTIVE_RE.search(line)
        if not m:
            continue
        op = m.group("op")
        b = _shape_bytes(m.group("rtype"))
        bytes_by_op[op] = bytes_by_op.get(op, 0) + b
        count_by_op[op] = count_by_op.get(op, 0) + 1
    return CollectiveStats(bytes_by_op, count_by_op)


@dataclasses.dataclass
class ProgramCost:
    """Per-device cost of one compiled program."""

    flops: float              # per-device HLO FLOPs
    hbm_bytes: float          # per-device bytes accessed
    collectives: CollectiveStats
    argument_bytes: int = 0   # per-device argument residency
    temp_bytes: int = 0       # per-device temporaries (activations)
    output_bytes: int = 0

    def __sub__(self, other: "ProgramCost") -> "ProgramCost":
        return ProgramCost(self.flops - other.flops,
                           self.hbm_bytes - other.hbm_bytes,
                           self.collectives - other.collectives)

    def scaled_add(self, other: "ProgramCost", factor: float) -> "ProgramCost":
        return ProgramCost(
            self.flops + factor * other.flops,
            self.hbm_bytes + factor * other.hbm_bytes,
            self.collectives.scaled_add(other.collectives, factor),
            self.argument_bytes, self.temp_bytes, self.output_bytes)


# --------------------------------------------------------------------- #
# counting an eager step
# --------------------------------------------------------------------- #
# torch's functional collectives (the ops DTensor's redistributions run)
# -> the reference's HLO op names
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
}
# aten ops that launch nothing on the device: allocations, metadata,
# waits on a collective's result
_NO_LAUNCH = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "lift_fresh", "wait_tensor", "sym_size",
    "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
    "resize_", "set_", "record_stream", "_local_scalar_dense",
    "_unsafe_view",
})


def _op_name(func) -> str:
    return func._overloadpacket.__name__


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _storages(tree) -> Dict[int, int]:
    """{storage key: bytes} of every tensor of ``tree`` (local shards)."""
    out: Dict[int, int] = {}
    for t in _tensors(tree):
        t = _local(t)
        out[_storage_key(t)] = t.untyped_storage().nbytes()
    return out


class _Counter(TorchDispatchMode):
    """Counts the plain-tensor ops a step issues; a DTensor op returns
    ``NotImplemented`` so that DTensor runs its rule and the mode sees
    the local ops and collectives it issues (as ``CommDebugMode``)."""

    def __init__(self, arg_storages, device_type: str):
        super().__init__()
        self.device_type = device_type
        from torch.utils.flop_counter import flop_registry
        self.flop_registry = flop_registry
        self.flops = 0
        self.hbm_bytes = 0
        self.launches = 0
        self.coll_bytes: Dict[str, int] = {}
        self.coll_count: Dict[str, int] = {}
        self.by_op: Dict[str, int] = {}
        self._args = set(arg_storages)
        self._live: Dict[int, Tuple[int, weakref.ref]] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.paused = False

    def _freed(self, key, _ref):
        entry = self._live.pop(key, None)
        if entry is not None:
            self.live_bytes -= entry[0]

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._args or key in self._live:
            return
        n = st.nbytes()
        self._live[key] = (n, weakref.ref(st, functools.partial(
            self._freed, key)))
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self.paused or isinstance(func, torch._ops.HigherOrderOperator):
            return out
        name = _op_name(func)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out          # DTensor's shape propagation, not the step
        if func.is_view or name in _NO_LAUNCH or not any(
                t.device.type == self.device_type for t in ins + outs):
            for t in outs:
                self._hold(t)
            return out
        self.count(name, ins, outs)
        packet = func._overloadpacket
        if packet in self.flop_registry:
            self.flops += self.flop_registry[packet](*args, **kwargs,
                                                     out_val=out)
        kind = _COLLECTIVES.get(name)
        if kind is not None:
            self.coll_bytes[kind] = self.coll_bytes.get(kind, 0) + sum(
                map(_nbytes, outs))
            self.coll_count[kind] = self.coll_count.get(kind, 0) + 1
        return out

    def count(self, name: str, ins, outs, extra_out_bytes: int = 0) -> None:
        """One device op: its inputs read, its outputs written."""
        self.launches += 1
        self.by_op[name] = self.by_op.get(name, 0) + 1
        self.hbm_bytes += (sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
                           + extra_out_bytes)
        for t in outs:
            self._hold(t)


class _FusedNorms(TorchFunctionMode):
    """Counts each ``F.rms_norm`` as the one ``_fused_rms_norm`` kernel
    CUDA launches for it, whatever the device runs (meta and the CPU
    decompose it into pow, mean, add_, rsqrt and mul, five device ops
    with temporaries of their own): its input read, its output and fp32
    ``rstd`` written.  Without a counter (a warm-up) it only runs."""

    def __init__(self, counter: Optional["_Counter"] = None):
        super().__init__()
        self.counter = counter

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is not F.rms_norm or self.counter is None:
            return func(*args, **kwargs)
        self.counter.paused = True
        try:
            out = func(*args, **kwargs)
        finally:
            self.counter.paused = False
        x, shape, weight = (list(args) + [None, None])[:3]
        shape = kwargs.get("normalized_shape", shape)
        weight = kwargs.get("weight", weight)
        x = _local(x)
        ins = [x] + ([_local(weight)] if weight is not None else [])
        rstd = x.numel() // math.prod(shape) * 4
        self.counter.count("_fused_rms_norm", ins, [_local(out)], rstd)
        return out


@dataclasses.dataclass
class StepCost:
    """:class:`ProgramCost` with what only an eager count sees."""
    cost: ProgramCost
    launches: int
    alias_bytes: int
    ops: Dict[str, int]

    @property
    def peak_bytes(self) -> int:
        c = self.cost
        return (c.argument_bytes + c.temp_bytes + c.output_bytes
                - self.alias_bytes)


def program_cost(step, *args, **kwargs) -> StepCost:
    """Run ``step(*args, **kwargs)`` twice and count the second run, per
    rank (see the module docstring): the first fills what the port caches
    per device (``rope_frequencies``' tables), as a step in service finds
    it, so a count does not depend on what ran before.  Meta arguments
    (DTensors with meta shards on a ``"fake"`` process group) count a
    step of any size without memory; the arguments of a real step are
    the card's tensors, whose step then runs for real."""
    from torch.distributed.tensor.debug import CommDebugMode
    with _FusedNorms():
        step(*args, **kwargs)
    arg_st = _storages((args, kwargs))
    devices = {_local(t).device.type for t in _tensors((args, kwargs))}
    if len(devices) != 1:
        raise ValueError(f"the step's arguments lie on {sorted(devices)}")
    counter = _Counter(arg_st, devices.pop())
    comm = CommDebugMode()
    with _FusedNorms(counter), comm, counter:
        out = step(*args, **kwargs)
    out_st = _storages(out)
    alias = sum(n for k, n in out_st.items() if k in arg_st)
    output = sum(out_st.values())
    new_out = output - alias
    counts = _comm_counts(comm)
    if counts != counter.coll_count:
        raise RuntimeError(f"collectives: CommDebugMode counts {counts}, "
                           f"the dispatch mode {counter.coll_count}")
    cost = ProgramCost(
        flops=float(counter.flops), hbm_bytes=float(counter.hbm_bytes),
        collectives=CollectiveStats(dict(counter.coll_bytes), counts),
        argument_bytes=sum(arg_st.values()),
        temp_bytes=max(0, counter.peak_bytes - new_out),
        output_bytes=output)
    return StepCost(cost, counter.launches, alias, dict(counter.by_op))


def _comm_counts(comm) -> Dict[str, int]:
    """CommDebugMode's counts by the reference's op names."""
    out: Dict[str, int] = {}
    for op, n in comm.get_comm_counts().items():
        kind = _COLLECTIVES.get(op.__name__)
        if kind is None:
            raise RuntimeError(f"collective {op} has no reference name")
        out[kind] = out.get(kind, 0) + n
    return out


def roofline_from_cost(cost: ProgramCost, n_chips: int,
                       hw: HardwareSpec = H100,
                       links: int = NVLINK_LINKS) -> RooflineTerms:
    """ProgramCost (per-device) → RooflineTerms (flops/bytes totals); the
    collective term over ``links`` NVLink links a card."""
    return RooflineTerms(
        flops=cost.flops * n_chips,
        hbm_bytes=cost.hbm_bytes * n_chips,
        collective_bytes=float(cost.collectives.total_bytes),
        chips=n_chips,
        hw=hw,
        ici_links=links,
    )


__all__ = ["CollectiveStats", "ProgramCost", "StepCost", "collective_stats",
           "program_cost", "roofline_from_cost"]
