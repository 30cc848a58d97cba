"""Production mesh construction on ``torch.distributed``.

A port of ``repro/launch/mesh.py``: each function returns an
``init_device_mesh`` with ``mesh_dim_names``.  Nothing here touches
process-group state when the module is imported; a mesh needs a default
process group of at least its size, which ``init_device_mesh`` starts
from the ``torchrun`` environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ...) unless the caller has started one.  To ask the
sharding rules about a 256- or 512-rank mesh in one process, start the
``"fake"`` backend first (``torch.testing._internal.distributed.fake_pg``
``FakeStore``; :func:`fake_world` does) and build the mesh with
``device_type="cpu"``.

Each function takes ``device_type=`` and defaults to ``"cuda"``: without
a card it raises unless the caller asks for ``"cpu"``.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Tuple

from .. import resolve_device


@contextlib.contextmanager
def fake_world(n_ranks: int) -> Iterator[None]:
    """A default process group of at least ``n_ranks`` ranks for meshes
    that hold no device: torch's ``"fake"`` backend, rank 0 of
    ``n_ranks``, started here and destroyed on exit unless a group of
    that size or more already runs (then it is used as it is)."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() < n_ranks:
            raise RuntimeError(f"a process group of {n_ranks} ranks is "
                               f"needed; {dist.get_world_size()} run")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *,
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes``."""
    from torch.distributed.device_mesh import init_device_mesh
    resolve_device(device_type)
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16×16 = 256 chips per pod; 2 pods = 512 chips multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_submesh(n_chips: int, *, model_parallel: Optional[int] = None,
                 device_type: str = "cuda"):
    """A thin-instance sub-mesh of ``n_chips`` devices: (data', model').

    Packrat's ⟨i,t,b⟩ instances are SPMD-identical, so one representative
    instance runs on a t-device sub-mesh.  ``model_parallel`` defaults to
    all devices (a pure tensor-parallel thin instance).
    """
    tp = model_parallel or n_chips
    if n_chips % tp:
        raise ValueError(f"{tp=} must divide {n_chips=}")
    dp = n_chips // tp
    return make_mesh((dp, tp), ("data", "model"), device_type=device_type)


__all__ = ["fake_world", "make_mesh", "make_production_mesh",
           "make_submesh"]
