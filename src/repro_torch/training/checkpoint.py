"""Checkpointing with manifest + async save, in the reference's format.

A port of ``repro/training/checkpoint.py`` that writes and reads the
same files, so a checkpoint written by either package restores in the
other, bit for bit.  Layout (one directory per step):

    <dir>/step_000000100/
        manifest.json        {step, leaf names, shapes, dtypes, files}
        leaf_00000.npy ...   one file per tree leaf (np.save)
        _COMPLETE            commit marker written last (atomic restore rule)

A leaf's name is its key path as the reference prints it
(``training.tree``); a bf16 leaf is stored as its ``uint16`` bits with
the logical dtype ``"bfloat16"`` in the manifest, as the reference
stores it (no ``ml_dtypes`` here: the bits cross through
``torch.int16``).

Fault-tolerance contract, the reference's:
* a checkpoint without ``_COMPLETE`` is ignored by ``latest_step`` — a
  writer killed mid-save can never corrupt restore;
* ``save`` copies every leaf to the host first, then can write in a
  background thread while the next train steps run;
* ``keep`` bounds disk usage (old committed steps garbage-collected).

The reference's ``shard_filter`` (each host of a multi-host job writes
the leaves it owns) has no caller in either package and is not ported;
the port runs on one device.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.convert import tensor_to_numpy
from .tree import PyTree, leaves_with_path, tree_unflatten

_COMPLETE = "_COMPLETE"

# a logical dtype numpy cannot hold -> its stored integer view (the
# reference's _VIEW_DTYPES that a torch tensor can hold)
_VIEW_DTYPES = {"bfloat16": np.uint16}


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _from_storable(arr: np.ndarray, logical_dtype: str) -> torch.Tensor:
    """A stored array as a CPU tensor of its logical dtype (the bits of
    a ``uint16`` view cross as ``int16``, which torch reads everywhere)."""
    arr = np.array(arr)
    if _VIEW_DTYPES.get(logical_dtype) == arr.dtype:
        return torch.from_numpy(arr.view(np.int16)).view(
            getattr(torch, logical_dtype))
    return torch.from_numpy(arr)


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = False):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ #
    def _step_dir(self, step: int) -> pathlib.Path:
        return self.dir / f"step_{step:09d}"

    def save(self, step: int, params: PyTree, opt_state: PyTree = None
             ) -> None:
        """Write a checkpoint (optionally in a background thread)."""
        tree = {"params": params, "opt_state": opt_state}
        # copy to host memory synchronously (the next step may replace
        # the tensors), then write async if requested
        leaves = [(name, _dtype_name(leaf), tensor_to_numpy(leaf))
                  for name, leaf in leaves_with_path(tree)]

        def write():
            sd = self._step_dir(step)
            tmp = sd.with_suffix(".tmp")
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {"step": step, "leaves": []}
            for i, (name, logical, arr) in enumerate(leaves):
                fname = f"leaf_{i:05d}.npy"
                np.save(tmp / fname, arr)
                manifest["leaves"].append(
                    {"name": name, "file": fname,
                     "shape": list(arr.shape), "dtype": logical})
            with open(tmp / "manifest.json", "w") as f:
                json.dump(manifest, f)
            (tmp / _COMPLETE).touch()
            if sd.exists():
                shutil.rmtree(sd)
            tmp.rename(sd)
            self._gc()

        self.wait()
        if self.async_save:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------ #
    def all_steps(self) -> List[int]:
        out = []
        for p in sorted(self.dir.glob("step_*")):
            if p.is_dir() and (p / _COMPLETE).exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, *, like: PyTree = None
                ) -> Dict:
        """Load {params, opt_state}; ``like`` gives the tree's structure
        and each leaf's dtype and device.  Without it, ``arrays`` maps
        each leaf name to a CPU tensor of its logical dtype."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        sd = self._step_dir(step)
        if not (sd / _COMPLETE).exists():
            raise FileNotFoundError(f"checkpoint {sd} is uncommitted")
        with open(sd / "manifest.json") as f:
            manifest = json.load(f)
        by_name = {l["name"]: _from_storable(
            np.load(sd / l["file"], mmap_mode="r"), l["dtype"])
            for l in manifest["leaves"]}
        if like is None:
            return {"step": step, "arrays": by_name}
        out = []
        for name, leaf in leaves_with_path(like):
            if name not in by_name:
                raise KeyError(f"checkpoint missing leaf {name}")
            t = by_name[name]
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"shape mismatch for {name}: ckpt {tuple(t.shape)} vs "
                    f"model {tuple(leaf.shape)}")
            out.append(t.to(device=leaf.device, dtype=leaf.dtype))
        return {"step": step, "tree": tree_unflatten(like, out)}


__all__ = ["Checkpointer"]
