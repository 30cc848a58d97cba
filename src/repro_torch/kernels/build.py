"""Build the port's CUDA kernels and load them through ``ctypes``.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface (no PyTorch headers, so a
build takes seconds, not minutes).  The libraries go into ``build/kernels``
at the root of the checkout (listed in ``.gitignore``; override with
``REPRO_TORCH_BUILD_DIR``), named by a hash of the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source or header is
rebuilt.  All sources compile in parallel, once per process, at first
use: :func:`build_kernels` is called when the first CUDA engine is
created, and every kernel wrapper calls :func:`library`.

Nothing here runs at import: the CPU tests import every module of the
port on a host without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("flash_attention", "decode_attention", "ssd_scan", "rglru_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the C entries' contract: dtype codes, the head dims they are built for
# and the ``route`` argument of the kernels with two routes (flash, decode
# and SSD; 0 lets the shape decide)
DTYPE_CODES = {"float32": 0, "bfloat16": 1}
HEAD_DIMS = (8, 16, 32, 64, 128, 256)
TENSOR_CORE_HEAD_DIMS = HEAD_DIMS[1:]   # mma.sync needs a depth of 16
ROUTE_BY_SHAPE = 0
ROUTE_CODES = {"cuda_core": 1, "tensor_core": 2}
MAX_SMEM_BYTES = 232_448          # one block's shared memory on an H100

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas resource lines (registers, shared memory, spills) of the last build
build_log: Dict[str, str] = {}


class KernelStats:
    """Launch counts of one kernel wrapper.

    ``launches_by_route`` grows where the wrapper launches its CUDA
    kernels, and nowhere else, by the number of ``__global__`` kernels
    that call put on the device, under the route that took the call
    (``"cuda_core"`` or ``"tensor_core"``; ``"chunked"`` for the RG-LRU
    scan, which has one); ``launches`` is their sum.
    ``cpu_calls`` counts calls that took the plain PyTorch version
    because the tensors lay on the CPU.  Updates are locked: serving
    runners call the wrappers from several threads.
    """

    def __init__(self) -> None:
        self.launches_by_route: Dict[str, int] = {}
        self.cpu_calls = 0
        self._lock = threading.Lock()

    @property
    def launches(self) -> int:
        return sum(self.launches_by_route.values())

    def launched(self, kernels: int = 1, route: str = "cuda_core") -> None:
        with self._lock:
            self.launches_by_route[route] = \
                self.launches_by_route.get(route, 0) + kernels

    def cpu_call(self) -> None:
        with self._lock:
            self.cpu_calls += 1

    def reset(self) -> None:
        with self._lock:
            self.launches_by_route = {}
            self.cpu_calls = 0


def route_code(name: str, force: str) -> int:
    """The C entry's ``route`` argument for a launch of kernel ``name``:
    :data:`ROUTE_BY_SHAPE` when nothing is forced, else the forced route's
    code; a name that is not one of :data:`ROUTE_CODES` raises."""
    if not force:
        return ROUTE_BY_SHAPE
    if force not in ROUTE_CODES:
        raise ValueError(f"{name}: no route {force!r}; its routes are "
                         f"{sorted(ROUTE_CODES)}")
    return ROUTE_CODES[force]


def aligned(x):
    """x contiguous with a 16-byte aligned start: the tensor-core kernels
    copy rows in 16-byte pieces."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                           "kernels are built from csrc/ at first use")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.name.encode() + h.read_bytes()
                       for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"lib{name}-{digest[:16]}.so"


def _declare(name: str, lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.kernel_error_string.argtypes = [i]
    lib.kernel_error_string.restype = ctypes.c_char_p
    if name == "flash_attention":
        lib.flash_attention_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                                            i, f, i, i, p]
        lib.flash_attention_fwd.restype = i
    elif name == "decode_attention":
        lib.decode_attention_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                                             i, f, i, i, p]
        lib.decode_attention_fwd.restype = i
        lib.decode_attention_smem_bytes.argtypes = [i, i, i]
        lib.decode_attention_smem_bytes.restype = ctypes.c_longlong
    elif name == "ssd_scan":
        lib.ssd_scan_fwd.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i,
                                     i, i, i, i, i, i, p]
        lib.ssd_scan_fwd.restype = i
        lib.ssd_scan_smem_bytes.argtypes = [i, i, i]
        lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
    elif name == "rglru_scan":
        lib.rglru_scan_fwd.argtypes = [p, p, p, i, i, i, i, p]
        lib.rglru_scan_fwd.restype = i


def build_kernels() -> float:
    """Compile every missing library (one ``nvcc`` per source, all started
    together) and load them all; returns the seconds spent.  Idempotent."""
    t0 = time.perf_counter()
    with _lock:
        todo = [n for n in SOURCES if n not in _libs]
        if not todo:
            return 0.0
        out_dir = build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in todo:
            path = _lib_path(name)
            if path.is_file():
                continue
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, path)
        failed = []
        for name, (proc, tmp, path) in procs.items():
            out, _ = proc.communicate()
            build_log[name] = out
            if proc.returncode != 0:
                failed.append(f"{name}:\n{out}")
                continue
            os.replace(tmp, path)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for name in todo:
            lib = ctypes.CDLL(str(_lib_path(name)))
            _declare(name, lib)
            _libs[name] = lib
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, building it first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_kernels()
        lib = _libs[name]
    return lib


def refuse_grad(name: str, *tensors) -> None:
    """Raise if autograd would need a gradient through a kernel call.

    A kernel fills its outputs through ``ctypes``, so they have no
    ``grad_fn``: under grad mode, an input that requires grad would see
    its gradient stop at the kernel without a word.  The plain version
    (a CPU tensor) is differentiable and is not checked.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward; an input requires "
            "grad under grad mode, and its gradient would stop here. Call "
            "it under torch.no_grad() or with use_pallas_kernels off")


def check(name: str, err: int) -> None:
    """Raise if a launch returned an error (see each ``*_fwd`` C entry)."""
    if err == 0:
        return
    if err == -1:
        raise ValueError(f"{name}: no CUDA kernel for this shape / dtype")
    msg = library(name).kernel_error_string(err).decode()
    raise RuntimeError(f"{name}: CUDA launch failed with error {err} ({msg})")
