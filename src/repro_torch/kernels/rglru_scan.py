"""RG-LRU linear scan: the CUDA kernel and its wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/rglru_scan.py``
(``rglru_scan``, body ``_rglru_kernel``).  The kernel is
``csrc/rglru_scan.cu`` (built for sm_90a by :mod:`.build`); its source
note says what bounds it on an H100 and how the design answers.

One kernel takes every shape: chunks of :data:`CHUNK_STEPS` steps
scanned in parallel, then joined.  Its launches count under the route
name ``"chunked"``.

For a CUDA tensor the wrapper launches the kernel or raises; for a CPU
tensor it computes the plain version, :func:`.ref.rglru_scan_ref`.
``stats`` counts both.
"""

from __future__ import annotations

import torch

from . import build
from .ref import rglru_scan_ref

stats = build.KernelStats()

CHUNK_STEPS = 32                  # steps per chunk (kChunk in the kernel)


def rglru_scan(a, b, *, block_s: int = 128, block_w: int = 512):
    """a/b: (B, S, W) → h_all (B, S, W) fp32 with h_t = a_t·h_{t-1} + b_t.

    ``block_s``/``block_w`` are the reference's tiles: they must divide S
    and W (the reference's assertion, a ``ValueError`` here) and do not
    shape the CUDA launch.
    """
    if a.ndim != 3 or a.shape != b.shape:
        raise ValueError(f"rglru_scan: a and b must be (B, S, W) of one "
                         f"shape, got {tuple(a.shape)}, {tuple(b.shape)}")
    B, S, W = a.shape
    bs, bw = min(block_s, S), min(block_w, W)
    if bs <= 0 or bw <= 0 or S % bs or W % bw:
        raise ValueError(f"rglru_scan: block_s={bs} and block_w={bw} must "
                         f"divide S={S} and W={W} (ops.rglru_scan halves "
                         "them until they do)")
    if a.device.type == "cpu":
        stats.cpu_call()
        return rglru_scan_ref(a, b)[0]
    dev = a.device
    if dev.type != "cuda" or b.device != dev:
        raise ValueError(f"rglru_scan: a and b must share one CUDA device, "
                         f"got {a.device}, {b.device}")
    dtype = str(a.dtype).removeprefix("torch.")
    if dtype not in build.DTYPE_CODES or b.dtype != a.dtype:
        raise ValueError(f"rglru_scan: a and b must both be float32 or "
                         f"bfloat16, got {a.dtype}, {b.dtype}")
    a, b = a.contiguous(), b.contiguous()
    h = torch.empty((B, S, W), dtype=torch.float32, device=dev)
    err = build.library("rglru_scan").rglru_scan_fwd(
        a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S, W,
        build.DTYPE_CODES[dtype], torch.cuda.current_stream(dev).cuda_stream)
    build.check("rglru_scan", err)
    stats.launched(route="chunked")
    return h
