"""Flash attention forward (prefill): the CUDA kernel and its wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention``, body ``_flash_kernel``).  The kernel is
``csrc/flash_attention.cu`` (built for sm_90a by :mod:`.build`); its
source note says what bounds it on an H100 and how the design answers.

The library has two routes, chosen by dtype and head dim before the
launch (:func:`route`): bf16 with a head dim of 16..256 runs the
tensor-core kernel (``mma.sync``), fp32 and head dim 8 the CUDA-core
kernel.  :func:`flash_attention` always lets the shape decide;
:func:`launch` can force a route, which only ``chip_smoke.py`` and the
card tests do, to time and check both kernels on the same inputs.

For a CUDA tensor the wrapper launches the kernel or raises; for a CPU
tensor it computes the plain version, :func:`.ref.flash_attention_ref`.
``stats`` counts both, launches by route.
"""

from __future__ import annotations

import math

import torch

from . import build
from .ref import flash_attention_ref

stats = build.KernelStats()


def route(dtype: str, head_dim: int) -> str:
    """The route the C entry takes by shape: ``"tensor_core"`` for bf16
    with a head dim mma can take, else ``"cuda_core"`` (fp32 needs more
    than TF32's precision; head dim 8 is below mma's depth of 16)."""
    if dtype == "bfloat16" and head_dim in build.TENSOR_CORE_HEAD_DIMS:
        return "tensor_core"
    return "cuda_core"


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, Sq, H, D); k/v: (B, Sk, Hkv, D) → (B, Sq, H, D).

    Positions are absolute from 0 for both q and k; ``window`` > 0 keeps
    keys with ``qpos - window < kpos``.
    """
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    if H % Hkv:
        raise ValueError(f"flash_attention: q heads H={H} must be a "
                         f"multiple of kv heads Hkv={Hkv}")
    if q.device.type == "cpu":
        stats.cpu_call()
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q/k/v must share one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    dtype = str(q.dtype).removeprefix("torch.")
    if not (q.dtype == k.dtype == v.dtype) or dtype not in build.DTYPE_CODES:
        raise ValueError(f"flash_attention: q/k/v must all be float32 or "
                         f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in build.HEAD_DIMS or k.shape[3] != D or v.shape != k.shape \
            or k.shape[0] != B:
        raise ValueError(f"flash_attention: unsupported shapes q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} v={tuple(v.shape)} (head dim "
                         f"must be one of {build.HEAD_DIMS})")
    return launch(q, k, v, causal=causal, window=window)


def launch(q, k, v, *, causal: bool, window: int, force: str = ""):
    """Launch the CUDA kernel on checked CUDA tensors.  ``force`` ``""``
    lets the shape decide (:func:`route`); ``"cuda_core"`` or
    ``"tensor_core"`` forces a route, and one that cannot take the shape
    raises."""
    build.refuse_grad("flash_attention", q, k, v)
    code = build.route_code("flash_attention", force)
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    dtype = str(q.dtype).removeprefix("torch.")
    taken = force or route(dtype, D)
    q, k, v = build.aligned(q), build.aligned(k), build.aligned(v)
    out = torch.empty_like(q)
    lib = build.library("flash_attention")
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Sk,
        H, Hkv, D, int(causal), int(window), 1.0 / math.sqrt(D),
        build.DTYPE_CODES[dtype], code,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check("flash_attention", err)
    stats.launched(route=taken)
    return out
