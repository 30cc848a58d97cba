"""Mamba2 chunked SSD scan: the CUDA kernel and its wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py``
(``ssd_scan``, body ``_ssd_kernel``).  The kernel is
``csrc/ssd_scan.cu`` (built for sm_90a by :mod:`.build`); its source
note says what bounds it on an H100 and how the design answers.

Unlike the reference, which returns y only, the wrapper returns
``(y, final_state)``: the kernel also writes the (B, H, P, N) fp32 state
after the last step, which prefill stores in the decode cache.  For a
CUDA tensor the wrapper launches the kernel or raises; for a CPU tensor
it computes the plain version, :func:`.ref.ssd_scan_ref`.  ``stats``
counts both.  ``ops.ssd_scan`` is this function: the reference's
wrapper adds no padding, and the S % chunk rule is checked here.
"""

from __future__ import annotations

import torch

from . import build
from .ref import ssd_scan_ref

stats = build.KernelStats()

TC_MAX_CHUNK = 128
# device kernels one call enqueues, by route
KERNELS_PER_CALL = {"tensor_core": 3, "cuda_core": 1}


def tc_smem_bytes(P: int, N: int, chunk: int) -> int:
    """Shared memory of the larger tensor-core block (``ssd_scan.cu``'s
    ``tc_smem``): chunk-state pass cs/dt/w + B + x·w hi/lo, chunk-scan
    pass cs/dt/exp(cs) + C + B + x + h_in hi/lo, rows padded by 8."""
    state = 16 * chunk + 2 * (chunk * (N + 8) + 2 * chunk * (P + 8))
    scan = 16 * chunk + 2 * (2 * chunk * (N + 8) + chunk * (P + 8)
                             + 2 * P * (N + 8))
    return max(state, scan)


def route(dtype: str, P: int, N: int, chunk: int) -> str:
    """The route the C entry takes by shape: ``"tensor_core"`` for bf16
    with P, N and chunk multiples of 16, chunk <= 128 and the blocks'
    shared memory within one SM's; else ``"cuda_core"``."""
    if (dtype == "bfloat16" and P % 16 == 0 and N % 16 == 0
            and chunk % 16 == 0 and 0 < chunk <= TC_MAX_CHUNK
            and tc_smem_bytes(P, N, chunk) <= build.MAX_SMEM_BYTES):
        return "tensor_core"
    return "cuda_core"


def _validate(x, dt, a_log, B_in, C_in, chunk: int) -> None:
    if x.ndim != 4:
        raise ValueError(f"ssd_scan: x must be (B, S, H, P), got "
                         f"{tuple(x.shape)}")
    Bb, S, H, P = x.shape
    if tuple(dt.shape) != (Bb, S, H) or tuple(a_log.shape) != (H,):
        raise ValueError(f"ssd_scan: dt must be {(Bb, S, H)} and a_log "
                         f"{(H,)}, got {tuple(dt.shape)}, "
                         f"{tuple(a_log.shape)}")
    if B_in.ndim != 4 or B_in.shape != C_in.shape \
            or tuple(B_in.shape[:2]) != (Bb, S):
        raise ValueError(f"ssd_scan: B_in/C_in must be (B, S, G, N) with "
                         f"B={Bb}, S={S}, got {tuple(B_in.shape)}, "
                         f"{tuple(C_in.shape)}")
    G = B_in.shape[2]
    if H % G:
        raise ValueError(f"ssd_scan: heads H={H} must be a multiple of "
                         f"groups G={G}")
    if chunk <= 0 or S % chunk:
        raise ValueError(f"ssd_scan: sequence length S={S} must be a "
                         f"multiple of chunk={chunk}; pad with dt = 0 "
                         "first (the SSM block does)")


def ssd_scan(x, dt, a_log, B_in, C_in, *, chunk: int = 64):
    """x: (B, S, H, P); dt: (B, S, H); a_log: (H,); B_in/C_in: (B, S, G, N).

    Returns y (B, S, H, P) in x's dtype and the final state (B, H, P, N)
    in fp32.  S must be a multiple of ``chunk``.
    """
    _validate(x, dt, a_log, B_in, C_in, chunk)
    if x.device.type == "cpu":
        stats.cpu_call()
        return ssd_scan_ref(x, dt, a_log, B_in, C_in, chunk=chunk)
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev
                                 for t in (dt, a_log, B_in, C_in)):
        raise ValueError("ssd_scan: x, dt, a_log, B_in and C_in must share "
                         f"one CUDA device, got {x.device}, {dt.device}, "
                         f"{a_log.device}, {B_in.device}, {C_in.device}")
    dtype = str(x.dtype).removeprefix("torch.")
    if dtype not in build.DTYPE_CODES or not (
            x.dtype == B_in.dtype == C_in.dtype):
        raise ValueError(f"ssd_scan: x, B_in and C_in must all be float32 "
                         f"or bfloat16, got {x.dtype}, {B_in.dtype}, "
                         f"{C_in.dtype}")
    return launch(x, dt, a_log, B_in, C_in, chunk=chunk)


def launch(x, dt, a_log, B_in, C_in, *, chunk: int, force: str = ""):
    """Launch the CUDA kernels on checked CUDA tensors.  ``force`` ``""``
    lets the shape decide (:func:`route`); ``"cuda_core"`` or
    ``"tensor_core"`` forces a route, and one that cannot take the shape
    raises."""
    build.refuse_grad("ssd_scan", x, dt, a_log, B_in, C_in)
    code = build.route_code("ssd_scan", force)
    Bb, S, H, P = x.shape
    G, N = B_in.shape[2], B_in.shape[3]
    dev = x.device
    dtype = str(x.dtype).removeprefix("torch.")
    taken = force or route(dtype, P, N, chunk)
    lib = build.library("ssd_scan")
    ws = h_in = cs_end = None
    if taken == "cuda_core":
        if P % 4 or N % 4 or chunk % 4:
            raise ValueError(f"ssd_scan: head dim P={P}, state N={N} and "
                             f"chunk={chunk} must be multiples of 4 on CUDA")
        if lib.ssd_scan_smem_bytes(P, N, chunk) > build.MAX_SMEM_BYTES:
            raise ValueError(f"ssd_scan: P={P}, N={N}, chunk={chunk} does "
                             "not fit one block's shared memory")
    else:
        nc = S // chunk
        ws = torch.empty((Bb, H, nc, P, N), dtype=torch.float32, device=dev)
        h_in = torch.empty((Bb, H, nc, 2, P, N), dtype=torch.bfloat16,
                           device=dev)
        cs_end = torch.empty((Bb, H, nc), dtype=torch.float32, device=dev)
    x, B_in, C_in = build.aligned(x), build.aligned(B_in), build.aligned(C_in)
    dt = dt.to(torch.float32).contiguous()
    a_log = a_log.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    state = torch.empty((Bb, H, P, N), dtype=torch.float32, device=dev)
    err = lib.ssd_scan_fwd(
        x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), B_in.data_ptr(),
        C_in.data_ptr(), y.data_ptr(), state.data_ptr(),
        *(t.data_ptr() if t is not None else None
          for t in (ws, h_in, cs_end)), Bb, S, H, G, P, N, chunk,
        build.DTYPE_CODES[dtype], code,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check("ssd_scan", err)
    stats.launched(KERNELS_PER_CALL[taken], route=taken)
    return y, state
