"""Mamba2 chunked SSD scan: the CUDA kernel and its wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py``
(``ssd_scan``, body ``_ssd_kernel``).  The kernel is
``csrc/ssd_scan.cu`` (built for sm_90a by :mod:`.build`); its source
note says what bounds it on an H100 and how the design answers.

Unlike the reference, which returns y only, the wrapper returns
``(y, final_state)``: the kernel also writes the (B, H, P, N) fp32 state
after the last step, which prefill stores in the decode cache.  bf16 at
the serving shapes runs on the tensor cores as one launch, a cluster of
blocks per (batch row, head) handing the state on in distributed shared
memory (:func:`cluster_plan`); the CUDA cores run three passes.  For a
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
CLUSTER = 8                       # the largest cluster size
CLUSTERS = (1, 2, 4, 8)           # the cluster sizes the kernel launches
# device kernels one call enqueues: the tensor cores' cluster launch, or
# three passes (chunk states, the state pass, the chunk scan) on the CUDA
# cores
CLUSTER_KERNELS, PASS_KERNELS = 1, 3


def _block_bytes(P: int, N: int, chunk: int, cluster: int, carry: bool,
                 rows: int, cols: int) -> int:
    """Shared memory of the cluster kernel's block (``ssd_scan.cu``'s
    ``ClSmem``) for state tiles of ``rows`` x ``cols``: cs (fp64), dt,
    exp(cs), w, the round's cs_end (8); x; C; B, then h_in's hi and lo
    over it where the state is one tile (else B and a tile of h_in's
    pair apart); a tile of the round's state increments (fp32); the carry
    of a rank's P / cluster rows where the chunks take more than one
    round.  bf16 rows padded by 8, the increments' by 8."""
    bs, xs, ts = N + 8, P + 8, cols + 8
    if (rows, cols) == (P, N):
        h_in = 2 * max(chunk, 2 * P) * bs
    else:
        h_in = 2 * chunk * bs + 4 * rows * ts
    return (20 * chunk + 4 * CLUSTER + 2 * chunk * xs + 2 * chunk * bs
            + h_in + 4 * rows * ts
            + (4 * (P // cluster) * N if carry else 0))


def cluster_tiles(P: int, N: int, chunk: int):
    """The state's tiles (``cl_tiles``): (rows, columns) a tile, or None
    where no tiling fits.  Rows: the fewest tiles of at most 4 (chunk <=
    64) or 5 16-row pieces (y's column pairs a slab's warps hold in
    registers), as even as they come; columns: the fewest tiles whose
    block, with a carry at a cluster of 8, fits an SM."""
    pieces, most = P // 16, 4 if chunk <= 64 else 5
    rows = 16 * -(-pieces // -(-pieces // most))
    for n_tiles in range(1, N // 16 + 1):
        cols = 16 * -(-(N // 16) // n_tiles)
        if (_block_bytes(P, N, chunk, CLUSTER, True, rows, cols)
                <= build.MAX_SMEM_BYTES):
            return rows, cols
    return None


def cluster_smem_bytes(P: int, N: int, chunk: int, cluster: int,
                       carry: bool) -> int:
    """Shared memory of the cluster kernel's block at the shape's tiles
    (``cl_smem``)."""
    return _block_bytes(P, N, chunk, cluster, carry,
                        *cluster_tiles(P, N, chunk))


def tc_smem_bytes(P: int, N: int, chunk: int) -> int:
    """Shared memory of the tensor-core block the route's rule checks:
    the cluster kernel's, at the shape's tiles, with a carry at a cluster
    of 8."""
    return cluster_smem_bytes(P, N, chunk, CLUSTER, True)


def route(dtype: str, P: int, N: int, chunk: int) -> str:
    """The route the C entry takes by shape: ``"tensor_core"`` for bf16
    with P, N and chunk multiples of 16, chunk <= 128 and a tiling of the
    state whose cluster block fits one SM's shared memory; else
    ``"cuda_core"``."""
    if (dtype == "bfloat16" and P > 0 and N > 0 and P % 16 == 0
            and N % 16 == 0 and chunk % 16 == 0
            and 0 < chunk <= TC_MAX_CHUNK
            and cluster_tiles(P, N, chunk) is not None):
        return "tensor_core"
    return "cuda_core"


def kernels_per_call(dtype: str, P: int, N: int, chunk: int,
                     taken: str = "") -> int:
    """Device kernels one call enqueues on ``taken`` (default: the route
    by shape)."""
    taken = taken or route(dtype, P, N, chunk)
    return CLUSTER_KERNELS if taken == "tensor_core" else PASS_KERNELS


def cluster_plan(B: int, S: int, H: int, P: int, N: int, chunk: int,
                 max_clusters=None, cluster: int = 0) -> dict:
    """The cluster kernel's schedule for one call, as ``tc_cluster`` and
    ``ssd_cluster_kernel`` make it.  The size: of 1, 2, 4 and
    :data:`CLUSTER` (at most the chunks rounded up to a power of two),
    the one with the fewest waves × rounds, the smaller on a tie, among
    those whose block with its carry fits an SM; waves are the B·H
    clusters over ``max_clusters(c, carry)`` (the occupancy query's
    answer; None counts one wave).  ``cluster`` forces a size.  Rank r
    takes chunks r, r + C, ... (one a round); the state is cut into
    ``tiles`` (row ranges x column ranges, rows outer), and of each row
    tile [lo, hi) rank r walks rows [lo + r R, lo + (r + 1) R), R = (hi -
    lo) / C, over every round (``rows``)."""
    nc = S // chunk
    tiles = cluster_tiles(P, N, chunk)
    if tiles is None:
        raise ValueError(f"ssd_scan: no tiling fits P={P}, N={N}, "
                         f"chunk={chunk} on this card")

    def carry(c):
        return -(-nc // c) > 1

    def smem(c):
        return _block_bytes(P, N, chunk, c, carry(c), *tiles)

    c = cluster
    if not c:
        best = None
        size = 1
        while size <= CLUSTER and (size == 1 or size // 2 < nc):
            fits = smem(size) <= build.MAX_SMEM_BYTES
            held = (max_clusters(size, carry(size)) if max_clusters
                    else B * H) if fits else 0
            if held > 0:
                cost = -(-(B * H) // held) * -(-nc // size)
                if best is None or cost < best[0]:
                    best = (cost, size)
            size *= 2
        if best is None:
            raise ValueError(f"ssd_scan: no cluster size fits P={P}, N={N}, "
                             f"chunk={chunk} on this card")
        c = best[1]
    rows, cols = tiles
    row_tiles = [(lo, min(P, lo + rows)) for lo in range(0, P, rows)]
    col_tiles = [(lo, min(N, lo + cols)) for lo in range(0, N, cols)]
    return {"cluster": c, "rounds": -(-nc // c),
            "chunks": [list(range(r, nc, c)) for r in range(c)],
            "tiles": [(rt, ct) for rt in row_tiles for ct in col_tiles],
            "rows": [[(lo + r * (hi - lo) // c, lo + (r + 1) * (hi - lo) // c)
                      for lo, hi in row_tiles] for r in range(c)],
            "carry": carry(c), "smem_bytes": smem(c)}


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


def launch(x, dt, a_log, B_in, C_in, *, chunk: int, force: str = "",
           cluster: int = 0):
    """Launch the CUDA kernels on checked CUDA tensors.  ``force`` ``""``
    lets the shape decide (:func:`route`); ``"cuda_core"`` or
    ``"tensor_core"`` forces a route, and one that cannot take the shape
    raises.  ``cluster`` forces the cluster kernel's size (one of
    :data:`CLUSTERS`); 0 lets the library's rule choose it."""
    build.refuse_grad("ssd_scan", x, dt, a_log, B_in, C_in)
    code = build.route_code("ssd_scan", force)
    Bb, S, H, P = x.shape
    G, N = B_in.shape[2], B_in.shape[3]
    dev = x.device
    dtype = str(x.dtype).removeprefix("torch.")
    taken = force or route(dtype, P, N, chunk)
    kernels = kernels_per_call(dtype, P, N, chunk, taken)
    if cluster and (taken != "tensor_core" or cluster not in CLUSTERS
                    or route(dtype, P, N, chunk) != "tensor_core"):
        raise ValueError(f"ssd_scan: cluster {cluster} needs bf16 at a shape "
                         f"the tensor cores take and one of {CLUSTERS}")
    lib = build.library("ssd_scan")
    if taken == "cuda_core":
        if P % 4 or N % 4 or chunk % 4:
            raise ValueError(f"ssd_scan: head dim P={P}, state N={N} and "
                             f"chunk={chunk} must be multiples of 4 on CUDA")
        if lib.ssd_scan_smem_bytes(P, N, chunk) > build.MAX_SMEM_BYTES:
            raise ValueError(f"ssd_scan: P={P}, N={N}, chunk={chunk} does "
                             "not fit one block's shared memory")
    nc = S // chunk
    ws = h_in = cs_end = None
    if taken == "cuda_core":
        # workspaces of the three passes: the chunks' state increments, the
        # state entering each chunk and each chunk's decay
        ws = torch.empty((Bb, H, nc, P, N), dtype=torch.float32, device=dev)
        h_in = torch.empty((Bb, H, nc, P, N), dtype=torch.float32,
                           device=dev)
        cs_end = torch.empty((Bb, H, nc), dtype=torch.float32, device=dev)
    x, B_in, C_in = build.aligned(x), build.aligned(B_in), build.aligned(C_in)
    dt = dt.to(torch.float32).contiguous()
    a_log = a_log.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    state = torch.empty((Bb, H, P, N), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if cluster:
        err = lib.ssd_scan_tc_fwd(
            x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), B_in.data_ptr(),
            C_in.data_ptr(), y.data_ptr(), state.data_ptr(), Bb, S, H, G, P,
            N, chunk, cluster, stream)
    else:
        err = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), B_in.data_ptr(),
            C_in.data_ptr(), y.data_ptr(), state.data_ptr(),
            *(t.data_ptr() if t is not None else None
              for t in (ws, h_in, cs_end)),
            Bb, S, H, G, P, N, chunk, build.DTYPE_CODES[dtype], code, stream)
    build.check("ssd_scan", err)
    stats.launched(kernels, route=taken,
                   shape=(dtype, Bb, S, H, G, P, N, chunk))
    return y, state
