"""The CUDA-core route of the port's ssd_scan: its three passes on the CPU.

* A test-local PyTorch mirror of ``ssd_scan.cu``'s CUDA-core passes (chunk
  states, the state pass, the chunk scan) with the kernels' rounding
  points: the cumsum and the decays' differences in fp64, the scores
  C B^T in fp64 (the FP64 tensor cores), the masked decayed matrix M
  rounded once to fp32, and everything else (dS, the state, M x,
  C h_in^T) in fp32.  It is held against ``ref.ssd_scan_ref`` evaluated
  in fp64 and against the JAX package's own sequential recurrence
  (``repro.kernels.ref.ssd_scan_ref``) in fp64, at the grid's small
  shapes and at mamba2-130m's widths, with fp32's tolerance (atol = rtol
  = 2e-5) on y and the final state.  Where the JAX package's ``ssd_scan``
  in fp32 (the Pallas kernel in interpret mode, as ``tests/test_kernels.py``
  runs it) is itself within that tolerance of the fp64 recurrence (chunks
  of 16 and 32), the mirror is held against it too.  The JAX recurrence
  runs in fp64 in a subprocess with ``jax_enable_x64`` on, as
  ``tests/test_torch_distributed.py`` runs the reference: this process
  keeps x64 off for the Pallas kernel.
* Why the scores are fp64: summed as one fp32 chain over N, as one CUDA
  thread would sum them, y leaves the tolerance at mamba2-130m's serving
  shape; in fp64 it stays well inside.
* The wrapper's contract with the C entry on this route: three kernels a
  call, counted with the call's shape, and fp32 workspaces of the shapes
  the passes index.

The kernels themselves run only on a card (``tests/test_torch_card.py``,
``chip_smoke.py``).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import KERNEL_STATS, build, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402
from test_torch_ssm import _as, _ssd_inputs  # noqa: E402

jax.config.update("jax_enable_x64", False)

FP32_TOL = dict(atol=2e-5, rtol=2e-5)   # tests/test_kernels.py's fp32


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """Tiny CPU ops run far slower under an oversubscribed intra-op pool
    (several test workers share the host); the tests need one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scores_fp64(Cc, Bc):
    """C B^T per chunk with fp64 sums: the scan kernel's mma.sync f64."""
    return torch.einsum("bcihn,bcjhn->bchij", Cc.double(), Bc.double())


def _scores_fp32_chain(Cc, Bc):
    """C B^T summed over n as one fp32 chain, in order (what the kernels
    do not do)."""
    acc = torch.zeros(Cc.shape[:2] + (Cc.shape[3], Cc.shape[2], Bc.shape[2]))
    for n in range(Cc.shape[-1]):
        acc = acc + torch.einsum("bcih,bcjh->bchij", Cc[..., n], Bc[..., n])
    return acc.double()


def _ssd_three_pass(x, dt, a_log, B_in, C_in, *, chunk, scores=_scores_fp64):
    """y (x's dtype) and the final state (fp32) by ``ssd_scan.cu``'s
    CUDA-core passes, in PyTorch; ``scores`` forms C B^T."""
    Bb, S, H, P = x.shape
    G, N = B_in.shape[2], B_in.shape[3]
    nc, Q = S // chunk, chunk
    A = -torch.exp(a_log.float())
    xf = x.float().reshape(Bb, nc, Q, H, P)
    dtc = dt.float().reshape(Bb, nc, Q, H)
    grp = torch.arange(H) // (H // G)            # B/C read per group
    Bc = B_in.float()[:, :, grp].reshape(Bb, nc, Q, H, N)
    Cc = C_in.float()[:, :, grp].reshape(Bb, nc, Q, H, N)
    # fp64 cumsum of the fp32 dA; the decays' differences in fp64, their
    # exp in fp32
    cs = torch.cumsum((dtc * A).double(), 2)                  # (B,nc,Q,H)
    cs_end = cs[:, :, -1]
    # pass 1: dS_c = (x o w)^T B in fp32, w_j = exp(cs_end - cs_j) dt_j
    w = torch.exp((cs_end[:, :, None] - cs).float()) * dtc
    dS = torch.einsum("bcqhp,bcqhn->bchpn", xf * w[..., None], Bc)
    # pass 2: h_c = exp(cs_end,c) h_{c-1} + dS_c in fp32
    h = torch.zeros(Bb, H, P, N)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = torch.exp(cs_end[:, c].float())[..., None, None] * h + dS[:, c]
    h_in = torch.stack(h_in, 1)                               # (B,nc,H,P,N)
    # pass 3: M = C B^T o L o dt rounded once to fp32, then
    # y = M x + exp(cs) o (C h_in^T) in fp32
    csh = cs.permute(0, 1, 3, 2)                              # (B,nc,H,Q)
    L = torch.exp((csh[..., :, None] - csh[..., None, :]).float()).double()
    lower = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    M = torch.where(lower, scores(Cc, Bc) * (
        L * dtc.permute(0, 1, 3, 2).double()[..., None, :]), 0.0).float()
    y = torch.einsum("bchij,bcjhp->bcihp", M, xf)
    y = y + torch.einsum("bcihn,bchpn->bcihp", Cc, h_in) \
        * torch.exp(cs.float())[..., None]
    return y.reshape(Bb, S, H, P).to(x.dtype), h


def _fp64_recurrence(tin):
    y, h = ref.ssd_scan_ref(*(t.double() for t in tin))
    return y, h


def _worst(got, want):
    """The largest |got - want| over fp32's allowance atol + rtol |want|."""
    limit = FP32_TOL["atol"] + FP32_TOL["rtol"] * want.abs()
    return float(((got.double() - want.double()).abs() / limit).max())


# jax_near: whether the Pallas kernel in fp32 itself stays within fp32's
# tolerance of the recurrence in fp64 there.  At a chunk of 64 it does
# not on these inputs (its decays take fp32 differences of the cumsum),
# so there the mirror is held to the two fp64 recurrences only
FP32_CASES = [
    (1, 64, 2, 16, 1, 16, 16, True),
    (2, 128, 4, 16, 1, 32, 32, True),
    (1, 64, 4, 16, 2, 16, 16, True),      # grouped B/C, P = 16
    (2, 64, 4, 16, 1, 32, 64, False),     # one chunk (S = chunk)
    (1, 256, 24, 64, 1, 128, 64, False),  # mamba2-130m's widths
]
ROOT = Path(__file__).resolve().parents[1]

# The JAX package's recurrence in fp64.  It fixes its carry and A at
# float32, so it is handed a jax.numpy whose float32 is float64; its own
# code runs unchanged.
_JAX_FP64 = r'''
import sys
from pathlib import Path
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
from repro.kernels import ref


class _X64:
    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


ref.jnp = _X64()
out = Path(sys.argv[1])
for f in sorted(out.glob("in_*.npz")):
    a = np.load(f)
    y, h = ref.ssd_scan_ref(*(jnp.asarray(a[k], jnp.float64)
                              for k in ("x", "dt", "a_log", "B", "C")))
    assert y.dtype == h.dtype == jnp.float64, (y.dtype, h.dtype)
    np.savez(out / f.name.replace("in_", "out_"), y=np.asarray(y),
             h=np.asarray(h))
'''


def _case_inputs(B, S, H, P, G, N):
    return _ssd_inputs(B * 7 + S + P, B, S, H, P, G, N)


@pytest.fixture(scope="module")
def jax_fp64(tmp_path_factory):
    """{case: (y, h)}: the JAX package's recurrence in fp64 on each fp32
    case's inputs, from one subprocess."""
    out = tmp_path_factory.mktemp("ssd_fp64")
    for i, case in enumerate(FP32_CASES):
        x, dt, a_log, B_in, C_in = _case_inputs(*case[:6])
        np.savez(out / f"in_{i}.npz", x=x, dt=dt, a_log=a_log, B=B_in,
                 C=C_in)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, "-c", _JAX_FP64, str(out)],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    got = {}
    for i, case in enumerate(FP32_CASES):
        r = np.load(out / f"out_{i}.npz")
        got[case] = (torch.from_numpy(r["y"]), torch.from_numpy(r["h"]))
    return got


@pytest.mark.parametrize("B,S,H,P,G,N,chunk,jax_near", FP32_CASES)
def test_fp32_three_pass_algebra_matches_references(jax_fp64, B, S, H, P, G,
                                                    N, chunk, jax_near):
    arrays = _case_inputs(B, S, H, P, G, N)
    tin = _as("float32", *arrays, lib="torch")
    y, h = _ssd_three_pass(*tin, chunk=chunk)
    assert y.dtype == torch.float32 and h.shape == (B, H, P, N)
    # fp32's tolerance, on y and on the final state, against the port's
    # and the JAX package's recurrences in fp64
    jax_y, jax_h = jax_fp64[(B, S, H, P, G, N, chunk, jax_near)]
    for want_y, want_h in (_fp64_recurrence(tin), (jax_y, jax_h)):
        np.testing.assert_allclose(y.numpy(), want_y.numpy(), **FP32_TOL)
        np.testing.assert_allclose(h.numpy(), want_h.numpy(), **FP32_TOL)
    jy = torch.from_numpy(np.array(
        jops.ssd_scan(*_as("float32", *arrays, lib="jax"), chunk=chunk),
        np.float32))
    print(f"Pallas fp32 / fp64 recurrence: {_worst(jy, jax_y):.3f}, "
          f"mirror: {_worst(y, jax_y):.3f} (in units of the tolerance)")
    if jax_near:
        np.testing.assert_allclose(y.numpy(), jy.numpy(), **FP32_TOL)


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (1, 64, 2, 8, 1, 16, 16),       # P = 8: bf16 the tensor cores refuse
    (1, 64, 4, 8, 2, 16, 16),
])
def test_bf16_inputs_take_the_same_passes(B, S, H, P, G, N, chunk):
    """bf16 shapes the tensor cores refuse run these passes too, on the
    bf16 values widened to fp32 (bf16's tolerance, 2e-2)."""
    arrays = _ssd_inputs(B * 7 + S + P, B, S, H, P, G, N)
    tin = _as("bfloat16", *arrays, lib="torch")
    y, h = _ssd_three_pass(*tin, chunk=chunk)
    assert y.dtype == torch.bfloat16
    want_y, want_h = ref.ssd_scan_ref(*tin)
    np.testing.assert_allclose(y.float().numpy(), want_y.float().numpy(),
                               atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(h.numpy(), want_h.numpy(), atol=2e-2,
                               rtol=2e-2)


def test_fp32_scores_would_miss_the_tolerance():
    """Why the scores C B^T are summed in fp64: as one fp32 chain over
    N = 128 they move y past fp32's tolerance from the recurrence in fp64
    at mamba2-130m's serving shape (B = 4, S = 512), while the passes with
    fp64 scores stay well inside it."""
    B, S, H, P, G, N, chunk = 4, 512, 24, 64, 1, 128, 64
    tin = _as("float32", *_ssd_inputs(2, B, S, H, P, G, N), lib="torch")
    want_y, _ = _fp64_recurrence(tin)

    def worst(scores):
        return _worst(_ssd_three_pass(*tin, chunk=chunk, scores=scores)[0],
                      want_y)

    assert worst(_scores_fp64) <= 0.5 < 1.0 < worst(_scores_fp32_chain)


class _FakeLib:
    """Stands in for the built library: records the C entry's arguments."""

    def __init__(self):
        self.calls = []

    def ssd_scan_smem_bytes(self, P, N, Q):
        return 0

    def ssd_scan_fwd(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("dtype,P,N,chunk,taken,kernels", [
    ("float32", 64, 128, 64, "cuda_core", 3),     # mamba2-130m in fp32
    ("bfloat16", 8, 16, 16, "cuda_core", 3),      # P = 8
    ("bfloat16", 16, 32, 32, "tensor_core", 1),   # one cluster launch
    ("bfloat16", 80, 64, 64, "tensor_core", 1),   # P = 80
    ("bfloat16", 64, 128, 64, "tensor_core", 1),  # mamba2-130m
    ("bfloat16", 128, 16, 16, "tensor_core", 1),  # two row tiles, one launch
])
def test_wrapper_hands_each_route_its_workspaces(monkeypatch, dtype, P, N,
                                                 chunk, taken, kernels):
    """The C entry gets three fp32 workspaces where the CUDA cores' three
    passes run, sized as the passes index them, and none for the tensor
    cores' one cluster launch; each call counts its kernels (three
    passes, or one launch) on its route and one call of its shape."""
    lib = _FakeLib()
    allocated = []
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        allocated.append((tuple(t.shape), t.dtype, t.data_ptr()))
        return t

    class _Stream:
        cuda_stream = 0
    monkeypatch.setattr(build, "library", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    monkeypatch.setattr(torch, "empty", empty)
    Bb, S, H, G = 2, 4 * chunk, 4, 2
    nc = S // chunk
    tin = _as(dtype, *_ssd_inputs(5, Bb, S, H, P, G, N), lib="torch")
    stats = KERNEL_STATS["ssd_scan"]
    before = dict(stats.launches_by_route)
    key = (dtype, Bb, S, H, G, P, N, chunk)
    calls_before = stats.calls_by_shape.get(key, 0)
    assert ssd_mod.route(dtype, P, N, chunk) == taken
    y, h = ssd_mod.launch(*tin, chunk=chunk)
    assert y.shape == (Bb, S, H, P) and h.shape == (Bb, H, P, N)
    args = lib.calls[-1]
    ws, h_in, cs_end = args[7:10]
    by_ptr = {ptr: (shape, dt) for shape, dt, ptr in allocated}
    if kernels == 1:
        assert (ws, h_in, cs_end) == (None, None, None)
    else:
        assert by_ptr[ws] == ((Bb, H, nc, P, N), torch.float32)
        assert by_ptr[cs_end] == ((Bb, H, nc), torch.float32)
        assert by_ptr[h_in] == ((Bb, H, nc, P, N), torch.float32)
    assert args[10:17] == (Bb, S, H, G, P, N, chunk)
    assert args[17:19] == (build.DTYPE_CODES[dtype], build.ROUTE_BY_SHAPE)
    after = dict(stats.launches_by_route)
    assert ssd_mod.kernels_per_call(dtype, P, N, chunk) == kernels
    assert after.get(taken, 0) - before.get(taken, 0) == kernels
    assert stats.calls_by_shape[key] - calls_before == 1
