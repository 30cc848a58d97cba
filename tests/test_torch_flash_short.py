"""The port's short-sequence flash route (attn-tiny's path), on the CPU.

* The pure rule that decides whether ``ops.flash_attention`` pads a
  call (``ops.flash_pads``): a causal call on a card whose shapes the
  short route takes goes to the kernel as it is; the CPU, non-causal
  calls and every other shape keep the reference's padding.  The
  wrapper hands the kernel module the padded or unpadded shapes that
  rule names.
* A test-local PyTorch mirror of ``flash_short_kernel``: 16 key slots
  whatever Sk is (zero-filled past it), each query row's scores masked
  by position against the true Sq and Sk with the finite -0.7·FLT_MAX,
  one softmax (no rescaling: one tile holds every key), P·V summed per
  lane over the even and the odd slots and the two halves added.  Held
  against the JAX package's oracle and its Pallas kernel (interpret
  mode, as ``tests/test_kernels.py`` runs it) at fp32's tolerance (atol
  = rtol = 2e-5), at attn-tiny's rungs and the route's limits; and the
  mirror of an unpadded call equals the mirror of the same call padded
  to 16 bit for bit, which is what lets the card skip the padding.

The kernel itself runs only on a card (``tests/test_torch_card.py``,
``chip_smoke.py``).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402

jax.config.update("jax_enable_x64", False)

FP32_TOL = dict(atol=2e-5, rtol=2e-5)   # tests/test_kernels.py's fp32
NEG_INF = -0.7 * float(np.finfo(np.float32).max)


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """Tiny CPU ops run far slower under an oversubscribed intra-op pool
    (several test workers share the host); the tests need one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------- #
# the wrapper's padding rule
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("device,dtype,causal,sq,sk,D,pads", [
    ("cuda", "float32", True, 16, 16, 16, False),   # attn-tiny's rungs
    ("cuda", "float32", True, 8, 8, 16, False),
    ("cuda", "float32", True, 4, 4, 16, False),
    ("cuda", "float32", True, 1, 16, 32, False),
    ("cpu", "float32", True, 8, 8, 16, True),       # the reference's rule
    ("cpu", "float32", True, 4, 4, 16, True),
    ("cuda", "float32", False, 8, 8, 16, True),     # keeps its checks
    ("cuda", "float32", True, 17, 17, 16, True),    # past the limits
    ("cuda", "float32", True, 8, 8, 64, True),
    ("cuda", "bfloat16", True, 8, 8, 16, True),     # tensor cores
    ("cuda", "bfloat16", True, 8, 8, 8, True),
])
def test_flash_pads_rule(device, dtype, causal, sq, sk, D, pads):
    assert ops.flash_pads(device, dtype, causal, sq, sk, D) is pads
    assert pads or flash_mod.route(dtype, D, sq, sk) == "short"


@pytest.mark.parametrize("S,padded", [(16, 16), (8, 16), (4, 16), (20, 32)])
def test_cpu_wrapper_keeps_the_reference_padding(monkeypatch, S, padded):
    """On the CPU the kernel module sees the reference's padded shapes;
    with the rule exempting the call, the unpadded ones."""
    seen = []

    def spy(q, k, v, *, causal, window):
        seen.append((q.shape[1], k.shape[1], v.shape[1]))
        return torch.zeros_like(q)

    monkeypatch.setattr(ops, "_flash_attention", spy)
    x = torch.zeros((2, S, 2, 16))
    assert ops.flash_attention(x, x, x, causal=True).shape == x.shape
    assert seen == [(padded,) * 3]
    monkeypatch.setattr(ops, "flash_pads", lambda *a: False)
    assert ops.flash_attention(x, x, x, causal=True).shape == x.shape
    assert seen[-1] == (S,) * 3


# --------------------------------------------------------------------- #
# a mirror of the short kernel
# --------------------------------------------------------------------- #
def short_mirror(q, k, v, *, causal=True, window=0):
    """``flash_short_kernel`` on fp32 CPU tensors, one query row at a time
    (so a row's arithmetic has the same shapes whatever Sq is): 16 key
    slots, rows past Sk zero-filled; scores masked by position; m = the
    max over the slots, p = exp(s - m), l = sum p; P·V summed over the
    even slots and over the odd ones in slot order, the halves added,
    times 1 / max(l, 1e-30)."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    n = build.SHORT_MAX_SEQ
    kp = torch.zeros((B, n, Hkv, D))
    vp = torch.zeros((B, n, Hkv, D))
    kp[:, :Sk], vp[:, :Sk] = k, v
    kp = torch.repeat_interleave(kp, H // Hkv, 2)   # (B, n, H, D)
    vp = torch.repeat_interleave(vp, H // Hkv, 2)
    scale = 1.0 / math.sqrt(D)
    out = torch.empty((B, Sq, H, D))
    for r in range(Sq):
        s = []
        for j in range(n):
            keep = j < Sk and (not causal or j <= r) and \
                (window <= 0 or j > r - window)
            dot = (q[:, r] * kp[:, j]).sum(-1) * scale       # (B, H)
            s.append(dot if keep else torch.full_like(dot, NEG_INF))
        m = torch.stack(s).max(0).values
        p = [torch.exp(x - m) for x in s]
        halves, lsum = [], []
        for t in (0, 1):
            acc = torch.zeros((B, H, D))
            part = torch.zeros((B, H))
            for j in range(t, n, 2):
                acc = acc + p[j][..., None] * vp[:, j]
                part = part + p[j]
            halves.append(acc)
            lsum.append(part)
        inv = 1.0 / torch.clamp(lsum[0] + lsum[1], min=1e-30)
        out[:, r] = (halves[0] + halves[1]) * inv[..., None]
    return out


def _inputs(seed, B, Sq, Sk, H, Hkv, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))]


@pytest.mark.parametrize("S", (16, 8, 4))
@pytest.mark.parametrize("B", (1, 3))
def test_short_mirror_matches_pallas_at_attn_tiny_rungs(B, S):
    """attn-tiny's rungs (2 heads of 16): the mirror against the JAX
    package's Pallas kernel (which pads 8 and 4 to 16) and its oracle."""
    q, k, v = _inputs(100 + 7 * B + S, B, S, S, 2, 2, 16)
    got = short_mirror(*(torch.from_numpy(x) for x in (q, k, v)))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jops.flash_attention(jq, jk, jv,
                                                     causal=True)),
        **FP32_TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.flash_attention_ref(jq, jk, jv,
                                                         causal=True)),
        **FP32_TOL)


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal,window", [
    (2, 16, 16, 4, 1, 32, True, 0),      # the limits, a group of 4
    (2, 16, 16, 4, 2, 8, True, 5),       # head dim 8, a window
    (1, 1, 16, 2, 2, 16, True, 0),       # one query row
    (2, 16, 3, 2, 1, 16, True, 0),       # rows past the last key
    (2, 12, 12, 2, 2, 16, False, 0),     # not causal
    (1, 5, 9, 2, 1, 32, False, 0),
])
def test_short_mirror_matches_the_oracle_at_the_route_limits(
        B, Sq, Sk, H, Hkv, D, causal, window):
    q, k, v = _inputs(200 + Sq + Sk + D, B, Sq, Sk, H, Hkv, D)
    assert flash_mod.route("float32", D, Sq, Sk) == "short"
    got = short_mirror(*(torch.from_numpy(x) for x in (q, k, v)),
                       causal=causal, window=window)
    want = jref.flash_attention_ref(*(jnp.asarray(x) for x in (q, k, v)),
                                    causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)


@pytest.mark.parametrize("S", (8, 4, 1, 13))
@pytest.mark.parametrize("window", (0, 3))
def test_short_mirror_unpadded_equals_padded_bit_for_bit(S, window):
    """A causal call padded with zeros to 16 rows and keys gives the
    unpadded call's bits on its first S rows: the masked slots add exact
    zeros in the same slot order."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(300 + S, 3, S, S, 2, 2,
                                                      16))

    def pad(x):
        return torch.cat([x, x.new_zeros((3, 16 - S, 2, 16))], 1)

    got = short_mirror(q, k, v, window=window)
    padded = short_mirror(pad(q), pad(k), pad(v), window=window)[:, :S]
    assert torch.equal(got, padded)
