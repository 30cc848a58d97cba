"""The dense decoders the card serves at full width, against the JAX
reference on the CPU: reduced stablelm-12b and minitron-8b (reduced
llama3-8b is in ``tests/test_torch_models.py``).

Their features beyond llama3-8b's: LayerNorm (both), partial rotary
(25% for stablelm-12b, 50% for minitron-8b), per-head qk-norm
(stablelm-12b) and minitron-8b's non-gated squared-ReLU MLP.  The
reduced configurations keep them and set the head dim to d_model //
n_heads (16); stablelm-12b runs again at its published head dim of 160,
with its attention through the kernels on both sides: the reference's
Pallas kernels in interpret mode and the port's kernel wrappers, which
take their plain versions for CPU tensors.

The weights are the reference's (``jax.random.PRNGKey(0)``), bridged
through numpy (``tests/test_torch_models.py``'s ``_pair``).  Tolerance
(fp32): 2e-4 of the largest logit magnitude, the reference's own bound
for prefill + decode == forward; both sides differ only in summation
order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models.lm import apply_head as japply_head  # noqa: E402
from repro_torch.kernels import KERNEL_STATS  # noqa: E402
from repro_torch.models.lm import apply_head  # noqa: E402
from test_torch_models import (TOL, _leaves, _pair,  # noqa: E402
                               _prefill_then_decode, _rel, _tokens)

NAMES = ["stablelm-12b", "minitron-8b"]
# stablelm-12b at its published head dim, the kernels on (both sides)
HD160 = dict(head_dim=160, use_pallas_kernels=True)


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """Tiny CPU ops run far slower under an oversubscribed intra-op pool
    (several test workers share the host); the tests need one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name,norm,rope_pct,qk_norm,act", [
    ("stablelm-12b", "layernorm", 0.25, True, "silu"),
    ("minitron-8b", "layernorm", 0.5, False, "relu2"),
])
def test_reduced_configs_keep_the_family_features(name, norm, rope_pct,
                                                  qk_norm, act):
    """What these tests exercise beyond llama3-8b: the reduced configs on
    both sides keep the published norm, rotary share, qk-norm and MLP,
    and GQA (4 heads on 2)."""
    (jcfg, _, _), (tcfg, _, _) = _pair(name)
    for cfg in (jcfg, tcfg):
        assert (cfg.norm, cfg.rope_pct, cfg.qk_norm, cfg.act) == (
            norm, rope_pct, qk_norm, act)
        assert (cfg.n_heads, cfg.n_kv_heads) == (4, 2)


@pytest.mark.parametrize("name", NAMES)
def test_forward_logits_match_reference(name):
    (jcfg, jm, jp), (tcfg, tm, tp) = _pair(name)
    tok = _tokens(jcfg, 2, 96)
    want = japply_head(jp, jm.forward(jp, {"tokens": jnp.asarray(tok)}),
                       jcfg)
    with torch.no_grad():
        got = apply_head(tp, tm.forward(tp, {"tokens": torch.from_numpy(
            tok).long()}), tcfg)
    assert got.shape == (2, 96, tcfg.vocab_size)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    assert _rel(got, want, float(jnp.max(jnp.abs(want)))) < TOL


@pytest.mark.parametrize("name", NAMES)
def test_prefill_logits_and_cache_match_reference(name):
    (jcfg, jm, jp), (tcfg, tm, tp) = _pair(name)
    tok = _tokens(jcfg, 2, 80, seed=1)
    want_logits, want_cache = jm.prefill(jp, {"tokens": jnp.asarray(tok)},
                                         max_len=96)
    with torch.no_grad():
        got_logits, got_cache = tm.prefill(
            tp, {"tokens": torch.from_numpy(tok).long()}, max_len=96)
    scale = float(jnp.max(jnp.abs(want_logits)))
    assert _rel(got_logits, want_logits, scale) < TOL
    jl, tl = _leaves(want_cache), _leaves(got_cache)
    assert len(jl) == len(tl) > 0
    for a, b in zip(jl, tl):
        assert tuple(b.shape) == tuple(a.shape)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-5,
                                   rtol=2e-5)


@pytest.mark.parametrize("name", NAMES)
def test_prefill_then_decode_matches_forward_and_reference(name):
    (jcfg, jm, jp), (tcfg, tm, tp) = _pair(name)
    B, S, n_dec = 2, 24, 4
    tok = _tokens(jcfg, B, S, seed=2)
    n_pre = S - n_dec
    with torch.no_grad():
        full = apply_head(tp, tm.forward(tp, {"tokens": torch.from_numpy(
            tok).long()}), tcfg)
        got = _prefill_then_decode(tm, tp, tcfg, tok, n_pre, S)
    want = _prefill_then_decode(jm, jp, jcfg, tok, n_pre, S)
    scale = float(full.abs().max())
    assert _rel(got, full[:, n_pre - 1:].numpy(), scale) < TOL
    assert _rel(got, want, scale) < TOL


@pytest.mark.parametrize("name", NAMES)
def test_param_counts_match_reference(name):
    from repro.models.lm import param_count as jcount
    from repro_torch.models.lm import param_count
    (_, _, jp), (_, _, tp) = _pair(name)
    assert param_count(tp) == jcount(jp) > 0


def test_head_dim_160_forward_matches_reference():
    """Reduced stablelm-12b at its published head dim of 160 (4 heads of
    160 on a d_model of 64), the kernels on: the forward runs blocked
    attention on both sides."""
    (jcfg, jm, jp), (tcfg, tm, tp) = _pair("stablelm-12b", **HD160)
    assert jcfg.resolved_head_dim == tcfg.resolved_head_dim == 160
    tok = _tokens(jcfg, 2, 40, seed=5)
    want = japply_head(jp, jm.forward(jp, {"tokens": jnp.asarray(tok)}),
                       jcfg)
    with torch.no_grad():
        got = apply_head(tp, tm.forward(tp, {"tokens": torch.from_numpy(
            tok).long()}), tcfg)
    assert _rel(got, want, float(jnp.max(jnp.abs(want)))) < TOL


def test_head_dim_160_kernel_route_matches_reference_kernels():
    """Reduced stablelm-12b at head dim 160 with the kernels on both
    sides: a 36-token prefill (not a multiple of the 32-row blocks, so
    the flash wrapper pads) and 4 decode steps.  The reference runs its
    Pallas ``flash_attention`` and ``decode_attention`` in interpret
    mode; the port's wrappers take their plain versions on CPU tensors
    (each call counted as such, no launch).  Logits within 2e-4 of the
    largest, and the port's incremental logits within the same of its
    own forward."""
    (jcfg, jm, jp), (tcfg, tm, tp) = _pair("stablelm-12b", jax_kernels=True,
                                           **HD160)
    assert jcfg.use_pallas_kernels and tcfg.use_pallas_kernels
    tok = _tokens(jcfg, 1, 40, seed=6)
    stats = [KERNEL_STATS[n] for n in ("flash_attention",
                                       "decode_attention")]
    before = [(s.cpu_calls, s.launches) for s in stats]
    with torch.no_grad():
        got = _prefill_then_decode(tm, tp, tcfg, tok, 36, 48)
        full = apply_head(tp, tm.forward(tp, {"tokens": torch.from_numpy(
            tok).long()}), tcfg)
    for s, (cpu, launches) in zip(stats, before):
        assert s.cpu_calls > cpu and s.launches == launches
    want = _prefill_then_decode(jm, jp, jcfg, tok, 36, 48)
    scale = float(jnp.max(jnp.abs(want)))
    assert _rel(got, want, scale) < TOL
    assert _rel(got, full[:, 35:].numpy(), scale) < TOL
