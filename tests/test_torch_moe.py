"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
reference (``repro/models/moe.py``), on the CPU.

Router ties go to the lower expert index, as ``jax.lax.top_k`` breaks
them; ``capacity`` and ``moe_model_flops`` are equal;
``moe_dispatch_indices`` is equal element for element, capacity drops
(leftmost token first) and the sentinel ``T`` included; ``apply_moe``
on the reference's own weights (bridged through numpy) agrees within
``tests/test_kernels.py``'s fp32 tolerance (atol = rtol = 2e-5) with and
without drops, and within its bf16 one (2e-2) in bf16.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.convert import _to_tensor  # noqa: E402

TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """Tiny CPU ops run far slower under an oversubscribed intra-op pool
    (several test workers share the host); the tests need one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(dtype="float32", **moe_kw):
    """(reference cfg, port cfg): reduced deepseek-v2-236b (d 64, 8
    experts top-2, expert ff 64, 2 shared), the MoE fields overridden."""
    pair = []
    for get in (jget_config, get_config):
        cfg = get("deepseek-v2-236b").reduced(dtype=dtype)
        pair.append(cfg.with_overrides(
            moe=dataclasses.replace(cfg.moe, **moe_kw)))
    return pair


def _torch_tree(tree):
    return jax.tree_util.tree_map(
        lambda a: _to_tensor(np.asarray(a), torch.device("cpu")), tree)


def test_router_ties_go_to_the_lower_expert_index():
    jcfg, tcfg = _configs()
    d, E = tcfg.d_model, tcfg.moe.n_experts
    x = np.abs(np.random.default_rng(0).standard_normal((16, d))).astype(
        np.float32)
    # a zero router: every probability ties; then columns 2 and 5 equal
    # and larger than the rest (x > 0), ties among a few
    tied = np.zeros((d, E), np.float32)
    tied[:, [2, 5]] = 0.1
    for router in (np.zeros((d, E), np.float32), tied):
        jg, je = jmoe.router_probs({"router": jnp.asarray(router)},
                                   jnp.asarray(x), jcfg.moe)
        tg, te = moe.router_probs({"router": torch.from_numpy(router)},
                                  torch.from_numpy(x), tcfg.moe)
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-7)
    assert te[:, 0].tolist() == [2] * 16 and te[:, 1].tolist() == [5] * 16


def test_capacity_matches_reference():
    for cf in (1.0, 1.25, 8.0):
        jcfg, tcfg = _configs(capacity_factor=cf)
        for T in (1, 3, 4, 5, 17, 48, 512, 2048):
            assert moe.capacity(T, tcfg.moe) == jmoe.capacity(T, jcfg.moe)
    v2 = get_config("deepseek-v2-236b").moe
    assert [moe.capacity(T, v2) for T in (1, 4, 2048)] == [4, 4, 96]


def _assignments(T, E, k, seed, skew):
    """(experts (T, k) distinct per token, gates (T, k) fp32); ``skew``
    weights expert 0 up, so a tight capacity drops assignments."""
    rng = np.random.default_rng(seed)
    p = np.ones(E)
    p[0] += skew
    p /= p.sum()
    experts = np.stack([rng.choice(E, k, replace=False, p=p)
                        for _ in range(T)]).astype(np.int32)
    gates = rng.random((T, k)).astype(np.float32)
    return experts, gates / gates.sum(-1, keepdims=True)


@pytest.mark.parametrize("T,E,k,cap,skew,drops", [
    (48, 8, 2, 12, 6.0, True),        # capacity factor 1.0, skewed
    (48, 8, 2, 48, 6.0, False),       # dropless
    (5, 8, 2, 4, 0.0, False),         # decode-sized: capacity's floor of 4
    (300, 160, 6, 15, 40.0, True),    # deepseek-v2's 160 experts, top-6
])
def test_dispatch_indices_match_reference_exactly(T, E, k, cap, skew, drops):
    experts, gates = _assignments(T, E, k, seed=T + E, skew=skew)
    jidx, jg = jmoe.moe_dispatch_indices(jnp.asarray(experts),
                                         jnp.asarray(gates), E, cap)
    tidx, tg = moe.moe_dispatch_indices(torch.from_numpy(experts),
                                        torch.from_numpy(gates), E, cap)
    assert tidx.dtype == torch.int32 and tg.dtype == torch.float32
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    kept = int((tidx < T).sum())
    assert (kept < T * k) == drops
    assert int((tidx == T).sum()) == E * cap - kept      # sentinel slots


@pytest.mark.parametrize("dtype,cf,drops", [
    ("float32", 1.0, True),
    ("float32", 8.0, False),
    ("bfloat16", 8.0, False),
])
def test_apply_moe_matches_reference(dtype, cf, drops):
    jcfg, tcfg = _configs(dtype, capacity_factor=cf)
    jparams = jmoe.init_moe(jax.random.PRNGKey(1), jcfg,
                            jnp.dtype(dtype))
    tparams = _torch_tree(jparams)
    assert tparams["router"].dtype == torch.float32
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 24, tcfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x, dtype)
    want = np.asarray(jax.jit(lambda p, v: jmoe.apply_moe(p, v, jcfg))(
        jparams, xj).astype(jnp.float32))
    xt = _to_tensor(np.asarray(xj), torch.device("cpu"))
    with torch.no_grad():
        got = moe.apply_moe(tparams, xt, tcfg)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])
    # the drops this case claims happen in the reference's own dispatch
    T = 48
    _, experts = jmoe.router_probs(jparams, xj.reshape(T, -1), jcfg.moe)
    idx, _ = jmoe.moe_dispatch_indices(
        experts, jnp.ones(experts.shape), jcfg.moe.n_experts,
        jmoe.capacity(T, jcfg.moe))
    assert (int((np.asarray(idx) < T).sum()) < T * jcfg.moe.top_k) == drops


@pytest.mark.parametrize("name", ["deepseek-v2-236b", "deepseek-v3-671b"])
def test_moe_model_flops_match_reference(name):
    cfg, jcfg = get_config(name), jget_config(name)
    for n in (1, 4, 2048):
        assert moe.moe_model_flops(cfg, n) == jmoe.moe_model_flops(jcfg, n)
