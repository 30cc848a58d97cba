"""The port's micro models against the JAX reference, on the CPU.

For each micro model and fidelity rung the reference's own parameters
(drawn as ``repro/models/micro.py:37-39`` draws them) cross the bridge
``repro_torch.models.convert.micro_params_from_numpy``; the port's step
and the reference computation then run on the same numpy inputs: the
jnp ``tanh(x @ w + c)`` chain for the MLPs, and for attn-tiny the
reference's oracle ``flash_attention_ref`` and its Pallas kernel in
interpret mode.  Tolerance fp32 atol = rtol = 2e-5
(``tests/test_kernels.py:18-20``).  Also: the runner contract, the
reference's error messages, a ``RealPlane`` end-to-end run (mirroring
``tests/test_plane.py``'s micro-MLP case) and attn-tiny's CPU-route
count.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import micro as jmicro  # noqa: E402
from repro_torch.kernels import KERNEL_STATS  # noqa: E402
from repro_torch.models import micro  # noqa: E402
from repro_torch.models.convert import micro_params_from_numpy  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)
# (model, rung) -> (width, depth) of the MLP rungs, micro.py:108-113
MLP_RUNGS = {("mlp-tiny", r): (d, 2) for r, d in enumerate((32, 16, 8))}
MLP_RUNGS.update({("mlp", r): (d, 4) for r, d in enumerate((128, 64, 32))})
ATTN_SEQS = (16, 8, 4)


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """Tiny CPU ops run far slower under an oversubscribed intra-op pool
    (several test workers share the host); the tests need one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_mlp_params(dim, depth, seed):
    """The reference's micro MLP parameters, as ``micro.py:37-39`` draws
    them, with numpy leaves."""
    keys = jax.random.split(jax.random.PRNGKey(seed), depth)
    return [(np.asarray(jax.random.normal(k, (dim, dim), jnp.float32)
                        / dim ** 0.5), np.zeros((dim,), np.float32))
            for k in keys]


def _reference_mlp(x, params):
    x = jnp.asarray(x)
    for w, c in params:
        x = jnp.tanh(x @ jnp.asarray(w) + jnp.asarray(c))
    return np.asarray(x)


@pytest.mark.parametrize("name,rung", sorted(MLP_RUNGS))
def test_mlp_step_matches_reference(name, rung):
    dim, depth = MLP_RUNGS[(name, rung)]
    params = _reference_mlp_params(dim, depth, seed=rung)
    x = np.random.default_rng(rung).standard_normal((8, dim)).astype(
        np.float32)
    got = micro.mlp_step(torch.from_numpy(x),
                         micro_params_from_numpy(params, device="cpu"))
    np.testing.assert_allclose(got.numpy(), _reference_mlp(x, params), **TOL)


@pytest.mark.parametrize("seq", ATTN_SEQS)
def test_attn_step_matches_reference_oracle_and_pallas_kernel(seq):
    """attn-tiny's rungs (seq 16/8/4, 2 heads of 16): the port's step on
    the CPU against the reference's step (its jnp oracle) and the Pallas
    kernel in interpret mode, which pads seq 8 and 4 to 16 as the port's
    wrapper does."""
    shape = (3, seq, 2, 16)
    rng = np.random.default_rng(seq)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    got = micro.attn_step(*(torch.from_numpy(a) for a in (q, k, v))).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    np.testing.assert_allclose(
        got, np.asarray(jref.flash_attention_ref(jq, jk, jv, causal=True)),
        **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jops.flash_attention(jq, jk, jv, causal=True)),
        **TOL)


@pytest.mark.parametrize("name", micro.MICRO_MODELS)
def test_fidelity_rungs_run_the_bridged_weights(name):
    """The fidelity factory takes one bridged weight list per rung, and
    each rung's runner runs to None; attn-tiny has no weights to take."""
    if name == "attn-tiny":
        with pytest.raises(ValueError, match="no weights"):
            micro.make_micro_runner(name, params=[], device="cpu")
        factory = micro.make_fidelity_micro_runner(name, device="cpu")
    else:
        params = [micro_params_from_numpy(
            _reference_mlp_params(*MLP_RUNGS[(name, r)], seed=r),
            device="cpu") for r in range(3)]
        factory = micro.make_fidelity_micro_runner(name, params=params,
                                                   device="cpu")
        with pytest.raises(ValueError, match="do not match"):
            micro.make_micro_runner(name, params=params[1], device="cpu")
    assert factory.fidelity_aware is True
    for r in range(3):
        assert factory(2, 4, fidelity=r)() is None


def test_micro_params_bridge_validates_shapes():
    with pytest.raises(ValueError, match=r"w \(d, d\) and c \(d,\)"):
        micro_params_from_numpy([(np.zeros((4, 3)), np.zeros(4))],
                                device="cpu")
    (w, c), = micro_params_from_numpy(
        [(np.ones((4, 4), np.float64), np.zeros(4))], device="cpu")
    assert w.dtype == c.dtype == torch.float32


@pytest.mark.parametrize("name", micro.MICRO_MODELS)
def test_runner_contract_matches_reference(name):
    """``make_runner(t, b)`` returns a zero-argument runner returning
    None, shared across ``t`` for one ``b``; the fidelity factory carries
    the marker and serves rung 0 as the plain factory's model."""
    make_runner = micro.make_micro_runner(name, device="cpu")
    ref_make = jmicro.make_micro_runner(name)
    run = make_runner(1, 4)
    assert run() is None and ref_make(1, 4)() is None
    assert make_runner(2, 4) is run and make_runner(1, 8) is not run
    assert (make_runner(2, 4) is run) == (ref_make(2, 4) is ref_make(1, 4))
    fid = micro.make_fidelity_micro_runner(name, device="cpu", n_rungs=2)
    ref_fid = jmicro.make_fidelity_micro_runner(name, n_rungs=2)
    assert fid.fidelity_aware is ref_fid.fidelity_aware is True
    assert fid(1, 2, fidelity=1)() is None


def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("factory,args,kw", [
    ("make_micro_runner", ("no-such-model",), {}),
    ("make_fidelity_micro_runner", ("no-such-model",), {}),
    ("make_fidelity_micro_runner", ("mlp-tiny",), {"n_rungs": 0}),
    ("make_fidelity_micro_runner", ("attn-tiny",), {"n_rungs": 4}),
])
def test_errors_match_reference(factory, args, kw):
    port = _error(lambda: getattr(micro, factory)(*args, **kw,
                                                  device="cpu"))
    assert port == _error(lambda: getattr(jmicro, factory)(*args, **kw))


def test_fidelity_rung_out_of_range_matches_reference():
    port = micro.make_fidelity_micro_runner("mlp-tiny", device="cpu",
                                            n_rungs=2)
    ref = jmicro.make_fidelity_micro_runner("mlp-tiny", n_rungs=2)
    for rung in (-1, 2):
        assert _error(lambda: port(1, 1, fidelity=rung)) == \
            _error(lambda: ref(1, 1, fidelity=rung))


def test_attn_tiny_counts_cpu_route_calls():
    stats = KERNEL_STATS["flash_attention"]
    before = (stats.launches, stats.cpu_calls)
    run = micro.make_micro_runner("attn-tiny", device="cpu")(1, 2)  # warms
    run()
    assert stats.cpu_calls == before[1] + 2
    assert stats.launches == before[0]


def test_real_plane_end_to_end_micro_mlp():
    """Mirror of ``tests/test_plane.py``'s micro-MLP case on the port:
    PackratServer over RealPlane running ``mlp-tiny`` on the CPU, the
    profile measured through the plane, wall-clock latencies delivered,
    the calibration loop populated."""
    from repro_torch.core.knapsack import PackratOptimizer
    from repro_torch.core.profiler import ProfileCalibrator, ProfileSpec
    from repro_torch.serving import (CalibratedBackend, ControllerConfig,
                                     PackratServer, RealPlane, Request,
                                     TabulatedBackend)
    units = 2
    plane = RealPlane(micro.make_micro_runner("mlp-tiny", device="cpu"),
                      units)
    profile = plane.profile(ProfileSpec(units, 8, thread_values=(1, 2)),
                            warmup=1, iters=3)
    assert all(lat > 0 for lat in profile.values())
    opt = PackratOptimizer(profile)
    cal = ProfileCalibrator(profile, refresh_interval=0.3)
    ccfg = ControllerConfig()
    ccfg.estimator.max_batch = 8
    server = PackratServer(
        plane, total_units=units, optimizer=opt,
        backend=CalibratedBackend(TabulatedBackend(profile), cal),
        initial_batch=2, config=ccfg, calibrator=cal)
    n = 60
    for i in range(n):
        t = 0.01 * (i + 1)
        plane.at(t, (lambda i=i, t=t: server.submit(Request(i, t))))
    plane.run_until(1.8)
    plane.close()
    ids = [r.request.id for r in server.responses]
    assert len(set(ids)) == len(ids) == n
    assert all(r.latency > 0 for r in server.responses)
    assert cal.observations > 0
    rep = cal.report()
    assert rep["entries"] and rep["observations"] == cal.observations
