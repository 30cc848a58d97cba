"""The port's training substrate against the JAX reference, on the CPU.

* ``cross_entropy_loss``: value and gradients (w.r.t. ``hidden`` and
  ``head_w``) against ``jax.value_and_grad`` of the reference, unchunked,
  in ≤ 16 chunks (unrolled there) and in > 16 (``lax.scan`` there), with
  a softcap and with -100 labels.
* ``lr_schedule``, ``global_norm``, and ``adamw_update`` over 3 steps with
  fp32 moments, bf16 moments, fp32 master weights of bf16 parameters and
  clipping on, fed the same gradients on both sides.
* ``loss_fn`` and one ``make_train_step`` on reduced configurations,
  weights bridged through ``convert.params_from_numpy`` (fp32, every
  parameter perturbed so that a zero bias hides nothing): the loss,
  every gradient leaf (by the reference's key path) and the parameters
  after the step, and gemma3-1b in its registered stacked layout.  The
  rest of the seven configurations, the reference's remat step and
  twenty of the launcher's steps are in
  ``tests/test_torch_train_models.py``.
* ``grad_accum=2`` against the reference's; ``remat=True`` against
  ``remat=False``; ``shift_labels`` exactly.

Tolerances (fp32, both sides differ in summation order only): the loss
within 1e-5 relative; each gradient leaf within 1e-4 of its largest
|g|; AdamW fed the same gradients within 1e-6 relative (and 1e-6 of
the leaf's largest value: an element near 0 is a difference of two
larger numbers), a bf16 leaf within one bf16 ulp (8e-3).  The parameters
after a step are held within the bound that a gradient difference
allows: the first AdamW step moves each element by lr · g/(|g| + eps)
(clipping scales g and eps alike), which is g's sign for all but tiny
|g|, so an element whose gradient is within rounding of zero may move
either way.  Per element: |Δ| ≤ 1e-6·(1 + |p|) + lr · min(2, d / (max(|g|
- d, 0) + eps)), with d the two sides' gradient difference plus 1e-6
of the leaf's largest |g| (the step computes its gradients again, and
the recomputation may round differently from the ones compared).

The reference's Mamba2 SSD has NaN gradients: its intra-chunk decay is
masked after the exp (``jnp.where(tri, jnp.exp(decay), 0)``), and above
the diagonal the decay is positive and overflows, so the backward meets
0 · inf.  The port masks before the exp (same values, finite
gradients).  For mamba2-130m the oracle is therefore the reference with
``jnp.exp``'s argument capped at 80 inside ``repro.models.ssm`` (every
value the forward uses has an argument ≤ 0, so none changes);
``test_reference_ssd_gradients_are_nan`` holds the fault itself.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.ssm as jssm  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models.common import cross_entropy_loss as jxent  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_loop as jtl  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.common import cross_entropy_loss  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import train_loop as ttl  # noqa: E402
from repro_torch.training.tree import leaves_with_path, tree_map  # noqa: E402,E501

jax.config.update("jax_enable_x64", False)

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4          # of each leaf's largest |g|
STEP_ATOL = 1e-6         # rounding of p - lr·(...) beside the Adam bound
GRAD_NOISE = 1e-6        # of a leaf's largest |g|: a recomputed gradient's
                         # rounding (the step computes its own)
NOISE = 0.05
LR = 1e-3
NAMES = ["llama3-8b", "gemma3-1b", "mamba2-130m"]


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """Tiny CPU ops run far slower under an oversubscribed intra-op pool
    (several test workers share the host); the tests need one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _CappedExp:
    """``jnp`` with exp's argument capped at 80, for the reference SSD."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def exp(x):
        return jnp.exp(jnp.minimum(x, 80.0))


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)

    def one(a):
        a = np.asarray(a)
        return (a + NOISE * rng.standard_normal(a.shape)).astype(a.dtype)

    return jax.tree_util.tree_map(one, tree)


@functools.lru_cache(maxsize=None)
def _pair(name, **kw):
    """(reference cfg, reference params) and (port cfg, the same params
    bridged): reduced, fp32, perturbed."""
    jcfg = jget_config(name).reduced(dtype="float32").with_overrides(**kw)
    tcfg = get_config(name).reduced(dtype="float32").with_overrides(**kw)
    tree = _perturb(jbuild_model(jcfg).init(jax.random.PRNGKey(0)), seed=11)
    return ((jcfg, jax.tree_util.tree_map(jnp.asarray, tree)),
            (tcfg, params_from_numpy(tcfg, tree, device="cpu")))


def _batch(cfg, B, S, seed):
    """A seeded train batch as numpy: the inputs ``input_specs`` names
    and next-token labels, some of them -100."""
    rng = np.random.default_rng(seed)
    batch, n_text, P = {}, S, 0
    if cfg.frontend is not None and cfg.frontend.kind == "vision":
        P = cfg.frontend.n_prefix_tokens
        batch["vision_embeds"] = rng.standard_normal(
            (B, P, cfg.d_model)).astype(np.float32)
        n_text = S - P
    elif cfg.is_encdec:
        batch["frames"] = rng.standard_normal(
            (B, cfg.frontend.n_frames, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, n_text), dtype=np.int32)
    labels = np.concatenate([np.full((B, P), -100, np.int32), toks[:, 1:],
                             np.full((B, 1), -100, np.int32)], axis=1)
    labels[0, P:P + 3] = -100
    batch["tokens"], batch["labels"] = toks, labels
    return batch


def _named(jtree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(jtree)[0]}


def _port_named(ttree):
    return {n: v.detach().float().numpy() for n, v in leaves_with_path(ttree)}


def _assert_grads_close(tg, jg):
    t, j = _port_named(tg), _named(jg)
    assert list(t) == list(j)
    for name in j:
        assert np.isfinite(t[name]).all(), name
        err = np.abs(t[name] - j[name]).max()
        assert err <= GRAD_TOL * np.abs(j[name]).max(), (name, err)


def _assert_step_close(tp1, jp1, tp0, tg, jg, gnorm, eps=1e-8, lr=LR):
    """Parameters after one AdamW step from zero moments, within the
    bound the two sides' gradient difference allows (module docstring)."""
    scale = min(1.0, 1.0 / max(gnorm, 1e-12))
    t1, j1, p0, t, j = (_port_named(tp1), _named(jp1), _port_named(tp0),
                        _port_named(tg), _named(jg))
    assert list(t1) == list(j1)
    for name in j1:
        d = (np.abs(t[name] - j[name]) + GRAD_NOISE * np.abs(j[name]).max()
             ) * scale
        g = np.abs(j[name]) * scale
        bound = STEP_ATOL * (1 + np.abs(p0[name])) + lr * np.minimum(
            2.0, d / (np.maximum(g - d, 0.0) + eps))
        err = np.abs(t1[name] - j1[name])
        assert (err <= bound).all(), (name, float(err.max()))


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# --------------------------------------------------------------------- #
# cross entropy
# --------------------------------------------------------------------- #
XENT_CASES = {            # (S, chunk, softcap, ignored labels)
    "unchunked": (24, 0, 0.0, 0),
    "chunks-4": (64, 16, 0.0, 5),
    "chunks-18": (72, 4, 0.0, 5),
    "softcap": (64, 16, 30.0, 0),
    "softcap-unchunked-ignored": (24, 0, 5.0, 9),
    "chunk-not-a-divisor": (24, 5, 0.0, 3),
}


@pytest.mark.parametrize("case", sorted(XENT_CASES))
def test_cross_entropy_matches_reference(case):
    S, chunk, softcap, n_ignored = XENT_CASES[case]
    B, d, V = 2, 16, 96
    rng = np.random.default_rng(3)
    hidden = rng.standard_normal((B, S, d)).astype(np.float32)
    head = (rng.standard_normal((d, V)) * 0.5).astype(np.float32)
    labels = rng.integers(0, V, (B, S), dtype=np.int32)
    labels.reshape(-1)[rng.choice(B * S, n_ignored, replace=False)] = -100

    jfn = jax.jit(jax.value_and_grad(
        lambda h, w: jxent(h, w, jnp.asarray(labels), chunk=chunk,
                           softcap=softcap), argnums=(0, 1)))
    jl, (jgh, jgw) = jfn(jnp.asarray(hidden), jnp.asarray(head))
    h = torch.from_numpy(hidden).requires_grad_()
    w = torch.from_numpy(head).requires_grad_()
    tl = cross_entropy_loss(h, w, torch.from_numpy(labels), chunk=chunk,
                            softcap=softcap)
    tgh, tgw = torch.autograd.grad(tl, (h, w))
    tl = tl.detach()
    assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    for got, want in ((tgh, jgh), (tgw, jgw)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= GRAD_TOL * np.abs(
            want).max()


def test_cross_entropy_ignores_every_label():
    """All labels -100: the count is clamped to 1 and the loss is 0."""
    h = torch.ones((1, 4, 8), requires_grad=True)
    loss = cross_entropy_loss(h, torch.ones((8, 16)),
                              torch.full((1, 4), -100, dtype=torch.int32))
    assert float(loss.detach()) == 0.0
    (g,) = torch.autograd.grad(loss, h)
    assert float(g.abs().max()) == 0.0


# --------------------------------------------------------------------- #
# optimizer
# --------------------------------------------------------------------- #
def test_lr_schedule_matches_reference():
    cfg = dict(learning_rate=3e-3, warmup_steps=10, decay_steps=100,
               min_lr_ratio=0.1)
    jcfg, tcfg = jopt.AdamWConfig(**cfg), topt.AdamWConfig(**cfg)
    for step in list(range(0, 120, 3)) + [9, 10, 11, 99, 100, 101]:
        want = float(jopt.lr_schedule(jcfg, jnp.int32(step)))
        got = topt.lr_schedule(tcfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12), step


def test_global_norm_matches_reference():
    rng = np.random.default_rng(5)
    tree = {"b": [rng.standard_normal((3, 4)).astype(np.float32),
                  rng.standard_normal(7).astype(np.float32)],
            "a": {"w": rng.standard_normal((5, 2)).astype(np.float32)}}
    want = float(jopt.global_norm(jax.tree_util.tree_map(jnp.asarray, tree)))
    got = topt.global_norm({"b": [torch.from_numpy(x) for x in tree["b"]],
                            "a": {"w": torch.from_numpy(tree["a"]["w"])}})
    assert float(got) == pytest.approx(want, rel=1e-6)


ADAMW_CASES = {          # (AdamWConfig overrides, param dtype, grad scale)
    "fp32-state": ({}, "float32", 0.05),
    "bf16-state": ({"state_dtype": "bfloat16"}, "float32", 0.05),
    "master-weights": ({"master_weights": True}, "bfloat16", 0.05),
    "clipped": ({"grad_clip": 0.5}, "float32", 10.0),
    "no-clip": ({"grad_clip": 0.0}, "float32", 10.0),
}


@pytest.mark.parametrize("case", sorted(ADAMW_CASES))
def test_adamw_update_matches_reference(case):
    """Three steps fed the same gradients: params, moments, master and
    metrics."""
    overrides, pdtype, gscale = ADAMW_CASES[case]
    cfg = dict(learning_rate=1e-2, warmup_steps=2, decay_steps=10,
               **overrides)
    jcfg, tcfg = jopt.AdamWConfig(**cfg), topt.AdamWConfig(**cfg)
    rng = np.random.default_rng(7)
    shapes = {"w": (6, 5), "blocks": [(4,), (3, 2)]}
    p_np = {"w": rng.standard_normal(shapes["w"]).astype(np.float32),
            "blocks": [rng.standard_normal(s).astype(np.float32)
                       for s in shapes["blocks"]]}
    jdt = jnp.dtype(pdtype)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jdt), p_np)
    tp = {"w": torch.from_numpy(p_np["w"]).to(getattr(torch, pdtype)),
          "blocks": [torch.from_numpy(a).to(getattr(torch, pdtype))
                     for a in p_np["blocks"]]}
    js, ts = jopt.init_adamw(jcfg, jp), topt.init_adamw(tcfg, tp)
    assert ts.step.dtype == torch.int32 and ts.step.dim() == 0
    jupd = jax.jit(functools.partial(jopt.adamw_update, jcfg))
    for _ in range(3):
        g_np = {"w": (gscale * rng.standard_normal(shapes["w"])).astype(
                    np.float32),
                "blocks": [(gscale * rng.standard_normal(s)).astype(
                    np.float32) for s in shapes["blocks"]]}
        jg = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jdt),
                                    g_np)
        tg = {"w": torch.from_numpy(g_np["w"]).to(getattr(torch, pdtype)),
              "blocks": [torch.from_numpy(a).to(getattr(torch, pdtype))
                         for a in g_np["blocks"]]}
        jp, js, jm = jupd(jg, js, jp)
        tp, ts, tm = topt.adamw_update(tcfg, tg, ts, tp)
        assert int(ts.step) == int(js.step)
        for key in ("grad_norm", "lr"):
            assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-6)
    got = {"params": tp, "mu": ts.mu, "nu": ts.nu}
    want = {"params": jp, "mu": js.mu, "nu": js.nu}
    if overrides.get("master_weights"):
        got["master"], want["master"] = ts.master, js.master
        assert all(v.dtype == torch.float32
                   for _, v in leaves_with_path(ts.master))
    else:
        assert ts.master is None
    for part in got:
        j = _named(want[part])
        t = leaves_with_path(got[part])
        assert [n for n, _ in t] == list(j)
        for name, leaf in t:
            # a bf16 leaf may round the same fp32 value one bf16 ulp apart
            rtol = 8e-3 if leaf.dtype == torch.bfloat16 else 1e-6
            ref = j[name].astype(np.float32)
            np.testing.assert_allclose(leaf.float().numpy(), ref,
                                       rtol=rtol,
                                       atol=rtol * np.abs(ref).max(),
                                       err_msg=f"{part}{name}")
    assert tp["w"].dtype == getattr(torch, pdtype)
    assert ts.mu["w"].dtype == getattr(torch, tcfg.state_dtype)


# --------------------------------------------------------------------- #
# the train step on reduced configurations
# --------------------------------------------------------------------- #
def _adam():
    return (jopt.AdamWConfig(learning_rate=LR, warmup_steps=1),
            topt.AdamWConfig(learning_rate=LR, warmup_steps=1))


def check_train_step(name, monkeypatch, B=2, S=32, **kw):
    """Loss, every grad leaf and the params after one step, port against
    reference (shared with tests/test_torch_train_models.py)."""
    if name == "mamba2-130m":
        monkeypatch.setattr(jssm, "jnp", _CappedExp())
    (jcfg, jp), (tcfg, tp) = _pair(name, **kw)
    batch = _batch(jcfg, B, S, seed=0)
    jb, tb = _jax_batch(batch), _torch_batch(batch)
    jl, jg = jax.jit(lambda p, b: jax.value_and_grad(jtl.loss_fn)(
        p, b, jcfg))(jp, jb)
    tl, tg = ttl.value_and_grad(tp, tb, tcfg)
    assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    _assert_grads_close(tg, jg)

    jadam, tadam = _adam()
    jstep = jax.jit(jtl.make_train_step(jcfg, jtl.TrainConfig(adamw=jadam)))
    tstep = ttl.make_train_step(tcfg, ttl.TrainConfig(adamw=tadam))
    jp1, js1, jm = jstep(jp, jopt.init_adamw(jadam, jp), jb)
    before = [a.clone() for _, a in leaves_with_path(tp)]
    tp1, ts1, tm = tstep(tp, topt.init_adamw(tadam, tp), tb)
    assert float(tm["loss"]) == float(tl)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-5)
    assert int(ts1.step) == 1
    _assert_step_close(tp1, jp1, tp, tg, jg, float(jm["grad_norm"]))
    # the step is functional: its inputs are untouched
    for (n, a), b in zip(leaves_with_path(tp), before):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_reference(name, monkeypatch):
    check_train_step(name, monkeypatch)


def test_stacked_layers_train_step_matches_reference(monkeypatch):
    """gemma3-1b's registered layout stacks each pattern position's
    repeats (``scan_layers``): the reference scans them, the port loops
    over views of the stacked leaves."""
    check_train_step("gemma3-1b", monkeypatch, scan_layers=True)


def test_reference_ssd_gradients_are_nan():
    """The fault in the reference that the port does not copy: at its own
    initialisation, reduced mamba2-130m's reference gradients are NaN
    (the SSD's masked-after-exp decay), the port's are finite and its
    loss is the reference's."""
    (jcfg, jp), (tcfg, tp) = _pair("mamba2-130m")
    batch = _batch(jcfg, 2, 32, seed=0)
    jl, jg = jax.jit(lambda p, b: jax.value_and_grad(jtl.loss_fn)(
        p, b, jcfg))(jp, _jax_batch(batch))
    tl, tg = ttl.value_and_grad(tp, _torch_batch(batch), tcfg)
    assert float(tl) == pytest.approx(float(jl), rel=LOSS_RTOL)
    ref_nan = [n for n, g in _named(jg).items() if not np.isfinite(g).all()]
    assert "['embed']" in ref_nan
    assert all(np.isfinite(g).all() for g in _port_named(tg).values())


def test_grad_accum_matches_reference():
    """grad_accum=2: the mean of the two microbatch means, as the
    reference's scan sums and divides; and not the full-batch step."""
    name = "llama3-8b"
    (jcfg, jp), (tcfg, tp) = _pair(name)
    batch = _batch(jcfg, 4, 32, seed=2)
    jb, tb = _jax_batch(batch), _torch_batch(batch)
    jadam, tadam = _adam()
    jstep = jax.jit(jtl.make_train_step(
        jcfg, jtl.TrainConfig(adamw=jadam, grad_accum=2)))
    tstep = ttl.make_train_step(
        tcfg, ttl.TrainConfig(adamw=tadam, grad_accum=2))
    jp1, _, jm = jstep(jp, jopt.init_adamw(jadam, jp), jb)
    tp1, _, tm = tstep(tp, topt.init_adamw(tadam, tp), tb)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_RTOL * abs(
        float(jm["loss"]))
    # the accumulated gradients, each side's own: the mean of the
    # microbatch gradients
    halves = [{k: v[i * 2:(i + 1) * 2] for k, v in batch.items()}
              for i in range(2)]
    jvg = jax.jit(lambda p, b: jax.value_and_grad(jtl.loss_fn)(p, b, jcfg))
    jgs = [jvg(jp, _jax_batch(h))[1] for h in halves]
    tgs = [ttl.value_and_grad(tp, _torch_batch(h), tcfg)[1] for h in halves]
    jg = jax.tree_util.tree_map(lambda a, b: (a + b) / 2, *jgs)
    tg = tree_map(lambda a, b: (a + b) / 2, *tgs)
    _assert_grads_close(tg, jg)
    _assert_step_close(tp1, jp1, tp, tg, jg, float(jm["grad_norm"]))
    full = ttl.make_train_step(tcfg, ttl.TrainConfig(adamw=tadam))(
        tp, topt.init_adamw(tadam, tp), tb)[2]
    assert float(full["loss"]) != float(tm["loss"])


@pytest.mark.parametrize("name", ["gemma3-1b", "recurrentgemma-9b"])
def test_remat_matches_no_remat(name):
    """cfg.remat recomputes each block in the backward: the same loss and
    gradients as without, up to summation order (the reference's remat
    step: tests/test_torch_train_models.py)."""
    _, (tcfg, tp) = _pair(name)
    batch = _torch_batch(_batch(tcfg, 2, 32, seed=4))
    l0, g0 = ttl.value_and_grad(tp, batch, tcfg)
    l1, g1 = ttl.value_and_grad(tp, batch, tcfg.with_overrides(remat=True))
    assert float(l1) == float(l0)
    a, b = _port_named(g0), _port_named(g1)
    for n in a:
        assert np.abs(a[n] - b[n]).max() <= 1e-6 * np.abs(a[n]).max(), n


def test_shift_labels_exact():
    toks = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    for prefix in (0, 2, 4):
        want = np.asarray(jtl.shift_labels(jnp.asarray(toks), prefix))
        got = ttl.shift_labels(torch.from_numpy(toks), prefix)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
