"""The port's distribution layer (``repro_torch.distributed``,
``launch/mesh.py``, ``lm.param_specs``/``cache_specs``) against the JAX
reference, on the CPU.

* Sharding rules: for every registered configuration at full width and
  the reduced configurations of ``tests/test_distributed.py``, the port's
  parameter, ZeRO optimizer, cache and batch specs equal the reference's,
  leaf by leaf, on the (2, 4), production (16, 16) and (2, 16, 16) meshes
  and on an (8,) "model" mesh with ``moe_ep`` on.  The reference asks an
  ``AbstractMesh``; the port a ``DeviceMesh`` on torch's ``"fake"``
  process-group backend (512 ranks in one process, no devices).
* ``param_specs``/``cache_specs`` have the reference's ``eval_shape``
  shapes and dtypes leaf by leaf.
* Blockwise int8: ``quantize_blockwise`` gives the reference's bytes;
  ``compressed_psum`` over 8 gloo ranks gives the reference's bits over
  8 devices, within the reference test's ``rms_rel < 0.02`` of the sum.
* Expert parallelism: ``apply_moe_ep`` over 8 gloo ranks matches the
  reference's over 8 devices within 2e-4 / 2e-3, on an (8,) "model" and
  a (2, 4) mesh, at capacity factor 8.0 and at 1.25 with drops.
* Sharded steps: on a (2, 4) gloo mesh, DTensor parameters, batch and
  cache laid out by the specs, the train and decode steps of seven
  configurations at ``test_distributed.py``'s reduced widths, in fp32
  (llama3-8b also with the reference's sharding hints on, and
  deepseek-v2-236b with ``moe_ep``), match the port's unsharded steps:
  loss within 1e-5, every gradient leaf within 1e-4 of its largest |g|,
  logits within 2e-5 of the largest, the cache within 1e-5.
* Sharded prefill: on the same mesh, the prefill of all eight cases
  (DTensor parameters and prompt) matches the unsharded prefill at the
  decode step's tolerances, builds its cache laid out by
  ``cache_pspecs`` and its logits by ``batch_pspecs``, and a decode step
  continues from that cache.
* ZeRO: two train steps with the moments laid out by
  ``optimizer_pspecs`` match the unsharded steps in seven cases and
  return every parameter and moment in the layout it came in; the
  eighth (deepseek-v2-236b with ``moe_ep``) has specs that name "data"
  twice, which both sides refuse (pinned by a test).
* ``make_submesh`` as ``test_submesh_shapes`` has it.

The reference's collectives need 8 devices, which an xdist worker that
has imported JAX cannot fabricate: they run in a subprocess with
``--xla_force_host_platform_device_count=8`` that writes ``.npy`` files.
The port's ranks run in two spawns of 8 gloo processes
(``tests/torch_dist_ranks.py``), the layout checks (ZeRO, prefill) in
the second.
"""

import os
import subprocess
import sys
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

import torch_dist_ranks as ranks  # noqa: E402
from repro.configs import all_configs as jall_configs  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.configs.base import applicable_shapes  # noqa: E402
from repro.distributed import compression as jcomp  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch.configs import ShapeConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import compression  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch.mesh import make_mesh, make_submesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training.tree import leaves_with_path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FULL = sorted(jall_configs())
# test_distributed.py's reduced configurations (unrolled layers): name ->
# (registered configuration, how it is reduced)
REDUCED = {
    "llama3-8b-step": ("llama3-8b", lambda get: get("llama3-8b").reduced(
        **dict(ranks.STEP_REDUCED, dtype="bfloat16"))),
    "deepseek-v2-236b-ep": ("deepseek-v2-236b",
                            lambda get: ranks.ep_config(get, 8.0)),
}
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "model8-ep": ((8,), ("model",))}
SMALL_SHAPES = (ShapeConfig("t", 32, 8, "train"),
                ShapeConfig("d", 64, 8, "decode"))


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fake_world():
    """512 fake ranks in this process: meshes for the rules, no devices."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    yield
    dist.destroy_process_group()


def _configs(name):
    """(reference cfg, port cfg) of a full or reduced configuration."""
    if name in REDUCED:
        reduce = REDUCED[name][1]
        return reduce(jget_config), reduce(get_config)
    return jget_config(name), get_config(name)


def _shapes(name):
    """(name, seq, batch, kind) of the registered configuration's shapes,
    and the small ones for a reduced configuration."""
    base = REDUCED[name][0] if name in REDUCED else name
    shapes = list(applicable_shapes(jget_config(base)))
    if name in REDUCED:
        shapes += SMALL_SHAPES
    return [(s.name, s.seq_len, s.global_batch, s.kind) for s in shapes]


@lru_cache(maxsize=None)
def _ref_param_shapes(name, moe_ep=False):
    jcfg, _ = _configs(name)
    jcfg = jcfg.with_overrides(moe_ep=moe_ep)
    return jcfg, jbuild(jcfg).param_specs()


def _ref_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {jax.tree_util.keystr(k): v for k, v in flat}


def _port_flat(tree):
    return dict(leaves_with_path(tree))


def _assert_specs_equal(port_tree, ref_tree, what):
    port, ref = _port_flat(port_tree), _ref_flat(ref_tree)
    assert list(port) == list(ref), what
    for path, spec in ref.items():
        assert port[path] == tuple(spec), (what, path, port[path], spec)


# --------------------------------------------------------------------- #
# sharding rules
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", FULL + sorted(REDUCED))
def test_specs_match_reference(fake_world, name, mesh_name):
    shape, axes = MESHES[mesh_name]
    moe_ep = mesh_name.endswith("-ep")
    jmesh = AbstractMesh(shape, axes)
    mesh = make_mesh(shape, axes, device_type="cpu")
    jcfg, j_shapes = _ref_param_shapes(name, moe_ep)
    cfg = _configs(name)[1].with_overrides(moe_ep=moe_ep)
    model = build_model(cfg)
    p_shapes = model.param_specs()

    j_spec = jsh.params_pspecs(jcfg, j_shapes, jmesh)
    p_spec = sharding.params_pspecs(cfg, p_shapes, mesh)
    _assert_specs_equal(p_spec, j_spec, "params")
    _assert_specs_equal(
        sharding.optimizer_pspecs(p_spec, p_shapes, mesh, zero=True),
        jsh.optimizer_pspecs(j_spec, j_shapes, jmesh, zero=True), "zero")

    jmodel = jbuild(jcfg)
    for sname, seq, batch, kind in _shapes(name):
        j_cache = jmodel.cache_specs(JShape(sname, seq, batch, kind))
        p_cache = model.cache_specs(ShapeConfig(sname, seq, batch, kind))
        _assert_specs_equal(sharding.cache_pspecs(cfg, p_cache, mesh),
                            jsh.cache_pspecs(jcfg, j_cache, jmesh),
                            f"cache {sname}")
        j_in = jmodel.input_specs(JShape(sname, seq, batch, kind))
        p_in = model.input_specs(ShapeConfig(sname, seq, batch, kind))
        _assert_specs_equal(sharding.batch_pspecs(p_in, mesh),
                            jsh.batch_pspecs(j_in, jmesh), f"batch {sname}")


def test_moe_ep_layout_shards_experts_over_both_axes(fake_world):
    """deepseek-v3-671b's 256 experts shard over data × model = 256 ranks
    of the production mesh, one expert per rank, as DeepSeek deploy."""
    cfg = get_config("deepseek-v3-671b").with_overrides(moe_ep=True)
    mesh = make_mesh((16, 16), ("data", "model"), device_type="cpu")
    specs = _port_flat(sharding.params_pspecs(
        cfg, build_model(cfg).param_specs(), mesh))
    gate = [v for k, v in specs.items() if k.endswith("['moe']['gate']")]
    assert gate and all(s == (None, ("data", "model"), None, None)
                        for s in gate)
    from torch.distributed.tensor import Replicate, Shard
    assert sharding.to_placements(mesh, gate[0]) == [Shard(1), Shard(1)]
    named = sharding.to_named(mesh, {"gate": gate[0]})["gate"]
    assert named.mesh is mesh and named.placements == [Shard(1), Shard(1)]
    assert sharding.to_placements(mesh, sharding.P(None, "model")) == [
        Replicate(), Shard(1)]
    with pytest.raises(ValueError, match="mesh order"):
        sharding.to_placements(mesh, sharding.P(("model", "data")))


def test_partition_spec_compares_as_the_reference_does():
    P = sharding.PartitionSpec
    assert P(("data",), None) == ("data", None) == tuple(JP(("data",), None))
    assert P(("pod", "data"), "model") == tuple(JP(("pod", "data"), "model"))
    assert P() == () and P(None) != P("model")
    assert hash(P(("data",))) == hash(P("data"))


@pytest.mark.parametrize("name", FULL + sorted(REDUCED))
def test_param_and_cache_specs_match_eval_shape(name):
    jcfg, j_shapes = _ref_param_shapes(name)
    model = build_model(_configs(name)[1])

    def check(port, ref, what):
        port, ref = _port_flat(port), dict(
            (jax.tree_util.keystr(k), v)
            for k, v in jax.tree_util.tree_flatten_with_path(ref)[0])
        assert list(port) == list(ref), what
        for path, leaf in ref.items():
            t = port[path]
            assert t.is_meta, (what, path)
            assert tuple(t.shape) == tuple(leaf.shape), (what, path)
            assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype), \
                (what, path, t.dtype, leaf.dtype)

    check(model.param_specs(), j_shapes, "params")
    jmodel = jbuild(jcfg)
    for sname, seq, batch, kind in _shapes(name):
        check(model.cache_specs(ShapeConfig(sname, seq, batch, kind)),
              jmodel.cache_specs(JShape(sname, seq, batch, kind)),
              f"cache {sname}")


def test_param_specs_allocate_nothing_at_full_width():
    """Full-width deepseek-v3-671b (671B parameters) on the meta device
    in under a second, once torch's meta kernels are loaded."""
    import time
    build_model(get_config("deepseek-v3-671b").reduced()).param_specs()
    t0 = time.perf_counter()
    specs = build_model(get_config("deepseek-v3-671b")).param_specs()
    elapsed = time.perf_counter() - t0
    leaves = [t for _, t in leaves_with_path(specs)]
    assert len(leaves) == 59 and all(t.is_meta for t in leaves)
    assert sum(t.numel() for t in leaves) > 6.7e11
    assert elapsed < 1.0, elapsed


def test_submesh_shapes(fake_world):
    m = make_submesh(8, device_type="cpu")
    assert m.size() == 8 and sharding.mesh_sizes(m)["model"] == 8
    m = make_submesh(8, model_parallel=4, device_type="cpu")
    assert sharding.mesh_sizes(m) == {"data": 2, "model": 4}
    with pytest.raises(ValueError):
        make_submesh(8, model_parallel=3, device_type="cpu")


# --------------------------------------------------------------------- #
# blockwise int8
# --------------------------------------------------------------------- #
def _quant_input(case):
    rng = np.random.default_rng(7)
    if case == "ragged":                  # 1000 values: a padded block
        return rng.standard_normal(1000).astype(np.float32) * 3.0
    if case == "ties":                    # q = x / scale lands on .5
        x = (np.arange(-127, 129, dtype=np.float32) + 0.5) / 127.0
        x[0] = -1.0
        return np.tile(x, 4).reshape(4, 256)
    if case == "zero-blocks":             # all-zero blocks: scale 1e-30
        x = rng.standard_normal((3, 7, 37)).astype(np.float32)
        x.reshape(-1)[256:512] = 0.0
        return x
    return rng.standard_normal((16, 1024)).astype(np.float32) * 1e-3


@pytest.mark.parametrize("case", ["ragged", "ties", "zero-blocks", "small"])
def test_quantize_blockwise_is_byte_identical(case):
    x = _quant_input(case)
    jq, js, jpad = jcomp.quantize_blockwise(jnp.asarray(x))
    q, s, pad = compression.quantize_blockwise(torch.from_numpy(x))
    assert pad == jpad
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    back = compression.dequantize_blockwise(q, s, pad, x.shape)
    jback = jcomp.dequantize_blockwise(jq, js, jpad, x.shape)
    np.testing.assert_array_equal(back.numpy().view(np.uint32),
                                  np.asarray(jback).view(np.uint32))


def test_psum_bytes_saved_matches_reference():
    tree = {"w": np.zeros((1 << 20,), np.float32),
            "b": [np.zeros((3, 5), np.float32)]}
    want = jcomp.psum_bytes_saved(jax.tree_util.tree_map(jnp.asarray, tree))
    got = compression.psum_bytes_saved(
        {"w": torch.from_numpy(tree["w"]),
         "b": [torch.from_numpy(tree["b"][0])]})
    assert got == want and got[1] < got[0] / 3.5


# --------------------------------------------------------------------- #
# multi-rank: one reference subprocess, one spawn of 8 gloo ranks
# --------------------------------------------------------------------- #
_REFERENCE = r'''
import os, sys
from pathlib import Path
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
sys.path.insert(0, sys.argv[2])
import torch_dist_ranks as ranks
from repro.configs import get_config
from repro.distributed import shard_map
from repro.distributed.compression import compressed_psum
from repro.distributed.expert_parallel import apply_moe_ep
from repro.launch.mesh import make_mesh
from repro.models.moe import apply_moe, init_moe

out = Path(sys.argv[1])
assert jax.device_count() == 8, jax.device_count()
mesh = make_mesh((8,), ("pod",))
x = jnp.asarray(np.load(out / "psum_x.npy"))
got = jax.jit(shard_map(lambda xs: compressed_psum(xs, "pod"), mesh=mesh,
                        in_specs=P("pod"), out_specs=P("pod")))(x)
np.save(out / "ref_psum.npy", np.asarray(got))

params = init_moe(jax.random.PRNGKey(0), ranks.ep_config(get_config, 8.0),
                  jnp.float32)
(out / "ep_params").mkdir()
for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
    name = "__".join(k.key for k in path)
    np.save(out / "ep_params" / f"{name}.npy", np.asarray(leaf))
x = jnp.asarray(np.load(out / "ep_x.npy"))
for case, shape, axes, cf in ranks.EP_CASES:
    cfg = ranks.ep_config(get_config, cf)
    mesh = make_mesh(shape, axes)
    with mesh:
        got = jax.jit(lambda p, xx: apply_moe_ep(p, xx, cfg, mesh=mesh))(
            params, x)
    np.save(out / f"ref_ep_{case}.npy", np.asarray(got))
'''


@pytest.fixture(scope="module")
def multi_rank(tmp_path_factory):
    """Inputs from numpy seeds; the reference's results over 8 fabricated
    devices; the port's over 8 gloo ranks.  Returns the directory."""
    out = tmp_path_factory.mktemp("multi_rank")
    rng = np.random.default_rng(0)
    np.save(out / "psum_x.npy", rng.standard_normal((8, 512)).astype(
        np.float32))
    np.save(out / "ep_x.npy", rng.standard_normal((4, 32, 32)).astype(
        np.float32))
    np.save(out / "decode_tokens.npy", rng.integers(
        0, ranks.STEP_REDUCED["vocab_size"], (ranks.STEP_BATCH, 1),
        dtype=np.int32))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref = subprocess.run([sys.executable, "-c", _REFERENCE, str(out),
                          str(Path(__file__).parent)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert ref.returncode == 0, ref.stderr[-4000:]
    ranks.spawn(str(out))
    ranks.spawn(str(out), ranks.LAYOUT_CHECKS)
    return out


def test_compressed_psum_matches_reference_bits(multi_rank):
    x = np.load(multi_rank / "psum_x.npy")
    want = np.load(multi_rank / "ref_psum.npy")
    for r in range(ranks.WORLD):
        got = np.load(multi_rank / f"got_psum_{r}.npy")
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want[r:r + 1].view(np.uint32))
    exact = np.broadcast_to(x.sum(0, keepdims=True), x.shape)
    rms_rel = np.sqrt(np.mean((want - exact) ** 2)) / np.sqrt(
        np.mean(exact ** 2))
    assert rms_rel < 0.02


@pytest.mark.parametrize("case", [c[0] for c in ranks.EP_CASES])
def test_moe_ep_matches_reference(multi_rank, case):
    got = np.load(multi_rank / f"got_ep_{case}.npy")
    want = np.load(multi_rank / f"ref_ep_{case}.npy")
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-3)
    if case.endswith("cf1.25"):        # the capacity drops assignments
        dropless = np.load(multi_rank / f"ref_ep_{case[:-6]}cf8.npy")
        assert np.abs(want - dropless).max() > 1e-2


@pytest.mark.parametrize("case", sorted(ranks.STEP_CASES))
def test_sharded_train_step_matches_unsharded(multi_rank, case):
    got, want = np.load(multi_rank / f"step_{case}_loss.npy")
    assert np.isfinite(got) and abs(got - want) <= 1e-5 * abs(want)
    grad_err, laid_out, _ = np.load(multi_rank / f"step_{case}_errs.npy")
    assert laid_out == 1.0 and grad_err < 1e-4


@pytest.mark.parametrize("case", sorted(ranks.STEP_CASES))
def test_sharded_decode_step_matches_unsharded(multi_rank, case):
    got, want = np.load(multi_rank / f"step_{case}_logits.npy")
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()
    assert np.load(multi_rank / f"step_{case}_errs.npy")[2] < 1e-5


@pytest.mark.parametrize("case", sorted(ranks.STEP_CASES))
def test_sharded_prefill_matches_unsharded(multi_rank, case):
    """The prefill's logits and cache, laid out by ``batch_pspecs`` and
    ``cache_pspecs``, then a decode step from that cache, at the decode
    case's tolerances."""
    laid_out, cache_err, decode_cache_err = np.load(
        multi_rank / f"prefill_{case}_errs.npy")
    assert laid_out == 1.0
    assert cache_err < 1e-5 and decode_cache_err < 1e-5
    for what in ("logits", "decode_logits"):
        got, want = np.load(multi_rank / f"prefill_{case}_{what}.npy")
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max(), what


@pytest.mark.parametrize("case", ranks.ZERO_CASES)
def test_zero_train_steps_match_unsharded(multi_rank, case):
    """Two steps with the moments laid out by ``optimizer_pspecs``: every
    parameter and moment keeps its layout; the loss within 1e-5, the
    parameters within 5e-5 (a sixth of one step's largest move, the
    learning rate 3e-4) and each moment leaf within 1e-4 of its largest
    value (the gradients' bound)."""
    for kept, loss, params, moments in np.load(
            multi_rank / f"zero_{case}_errs.npy"):
        assert kept == 1.0
        assert loss <= 1e-5 and params <= 5e-5 and moments <= 1e-4


def test_zero_specs_name_an_axis_twice_on_both_sides(fake_world):
    """With ``moe_ep`` on (2, 4), reduced deepseek-v2-236b's experts
    shard over ("data", "model"), and the ZeRO rule (the reference's
    ``DATA_AXIS in dims`` misses the tuple) names "data" again on
    another dim.  The port keeps the reference's specs: the same leaves
    get the same specs, the reference's ``NamedSharding`` refuses them
    and so does the port's ``to_placements``."""
    from jax._src.named_sharding import DuplicateSpecError
    from jax.sharding import NamedSharding as JNamedSharding
    shape, axes = MESHES["2x4"]
    jmesh = AbstractMesh(shape, axes)
    mesh = make_mesh(shape, axes, device_type="cpu")
    arch, overrides = ranks.STEP_CASES["deepseek-v2-236b-moe-ep"]
    jcfg = jget_config(arch).reduced(**ranks.STEP_REDUCED).with_overrides(
        **overrides)
    cfg = get_config(arch).reduced(**ranks.STEP_REDUCED).with_overrides(
        **overrides)
    j_shapes = jbuild(jcfg).param_specs()
    j_zero = _ref_flat(jsh.optimizer_pspecs(
        jsh.params_pspecs(jcfg, j_shapes, jmesh), j_shapes, jmesh))
    p_shapes = build_model(cfg).param_specs()
    zero = _port_flat(sharding.optimizer_pspecs(
        sharding.params_pspecs(cfg, p_shapes, mesh), p_shapes, mesh))

    def twice(spec):
        names = [a for e in spec for a in (e if isinstance(e, tuple)
                                           else (e,)) if a is not None]
        return len(names) != len(set(names))

    dup = sorted(k for k, v in j_zero.items() if twice(tuple(v)))
    assert dup == sorted(k for k, v in zero.items() if twice(tuple(v)))
    assert len(dup) == 6
    for path in dup:
        assert zero[path] == tuple(j_zero[path]) == (
            ("data", "model"), "data", None), path
        with pytest.raises(DuplicateSpecError):
            JNamedSharding(jmesh, j_zero[path])
        with pytest.raises(ValueError, match="axis data used twice"):
            sharding.to_placements(mesh, zero[path])


# --------------------------------------------------------------------- #
# moe_ep in the model
# --------------------------------------------------------------------- #
def test_moe_ep_without_a_mesh_is_the_dense_layer():
    """``cfg.moe_ep`` no longer raises; with no mesh ``apply_moe_ep`` is
    ``apply_moe`` (the reference's rule), so the forward is unchanged."""
    cfg = get_config("deepseek-v2-236b").reduced(dtype="float32")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(0))
    want = model.forward(params, {"tokens": tokens})
    got = build_model(cfg.with_overrides(moe_ep=True)).forward(
        params, {"tokens": tokens})
    assert torch.equal(got, want)
