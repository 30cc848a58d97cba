"""The port's checkpoints, its train loop's resume and its launcher, on
the CPU.

* ``Checkpointer`` as ``tests/test_training.py`` holds the reference's:
  a bit-exact round trip, GC of old steps, an uncommitted step ignored,
  async save, and a resume that continues the uninterrupted run.
* The format is the reference's: for the same tree (bf16 parameters, an
  fp32 AdamW state and its int32 step) both packages write the same
  ``manifest.json`` and the same leaf files, a reference checkpoint
  restores into the port and a port checkpoint into the reference, bit
  for bit.
* ``python -m repro_torch.launch.train --reduced --device cpu`` trains a
  few steps and checkpoints, and ``--resume`` continues from the saved
  step.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.training import Checkpointer as JCheckpointer  # noqa: E402
from repro.training import init_adamw as jinit_adamw  # noqa: E402
from repro.training import AdamWConfig as JAdamWConfig  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.data import batches_for_model  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        params_to_numpy)
from repro_torch.training import (AdamWConfig, AdamWState,  # noqa: E402
                                  Checkpointer, TrainConfig, init_adamw,
                                  train)
from repro_torch.training.tree import leaves_with_path  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """Tiny CPU ops run far slower under an oversubscribed intra-op pool
    (several test workers share the host); the tests need one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_model():
    """The reference tests' tiny model: reduced llama3-8b, bf16."""
    cfg = get_config("llama3-8b").reduced(vocab_size=128, n_repeats=2,
                                          d_model=32, n_heads=2, d_ff=64)
    return cfg, build_model(cfg)


def _bits(t: torch.Tensor) -> bytes:
    t = t.detach().cpu().contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy(
        ).tobytes()


def _assert_trees_bit_equal(a, b):
    la, lb = leaves_with_path(a), leaves_with_path(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert _bits(x) == _bits(y), name


# --------------------------------------------------------------------- #
# the reference's checkpoint tests, on the port
# --------------------------------------------------------------------- #
def test_checkpoint_roundtrip(tmp_path):
    _, model = tiny_model()
    params = model.init(0, device="cpu")
    opt = init_adamw(AdamWConfig(master_weights=True), params)
    ck = Checkpointer(str(tmp_path), keep=2)
    ck.save(10, params, opt)
    restored = ck.restore(like={"params": params, "opt_state": opt})
    assert restored["step"] == 10
    got = restored["tree"]
    assert isinstance(got["opt_state"], AdamWState)
    assert got["opt_state"].step.dtype == torch.int32
    _assert_trees_bit_equal(got, {"params": params, "opt_state": opt})
    arrays = ck.restore()["arrays"]
    assert arrays["['params']['embed']"].dtype == torch.bfloat16
    assert _bits(arrays["['params']['embed']"]) == _bits(params["embed"])


def test_checkpoint_gc_keeps_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    p = {"w": torch.ones(4)}
    for s in (1, 2, 3, 4):
        ck.save(s, p)
    assert ck.all_steps() == [3, 4]


def test_uncommitted_checkpoint_ignored(tmp_path):
    ck = Checkpointer(str(tmp_path))
    p = {"w": torch.ones(4)}
    ck.save(5, p)
    torn = tmp_path / "step_000000009"
    torn.mkdir()
    (torn / "manifest.json").write_text("{}")
    assert ck.latest_step() == 5
    with pytest.raises(FileNotFoundError):
        ck.restore(step=9)


def test_async_checkpoint(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=True)
    p = {"w": torch.arange(16, dtype=torch.float32)}
    ck.save(1, p)
    # the host copy was taken before save returned: a later write to the
    # live tensor does not reach the checkpoint
    p["w"].add_(100.0)
    ck.wait()
    got = ck.restore(like={"params": p, "opt_state": None})
    assert got["tree"]["opt_state"] is None
    np.testing.assert_array_equal(got["tree"]["params"]["w"].numpy(),
                                  np.arange(16, dtype=np.float32))


def test_restore_rejects_a_mismatched_tree(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.ones(4)})
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.restore(like={"params": {"w": torch.ones(5)}, "opt_state": None})
    with pytest.raises(KeyError, match="missing leaf"):
        ck.restore(like={"params": {"v": torch.ones(4)}, "opt_state": None})


def test_train_resume_continues(tmp_path):
    """Kill/restart: resume from a checkpoint repeats the uninterrupted
    run bit for bit (same losses, same parameters)."""
    cfg, model = tiny_model()
    shape = ShapeConfig("t", seq_len=16, global_batch=4, kind="train")
    tcfg = TrainConfig(adamw=AdamWConfig(learning_rate=1e-3, warmup_steps=2,
                                         decay_steps=50))

    def data():
        return batches_for_model(cfg, shape, seed=3)

    losses_full, losses_res = [], []
    p_full, o_full, _ = train(
        model, tcfg, data(), steps=10, device="cpu",
        on_step=lambda s, m: losses_full.append(float(m["loss"])))
    ck = Checkpointer(str(tmp_path), async_save=True)
    p5, o5, _ = train(model, tcfg, data(), steps=5, device="cpu",
                      checkpointer=ck, checkpoint_every=5)
    ck.wait()
    fresh = model.init(1, device="cpu")
    restored = ck.restore(like={"params": fresh,
                                "opt_state": init_adamw(tcfg.adamw, fresh)})
    assert restored["step"] == 5
    _assert_trees_bit_equal(restored["tree"], {"params": p5, "opt_state": o5})
    it = data()
    for _ in range(5):
        next(it)                                  # skip consumed batches
    p_res, o_res, _ = train(
        model, tcfg, it, steps=10, device="cpu",
        params=restored["tree"]["params"],
        opt_state=restored["tree"]["opt_state"],
        on_step=lambda s, m: losses_res.append(float(m["loss"])))
    assert int(o_res.step) == int(o_full.step) == 10
    assert losses_res == losses_full[5:]
    _assert_trees_bit_equal(p_res, p_full)


# --------------------------------------------------------------------- #
# the reference's format, both ways
# --------------------------------------------------------------------- #
def _both_trees():
    """The reference's tiny model (bf16) and an fp32 AdamW state, and the
    same tree in the port."""
    jcfg = jget_config("llama3-8b").reduced(vocab_size=128, n_repeats=2,
                                            d_model=32, n_heads=2, d_ff=64)
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    jopt = jinit_adamw(JAdamWConfig(), jparams)
    tcfg = get_config("llama3-8b").reduced(vocab_size=128, n_repeats=2,
                                           d_model=32, n_heads=2, d_ff=64)
    tparams = params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    topt = init_adamw(AdamWConfig(), tparams)
    return (jparams, jopt), (tparams, topt)


def test_both_write_the_same_files(tmp_path):
    (jp, jo), (tp, to) = _both_trees()
    JCheckpointer(str(tmp_path / "ref")).save(7, jp, jo)
    Checkpointer(str(tmp_path / "port")).save(7, tp, to)
    ref, port = tmp_path / "ref" / "step_000000007", \
        tmp_path / "port" / "step_000000007"
    assert (port / "manifest.json").read_text() == \
        (ref / "manifest.json").read_text()
    manifest = json.loads((port / "manifest.json").read_text())
    assert {leaf["dtype"] for leaf in manifest["leaves"]} == {
        "bfloat16", "float32", "int32"}
    assert sorted(p.name for p in port.iterdir()) == sorted(
        p.name for p in ref.iterdir())
    for leaf in manifest["leaves"]:
        assert (port / leaf["file"]).read_bytes() == \
            (ref / leaf["file"]).read_bytes(), leaf["name"]


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    (jp, jo), (tp, to) = _both_trees()
    # move the reference state off its zeros, so every leaf is checked
    jo = jo._replace(step=jnp.int32(3), mu=jax.tree_util.tree_map(
        lambda p: p.astype(jnp.float32) * 0.5, jp))
    JCheckpointer(str(tmp_path)).save(3, jp, jo)
    fresh = build_model(get_config("llama3-8b").reduced(
        vocab_size=128, n_repeats=2, d_model=32, n_heads=2, d_ff=64)).init(
            5, device="cpu")
    got = Checkpointer(str(tmp_path)).restore(
        like={"params": fresh, "opt_state": init_adamw(AdamWConfig(),
                                                       fresh)})
    assert got["step"] == 3 and int(got["tree"]["opt_state"].step) == 3
    want = {"params": jp, "opt_state": jo}
    named = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
             jax.tree_util.tree_flatten_with_path(want)[0]}
    port = leaves_with_path(got["tree"])
    assert [n for n, _ in port] == list(named)
    for name, t in port:
        ref = named[name]
        bits = ref.view(np.uint16) if ref.dtype.name == "bfloat16" else ref
        assert _bits(t) == np.ascontiguousarray(bits).tobytes(), name


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    (jp, jo), (tp, to) = _both_trees()
    to = to._replace(step=torch.tensor(4, dtype=torch.int32),
                     nu={"embed": tp["embed"].float() * 2,
                         **{k: v for k, v in to.nu.items() if k != "embed"}})
    Checkpointer(str(tmp_path)).save(4, tp, to)
    got = JCheckpointer(str(tmp_path)).restore(
        like={"params": jp, "opt_state": jo})
    assert got["step"] == 4
    ref = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
           jax.tree_util.tree_flatten_with_path(got["tree"])[0]}
    port = leaves_with_path({"params": tp, "opt_state": to})
    assert [n for n, _ in port] == list(ref)
    for name, t in port:
        r = ref[name]
        assert r.dtype.name == str(t.dtype).removeprefix("torch."), name
        bits = r.view(np.uint16) if r.dtype.name == "bfloat16" else r
        assert _bits(t) == np.ascontiguousarray(bits).tobytes(), name
    # params_to_numpy gives the same bits
    as_np = params_to_numpy(tp)
    assert as_np["embed"].dtype == np.uint16
    assert as_np["embed"].tobytes() == np.asarray(jp["embed"]).view(
        np.uint16).tobytes()


# --------------------------------------------------------------------- #
# the launcher
# --------------------------------------------------------------------- #
LAUNCH = ["--arch", "gemma3-1b", "--reduced", "--d-model", "64",
          "--layers", "6", "--vocab", "256", "--batch", "2", "--seq", "16",
          "--log-every", "1", "--device", "cpu"]


def test_launcher_trains_and_resumes(tmp_path, capsys):
    ckpt = str(tmp_path / "ck")
    assert launch_train.main(LAUNCH + ["--steps", "3", "--ckpt", ckpt,
                                       "--ckpt-every", "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[train] arch=gemma3-1b-smoke params=")
    assert out[0].endswith("devices=1")
    steps = [ln for ln in out if "step=" in ln]
    assert len(steps) == 3
    for ln in steps:
        loss = float(ln.split("loss=")[1].split()[0])
        assert np.isfinite(loss) and "tok/s=" in ln and "lr=" in ln
    assert Checkpointer(ckpt).all_steps() == [2, 3]

    assert launch_train.main(LAUNCH + ["--steps", "5", "--ckpt", ckpt,
                                       "--resume"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "[train] resumed from step 3"
    assert [int(ln.split("step=")[1].split()[0]) for ln in out
            if "step=" in ln] == [4, 5]
    assert Checkpointer(ckpt).latest_step() == 5


def test_launcher_takes_the_reference_flags(monkeypatch):
    """The reference launcher's flags and defaults, plus --device: the
    namespaces both parsers give for the same argv."""
    import argparse
    from repro.launch import train as jlaunch

    class Parsed(Exception):
        pass

    parse = argparse.ArgumentParser.parse_args

    def stop_after_parsing(self, args=None, namespace=None):
        raise Parsed(parse(self, args, namespace))

    argv = ["--arch", "llama3-8b", "--reduced", "--steps", "7"]
    port = vars(launch_train.parse_args(argv))
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args",
                        stop_after_parsing)
    with pytest.raises(Parsed) as parsed:
        jlaunch.main(argv)
    assert port.pop("device") == "cuda"
    assert port == vars(parsed.value.args[0])
