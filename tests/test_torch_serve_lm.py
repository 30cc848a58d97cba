"""The port's LM serving engine and launcher, on the CPU.

Mirrors ``tests/test_serve_lm.py`` for ``repro_torch``: pow2 runner
cells, the resident decode pool's position wrap, the phase-aware
factory behind the port's ``RealPlane``, and a short ``run_lm_policy``
under both policies whose report has the reference's keys.  The engine
runs with ``device="cpu"``, where the kernel wrappers compute their
plain versions.
"""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.profiler import ProfileSpec  # noqa: E402
from repro_torch.kernels import KERNEL_STATS  # noqa: E402
from repro_torch.launch import bench_serving as tbench  # noqa: E402
from repro_torch.models.lm import apply_head  # noqa: E402
from repro_torch.models.serve_lm import (LM_MODELS, PHASE_DECODE,  # noqa: E402
                                         PHASE_PREFILL, PHASES, LmEngine,
                                         lm_tiny_config,
                                         lm_tiny_rung_configs,
                                         make_fidelity_lm_factory,
                                         make_lm_engine)
from repro_torch.serving import RealPlane  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """Tiny CPU ops run far slower under an oversubscribed intra-op pool
    (several test workers share the host); the tests need one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engine(one_cpu_thread):
    # max_seq 96 > the reduced gemma3 sliding window (64)
    return LmEngine(max_seq=96, device="cpu")


def test_prefill_decode_matches_full_forward_past_the_window(engine):
    """The engine's incremental path (ring cache past the window, cache
    updated in place) equals the full-sequence forward."""
    tok = torch.from_numpy(np.random.default_rng(7).integers(
        0, engine.cfg.vocab_size, (1, 80)))
    with torch.no_grad():
        full = apply_head(engine.params, engine.model.forward(
            engine.params, {"tokens": tok}), engine.cfg)
    n_pre = 72
    logits, cache = engine.prefill(tok[:, :n_pre])
    errs = [float((logits[:, 0] - full[:, n_pre - 1]).abs().max())]
    for i in range(n_pre, tok.shape[1]):
        logits, same = engine.decode_step(cache, tok[:, i:i + 1], i)
        assert same is cache                       # updated in place
        errs.append(float((logits[:, 0] - full[:, i]).abs().max()))
    assert max(errs) / float(full.abs().max()) < 2e-4


def test_lm_tiny_config_serves_through_kernels():
    cfg = lm_tiny_config()
    assert cfg.use_pallas_kernels and cfg.name == "lm-tiny"
    with pytest.raises(ValueError, match="use_pallas_kernels"):
        LmEngine(cfg.with_overrides(use_pallas_kernels=False),
                 device="cpu")


def test_prefill_runner_cells_bucket_pow2(engine):
    assert engine.prefill_runner(1, 3) is engine.prefill_runner(2, 4)
    assert engine.prefill_runner(1, 4) is not engine.prefill_runner(1, 8)
    assert engine.prefill_runner(1, 4, 8) is not \
        engine.prefill_runner(1, 4, 16)


def test_decode_runner_pool_advances_and_wraps(engine):
    run = engine.decode_runner(1, 2)
    s0 = engine.default_seq_bucket
    for _ in range(2 * (engine.max_seq - s0)):
        run()
        _, pos = engine._resident[2]
        assert s0 <= pos < engine.max_seq
    assert engine.decode_runner(4, 2) is run      # t does not key the cell


def test_factory_routes_phases(engine):
    make = engine.factory()
    assert getattr(make, "phase_aware", False)
    assert make(1, 2, PHASE_PREFILL) is engine.prefill_runner(1, 2)
    assert make(1, 2, PHASE_DECODE) is engine.decode_runner(1, 2)
    assert make(1, 2) is engine.decode_runner(1, 2)   # default phase


def test_registry_and_fidelity_ladder():
    assert "lm-tiny" in LM_MODELS and PHASES == (PHASE_PREFILL, PHASE_DECODE)
    with pytest.raises(ValueError, match="unknown LM serving model"):
        make_lm_engine("no-such-model", device="cpu")
    cfgs = lm_tiny_rung_configs(3)
    assert [c.resolved_head_dim for c in cfgs] == [16, 8, 8]
    make = make_fidelity_lm_factory(n_rungs=2, max_seq=32, device="cpu")
    assert make.phase_aware and make.fidelity_aware
    assert [e.default_seq_bucket for e in make.engines] == [16, 8]
    make(1, 1, PHASE_DECODE, fidelity=1)()
    with pytest.raises(ValueError, match="out of range"):
        make(1, 1, PHASE_DECODE, fidelity=2)


def test_real_plane_runs_the_factory(engine):
    plane = RealPlane(engine.factory(), total_units=2)
    profile = plane.profile(ProfileSpec(2, 2, thread_values=(1, 2)),
                            warmup=0, iters=1, phase=PHASE_DECODE)
    assert set(profile) == {(1, 1), (1, 2), (2, 1), (2, 2)}
    assert all(lat > 0 for lat in profile.values())
    assert plane.runner_report()["cached"] == 4
    plane.close()


def test_concurrent_decode_steps_of_one_cell_are_serialized(engine):
    """Two plane cells ⟨t, b⟩ sharing one decode runner step its resident
    cache from several threads; every step must advance the position
    exactly once (a lost update would skip or repeat one)."""
    import threading
    run = engine.decode_runner(1, 1)
    s0, span = engine.default_seq_bucket, engine.max_seq - \
        engine.default_seq_bucket
    _, pos0 = engine._resident[1]
    n_threads, steps = 4, 5
    threads = [threading.Thread(target=lambda: [run() for _ in range(steps)])
               for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    _, pos = engine._resident[1]
    assert pos == s0 + (pos0 - s0 + n_threads * steps) % span


def test_prefill_cell_waits_only_for_its_own_threads_stream(monkeypatch):
    """Plane cells ⟨t, b⟩ sharing one prefill runner run it from several
    worker threads at once; each thread must run on its own stream and
    wait on that stream alone, or its wall time would include the other
    workers' batches.  Streams are stand-ins here: the CPU has none."""
    import contextlib
    import threading
    eng = LmEngine(max_seq=32, device="cpu")
    made, waits = [], []
    lock = threading.Lock()

    def new_stream():
        with lock:
            made.append(object())
            return made[-1]

    def wait(stream):
        with lock:
            waits.append((threading.get_ident(), stream))

    monkeypatch.setattr(eng, "_cell_stream", new_stream)
    monkeypatch.setattr(eng, "_on", lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(eng, "_wait", wait)
    run = eng.prefill_runner(1, 2, 8)               # warm-up on this thread
    n_threads, steps = 2, 3
    barrier = threading.Barrier(n_threads)

    def worker():
        barrier.wait()
        for _ in range(steps):
            run()

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    by_thread = collections.defaultdict(set)
    for ident, stream in waits:
        by_thread[ident].add(stream)
    workers = {t.ident for t in threads}
    assert workers <= set(by_thread)
    assert all(len(by_thread[i]) == 1 for i in by_thread)
    assert len(set().union(*by_thread.values())) == n_threads + 1
    assert len(made) == n_threads + 1
    assert sum(1 for i, _ in waits if i in workers) == n_threads * steps


def _key_tree(rep, depth=2):
    """The report's key structure, descending into fixed-schema dicts
    (maps keyed by data — cell labels, instance ids — stop the walk)."""
    data_keyed = {"compile_ms", "instances", "reconfig_log",
                  "latency_histogram", "queue_depth", "cells"}
    out = {}
    for k, v in rep.items():
        if isinstance(v, dict) and depth > 0 and k not in data_keyed:
            out[k] = _key_tree(v, depth - 1)
        else:
            out[k] = None
    return out


def test_run_lm_policy_report_keys_match_reference(engine):
    """Both policies serve a short trace to completion, and the report has
    exactly the keys the reference's run_lm_policy produces on the same
    trace and profiles."""
    pytest.importorskip("jax")
    from repro.launch import bench_serving as jbench
    from repro.models.serve_lm import LmEngine as JaxLmEngine
    profiles = {p: {(t, b): 0.002 * b / t for t in (1, 2) for b in (1, 2)}
                for p in PHASES}
    arrivals = [0.05 * i for i in range(1, 6)]
    kw = dict(profiles=profiles, units=2, duration=0.4, initial_batch=2,
              max_batch=2, decode_steps=2,
              slo_by_phase={p: 1.0 for p in PHASES},
              reconfigure_timeout=0.2, dispatch="continuous",
              real_model="lm-tiny")
    ref_engine = JaxLmEngine(max_seq=32)
    for eng in (engine, ref_engine):       # build every cell ahead of time
        for b in (1, 2):
            eng.prefill_runner(1, b)
            eng.decode_runner(1, b)
    before = {n: s.cpu_calls for n, s in KERNEL_STATS.items()}
    for policy in ("static", "packrat"):
        got = tbench.run_lm_policy(policy, arrivals,
                                   factory=engine.factory(), **kw)
        want = jbench.run_lm_policy(policy, arrivals,
                                    factory=ref_engine.factory(), **kw)
        assert got["phases"][PHASE_PREFILL]["completed"] == len(arrivals)
        assert got["phases"][PHASE_DECODE]["completed"] == 2 * len(arrivals)
        assert got["incomplete"] == 0 and want["incomplete"] == 0
        assert _key_tree(got) == _key_tree(want)
    # the CPU engine went through the attention kernels' plain versions
    # (lm-tiny has no recurrent layer)
    assert all(KERNEL_STATS[n].cpu_calls > before[n]
               for n in ("flash_attention", "decode_attention"))


REJECTED_ARGVS = [
    ["--duration", "0"],
    ["--units", "0"],
    ["--max-batch", "0"],
    ["--slo-ms", "-5"],
    ["--nodes", "0"],
    ["--nodes", "2", "--models", "resnet50,bert"],
    ["--nodes", "2", "--execution", "real"],
    ["--fidelity-ladder"],
    ["--execution", "real", "--models", "resnet50,bert"],
    ["--execution", "real", "--interference"],
    ["--execution", "real", "--model", "resnet50"],
    ["--execution", "real", "--real-model", "no-such-model"],
    ["--execution", "real", "--real-model", "lm-tiny", "--nodes", "2"],
    ["--execution", "real", "--real-model", "lm-tiny", "--units", "1"],
    ["--execution", "real", "--real-model", "lm-tiny",
     "--lm-decode-steps", "0"],
    ["--models", "resnet50"],
    ["--models", "resnet50,no-such-model"],
    ["--models", "resnet50,bert", "--units", "1"],
    ["--models", "resnet50,bert", "--trace", "t.json"],
    ["--models", "resnet50,bert", "--scenario", "diurnal"],
    ["--scenario", "no-such-scenario"],
    ["--trace", "no-such-trace.json"],
    ["--model", "no-such-model"],
    ["--execution", "tpu"],
]


@pytest.mark.parametrize("argv", REJECTED_ARGVS, ids=" ".join)
def test_launcher_rejects_unported_modes(argv, capsys):
    """The port's launcher holds the reference's rejection rules: each
    argv the reference refuses (``tests/test_bench_serving.py``) exits
    with argparse's code 2 and the reference's error line, and no mode
    the reference accepts is refused as not ported."""
    pytest.importorskip("jax")
    from repro.launch import bench_serving as jbench
    errors = []
    for main in (tbench.main, jbench.main):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errors[0] == errors[1]
    assert "not yet ported" not in errors[0]


def test_launcher_runs_lm_tiny_on_cpu(tmp_path, capsys):
    out = tmp_path / "report.json"
    assert tbench.main(["--execution", "real", "--real-model", "lm-tiny",
                        "--device", "cpu", "--scenario", "steady-poisson",
                        "--duration", "2", "--units", "2",
                        "--max-batch", "2", "--lm-decode-steps", "2",
                        "--dispatch", "continuous", "--out",
                        str(out)]) == 0
    import json
    rep = json.loads(out.read_text())
    sc = rep["scenarios"]["steady-poisson"]
    assert rep["schema_version"] == tbench.SCHEMA_VERSION
    assert sc["policies"] == ["static+continuous", "packrat+continuous"]
    counts = collections.Counter()
    for key in sc["policies"]:
        counts[key] = sc[key]["phases"][PHASE_PREFILL]["completed"]
    assert all(v == sc["offered_prompts"] for v in counts.values())


def test_launcher_lm_mode_through_main_on_cpu(capsys):
    """The launcher's LM mode as ``chip_smoke.py``'s launcher_lm phase
    runs it (lm-tiny, steady-poisson, 4 units), here on the CPU, shorter
    and at max batch 4: exit 0, every prompt and decode step completed
    under both policies and both dispatches with TTFT and TPOT p50/p95,
    and the attention wrappers took their plain versions."""
    import json
    argv = ["--execution", "real", "--real-model", "lm-tiny",
            "--scenario", "steady-poisson", "--duration", "2",
            "--units", "4", "--max-batch", "4", "--device", "cpu"]
    before = {n: KERNEL_STATS[n].cpu_calls
              for n in ("flash_attention", "decode_attention")}
    assert tbench.main(argv) == 0
    sc = json.loads(capsys.readouterr().out)["scenarios"]["steady-poisson"]
    prompts, steps = sc["offered_prompts"], sc["decode_steps"]
    assert prompts > 0 and steps == 8
    assert {k.split("+")[0] for k in sc["policies"]} == {"static", "packrat"}
    for key in sc["policies"]:
        rep = sc[key]
        assert rep["phases"][PHASE_PREFILL]["completed"] == prompts
        assert rep["phases"][PHASE_DECODE]["completed"] == prompts * steps
        assert rep["incomplete"] == 0
        for metric in ("ttft_ms", "tpot_ms"):
            assert all(rep[metric][q] > 0 for q in ("p50", "p95"))
    assert all(KERNEL_STATS[n].cpu_calls > before[n] for n in before)


def test_engine_serves_reduced_deepseek_on_cpu():
    """deepseek-v2-236b's MLA/MoE stack behind the engine (stacked
    layout, as the full config): prefill + decode through the latent
    cache equal the full forward on a dropless MoE, and every runner
    cell runs with no kernel call, since MLA and MoE have none."""
    from repro_torch.configs import get_config
    cfg = get_config("deepseek-v2-236b").reduced(
        dtype="float32", use_pallas_kernels=True, scan_layers=True)
    eng = LmEngine(cfg, max_seq=32, default_seq_bucket=16, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 24)))
    with torch.no_grad():
        full = apply_head(eng.params, eng.model.forward(
            eng.params, {"tokens": tok}), cfg)
    logits, cache = eng.prefill(tok[:, :20])
    errs = [float((logits[:, 0] - full[:, 19]).abs().max())]
    for i in range(20, 24):
        logits, _ = eng.decode_step(cache, tok[:, i:i + 1], i)
        errs.append(float((logits[:, 0] - full[:, i]).abs().max()))
    assert max(errs) / float(full.abs().max()) < 2e-4
    calls = {n: s.cpu_calls for n, s in KERNEL_STATS.items()}
    make = eng.factory()
    for b in (1, 4):
        assert make(1, b, PHASE_PREFILL)() is None
        assert make(1, b, PHASE_DECODE)() is None
    assert {n: s.cpu_calls for n, s in KERNEL_STATS.items()} == calls
