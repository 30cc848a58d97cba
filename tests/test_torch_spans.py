"""The real plane's span log (``repro_torch.serving.spans``), on the CPU.

A short ``run_lm_policy`` on lm-tiny under both dispatch policies: each
served prompt's and decode step's span components add up to its TTFT or
TPOT (``Response.completion - arrival``) within a microsecond, each
decode step's cause chains back to its prompt, and each batch's stamps
come in order.  Then the log's bound, ``mark`` outside a batch and the
log switched off.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import bench_serving as tbench  # noqa: E402
from repro_torch.models.serve_lm import (PHASE_DECODE,  # noqa: E402
                                         PHASE_PREFILL, PHASES, LmEngine)
from repro_torch import serving  # noqa: E402
from repro_torch.serving import RealPlane, Request  # noqa: E402
from repro_torch.serving import spans as span_log  # noqa: E402
from repro_torch.serving.spans import (BATCH_FIELDS,  # noqa: E402
                                       REQUEST_FIELDS, TRIGGERS, SpanLog,
                                       mark)

DECODE_STEPS = 2
ARRIVALS = [0.05 * i for i in range(1, 7)]


@pytest.fixture(scope="module")
def engine():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    eng = LmEngine(max_seq=32, device="cpu")
    for b in (1, 2):                       # build every cell ahead of time
        eng.prefill_runner(1, b)
        eng.decode_runner(1, b)
    yield eng
    torch.set_num_threads(n)


def _serve(engine, monkeypatch, dispatch="continuous"):
    """run_lm_policy's packrat path over ARRIVALS; returns the report and
    every Response the launcher's collector saw."""
    responses = []

    class Collector(tbench.MetricsCollector):
        def on_response(self, resp):
            super().on_response(resp)
            responses.append(resp)

    monkeypatch.setattr(tbench, "MetricsCollector", Collector)
    profiles = {p: {(t, b): 0.002 * b / t for t in (1, 2) for b in (1, 2)}
                for p in PHASES}
    rep = tbench.run_lm_policy(
        "packrat", ARRIVALS, factory=engine.factory(), profiles=profiles,
        units=2, duration=0.4, initial_batch=2, max_batch=2,
        decode_steps=DECODE_STEPS, slo_by_phase={p: 1.0 for p in PHASES},
        reconfigure_timeout=0.2, dispatch=dispatch, real_model="lm-tiny")
    return rep, responses


@pytest.fixture(scope="module", params=["continuous", "sync"])
def served(request, engine):
    mp = pytest.MonkeyPatch()
    try:
        rep, responses = _serve(engine, mp, request.param)
    finally:
        mp.undo()
    assert rep["incomplete"] == 0
    spans = rep["spans"]
    req = {r[0]: dict(zip(spans["request_fields"], r))
           for r in spans["requests"]}
    batches = [dict(zip(spans["batch_fields"], b)) for b in spans["batches"]]
    return spans, req, batches, responses


def test_export_names_its_fields(served):
    spans, req, batches, responses = served
    assert spans["request_fields"] == list(REQUEST_FIELDS)
    assert spans["batch_fields"] == list(BATCH_FIELDS)
    assert spans["triggers"] == list(TRIGGERS)
    assert spans["clock"] == "perf_counter" and spans["epoch"] > 0
    assert spans["dropped"] == 0
    assert sorted(spans["phases"]) == sorted(PHASES)
    assert len(req) == len(ARRIVALS) * (1 + DECODE_STEPS) == len(responses)
    assert [b["id"] for b in batches] == list(range(len(batches)))


def test_components_add_up_to_ttft_and_tpot(served):
    spans, req, batches, responses = served
    phases = spans["phases"]
    for resp in responses:
        r = req[resp.request.id]
        b = batches[r["batch"]]
        assert phases[r["phase"]] == resp.request.phase == \
            phases[b["phase"]]
        assert r["due"] == resp.request.arrival
        assert r["delivered"] == resp.completion
        assert resp.request.id in b["requests"]
        parts = [r["submitted"] - r["due"], b["fired"] - r["submitted"],
                 b["gate"] - b["fired"], b["run_end"] - b["gate"],
                 r["delivered"] - b["run_end"]]
        assert min(parts) >= 0
        assert sum(parts) == pytest.approx(
            resp.completion - resp.request.arrival, abs=1e-6)


def test_decode_steps_chain_back_to_their_prompts(served):
    spans, req, batches, responses = served
    phases = spans["phases"]
    prompts = {i for i, r in req.items()
               if phases[r["phase"]] == PHASE_PREFILL}
    assert prompts == set(range(len(ARRIVALS)))
    assert all(req[i]["cause"] == -1 for i in prompts)
    roots = []
    for i, r in req.items():
        if phases[r["phase"]] != PHASE_DECODE:
            continue
        hops, cur = 0, r
        while cur["cause"] != -1:
            # a step is made when the request that caused it is delivered
            assert req[cur["cause"]]["delivered"] <= cur["due"]
            cur = req[cur["cause"]]
            hops += 1
        assert cur["id"] in prompts and 1 <= hops <= DECODE_STEPS
        roots.append(cur["id"])
    # every prompt has DECODE_STEPS steps, one at each depth
    assert sorted(roots) == sorted(list(prompts) * DECODE_STEPS)


def test_batch_stamps_come_in_order(served):
    spans, req, batches, responses = served
    phases = spans["phases"]
    for b in batches:
        assert b["fired"] <= b["start"] <= b["gate"] <= b["run_end"] \
            <= b["delivered"]
        assert b["gate"] <= b["enqueued"] <= b["run_end"]
        if phases[b["phase"]] == PHASE_DECODE:
            assert b["gate"] <= b["locked"] <= b["enqueued"]
        else:
            assert b["locked"] == -1.0
        assert len(b["requests"]) >= 1
    # the prompts arrive one at a time into batches of two: the coalesce
    # timer fires some
    assert any(spans["triggers"][b["trigger"]] == "coalesce"
               for b in batches)


def test_spans_off_exports_nothing(engine, monkeypatch):
    # a plane keeps no log unless its caller asks; run_lm_policy asks
    assert RealPlane(engine.factory(), 2).spans is None
    assert RealPlane(engine.factory(), 2, spans=True).spans is not None

    def plane_without_log(*args, **kw):
        return RealPlane(*args, **dict(kw, spans=False))

    # run_lm_policy imports the plane from the serving package at call time
    monkeypatch.setattr(serving, "RealPlane", plane_without_log)
    rep, responses = _serve(engine, monkeypatch)
    assert "spans" not in rep
    assert rep["incomplete"] == 0
    assert len(responses) == len(ARRIVALS) * (1 + DECODE_STEPS)


def test_bound_counts_dropped(monkeypatch):
    monkeypatch.setattr(span_log, "MAX_RECORDS", 3)
    log = SpanLog()
    reqs = [Request(i, 0.1 * i, phase=PHASE_PREFILL) for i in range(5)]
    for r in reqs:
        log.submitted(r, 1.0)
    assert [rec[0] for rec in log.requests] == [0, 1, 2]
    assert log.dropped == 2
    for _ in range(4):
        log.open_batch(reqs[:2], "full", 1.0)
    assert len(log.batches) == 3 and log.dropped == 3
    # a dropped request is delivered without a record, and nothing raises
    log.delivered(reqs[4], log.batches[0], 2.0)
    log.delivered(reqs[0], log.batches[0], 2.0)
    assert log.requests[0][REQUEST_FIELDS.index("delivered")] == 2.0
    assert log.export()["dropped"] == 3


def test_mark_stamps_only_inside_a_batch():
    log = SpanLog(clock=lambda: 10.0)
    log.epoch = 4.0
    span = log.open_batch([Request(0, 0.0, phase=PHASE_DECODE)], "coalesce",
                          5.0)
    locked = BATCH_FIELDS.index("locked")
    mark("locked")                              # outside a batch: nothing
    assert span[locked] == -1.0
    log.enter(span, 5.5)
    mark("locked")
    log.leave(span, 9.0)
    mark("enqueued")                            # after leave: nothing
    assert span[locked] == 6.0
    assert span[BATCH_FIELDS.index("gate")] == 1.5
    assert span[BATCH_FIELDS.index("run_end")] == 5.0
    assert span[BATCH_FIELDS.index("enqueued")] == -1.0
    with pytest.raises(KeyError):
        mark("gate")
