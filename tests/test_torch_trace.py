"""The port's spans (runtime/trace.py) on the CPU: what one synthesize_batch
call records under torch.profiler, and that nothing is recorded without
one. The synthesizer's launch is stubbed where a test reads only the spans
(the plain program under the profiler takes tens of seconds)."""

import json
import threading

import pytest
import torch

import grail_tpu_torch as g
from grail_tpu_torch import api as papi
from grail_tpu_torch.runtime import trace
from grail_tpu_torch.synth.score import (_reference_boundary_samples_np,
                                         merge_glides,
                                         score_from_phoneme_elems)

torch.set_num_threads(2)
PREP_CHILDREN = {"lattices", "tables", "schedule", "launch"}


@pytest.fixture(autouse=True)
def empty_buffer():
    trace.clear()
    yield
    trace.clear()


@pytest.fixture
def no_launch(monkeypatch):
    """synth_fused answers zeros of the shape it would return."""
    def stub(tables, T, impl, **kw):
        return torch.zeros(tables.n.shape[0], T), None

    monkeypatch.setattr(papi, "synth_fused", stub)


def profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return prof, out


def _by_name(spans):
    got = {s.name: s for s in spans}
    assert len(got) == len(spans), [s.name for s in spans]
    return got


def _nested(spans):
    """Every child's interval inside its parent's, one call id."""
    got = _by_name(spans)
    assert len({s.call for s in spans}) == 1
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = got[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, s.name
    return got


def test_one_batch_call_records_its_spans(no_launch, tmp_path):
    prof, outs = profiled(lambda: g.synthesize_batch(["ae", "ea"],
                                                     device="cpu"))
    assert len(outs) == 2
    got = _nested(trace.spans())
    assert set(got) == {"batch", "frontend", "prep"} | PREP_CHILDREN
    assert got["batch"].parent is None and got["batch"].attrs == {"B": 2}
    assert got["frontend"].parent == got["prep"].parent == "batch"
    assert {n for n, s in got.items() if s.parent == "prep"} == PREP_CHILDREN
    assert got["prep"].attrs == {
        "carrier": "q32", "S": 1,
        "T": papi._round_up(max(o.shape[0] for o in outs), papi.BLOCK_SIZE)}
    assert isinstance(got["schedule"].attrs["hit"], bool)
    # the spans stand in the profiler's Chrome trace
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert {"grail.batch", "grail.frontend", "grail.prep"} <= names


def test_the_split_builds_its_schedule_under_its_own_span(no_launch,
                                                          monkeypatch):
    # route's CPU answer is unsplit; the split is reached as the card would
    monkeypatch.setattr(papi, "route", lambda B, maxN, *a, **kw: (
        "plain", "q32", 2, papi._round_up(maxN, 2 * papi.BLOCK_SIZE)))
    profiled(lambda: g.synthesize_batch(["ae", "ea"], device="cpu"))
    got = _nested(trace.spans())
    assert got["prep"].attrs["S"] == 2
    assert {n for n, s in got.items() if s.parent == "prep"} == PREP_CHILDREN


def test_the_kcar_split_tallies_its_seam_samples(no_launch, monkeypatch):
    # the exact carrier's split, as the card routes a batch past 30 s: the
    # seam pre-pass (its plain version here) steps each utterance to its
    # last seam, T - T/S - W samples, and `prep` counts the lane-samples
    T = {}

    def route(B, maxN, *a, **kw):
        T["T"] = papi._round_up(maxN, 4 * papi.BLOCK_SIZE)
        return "plain", "kcar", 4, T["T"]

    monkeypatch.setattr(papi, "route", route)
    profiled(lambda: g.synthesize_batch(["ae", "ea"], device="cpu"))
    got = _nested(trace.spans())
    assert got["prep"].attrs["carrier"] == "kcar"
    assert got["prep"].attrs["kcar_seam_samples"] == 2 * (
        T["T"] - T["T"] // 4 - papi.WARMUP)
    assert "kcar_seam_samples" not in got["launch"].attrs


@pytest.mark.parametrize("case", ["no profiler", "frontend alone"])
def test_nothing_is_recorded(case, no_launch):
    if case == "no profiler":
        g.synthesize_batch(["ae", "ea"], device="cpu")
    else:       # the public frontend functions record no frontend span
        v = papi._resolve_voice("generic")
        profiled(lambda: [score_from_phoneme_elems(
            papi.text_to_phoneme_elems(t, v), v) for t in ["ae", "ea"]])
    assert trace.spans() == []


def test_synthesize_scores_alone_opens_prep_as_a_root(no_launch):
    scores = [g.text_to_score(t) for t in ["ae", "ea"]]

    def two_calls():
        g.synthesize_batch(["ae"], device="cpu")
        g.synthesize_scores(scores, device="cpu")

    profiled(two_calls)
    got = trace.spans()
    roots = [s for s in got if s.parent is None]
    assert [s.name for s in roots] == ["batch", "prep"]
    assert roots[0].call != roots[1].call
    solo = _nested([s for s in got if s.call == roots[1].call])
    assert set(solo) == {"prep"} | PREP_CHILDREN
    assert solo["prep"].attrs["carrier"] == "q32"


def test_a_thread_of_its_own_starts_its_own_call(monkeypatch):
    # the profiler follows only the thread that started it, so the spans
    # of another thread are recorded here as if one followed it too
    monkeypatch.setattr(trace, "_recording", lambda: True)

    def worker():
        with trace.span("prep"):
            pass

    def calls():
        with trace.span("batch"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()

    calls()
    got = _by_name(trace.spans())
    assert got["prep"].parent is None
    assert got["prep"].call != got["batch"].call


def test_the_buffer_keeps_the_newest_spans_up_to_its_bound():
    def many():
        for i in range(trace.MAXLEN + 10):
            with trace.span("s", i=i):
                pass

    profiled(many)
    got = trace.spans()
    assert len(got) == trace.MAXLEN
    assert got[0].attrs["i"] == 10 and got[-1].attrs["i"] == trace.MAXLEN + 9


def test_the_frontend_counts_the_drift_countdowns_steps(no_launch):
    texts = ["hello there.", "how are you today?", "the quick brown fox."]
    prof, _ = profiled(lambda: g.synthesize_batch(
        texts, voice="plain", language="english", device="cpu"))
    attrs = _by_name(trace.spans())["frontend"].attrs
    v = papi._resolve_voice("plain")
    samples = sum(int(_reference_boundary_samples_np(
        [pe.length for pe in merge_glides(papi.text_to_phoneme_elems(
            t, v, "english"))], v.sample_rate)[0][-1]) for t in texts)
    assert attrs["drift_samples"] == samples > 3 * 44100
    assert 0 < attrs["drift_steps"] < 0.01 * attrs["drift_samples"]
    # without a profiler the countdown still runs, and nothing is recorded
    trace.clear()
    g.synthesize_batch(texts, voice="plain", language="english",
                       device="cpu")
    assert trace.spans() == []
