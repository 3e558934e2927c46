"""The CLI's one-utterance route on the CPU, held against the benchmark's
plain reference (portbench/reference/render.py, which imports no code of
the port): `synthesize` on the host carrier track, unsplit as the CPU
routes it; the overlap-save split with the track, as the card routes it;
and the `track` span around the host pre-pass.

Tolerances, each with its reason (the reference in bfloat16 reads 0.55 to
0.59 on these texts, so it fails both):
  * the track route vs the reference's exact carrier: max-abs 1e-5. The
    track is the native pre-pass's integral of the oracle's frequency
    chain, the reference steps its own float32 recurrence: they agree to a
    few float32 ulps of phase (5.1e-7 and 2.9e-6 here), where the Q32
    carrier reads 1.2e-5 and 3.4e-5.
  * the split with the track vs the same unsplit reference: max-abs 1e-4,
    tests/test_torch_carrier.py's bound for split against unsplit: each
    segment's filter state comes from a WARMUP pre-roll (1.3e-5 here).
"""

import numpy as np
import pytest
import torch

import grail_tpu_torch as g
from grail_tpu_torch import api as papi
from grail_tpu_torch.runtime import trace
from portbench import compare
from portbench.reference.render import render

torch.set_num_threads(2)

VOICE, LANGUAGE = "plain", "english"
CASES = [("a", 11), ("ae", 2 ** 31 - 5)]
# 12 words: ~33 s of audio, past EXACT_CARRIER_AUTO_SECONDS
LONG = "the quick brown fox jumps over the lazy dog by the old river."


def _reference(text, seed):
    return render([text], [seed], VOICE, LANGUAGE, True, "cpu")[0]


@pytest.fixture
def routes(monkeypatch):
    """Every answer of api.route, in order."""
    got = []
    real = papi.route

    def spy(*a, **kw):
        got.append(real(*a, **kw))
        return got[-1]

    monkeypatch.setattr(papi, "route", spy)
    return got


@pytest.mark.parametrize("text,seed", CASES)
def test_the_track_route_matches_the_reference(text, seed, routes):
    out = g.synthesize(text, VOICE, LANGUAGE, seed=seed, exact_carrier=True,
                       device="cpu")
    assert [r[1:3] for r in routes] == [("track", 1)]
    ref = _reference(text, seed)
    assert out.shape == ref.shape
    assert compare.gap(out.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("S", [4, 8])
@pytest.mark.parametrize("text,seed", CASES)
def test_the_split_on_the_track_matches_the_reference(text, seed, S, routes):
    v = papi._resolve_voice(VOICE)
    pelems = papi.text_to_phoneme_elems(text, v, LANGUAGE)
    track = papi._carrier_track_for(pelems, v, seed)
    score = papi.text_to_score(text, v, LANGUAGE)
    out = papi._synthesize_split([score], v, seeds=[seed], S=S, device="cpu",
                                 carrier_tracks=[track])[0]
    assert routes[-1][1] == "track"
    ref = _reference(text, seed)
    assert out.shape == ref.shape
    assert compare.gap(out.numpy(), ref) <= 1e-4


@pytest.fixture
def no_launch(monkeypatch):
    """synth_fused answers zeros of the shape it would return (the spans
    alone are read; the plain program takes seconds a second of audio)."""
    def stub(tables, T, impl, **kw):
        return torch.zeros(tables.n.shape[0], T), None

    monkeypatch.setattr(papi, "synth_fused", stub)
    trace.clear()
    papi._carrier_cache.clear()
    yield
    trace.clear()


def _tracks(calls):
    trace.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        calls()
    got = trace.spans()
    by_call = {}
    for s in got:
        by_call.setdefault(s.call, {})[s.name] = s
    return [c.get("track") for c in by_call.values()], by_call


def test_a_solo_call_past_the_gate_records_one_track_span(no_launch):
    v = papi._resolve_voice(VOICE)
    pelems = papi.text_to_phoneme_elems(LONG, v, LANGUAGE)
    assert papi._wants_exact_carrier(pelems)
    tracks, calls = _tracks(lambda: [
        g.synthesize(LONG, VOICE, LANGUAGE, seed=7, device="cpu")
        for _ in range(2)])
    assert len(tracks) == 2
    for track, call in zip(tracks, calls.values()):
        assert track is not None and track.parent == "prep"
        prep = call["prep"]
        assert prep.start_ns <= track.start_ns <= track.end_ns <= prep.end_ns
        assert prep.attrs["carrier"] == "track"
    n = len(papi._carrier_track_for(pelems, v, 7))
    assert [t.attrs for t in tracks] == [
        {"hit": False, "samples": n, "track_chain_samples": n},
        {"hit": True, "samples": n}]


@pytest.mark.parametrize("case", ["batch of two", "solo under 30 s"])
def test_no_track_span_where_no_track_is_taken(case, no_launch):
    if case == "batch of two":
        def calls():
            g.synthesize_batch([LONG, LONG], VOICE, LANGUAGE, seeds=[7, 8],
                               device="cpu")
        carrier = "kcar"
    else:
        def calls():
            g.synthesize("ae", VOICE, LANGUAGE, seed=7, device="cpu")
        carrier = "q32"
    tracks, by_call = _tracks(calls)
    assert tracks == [None]
    (call,) = by_call.values()
    assert call["prep"].attrs["carrier"] == carrier


def test_the_track_span_records_nothing_unprofiled(no_launch):
    g.synthesize(LONG, VOICE, LANGUAGE, seed=7, device="cpu")
    assert trace.spans() == []
    assert len(papi._carrier_cache) == 1
    assert np.isfinite(next(iter(papi._carrier_cache.values()))).all()
