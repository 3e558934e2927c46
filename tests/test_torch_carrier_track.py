"""The solo long-form route's host pre-pass, native_carrier_track
(runtime/native.py; runtime/csrc/carrier_track.cpp: the frequency chain
alone), held bit for bit against the oracle's track,
oracle/native.native_carrier_phase_track (native/grail_oracle.cpp: the whole
oracle chain without its filter), which is written apart from it, and on one
short text against the plain numpy version, carrier_phase_track_reference.

Every comparison is of the same length and of the float32 bits
(`view(np.uint32)`): texts of bench.py's batch and the 86.5-s long_en text
over several seeds, LJSpeech-length sentences from the benchmark's
generator, hand-made element sequences for the sequencer's corners (a zero
crossfade, one that reads 0 / 0, absent elements first, last and back to
back, an element of length 0), and a voice at other sample rates. Then: the
same ValueError on a non-finite length, the same audio from `synthesize` on
either track, the `track_chain_samples` count on the `track` span, and
benchmarks/carrier_track.py on two sentences.
"""

import dataclasses

import numpy as np
import pytest
import torch

import grail_tpu_torch as g
from grail_tpu_torch import api as papi
from grail_tpu_torch.oracle import native as onat
from grail_tpu_torch.runtime import native as rnat
from grail_tpu_torch.runtime import trace
from grail_tpu_torch.text.intonate import PhonemeElem
from grail_tpu_torch.text.phonemes import Phoneme
from grail_tpu_torch.voices import get_spec
from portbench.traffic import generator

torch.set_num_threads(2)

VOICE, LANGUAGE = "plain", "english"
# bench.py's batch: 64 texts of 8-15 characters
BENCH_TEXTS = [("aeae" * 4)[: 8 + (i % 8)] for i in range(64)]
# benchmarks/fidelity_suite.py's long_en text (86.5 s with the stub
# intonator)
LONG_EN = ("the quick brown fox jumps over the lazy dog, while seventeen "
           "synthesizers hum along in the hall. is anyone still listening "
           "to this? the formants drift on and on.")
# 12 words: ~36 s of audio, past EXACT_CARRIER_AUTO_SECONDS
LONG = "the quick brown fox jumps over the lazy dog by the old river."
SEEDS = [0, 7, 2 ** 31 - 5, 2 ** 32 - 1]


def _spec(sample_rate=None):
    spec = get_spec(VOICE)
    if sample_rate is not None:
        spec = dataclasses.replace(spec, sample_rate=float(sample_rate))
    return spec


def _pelems(text, sample_rate=None):
    v = papi._resolve_voice(VOICE)
    if sample_rate is not None:
        v = v.resampled(float(sample_rate))
    return papi.text_to_phoneme_elems(text, v, LANGUAGE)


def _same(pelems, spec, seed):
    """The port's track and the oracle's: same length, same bits."""
    ours = rnat.native_carrier_track(pelems, spec, seed)
    theirs = onat.native_carrier_phase_track(pelems, spec, seed)
    assert ours.dtype == np.float32 and ours.shape == theirs.shape
    np.testing.assert_array_equal(ours.view(np.uint32),
                                  theirs.view(np.uint32))
    return ours


@pytest.mark.parametrize("seed", SEEDS)
def test_bench_texts(seed):
    spec = _spec()
    for i, text in enumerate(BENCH_TEXTS):
        _same(_pelems(text), spec, seed + i)


@pytest.mark.parametrize("seed", SEEDS)
def test_long_en(seed):
    track = _same(_pelems(LONG_EN), _spec(), seed)
    assert len(track) > 86 * 44100


@pytest.mark.parametrize("gen_seed", [4111222333, 12345])
def test_ljspeech_length_sentences(gen_seed):
    (texts,) = generator.batches(generator.load_mix("sentences"), gen_seed, 1)
    by_words = sorted(texts, key=lambda t: len(t.split()))
    # the shortest, the quartiles, the longest
    picks = [by_words[i] for i in (0, 16, 32, 48, 63)]
    spec = _spec()
    for i, text in enumerate(picks):
        _same(_pelems(text), spec, gen_seed + i)


_FREQS = iter(np.linspace(0.002, 0.006, 64).tolist())


def _pe(name, length, blend, frequency=None):
    """A PhonemeElem; each gets a pitch of its own unless one is given, so
    that taking one element's frequency for another's shows."""
    if frequency is None:
        frequency = next(_FREQS)
    return PhonemeElem(Phoneme[name], length, blend, frequency)


CORNERS = {
    # a zero crossfade: alpha_of reads time / 0
    "zero blend": [_pe("A", 0.2, 0.05), _pe("E", 0.25, 0.0),
                   _pe("O", 0.2, 0.0), _pe("M", 0.1, 0.05)],
    "absent first": [_pe("SILENCE", 0.3, 0.05), _pe("A", 0.2, 0.05),
                     _pe("E", 0.2, 0.05)],
    "absent last": [_pe("A", 0.2, 0.05), _pe("E", 0.2, 0.05),
                    _pe("STOP", 0.3, 0.05)],
    "absent back to back": [_pe("A", 0.2, 0.05), _pe("SILENCE", 0.1, 0.05),
                            _pe("STOP", 0.1, 0.02), _pe("SILENCE", 0.1, 0.0),
                            _pe("E", 0.2, 0.05)],
    "only absent": [_pe("SILENCE", 0.2, 0.05), _pe("STOP", 0.1, 0.05)],
    "length 0": [_pe("A", 0.2, 0.05), _pe("E", 0.0, 0.05),
                 _pe("O", 0.2, 0.05), _pe("SILENCE", 0.0, 0.05),
                 _pe("U", 0.1, 0.05)],
    "length 0 and blend 0": [_pe("A", 0.2, 0.05), _pe("E", 0.0, 0.0),
                             _pe("O", 0.2, 0.05)],
    "glides merged": [_pe("A", 0.2, 0.05), _pe("GLIDE", 0.1, 0.05),
                      _pe("E", 0.2, 0.05)],
    "frequency above one half": [_pe("A", 0.1, 0.05, 0.7),
                                 _pe("E", 0.1, 0.05, 0.2)],
    "one element": [_pe("A", 0.05, 0.01)],
    "no element": [],
}


@pytest.mark.parametrize("case", list(CORNERS))
def test_sequencer_corners(case):
    for seed in (0, 99):
        _same(CORNERS[case], _spec(), seed)


def test_zero_blend_at_time_zero():
    """At 32,768 Hz dt = 2^-15 is exact, so an element of 0.25 s counts its
    time down to exactly 0 and its crossfade reads 0 / 0: fminf's NaN first
    operand, which must give 1, not NaN."""
    pelems = [_pe("A", 0.25, 0.0), _pe("E", 0.25, 0.0), _pe("O", 0.1, 0.05)]
    track = _same(pelems, _spec(32768.0), 5)
    assert np.isfinite(track).all()


@pytest.mark.parametrize("sample_rate", [22050.0, 16000.0])
def test_resampled_voice(sample_rate):
    spec = _spec(sample_rate)
    for seed in (0, 7):
        track = _same(_pelems(LONG, sample_rate), spec, seed)
        assert abs(len(track) / sample_rate - len(
            _same(_pelems(LONG), _spec(), seed)) / 44100.0) < 0.01


def test_the_plain_numpy_version():
    pelems, spec = _pelems("hello"), _spec()
    ours = rnat.native_carrier_track(pelems, spec, 3)
    ref = onat.carrier_phase_track_reference(pelems, spec, 3)
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(ours.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("bad", [float("inf"), float("-inf"), float("nan")])
def test_a_non_finite_length_raises_the_same_error(bad):
    pelems = [_pe("A", 0.2, 0.05), _pe("E", bad, 0.05), _pe("O", 0.2, 0.05)]
    with pytest.raises(ValueError) as theirs:
        onat.native_carrier_phase_track(pelems, _spec(), 0)
    with pytest.raises(ValueError) as ours:
        rnat.native_carrier_track(pelems, _spec(), 0)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("text,kw", [
    (LONG, dict(backend="xla")),            # past 30 s: the auto route
    ("ae", dict(exact_carrier=True)),       # the fused backend's
])
def test_synthesize_gives_the_same_audio(text, kw, monkeypatch):
    def run():
        papi._carrier_cache.clear()
        return g.synthesize(text, VOICE, LANGUAGE, seed=11, device="cpu",
                            **kw).numpy()

    ours = run()
    monkeypatch.setattr(papi, "native_carrier_track",
                        onat.native_carrier_phase_track)
    theirs = run()
    papi._carrier_cache.clear()
    assert ours.shape == theirs.shape
    np.testing.assert_array_equal(ours.view(np.uint32),
                                  theirs.view(np.uint32))


@pytest.fixture
def no_launch(monkeypatch):
    """synth_fused answers zeros of the shape it would return (the spans
    alone are read)."""
    def stub(tables, T, impl, **kw):
        return torch.zeros(tables.n.shape[0], T), None

    monkeypatch.setattr(papi, "synth_fused", stub)
    trace.clear()
    papi._carrier_cache.clear()
    yield
    trace.clear()
    papi._carrier_cache.clear()


def test_the_track_span_counts_the_chain_samples(no_launch):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(2):
            g.synthesize(LONG, VOICE, LANGUAGE, seed=7, device="cpu")
    tracks = [s for s in trace.spans() if s.name == "track"]
    assert len(tracks) == 2
    miss, hit = (t.attrs for t in tracks)
    assert miss["hit"] is False and hit["hit"] is True
    assert miss["track_chain_samples"] == miss["samples"] > 30 * 44100
    assert "track_chain_samples" not in hit


def test_nothing_is_counted_unprofiled(no_launch):
    track = rnat.native_carrier_track(_pelems("hello"), _spec(), 0)
    assert len(track) > 0 and trace.spans() == []


def test_the_host_microbenchmark(tmp_path, monkeypatch):
    """benchmarks/carrier_track.py on two sentences: both tracks timed and
    compared, every stage read."""
    import json
    from pathlib import Path

    from grail_tpu_torch.benchmarks import carrier_track as ct

    monkeypatch.chdir(Path(__file__).parents[1])
    out = tmp_path / "track.json"
    assert ct.main(["--texts", "2", "--repeats", "1", "--out",
                    str(out)]) == 0
    got = json.loads(out.read_text())
    assert got["texts"] == 2 and len(got["per_text"]) == 2
    assert got["samples"] > 30 * 44100
    for k in ct.STAGES:
        assert got[f"{k}_ms"] > 0 and got[f"{k}_ns_per_sample"] > 0, k
    assert got["select_ms"] < got["port_ms"]
