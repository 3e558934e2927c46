"""The port's native host tier (runtime/native.py) against the Python and
numpy versions it replaces and against grail_tpu's, bit for bit.

The port builds the host library from native/*.cpp at first use into
build/grail_tpu_torch/, and its frontend reaches three loops there:
transcription (text/transcribe.transcribe), the reference's drift
boundaries (synth/score._reference_boundary_samples) and the jitter phase
schedule (synth/schedule._simulate). grail_tpu's own library (native/) is
not built here, so grail_tpu's side runs its Python and numpy routes: an
independent reference. Everything is compared by value for integers and
phonemes and by bits for float32.
"""

import importlib
import types

import numpy as np
import pytest
import torch

import grail_tpu.api as japi
from grail_tpu import languages as jlang
from grail_tpu.runtime import stream as jstream
from grail_tpu.synth import schedule as jschedule
from grail_tpu.synth import score as jscore
from grail_tpu.text.language import Language as JLanguage
from grail_tpu.text.phonemes import Phoneme as JPhoneme

import grail_tpu_torch as g
from grail_tpu_torch import languages as plang
from grail_tpu_torch.runtime import native as rnat
from grail_tpu_torch.runtime import stream as pstream
from grail_tpu_torch.synth import schedule as pschedule
from grail_tpu_torch.synth import score as pscore
from grail_tpu_torch.text.language import Language as PLanguage
from grail_tpu_torch.text.language import TranscriptionRule
from grail_tpu_torch.text.phonemes import Phoneme as PPhoneme
from grail_tpu_torch.utils import sample_error_db
from grail_tpu_torch.voices import get_voice, voice_names

# the modules (each package's text/__init__ exports the function under the
# module's name)
jtranscribe = importlib.import_module("grail_tpu.text.transcribe")
ptranscribe = importlib.import_module("grail_tpu_torch.text.transcribe")

torch.set_num_threads(2)

LANGS = ["generic", "english", "espanol", "deutsch", "francais"]
INC = 16.0 / 44100.0
# bench.py's batch: 64 texts of 8-15 characters
BENCH_TEXTS = [("aeae" * 4)[: 8 + (i % 8)] for i in range(64)]
# benchmarks/fidelity_suite.py's long_en text (86.5 s with the stub
# intonator)
LONG_EN = ("the quick brown fox jumps over the lazy dog, while seventeen "
           "synthesizers hum along in the hall. is anyone still listening "
           "to this? the formants drift on and on.")
# the jitter rate of every preset voice, at its own rate and at 22.05 kHz
RATES = sorted({float(np.float32(v.jitter_frequency)) for v in
                (get_voice(n).resampled(sr) for n in voice_names()
                 for sr in (44100.0, 22050.0))})


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _ids(phonemes):
    return [int(p) for p in phonemes]


def _random_ascii(rng, n, size):
    """n seeded strings of 0..size printable ASCII characters, weighted
    toward letters (both cases) and spaces, punctuation and digits
    included."""
    letters = "abcdefghijklmnopqrstuvwxyz"
    alphabet = (letters * 4 + letters.upper() + "     " + ".,;:!?'-()\"0123"
                "456789\t\n#@[]")
    return ["".join(rng.choice(list(alphabet), int(rng.integers(0, size))))
            for _ in range(n)]


# ---- transcription -------------------------------------------------------

def test_native_transcriber_matches_python():
    """grail_tpu's cases (tests/test_runtime.py), against both automata."""
    cases = ["abc", "abacab", "aaa", "ae", "abuac", "abaca", "oui", "ii",
             "AeI", "zzz", "aeae", "pp a e", ""]
    pg, jg = plang.generic(), jlang.generic()
    for t in cases:
        got = _ids(rnat.native_transcribe(t, pg))
        assert got == _ids(ptranscribe.transcribe_chars(t, pg)), t
        assert got == _ids(jtranscribe.transcribe_chars(t, jg)), t
    pairs = [("a", [PPhoneme.A]), ("aa", [PPhoneme.E]),
             ("e", [PPhoneme.E])]
    pl = PLanguage.from_pairs(pairs)
    jl = JLanguage.from_pairs([(s, [JPhoneme(int(p)) for p in ps])
                               for s, ps in pairs])
    for t in ["ae", "aaa", "aae", "ea"]:
        got = _ids(rnat.native_transcribe(t, pl))
        assert got == _ids(ptranscribe.transcribe_chars(t, pl)), t
        assert got == _ids(jtranscribe.transcribe_chars(t, jl)), t


@pytest.mark.parametrize("lname", LANGS)
def test_native_transcribe_random_ascii(lname):
    pl, jl = plang.get_language(lname), jlang.get_language(lname)
    rng = np.random.default_rng(sum(map(ord, lname)))
    for t in _random_ascii(rng, 150, 60):
        got = rnat.native_transcribe(t, pl)
        assert all(isinstance(p, PPhoneme) for p in got)
        assert _ids(got) == _ids(ptranscribe.transcribe_chars(t, pl)), t
        assert _ids(got) == _ids(jtranscribe.transcribe_chars(t, jl)), t


@pytest.mark.parametrize("lname", LANGS)
@pytest.mark.parametrize("leading_silence", [True, False])
def test_transcribe_equals_grail_tpu_python_route(lname, leading_silence):
    pl, jl = plang.get_language(lname), jlang.get_language(lname)
    rng = np.random.default_rng(11)
    for t in _random_ascii(rng, 40, 80) + [LONG_EN, "Hello, World!"]:
        want = jtranscribe.transcribe(t, jl, leading_silence,
                                      prefer_native=False)
        assert _ids(ptranscribe.transcribe(t, pl, leading_silence)) == \
            _ids(want), t
        assert _ids(ptranscribe.transcribe(
            t, pl, leading_silence, prefer_native=False)) == _ids(want), t


def test_case_sensitive_language():
    pairs = [("A", [PPhoneme.A]), ("a", [PPhoneme.E]), ("ab", [PPhoneme.I]),
             ("B", [PPhoneme.O])]
    pl = PLanguage.from_pairs(pairs, case_sensitive=True)
    jl = JLanguage.from_pairs([(s, [JPhoneme(int(p)) for p in ps])
                               for s, ps in pairs], case_sensitive=True)
    for t in ["AaBb", "abAB", "aAbB ab", "BBA"]:
        got = _ids(rnat.native_transcribe(t, pl))
        assert got == _ids(ptranscribe.transcribe_chars(t, pl)), t
        assert got == _ids(jtranscribe.transcribe_chars(t, jl)), t


def test_non_ascii_text_takes_the_python_automaton(monkeypatch):
    """transcribe() guards on text.isascii(), as grail_tpu does; the native
    automaton itself skips a multi-byte character's continuation bytes, so
    it agrees on such text too (tests/test_review_fixes.py)."""
    texts = ("straße grün", "¿qué chica?", "日本語 🎵 ñ", "¿¡aä!?")
    for lname in LANGS:
        pl, jl = plang.get_language(lname), jlang.get_language(lname)
        rs = rnat.NativeRuleset(pl)
        for t in texts:
            assert _ids(rs.transcribe(t)) == _ids(
                ptranscribe.transcribe_chars(t, pl)) == _ids(
                jtranscribe.transcribe_chars(t, jl)), (lname, t)

    def refuse(*args):
        raise AssertionError("the native transcriber ran on non-ASCII text")

    monkeypatch.setattr(rnat, "native_transcribe", refuse)
    de, jde = plang.get_language("deutsch"), jlang.get_language("deutsch")
    for t in texts:
        assert _ids(ptranscribe.transcribe(t, de)) == _ids(
            jtranscribe.transcribe(t, jde, prefer_native=False))


def test_ruleset_cache_keyed_by_content():
    la = PLanguage.from_pairs([("a", [PPhoneme.A])])
    ra = rnat.native_transcribe("a", la)
    del la
    lb = PLanguage.from_pairs([("a", [PPhoneme.E])])
    rb = rnat.native_transcribe("a", lb)
    assert ra == [PPhoneme.A] and rb == [PPhoneme.E]
    # an equal ruleset in another object shares the handle
    lc = PLanguage.from_pairs([("a", [PPhoneme.E])])
    key = rnat._language_key(lb)
    assert rnat._language_key(lc) == key
    rs = rnat._ruleset_cache[key]
    rnat.native_transcribe("aa", lc)
    assert rnat._ruleset_cache[key] is rs


def test_empty_rule_string_raises():
    with pytest.raises(ValueError, match="empty"):
        PLanguage.from_pairs([("", [PPhoneme.A])])
    # around the Language's own validation, the native layer refuses it
    fake = types.SimpleNamespace(
        rules=(TranscriptionRule("", (PPhoneme.A,)),
               TranscriptionRule("b", (PPhoneme.E,))), case_sensitive=False)
    with pytest.raises(ValueError, match="empty rule string"):
        rnat.NativeRuleset(fake)


def test_dense_rules_are_not_truncated():
    """A rule emitting 9 phonemes for one character: the output buffer is
    sized by the densest rule, not by a fixed ratio."""
    P = PPhoneme
    pl = PLanguage.from_pairs([("a", [P.A, P.E, P.I, P.O, P.U] * 2 + [P.A]),
                               ("bc", [P.E] * 13), ("d", [P.O])])
    rs = rnat.NativeRuleset(pl)
    assert rs._max_ratio == 11
    text = "abcd a zz" * 50
    got = rnat.native_transcribe(text, pl)
    assert len(got) > 4 * len(text)
    assert _ids(got) == _ids(ptranscribe.transcribe_chars(text, pl))


# ---- drift boundaries ----------------------------------------------------

def test_native_drift_boundaries_bit_equal():
    """grail_tpu's 100 seeded trials (tests/test_runtime.py): counts and
    residual bits against the port's numpy twin and grail_tpu's."""
    rng = np.random.default_rng(7)
    for trial in range(100):
        E = int(rng.integers(1, 16))
        lengths = (rng.choice(
            [0.5, 0.25, 0.0571, 0.012, 0.0001, 0.9999, 1.7, 0.03], size=E)
            * rng.uniform(0.5, 1.5)).astype(np.float32)
        sr = float(rng.choice([44100.0, 22050.0, 48000.0]))
        t0 = np.float32(rng.uniform(-0.00002, 0.0005))
        a_c, a_r = rnat.native_drift_boundaries(lengths, sr, float(t0))
        assert a_c.dtype == np.int64 and a_r.dtype == np.float32
        for twin in (pscore._reference_boundary_samples_np,
                     jscore._reference_boundary_samples_np):
            b_c, b_r = twin(lengths, sr, t0=t0)
            assert np.array_equal(a_c, b_c), trial
            assert np.array_equal(_bits(a_r), _bits(b_r)), trial
        d_c, d_r = pscore._reference_boundary_samples(lengths, sr, t0=t0)
        assert np.array_equal(d_c, a_c) and np.array_equal(_bits(d_r),
                                                           _bits(a_r))


def test_native_drift_boundaries_errors_and_empty():
    c, r = rnat.native_drift_boundaries(np.empty(0, np.float32), 44100.0)
    assert len(c) == 0 and len(r) == 0
    with pytest.raises(ValueError, match="must be finite, got NaN "
                                         r"\(element 1\)"):
        rnat.native_drift_boundaries(np.float32([0.1, np.nan, 0.2]),
                                     44100.0)
    with pytest.raises(ValueError, match="finite"):
        pscore._reference_boundary_samples_np([0.1, np.nan], 44100.0)
    # past ~512 s the f32 step t - dt is a no-op at 44.1 kHz
    with pytest.raises(ValueError, match="stalls the reference's f32"):
        rnat.native_drift_boundaries(np.float32([0.1, 600.0]), 44100.0)


# ---- jitter schedule -----------------------------------------------------

@pytest.mark.parametrize("inc", RATES + [0.002])
@pytest.mark.parametrize("phase0", [0.0, 0.37, 0.9995])
def test_native_jitter_schedule_bit_equal(inc, phase0):
    """T = 70,000 steps: past the port twin's 2^16-step run (_SEG) and
    through every wrap of the rate."""
    T = 70000
    outs = [(np.zeros(T + 5, np.float32), np.zeros(T + 5, np.int32))
            for _ in range(3)]
    w = [rnat.native_jitter_schedule(np.float32(inc), np.float32(phase0),
                                     T, *outs[0]),
         pschedule._np_simulate(np.float32(inc), np.float32(phase0), T,
                                *outs[1]),
         jschedule._np_simulate(np.float32(inc), np.float32(phase0), T,
                                *outs[2])]
    assert w[0] == w[1] == w[2] and w[0] > 0
    for phi, cell in outs[1:]:
        assert np.array_equal(_bits(outs[0][0]), _bits(phi))
        assert np.array_equal(outs[0][1], cell)
    assert not outs[0][0][T:].any()              # nothing past T written


def test_native_jitter_schedule_across_a_checkpoint():
    """One call over 2^20 + 3,000 steps against the port's twin."""
    T = pschedule._CHK + 3000
    a = (np.empty(T, np.float32), np.empty(T, np.int32))
    b = (np.empty(T, np.float32), np.empty(T, np.int32))
    wa = rnat.native_jitter_schedule(np.float32(INC), np.float32(0.25), T,
                                     *a)
    wb = pschedule._np_simulate(np.float32(INC), np.float32(0.25), T, *b)
    assert wa == wb
    assert np.array_equal(_bits(a[0]), _bits(b[0]))
    assert np.array_equal(a[1], b[1])


@pytest.mark.parametrize("start,length", [
    ((1 << 20) - 5000, 70000), ((1 << 20) + 12345, 70000), (-300, 4000)],
    ids=["across-checkpoint", "past-checkpoint", "preroll"])
def test_phase_schedule_equals_grail_tpu(start, length):
    ps = pschedule.PhaseSchedule(INC)             # fresh: its own checkpoints
    js = jschedule.get_schedule(INC)
    pp, pc = ps.window(start, length)
    jp, jc = js.window(start, length)
    assert np.array_equal(_bits(pp), _bits(jp)) and np.array_equal(pc, jc)
    for k in (start + length, start + 1, (1 << 20) + 1):
        (a, ca), (b, cb) = ps.state_at(k), js.state_at(k)
        assert _bits(a) == _bits(b) and ca == cb, k


# ---- the slice -----------------------------------------------------------

def _score_bits_equal(js, ps):
    for a, b in zip(js.elem, ps.elem):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    for k in ("has_sound", "length", "blend_length", "cum_length"):
        a, b = np.asarray(getattr(js, k)), np.asarray(getattr(ps, k))
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), k


def test_bench_texts_scores_bit_equal():
    for t in BENCH_TEXTS:
        _score_bits_equal(japi.text_to_score(t), g.text_to_score(t))


@pytest.mark.parametrize("contour", [False, True], ids=["stub", "contour"])
def test_long_text_score_bit_equal(contour):
    kw = dict(voice="plain", language="english", contour=contour)
    _score_bits_equal(japi.text_to_score(LONG_EN, **kw),
                      g.text_to_score(LONG_EN, **kw))


def _boundaries_equal(js, ps):
    je, jr = js._boundaries()
    pe, pr = ps._boundaries()
    assert np.array_equal(np.asarray(je), pe)
    assert np.array_equal(_bits(jr), _bits(pr))


def test_session_boundaries_bit_equal_and_resume():
    kw = dict(voice="plain", language="english", seed=1, block=1024,
              contour=True)
    js = jstream.StreamSession(**kw)
    ps = pstream.StreamSession(device="cpu", **kw)
    for text in ("hello there. ", "how are you today? ", "fine, thanks. "):
        js.feed(text)
        ps.feed(text)
        _boundaries_equal(js, ps)                # incremental appends
    js.flush()
    ps.flush()
    js._ensure_audio_horizon(3 * 44100)
    ps._ensure_audio_horizon(3 * 44100)
    assert len(ps._elements) == len(js._elements)
    _boundaries_equal(js, ps)
    # a checkpointed session resumes bit-exactly, and after the reads (a
    # rebase carries the residual) the boundaries equal a full recompute
    ps.read(3000)
    blob = ps.save_state()
    a = ps.read(9000)
    again = pstream.StreamSession(device="cpu", **kw)
    again.load_state(blob)
    np.testing.assert_array_equal(again.read(9000), a)
    for s in (ps, again):
        endn, resid = s._boundaries()
        e2, r2 = pscore._reference_boundary_samples_np(
            [e.length for e in s._elements], s.sample_rate,
            t0=float(s._drift_t0))
        assert np.array_equal(endn, e2)
        assert np.array_equal(_bits(resid), _bits(r2))


def test_synthesize_batch_cpu_matches_jax():
    texts = ["hi", "ea"]
    out = [o.numpy() for o in g.synthesize_batch(
        texts, voice="plain", language="english", device="cpu")]
    ref = japi.synthesize_batch(texts, voice="plain", language="english",
                                backend="fused_interpret")
    assert [len(o) for o in out] == [len(r) for r in ref]
    for o, r in zip(out, ref):
        assert sample_error_db(o, np.asarray(r)) < -100
        assert np.abs(o - np.asarray(r)).max() <= 1e-5


# ---- the native route is taken, and a failed build raises ----------------

def test_frontend_runs_without_the_python_twins(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a Python or numpy twin ran")

    monkeypatch.setattr(ptranscribe, "transcribe_chars", refuse)
    monkeypatch.setattr(pscore, "_reference_boundary_samples_np", refuse)
    monkeypatch.setattr(pschedule, "_np_simulate", refuse)
    _score_bits_equal(japi.text_to_score("hello world", voice="plain",
                                         language="english"),
                      g.text_to_score("hello world", voice="plain",
                                      language="english"))
    phi, cell = pschedule.PhaseSchedule(INC).window((1 << 20) - 10, 5000)
    jphi, jcell = jschedule.get_schedule(INC).window((1 << 20) - 10, 5000)
    assert np.array_equal(_bits(phi), _bits(jphi))
    assert np.array_equal(cell, jcell)
    s = pstream.StreamSession(voice="plain", language="english", contour=True,
                              device="cpu")
    s.feed("hello there. ")
    s.flush()
    assert np.abs(s.read(4096)).max() > 0


def _broken_build(monkeypatch, tmp_path):
    """A fresh process's loader pointed at a compiler that cannot run."""
    monkeypatch.setattr(rnat, "_lib", None)
    monkeypatch.setattr(rnat, "_ruleset_cache", {})
    monkeypatch.setattr(rnat, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(rnat, "_compiler", lambda: "/nonexistent/compiler")


def test_failed_build_raises_not_falls_back(monkeypatch, tmp_path):
    _broken_build(monkeypatch, tmp_path)
    assert rnat.available() is False
    en = plang.get_language("english")
    with pytest.raises(RuntimeError, match="prefer_native=False"):
        ptranscribe.transcribe("hello", en)
    with pytest.raises(RuntimeError, match="host compiler"):
        g.text_to_score("hello")
    with pytest.raises(RuntimeError, match="host compiler"):
        pscore._reference_boundary_samples([0.1, 0.2], 44100.0)
    with pytest.raises(RuntimeError, match="host compiler"):
        pschedule.PhaseSchedule(INC).window(0, 100)
    with pytest.raises(RuntimeError, match="host compiler"):
        rnat.NativeRuleset(en)
    # the Python automaton needs no library, as the error says
    assert _ids(ptranscribe.transcribe("hello", en, prefer_native=False)) \
        == _ids(jtranscribe.transcribe("hello", jlang.get_language(
            "english"), prefer_native=False))
    assert list(tmp_path.iterdir()) == []        # no partial library left
