"""The port's host frontend (text, languages, voices, scores) against the
JAX package's, bit for bit: the port carries copies of these numpy modules
because the card's machine has no jax, so the copies must not drift."""

import numpy as np
import pytest
import torch

import grail_tpu.api as japi
from grail_tpu.synth import score as jscore
from grail_tpu.voices import get_voice as jget_voice
from grail_tpu.voices import voice_names as jvoice_names

import grail_tpu_torch.api as papi
from grail_tpu_torch import convert
from grail_tpu_torch.synth import score as pscore
from grail_tpu_torch.voices import get_voice as pget_voice
from grail_tpu_torch.voices import voice_names as pvoice_names

torch.set_num_threads(2)

VOICES = ["generic", "plain", "bright", "deep", "whisper"]
TEXTS = [("ae ea", "generic", "generic"),
         ("hello world, how are you?", "english", "plain"),
         ("hola, ¿qué tal? muy bien.", "espanol", "plain"),
         ("guten Tag! schöne Grüße.", "deutsch", "bright"),
         ("bonjour, ça va?", "francais", "deep")]


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b)


def _voice_equal(jv, pv):
    for a, b in zip(jv.table, pv.table):
        _bits_equal(a, b)
    _bits_equal(jv.defined, pv.defined)
    for k in ("sample_rate", "center_frequency", "jitter_frequency",
              "jitter_delta_frequency", "jitter_delta_formant_frequency",
              "jitter_delta_amplitude", "name"):
        assert getattr(jv, k) == getattr(pv, k), k


def _score_equal(js, ps):
    for a, b in zip(js.elem, ps.elem):
        _bits_equal(a, b)
    for k in ("has_sound", "length", "blend_length", "cum_length"):
        _bits_equal(getattr(js, k), getattr(ps, k))


def test_same_voice_registry():
    assert pvoice_names() == jvoice_names() == sorted(VOICES)


@pytest.mark.parametrize("name", VOICES)
def test_compiled_voice_equal(name):
    _voice_equal(jget_voice(name), pget_voice(name))


@pytest.mark.parametrize("name", VOICES)
def test_resampled_voice_equal(name):
    _voice_equal(jget_voice(name).resampled(22050.0),
                 pget_voice(name).resampled(22050.0))


def test_voice_from_numpy_equals_own_compile():
    jv = jget_voice("plain")
    v = convert.voice_from_numpy(
        [np.asarray(f) for f in jv.table], np.asarray(jv.defined),
        {k: getattr(jv, k) for k in (
            "sample_rate", "center_frequency", "jitter_frequency",
            "jitter_delta_frequency", "jitter_delta_formant_frequency",
            "jitter_delta_amplitude", "name")})
    _voice_equal(v, pget_voice("plain"))


@pytest.mark.parametrize("contour", [False, True], ids=["stub", "contour"])
@pytest.mark.parametrize("text,lang,voice", TEXTS,
                         ids=[t[1] for t in TEXTS])
def test_text_to_score_equal(text, lang, voice, contour):
    kw = dict(voice=voice, language=lang, contour=contour,
              speaking_rate=1.25 if contour else 1.0)
    jp = japi.text_to_phoneme_elems(text, **kw)
    pp = papi.text_to_phoneme_elems(text, **kw)
    assert ([(int(e.phoneme), e.length, e.blend_length, e.frequency)
             for e in jp] ==
            [(int(e.phoneme), e.length, e.blend_length, e.frequency)
             for e in pp])
    js = japi.text_to_score(text, **kw, pad_to=40)
    ps = papi.text_to_score(text, **kw, pad_to=40)
    _score_equal(js, ps)


def test_pad_stack_and_convert_scores_equal():
    js = [japi.text_to_score(t) for t in ("ae", "aeae", "e")]
    ps = [papi.text_to_score(t) for t in ("ae", "aeae", "e")]
    E = max(s.num_elems for s in js) + 2
    jb = jscore.stack_scores([jscore.pad_score(s, E) for s in js])
    pb = pscore.stack_scores([pscore.pad_score(s, E) for s in ps])
    _score_equal(jb, pb)
    cb = convert.score_from_numpy([np.asarray(f) for f in jb.elem],
                                  jb.has_sound, jb.length, jb.blend_length,
                                  jb.cum_length)
    _score_equal(cb, pb)


def test_merge_glides_equal():
    from grail_tpu.text.intonate import PhonemeElem as JPE
    from grail_tpu.text.phonemes import Phoneme as JP
    from grail_tpu_torch.text.intonate import PhonemeElem as PPE
    from grail_tpu_torch.text.phonemes import Phoneme as PP

    seq = [("A", 0.3, 0.1), ("GLIDE", 0.1, 0.0), ("E", 0.2, 0.05)]
    jm = jscore.merge_glides([JPE(JP[p], ln, bl, 0.003) for p, ln, bl in seq])
    pm = pscore.merge_glides([PPE(PP[p], ln, bl, 0.003) for p, ln, bl in seq])
    assert ([(int(e.phoneme), e.length, e.blend_length) for e in jm] ==
            [(int(e.phoneme), e.length, e.blend_length) for e in pm])
    assert len(pm) == 2


@pytest.mark.parametrize("sr", [44100.0, 22050.0])
def test_reference_boundary_samples_equal(sr):
    rng = np.random.default_rng(3)
    lengths = rng.uniform(0.0, 0.8, 40).astype(np.float32)
    lengths[5] = 0.0
    j_n, j_r = jscore._reference_boundary_samples_np(lengths, sr, t0=0.01)
    p_n, p_r = pscore._reference_boundary_samples_np(lengths, sr, t0=0.01)
    np.testing.assert_array_equal(j_n, p_n)
    _bits_equal(j_r, p_r)
    zb = np.arange(40) % 3 == 0
    _bits_equal(jscore._lengths_hitting_boundaries(j_n, sr, zero_blend=zb),
                pscore._lengths_hitting_boundaries(p_n, sr, zero_blend=zb))
