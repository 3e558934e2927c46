"""The port's oracle (grail_tpu_torch/oracle/) and host library against the
JAX package's oracle, and the native twins against their plain versions.

Everything here is bit for bit: the port's reference.py is a copy of
grail_tpu's (numpy float32, the same operation order); the C++ twin and the
carrier pre-pass round every f32 operation on its own (-ffp-contract=off),
as numpy does. The host library is built by the port at first use into
build/grail_tpu_torch/; the JAX package's own library (native/) is not built
here and nothing of this file needs it.
"""

import numpy as np
import pytest

from grail_tpu import languages as jlang
from grail_tpu.oracle import reference as jref
from grail_tpu.text.intonate import PhonemeElem as JPhonemeElem
from grail_tpu.text.phonemes import Phoneme as JPhoneme
from grail_tpu.voices.preset_generic import SPEC as JSPEC

import grail_tpu_torch as g
from grail_tpu_torch import languages as plang
from grail_tpu_torch.api import text_to_phoneme_elems
from grail_tpu_torch.oracle import native as pnat
from grail_tpu_torch.oracle import reference as pref
from grail_tpu_torch.runtime import native as rnat
from grail_tpu_torch.runtime.wav import encode_wav
from grail_tpu_torch.synth._build import BUILD_DIR
from grail_tpu_torch.voices import get_spec
from grail_tpu_torch.voices.preset_generic import SPEC as PSPEC

# short but structurally varied (tests/test_carrier.py): leading silence,
# two vowels with distinct frequencies, interior silence, tail vowel
_ELEMS = [("SILENCE", 0.1, 0.02, 1.0), ("A", 0.2, 0.05, 1.1),
          ("E", 0.15, 0.08, 0.9), ("SILENCE", 0.08, 0.02, 1.0),
          ("O", 0.18, 0.06, 1.05)]


def _pelems(PE, P):
    f0 = 120.0 / 44100.0
    return [PE(P[name], ln, bl, f0 * k) for name, ln, bl, k in _ELEMS]


def _bits_equal(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.uint32),
                                                 b.view(np.uint32))


@pytest.fixture(scope="module")
def port_chain():
    """The port's numpy oracle on the ~0.7 s element list, computed once."""
    return pref.oracle_dsp_chain(_pelems(g.PhonemeElem, g.Phoneme), PSPEC,
                                 jitter_seed=3)


def test_reference_dsp_chain_matches_jax_package(port_chain):
    gold = jref.oracle_dsp_chain(_pelems(JPhonemeElem, JPhoneme), JSPEC,
                                 jitter_seed=3)
    assert len(gold) > 30000 and _bits_equal(port_chain, gold)


def test_reference_pipeline_matches_jax_package():
    a = pref.oracle_pipeline("a", PSPEC, plang.generic(), jitter_seed=1,
                             leading_silence=False)
    b = jref.oracle_pipeline("a", JSPEC, jlang.generic(), jitter_seed=1,
                             leading_silence=False)
    assert len(b) > 1000 and _bits_equal(a, b)


def test_native_twin_matches_numpy_oracle(port_chain):
    pel = _pelems(g.PhonemeElem, g.Phoneme)
    out = pnat.native_oracle_dsp_chain(pel, PSPEC, jitter_seed=3)
    assert _bits_equal(out, port_chain)
    assert _bits_equal(pnat.gold_dsp_chain(pel, PSPEC, jitter_seed=3), out)


@pytest.mark.parametrize("voice,language,text,seed", [
    ("generic", "generic", None, 0),          # the element list above
    ("plain", "english", "hi", 7),            # a real language, contour
])
def test_native_track_matches_plain_track(voice, language, text, seed):
    pel = (_pelems(g.PhonemeElem, g.Phoneme) if text is None else
           text_to_phoneme_elems(text, voice, language, contour=True))
    spec = get_spec(voice)
    track = pnat.native_carrier_phase_track(pel, spec, jitter_seed=seed)
    plain = pnat.carrier_phase_track_reference(pel, spec, jitter_seed=seed)
    assert len(track) > 10000 and _bits_equal(track, plain)
    assert track[0] == 0.0 and (track >= 0).all() and (track < 1).all()
    # the track has the oracle's own sample count
    assert len(track) == len(pnat.native_oracle_dsp_chain(pel, spec, seed))


def test_native_track_rejects_non_finite_length():
    pel = [g.PhonemeElem(g.Phoneme.A, float("nan"), 0.05, 0.003)]
    with pytest.raises(ValueError, match="non-finite"):
        pnat.native_carrier_phase_track(pel, PSPEC)


def test_library_builds_into_the_build_directory(tmp_path):
    lib = rnat.load_library()
    built = rnat.build()
    assert built.parent == BUILD_DIR and built.exists()
    assert built.name.startswith("libgrail_native_")
    assert lib.gn_carrier_phase_track is not None
    # a second build directory gets its own copy, under the same name
    again = rnat.build(tmp_path)
    assert again.parent == tmp_path and again.name == built.name
    assert again.exists()
    # nothing is built into native/: the JAX package would load it
    assert not (rnat.NATIVE_DIR / "libgrail_native.so").exists()


@pytest.mark.parametrize("cxx", ["/nonexistent/compiler", "false"])
def test_broken_compiler_raises(tmp_path, monkeypatch, cxx):
    monkeypatch.setenv("CXX", cxx)
    with pytest.raises(RuntimeError, match="host"):
        rnat.build(tmp_path)
    assert list(tmp_path.iterdir()) == []      # no partial library is left


def test_native_wav_encoder_matches_python():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(3000) * 0.6).astype(np.float32)
    x[:4] = [np.nan, 2.0, -2.0, 0.0]
    assert rnat.native_encode_wav(x, 22050) == encode_wav(x, 22050)
