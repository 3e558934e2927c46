"""The port's SynthesisElem API (synth/elem.py: blend, resample,
copy_with_frequency, copy_silent, silent, indexing, batch_shape,
stack_elems) and Voice.get against grail_tpu's, bit for bit: numpy float32
in the port, eager jnp in the JAX package, one operation order."""

import numpy as np
import pytest

import jax.numpy as jnp

from grail_tpu.synth.elem import SynthesisElem as JElem
from grail_tpu.synth.elem import stack_elems as jstack_elems
from grail_tpu.text.phonemes import Phoneme as JPhoneme
from grail_tpu.voices import get_voice as jget_voice

import grail_tpu_torch as g
from grail_tpu_torch.synth.elem import SynthesisElem as PElem
from grail_tpu_torch.synth.elem import stack_elems as pstack_elems

VOICES = ["generic", "plain", "bright", "deep", "whisper"]


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b)


def _same(p, j):
    assert isinstance(p, PElem)
    for x, y in zip(p, j):
        _bits(x, y)


def _pair(seed, lead=(5,)):
    rng = np.random.default_rng(seed)
    f = [rng.random(lead).astype(np.float32) * 0.6]
    f += [(rng.random(lead + (8,)) * 0.6).astype(np.float32)
          for _ in range(6)]
    return PElem(*f), JElem(*map(jnp.asarray, f))


@pytest.mark.parametrize("alpha", [0.3, [0.0, 0.25, 0.5, 0.75, 1.0]],
                         ids=["scalar", "per-row"])
def test_blend(alpha):
    pa, ja = _pair(0)
    pb, jb = _pair(1)
    _same(pa.blend(pb, alpha), ja.blend(jb, alpha))


@pytest.mark.parametrize("rates", [(44100.0, 22050.0), (44100.0, 48000.0),
                                   (16000.0, 44100.0)])
def test_resample(rates):
    p, j = _pair(2)
    _same(p.resample(*rates), j.resample(*rates))


def test_copies_silent_indexing_and_stacking():
    p, j = _pair(3)
    _same(p.copy_with_frequency([0.1, 0.7, 0.2, 0.5, 0.3]),
          j.copy_with_frequency(jnp.asarray([0.1, 0.7, 0.2, 0.5, 0.3],
                                            jnp.float32)))
    _same(p.copy_silent(), j.copy_silent())
    for shape in ((), (3,), (2, 4)):
        _same(PElem.silent(shape), JElem.silent(shape))
    _same(p[1:3], j[1:3])
    _same(p[2], j[2])
    assert p.batch_shape == tuple(j.batch_shape) == (5,)
    assert p[2].batch_shape == ()
    _same(pstack_elems([p, p[::-1]]), jstack_elems([j, j[::-1]]))
    assert g.stack_elems is pstack_elems


@pytest.mark.parametrize("name", VOICES)
def test_voice_get(name):
    pv, jv = g.get_voice(name), jget_voice(name)
    n = 0
    for ph in JPhoneme:
        want = jv.get(ph)
        got = pv.get(g.Phoneme(int(ph)))
        assert (got is None) == (want is None), ph
        if want is not None:
            _same(got, want)
            n += 1
    assert n >= 2          # the generic voice defines two
