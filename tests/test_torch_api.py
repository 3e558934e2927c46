"""The port's slice end to end on the CPU: synthesize_batch(device="cpu")
against the JAX package's fused kernel (interpret mode) and the oracle, the
routing table, and the import boundary (the port imports no jax)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import grail_tpu.api as japi
from grail_tpu import languages
from grail_tpu.oracle import oracle_pipeline
from grail_tpu.synth.jitter import JitterLattice, build_lattice
from grail_tpu.synth.schedule import device_window
from grail_tpu.synth.score import pad_score, score_from_phoneme_elems, stack_scores
from grail_tpu.voices import get_voice
from grail_tpu.voices.preset_generic import SPEC

import grail_tpu_torch as g
from grail_tpu_torch.utils import sample_error_db, spectral_error_db

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(outs):
    return [o.numpy() for o in outs]


def _assert_matches(outs, refs):
    assert [len(o) for o in outs] == [len(r) for r in refs]
    for o, r in zip(outs, refs):
        assert sample_error_db(o, r) < -100
        assert np.abs(o - r).max() <= 1e-5


def _jax_fused(texts, voices, langs, seeds, sample_rate=None, contour=False,
               speaking_rate=1.0):
    """The JAX package's unsplit fused program, _synth_jit_batch(
    'fused_interpret'), at the batch's own width (the public API pads the
    batch to 128 lanes, which changes no lane's output)."""
    vs = [get_voice(v) for v in voices]
    if sample_rate:
        vs = [v.resampled(float(sample_rate)) for v in vs]
    sr = float(vs[0].sample_rate)
    scores = [score_from_phoneme_elems(japi.text_to_phoneme_elems(
        t, v, l, contour=contour, speaking_rate=speaking_rate), v)
        for t, v, l in zip(texts, vs, langs)]
    E = max(s.num_elems for s in scores)
    scores = [pad_score(s, E) for s in scores]
    Ns = [japi._score_num_samples(s, sr) for s in scores]
    T = japi._round_up(max(Ns), japi.BLOCK_SIZE)
    lat = JitterLattice(*(np.stack(f) for f in zip(
        *(build_lattice(sd, T, vs[0].jitter_frequency) for sd in seeds))))
    jp = (jnp.float32(vs[0].jitter_frequency),
          jnp.asarray([v.jitter_delta_frequency for v in vs], jnp.float32),
          jnp.asarray([v.jitter_delta_formant_frequency for v in vs],
                      jnp.float32),
          jnp.asarray([v.jitter_delta_amplitude for v in vs], jnp.float32))
    out = np.asarray(japi._synth_jit_batch(
        stack_scores(scores), lat, jp, jnp.float32(sr),
        device_window(vs[0].jitter_frequency, 0, T), T, "fused_interpret"))
    return [out[i, :n] for i, n in enumerate(Ns)]


@pytest.fixture(scope="module")
def slice_q32():
    return _np(g.synthesize_batch(["ae", "ea"], device="cpu"))


def test_slice_q32_matches_jax_fused(slice_q32):
    ref = japi.synthesize_batch(["ae", "ea"], backend="fused_interpret")
    _assert_matches(slice_q32, ref)


def test_slice_exact_carrier_matches_jax_kcar():
    out = _np(g.synthesize_batch(["ae", "ea"], exact_carrier="kernel",
                                 device="cpu"))
    ref = japi.synthesize_batch(["ae", "ea"], backend="fused_interpret",
                                exact_carrier="kernel")
    _assert_matches(out, ref)


def test_slice_matches_oracle(slice_q32):
    # the bounds of tests/test_pipeline.py; utterance 0 is synthesize("ae")
    gold = oracle_pipeline("ae", SPEC, languages.generic())
    assert spectral_error_db(slice_q32[0], gold) < -60
    assert sample_error_db(slice_q32[0], gold) < -55
    np.testing.assert_array_equal(
        g.synthesize("ae", device="cpu").numpy()[:4096], slice_q32[0][:4096])


def test_sample_rate_22050_matches_jax():
    out = _np(g.synthesize_batch(["ea"], sample_rate=22050, device="cpu"))
    ref = _jax_fused(["ea"], ["generic"], ["generic"], [0],
                     sample_rate=22050)
    _assert_matches(out, ref)
    assert abs(len(out[0]) / 22050 - 1.5) < 0.01      # same duration


def test_mixed_voice_language_batch_matches_jax():
    kw = dict(seeds=[0, 1], contour=True, speaking_rate=1.25)
    out = _np(g.synthesize_batch(["hello", "guten tag"],
                                 voice=["plain", "bright"],
                                 language=["english", "deutsch"],
                                 device="cpu", **kw))
    ref = _jax_fused(["hello", "guten tag"], ["plain", "bright"],
                     ["english", "deutsch"], **kw)
    _assert_matches(out, ref)


def test_route_table():
    sr = 44100.0
    long_n = int(31 * sr)
    long_t = 334 * 4096                         # round_up(long_n, 4096)
    # (implementation, carrier, S, T): the CPU route is always unsplit
    assert g.route(2, 1000, None, "cpu", sr) == ("plain", "q32", 1, 4096)
    assert g.route(2, long_n, None, "cpu", sr) == ("plain", "kcar", 1,
                                                   long_t)
    assert g.route(1, long_n, False, "cpu", sr) == ("plain", "q32", 1,
                                                    long_t)
    assert g.route(64, 1000, True, "cpu", sr) == ("plain", "kcar", 1, 4096)
    assert g.route(64, 1000, "kernel", "cpu", sr) == ("plain", "kcar", 1,
                                                      4096)
    with pytest.raises(ValueError):
        g.route(0, 1000, None, "cpu", sr)
    with pytest.raises(ValueError):
        g.route(1, 1000, "host", "cpu", sr)
    with pytest.raises(ValueError):
        g.route(1, 1000, None, "meta", sr)


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device works here")
    with pytest.raises(RuntimeError, match="CUDA"):
        g.synthesize_batch(["ae"])
    with pytest.raises(RuntimeError, match="CUDA"):
        g.route(1, 1000, None, "cuda", 44100.0)


def test_batch_argument_errors():
    assert g.synthesize_batch([], device="cpu") == []
    with pytest.raises(TypeError):
        g.synthesize_batch("ae", device="cpu")


def test_port_imports_no_jax():
    code = ("import sys, grail_tpu_torch, grail_tpu_torch.convert, "
            "grail_tpu_torch.utils, grail_tpu_torch.synth._build, "
            "grail_tpu_torch.synth.kernel, grail_tpu_torch.synth.sequencer; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'grail_tpu')); assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
