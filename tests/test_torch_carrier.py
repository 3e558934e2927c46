"""The solo long-form route's carrier plumbing on the CPU: the host track
windows, the fused plain version's 'host_track' mode against the JAX
package's fused Pallas kernel (interpret mode) with the same track, the
split and unsplit slices with a track against grail_tpu.api, the track
against the in-kernel recurrence, and the routing decision.

The track is made once by the port's native pre-pass (its library is built
at first use) and handed to both packages: the JAX package's own library is
not built here, so its text-level callers would fall to Q32.

Tolerances, each with its reason:
  * plain vs the JAX kernel, same track: < -100 dB per utterance, max-abs
    <= 1e-5, the fused tests' bounds (the same algorithm and precision;
    XLA:CPU contracts a*b+c into FMAs, the port never does).
  * split with a track vs JAX's split-fused program with the same track at
    the same S: < -110 dB, max-abs <= 1e-5, the split tests' bounds.
  * split vs unsplit with the same track: < -90 dB, max-abs < 1e-4 (each
    segment's filter state comes from a WARMUP pre-roll).
  * track vs the in-kernel recurrence: atol 5e-5 (tests/test_carrier.py):
    the pre-pass integrates the oracle's frequency chain, the kernel its
    own closed form; they agree to a few ulps, not bits.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import grail_tpu.api as japi
from grail_tpu.synth.jitter import JitterLattice, build_lattice
from grail_tpu.synth.kernel_fused import build_tables, synth_fused_pallas
from grail_tpu.synth.schedule import device_window
from grail_tpu.synth.score import stack_scores
from grail_tpu.voices import get_voice

import grail_tpu_torch as g
import grail_tpu_torch.api as papi
from grail_tpu_torch import convert
from grail_tpu_torch.oracle.native import native_carrier_phase_track
from grail_tpu_torch.synth import kernel_fused as pk
from grail_tpu_torch.utils import sample_error_db
from grail_tpu_torch.voices import get_spec

torch.set_num_threads(2)

TEXT, VOICE, LANGUAGE, SEED = "a", "generic", "generic", 0
W = papi.WARMUP


@functools.lru_cache(maxsize=None)
def _case():
    """One utterance: the JAX score and the port's from the same numpy
    leaves, and the native carrier track of the port's pre-pass."""
    jscore = japi.text_to_score(TEXT, get_voice(VOICE), LANGUAGE)
    pscore = convert.score_from_numpy(
        [np.asarray(f) for f in jscore.elem], jscore.has_sound,
        jscore.length, jscore.blend_length, jscore.cum_length)
    pelems = papi.text_to_phoneme_elems(TEXT, VOICE, LANGUAGE)
    track = native_carrier_phase_track(pelems, get_spec(VOICE), SEED)
    sr = float(get_voice(VOICE).sample_rate)
    N = japi._score_num_samples(jscore, sr)
    assert abs(len(track) - N) <= 4       # the oracle's count, near the score's
    return dict(jscore=jscore, pscore=pscore, track=track, N=N, sr=sr)


@functools.lru_cache(maxsize=None)
def _jax_unsplit():
    c = _case()
    return japi.synthesize_scores([c["jscore"]], VOICE, seeds=[SEED],
                                  backend="fused_interpret",
                                  carrier_tracks=[c["track"]])[0]


@functools.lru_cache(maxsize=None)
def _port_unsplit():
    c = _case()
    return papi.synthesize_score(c["pscore"], VOICE, seed=SEED,
                                 carrier_track=c["track"],
                                 device="cpu").numpy()


# ---- the track's windows ---------------------------------------------------

@pytest.mark.parametrize("S", [2, 4, 8])
def test_split_carrier_matches_jax(S):
    rng = np.random.default_rng(S)
    T = S * 2 * papi.BLOCK_SIZE
    track = rng.random(T - 37).astype(np.float32)     # shorter: edge-padded
    seg = papi._split_carrier(track, T, S, "cpu")
    assert seg.shape == (S, T // S + W) and seg.stride() == (T // S, 1)
    ref = np.asarray(japi._split_carrier(track, T, S))        # [Ts + W, S]
    np.testing.assert_array_equal(seg.numpy(), ref.T)


def test_split_carrier_preroll_cycle():
    """Segment 0's pre-roll is the silent warm-up's phase cycle {0, .25, .5,
    .75}, the first real sample reads track[0], and index j of row k is
    absolute sample k*Ts + j - W + 1 (tests/test_carrier.py)."""
    T, S = 8192, 4
    Ts = T // S
    track = (np.arange(T, dtype=np.float32) * np.float32(0.001)) % 1.0
    seg = papi._split_carrier(track, T, S, "cpu").numpy()
    expect_pre = (np.arange(W) % 4).astype(np.float32) * 0.25
    np.testing.assert_array_equal(seg[0, :W], expect_pre)
    assert seg[0, W] == track[0]
    full = np.concatenate([expect_pre, track])
    for k in range(1, S):
        np.testing.assert_array_equal(seg[k], full[k * Ts: k * Ts + Ts + W])


def test_track_padding_and_length_check():
    t = np.linspace(0, 0.9, 100, dtype=np.float32)
    p = papi._pad_track(t, 128, "cpu").numpy()
    np.testing.assert_array_equal(p[:100], t)
    assert (p[100:] == t[-1]).all()
    assert (papi._pad_track(np.zeros(0, np.float32), 8, "cpu") == 0).all()
    with pytest.raises(ValueError, match="exceeds"):
        papi._pad_track(np.zeros(129, np.float32), 128, "cpu")
    with pytest.raises(ValueError, match="exceeds"):
        papi._split_carrier(np.zeros(8193, np.float32), 8192, 2, "cpu")


# ---- the plain version's host_track mode against the JAX kernel ------------

def test_plain_host_track_matches_jax_kernel():
    c = _case()
    sr, T = c["sr"], 16384         # the first 16,384 samples: sound by then
    v = get_voice(VOICE)
    inc = v.jitter_frequency
    lat = JitterLattice(*(np.asarray(f)[None]
                          for f in build_lattice(SEED, T, inc)))
    jp = tuple(jnp.float32(x) for x in (
        inc, v.jitter_delta_frequency, v.jitter_delta_formant_frequency,
        v.jitter_delta_amplitude))
    batched = stack_scores([c["jscore"]])
    phi, cell = device_window(inc, 0, T)
    car = np.asarray(japi._pad_track(c["track"][:T], T))
    ja, jst, _ = synth_fused_pallas(
        build_tables(batched, lat, jp, jnp.float32(sr)), T,
        sched=(phi[:, None], cell[:, None]), carrier=jnp.asarray(car)[:, None],
        interpret=True)
    pscore = convert.score_from_numpy(
        [np.asarray(f) for f in batched.elem], batched.has_sound,
        batched.length, batched.blend_length, batched.cum_length)
    ptables = pk.build_tables(pscore, convert.lattice_from_numpy(*lat),
                              tuple(np.asarray(x) for x in jp), sr)
    psched = convert.schedule_from_numpy(np.asarray(phi), np.asarray(cell))
    np.testing.assert_array_equal(
        papi._pad_track(c["track"][:T], T, "cpu").numpy(), car)
    pa, pst = pk.synth_fused(ptables, T, "plain", sched=psched,
                             carrier=torch.from_numpy(car.copy()))
    ja, pa = np.asarray(ja).T, pa.numpy()
    assert pa.shape == ja.shape
    assert np.abs(ja).max() > 0.01
    assert sample_error_db(pa[0], ja[0]) < -100
    assert np.abs(pa - ja).max() <= 1e-5
    np.testing.assert_array_equal(pst.seed.numpy(),
                                  np.asarray(jst.seed).astype(np.int64))
    # the carried phases pass through: the track replaces both accumulators
    assert float(pst.phase[0]) == 0.0

    # the track is read, not dropped: another track gives other samples
    Tc = 8192
    sched_c = (psched[0][:Tc], psched[1][:Tc])
    other = torch.from_numpy(((car[:Tc] + np.float32(0.25)) % 1.0)
                             .astype(np.float32))
    shifted, _ = pk.synth_fused(ptables, Tc, "plain", sched=sched_c,
                                carrier=other)
    assert np.abs(shifted.numpy() - pa[:, :Tc]).max() > 1e-3


def test_track_excludes_kcar_and_carry():
    t = pk.build_tables(convert.score_from_numpy(*_stacked()), _lattice(),
                        (0.0004, 0.0, 0.0, 0.0), 44100.0)
    sf = torch.zeros(1, 24)
    phi, cell = torch.zeros(128), torch.zeros(128, dtype=torch.int32)
    car = torch.zeros(128)
    with pytest.raises(ValueError, match="carrier track"):
        pk.synth_fused_reference(t, phi, cell, sf,
                                 torch.zeros(1, 3, dtype=torch.int32), 128,
                                 True, carrier=car)
    with pytest.raises(ValueError, match="carrier track"):
        pk.synth_fused_reference(t, None, None, sf,
                                 torch.zeros(1, 5, dtype=torch.int32), 128,
                                 False, inc=0.0004, carrier=car)
    with pytest.raises(ValueError, match="carrier track"):
        pk.synth_fused(t, 128, "plain", sched=(phi, cell),
                       exact_carrier=True, carrier=car)
    # the kernel's wrapper refuses before it looks for a card
    with pytest.raises(ValueError, match="carrier track"):
        pk.fused_synth_cuda(t, phi, cell, sf,
                            torch.zeros(1, 3, dtype=torch.int32), 128, True,
                            carrier=car)


def _stacked():
    s = stack_scores([_case()["jscore"]])
    return ([np.asarray(f) for f in s.elem], s.has_sound, s.length,
            s.blend_length, s.cum_length)


def _lattice():
    return convert.lattice_from_numpy(
        *(np.asarray(f)[None] for f in build_lattice(0, 4096, 0.0004)))


# ---- the slice as a whole ----------------------------------------------------

def test_unsplit_with_track_matches_jax():
    c = _case()
    ref, out = _jax_unsplit(), _port_unsplit()
    assert out.shape == ref.shape == (c["N"],)
    assert sample_error_db(out, ref) < -100
    assert np.abs(out - ref).max() <= 1e-5


@pytest.mark.parametrize("S", [2, 4])
def test_split_with_track_matches_jax(S):
    c = _case()
    out = papi._synthesize_split([c["pscore"]], VOICE, [SEED], S=S,
                                 device="cpu",
                                 carrier_tracks=[c["track"]])[0].numpy()
    assert out.shape == (c["N"],)
    # JAX's split-fused program at the same S, the same track
    v = get_voice(VOICE)
    T = japi._round_up(c["N"], S * japi.BLOCK_SIZE)
    inc = v.jitter_frequency
    lat = JitterLattice(*(np.asarray(f)[None]
                          for f in build_lattice(SEED, T, inc)))
    jp = tuple(jnp.float32(x) for x in (
        inc, v.jitter_delta_frequency, v.jitter_delta_formant_frequency,
        v.jitter_delta_amplitude))
    pre, seg, shift = japi._split_sched(inc, T, S)
    ref = np.asarray(japi._synth_jit_split_fused(
        stack_scores([c["jscore"]]), lat, jp, jnp.float32(c["sr"]), pre, seg,
        shift, T, S, interpret=True,
        car_seg=japi._split_carrier(c["track"], T, S)))[0, :c["N"]]
    assert sample_error_db(out, ref) < -110
    assert np.abs(out - ref).max() <= 1e-5
    # and grail_tpu.api.synthesize_scores with the same track (unsplit
    # there): the split's own bounds
    uns = _jax_unsplit()
    assert sample_error_db(out, uns) < -90
    assert np.abs(out - uns).max() < 1e-4


def test_split_with_track_launches_no_pre_pass(monkeypatch):
    c = _case()

    def no_pre_pass(*a, **k):
        raise AssertionError("the track route must not run the Q32 pre-pass")

    monkeypatch.setattr(papi, "phase_q32_pre_block", no_pre_pass)
    out = papi._synthesize_split([c["pscore"]], VOICE, [SEED], S=2,
                                 device="cpu", carrier_tracks=[c["track"]])
    assert torch.isfinite(out[0]).all()
    with pytest.raises(AssertionError, match="pre-pass"):
        papi._synthesize_split([c["pscore"]], VOICE, [SEED], S=2,
                               device="cpu")


def test_track_matches_in_kernel_recurrence():
    c = _case()
    kcar = papi.synthesize_scores([c["pscore"]], VOICE, seeds=[SEED],
                                  exact_carrier="kernel",
                                  device="cpu")[0].numpy()
    np.testing.assert_allclose(_port_unsplit(), kcar, atol=5e-5, rtol=0)
    # text level: True takes the track ('kernel' the recurrence: see
    # test_auto_gate_takes_the_track_past_30_seconds)
    a = g.synthesize(TEXT, VOICE, LANGUAGE, seed=SEED, exact_carrier=True,
                     device="cpu").numpy()
    np.testing.assert_array_equal(a, _port_unsplit())


def test_tracks_apply_to_one_fused_utterance_only(monkeypatch):
    c = _case()
    ran = []

    def stub_run(self, impl, carrier, S, T, dev, backend="fused", track=None):
        ran.append((self.B, backend, carrier, track is not None))
        return [None] * self.B

    monkeypatch.setattr(papi._Batch, "run", stub_run)
    kw = dict(device="cpu")
    papi.synthesize_scores([c["pscore"]], VOICE, carrier_tracks=[c["track"]],
                           **kw)
    papi.synthesize_scores([c["pscore"]] * 2, VOICE,
                           carrier_tracks=[c["track"]] * 2, **kw)
    papi.synthesize_scores([c["pscore"]], VOICE, backend="core",
                           carrier_tracks=[c["track"]], **kw)
    papi.synthesize_scores([c["pscore"]], VOICE, carrier_tracks=[None], **kw)
    assert ran == [(1, "fused", "track", True), (2, "fused", "q32", False),
                   (1, "core", "q32", False), (1, "fused", "q32", False)]
    with pytest.raises(ValueError, match="carrier tracks"):
        papi.synthesize_scores([c["pscore"]], VOICE,
                               carrier_tracks=[c["track"]] * 2, **kw)
    # a sample rate other than the voice's runs on xla when no backend is
    # named, as in grail_tpu, and reads the track there; a fused backend
    # named raises
    papi.synthesize_score(c["pscore"], VOICE, sample_rate=22050,
                          device="cpu", carrier_track=c["track"])
    assert ran[-1] == (1, "xla", "track", True)
    with pytest.raises(ValueError, match="sample_rate"):
        papi.synthesize_score(c["pscore"], VOICE, sample_rate=22050,
                              device="cpu", backend="fused")


# ---- routing -----------------------------------------------------------------

_SR = 44100.0
_LONG = int(31 * _SR)
_LONG_T = 334 * 4096


@pytest.mark.parametrize("exact,B,n,track,expect", [
    # one utterance, a track in hand: the track, whatever exact_carrier says
    (None, 1, _LONG, True, ("track", _LONG_T)),
    (None, 1, 1000, True, ("track", 4096)),
    (True, 1, 1000, True, ("track", 4096)),
    (False, 1, 1000, True, ("track", 4096)),
    # one utterance, no track (a voice without a spec, or 'kernel')
    (None, 1, _LONG, False, ("kcar", _LONG_T)),
    (None, 1, 1000, False, ("q32", 4096)),
    (True, 1, 1000, False, ("kcar", 4096)),
    ("kernel", 1, 1000, False, ("kcar", 4096)),
    (False, 1, _LONG, False, ("q32", _LONG_T)),
    # a batch never reads a track
    (None, 3, _LONG, True, ("kcar", _LONG_T)),
    (True, 3, 1000, True, ("kcar", 4096)),
    ("kernel", 3, 1000, True, ("kcar", 4096)),
    (False, 3, 1000, True, ("q32", 4096)),
    (None, 3, 1000, False, ("q32", 4096)),
])
def test_route_carrier_table(exact, B, n, track, expect):
    impl, carrier, S, T = papi.route(B, n, exact, "cpu", _SR, track=track)
    assert (impl, carrier, S, T) == ("plain", expect[0], 1, expect[1])


def test_route_core_backend_ignores_a_track():
    assert papi.route(1, 1000, None, "cpu", _SR, "core",
                      track=True) == ("plain", "q32", 1, 4096)
    with pytest.raises(ValueError, match="fused backend"):
        papi.route(1, 1000, True, "cpu", _SR, "core", track=True)


def test_spec_lookup():
    v = g.get_voice("plain")
    assert papi._spec_for_voice(v) is get_spec("plain")
    r = papi._spec_for_voice(v.resampled(22050.0))
    assert r.sample_rate == 22050.0 and r.name == "plain"
    import dataclasses
    assert papi._spec_for_voice(dataclasses.replace(v, name="mine")) is None


def test_auto_gate_takes_the_track_past_30_seconds(monkeypatch):
    """exact_carrier=None: an utterance just past EXACT_CARRIER_AUTO_SECONDS
    runs the pre-pass and routes 'track'; a short one does neither; a voice
    without a registered spec routes 'kcar'. The synthesizer itself is
    stubbed: 31 s of the plain version is minutes of CPU."""
    calls, routed = [], []
    real_track_for = papi._carrier_track_for

    def spy(pelems, v, seed):
        calls.append(sum(p.length for p in pelems))
        return real_track_for(pelems, v, seed)

    class Stop(Exception):
        pass

    def stub_run(self, impl, carrier, S, T, dev, backend="fused", track=None):
        routed.append((carrier, S, None if track is None else len(track)))
        raise Stop

    monkeypatch.setattr(papi, "_carrier_track_for", spy)
    monkeypatch.setattr(papi._Batch, "run", stub_run)
    with pytest.raises(Stop):
        g.synthesize("aeae", "plain", "english", device="cpu")
    assert calls == [] and routed == [("q32", 1, None)]

    long_text = "a" * 62                     # 62 phonemes of 0.5 s
    pel = papi.text_to_phoneme_elems(long_text, "plain", "english")
    assert 30.0 < sum(p.length for p in pel) < 33.0
    with pytest.raises(Stop):
        g.synthesize(long_text, "plain", "english", device="cpu")
    assert len(calls) == 1 and routed[-1][0] == "track"
    assert abs(routed[-1][2] - calls[0] * _SR) < 200
    with pytest.raises(Stop):                # memoized: same track object
        g.synthesize_batch([long_text], "plain", "english", device="cpu")
    assert routed[-1] == routed[-2]

    import dataclasses
    unregistered = dataclasses.replace(g.get_voice("plain"), name="mine")
    with pytest.raises(Stop):
        g.synthesize(long_text, unregistered, "english", device="cpu")
    assert routed[-1] == ("kcar", 1, None)
    with pytest.raises(Stop):                # 'kernel' pins the recurrence
        g.synthesize(long_text, "plain", "english", exact_carrier="kernel",
                     device="cpu")
    assert routed[-1] == ("kcar", 1, None) and len(calls) == 3
