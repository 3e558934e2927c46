"""The reference's drift countdown in closed form (runtime/csrc/drift.cpp,
`native_drift_boundaries`) against the stepwise loop
(`native_drift_boundaries_stepwise`, native/grail_native.cpp's
gn_drift_boundaries2) and the port's numpy twin
(synth/score._reference_boundary_samples_np): the same counts, the same
residual bits and the same errors, at eight sample rates, from every float32
binade between 2·dt and 2^8 s, and on the element lengths of real texts."""

import numpy as np
import pytest
import torch

import grail_tpu_torch as g
from grail_tpu_torch import api as papi
from grail_tpu_torch.runtime import native as rnat
from grail_tpu_torch.runtime import trace
from grail_tpu_torch.synth import score as pscore
from test_torch_native import BENCH_TEXTS, LONG_EN

torch.set_num_threads(2)

SAMPLE_RATES = [8000.0, 11025.0, 16000.0, 22050.0, 32000.0, 44100.0,
                48000.0, 96000.0]


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _dt(sr):
    return np.float32(np.float32(1.0) / np.float32(sr))


def _binade(t) -> int:
    """e with 2^e <= t < 2^(e+1), for a positive normal float32 t."""
    return int((int(_bits(t)) >> 23) & 0xFF) - 127


def _tie_binade(sr) -> int:
    """The binade whose spacing u makes dt / u end in exactly .5."""
    b = int(_bits(_dt(sr)))
    sig = (b & 0x7FFFFF) | 0x800000
    trailing_zeros = (sig & -sig).bit_length() - 1
    return ((b >> 23) & 0xFF) - 127 + trailing_zeros + 1


def _all_equal(lengths, sr, t0=0.0, twin=True):
    """The closed form, the stepwise loop and (with twin) the numpy twin
    give the same counts and residual bits; returns the closed form's."""
    c, r = rnat.native_drift_boundaries(lengths, sr, t0)
    assert c.dtype == np.int64 and r.dtype == np.float32
    others = [rnat.native_drift_boundaries_stepwise(lengths, sr, t0)]
    if twin:
        others.append(pscore._reference_boundary_samples_np(lengths, sr,
                                                            t0=t0))
    for oc, orr in others:
        assert np.array_equal(c, oc)
        assert np.array_equal(_bits(r), _bits(orr))
    return c, r


def _same_error(lengths, sr, t0=0.0):
    """Both native forms raise the same ValueError; returns its text."""
    with pytest.raises(ValueError) as closed:
        rnat.native_drift_boundaries(lengths, sr, t0)
    with pytest.raises(ValueError) as stepwise:
        rnat.native_drift_boundaries_stepwise(lengths, sr, t0)
    assert str(closed.value) == str(stepwise.value)
    return str(closed.value)


@pytest.mark.parametrize("sr", SAMPLE_RATES)
def test_random_elements(sr):
    """Seeded trials: t0 from -dt to 5e-4, zero lengths and whole multiples
    of dt among the lengths."""
    rng = np.random.default_rng(int(sr))
    dt = _dt(sr)
    for trial in range(60):
        E = int(rng.integers(1, 12))
        lengths = (rng.choice([0.5, 0.25, 0.0571, 0.012, 0.0001, 0.9999,
                               1.7, 0.03, 0.0], size=E)
                   * rng.uniform(0.5, 1.5)).astype(np.float32)
        whole = rng.random(E) < 0.25
        lengths[whole] = (rng.integers(0, 20000, whole.sum()) * dt).astype(
            np.float32)
        t0 = float(np.float32(rng.uniform(-float(dt), 5e-4)))
        _all_equal(lengths, sr, t0)


@pytest.mark.parametrize("sr", SAMPLE_RATES)
def test_every_binade(sr):
    """One element whose countdown starts in each binade from below 2·dt up
    to 2^8 s, three starts a binade, and in the tie binade starts with an
    odd significand (the step that fixes the tie's parity)."""
    rng = np.random.default_rng(1000 + int(sr))
    dt = _dt(sr)
    low, tie = _binade(dt), _tie_binade(sr)
    assert 2.0 ** low < 2 * dt and low <= tie < 8
    reached = set()
    for e in range(low, 8):
        for _ in range(3):
            L = np.float32(np.float32(2.0 ** e * rng.uniform(1.05, 1.95))
                           + dt)
            start = np.float32(np.float32(-dt) + L)   # the entry step
            assert _binade(start) == e
            reached.add(e)
            _all_equal(np.float32([L]), sr, twin=e < 5)
    assert reached == set(range(low, 8)) and tie in reached
    # from t0 = 0, or from the binade above, the tie binade is entered at
    # an even significand; a residual t0 carried in reaches the odd ones
    odd = 0
    for _ in range(200):
        t0 = np.float32(rng.uniform(0.0, float(dt)))
        L = np.float32(2.0 ** tie * rng.uniform(1.0, 2.0))
        start = np.float32(np.float32(t0 - dt) + L)
        if _binade(start) == tie and int(_bits(start)) & 1:
            _all_equal(np.float32([L, L]), sr, float(t0))
            odd += 1
    assert odd >= 8


@pytest.mark.parametrize("sr", SAMPLE_RATES)
def test_long_elements_and_the_stall(sr):
    """Elements up to the stall count alike; past it both forms refuse the
    same element with the same message."""
    done = []
    for L in (10.0, 100.0, 250.0, 300.0, 600.0, 1200.0, 5000.0):
        lengths = np.float32([0.1, L, 0.2])
        try:
            rnat.native_drift_boundaries_stepwise(lengths, sr)
        except ValueError:
            msg = _same_error(lengths, sr)
            assert f"element length {L:.1f}s stalls" in msg
            continue
        _all_equal(lengths, sr, twin=L <= 100.0)
        done.append(L)
    assert 100.0 in done and 5000.0 not in done
    # the first binade whose spacing exceeds 2·dt stalls from above its
    # lowest value; from exactly that value the first step falls into the
    # finer binade below, and the countdown goes on
    dt = _dt(sr)
    low = np.float32(2.0 ** next(e for e in range(30) if 2.0 ** (e - 24) > dt))
    _all_equal(np.float32([low, 0.1]), sr, float(dt), twin=False)
    _same_error(np.float32([np.nextafter(low, np.float32(np.inf)), 0.1]), sr,
                float(dt))


def test_errors_and_odd_inputs():
    for sr in (8000.0, 44100.0, 96000.0):
        # NaN: the element's index
        assert "(element 1)" in _same_error(np.float32([0.1, np.nan, 0.2]),
                                            sr)
        # +inf stalls at once; -inf and negative lengths count one sample
        # each and carry their residual on
        assert "element length infs stalls" in _same_error(
            np.float32([0.1, 0.2, np.inf]), sr)
        for lengths in ([0.1, -np.inf, 0.2], [0.1, -0.05, 0.3, -1.0, 0.02],
                        [-1e-3, 0.0, 0.0, 1e-3]):
            _all_equal(np.float32(lengths), sr, twin=False)
        c, r = rnat.native_drift_boundaries(np.empty(0, np.float32), sr)
        assert len(c) == 0 and len(r) == 0
        c, r = rnat.native_drift_boundaries_stepwise(np.empty(0, np.float32),
                                                     sr)
        assert len(c) == 0 and len(r) == 0


def _text_lengths(text, contour):
    v = papi._resolve_voice("plain")
    pelems = pscore.merge_glides(g.text_to_phoneme_elems(
        text, v, "english", contour=contour))
    return np.float32([pe.length for pe in pelems])


@pytest.mark.parametrize("contour", [False, True])
def test_real_texts(contour):
    """The element lengths of bench.py's batch and the long English text,
    at every rate, chained through t0 as a session's rebase does."""
    texts = [_text_lengths(t, contour) for t in BENCH_TEXTS[:16]]
    long_en = _text_lengths(LONG_EN, contour)
    for sr in SAMPLE_RATES:
        for lengths in texts:
            _all_equal(lengths, sr)
        c, r = _all_equal(long_en, sr)
        half = len(long_en) // 2
        c2, r2 = _all_equal(long_en[half:], sr, float(r[half - 1]))
        assert np.array_equal(c2 + c[half - 1], c[half:])
        assert np.array_equal(_bits(r2), _bits(r[half:]))


def test_the_tally_counts_steps_and_samples():
    """The closed form adds its explicit steps and the samples it counted
    to the innermost open span; the stepwise loop adds nothing, and with
    no span open nothing is kept."""
    lengths = _text_lengths(LONG_EN, False)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.span("outer"):
            with trace.span("inner"):
                c, _ = rnat.native_drift_boundaries(lengths, 44100.0)
                rnat.native_drift_boundaries(lengths[:3], 44100.0)
                rnat.native_drift_boundaries_stepwise(lengths, 44100.0)
    got = {s.name: s.attrs for s in trace.spans()[-2:]}
    trace.clear()
    c3, _ = rnat.native_drift_boundaries(lengths[:3], 44100.0)
    assert got["outer"] == {}
    steps, samples = got["inner"]["drift_steps"], got["inner"]["drift_samples"]
    assert samples == c[-1] + c3[-1] and c[-1] > 86 * 44100
    assert 0 < steps < 1e-2 * samples
    assert trace.spans() == []


def test_scores_and_audio_equal_the_stepwise_loop(monkeypatch):
    """synthesize_batch(device='cpu') through either form: the same
    scores bit for bit, the same audio."""
    texts = ["hi", "ea"]
    closed = [g.text_to_score(t, voice="plain", language="english")
              for t in texts]
    audio = [o.numpy() for o in g.synthesize_batch(
        texts, voice="plain", language="english", device="cpu")]
    monkeypatch.setattr(pscore, "native_drift_boundaries",
                        rnat.native_drift_boundaries_stepwise)
    stepwise = [g.text_to_score(t, voice="plain", language="english")
                for t in texts]
    audio2 = [o.numpy() for o in g.synthesize_batch(
        texts, voice="plain", language="english", device="cpu")]
    for a, b in zip(closed, stepwise):
        assert np.array_equal(_bits(a.length), _bits(b.length))
        assert np.array_equal(_bits(a.cum_length), _bits(b.cum_length))
    for a, b in zip(audio, audio2):
        assert np.array_equal(_bits(a), _bits(b))


def test_the_frontend_stage_timer(tmp_path, monkeypatch):
    """benchmarks/frontend_stages.py on one small batch of each mix: every
    stage timed, the counters read from its span."""
    import json
    from grail_tpu_torch.benchmarks import frontend_stages as fs

    monkeypatch.chdir(__import__("pathlib").Path(__file__).parents[1])
    out = tmp_path / "stages.json"
    assert fs.main(["--batches", "1", "--texts", "3", "--out",
                    str(out)]) == 0
    got = json.loads(out.read_text())
    for mix in ("sentences", "prompts"):
        row = got[mix]
        assert row["batches"] == 1 and row["texts"] == 3
        for k in ("transcribe_intonate", "drift", "drift_stepwise",
                  "retarget", "assembly", "score", "score_stepwise",
                  "frontend", "frontend_stepwise"):
            assert row[k] > 0, k
        assert 0 < row["step_share"] < 1e-2
