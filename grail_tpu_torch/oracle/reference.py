"""Sequential NumPy oracle: the behavioral golden for every fast path.

The copy of grail_tpu/oracle/reference.py (numpy only; tests/
test_torch_oracle.py holds it bit for bit against the original). It is a
*sample-exact* float32 port of grail-rs's six-stage pipeline, kept deliberately
sequential and structured like the original iterators so it can be verified
against the Rust source line-by-line:

  stage         reference location
  transcriber   src/lib.rs:1098-1207  (shared with text/transcribe.py)
  intonator     src/lib.rs:1047-1089  (stub: 0.5s/0.5s/center frequency)
  selector      src/lib.rs:978-1022
  sequencer     src/lib.rs:838-953
  jitter        src/lib.rs:723-805
  synthesize    src/lib.rs:467-600    (the per-sample hot loop)

Every arithmetic op is done in float32 in the reference's operation order, so
modulo FMA-fusion differences this reproduces the Rust output bit-for-bit.
It is SLOW (pure Python per sample) — test inputs stay short.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from ..core.approx import np_exp_approx, np_tan_approx
from ..core.constants import DEFAULT_SAMPLE_RATE, LEHMER_A, NUM_FORMANTS
from ..text.intonate import PhonemeElem
from ..text.phonemes import Phoneme, is_sound
from ..voices.voice import VoiceSpec

F32 = np.float32
_ONE = F32(1.0)


def _rust_min(x: np.float32, y: np.float32) -> np.float32:
    """Rust f32::min: returns the OTHER operand when one is NaN (IEEE-754
    minNum), unlike Python's min (propagates a NaN first argument). The
    zero-blend corner relies on this: alpha = (0.0/0.0).min(1.0) = 1.0 in
    the reference (src/lib.rs:899), i.e. an exact-grid boundary hit still
    HOLDS the current element."""
    if np.isnan(x):
        return F32(y)
    if np.isnan(y):
        return F32(x)
    return F32(min(x, y))


def _alpha(time: np.float32, blend_length: np.float32) -> np.float32:
    """(time / blend_length).min(1.0) with Rust min semantics; division by
    zero intentionally produces inf/NaN exactly as the reference does."""
    with np.errstate(divide="ignore", invalid="ignore"):
        q = F32(time / blend_length)
    return _rust_min(q, _ONE)
_HALF = F32(0.5)


def _lehmer_next(state: int) -> int:
    return (state * LEHMER_A + 1) & 0xFFFFFFFF


def _state_to_f32(state: int) -> np.float32:
    bits = np.uint32((state >> 9) | 0x3F800000)
    return F32((bits.view(np.float32) - F32(1.5)) * F32(2.0))


class _Rng:
    """Mutable Lehmer RNG (reference random_f32, src/lib.rs:36-55)."""

    def __init__(self, state: int):
        self.state = int(state) & 0xFFFFFFFF

    def next_f32(self) -> np.float32:
        self.state = _lehmer_next(self.state)
        return _state_to_f32(self.state)

    def next_array(self) -> np.ndarray:
        return np.array([self.next_f32() for _ in range(NUM_FORMANTS)], F32)


# ---------------------------------------------------------------------------
# SynthesisElem (numpy)
# ---------------------------------------------------------------------------

@dataclass
class NpElem:
    frequency: np.float32
    formant_freq: np.ndarray
    formant_bw: np.ndarray
    formant_smooth: np.ndarray
    formant_breath: np.ndarray
    formant_turb: np.ndarray
    formant_amp: np.ndarray

    def copy(self) -> "NpElem":
        return NpElem(F32(self.frequency), *(a.copy() for a in (
            self.formant_freq, self.formant_bw, self.formant_smooth,
            self.formant_breath, self.formant_turb, self.formant_amp)))

    def blend(self, other: "NpElem", alpha: np.float32) -> "NpElem":
        a = F32(alpha)
        ia = F32(_ONE - a)

        def lerp(x, y):
            return (x * ia + y * a).astype(F32)

        return NpElem(
            frequency=F32(self.frequency * ia + other.frequency * a),
            formant_freq=lerp(self.formant_freq, other.formant_freq),
            formant_bw=lerp(self.formant_bw, other.formant_bw),
            formant_smooth=lerp(self.formant_smooth, other.formant_smooth),
            formant_breath=lerp(self.formant_breath, other.formant_breath),
            formant_turb=lerp(self.formant_turb, other.formant_turb),
            formant_amp=lerp(self.formant_amp, other.formant_amp),
        )

    def resample(self, old_sr: float, new_sr: float) -> "NpElem":
        scale = F32(F32(old_sr) / F32(new_sr))
        scaled_ff = (self.formant_freq * scale).astype(F32)
        return NpElem(
            frequency=F32(min(F32(self.frequency * scale), _HALF)),
            formant_freq=np.minimum(scaled_ff, _HALF).astype(F32),
            formant_bw=(self.formant_bw * scale).astype(F32),
            formant_smooth=(self.formant_smooth * scale).astype(F32),
            formant_breath=self.formant_breath.copy(),
            formant_turb=self.formant_turb.copy(),
            formant_amp=np.where(scaled_ff > _HALF, F32(0.0), self.formant_amp).astype(F32),
        )

    def copy_with_frequency(self, frequency: np.float32) -> "NpElem":
        e = self.copy()
        e.frequency = F32(min(F32(frequency), _HALF))
        return e

    def copy_silent(self) -> "NpElem":
        e = self.copy()
        e.formant_amp = np.zeros(NUM_FORMANTS, F32)
        return e

    @staticmethod
    def silent() -> "NpElem":
        q = np.full(NUM_FORMANTS, 0.25, F32)
        z = np.zeros(NUM_FORMANTS, F32)
        return NpElem(F32(0.25), q.copy(), q.copy(), q.copy(), z.copy(), z.copy(), z.copy())

    @staticmethod
    def new_phoneme(freq, bw, smooth, turb, breath, amp) -> "NpElem":
        """MKPHON semantics: unit-gain normalize then Hz -> normalized."""
        amp = np.asarray(amp, F32)
        # Rust's iter().sum() is a sequential left fold in f32
        s = F32(0.0)
        for v in amp:
            s = F32(s + v)
        amp = (amp / s).astype(F32)
        e = NpElem(
            frequency=F32(0.0),
            formant_freq=np.asarray(freq, F32),
            formant_bw=np.asarray(bw, F32),
            formant_smooth=np.asarray(smooth, F32),
            formant_breath=np.asarray(breath, F32),
            formant_turb=np.asarray(turb, F32),
            formant_amp=amp,
        )
        return e.resample(1.0, DEFAULT_SAMPLE_RATE)


# ---------------------------------------------------------------------------
# Oracle voice
# ---------------------------------------------------------------------------

@dataclass
class NpVoice:
    sample_rate: np.float32
    phonemes: dict  # Phoneme -> NpElem
    center_frequency: np.float32
    jitter_frequency: np.float32
    jitter_delta_frequency: np.float32
    jitter_delta_formant_frequency: np.float32
    jitter_delta_amplitude: np.float32

    def get(self, p: Phoneme) -> Optional[NpElem]:
        if not is_sound(p):
            return None
        return self.phonemes.get(Phoneme(int(p)))

    @staticmethod
    def from_spec(spec: VoiceSpec) -> "NpVoice":
        sr = F32(spec.sample_rate)

        def build(ph):
            e = NpElem.new_phoneme(ph.freq, ph.bw, ph.smooth, ph.turb,
                                   ph.breath, ph.amp)
            if float(spec.sample_rate) != 44100.0:
                # mirror compile_voice: new_phoneme normalizes to the
                # DEFAULT rate; non-default voices retarget their tables
                # (without this, a 22050 Hz voice's oracle would render
                # every formant at half frequency)
                e = e.resample(F32(44100.0), sr)
            return e

        return NpVoice(
            sample_rate=sr,
            phonemes={Phoneme[name]: build(ph)
                      for name, ph in spec.phonemes.items()},
            center_frequency=F32(F32(spec.center_frequency_hz) / sr),
            jitter_frequency=F32(F32(spec.jitter_frequency_hz) / sr),
            jitter_delta_frequency=F32(F32(spec.jitter_delta_frequency_hz) / sr),
            jitter_delta_formant_frequency=F32(F32(spec.jitter_delta_formant_frequency_hz) / sr),
            jitter_delta_amplitude=F32(spec.jitter_delta_amplitude),
        )


# ---------------------------------------------------------------------------
# Stage ports
# ---------------------------------------------------------------------------

@dataclass
class NpSequenceElem:
    """Reference SequenceElem (src/lib.rs:813-835)."""

    elem: Optional[NpElem]
    length: np.float32
    blend_length: np.float32


def oracle_intonate(phonemes: Sequence[Phoneme], voice: NpVoice) -> List[PhonemeElem]:
    """Reference stub intonator (src/lib.rs:1057-1075)."""
    return [PhonemeElem(p, 0.5, 0.5, float(voice.center_frequency)) for p in phonemes]


def oracle_select(phoneme_elems: Sequence[PhonemeElem], voice: NpVoice) -> List[NpSequenceElem]:
    """Reference Selector (src/lib.rs:987-1006)."""
    out = []
    for pe in phoneme_elems:
        elem = voice.get(pe.phoneme)
        if elem is not None:
            elem = elem.copy_with_frequency(F32(pe.frequency))
        out.append(NpSequenceElem(elem, F32(pe.length), F32(pe.blend_length)))
    return out


def oracle_sequence(seq: Sequence[NpSequenceElem], sample_rate: float):
    """Reference Sequencer state machine (src/lib.rs:856-932). Yields NpElem."""
    it = iter(seq)

    def nxt():
        try:
            return next(it)
        except StopIteration:
            return None

    cur_elem: Optional[NpSequenceElem] = None
    next_elem: Optional[NpSequenceElem] = None
    time = F32(0.0)
    delta_time = F32(_ONE / F32(sample_rate))

    while True:
        time = F32(time - delta_time)
        if time < 0.0:
            if cur_elem is not None and next_elem is not None:
                cur_elem = next_elem
                next_elem = nxt()
                time = F32(time + cur_elem.length)
            elif cur_elem is None and next_elem is None:
                cur_elem = nxt()
                next_elem = nxt()
                if cur_elem is not None:
                    time = F32(time + cur_elem.length)
            else:
                return

        a = cur_elem
        b = cur_elem.elem if cur_elem is not None else None
        c = next_elem.elem if next_elem is not None else None

        if a is not None and b is not None and c is not None:
            alpha = _alpha(time, a.blend_length)
            yield c.blend(b, alpha)
        elif a is not None and b is not None:
            alpha = _alpha(time, a.blend_length)
            yield b.copy_silent().blend(b, alpha)
        elif a is not None and c is not None:
            alpha = _alpha(time, a.blend_length)
            yield c.blend(c.copy_silent(), alpha)
        elif a is not None:
            yield NpElem.silent()
        else:
            return


def oracle_sequence_exact(seq: Sequence[NpSequenceElem], sample_rate: float):
    """The reference Sequencer state machine with a DRIFT-FREE time
    accumulator. The reference's `time -= 1/sr` f32 countdown accumulates
    ~1e-5 s of rounding drift, which shifts element boundaries by +-1 sample
    and the crossfade ramp sub-sample-ly; this twin recomputes
    `time = C_j - k/sr` fresh each sample from exact integer element
    boundaries (n_j = floor(C_j * sr)) — the same convention the vectorized
    closed form uses (synth/sequencer.py). The 4-case blend yields are the
    ORIGINAL oracle code, so equality against expand_score pins the fast
    path exactly: for scores without zero-length elements, its only
    deviation from oracle_sequence is the countdown drift.

    Zero-length caveat: the reference advances at most one element per
    emitted sample, so a zero-length SequenceElem still occupies one
    sample; this twin (like expand_score's duplicate-boundary skip) emits
    nothing for it. No frontend produces interior zero-length elements
    (intonator lengths are bounded below); zero-length rows exist only as
    trailing score padding, where both conventions agree.
    """
    elems = list(seq)
    if not elems:
        return
    E = len(elems)
    C = np.cumsum(np.asarray([e.length for e in elems], F32), dtype=F32)
    n = np.floor(C * F32(sample_rate)).astype(np.int64)
    dt = F32(F32(1.0) / F32(sample_rate))

    j = 0
    for k1 in range(1, int(n[-1]) + 1):
        while n[j] < k1:  # advance past expired (and zero-length) elements
            j += 1
        a = elems[j]
        b = a.elem
        c = elems[j + 1].elem if j + 1 < E else None
        time = F32(C[j] - F32(F32(k1) * dt))

        if b is not None and c is not None:
            alpha = _alpha(time, a.blend_length)
            yield c.blend(b, alpha)
        elif b is not None:
            alpha = _alpha(time, a.blend_length)
            yield b.copy_silent().blend(b, alpha)
        elif c is not None:
            alpha = _alpha(time, a.blend_length)
            yield c.blend(c.copy_silent(), alpha)
        else:
            yield NpElem.silent()


class _ValueNoise:
    """Reference ValueNoise (src/lib.rs:218-256)."""

    def __init__(self, rng: _Rng):
        self.current = rng.next_f32()
        self.next_v = rng.next_f32()
        self.phase = F32(0.0)
        self.rng = _Rng(rng.state)

    def next(self, increment: np.float32) -> np.float32:
        self.phase = F32(self.phase + increment)
        if self.phase > 1.0:
            self.phase = F32(self.phase - _ONE)
            self.current = self.next_v
            self.next_v = self.rng.next_f32()
        return F32(self.current * F32(_ONE - self.phase) + self.next_v * self.phase)


class _ArrayValueNoise:
    """Reference ArrayValueNoise (src/lib.rs:261-307). Note the interleaved
    construction order: current[i], next[i] per formant."""

    def __init__(self, rng: _Rng):
        current = np.zeros(NUM_FORMANTS, F32)
        next_v = np.zeros(NUM_FORMANTS, F32)
        for i in range(NUM_FORMANTS):
            current[i] = rng.next_f32()
            next_v[i] = rng.next_f32()
        self.current = current
        self.next_v = next_v
        self.phase = F32(0.0)
        self.rng = _Rng(rng.state)

    def next(self, increment: np.float32) -> np.ndarray:
        self.phase = F32(self.phase + increment)
        if self.phase > 1.0:
            self.phase = F32(self.phase - _ONE)
            self.current = self.next_v
            self.next_v = self.rng.next_array()
        return (self.current * F32(_ONE - self.phase) + self.next_v * self.phase).astype(F32)


def oracle_jitter(elems, seed: int, voice: NpVoice):
    """Reference Jitter stage (src/lib.rs:750-798). Yields NpElem."""
    rng = _Rng(seed)
    freq_noise = _ValueNoise(rng)
    formant_freq_noise = _ArrayValueNoise(rng)
    formant_amp_noise = _ArrayValueNoise(rng)
    frequency = voice.jitter_frequency
    delta_frequency = voice.jitter_delta_frequency
    delta_formant_freq = voice.jitter_delta_formant_frequency
    delta_amplitude = voice.jitter_delta_amplitude

    for elem in elems:
        e = elem.copy()
        freq = freq_noise.next(frequency)
        formant_freq = formant_freq_noise.next(frequency)
        formant_amp = formant_amp_noise.next(frequency)

        e.frequency = F32(e.frequency + F32(freq * delta_frequency))
        e.formant_freq = (e.formant_freq + formant_freq * F32(delta_formant_freq)).astype(F32)

        formant_amp_delta = ((formant_amp + _ONE) * F32(_HALF * delta_amplitude)).astype(F32)
        formant_amp_mul = (_ONE - formant_amp_delta).astype(F32)
        e.formant_amp = (e.formant_amp * formant_amp_mul).astype(F32)
        yield e


def oracle_jitter_exact(elems, seed: int, voice: NpVoice):
    """The reference Jitter stage with a DRIFT-FREE value-noise phase.

    HISTORICAL twin: places sample k (1-based) in cell i = floor(k * inc)
    with fraction phi = k*inc - i — the closed-form schedule production
    used through round 3 — while drawing lattice points through the
    ORIGINAL generator state machines. Production now consumes the exact
    f32 phase recurrence (synth/schedule.py) and is pinned against
    oracle_jitter directly (tests/test_stages.py); this twin remains as
    the reference point for the drift the closed form accumulates
    (-47 dB at 86.5 s, VERDICT r3).
    """
    rng = _Rng(seed)
    gens = (_ValueNoise(rng), _ArrayValueNoise(rng), _ArrayValueNoise(rng))
    inc = F32(voice.jitter_frequency)
    delta_frequency = voice.jitter_delta_frequency
    delta_formant_freq = voice.jitter_delta_formant_frequency
    delta_amplitude = voice.jitter_delta_amplitude

    cell = 0
    k = 0
    for elem in elems:
        k += 1
        ph = F32(F32(k) * inc)
        i = int(np.floor(ph))
        phi = F32(ph - F32(i))
        while cell < i:  # advance the lattice like the reference wrap does
            for g in gens:
                g.current = g.next_v
                g.next_v = (g.rng.next_f32() if isinstance(g, _ValueNoise)
                            else g.rng.next_array())
            cell += 1
        freq_n = F32(gens[0].current * F32(_ONE - phi) + gens[0].next_v * phi)
        form_n = (gens[1].current * F32(_ONE - phi)
                  + gens[1].next_v * phi).astype(F32)
        amp_n = (gens[2].current * F32(_ONE - phi)
                 + gens[2].next_v * phi).astype(F32)

        e = elem.copy()
        e.frequency = F32(e.frequency + F32(freq_n * delta_frequency))
        e.formant_freq = (e.formant_freq
                          + form_n * F32(delta_formant_freq)).astype(F32)
        amp_delta = ((amp_n + _ONE) * F32(_HALF * delta_amplitude)).astype(F32)
        e.formant_amp = (e.formant_amp * (_ONE - amp_delta)).astype(F32)
        yield e


def oracle_synthesize(elems) -> np.ndarray:
    """Reference synthesis hot loop (src/lib.rs:497-578), seed=0 (:594)."""
    phase = F32(0.0)
    state_a = np.zeros(NUM_FORMANTS, F32)
    state_b = np.zeros(NUM_FORMANTS, F32)
    state_c = np.zeros(NUM_FORMANTS, F32)
    rng = _Rng(0)
    out = []

    for elem in elems:
        f = elem.frequency
        if phase < f:
            t = F32(phase / f)
            polyblep = F32(F32(F32(2.0) * t) - F32(t * t) - _ONE)
        elif phase > F32(_ONE - f):
            t = F32(F32(phase - _ONE) / f)
            polyblep = F32(F32(t * t) + F32(F32(2.0) * t) + _ONE)
        else:
            polyblep = F32(0.0)

        saw = np.full(NUM_FORMANTS, F32(F32(F32(2.0) * phase - _ONE) - polyblep), F32)

        phase = F32(phase + f)
        if phase >= 1.0:
            phase = F32(phase - _ONE)

        noise = np.full(NUM_FORMANTS, rng.next_f32(), F32)

        breath = elem.formant_breath
        noise_wave = (saw * (_ONE - breath) + noise * breath).astype(F32)

        alpha = np_exp_approx(elem.formant_smooth)
        state_a = (state_a + (_ONE - alpha) * (noise_wave - state_a)).astype(F32)
        glottal_wave = state_a

        turb = elem.formant_turb
        turbulence_wave = (glottal_wave * (_ONE * (_ONE - turb) + noise * turb)).astype(F32)

        v0 = (turbulence_wave * elem.formant_amp).astype(F32)

        g = np_tan_approx(elem.formant_freq)
        k = (elem.formant_bw / elem.formant_freq).astype(F32)
        a1 = (_ONE / (_ONE + g * (g + k))).astype(F32)
        a2 = (g * a1).astype(F32)
        a3 = (g * a2).astype(F32)

        v3 = (v0 - state_c).astype(F32)
        v1 = (a1 * state_b + a2 * v3).astype(F32)
        v2 = (state_c + a2 * state_b + a3 * v3).astype(F32)

        state_b = (F32(2.0) * v1 - state_b).astype(F32)
        state_c = (F32(2.0) * v2 - state_c).astype(F32)

        s = F32(0.0)
        for v in v1:
            s = F32(s + v)
        out.append(F32(s * _HALF))

    return np.array(out, F32)


def oracle_dsp_chain(pelems, spec: VoiceSpec, jitter_seed: int = 0) -> np.ndarray:
    """Reference DSP chain downstream of intonation: timed PhonemeElems ->
    samples (select -> sequence -> jitter -> synthesize, the chain of
    examples/cli.rs:175-184 below the intonator).

    Taking PhonemeElems directly lets the fidelity harness gate frontends
    the reference never implemented — the contour intonator's prosody
    (README.md:15) — against the reference's DSP semantics. GLIDE markers
    go through the same frontend merge as the fast path
    (synth/score.py:merge_glides): the merge is frontend preprocessing."""
    from ..synth.score import merge_glides

    voice = NpVoice.from_spec(spec)
    seq = oracle_select(merge_glides(list(pelems)), voice)
    stream = oracle_sequence(seq, float(voice.sample_rate))
    jittered = oracle_jitter(stream, jitter_seed, voice)
    return oracle_synthesize(jittered)


def oracle_pipeline(text: str, spec: VoiceSpec, language, jitter_seed: int = 0,
                    leading_silence: bool = True) -> np.ndarray:
    """Full text -> samples chain matching examples/cli.rs:175-184."""
    from ..text.transcribe import transcribe

    voice = NpVoice.from_spec(spec)
    phonemes = transcribe(text, language, leading_silence=leading_silence)
    return oracle_dsp_chain(oracle_intonate(phonemes, voice), spec,
                            jitter_seed=jitter_seed)


__all__ = [
    "NpElem", "NpVoice", "NpSequenceElem",
    "oracle_intonate", "oracle_select", "oracle_sequence",
    "oracle_jitter", "oracle_synthesize", "oracle_dsp_chain",
    "oracle_pipeline",
]
