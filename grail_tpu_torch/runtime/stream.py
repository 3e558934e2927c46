"""Streaming synthesis: StreamSession and the StreamPool server.

Counterpart of grail_tpu/runtime/stream.py. The reference's streaming
example (examples/interactive.rs) wires stdin chars into the lazy pipeline
and lets the audio callback pull samples; idle input injects ' ', which
transcribes to Silence, so the stream never starves. Here the same contract
is block-structured: `feed(text)` runs the host frontend incrementally and
appends timed elements to a rolling score; a read synthesizes the next
block with all DSP state carried across calls (carrier phase, filter
states, Lehmer seed, the jitter phase and its lattice window).

The device program is a tick, one of two with one signature and one
carried state (the packed rows `sf`/`si` of the fused kernel's carry mode),
both with the exact f32 carrier: every lane steps the jitter recurrence
from its carried (phase, absolute cell) and reads its sliding lattice window
at row `cell - lat_base`.

  * the carry tick (`_tick`): one launch of the fused synthesizer in its
    'carry' mode (synth/kernel_fused.py; the CUDA kernel on a card, its
    plain PyTorch version on the CPU); blocks that are multiples of 128;
  * the xla tick (`_xla_tick`, grail_tpu's _stream_block_batch and, for a
    solo session, _stream_block): the jitter and carrier recurrences in the
    kernel synth/csrc/seq_scan.cu (their plain versions on the CPU), the
    sequencer, the jitter and the associative-scan core
    (synth/synthesize._block_core) in plain PyTorch. Any block; a pool
    with backend='xla', or a block that is not a multiple of 128, runs it.

  * `StreamSession` — one session: the host frontend (commands, rolling
    score, rebase, idle horizon, lattice window slides), a solo `read`
    (one-lane tick) and `save_state`/`load_state`.
  * `StreamPool` — N sessions, one launch per tick for all of them. Scores,
    lattices, offsets and the carried state stay on the device; a feed or a
    slide scatters the changed sessions' rows in place, and a steady-state
    tick copies nothing from the host to the device.
  * Serve mode (`StreamPool.serve_start` / `serve_tick` / `serve_stop`):
    a frontend thread runs the host pass and publishes table sets; the
    real-time thread's tick is one replay of a CUDA graph captured for the
    adopted set (on the CPU, the same tick run eagerly).

  * A mesh (`StreamPool(..., mesh=parallel.make_mesh(n_data, n_seq))`):
    sessions shard over the mesh's 'data' axis, one process per rank
    (torch.distributed, SPMD). Each rank runs the host pass and the carry
    tick (parallel.sharded_stream_tick_fn) over the sessions it owns and
    reads back its own rows; the tick has no collective. save() gathers
    the sessions' payloads over the mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import threading
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..api import _resolve_device
from ..core.constants import NUM_FORMANTS
from ..languages import get_language
from ..synth import kernel_fused as kf
from ..synth.elem import SynthesisElem
from ..synth.jitter import JitterLattice, apply_jitter
from ..synth.score import (Score, _reference_boundary_samples,
                           merge_glides, score_from_phoneme_elems,
                           stack_scores)
from ..synth.seq_scan import carrier_scan, jsched_scan
from ..synth.sequencer import expand_score
from ..synth.synthesize import SynthState, _block_core
from ..text.intonate import PhonemeElem, intonate
from ..text.phonemes import Phoneme
from ..text.transcribe import transcribe_chars, transcribe_partial
from ..voices import Voice, get_voice
from .trace import annotate, span, stage, tally

class _IncrementalLattice:
    """Value-noise lattices grown on demand (unbounded sessions), with a
    SLIDING window: cells the stream has passed are dropped (see
    StreamSession._maybe_rebase_jitter), so long-running sessions hold a
    bounded window instead of an ever-growing array.

    Holds the three Lehmer continuation states exactly as the reference's
    noise generators do (synth/jitter.py has the layout); after drop(K) the
    arrays hold cells [K, K+len) of the absolute stream and ensure() keeps
    appending the SAME draws the never-dropped stream would contain.
    `version` keys upload caches (content changes only on append/drop)."""

    def __init__(self, seed: int):
        from ..core.rng import NpLehmer

        rng = NpLehmer(seed)
        p0, p1 = rng.next_f32(), rng.next_f32()
        self._pitch_state = NpLehmer(rng.state)
        f = np.zeros((2, NUM_FORMANTS), np.float32)
        for j in range(NUM_FORMANTS):
            f[0, j] = rng.next_f32()
            f[1, j] = rng.next_f32()
        self._formant_state = NpLehmer(rng.state)
        a = np.zeros((2, NUM_FORMANTS), np.float32)
        for j in range(NUM_FORMANTS):
            a[0, j] = rng.next_f32()
            a[1, j] = rng.next_f32()
        self._amp_state = NpLehmer(rng.state)

        self.pitch = np.array([p0, p1], np.float32)
        self.formant = f
        self.amp = a
        self.version = 0

    def ensure(self, cells: int) -> None:
        from ..core.rng import lehmer_states, np_random_f32_from_state

        grew = False
        k = cells - len(self.pitch)
        if k > 0:
            states = lehmer_states(self._pitch_state.state, k)
            self.pitch = np.concatenate(
                [self.pitch, np_random_f32_from_state(states)])
            self._pitch_state.state = int(states[-1])
            grew = True
        for name, st in (("formant", self._formant_state),
                         ("amp", self._amp_state)):
            arr = getattr(self, name)
            k = cells - len(arr)
            if k > 0:
                states = lehmer_states(st.state, k * NUM_FORMANTS)
                rows = np_random_f32_from_state(states).reshape(
                    k, NUM_FORMANTS)
                setattr(self, name, np.vstack([arr, rows]))
                st.state = int(states[-1])
                grew = True
        if grew:
            self.version += 1

    def drop(self, k: int) -> None:
        """Slide the window: discard the first k cells (already passed)."""
        if k <= 0:
            return
        self.pitch = self.pitch[k:]
        self.formant = self.formant[k:]
        self.amp = self.amp[k:]
        self.version += 1

    def rows(self, cells: int) -> JitterLattice:
        """The window's first `cells` rows (ensure(cells) first)."""
        return JitterLattice(self.pitch[:cells], self.formant[:cells],
                             self.amp[:cells])


STREAM_COMMANDS = ("pitch", "rate", "voice", "lang")


def _parse_commands(text: str, partial: bool = False):
    """Split text into ('text', str) and (command, value) chunks.

    Grammar (the reference's planned parser stage, src/lib.rs:1366,
    README.md:19):

        command  := '[' key ':' value ']'     key in STREAM_COMMANDS
        literal  := '[['  (a literal '[')  |  ']]'  (a literal ']')

    Malformed input is a loud ValueError — an unterminated '[', a bracket
    body without ':', or an unknown key (silently speaking a mistyped
    command as text hides the mistake from the author).

    With partial=True (the incremental feed() path) returns (chunks, tail):
    a trailing fragment that could still become valid with more input — an
    unterminated '[...' command, a lone final '[' (possible '[[' half), or a
    lone final ']' (possible ']]' half) — is held back as `tail` instead of
    raising/emitting, so commands may arrive split across feed() chunk
    boundaries."""
    out = []
    buf = []
    i = 0
    n = len(text)
    while i < n:
        c = text[i]
        if c == "[":
            if i + 1 == n and partial:      # could become '[[' next chunk
                return (out + ([("text", "".join(buf))] if buf else []),
                        text[i:])
            if text[i + 1:i + 2] == "[":
                buf.append("[")
                i += 2
                continue
            k = text.find("]", i)
            if k < 0:
                if partial:                 # command may terminate later
                    return (out + ([("text", "".join(buf))] if buf else []),
                            text[i:])
                raise ValueError(
                    f"unterminated command bracket at {text[i:i + 20]!r} "
                    "(use '[[' for a literal '[')")
            body = text[i + 1:k]
            if ":" not in body:
                raise ValueError(
                    f"malformed command {('[' + body + ']')!r}: expected "
                    "[key:value] (use '[[' for a literal '[')")
            key, val = body.split(":", 1)
            if key not in STREAM_COMMANDS:
                raise ValueError(
                    f"unknown stream command {key!r} "
                    f"(known: {', '.join(STREAM_COMMANDS)})")
            if buf:
                out.append(("text", "".join(buf)))
                buf = []
            out.append((key, val.strip()))
            i = k + 1
        elif c == "]" and text[i + 1:i + 2] == "]":
            buf.append("]")
            i += 2
        elif c == "]" and i + 1 == n and partial:  # possible ']]' half
            return (out + ([("text", "".join(buf))] if buf else []),
                    text[i:])
        else:
            buf.append(c)
            i += 1
    if buf:
        out.append(("text", "".join(buf)))
    return (out, "") if partial else out


def _bucket(n: int) -> int:
    b = 16
    while b < n:
        b *= 2
    return b


# ---------------------------------------------------------------------------
# Output formats
# ---------------------------------------------------------------------------

def _pcm16_body(audio: torch.Tensor) -> torch.Tensor:
    """f32 [-1, 1] -> int16 PCM with the WAV encoder's Rust `as i16`
    semantics: scale, saturate, NaN -> 0, truncate toward zero. Half the
    device->host audio bytes of f32."""
    x = (audio * 32767.0).clamp(-32768.0, 32767.0)
    x = torch.where(torch.isnan(x), 0.0, x)
    return x.to(torch.int16)


def _ulaw_body(audio: torch.Tensor) -> torch.Tensor:
    """f32 [-1, 1] -> G.711 mu-law (uint8), the telephony serving format:
    a quarter of f32's device->host bytes. Standard encoder: BIAS = 0x84,
    clip 32635, 8 exponent segments, inverted output bits. The exponent is
    an integer comparison ladder, never a float log2."""
    pcm = _pcm16_body(audio).to(torch.int32)
    sign = torch.where(pcm < 0, 0x80, 0).to(torch.int32)
    m = pcm.abs().clamp(max=32635) + 0x84
    e = torch.zeros_like(m)
    for k in range(7):
        e = e + (m >= (1 << (k + 8))).to(torch.int32)
    mant = torch.bitwise_right_shift(m, e + 3) & 0xF
    return (~(sign | (e << 4) | mant) & 0xFF).to(torch.uint8)


def ulaw_decode(code: np.ndarray) -> np.ndarray:
    """G.711 mu-law uint8 -> int16 PCM (host-side decoder for sinks and
    tests)."""
    c = (~np.asarray(code, np.uint8).astype(np.int32)) & 0xFF
    sign = c & 0x80
    e = (c >> 4) & 0x7
    mant = c & 0xF
    m = ((mant << 3) + 0x84) << e
    m = m - 0x84
    return np.where(sign != 0, -m, m).astype(np.int16)


_OUTPUTS = {"f32": None, "pcm16": _pcm16_body, "ulaw": _ulaw_body}


# ---------------------------------------------------------------------------
# Carried state and the tick
# ---------------------------------------------------------------------------

class HostState(NamedTuple):
    """One session's carried DSP state on the host, in grail_tpu's
    checkpoint layout: phase f32 (), lp/fb/fc f32 [8], seed uint32 ()."""

    phase: np.ndarray
    lp: np.ndarray
    fb: np.ndarray
    fc: np.ndarray
    seed: np.ndarray


def _host_state(sf: np.ndarray, si: np.ndarray) -> HostState:
    """One lane's kernel rows (sf [24], si [>= 3]) -> HostState."""
    F = NUM_FORMANTS
    si = np.asarray(si, np.int32)
    return HostState(phase=si[2:3].view(np.float32)[0].copy(),
                     lp=np.array(sf[:F], np.float32),
                     fb=np.array(sf[F:2 * F], np.float32),
                     fc=np.array(sf[2 * F:], np.float32),
                     seed=si[1:2].view(np.uint32)[0].copy())


def _state_rows(st: HostState, jphi, jcell):
    """HostState and the carried jitter state -> the carry mode's rows
    (sf f32 [24], si int32 [5]) as numpy: si 0 (the Q32 phase) is unused
    by the exact carrier and 0."""
    sf = np.concatenate([np.asarray(st.lp, np.float32).reshape(-1),
                         np.asarray(st.fb, np.float32).reshape(-1),
                         np.asarray(st.fc, np.float32).reshape(-1)])
    si = np.array([0,
                   np.asarray(st.seed, np.uint32).reshape(()).view(np.int32),
                   np.asarray(st.phase, np.float32).reshape(()).view(
                       np.int32),
                   np.float32(jphi).view(np.int32), int(jcell)], np.int32)
    return sf, si


def _impl(device: torch.device) -> str:
    return "kernel" if device.type == "cuda" else "plain"


def _tick(impl: str, dev: dict, sf: torch.Tensor, si: torch.Tensor,
          blk: int):
    """One carry-mode launch of the fused synthesizer over the device
    inputs `dev` (score tables n/scal/vec/par, lattice window `lat`,
    `lat_base`, `offsets`, the jitter rate `inc`): (audio [B, blk], sf,
    si), the exact f32 carrier always on."""
    tables = kf.FusedTables(dev["n"], dev["scal"], dev["vec"], *dev["lat"],
                            dev["par"])
    return kf.IMPLEMENTATIONS[impl](tables, None, None, sf, si, blk, True,
                                    g0=dev["offsets"],
                                    lat_base=dev["lat_base"], inc=dev["inc"])


def _score_view(dev: dict) -> Score:
    """The score tables of `dev` (scal [B, E, 4], vec [B, E, 6, 8]) as a
    batched Score of views, what the sequencer reads: the same float32
    values, so expand_score renders what the carry kernel renders from the
    tables. `length` is None: the sequencer reads the cumulative ends."""
    scal, vec = dev["scal"], dev["vec"]
    elem = SynthesisElem(scal[..., 0], *(vec[:, :, k] for k in range(6)))
    return Score(elem, scal[..., 3] > 0.5, None, scal[..., 2], scal[..., 1])


def _xla_tick(impl: str, dev: dict, sf: torch.Tensor, si: torch.Tensor,
              blk: int, masked: bool = True):
    """One xla tick over the device inputs `dev` (as _tick's, and the
    sample rate `sr`): (audio [B, blk], sf, si), grail_tpu's
    _stream_block_batch with use_pallas off (masked=True: jitter off past a
    score's end) or, for a solo session, _stream_block (masked=False).

    It unpacks the carried rows into the jitter state (jphi, jcell) and a
    SynthState, steps the jitter recurrence (jsched_scan), renders the
    frames (expand_score at each lane's offset, apply_jitter at rows
    cell - lat_base), steps the f32 carrier (carrier_scan), runs
    _block_core on the carrier track, and packs the new state back into
    rows of the carry mode's layout, so checkpoints read one layout
    whichever tick ran. `impl` is 'kernel' (seq_scan.cu) or 'plain' for the
    two recurrences; the rest is plain PyTorch on the inputs' device. No
    host synchronisation: a CUDA graph can capture it.

    Its stages are spans (runtime/trace.py's `stage`: `jsched`, `frames`,
    `carrier`, `core`, `pack`), recorded only inside an open span, the
    pool's `launch`: a solo session's read and a served tick record none."""
    F = NUM_FORMANTS
    with stage("jsched"):
        phi, cell, jphi, jcell = jsched_scan(si[:, 3].view(torch.float32),
                                             si[:, 4], dev["inc"], blk, impl)
    with stage("frames"):
        elems, valid = expand_score(_score_view(dev), dev["sr"], blk,
                                    offset=dev["offsets"])
        par = dev["par"]
        elems = apply_jitter(elems, JitterLattice(*dev["lat"]), par[:, 0],
                             par[:, 1], par[:, 2],
                             (phi, cell - dev["lat_base"][:, None]),
                             mask=valid if masked else None)
        elems = SynthesisElem(*(f.transpose(0, 1) for f in elems))
    with stage("carrier"):
        state = SynthState(phase=si[:, 2].view(torch.float32),
                           filter_state_a=sf[:, :F],
                           filter_state_b=sf[:, F:2 * F],
                           filter_state_c=sf[:, 2 * F:],
                           seed=kf._i32_to_u32(si[:, 1]))
        car, phase = carrier_scan(state.phase, elems.frequency, impl)
    with stage("core"):
        out, st = _block_core(elems, state, carrier=car)
    with stage("pack"):
        sf2 = torch.cat([st.filter_state_a, st.filter_state_b,
                         st.filter_state_c], dim=1)
        si2 = torch.stack([si[:, 0], kf._u32_to_i32(st.seed),
                           phase.view(torch.int32), jphi.view(torch.int32),
                           jcell], dim=1)
    return out.T, sf2, si2


# the ticks by program, and the LAUNCHES keys of the kernels that one
# served tick's graph holds (serve_tick counts them per replay)
_TICKS = {"fused": _tick, "xla": _xla_tick}
_TICK_LAUNCHES = {"fused": ("fused_synth_carry",),
                  "xla": ("carrier_scan", "jsched_scan")}


def _converted_tick(impl: str, program: str, blk: int, output: str,
                    dev: dict, sf: torch.Tensor, si: torch.Tensor):
    """The tick of `program` over `dev` with its audio in the `output`
    format: (audio, sf, si). A pool binds everything before `dev`
    (StreamPool._tick_program), so that one call runs one tick."""
    out, sf, si = _TICKS[program](impl, dev, sf, si, blk)
    conv = _OUTPUTS[output]
    return (out if conv is None else conv(out)), sf, si


def _served_tick(tick, dev: dict, sf: torch.Tensor, si: torch.Tensor,
                 offsets: torch.Tensor, blk: int):
    """One served tick into fixed buffers, as serve mode captures it:
    `tick` (a pool's _tick_program) over the table set `dev` from
    `offsets`, the carried rows written back into `sf` and `si` in place
    and the offsets advanced in place by `blk`. Returns the audio."""
    out, sf2, si2 = tick(dict(dev, offsets=offsets), sf, si)
    sf.copy_(sf2)
    si.copy_(si2)
    offsets.add_(blk)
    return out


def _jparams(voices, inc):
    """(rate, jdf [B], jdff [B], jda [B]) for score_tables."""
    return (inc, [v.jitter_delta_frequency for v in voices],
            [v.jitter_delta_formant_frequency for v in voices],
            [v.jitter_delta_amplitude for v in voices])


def _up(x, device, dtype=None) -> torch.Tensor:
    """A host array (or list) on `device`."""
    return torch.as_tensor(np.ascontiguousarray(x) if isinstance(
        x, np.ndarray) else x, dtype=dtype).to(device)


# ---------------------------------------------------------------------------
# StreamSession
# ---------------------------------------------------------------------------

class StreamSession:
    """Incremental text -> audio session with carried DSP state.

    `device` ('cuda' by default, 'cpu' runs the plain versions) is where a
    solo read synthesizes; a session owned by a StreamPool is read through
    the pool. A solo read runs the carry tick on one lane when `block` is a
    multiple of 128, else the xla tick (grail_tpu's _stream_block)."""

    def __init__(self, voice="generic", language="generic", seed: int = 0,
                 block: int = 1024, contour: bool = False,
                 speaking_rate: float = 1.0, jitter_horizon_s: float = 60.0,
                 device="cuda"):
        self.device = _resolve_device(device)
        self.voice: Voice = get_voice(voice) if isinstance(voice, str) \
            else voice
        self.language = get_language(language) if isinstance(language, str) \
            else language
        self.block = int(block)
        if self.block <= 0:
            raise ValueError(f"block={self.block} must be positive")
        self.contour = contour
        self.speaking_rate = speaking_rate
        self.sample_rate = float(self.voice.sample_rate)
        # jitter window: the lattice is sized once for `jitter_horizon_s`
        # of stream and slides (_maybe_rebase_jitter) whenever the position
        # would outgrow it, so unbounded sessions keep a bounded lattice of
        # a fixed shape
        inc = float(self.voice.jitter_frequency)
        self._jitter_reserve = _bucket(
            max(int(jitter_horizon_s * self.sample_rate * inc) + 8, 16))
        # Stagger jitter-window slides across sessions: the trigger is
        # otherwise deterministic in (jitter_pos, inc), which all pooled
        # sessions share, and every session would slide on the same tick.
        # Seed-derived (not pool-index-derived) so a session behaves
        # identically solo and pooled.
        self._jitter_stagger = int(seed) % max(1, self._jitter_reserve // 4)

        self._elements: List[PhonemeElem] = []   # always glide-merged
        self._rev = 0                # bumped on every rolling-score change
        self._endn_key = None        # cache for _boundaries
        self._endn = None
        self._resid = None           # per-element drift residuals
        self._drift_t0 = np.float32(0.0)  # f32 countdown residual carried
        #                              across rebases (bit-identical
        #                              boundaries to the continuous stream)
        self._score_cache = {}       # {(rev, pad_to): Score}
        self._horizon_tail = 0       # trailing auto-appended idle silence
        self._pool_ref = None        # (pool, index) when owned by a pool
        self._ghost = False          # in a mesh pool, owned by another
        #                              rank: feeds keep only the command
        #                              grammar's state (StreamPool)
        self._consumed_samples = 0   # samples consumed within the score
        self._jitter_pos = 0         # absolute sample counter (never
        #                              rebased: the jitter clock)
        self._lat_base = 0           # absolute cell of lattice row 0
        self._sf = torch.zeros(1, 3 * NUM_FORMANTS, device=self.device)
        self._si = torch.zeros(1, 5, dtype=torch.int32, device=self.device)
        self._lattice = _IncrementalLattice(seed)
        self._pending_chars: List[str] = []
        self._pending_cmd = ""       # unterminated [command fragment
        self._pending_clause = ""    # contour mode: unterminated clause
        self._lead_silence = True    # reference parity: transcribe() seeds
        #                              one Silence per utterance
        #                              (src/lib.rs:1197-1204); the first
        #                              real text carries it
        self._residual = np.empty(0, np.float32)  # unserved tail of a block

    # -- pool-lag sample counters -------------------------------------------
    # Pool ticks advance every session's two sample counters in lockstep.
    # The pool accumulates ONE lag integer (StreamPool._lag_samples, += blk
    # per tick) and these properties fold it into every read, so a tick
    # costs no per-session host work. Absolute writes subtract the current
    # lag, so `s._consumed_samples -= n` (rebase) and checkpoint restores
    # keep exact semantics.

    def _pool_lag(self) -> int:
        pr = self._pool_ref
        return 0 if pr is None else pr[0]._lag_samples

    @property
    def _consumed_samples(self) -> int:
        return self._consumed_base + self._pool_lag()

    @_consumed_samples.setter
    def _consumed_samples(self, v) -> None:
        self._consumed_base = int(v) - self._pool_lag()

    @property
    def _jitter_pos(self) -> int:
        return self._jitter_base + self._pool_lag()

    @_jitter_pos.setter
    def _jitter_pos(self, v) -> None:
        self._jitter_base = int(v) - self._pool_lag()

    def _bump_rev(self) -> None:
        """Every rolling-score mutation comes through here: bumps this
        session's revision (cache keys) and the owning pool's mutation
        counter (the O(1) steady-state tick fast path)."""
        self._rev += 1
        if self._pool_ref is not None and not self._ghost:
            self._pool_ref[0]._mut += 1

    # -- frontend ----------------------------------------------------------

    def feed(self, text: str, parse_commands: bool = False) -> None:
        """Append text; transcription is greedy so a trailing partial match
        waits for more characters (buffered like the reference Peekable).

        With parse_commands=True, inline `[key:value]` tokens adjust live
        intonation (the reference's planned parser stage, src/lib.rs:1366):

            [pitch:150]   center frequency in Hz for subsequent text
            [rate:1.5]    speaking rate multiplier
            [voice:name]  switch voice preset (same sample/jitter rates)
            [lang:name]   switch transcription language / prosody rules
            [[  /  ]]     literal '[' / ']'

        Malformed or unknown commands raise ValueError. A command split
        across feed() chunks is buffered until terminated; an unterminated
        fragment at flush() is the loud error."""
        if parse_commands:
            combined = self._pending_cmd + text
            try:
                chunks, tail = _parse_commands(combined, partial=True)
                # validate every command BEFORE applying anything, so a
                # value that parses but cannot apply consumes nothing
                for kind, payload in chunks:
                    if kind != "text":
                        self._validate_command(kind, payload)
            except ValueError:
                # atomic: the whole buffer stays pending, no input is lost
                self._pending_cmd = combined
                raise
            self._pending_cmd = tail
            for kind, payload in chunks:
                if kind == "text":
                    self.feed(payload)
                else:
                    self._apply_command(kind, payload)
            return
        if self._ghost:
            return      # another rank synthesizes this session's text
        if self.contour:
            # clause-typed prosody needs the clause terminator before any
            # of the clause can be intonated; buffer until punctuation or
            # flush() arrives
            from ..text.intonate import split_clauses_partial

            clauses, self._pending_clause = split_clauses_partial(
                self._pending_clause + text)
            for clause, kind, pause in clauses:
                self._append_clause(clause, kind, pause)
            return
        self._pending_chars.extend(text)
        # incremental automaton run: emits every match that is final
        # whatever follows; a trailing extendable partial match waits for
        # more text or flush()
        phonemes, consumed = transcribe_partial(
            "".join(self._pending_chars), self.language)
        self._pending_chars = self._pending_chars[consumed:]
        if phonemes and self._lead_silence:
            phonemes = [Phoneme.SILENCE] + list(phonemes)
            self._lead_silence = False
        self._append_phonemes(phonemes)

    def _validate_command(self, kind: str, value: str) -> None:
        """Raise ValueError if `value` cannot apply; side-effect free."""
        if kind in ("pitch", "rate"):
            try:
                v = float(value)
            except ValueError:
                raise ValueError(
                    f"[{kind}:{value}]: expected a number") from None
            if not (v > 0):
                raise ValueError(f"[{kind}:{value}]: must be positive")
        elif kind == "voice":
            try:
                new = get_voice(value)
            except KeyError as e:
                raise ValueError(str(e)) from None
            if float(new.sample_rate) != self.sample_rate:
                raise ValueError(
                    "live voice switch requires equal sample rates")
            if abs(float(new.jitter_frequency)
                   - float(self.voice.jitter_frequency)) > 1e-12:
                # the lattice's cell schedule is position * rate: a
                # mid-stream rate change would misalign every drawn cell
                raise ValueError(
                    "live voice switch requires equal jitter rates")
        elif kind == "lang":
            try:
                get_language(value)
            except KeyError as e:
                raise ValueError(str(e)) from None
        else:
            raise ValueError(f"unknown stream command {kind!r}")

    def _apply_command(self, kind: str, value: str) -> None:
        self._validate_command(kind, value)
        self.flush()  # pending text keeps the pre-command settings
        if kind == "pitch":
            self.voice = dataclasses.replace(
                self.voice, center_frequency=float(value) / self.sample_rate)
        elif kind == "rate":
            self.speaking_rate = float(value)
        elif kind == "voice":
            self.voice = get_voice(value)
        elif kind == "lang":
            self.language = get_language(value)
        # voice/prosody changes invalidate the pool's upload cache even with
        # no pending text (a collected Voice's id can be reused)
        self._bump_rev()

    def flush(self) -> None:
        """Force-transcribe any held-back characters; a command fragment
        still unterminated at end-of-input raises (strict grammar)."""
        if self._pending_cmd:
            # parse + validate BEFORE clearing: on a ValueError the fragment
            # stays buffered
            chunks = _parse_commands(self._pending_cmd)
            for kind, payload in chunks:
                if kind != "text":
                    self._validate_command(kind, payload)
            self._pending_cmd = ""
            for kind, payload in chunks:
                if kind == "text":
                    self.feed(payload)
                else:
                    self._apply_command(kind, payload)
        if self._pending_clause:
            from ..text.intonate import split_clauses_partial

            clauses, tail = split_clauses_partial(self._pending_clause,
                                                  final=True)
            self._pending_clause = ""
            for clause, kind, pause in clauses:
                self._append_clause(clause, kind, pause)
            tail = tail.strip()
            if tail:   # unterminated final clause: statement, no pause
                self._append_clause(tail, "statement", None)
        if self._pending_chars:
            phonemes = list(transcribe_chars("".join(self._pending_chars),
                                             self.language))
            self._pending_chars = []
            if phonemes and self._lead_silence:
                phonemes = [Phoneme.SILENCE] + phonemes
                self._lead_silence = False
            self._append_phonemes(phonemes)

    def _append_clause(self, clause: str, kind: str, pause) -> None:
        """Contour mode: transcribe + intonate one terminated clause with
        its type and append the trailing pause silence, as
        api.text_to_phoneme_elems treats clauses."""
        from ..text.transcribe import transcribe

        self._append_phonemes(transcribe(clause, self.language),
                              clause=kind, pause=pause)

    def _append_phonemes(self, phonemes, clause: str = "statement",
                         pause=None) -> None:
        if not phonemes:
            return
        pelems = list(intonate(phonemes, self.language, self.voice,
                               contour=self.contour,
                               speaking_rate=self.speaking_rate,
                               clause=clause))
        if pause is not None:
            rate = max(self.speaking_rate, 1e-3)
            dur = (self.language.intonation.comma_pause if pause == "comma"
                   else self.language.intonation.sentence_pause) / rate
            pelems.append(PhonemeElem(Phoneme.SILENCE, dur,
                                      min(0.5 * dur, 0.06 / rate),
                                      self.voice.center_frequency))
        self._trim_horizon_tail()
        # glide-merge at append time so the rolling element list is 1:1
        # with the score's rows (one element of context suffices)
        tail = self._elements[-1:]
        merged = merge_glides(tail + list(pelems))
        self._elements = (self._elements[:len(self._elements) - len(tail)]
                          + merged)
        tally(elems=len(merged) - len(tail))
        self._bump_rev()

    def _trim_horizon_tail(self) -> None:
        """Drop auto-appended trailing silence that has not started playing,
        keeping the immediate next element (the current element's crossfade
        target), so text fed after an idle period starts about one block
        later, not after the pre-scheduled silence."""
        t = min(self._horizon_tail, len(self._elements))
        if t <= 0:
            self._horizon_tail = 0
            return
        n = self._end_samples()
        E = len(self._elements)
        keep = self._consumed_samples
        drop = 0
        while drop < t:
            i = E - 1 - drop
            start = int(n[i - 1]) if i > 0 else 0
            if start <= keep:       # started / current element: keep
                break
            prev_start = int(n[i - 2]) if i > 1 else 0
            if prev_start <= keep:  # i is the current element's blend
                break               # target: keep one for continuity
            drop += 1
        if drop:
            self._elements = self._elements[:E - drop]
            self._bump_rev()
        self._horizon_tail = 0

    def _end_samples(self) -> np.ndarray:
        """Cumulative element end-samples [E] int64 in the score's own
        boundary convention (the reference's drifting f32 countdown, seeded
        with the rebase-carried residual), cached on _rev."""
        return self._boundaries()[0]

    def _boundaries(self):
        """(end_samples [E] int64, drift residuals [E] f32), cached on _rev.

        Incremental across revisions: the drift sim is a left-to-right f32
        fold whose per-element residuals are the continuation seeds, so an
        append or truncation re-simulates only past the longest unchanged
        prefix. A rebase changes _drift_t0 and resets the prefix."""
        key = self._rev
        if self._endn_key != key:
            lengths = np.asarray([e.length for e in self._elements],
                                 np.float32)
            prev = getattr(self, "_endn_lengths", None)
            m = 0
            if (prev is not None and len(prev)
                    and getattr(self, "_endn_t0", None)
                    == np.float32(self._drift_t0).tobytes()):
                k = min(len(prev), len(lengths))
                neq = np.nonzero(prev[:k].view(np.uint32)
                                 != lengths[:k].view(np.uint32))[0]
                m = int(neq[0]) if len(neq) else k
            if len(lengths) == 0:
                self._endn = np.zeros(1, np.int64)
                self._resid = np.zeros(0, np.float32)
            elif m == len(lengths):          # pure truncation
                self._endn = self._endn[:m]
                self._resid = self._resid[:m]
            elif m > 0:
                endn_sfx, resid_sfx = _reference_boundary_samples(
                    lengths[m:], self.sample_rate,
                    t0=float(self._resid[m - 1]))
                self._endn = np.concatenate(
                    [self._endn[:m], endn_sfx + self._endn[m - 1]])
                self._resid = np.concatenate([self._resid[:m], resid_sfx])
            else:
                self._endn, self._resid = _reference_boundary_samples(
                    lengths, self.sample_rate, t0=float(self._drift_t0))
            self._endn_lengths = lengths
            self._endn_t0 = np.float32(self._drift_t0).tobytes()
            self._endn_key = key
            self._score_cache.clear()
        return self._endn, self._resid

    def _build_score(self, pad_to: int):
        """numpy Score for the current elements, from the cached boundary
        sim (one drift simulation per revision, one table gather per
        (revision, pad))."""
        key = (self._rev, pad_to)
        score = self._score_cache.get(key)
        if score is None:
            n_ref, _ = self._boundaries()
            score = score_from_phoneme_elems(
                self._elements, self.voice, pad_to=pad_to,
                n_ref=n_ref if self._elements else None)
            self._score_cache[key] = score
        return score

    def _ensure_audio_horizon(self, samples_needed: int) -> None:
        """Idle behavior: extend with Silence elements (the reference's
        repeat_with(' ') -> Silence path) until the score covers the read.

        Appends in BULK (several seconds at once): every append bumps the
        revision, and a pool re-uploads a session's rows on a revision.
        Trailing silence elements are idempotent, so over-appending never
        changes the audio."""
        deficit = (samples_needed
                   - (int(self._end_samples()[-1]) - self._consumed_samples))
        if deficit <= 0:
            return
        # shed consumed elements first, as a bump is happening anyway
        self._rebase(min_drop=0)
        margin = max(4 * samples_needed, int(2 * self.sample_rate))
        # pooled sessions stagger their horizon expiry (index-derived), so
        # sessions fed together do not all re-append on the same tick
        if self._pool_ref is not None:
            i = self._pool_ref[1]
            margin += int((i % 32) * 0.125 * self.sample_rate)
        n_el = -(-(deficit + margin) // int(0.5 * self.sample_rate))
        sil = PhonemeElem(Phoneme.SILENCE, 0.5, 0.5,
                          self.voice.center_frequency)
        self._elements.extend([sil] * n_el)
        self._horizon_tail += n_el   # trimmed when real text arrives
        self._bump_rev()

    def _rebase(self, min_drop: int = 8) -> None:
        """Drop fully-consumed elements to keep the score small.

        `min_drop` batches revision bumps (every bump invalidates the pool
        upload cache); pass 0 when a bump is happening anyway."""
        if not self._elements:
            return
        n, resid = self._boundaries()
        # keep one consumed element of margin (its params blend into the
        # next)
        drop = int(np.searchsorted(n, self._consumed_samples, side="right"))
        drop = max(0, drop - 1)
        if drop > min_drop:
            self._elements = self._elements[drop:]
            self._consumed_samples -= int(n[drop - 1])
            # carry the countdown residual at the drop point so the
            # remaining boundaries stay those of the continuous stream
            self._drift_t0 = np.float32(resid[drop - 1])
            tally(rebases=1)
            self._bump_rev()

    def _cell_bound(self, pos: int) -> int:
        """Cheap upper bound on the exact absolute cell at sample `pos`:
        floor(pos*inc) + 1 (phase-origin offset) + the accumulated f32
        phase drift, over-covered by pos >> 28 + 1. Integer math only, for
        the per-tick sizing and slide triggers."""
        return int(pos * float(self.voice.jitter_frequency)) + 2 + (pos >> 28)

    def _jitter_cells(self, blk: int) -> int:
        """Lattice rows (window-relative) needed for the next `blk` samples;
        normally the fixed reserve, growing only if a caller reads more
        than the horizon in one call."""
        need = (self._cell_bound(self._jitter_pos + blk + 1) - self._lat_base
                + 4)
        if need > self._jitter_reserve:
            self._jitter_reserve = _bucket(need)
        return self._jitter_reserve

    def _jitter_state_host(self):
        """Exact (phase f32, absolute cell) at self._jitter_pos, from the
        checkpointed schedule (on restores, never per tick)."""
        from ..synth.schedule import get_schedule

        return get_schedule(self.voice.jitter_frequency).state_at(
            self._jitter_pos)

    def _maybe_rebase_jitter(self, blk: int) -> None:
        """Slide the lattice window when the next read would outgrow the
        reserve: drop the K passed cells and advance _lat_base by K. The
        jitter phase is untouched (it is the absolute carried state); only
        the window and the lat_base that maps absolute cells onto it move.
        Deterministic in (jitter_pos, inc, seed), so a session slides
        identically solo and pooled."""
        need = (self._cell_bound(self._jitter_pos + blk + 1) - self._lat_base
                + 4)
        if need + self._jitter_stagger <= self._jitter_reserve:
            return
        _, cell_abs = self._jitter_state_host()
        K = cell_abs - self._lat_base - 4
        if K <= 0:
            return           # nothing to slide: _jitter_cells grows instead
        self._lattice.ensure(K + 1)   # never drop cells not yet generated
        self._lattice.drop(K)
        self._lat_base += K  # the version bump re-uploads window + base

    def _quiet_horizon(self, blk: int) -> int:
        """Largest absolute _jitter_pos at which a tick of `blk` samples
        still runs NO per-session maintenance: the audio horizon's deficit
        stays <= 0, the slide trigger stays false, and the reserve cannot
        grow. Every trigger is monotone in the session's position, so the
        pool skips the O(N) maintenance loop until the earliest session's
        bound (StreamPool._prepare_tick's fast path)."""
        pos = self._jitter_pos
        if not self._elements:
            return pos          # nothing buffered: maintain every tick
        q = pos + (int(self._end_samples()[-1])
                   - self._consumed_samples) - blk
        # jitter window: quiet while need(p) + stagger <= reserve, with
        # need(p) monotone in p; _cell_bound(x) - 2 <= x*(inc + 2^-28), so
        # x <= budget/(inc + 2^-28) is conservative, confirmed below
        budget = (self._jitter_reserve - self._jitter_stagger - 6
                  + self._lat_base)
        inc = float(self.voice.jitter_frequency)
        p_j = int(budget / (inc + 2.0 ** -28)) - blk - 1 if budget > 0 else 0
        if (p_j <= pos
                or self._cell_bound(p_j + blk + 1) - self._lat_base + 4
                + self._jitter_stagger > self._jitter_reserve):
            return pos          # at/near the slide trigger: no skipping
        return min(q, p_j)

    # -- audio -------------------------------------------------------------

    def read(self, num_samples: Optional[int] = None) -> np.ndarray:
        """Synthesize the next `num_samples` (default one block).

        Synthesis advances in whole blocks; samples beyond the requested
        count are kept in a residual buffer and served by the next read, so
        arbitrary read sizes are gap-free."""
        if self._pool_ref is not None:
            raise RuntimeError(
                "session is owned by a StreamPool: read audio via "
                "pool.read_block() — a solo read would advance only this "
                "session's host state and desynchronize it from the pool's "
                "device-resident batch state")
        n = self.block if num_samples is None else int(num_samples)
        out = np.empty(n, np.float32)
        done = 0
        while done < n:
            if len(self._residual) == 0:
                self._residual = self._read_block()
            take = min(len(self._residual), n - done)
            out[done:done + take] = self._residual[:take]
            self._residual = self._residual[take:]
            done += take
        return out

    def _materialize_state(self) -> None:
        """Pool-owned sessions keep their state in the pool's stacked device
        rows; pull this session's rows only when needed (checkpoints)."""
        if self._pool_ref is not None:
            pool, idx = self._pool_ref
            r = idx - pool._lo
            self._sf = pool._sf[r:r + 1].clone()
            self._si = pool._si[r:r + 1].clone()

    def _read_block(self) -> np.ndarray:
        """One block of the solo stream: the pool's carry tick on one lane
        (the kernel on a card), or the xla tick unmasked (grail_tpu's
        _stream_block) for a block that is not a multiple of 128, with this
        session's score and window uploaded for it."""
        blk = self.block
        self._ensure_audio_horizon(blk)
        self._rebase()
        self._maybe_rebase_jitter(blk)
        score = self._build_score(_bucket(len(self._elements)))
        cells = self._jitter_cells(blk)
        self._lattice.ensure(cells)
        v, dev = self.voice, self.device
        n, scal, vec, par = kf.score_tables(
            stack_scores([score]), _jparams([v], v.jitter_frequency),
            self.sample_rate)
        inputs = dict(
            n=_up(n, dev), scal=_up(scal, dev), vec=_up(vec, dev),
            par=_up(par, dev),
            lat=tuple(_up(x, dev) for x in kf.lattice_tables(
                JitterLattice(*(x[None] for x in self._lattice.rows(
                    cells))))),
            lat_base=_up([self._lat_base], dev, torch.int32),
            offsets=_up([self._consumed_samples], dev, torch.int32),
            inc=float(np.float32(v.jitter_frequency)), sr=self.sample_rate)
        if blk % kf.CHUNK:
            out, self._sf, self._si = _xla_tick(_impl(dev), inputs, self._sf,
                                                self._si, blk, masked=False)
        else:
            out, self._sf, self._si = _tick(_impl(dev), inputs, self._sf,
                                            self._si, blk)
        self._consumed_samples += blk
        self._jitter_pos += blk
        return out[0].cpu().numpy()

    # -- checkpoint / resume ----------------------------------------------
    #
    # The whole session (rolling score, counters, DSP state, lattice window
    # and its continuations) serializes to one npz payload with grail_tpu's
    # keys, so a checkpoint taken by either package loads into the other.

    def _payload_dict(self, state: HostState) -> dict:
        """Flat array dict of the full session state, shared by the solo
        and the pool-level checkpoint formats."""
        elems = np.array([(int(e.phoneme), e.length, e.blend_length,
                           e.frequency) for e in self._elements],
                         np.float64).reshape(-1, 4)
        return dict(
            elems=elems,
            counters=np.array([self._consumed_samples, self._jitter_pos,
                               self._lat_base], np.int64),
            drift_t0=np.float32(self._drift_t0),
            phase=state.phase, lp=state.lp, fb=state.fb, fc=state.fc,
            seed=state.seed,
            lat_pitch=self._lattice.pitch,
            lat_formant=self._lattice.formant,
            lat_amp=self._lattice.amp,
            lat_states=np.array([self._lattice._pitch_state.state,
                                 self._lattice._formant_state.state,
                                 self._lattice._amp_state.state], np.uint32),
            pending=np.frombuffer("".join(self._pending_chars).encode(),
                                  np.uint8),
            pending_cmd=np.frombuffer(self._pending_cmd.encode(), np.uint8),
            pending_clause=np.frombuffer(self._pending_clause.encode(),
                                         np.uint8),
            residual=self._residual,
            # live-command state: a session that executed [voice:]/[pitch:]
            # /[rate:]/[lang:] restores with those settings
            voice_name=np.frombuffer(self.voice.name.encode(), np.uint8),
            lang_name=np.frombuffer(self.language.name.encode(), np.uint8),
            prosody=np.array([self.voice.center_frequency,
                              self.speaking_rate, self.sample_rate,
                              float(self.contour),
                              float(self._lead_silence)], np.float64),
            horizon=np.int64(self._horizon_tail),
        )

    def _apply_payload(self, z, prefix: str = "") -> None:
        """Restore session state from a dict-like of arrays (npz archive),
        keys optionally prefixed (pool payloads pack N sessions into one
        archive). Sets this session's own state rows (_sf, _si) with the
        jitter state rebuilt from the restored position; scattering them
        into a pool is the caller's."""
        def g(k):
            return z[prefix + k]

        def has(k):
            try:
                return (prefix + k) in z
            except TypeError:
                return (prefix + k) in z.files

        if has("voice_name"):
            vn = bytes(np.asarray(g("voice_name"), np.uint8)).decode()
            pros = [float(x) for x in g("prosody")]
            cf, rate, sr, contour = pros[:4]
            # older checkpoints (4-value prosody) are mid-session by
            # construction: their leading silence was already emitted
            self._lead_silence = bool(pros[4]) if len(pros) > 4 else False
            if vn and vn != self.voice.name:
                try:
                    v = get_voice(vn)
                except KeyError:
                    raise ValueError(
                        f"checkpoint used voice {vn!r}, which is not "
                        "registered here; register_voice() it before "
                        "load_state()") from None
                self.voice = v
            if float(self.voice.sample_rate) != sr:
                self.voice = self.voice.resampled(sr)
            if cf != float(self.voice.center_frequency):   # live [pitch:]
                self.voice = dataclasses.replace(
                    self.voice, center_frequency=cf)
            self.sample_rate = float(self.voice.sample_rate)
            self.speaking_rate = rate
            self.contour = bool(contour)
            ln = bytes(np.asarray(g("lang_name"), np.uint8)).decode()
            if ln and ln != self.language.name:
                try:
                    self.language = get_language(ln)
                except KeyError:
                    raise ValueError(
                        f"checkpoint used language {ln!r}, which is not "
                        "registered here; register_language() it before "
                        "load_state()") from None
        self._elements = [
            PhonemeElem(Phoneme(int(r[0])), float(r[1]), float(r[2]),
                        float(r[3]))
            for r in g("elems")]
        self._bump_rev()   # invalidates pool and end-sample caches
        self._horizon_tail = int(g("horizon")) if has("horizon") else 0
        self._drift_t0 = (np.float32(g("drift_t0")) if has("drift_t0")
                          else np.float32(0.0))
        c = np.asarray(g("counters"))
        self._consumed_samples = int(c[0])
        self._jitter_pos = int(c[1])
        self._lat_base = int(c[2]) if c.shape[0] > 2 else 0
        state = HostState(*(np.asarray(g(k)) for k in
                            ("phase", "lp", "fb", "fc", "seed")))
        sf, si = _state_rows(state, *self._jitter_state_host())
        self._sf = _up(sf[None], self.device)
        self._si = _up(si[None], self.device)
        self._lattice.pitch = g("lat_pitch")
        self._lattice.formant = g("lat_formant")
        self._lattice.amp = g("lat_amp")
        # a restored window may exceed the constructor-sized reserve
        self._jitter_reserve = max(self._jitter_reserve,
                                   _bucket(len(self._lattice.pitch)))
        self._lattice.version += 1   # restored content invalidates uploads
        st = g("lat_states")
        self._lattice._pitch_state.state = int(st[0])
        self._lattice._formant_state.state = int(st[1])
        self._lattice._amp_state.state = int(st[2])
        self._pending_chars = list(bytes(g("pending")).decode())
        self._pending_cmd = (bytes(g("pending_cmd")).decode()
                             if has("pending_cmd") else "")
        self._pending_clause = (bytes(g("pending_clause")).decode()
                                if has("pending_clause") else "")
        self._residual = (np.asarray(g("residual"), np.float32)
                          if has("residual") else np.empty(0, np.float32))

    def _check_not_serving(self, what: str) -> None:
        """A pool-owned session shares StreamPool.save/load's torn-state
        hazard: while serve mode is live the host counters sync only at
        frontend cycles and the real-time thread writes the pool's rows.
        In a mesh pool only the owning rank holds a session's state."""
        if self._ghost:
            raise RuntimeError(
                f"{what} on session {self._pool_ref[1]}, which another rank "
                "of the pool's mesh owns; pool.save() gathers every session")
        if self._pool_ref is not None and self._pool_ref[0]._serving:
            raise RuntimeError(
                f"{what} on a pool-owned session while serve mode is live "
                "would snapshot/restore a torn state; call "
                "pool.serve_stop() first")

    def save_state(self) -> bytes:
        self._check_not_serving("save_state()")
        self._materialize_state()
        buf = io.BytesIO()
        np.savez(buf, **self._payload_dict(_host_state(
            self._sf[0].cpu().numpy(), self._si[0].cpu().numpy())))
        return buf.getvalue()

    def load_state(self, payload: bytes) -> None:
        self._check_not_serving("load_state()")
        z = np.load(io.BytesIO(payload))
        self._apply_payload(z)
        if self._pool_ref is not None:
            # pool-owned: the pool reads the state from its stacked rows,
            # so the restored rows are scattered back and the device
            # inputs (offsets with them) rebuilt from the restored counters
            pool, idx = self._pool_ref
            if pool._inflight is not None:
                pool.drain()   # a tick dispatched before the restore
            pool._sf[idx - pool._lo] = self._sf[0].to(pool.device)
            pool._si[idx - pool._lo] = self._si[0].to(pool.device)
            pool._cache_key = None
            pool._lat_key = None

    @property
    def pending_seconds(self) -> float:
        end = int(self._end_samples()[-1]) if self._elements else 0
        return max(0.0, (end - self._consumed_samples) / self.sample_rate)


# ---------------------------------------------------------------------------
# StreamPool
# ---------------------------------------------------------------------------

# pool backend names -> the tick's program ('fused_interpret' is grail_tpu's
# interpreter name for its fused tick)
_BACKENDS = {"fused": "fused", "fused_interpret": "fused", "xla": "xla"}
# the lattice group's tables, in JitterLattice's order
_LAT = ("latp", "latf", "lata")


class StreamPool:
    """N concurrent streaming sessions, one tick program for all of them:
    the fused synthesizer's carry launch, or the xla tick.

    The serving shape: each tick synthesizes the next `block` samples for
    every session in one program (the kernels on `device='cuda'`, the
    default; the plain versions on 'cpu'). Session frontends (feed, flush,
    commands, rebasing) stay per-session on the host.

    `backend` is 'fused' (default: one carry-mode launch per tick;
    'fused_interpret' is another name for it, so that calls written for
    grail_tpu run unchanged) or 'xla' (the xla tick: one carrier_scan and
    one jsched_scan launch and plain PyTorch). A `block` that is not a
    multiple of 128 selects 'xla', as in grail_tpu.

    `device` is where the tick runs: 'cuda' (None, the default, without a
    mesh) or 'cpu' (the plain versions).

    `mesh` (parallel.make_mesh over an initialised process group) shards
    the sessions over its 'data' axis, as grail_tpu's sharded pool does.
    torch runs one process per rank, so the contract is SPMD:

      * every rank constructs the same pool and makes the same calls in the
        same order (feed, flush, reads, serve_*, save, load);
      * the rank at 'data' coordinate d owns sessions [d*n/n_data,
        (d+1)*n/n_data) (`local_sessions`); the ranks of one data row (its
        'seq' coordinates) replicate it. `sessions` holds all n, with
        grail_tpu's seeds and indices, but the host pass, the uploads, the
        carried rows and the tick cover only the owned ones;
      * a feed to a session that another rank owns is dropped after its
        command grammar has run, so a call that raises on the owner (a bad
        inline command) raises on every rank;
      * every read (read_block(s), collect, tick_pipelined, drain,
        serve_tick) returns the rank's own rows, [n/n_data, k*block] in
        session order; the tick (parallel.sharded_stream_tick_fn, the
        carry launch and the output conversion) has no collective;
      * save() is collective: it gathers the owned sessions' payloads over
        the mesh (seq coordinate 0 of each row), and every rank returns
        the one blob of all n sessions in the unsharded layout. load()
        restores the owned sessions of any pool blob, sharded or not.

    A mesh needs the fused tick (backend 'xla', or a block that is not a
    multiple of 128, raises ValueError) and n divisible by its 'data'
    size; the pool's device is the mesh's (a `device` that disagrees
    raises ValueError). Nothing falls back: a failed launch, capture or
    collective raises.

    `pin_elems` pins the element-count bucket E of the device tables (to
    at least `_bucket(pin_elems)`), so that a session crossing a power of
    two does not change the tables' shape mid-serving; E grows past the
    pin only when a score outgrows it.

    Serve mode (serve_start / serve_tick / serve_stop, as grail_tpu's): a
    frontend thread owns the host pass and publishes table sets; the
    real-time thread's serve_tick adopts the newest set and runs one tick,
    on a card one replay of the CUDA graph captured for that set.

    Usage:
        pool = StreamPool(8, voice="plain", language="english")
        pool.feed(3, "hello")
        audio = pool.read_block()      # [8, block]

        pool.serve_start()             # strict-deadline serving
        audio = pool.serve_tick()      # [8, block] on the device
        pool.serve_stop()

        # on each of 4 ranks, after init_process_group and set_device:
        pool = StreamPool(8, voice="plain", mesh=make_mesh(4, 1))
        pool.feed(3, "hello")          # rank 1 speaks it, the rest drop it
        audio = pool.read_block()      # [2, block]: this rank's sessions
    """

    def __init__(self, n: int, voice="generic", language="generic",
                 block: int = 1024, seeds=None, contour: bool = False,
                 speaking_rate: float = 1.0, backend: Optional[str] = None,
                 mesh=None, output: str = "f32",
                 pin_elems: Optional[int] = None,
                 jitter_horizon_s: float = 60.0, device=None):
        if output not in _OUTPUTS:
            raise ValueError(
                f"output must be 'f32', 'pcm16' or 'ulaw', got {output!r}")
        backend = "fused" if backend is None else backend
        if backend not in _BACKENDS:
            raise ValueError(f"StreamPool backend must be 'fused', "
                             f"'fused_interpret' or 'xla', got {backend!r}")
        if int(block) <= 0:
            raise ValueError(f"block={block} must be positive")
        if int(block) % kf.CHUNK:
            backend = "xla"     # the carry kernel runs whole chunks
        self.mesh = mesh
        if mesh is None:
            self.device = _resolve_device("cuda" if device is None
                                          else device)
            self._lo, self._hi = 0, n
        else:
            self.device, (self._lo, self._hi) = _mesh_place(
                mesh, n, backend, device)
        self._impl = _impl(self.device)
        self.output = output
        self.backend = backend
        self._program = _BACKENDS[backend]
        self.pin_elems = int(pin_elems) if pin_elems else 0
        seeds = list(seeds) if seeds is not None else list(range(n))
        # jitter_horizon_s sizes each session's device-resident lattice
        # window (reserve rows = horizon * sr * jitter rate); smaller
        # horizons shrink the upload at the cost of more frequent
        # (staggered) window slides
        self.sessions = [
            StreamSession(voice=voice, language=language, seed=seeds[i],
                          block=block, contour=contour,
                          speaking_rate=speaking_rate,
                          jitter_horizon_s=jitter_horizon_s,
                          device=self.device)
            for i in range(n)
        ]
        self.n = n
        self.block = int(block)
        self.sample_rate = self.sessions[0].sample_rate
        # the sessions this rank owns (all n without a mesh): the host pass,
        # the device tables and the carried rows cover these, in order
        self._local = self.sessions[self._lo:self._hi]
        nl = len(self._local)
        # the carried state, device-resident as the kernel's rows: sf f32
        # [nl, 24] (lp, b, c), si int32 [nl, 5] (Q32 phase unused, seed, f32
        # carrier phase, jitter phase bits, absolute jitter cell). All
        # sessions start at jitter position 0: state (0.0, 0).
        self._sf = torch.zeros(nl, 3 * NUM_FORMANTS, device=self.device)
        self._si = torch.zeros(nl, 5, dtype=torch.int32, device=self.device)
        self._ticks = {}              # {samples: the tick program}
        # upload caches: scores + offsets (any session revision) and the
        # lattice window + lat_base (content changes: first sizing, slides).
        # In steady state a tick re-launches on the same device tables with
        # the device-advanced offsets: no host->device copy.
        self._cache_key = None
        self._dev = None
        self._lat_key = None
        self._lat_dev = None          # (latp, latf, lata) [N, cells(, 8)]
        self._lat_base_dev = None     # [N] int32, published with the window
        self._inflight = None         # depth-2 pipeline: (host audio, event)
        self._quiet = None            # (until_pos, blk, E, cells, pin): the
        #                               position below which the
        #                               per-session maintenance is a no-op
        self._mut = 0                 # bumped by every session mutation
        self._quiet_mut = -1          # _mut when _dev was last validated
        self._lag_samples = 0         # lockstep counter lag (see
        #                               StreamSession's counter properties)
        # serve mode (serve_start): the frontend lock (feeds, builds), the
        # swap lock (the one published set), and the set the real-time
        # thread has adopted
        self._serving = False
        self._serve_thread = None
        self._serve_lock = threading.Lock()
        self._swap_lock = threading.Lock()
        self._swap_pending = None
        self._serve_cur = None
        self._serve_ticks = 0         # served ticks (the real-time clock)
        self._serve_captures = 0      # CUDA graphs captured
        for i, s in enumerate(self.sessions):
            s._pool_ref = (self, i)
            s._ghost = not self._lo <= i < self._hi

    @property
    def local_sessions(self) -> range:
        """The indices of the sessions this rank owns, whose rows every read
        returns in this order: all n without a mesh."""
        return range(self._lo, self._hi)

    def _tick_program(self, blk: int):
        """The tick of `blk` samples, (dev, sf, si) -> (audio in the pool's
        output format, sf, si), cached per size: on a mesh
        parallel.sharded_stream_tick_fn, else the pool's program. The same
        callable runs read_blocks, serve_start's eager tick and the
        captured served tick."""
        tick = self._ticks.get(blk)
        if tick is None:
            if self.mesh is not None:
                from ..parallel.sharded import sharded_stream_tick_fn

                tick = sharded_stream_tick_fn(self.mesh, blk,
                                              out_fmt=self.output)
            else:
                tick = functools.partial(_converted_tick, self._impl,
                                         self._program, blk, self.output)
            self._ticks[blk] = tick
        return tick

    @property
    def _jstates(self):
        """The carried jitter state (jphi f32 [N], jcell int32 [N])."""
        return self._si[:, 3].view(torch.float32), self._si[:, 4]

    def _feed_lock(self):
        """The frontend lock while serve mode is live, else a no-op: a feed
        must not change a session's elements in the middle of a frontend
        build. Gated on _serving, which serve_start sets before its first
        build, so no feed runs unlocked beside that build."""
        return self._serve_lock if self._serving else contextlib.nullcontext()

    def feed(self, i: int, text: str, parse_commands: bool = False) -> None:
        with span("feed", session=i, what="feed", elems=0), \
                self._feed_lock():
            self.sessions[i].feed(text, parse_commands=parse_commands)

    def flush(self, i: Optional[int] = None) -> None:
        with span("feed", session=i, what="flush", elems=0), \
                self._feed_lock():
            for s in (self.sessions if i is None else [self.sessions[i]]):
                s.flush()

    def _prepare_tick(self, samples=None) -> dict:
        """Host frontend + (cached) device upload for one tick of `samples`
        (default one block).

        Fast path: while every session's position is below its proven quiet
        horizon and no session has mutated since the device inputs were
        validated, the maintenance loop is a no-op, and the check is one
        integer compare (pool._mut, bumped by every revision)."""
        blk = self.block if samples is None else int(samples)
        q = self._quiet
        if (q is not None and q[1] == blk and q[4] == self.pin_elems
                and self._mut == self._quiet_mut
                and self._local[0]._jitter_pos <= q[0]):
            annotate(full=False)
            return self._dev
        annotate(full=True)
        self._quiet = None
        dev = self._prepare_tick_full(blk)
        # arm AFTER the full pass: maintenance itself bumps revs (rebases)
        self._quiet_mut = self._mut
        return dev

    def _prepare_tick_full(self, blk: int) -> dict:
        """The full maintenance + upload pass behind _prepare_tick."""
        local = self._local
        E = max(16, _bucket(self.pin_elems)) if self.pin_elems else 16
        for s in local:
            s._ensure_audio_horizon(blk)
            s._rebase()
            s._maybe_rebase_jitter(blk)
            E = max(E, _bucket(len(s._elements)))
        inc = float(local[0].voice.jitter_frequency)
        cells = 16
        for s in local:
            cells = max(cells, s._jitter_cells(blk))
        # relative to the first owned session: all sessions advance in
        # lockstep, but their absolute positions may differ after a
        # session-level restore
        self._quiet = (local[0]._jitter_pos
                       + min(s._quiet_horizon(blk) - s._jitter_pos
                             for s in local),
                       blk, E, cells, self.pin_elems)

        key = (E, tuple(s._rev for s in local),
               tuple(id(s.voice) for s in local))
        lat_key = (cells, tuple(s._lattice.version for s in local))
        if key == self._cache_key and lat_key == self._lat_key:
            return self._dev      # steady state: nothing to upload
        if lat_key != self._lat_key:
            self._upload_lattices(cells, lat_key)
        if key != self._cache_key or self._dev is None:
            self._upload_scores(E, key, inc)
        self._dev["lat"] = self._lat_dev
        self._dev["lat_base"] = self._lat_base_dev
        return self._dev

    def _upload_rows(self, group: Optional[dict], changed, build,
                     rows_tally: str) -> dict:
        """The upload rule of both table groups (the scores with the
        offsets, the lattices with lat_base), each a dict of [nl, ...]
        device tensors. `changed` lists the local sessions whose rows moved,
        or is None when the group's structure moved (its first upload, a new
        E or cell count). `build(sessions)` gives those sessions' rows as a
        dict of device tensors.

        Only the changed sessions' rows are built, and they are scattered
        into the group with index_copy_, however many changed (all of them
        too: the scatter is one device copy of the group); when the
        structure moved, every session's rows are built and become the
        group. While serving the scatter goes into a copy of the group: a
        set that was published may still be read by a queued served
        tick."""
        nl = len(self._local)
        whole = not changed
        idx = range(nl) if whole else changed
        rows = build([self._local[i] for i in idx])
        tally(**{rows_tally: len(idx)}, full_uploads=int(whole))
        if whole:
            return rows
        if self._serving:
            group = dict(group, **{k: group[k].clone() for k in rows})
        index = _up(changed, self.device, torch.int64)
        for k, r in rows.items():
            group[k].index_copy_(0, index, r)
        return group

    def _upload_lattices(self, cells: int, lat_key) -> None:
        """Publish the lattice windows and lat_base together
        (_upload_rows): slides change a session's lattice version; first
        sizing and a new cell count move the structure."""
        nl = len(self._local)
        prev = self._lat_key
        changed = ([i for i in range(nl) if prev[1][i] != lat_key[1][i]]
                   if (prev is not None and self._lat_dev is not None
                       and prev[0] == cells) else None)

        def build(sess):
            for s in sess:
                s._lattice.ensure(cells)
            lat = JitterLattice(*(np.stack(f) for f in zip(
                *(s._lattice.rows(cells) for s in sess))))
            rows = dict(zip(_LAT, (_up(x, self.device)
                                   for x in kf.lattice_tables(lat))))
            rows["lat_base"] = _up([s._lat_base for s in sess], self.device,
                                   torch.int32)
            return rows

        group = (None if changed is None else
                 dict(zip(_LAT, self._lat_dev), lat_base=self._lat_base_dev))
        group = self._upload_rows(group, changed, build,
                                  "lattice_rows_uploaded")
        self._lat_dev = tuple(group[k] for k in _LAT)
        self._lat_base_dev = group["lat_base"]
        # versions may have been bumped by ensure() just above
        self._lat_key = (cells, tuple(s._lattice.version
                                      for s in self._local))

    def _upload_scores(self, E: int, key, inc: float) -> None:
        """Publish the score tables, the per-session jitter deltas (par)
        and the offsets (_upload_rows). A session's rows move with its
        revision (a feed, a rebase, an idle-horizon append, a live
        [voice:]) or its voice (a direct `session.voice` assignment bumps
        no revision); a new E moves the structure."""
        local, nl = self._local, len(self._local)
        for s in local:
            if abs(s.voice.jitter_frequency - inc) >= 1e-9:
                raise ValueError("pooled sessions must share a jitter rate")
        prev = self._cache_key
        changed = ([i for i in range(nl) if prev[1][i] != key[1][i]
                    or prev[2][i] != key[2][i]]
                   if (self._dev is not None and prev is not None
                       and prev[0] == key[0]) else None)

        def build(sess):
            tabs = kf.score_tables(
                stack_scores([s._build_score(E) for s in sess]),
                _jparams([s.voice for s in sess], inc), self.sample_rate)
            rows = dict(zip(("n", "scal", "vec", "par"),
                            (_up(x, self.device) for x in tabs)))
            rows["offsets"] = _up([s._consumed_samples for s in sess],
                                  self.device, torch.int32)
            return rows

        self._dev = self._upload_rows(self._dev, changed, build,
                                      "score_rows_uploaded")
        self._dev["inc"] = float(np.float32(inc))
        self._dev["sr"] = self.sample_rate
        self._cache_key = key

    def read_block(self, sync: bool = True):
        """Advance every session by one block: returns [N, block] audio
        (numpy; the device tensor with sync=False), on a mesh this rank's
        rows [N/n_data, block]."""
        return self.read_blocks(1, sync=sync)

    def read_blocks(self, k: int = 1, sync: bool = True):
        """Advance every session by k blocks in ONE launch: returns [N,
        k*block] audio (on a mesh this rank's rows). Read-ahead trades
        k*block of latency for one launch and one host pass per k blocks;
        the state continues exactly either way, so mixing k values is
        safe."""
        with span("tick", blocks=int(k)):
            out = self._advance(int(k))
            return out.cpu().numpy() if sync else out

    def _advance(self, k: int) -> torch.Tensor:
        """Advance every session by k blocks: the host pass (span `host`),
        then the launch and the output conversion's enqueue (span
        `launch`). Returns the audio on the device."""
        if self._serving:
            raise RuntimeError("read_block() while serve mode is live would "
                               "race the real-time thread for the carried "
                               "state; use serve_tick() or serve_stop() "
                               "first")
        blk = self.block * k
        with span("host"):
            dev = self._prepare_tick(blk)
        with span("launch", program=self._program):
            out, self._sf, self._si = self._tick_program(blk)(dev, self._sf,
                                                              self._si)
            dev["offsets"].add_(blk)       # advanced on the device
        # all sessions advance in lockstep: ONE pool-level lag integer
        self._lag_samples += blk
        return out

    # -- depth-2 pipelined serving ----------------------------------------

    def collect(self):
        """The in-flight tick's audio [N, block] as numpy (None if nothing
        is in flight). Its device->host copy was started a block period
        ago (dispatch_tick), so by the sink's deadline it has normally
        landed and this returns at once."""
        prev, self._inflight = self._inflight, None
        if prev is None:
            return None
        host, event = prev
        with span("collect"):
            if event is not None:
                event.synchronize()
            return host.numpy()

    def dispatch_tick(self) -> None:
        """Launch the next tick and start its audio's device->host copy
        into pinned memory, with a CUDA event behind it; collect() returns
        it. At most one tick is in flight: dispatching with a tick still
        uncollected collects and discards it first."""
        if self._inflight is not None:
            self.collect()
        with span("tick", blocks=1):
            out = self._advance(1)
            if out.device.type != "cuda":
                self._inflight = (out, None)
                return
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(out.device))
            self._inflight = (host, event)

    def tick_pipelined(self):
        """One serving tick with a depth-2 pipeline: collects the PREVIOUS
        tick's audio [N, block], then dispatches this tick. Exactly one
        extra block of sink latency against a synchronous tick. Returns
        None on the first call; drain() fetches the last block."""
        audio = self.collect()
        self.dispatch_tick()
        return audio

    def drain(self):
        """Fetch the last in-flight pipelined tick (None if none)."""
        return self.collect()

    # -- serve mode: a frontend thread and a real-time tick ----------------
    #
    # As grail_tpu's: the frontend thread (serve_start's loop, or explicit
    # _serve_build calls) owns every host pass and publishes a swap; the
    # real-time thread's serve_tick adopts the newest swap and runs one
    # tick. The carried rows (_sf, _si) and the served offsets never ride a
    # swap: the real-time thread is their only writer while serving.
    #
    # On a card every published table set gets a CUDA graph of its own,
    # captured on the frontend thread against that set's tables and the
    # pool's fixed state and offsets buffers, so the real-time thread
    # never builds or captures: its tick is one replay (the carry launch,
    # or the xla tick's two kernels and its torch ops; the state written
    # back, the offsets advanced, the output conversion) and one copy of
    # the audio out of the graph's buffer. A published set
    # is never written again (the frontend scatters into copies, see
    # _upload_rows), so a queued replay cannot read a half-applied feed;
    # a new set costs a device copy of the group that changed and one
    # capture. The other design, one graph over fixed tables with each
    # published set copied into them at adoption, would put a copy of the
    # whole group (the 35.6 MB of lattices at N = 512, E = 64, 60 s
    # windows) on the real-time path at every adoption.
    #
    # The frontend's device work (uploads, copies, scatters) and the ticks
    # share the device's default stream; only the capture runs on a side
    # stream, where it records and launches nothing. Stream order then
    # puts a set's writes before the first tick that reads it, and the
    # caching allocator reuses a dropped set's memory only after the ticks
    # queued before the drop, so an adoption is a pointer swap and one
    # copy of the offsets: no event to wait on, no record_stream. The cost
    # is that a large upload of the frontend (a whole lattice group) sits
    # in the stream between two ticks. grail_tpu's warm-up of its scatter
    # shapes has no counterpart: index_copy_ compiles nothing.

    def _serve_build(self) -> bool:
        """Frontend cycle: sync the session counters to the real-time tick
        clock, run the host pass (_prepare_tick) and, when its inputs
        changed, publish a swap; on a card the swap carries the graph
        captured for it. Returns whether it published.

        Runs only on the frontend thread (and in serve_start). The publish
        key commits only once the swap is ready: a failed capture raises
        and leaves the key, so the next cycle retries the publish."""
        t_snap = self._serve_ticks          # one int read, GIL-atomic
        blk = self.block
        with self._serve_lock:
            # every session advances in lockstep: one lag integer
            self._lag_samples += (t_snap - self._serve_synced) * blk
            self._serve_synced = t_snap
            dev = self._prepare_tick(blk)
            pub_key = (self._cache_key, self._lat_key)
            if pub_key == self._serve_pub_key:
                return False                # steady state: nothing changed
            off = torch.empty(len(self._local), dtype=torch.int32,
                              pin_memory=self._impl == "kernel")
            off.numpy()[:] = [s._consumed_samples for s in self._local]
            swap = dict(dev={k: v for k, v in dev.items() if k != "offsets"},
                        off_host=off, snap_ticks=t_snap)
            if self._impl == "kernel":
                self._serve_capture(swap)
            self._serve_pub_key = pub_key
        with self._swap_lock:
            self._swap_pending = swap       # the newest publish wins
        return True

    def _serve_capture(self, swap: dict) -> None:
        """Capture the served tick over `swap`'s tables as a CUDA graph on
        the capture stream, in the thread-local capture mode so that the
        real-time thread and the sinks go on launching and copying
        meanwhile. The graph writes the pool's fixed state and offsets; its
        audio lands in a buffer of its own (swap['out']). Every graph of
        the pool allocates from one memory pool: they replay one at a time
        on one stream, and each one's output is copied out after its
        replay."""
        g = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self._capture_stream):
            g.capture_begin(pool=self._serve_mempool,
                            capture_error_mode="thread_local")
            try:
                out = _served_tick(self._tick_program(self.block),
                                   swap["dev"], self._sf, self._si,
                                   self._serve_off, self.block)
            finally:
                g.capture_end()
        swap.update(graph=g, out=out)
        self._serve_captures += 1

    def serve_start(self, period: Optional[float] = None) -> None:
        """Start the serving frontend; serve_tick() becomes real-time safe.

        `period` is the frontend cycle time (default: one block period).
        The first build and publish happen here and, on a card, the kernel
        library's build, one eager tick on copies of the state (it
        configures the kernel, makes the Lehmer table and loads every
        kernel the tick runs, none of which may happen inside a capture)
        and the first capture, so the first serve_tick() replays at once.
        Feeds remain allowed from any thread: they take the frontend lock,
        which the real-time path never takes."""
        if self._serve_thread is not None:
            return
        on_card = self._impl == "kernel"
        if on_card:
            from ..synth._build import load_library

            load_library()
            self._capture_stream = torch.cuda.Stream(self.device)
            self._serve_mempool = torch.cuda.graph_pool_handle()
        self._serve_off = torch.zeros(len(self._local), dtype=torch.int32,
                                      device=self.device)
        self._swap_pending = self._serve_cur = self._serve_pub_key = None
        self._serve_error = None
        self._serve_ticks = self._serve_synced = 0
        self._serve_stop_flag = False
        self._serving = True                # gates _feed_lock from here on
        try:
            if on_card:
                with self._serve_lock:
                    dev = self._prepare_tick()
                    _served_tick(self._tick_program(self.block), dev,
                                 self._sf.clone(), self._si.clone(),
                                 dev["offsets"].clone(), self.block)
                    torch.cuda.synchronize(self.device)
            self._serve_build()             # the first publish
        except BaseException:
            self._serving = False
            raise
        period = float(period) if period else self.block / self.sample_rate

        def loop():
            while not self._serve_stop_flag:
                t0 = time.perf_counter()
                try:
                    self._serve_build()
                except Exception as e:      # handed to the real-time thread
                    self._serve_error = e
                deadline = t0 + period
                while not self._serve_stop_flag:
                    dt = deadline - time.perf_counter()
                    if dt <= 0:
                        break
                    time.sleep(min(dt, 0.05))

        self._serve_thread = threading.Thread(
            target=loop, name="StreamPool-frontend", daemon=True)
        self._serve_thread.start()

    def _serve_adopt(self, swap: dict) -> None:
        """Adopt a published swap: its tables (and graph), with the offsets
        of its snapshot plus the blocks served since it was taken, copied
        to the device from pinned memory."""
        off = swap["off_host"]
        o = off.numpy()
        o += (self._serve_ticks - swap["snap_ticks"]) * self.block
        self._serve_off.copy_(off, non_blocking=True)
        self._serve_cur = swap

    def serve_tick(self) -> torch.Tensor:
        """Real-time dispatch: adopt the newest published set (if any) and
        run one tick. Returns the [N, block] audio (on a mesh this rank's
        rows) on the pool's device
        (int16 with output='pcm16', uint8 with 'ulaw'), a tensor of its own
        that later ticks do not overwrite, as read_block(sync=False)
        returns: on a card the graph's output buffer is copied out after
        each replay (one device copy), so a sink may hold any number of
        ticks in flight.

        On a card the tick is one replay of the adopted set's CUDA graph,
        counted as the launches it holds (one fused_synth_carry, or on the
        xla tick one carrier_scan and one jsched_scan), on the device's default
        stream, where the frontend's device work runs too: call it with
        that stream current (as a thread has unless it set another). A
        failed replay raises, and so does the next serve_tick after a
        failed frontend cycle. Nothing here waits on the frontend: adoption
        is a pointer swap under a lock held for as long and one [N] int32
        copy of the offsets from pinned memory; a steady tick copies
        nothing from the host."""
        if not self._serving:
            raise RuntimeError("serve_tick() needs serve_start() first")
        err, self._serve_error = self._serve_error, None
        if err is not None:
            raise RuntimeError("the serving frontend failed") from err
        with self._swap_lock:
            swap, self._swap_pending = self._swap_pending, None
        if swap is not None:
            self._serve_adopt(swap)
        cur = self._serve_cur
        if self._impl == "kernel":
            cur["graph"].replay()
            for name in _TICK_LAUNCHES[self._program]:   # the launches it
                kf.LAUNCHES[name] += 1                   # holds
            out = cur["out"].clone()
        else:
            out = _served_tick(self._tick_program(self.block), cur["dev"],
                               self._sf, self._si, self._serve_off,
                               self.block)
        self._serve_ticks += 1
        return out

    def serve_stop(self) -> None:
        """Stop the frontend thread and resync the session counters, so
        that read_block, save and load_state continue from the served
        position."""
        th = self._serve_thread
        if th is None:
            return
        self._serve_stop_flag = True
        th.join(timeout=30)
        if th.is_alive():
            # tearing serve state down under a live frontend would let it
            # write counters and tables beside the non-serving calls
            raise RuntimeError(
                "serving frontend thread did not stop within 30 s (stalled "
                "build?); serve state left intact; retry serve_stop()")
        self._serve_thread = None
        self._serving = False
        with self._serve_lock:
            self._lag_samples += ((self._serve_ticks - self._serve_synced)
                                  * self.block)
            self._serve_synced = self._serve_ticks
        # the served offsets advanced on the device: drop the upload caches
        # and the quiet fast path (which would return the stale _dev), so
        # the next read_block rebuilds from the host counters; the graphs
        # go with their sets
        self._cache_key = self._lat_key = None
        self._quiet = None
        self._swap_pending = self._serve_cur = None
        self._capture_stream = self._serve_mempool = None

    # -- pool-level checkpoint / restore -----------------------------------
    #
    # ONE payload captures all N sessions (rolling scores, counters, lattice
    # continuations) plus the stacked device state, fetched in one
    # device->host copy, with grail_tpu's keys: a JAX pool's blob loads here.
    # On a mesh each rank packs the sessions it owns and save() gathers the
    # packs over the mesh, on the caller's thread (serve mode refuses both
    # calls, so no collective meets a serving thread's work).

    def save(self) -> bytes:
        if self._serving:
            # the counters sync only at frontend cycles while the real-time
            # thread writes the carried rows every tick: a checkpoint taken
            # now would pair stale counters with a newer state
            raise RuntimeError(
                "StreamPool.save() while serve mode is live would snapshot "
                "a torn state; call serve_stop() first")
        if self._inflight is not None:
            self.drain()   # a checkpoint must not orphan an in-flight tick
        sf, si = self._sf.cpu().numpy(), self._si.cpu().numpy()
        own = {}
        for r, s in enumerate(self._local):
            for k, v in s._payload_dict(_host_state(sf[r], si[r])).items():
                own[f"s{self._lo + r}_{k}"] = v
        parts = {"pool_meta": np.array([self.n, self.block], np.int64)}
        if self.mesh is None:
            parts.update(own)
        else:
            from ..parallel.sharded import _row_objects

            for row in _row_objects(own, self.mesh):   # in session order
                parts.update(row)
        buf = io.BytesIO()
        np.savez(buf, **parts)
        return buf.getvalue()

    def load(self, payload: bytes) -> None:
        if self._serving:
            # the real-time thread would go on ticking the adopted set over
            # the restored state
            raise RuntimeError(
                "StreamPool.load() while serve mode is live would be "
                "clobbered by the real-time thread; call serve_stop() first")
        z = np.load(io.BytesIO(payload))
        n, block = (int(x) for x in z["pool_meta"])
        if n != self.n:
            raise ValueError(f"payload has {n} sessions, pool has {self.n}")
        if block != self.block:
            raise ValueError(
                f"payload block={block}, pool block={self.block}")
        for i, s in enumerate(self.sessions):
            if s._ghost:        # its grammar state, for raising in step
                key = f"s{i}_pending_cmd"
                s._pending_cmd = (bytes(z[key]).decode() if key in z.files
                                  else "")
            else:
                s._apply_payload(z, prefix=f"s{i}_")
        # one stacked state replaces the whole device state; the carried
        # jitter states were rebuilt from the restored counters
        self._sf = torch.cat([s._sf for s in self._local]).to(self.device)
        self._si = torch.cat([s._si for s in self._local]).to(self.device)
        self._cache_key = None
        self._lat_key = None
        self._inflight = None
        self._quiet = None


def _mesh_place(mesh, n: int, backend: str, device):
    """A mesh pool's device and the range of sessions this rank owns,
    after grail_tpu's mesh rules (a fused backend, n divisible by the
    'data' axis) and the device's: the mesh's, which an explicit `device`
    must name."""
    from ..parallel.sharded import _mesh_device, _shard

    sh = _shard(mesh)
    if _BACKENDS[backend] != "fused":
        raise ValueError("a mesh-sharded StreamPool needs the fused tick "
                         f"(backend {backend!r}; a block that is not a "
                         f"multiple of {kf.CHUNK} selects 'xla')")
    if n % sh.n_data:
        raise ValueError(f"n={n} sessions must divide over the mesh's "
                         f"'data' axis ({sh.n_data})")
    dev = _resolve_device(_mesh_device(mesh))
    if device is not None:
        want = torch.device(device)
        if want.type != dev.type or want.index not in (None, dev.index):
            raise ValueError(f"device={want} disagrees with the mesh's "
                             f"device {dev}")
    k = n // sh.n_data
    return dev, (sh.d * k, (sh.d + 1) * k)


__all__ = ["StreamSession", "StreamPool", "ulaw_decode"]
