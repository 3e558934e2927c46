"""Spans of the batch path and the pool, on the host clock and the profiler's.

How to see them: run the calls under `torch.profiler.profile` (CPU and,
on a card, CUDA activities), export the Chrome trace
(`prof.export_chrome_trace(path)`) and open it in Perfetto or
chrome://tracing. Each span is a `grail.<name>` row on the calling thread,
above the device rows, so a gap on the device lines up with the host stage
that left it; on a card the profiler also draws the innermost span over the
device operations it launched (`tables`' upload, `launch`'s kernels).
Nothing is recorded while no profiler records, nor on a thread the
profiler does not follow (it follows the thread that started it): `span`
then costs one check and hands back a shared no-op context.

The spans of the batch path (`api.py`), at most eight a call:

  * `batch`     `synthesize_batch`, the whole call (attribute `B`);
  * `frontend`  its host frontend: `text_to_phoneme_elems` and
                `score_from_phoneme_elems` over the texts (those functions
                called on their own record nothing), with the drift
                countdown's `drift_steps` (explicit float32 steps) and
                `drift_samples` (samples counted), which
                `native.native_drift_boundaries` adds up over the texts;
  * `prep`      the frontend's end to the call's return: `synthesize_scores`
                (padding, `route`, the program, the output slices), with the
                route's `carrier`, `S` and `T`, and on the split exact
                carrier (`carrier` 'kcar', S > 1) `kcar_seam_samples`, the
                lane-samples the seam pre-pass stepped (B times its last
                seam); a root of its own when `synthesize_scores` is called
                directly;
  * `track`     in `prep`, for one utterance that takes the host carrier
                track (`api._carrier_track_for`): the memo's look-up and, on
                a miss, the native pre-pass, with the track's `samples` and
                `hit` (whether the memo held it), and on a miss
                `track_chain_samples`, the samples that
                `native.native_carrier_track` produced;
  * `lattices`  in `prep`: the jitter lattices, one `build_lattice` a seed;
  * `tables`    in `prep`: `build_tables`, the host tables and their upload;
  * `schedule`  in `prep`: the jitter schedule's window on the device
                (`device_window`; `hit` says whether its cache held it);
  * `launch`    in `prep`: the program's enqueue (`synth_fused`, or the
                split's lanes, its seam pre-pass (kernel 2 for Q32,
                kcar_seam.cu for the exact carrier) and kernel 1).

The fused backend opens all four of `prep`'s spans; the core, xla and scan
backends only `lattices`.

The spans of the pool (`runtime/stream.py`'s StreamPool), four a pipelined
tick (nine on the xla tick) and two a fed text:

  * `tick`      a root: `read_blocks` (attribute `blocks`), or
                `dispatch_tick` (its block, the pinned host buffer and the
                copy's enqueue);
  * `host`      in `tick`: `_prepare_tick`, the host pass, with `full`
                (whether the per-session maintenance pass ran, or the one
                compare of the quiet fast path) and, from the full pass, the
                tallies `score_rows_uploaded` and `lattice_rows_uploaded`
                (sessions whose rows went to the device), `full_uploads`
                (uploads of every session's rows, scores and lattices
                counted apart) and `rebases` (sessions that dropped played
                elements);
  * `launch`    in `tick`: the tick program's enqueue (the carry launch, or
                the xla tick, and the output conversion) and the offsets'
                advance, with the tick's `program` ('fused', the carry
                tick, or 'xla');
  * `collect`   a root: the wait on the previous tick's copy event and the
                audio handed out;
  * `feed`      a root: `StreamPool.feed` (`what` 'feed') or `flush`
                (`what` 'flush'), with the `session` (None: every one) and
                `elems`, the elements the frontend appended (after the
                glide merge; `StreamSession._append_phonemes` tallies them).

On the xla tick (`stream._xla_tick`) `launch` holds five stages, once a
tick each, in this order (the carry tick records none):

  * `jsched`    the jitter recurrence, `seq_scan.jsched_scan`;
  * `frames`    the sequencer (`expand_score` at the sessions' offsets) and
                the jitter (`apply_jitter` at the lattice windows' rows);
  * `carrier`   the carried state unpacked and the f32 carrier,
                `seq_scan.carrier_scan`;
  * `core`      the associative-scan core, `synthesize._block_core`;
  * `pack`      the new state packed back into the carry mode's rows.

They are `stage`s: recorded only inside a span open on the same thread,
so a solo session's read, which opens none, records no stage.

Serve mode's frontend cycles and replays record no span (its feeds do),
and its captures of the xla tick no stage.

Besides the profiler's rows, each span is kept in a bounded buffer as a
`Span`: the call it belongs to (every span under one root shares the root's
call id), its name, its parent's name (None for a root), its start and end
(`time.perf_counter_ns`) and its attributes. `spans()` copies the buffer
and `clear()` empties it; the oldest spans fall out past `MAXLEN`.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from typing import NamedTuple, Optional

import torch

MAXLEN = 1 << 16      # spans kept (a 51-s window: ~2k of 64-text calls,
#                       15-17k of pool ticks and feeds at N = 768 on the
#                       carry tick; on the xla tick nine spans a tick)
PREFIX = "grail."

_recording = torch.autograd._profiler_enabled
_buffer: deque = deque(maxlen=MAXLEN)
_local = threading.local()
_calls = itertools.count(1)
_OFF = contextlib.nullcontext()


class Span(NamedTuple):
    call: int
    name: str
    parent: Optional[str]
    start_ns: int
    end_ns: int
    attrs: dict


class _Open:
    """One open span: a profiler range and its in-memory record."""

    __slots__ = ("name", "attrs", "call", "parent", "_range", "_start")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _stack()
        if stack:
            self.call, self.parent = stack[-1].call, stack[-1].name
        else:
            self.call, self.parent = next(_calls), None
        stack.append(self)
        self._range = torch.profiler.record_function(PREFIX + self.name)
        self._range.__enter__()
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self._range.__exit__(*exc)
        _stack().pop()
        _buffer.append(Span(self.call, self.name, self.parent, self._start,
                            end, self.attrs))
        return False


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, **attrs):
    """A context that records the span `name` while a profiler records, and
    does nothing otherwise."""
    if not _recording():
        return _OFF
    return _Open(name, attrs)


def stage(name: str, **attrs):
    """As `span`, but recorded only inside a span open on this thread: a
    stage of a larger step, which records nothing where that step is run
    without its enclosing span."""
    if not _recording() or not getattr(_local, "stack", None):
        return _OFF
    return _Open(name, attrs)


def annotate(**attrs):
    """Add attributes to the innermost span open on this thread, if any."""
    stack = getattr(_local, "stack", None)
    if stack:
        stack[-1].attrs.update(attrs)


def tally(**counts):
    """Add counts to the attributes of the innermost span open on this
    thread, if any (an attribute not set yet starts at 0)."""
    stack = getattr(_local, "stack", None)
    if stack:
        attrs = stack[-1].attrs
        for key, n in counts.items():
            attrs[key] = attrs.get(key, 0) + n


def spans() -> list:
    """The recorded spans, oldest first (a copy)."""
    return list(_buffer)


def clear():
    _buffer.clear()


__all__ = ["MAXLEN", "Span", "annotate", "clear", "span", "spans", "stage",
           "tally"]
