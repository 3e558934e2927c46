"""Text -> phoneme transcription: greedy longest-prefix find-and-replace.

This ports the exact automaton of the reference Transcriber
(grail-rs src/lib.rs:1098-1207), whose observable semantics are pinned
by six unit tests there (src/lib.rs:1210-1358) and re-pinned by ours:

  * incremental binary search narrows a [min, max) range over the *sorted*
    ruleset one character at a time (two partition_point calls per char);
  * on range collapse: if the lexicographically-smallest rule of the previous
    range exactly equals the consumed prefix, emit its phonemes (the breaking
    char is NOT consumed); otherwise emit SILENCE and consume one char —
    note this swallows the whole dead-end prefix, there is no backtracking;
  * at end of input: emit the exact-prefix rule if one exists, else SILENCE;
  * rules can emit multiple phonemes (buffered).

Transcription is host-side preprocessing (variable-length, data-dependent):
the device pipeline consumes its fixed-shape output (phoneme id arrays).
In this frozen copy `transcribe` always runs the Python automaton (the
port runs its native C++ twin, bit-equal, on ASCII text).
"""

from __future__ import annotations

from typing import Iterable, Iterator, List

from .language import Language
from .phonemes import Phoneme


def _partition_point(rules, lo: int, hi: int, pred) -> int:
    """Rust's <[T]>::partition_point on rules[lo:hi]: first index where pred
    is false, found by binary search (identical probe order to Rust std)."""
    left, right = lo, hi
    while left < right:
        mid = (left + right) // 2
        if pred(rules[mid]):
            left = mid + 1
        else:
            right = mid
    return left


def _nth_char(s: str, i: int):
    return s[i] if i < len(s) else None


def transcribe_chars(chars: Iterable[str], language: Language) -> Iterator[Phoneme]:
    """Lazy char -> Phoneme iterator with reference semantics."""
    rules = language.rules
    case_sensitive = language.case_sensitive
    it = iter(chars)
    peeked: List[str] = []  # 0- or 1-element lookahead buffer

    def peek():
        if not peeked:
            try:
                peeked.append(next(it))
            except StopIteration:
                return None
        return peeked[0]

    def advance():
        if peeked:
            peeked.pop()
        else:
            try:
                next(it)
            except StopIteration:
                pass

    if not rules:
        # degenerate: every char becomes silence
        while peek() is not None:
            advance()
            yield Phoneme.SILENCE
        return

    while True:
        search_min, search_max = 0, len(rules)
        index = 0
        buffer = None
        while buffer is None:
            c = peek()
            if c is None:
                return  # reference: peek fails at loop top -> iterator ends
            if not case_sensitive:
                c = c.lower() if c.isascii() else c  # to_ascii_lowercase

            new_min = _partition_point(
                rules, search_min, search_max,
                lambda r: (_nth_char(r.string, index) or "") < c
                if _nth_char(r.string, index) is not None else True,
            )
            new_max = _partition_point(
                rules, search_min, search_max,
                lambda r: _nth_char(r.string, index) is not None
                and _nth_char(r.string, index) <= c,
            )

            if new_min >= new_max and len(rules[search_min].string) == index:
                buffer = rules[search_min].phonemes
            elif new_min >= new_max:
                buffer = (Phoneme.SILENCE,)
                advance()  # garbled char is consumed
            else:
                search_min, search_max = new_min, new_max
                index += 1
                advance()
                if peek() is None and len(rules[search_min].string) == index:
                    buffer = rules[search_min].phonemes
                elif peek() is None:
                    buffer = (Phoneme.SILENCE,)
        yield from buffer


def transcribe_partial(text: str, language: Language):
    """Incremental transcription: run the automaton over `text` but emit only
    matches that do NOT depend on end-of-input — a trailing (possibly
    extendable) partial match is held back. Returns (phonemes, consumed):
    the caller keeps text[consumed:] and re-feeds it with more input later.

    This is how a streaming frontend consumes the greedy longest-match
    automaton without mis-splitting multi-character rules across feed
    boundaries (the EOF fallbacks at src/lib.rs:1171-1179 only apply when
    the input is truly final — see flush()).
    """
    rules = language.rules
    case_sensitive = language.case_sensitive
    out: List[Phoneme] = []
    pos = 0
    n = len(text)

    if not rules:
        return [Phoneme.SILENCE] * n, n

    while True:
        start = pos
        search_min, search_max = 0, len(rules)
        index = 0
        while True:
            if pos >= n:
                return out, start  # mid-match at end of buffer: hold back
            c = text[pos]
            if not case_sensitive:
                c = c.lower() if c.isascii() else c

            new_min = _partition_point(
                rules, search_min, search_max,
                lambda r: (_nth_char(r.string, index) or "") < c
                if _nth_char(r.string, index) is not None else True,
            )
            new_max = _partition_point(
                rules, search_min, search_max,
                lambda r: _nth_char(r.string, index) is not None
                and _nth_char(r.string, index) <= c,
            )

            if new_min >= new_max and len(rules[search_min].string) == index:
                # exact-prefix rule; could it extend with more input? only if
                # the previous range still held longer rules — but the range
                # collapsed on THIS char, so the match is final. Emit; the
                # breaking char stays (matches the reference automaton).
                out.extend(rules[search_min].phonemes)
                break
            elif new_min >= new_max:
                out.append(Phoneme.SILENCE)
                pos += 1  # dead end consumes the garbled char
                break
            else:
                search_min, search_max = new_min, new_max
                index += 1
                pos += 1
                # NOTE: no EOF fallback here — that's the held-back case
    # unreachable


def transcribe(text: str, language: Language, leading_silence: bool = True,
               prefer_native: bool = True) -> List[Phoneme]:
    """Transcribe a whole string to a phoneme list.

    `leading_silence=True` matches the reference's public pipeline: its
    IntoTranscriber::transcribe initializes the phoneme buffer to [Silence]
    (src/lib.rs:1197-1204), so every utterance starts with one SILENCE
    phoneme. The raw automaton (reference unit tests construct the
    Transcriber with an empty buffer) is `transcribe_chars`.

    Here every text runs the Python automaton; `prefer_native` is kept
    for the port's signature and ignored.
    """
    out = [Phoneme.SILENCE] if leading_silence else []
    out.extend(transcribe_chars(text, language))
    return out


__all__ = ["transcribe", "transcribe_chars", "transcribe_partial"]
