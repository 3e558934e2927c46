"""Entry `pool`: grail_tpu_torch.runtime.stream.StreamPool, N live sessions
ticked back to back by one caller.

The caller holds one continuous voice per session, as a streaming service
does: it calls `tick_pipelined()` back to back, one block of every session
a tick, each tick's [N, block] audio (the configuration's output format)
reaching the host inside the window, and `drain()` at the window's end.
Before each tick, every session whose queued audio (`pending_seconds`) has
dropped under the mix's `feed_below_s` gets its next sentence with
`feed(i, text)` then `flush(i)`, so that no session runs dry. The feeder
reads a session's queued audio once, after each feed, and from it the tick
at which that session falls under the threshold (a tick plays one block
and nothing else moves what is queued), where it reads it again before
feeding: O(feeds) work a tick, not O(N).

Set-up imports the port, builds its libraries (first run in a checkout),
draws the sessions that the check keeps and their seeds from the run's
seed, generates the texts (the cell's `texts` a session: a seeded order of
64-quantile groups of the mix, so the lengths keep the mix's quantiles;
a session that speaks them all starts its list again, and the result's
check row `text_repeats` counts those feeds), constructs the pool with
`pin_elems` the count of elements that two of the run's longest sentences
make, feeds and flushes every session's first sentence, and runs the
cell's `warm_ticks` ticks with the feeder, then drains.

End to end: `batch_xrt`, the seconds of audio of every session delivered
to the host over the wall seconds of the window, which runs until the last
tick dispatched in it is drained. `attempted` and `failed` count session
blocks dispatched in the window and not delivered.

The check: the sessions drawn before set-up keep their rows of every tick
from position 0 (set-up's included) up to KEPT_SECONDS of audio, and the
texts they were fed; after the window each is held against
reference/stream.py, which renders the same texts in feed order from the
session's seed, as 16-bit PCM: `audio_gap` in units of full scale (32767).
"""

from __future__ import annotations

import heapq
import sys
import time

import numpy as np
import torch

from .. import compare
from ..trace import phase
from ..traffic import generator

CHECKED = 6            # sessions compared after the window
KEPT_SECONDS = 180.0   # of each one's audio, from position 0


class Entry:
    def __init__(self, cell, seed: int, device, fault=None, seconds=None):
        self.cell, self.seed, self.dev = cell, int(seed), torch.device(device)
        self.fault = fault
        self.cfg, self.mix = cell.config, cell.mix
        self.n = int(self.cfg["sessions"])
        self.block = int(self.cfg["block"])
        self.sr = float(self.cfg["sample_rate"])
        self.below = int(round(float(self.mix["feed_below_s"]) * self.sr))

    def _rng(self, stream: int):
        s = self.seed
        return np.random.default_rng([s & 0xFFFFFFFF, s >> 32, stream])

    def setup(self):
        from grail_tpu_torch.runtime.stream import StreamPool

        from ..reference.stream import elements

        cfg, N = self.cfg, self.n
        rng = self._rng(5)
        self.kept_ids = sorted(int(i) for i in rng.choice(
            N, size=min(CHECKED, N), replace=False))
        self.seeds = [int(s) for s in rng.integers(0, 2 ** 31, size=N)]
        K = int(self.cell.texts)
        G = int(self.mix["batch"])
        groups = generator.batches(self.mix, self.seed, -(-N * K // G))
        flat = [t for g in groups for t in g]
        order = rng.permutation(len(flat))[:N * K]
        self.seq = [[flat[j] for j in order[i * K:(i + 1) * K]]
                    for i in range(N)]
        # E is pinned to what a session holding two of the longest
        # sentences needs, so that it does not change in the window
        top = max(len(t.split()) for t in flat)
        longest = max(len(elements([t], cfg["voice"], cfg["language"]))
                      for t in flat if len(t.split()) == top)
        self.pin = 2 * longest
        print(f"portbench: pool of {N}, pin_elems {self.pin} (the longest "
              f"sentence, {top} words, {longest} elements)", file=sys.stderr)
        self.pool = StreamPool(
            N, voice=cfg["voice"], language=cfg["language"],
            block=self.block, output=cfg["output"], seeds=self.seeds,
            pin_elems=self.pin, jitter_horizon_s=cfg["jitter_horizon_s"],
            device=self.dev)
        self.kept_rows = {i: [] for i in self.kept_ids}
        self.fed = {i: [] for i in self.kept_ids}
        self.keep_samples = int(KEPT_SECONDS * self.sr)
        self.next_text = [0] * N
        self.repeats = 0
        self.collected = 0            # ticks whose audio reached the host
        self.k = 0                    # ticks dispatched
        self.due = []
        for i in range(N):
            self._feed(i)
        for _ in range(int(self.cell.warm_ticks)):
            self._tick()
        self._take(self.pool.drain())

    def _feed(self, i: int):
        """Feed session i its next text, and schedule its next feed at the
        first tick before which its queued audio is under the threshold."""
        j = self.next_text[i]
        text = self.seq[i][j % len(self.seq[i])]
        self.repeats += j >= len(self.seq[i])
        self.next_text[i] = j + 1
        if self.fault is None or self.fault.feed(i, j):
            self.pool.feed(i, text)
            self.pool.flush(i)
        if i in self.fed:
            self.fed[i].append(text)
        self._schedule(i)

    def _schedule(self, i: int):
        queued = int(round(self.pool.sessions[i].pending_seconds * self.sr))
        m = max(0, (queued - self.below) // self.block + 1)
        heapq.heappush(self.due, (self.k + m, i))

    def _feeder(self):
        """The feeds due before tick self.k."""
        while self.due and self.due[0][0] <= self.k:
            _, i = heapq.heappop(self.due)
            if self.pool.sessions[i].pending_seconds * self.sr < self.below:
                self._feed(i)
            else:                   # not under it yet: read it again later
                self._schedule(i)

    def _take(self, audio):
        """Keep the kept sessions' rows of a tick that reached the host."""
        if audio is None:
            return
        t = self.collected
        self.collected += 1
        if t * self.block >= self.keep_samples:
            return
        rows = audio[self.kept_ids].copy()
        if self.fault is not None:
            rows = self.fault.rows(t, rows)
        for r, i in enumerate(self.kept_ids):
            self.kept_rows[i].append(rows[r])

    def _tick(self):
        self._feeder()
        audio = self.pool.tick_pipelined()
        self.k += 1
        self._take(audio)

    def window(self, seconds: float, traced: bool):
        k0, c0 = self.k, self.collected
        r0 = self.repeats
        t0 = time.perf_counter()
        if traced:
            from grail_tpu_torch.runtime import trace

            trace.clear()           # the readers read this window's spans
            while time.perf_counter() - t0 < seconds:
                with phase("feeder"):
                    self._feeder()
                with phase("tick"):
                    audio = self.pool.tick_pipelined()
                self.k += 1
                self._take(audio)
            with phase("tick"):
                self._take(self.pool.drain())
        else:
            while time.perf_counter() - t0 < seconds:
                self._tick()
            self._take(self.pool.drain())
        self.t_window = time.perf_counter() - t0
        self.ticks = self.k - k0
        self.delivered = self.collected - c0
        self.window_repeats = self.repeats - r0
        self.traced = traced

    def records(self) -> dict:
        rec = {"entry": "pool", "window_s": self.t_window,
               "ticks": self.ticks,
               "samples": self.delivered * self.n * self.block,
               "output": self.cfg["output"]}
        if self.traced:
            from grail_tpu_torch.runtime import trace

            rec["port_spans"] = trace.spans()
        return rec

    def finish(self):
        pool = self.pool
        print(f"portbench: {self.ticks} ticks in the window, "
              f"{self.delivered} delivered, E {pool._cache_key[0]} (pin "
              f"{self.pin}), {self.window_repeats} repeated texts",
              file=sys.stderr)

    def end_to_end(self) -> dict:
        audio_s = self.delivered * self.n * self.block / self.sr
        return {"batch_xrt": (audio_s / self.t_window, "s/s")}

    def counts(self):
        return self.ticks * self.n, (self.ticks - self.delivered) * self.n

    def verify(self, control=None):
        """Check rows; with `control` (a torch dtype) the answers are the
        reference's own, computed in that precision, in the program's
        place (the control of the comparison)."""
        from ..reference.stream import render_stream

        v, lang = self.cfg["voice"], self.cfg["language"]
        gaps = []
        for i in self.kept_ids:
            got = (np.concatenate(self.kept_rows[i])[:self.keep_samples]
                   if self.kept_rows[i] else np.zeros(0, np.int16))
            args = (self.fed[i], self.seeds[i], v, lang, self.dev, len(got))
            ref = render_stream(*args)
            answer = got if control is None else render_stream(
                *args, dtype=control)
            gaps.append(compare.gap(answer / 32767.0, ref / 32767.0))
        self.gaps = gaps
        return compare.rows(gaps, self.cell.limits) + [
            ("text_repeats", self.repeats, None, True)]

