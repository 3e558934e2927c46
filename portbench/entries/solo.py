"""Entry `solo`: grail_tpu_torch.api.synthesize, one text a call, in a
closed loop.

One caller sends one text a call, waits for its audio, and sends the next,
as the grail-rs CLI (`-i`: one input text, one WAV) or an endpoint that
serves one request at a time does; each call's float32 audio is fetched to
the host with `.cpu()` inside the window (no WAV is written: file I/O is
left out). Set-up imports the port, builds its libraries (first run in a
checkout), generates the texts of the run from the seed (the cell's
`batches` groups of mix['batch'] texts, so that lengths keep the mix's
quantiles, sent one text at a time in order; a window that outruns them
starts over at the first) with one seed a text, and makes two warm calls
on texts of its own: the longest and the shortest of a group, so that on
the cell's mix both routes (past and under EXACT_CARRIER_AUTO_SECONDS) are
built and warm.

End to end: `batch_xrt`, as the batch entry defines it: seconds of audio on
the host over the wall seconds of the window, which runs from its start
until the last call started in it has delivered. For one caller in a closed
loop that is the audio's seconds over the sum of the calls' latencies.
`attempted` and `failed` count utterances.

The check: one text of each group, drawn from the seed before the window, is
kept; after the window a sample of them, drawn from the seed, with the
longest kept one in it, is held against reference/render.py, each text on
its own with the carrier its own length demands.
"""

from __future__ import annotations

import time

from .. import compare
from ..trace import phase
from ..traffic import generator
from . import batch


class Entry(batch.Entry):
    """The batch entry's seeds, `batch_xrt` and counts, one text a call."""

    def setup(self):
        from grail_tpu_torch import api

        self.api = api
        n_groups = int(self.cell.batches)
        groups = generator.batches(self.mix, self.seed, n_groups + 1)
        G = len(groups[0])
        rng = self._rng(3)
        seeds = rng.integers(0, 2 ** 31, size=(n_groups + 1, G))
        self.keep = rng.integers(0, G, size=n_groups)
        # the warm calls: the longest and the shortest text of a group of
        # their own (the last), never checked
        warm = sorted(zip(groups[-1], seeds[-1]),
                      key=lambda ts: len(ts[0].split()))
        for text, sd in (warm[-1], warm[0]):
            self._call(text, sd).cpu()
        self.texts = [t for g in groups[:-1] for t in g]
        self.seeds = [int(s) for row in seeds[:-1] for s in row]
        self.group = G

    def _call(self, text, seed):
        out = self.api.synthesize(text, voice=self.cfg["voice"],
                                  language=self.cfg["language"],
                                  seed=int(seed), device=self.dev)
        if self.fault is not None:
            out = self.fault(out)
        return out

    def window(self, seconds: float, traced: bool):
        sr = float(self.cfg["sample_rate"])
        self.kept, self.samples, self.spans = [], [], []
        self.done = self.sent = 0
        n = len(self.texts)
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            j = i % n
            a = time.perf_counter()
            self.sent += 1
            with phase("program"):
                out = self._call(self.texts[j], self.seeds[j])
            m = time.perf_counter()
            with phase("fetch"):
                host = out.cpu()
            e = time.perf_counter()
            self.spans += [("program", a, m), ("fetch", m, e)]
            self.samples.append(int(host.shape[-1]))
            self.done += 1
            b, k = divmod(j, self.group)
            if i < n and k == int(self.keep[b]):
                self.kept.append((j, host.numpy().copy()))
            del out, host
            i += 1
        self.t_window = time.perf_counter() - t0
        self.traced = traced
        self.audio_s = sum(self.samples) / sr

    def records(self) -> dict:
        return {"entry": "solo", "spans": self.spans,
                "window_s": self.t_window,
                "work": [{"samples": s} for s in self.samples],
                "carrier": self._carrier_kinds() if self.traced else None}

    def _kcar(self, j: int) -> bool:
        """Whether text j's semantics demand the exact f32 carrier: the
        reference's rule on that text alone."""
        from ..reference.render import exact_carrier, longest_samples

        v = self.cfg["voice"]
        return exact_carrier(longest_samples([self.texts[j]], v,
                                             self.cfg["language"]), v)

    def _carrier_kinds(self):
        """The carrier each call's text demands (set lazily, once)."""
        if not hasattr(self, "_kinds"):
            n = len(self.texts)
            self._kinds = ["kcar" if self._kcar(i % n) else "q32"
                           for i in range(len(self.samples))]
        return self._kinds

    def verify(self, control=None):
        """Check rows; with `control` (a torch dtype) the answers are the
        reference's own, computed in that precision, in the program's
        place (the control of the comparison)."""
        from ..reference.render import render

        v, lang = self.cfg["voice"], self.cfg["language"]
        if not self.kept:
            return compare.rows([], self.cell.limits)
        rng = self._rng(4)
        longest = max(range(len(self.kept)),
                      key=lambda i: len(self.kept[i][1]))
        rest = [i for i in range(len(self.kept)) if i != longest]
        pick = [longest] + list(rng.permutation(rest)[:batch.CHECKED - 1])
        gaps = []
        for i in pick:
            j, audio = self.kept[i]
            args = ([self.texts[j]], [self.seeds[j]], v, lang, self._kcar(j),
                    self.dev)
            ref = render(*args)[0]
            answer = audio if control is None else render(*args,
                                                          dtype=control)[0]
            gaps.append(compare.gap(answer, ref))
        self.gaps = gaps
        return compare.rows(gaps, self.cell.limits)
