"""Entry `batch`: grail_tpu_torch.api.synthesize_batch in a closed loop.

One caller sends batches of mix['batch'] texts back to back; each call's
float32 audio is fetched to the host with `.cpu()` inside the window, as a
renderer that writes audio out does. Set-up imports the port, builds its
libraries (first run in a checkout), generates the texts of the run from
the seed (the cell's `batches` groups, sized to outlast its window; a
window that outruns them starts over at the first) and synthesizes one
warm batch of texts of its own.

End to end: `batch_xrt`, seconds of audio on the host over the wall
seconds of the window, which runs from its start until the last call
started in it has delivered. `attempted` and `failed` count utterances.

The check: one utterance of each batch, drawn from the seed before the
window, is kept; after the window a sample of them, drawn from the seed,
with the longest kept one in it, is held against reference/render.py.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import compare
from ..trace import phase
from ..traffic import generator

CHECKED = 6            # utterances compared after the window


class Entry:
    def __init__(self, cell, seed: int, device, fault=None, seconds=None):
        self.cell, self.seed, self.dev = cell, int(seed), torch.device(device)
        self.fault = fault
        self.cfg, self.mix = cell.config, cell.mix

    def _rng(self, stream: int):
        s = self.seed
        return np.random.default_rng([s & 0xFFFFFFFF, s >> 32, stream])

    def setup(self):
        from grail_tpu_torch import api

        self.api = api
        n_batches = int(self.cell.batches)
        self.texts = generator.batches(self.mix, self.seed, n_batches + 1)
        B = len(self.texts[0])
        rng = self._rng(3)
        self.seeds = rng.integers(0, 2 ** 31, size=(n_batches + 1, B))
        self.keep = rng.integers(0, B, size=n_batches + 1)
        # the warm batch: texts of its own (the last group), never checked
        self._call(self.texts[-1], self.seeds[-1])
        self.texts, self.seeds = self.texts[:-1], self.seeds[:-1]

    def _call(self, texts, seeds):
        outs = self.api.synthesize_batch(
            texts, voice=self.cfg["voice"], language=self.cfg["language"],
            seeds=[int(s) for s in seeds], device=self.dev)
        if self.fault is not None:
            outs = self.fault(outs)
        return outs

    def window(self, seconds: float, traced: bool):
        api, cfg = self.api, self.cfg
        sr = float(cfg["sample_rate"])
        self.kept, self.samples, self.spans = [], [], []
        self.done = self.sent = 0
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            b = i % len(self.texts)
            texts, seeds = self.texts[b], self.seeds[b]
            if traced:          # the two public frontend functions, apart
                from grail_tpu_torch.synth.score import (
                    score_from_phoneme_elems)

                v = api._resolve_voice(cfg["voice"])
                a = time.perf_counter()
                with phase("frontend_probe"):
                    pe = [api.text_to_phoneme_elems(t, v, cfg["language"])
                          for t in texts]
                    for p in pe:
                        score_from_phoneme_elems(p, v)
                self.spans.append(("frontend_probe", a,
                                   time.perf_counter()))
            a = time.perf_counter()
            self.sent += len(texts)
            with phase("program"):
                outs = self._call(texts, seeds)
            m = time.perf_counter()
            with phase("fetch"):
                host = [o.cpu() for o in outs]
            e = time.perf_counter()
            self.spans += [("program", a, m), ("fetch", m, e)]
            n = [int(h.shape[-1]) for h in host]
            self.samples.append(sum(n))
            self.done += len(host)
            k = int(self.keep[b])
            if k < len(host) and i < len(self.texts):
                self.kept.append((b, k, host[k].numpy().copy()))
            del outs, host
            i += 1
        self.t_window = time.perf_counter() - t0
        self.traced = traced
        self.audio_s = sum(self.samples) / sr

    def records(self) -> dict:
        return {"entry": "batch", "spans": self.spans,
                "window_s": self.t_window,
                "work": [{"samples": s} for s in self.samples],
                "carrier": self._carrier_kinds() if self.traced else None}

    def _carrier_kinds(self):
        """The carrier each batch's semantics demand, by the reference's
        rule over the batch's own texts (set lazily, once)."""
        if not hasattr(self, "_kinds"):
            from ..reference.render import exact_carrier, longest_samples

            v, lang = self.cfg["voice"], self.cfg["language"]
            used = range(min(len(self.samples), len(self.texts)))
            self._kinds = ["kcar" if exact_carrier(
                longest_samples(self.texts[b], v, lang), v) else "q32"
                for b in used]
        return self._kinds

    def finish(self):
        pass

    def end_to_end(self) -> dict:
        return {"batch_xrt": (self.audio_s / self.t_window, "s/s")}

    def counts(self):
        return self.sent, self.sent - self.done

    def verify(self, control=None):
        """Check rows; with `control` (a torch dtype) the answers are the
        reference's own, computed in that precision, in the program's
        place (the control of the comparison)."""
        from ..reference.render import exact_carrier, longest_samples, render

        v, lang = self.cfg["voice"], self.cfg["language"]
        if not self.kept:
            return compare.rows([], self.cell.limits)
        rng = self._rng(4)
        longest = max(range(len(self.kept)),
                      key=lambda j: len(self.kept[j][2]))
        rest = [j for j in range(len(self.kept)) if j != longest]
        pick = [longest] + list(rng.permutation(rest)[:CHECKED - 1])
        groups = {}
        for j in pick:
            b, k, audio = self.kept[j]
            kcar = exact_carrier(longest_samples(self.texts[b], v, lang), v)
            groups.setdefault(kcar, []).append((b, k, audio))
        gaps = []
        dev = self.dev
        for kcar, items in groups.items():
            args = ([self.texts[b][k] for b, k, _ in items],
                    [int(self.seeds[b][k]) for b, k, _ in items],
                    v, lang, kcar, dev)
            refs = render(*args)
            answers = ([a for _, _, a in items] if control is None
                       else render(*args, dtype=control))
            gaps += [compare.gap(a, r) for a, r in zip(answers, refs)]
        self.gaps = gaps
        return compare.rows(gaps, self.cell.limits)
