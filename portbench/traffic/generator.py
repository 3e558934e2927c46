"""The one text generator that every traffic mix feeds.

A mix is a JSON file of parameters beside this module (traffic/<name>.json),
which a workload may override key by key. Sentences are words drawn with
Zipf weights (rank r has weight r ** -zipf_s) from the word list
`words_en.txt`, one text per draw of a word count. Word counts are not drawn
at random: a group of n texts always holds the same n counts, the quantiles
(i + 0.5) / n of the mix's distribution, in an order drawn from the seed. So
every seed brings the same amount of work in another order, and runs with
different seeds differ only by the words.

Distributions of the word count (`words`):
  * {"dist": "lognormal", "mean": m, "sigma": s, "min": a, "max": b}: the
    lognormal of shape s whose quantiles, rounded and clipped to [a, b],
    have the mean m;
  * {"dist": "uniform", "min": a, "max": b}: a, ..., b in equal shares.
"""

from __future__ import annotations

import json
import math
import statistics
from pathlib import Path
from typing import List

import numpy as np

HERE = Path(__file__).resolve().parent


def load_mix(name: str, overrides: dict | None = None) -> dict:
    """The mix traffic/<name>.json (if there is one), updated by
    `overrides`."""
    path = HERE / f"{name}.json"
    mix = json.loads(path.read_text()) if path.exists() else {}
    mix.update(overrides or {})
    if not mix:
        raise FileNotFoundError(f"no traffic mix {name!r}: neither {path} "
                                "nor a 'mix' in the workload")
    return mix


def load_words(mix: dict):
    """(words, Zipf weights normalised to 1) of the mix's word list."""
    words = [w for w in (HERE / mix.get("word_list", "words_en.txt"))
             .read_text().split() if w]
    p = np.arange(1, len(words) + 1, dtype=np.float64) ** -float(
        mix.get("zipf_s", 1.0))
    return words, p / p.sum()


def quantile_counts(spec: dict, n: int) -> List[int]:
    """The n word counts of a group: quantiles (i + 0.5) / n of `spec`."""
    lo, hi = int(spec["min"]), int(spec["max"])
    u = [(i + 0.5) / n for i in range(n)]
    if spec["dist"] == "uniform":
        return [lo + min(int(x * (hi - lo + 1)), hi - lo) for x in u]
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown word-count distribution {spec['dist']!r}")
    z = [statistics.NormalDist().inv_cdf(x) for x in u]
    sigma, target = float(spec["sigma"]), float(spec["mean"])

    def counts(median):
        return [min(hi, max(lo, round(median * math.exp(sigma * zi))))
                for zi in z]

    a, b = 0.1, float(hi) * 4
    for _ in range(60):           # the median whose counts have the mean
        m = 0.5 * (a + b)
        if sum(counts(m)) / n < target:
            a = m
        else:
            b = m
    return counts(0.5 * (a + b))


def sentences(rng: np.random.Generator, mix: dict, n: int) -> List[str]:
    """n texts with the group's word counts, in an order from `rng`."""
    words, p = load_words(mix)
    counts = quantile_counts(mix["words"], n)
    order = rng.permutation(n)
    end = mix.get("end", ".")
    out = []
    for i in order:
        idx = rng.choice(len(words), size=counts[i], p=p)
        out.append(" ".join(words[j] for j in idx) + end)
    return out


def batches(mix: dict, seed: int, n_batches: int) -> List[List[str]]:
    """n_batches groups of mix['batch'] texts from `seed`."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32,
                                 1])
    return [sentences(rng, mix, int(mix["batch"])) for _ in range(n_batches)]


def mean_chars(mix: dict) -> float:
    """Mean characters of a text, from the word counts' mean and the word
    list's Zipf-weighted mean length (a space between words, `end` after)."""
    words, p = load_words(mix)
    wl = float(np.dot(p, [len(w) for w in words]))
    c = np.mean(quantile_counts(mix["words"], 1024))
    return c * wl + (c - 1) + len(mix.get("end", "."))

