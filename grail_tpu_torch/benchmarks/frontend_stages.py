"""The batch path's host frontend split by stage on the host clock, with the
drift countdown in closed form and stepwise, on the benchmark's generated
batches of both mixes.

    python -m grail_tpu_torch.benchmarks.frontend_stages [--batches 8]
        [--texts 64] [--out stages.json]

Run from the repository's root (the texts come from
portbench/traffic/generator.py): sentences from seed 4111222333, prompts
from seed 3999888777, voice plain, language english, each batch cut to its
first `--texts` texts. The first batch of a mix warms the caches and is not
counted; every stage is the median over the other `--batches`, in ms a
batch:

  * transcribe_intonate  `text_to_phoneme_elems` over the texts;
  * drift                `native_drift_boundaries` (the closed form) on
                         each text's merged element lengths;
  * drift_stepwise       `native_drift_boundaries_stepwise` on the same;
  * retarget             `_lengths_hitting_boundaries` on those boundaries;
  * assembly             `score_from_phoneme_elems` given the boundaries,
                         less the retarget (glide merge, gather,
                         `Score.build`, padding);
  * score / score_stepwise  `score_from_phoneme_elems` whole, through
                         either form of the countdown;
  * frontend / frontend_stepwise  transcribe_intonate plus score, what the
                         `frontend` span holds.

`drift_steps` and `drift_samples` are the closed form's explicit float32
steps and the samples it counted, read from a span (runtime/trace.py) in a
pass of their own under a CPU profiler; `step_share` is their ratio. One
JSON line per mix; `--out` also writes both to a file.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from .. import api
from ..runtime import native as rn
from ..runtime import trace
from ..synth import score as sc

MIXES = (("sentences", 4111222333), ("prompts", 3999888777))


def _batch(texts, v, sr) -> dict:
    """One batch's stages in seconds, and its drift counters."""
    r = {}
    t = time.perf_counter()
    pel = [api.text_to_phoneme_elems(x, v, "english") for x in texts]
    r["transcribe_intonate"] = time.perf_counter() - t
    merged = [sc.merge_glides(p) for p in pel]
    lens = [np.float32([pe.length for pe in m]) for m in merged]
    t = time.perf_counter()
    n_refs = [rn.native_drift_boundaries(L, sr)[0] for L in lens]
    r["drift"] = time.perf_counter() - t
    t = time.perf_counter()
    for L in lens:
        rn.native_drift_boundaries_stepwise(L, sr)
    r["drift_stepwise"] = time.perf_counter() - t
    t = time.perf_counter()
    for m, n in zip(merged, n_refs):
        sc._lengths_hitting_boundaries(n, sr, zero_blend=np.asarray(
            [pe.blend_length == 0 for pe in m]))
    r["retarget"] = time.perf_counter() - t
    t = time.perf_counter()
    for p, n in zip(pel, n_refs):
        sc.score_from_phoneme_elems(p, v, n_ref=n)
    r["assembly"] = time.perf_counter() - t - r["retarget"]
    t = time.perf_counter()
    for p in pel:
        sc.score_from_phoneme_elems(p, v)
    r["score"] = time.perf_counter() - t
    closed = sc.native_drift_boundaries
    sc.native_drift_boundaries = rn.native_drift_boundaries_stepwise
    try:
        t = time.perf_counter()
        for p in pel:
            sc.score_from_phoneme_elems(p, v)
        r["score_stepwise"] = time.perf_counter() - t
    finally:
        sc.native_drift_boundaries = closed
    r["frontend"] = r["transcribe_intonate"] + r["score"]
    r["frontend_stepwise"] = r["transcribe_intonate"] + r["score_stepwise"]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.span("drift"):
            for L in lens:
                rn.native_drift_boundaries(L, sr)
    counted = trace.spans()[-1].attrs
    r["drift_steps"] = counted["drift_steps"]
    r["drift_samples"] = counted["drift_samples"]
    return r


def stages(mix_name: str, seed: int, n_batches: int, n_texts: int) -> dict:
    """The medians of one mix (see the module's docstring)."""
    from portbench.traffic import generator

    v = api._resolve_voice("plain")
    sr = float(v.sample_rate)
    rows = [_batch(texts[:n_texts], v, sr) for texts in
            generator.batches(generator.load_mix(mix_name), seed,
                              n_batches + 1)][1:]
    counters = ("drift_steps", "drift_samples")
    out = {k: statistics.median(r[k] for r in rows) * 1e3
           for k in rows[0] if k not in counters}
    out.update({k: sum(r[k] for r in rows) for k in counters})
    out["step_share"] = out["drift_steps"] / out["drift_samples"]
    out.update(mix=mix_name, seed=seed, batches=len(rows), texts=n_texts)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--texts", type=int, default=64)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ".")
    got = {}
    for name, seed in MIXES:
        got[name] = stages(name, seed, args.batches, args.texts)
        print(json.dumps(got[name]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(got, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
