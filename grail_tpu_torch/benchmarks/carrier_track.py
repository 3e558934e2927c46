"""The solo route's host carrier pre-pass on the host clock: the oracle's
track against the port's frequency-only chain, on the benchmark's sentences.

    python -m grail_tpu_torch.benchmarks.carrier_track [--texts 16]
        [--repeats 5] [--seed 4111222333] [--out track.json]

Run from the repository's root (the texts come from
portbench/traffic/generator.py, the sentences mix that the cell
`cli_en_plain.sentences` sends one text a call). Voice plain, language
english; the texts are the seed's first group, those past
EXACT_CARRIER_AUTO_SECONDS (the ones `synthesize` gives a track), cut to the
first `--texts`; one seed a text. For each text, in turns (oracle, port,
port, oracle, ... over `--repeats` pairs), the host seconds of

  * oracle   oracle/native.native_carrier_phase_track: selection, the six
             formant fields marshalled, the oracle chain without its filter;
  * port     runtime/native.native_carrier_track: the whole function;
  * select   its selection alone (`_carrier_track_inputs`);
  * chain    its C++ loop alone (`_carrier_track_chain` on those inputs);
  * track    api._carrier_track_for with an empty memo: what the `track`
             span holds on a miss (the memo's key, then `port`).

and the two tracks compared bit for bit (the run fails if they differ).
Each is the median over the repeats, then over the texts: ms a text and ns
a sample. One JSON line; `--out` also writes it to a file, with every text's
numbers.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

from .. import api
from ..oracle import native as onat
from ..runtime import native as rn

SEED = 4111222333
STAGES = ("oracle", "port", "select", "chain", "track")


def _host() -> str:
    """The host CPU's model name, where /proc/cpuinfo gives one."""
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


def _seconds(fn) -> float:
    t = time.perf_counter()
    fn()
    return time.perf_counter() - t


def _text(pelems, v, spec, seed: int, repeats: int) -> dict:
    """One text's medians (seconds) and its sample count."""
    theirs = onat.native_carrier_phase_track(pelems, spec, seed)
    ours = rn.native_carrier_track(pelems, spec, seed)
    if ours.shape != theirs.shape or not np.array_equal(
            ours.view(np.uint32), theirs.view(np.uint32)):
        raise AssertionError("the port's carrier track differs from the "
                             "oracle's")
    inputs = rn._carrier_track_inputs(pelems, spec)

    def track():
        api._carrier_cache.clear()
        api._carrier_track_for(pelems, v, seed)

    runs = {
        "oracle": lambda: onat.native_carrier_phase_track(pelems, spec, seed),
        "port": lambda: rn.native_carrier_track(pelems, spec, seed),
        "select": lambda: rn._carrier_track_inputs(pelems, spec),
        "chain": lambda: rn._carrier_track_chain(inputs, seed),
        "track": track,
    }
    got = {k: [] for k in runs}
    for r in range(repeats):
        order = list(runs) if r % 2 == 0 else list(runs)[::-1]
        for k in order:
            got[k].append(_seconds(runs[k]))
    api._carrier_cache.clear()
    out = {k: statistics.median(ts) for k, ts in got.items()}
    out["samples"] = len(ours)
    return out


def measure(n_texts: int, repeats: int, seed: int = SEED) -> dict:
    """The medians over the texts (see the module's docstring)."""
    from portbench.traffic import generator

    v = api._resolve_voice("plain")
    spec = api._spec_for_voice(v)
    (texts,) = generator.batches(generator.load_mix("sentences"), seed, 1)
    rng = np.random.default_rng(seed)
    rows = []
    for text in texts:
        pelems = api.text_to_phoneme_elems(text, v, "english")
        if not api._wants_exact_carrier(pelems):
            continue
        rows.append(_text(pelems, v, spec, int(rng.integers(0, 2 ** 31)),
                          repeats))
        if len(rows) == n_texts:
            break
    out = {"host": _host(), "texts": len(rows), "repeats": repeats,
           "seed": seed,
           "samples": statistics.median(r["samples"] for r in rows)}
    for k in STAGES:
        out[f"{k}_ms"] = statistics.median(r[k] for r in rows) * 1e3
        out[f"{k}_ns_per_sample"] = statistics.median(
            r[k] / r["samples"] for r in rows) * 1e9
    out["speedup"] = out["oracle_ms"] / out["port_ms"]
    out["per_text"] = rows
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--texts", type=int, default=16)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ".")
    got = measure(args.texts, args.repeats, args.seed)
    print(json.dumps({k: v for k, v in got.items() if k != "per_text"}),
          flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(got, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
