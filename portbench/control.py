"""Readings for the limits of a cell's comparison, on the card.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 \
        --seconds 10 [--dtype bfloat16]

For each seed: one run's set-up and window as the benchmark makes them,
then the widest gap of the program's answers (the sound run's reading),
and of the control's: the reference computed in `--dtype` (the nearest
precision below the configuration's float32) in the program's place, over
the same sampled answers. One line of JSON a seed on standard output.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path


def readings(cell: str, seed: int, seconds: float, dtype, device="cuda",
             overrides=None) -> dict:
    import torch

    from portbench import harness

    c = harness.load_cell(cell, overrides)
    entry = harness.entry_class(c.entry)(c, int(seed), device,
                                         seconds=seconds)
    entry.setup()
    entry.window(seconds, traced=False)
    entry.finish()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    prog = entry.verify()
    prog_gaps = list(entry.gaps)
    ctrl = entry.verify(control=dtype)
    return {"cell": cell, "seed": seed, "program": prog[0][1],
            "program_gaps": prog_gaps, "control": ctrl[0][1],
            "control_gaps": list(entry.gaps), "limit": prog[0][2]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    dtype = getattr(torch, args.dtype)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = readings(args.workload, seed, args.seconds, dtype)
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
