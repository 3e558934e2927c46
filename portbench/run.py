"""The benchmark of grail_tpu_torch: one run of one cell on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the repository's root. Prints, as its last line on standard
output, one JSON object (correct, attempted, failed, metrics, device, with
--trace 1 breakdown, and last the numbers compared with their limits), and
the same comparisons as the last lines on standard error. Exits non-zero,
printing no result, when no CUDA card is found, and when JAX or grail_tpu
was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of the run stays in the checkout, at fixed paths
    cache = ROOT / "build" / "portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path.insert(0, str(ROOT))

    import torch

    from portbench import harness

    harness.load_cell(args.workload)       # an unknown cell fails first
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA card: the benchmark runs only on one",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result, checks = harness.run(args.workload, args.seed, args.seconds,
                                 args.trace, "cuda", T_START)
    banned = harness.banned_modules()
    if banned:
        print(f"loaded in the benchmark's process: {', '.join(banned)}",
              file=sys.stderr)
        return 3
    for name, value, limit, ok in checks:
        print(f"check {name} {value!r} limit {limit!r} "
              f"{'ok' if ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
