"""Serve mode in real time on one card: StreamPool's paced serving loop.

    python -m grail_tpu_torch.benchmarks.serve_paced

StreamPool(N, voice plain, english, block 1,024, pin_elems=64, every session
fed) at N = 512, then 128, served for 10 s at the block period (23.22 ms):
this thread dispatches serve_tick once a period, the frontend thread runs on
its own period, a feeder thread feeds a session every max(7, ceil(12 / (N *
period))) periods (grail_tpu's benchmarks/latency.py cadence) and a sink
thread copies each tick's audio to the host in order; the collector is off,
as in a real-time audio loop. One JSON line with the card's name and power
limit and, per N: deadline misses at sink depth 1-3 (tick k's audio on the
host later than k + d periods after the start), serve_tick's host time per
call (p50, p99, max), the dispatches' lateness, the captures (all on the
frontend thread) and the frontend cycles. It gates nothing.

The captures and the frontend cycles are timed by wrapping StreamPool's
private `_serve_capture` and `_serve_build` for the run, and a frontend
failure is read from `_serve_error`: the tool depends on those names until
the pool has spans of its own for them (PERF.md §7). The card's line comes
from kernel1_ab's `_card`, as in kernels23_ab.
"""

from __future__ import annotations

import gc
import json
import queue
import random
import statistics
import threading
import time

import numpy as np
import torch

from ..runtime.stream import StreamPool
from .kernel1_ab import SERVE_TEXTS as TEXTS
from .kernel1_ab import _card

SERVE_N = (512, 128)
BLOCK = 1024
SECONDS = 10.0


def _p(xs, q) -> float:
    return float(np.percentile(xs, q))


def paced(pool: StreamPool, seconds: float = SECONDS) -> dict:
    """One paced run on a pool that is not serving: its numbers. Raises if a
    tick is lost or not finite, the feeder or the frontend failed, or a
    capture ran on another thread than the frontend's."""
    n, period = len(pool.sessions), pool.block / pool.sample_rate
    every = int(max(7, -(-12.0 // (n * period))))
    pool.serve_start()
    captures, builds = [], []
    capture, build = pool._serve_capture, pool._serve_build

    def timed_capture(swap):
        t0 = time.perf_counter()
        capture(swap)
        captures.append((threading.current_thread().name,
                         (time.perf_counter() - t0) * 1e3))

    def timed_build():
        t0 = time.perf_counter()
        published = build()
        builds.append((time.perf_counter() - t0) * 1e3)
        return published

    pool._serve_capture, pool._serve_build = timed_capture, timed_build
    K = int(seconds / period)
    avail, late, call = [None] * K, [0.0] * K, [0.0] * K
    fetched, errors, rng = queue.Queue(), [], random.Random(0)

    def sink():
        # the check after the stamp, and in numpy: torch's isfinite on the
        # host runs on its intra-op threads, which take the cores that the
        # frontend, this thread and the real-time thread need, and it put
        # 8-53 misses at depth 2 into runs that read 0-2 without it
        # (PERF.md §6)
        while (item := fetched.get()) is not None:
            k, a = item
            h = a.cpu()
            avail[k] = time.perf_counter()
            if not np.isfinite(h.numpy()).all():
                errors.append(f"tick {k} not finite")

    def feeder():
        try:
            for k in range(0, K, every):
                dt = t_start + (k + 0.5) * period - time.perf_counter()
                if dt > 0:
                    time.sleep(dt)
                i = rng.randrange(n)
                pool.feed(i, TEXTS[rng.randrange(len(TEXTS))] + " ")
                pool.flush(i)
        except Exception as e:          # reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=sink), threading.Thread(target=feeder)]
    gc.collect()
    gc.disable()
    try:
        t_start = time.perf_counter() + 2 * period
        for th in threads:
            th.start()
        for k in range(K):
            dt = t_start + k * period - time.perf_counter()
            if dt > 0:
                time.sleep(dt)
            t0 = time.perf_counter()
            late[k] = t0 - t_start - k * period
            fetched.put((k, pool.serve_tick()))
            call[k] = time.perf_counter() - t0
    finally:
        fetched.put(None)
        for th in threads:
            th.join(timeout=60)
        gc.enable()
        frontend_error = pool._serve_error
        pool.serve_stop()
        pool._serve_capture, pool._serve_build = capture, build
    names = {name for name, _ in captures}
    if errors or frontend_error is not None or None in avail \
            or names - {"StreamPool-frontend"}:
        raise RuntimeError(f"paced run at N = {n}: {errors}, frontend "
                           f"{frontend_error!r}, captures on {names}")
    cap_ms = [ms for _, ms in captures]
    return dict(
        ticks=K, period_ms=period * 1e3, feed_every=every,
        misses={d: sum(avail[k] > t_start + (k + d) * period
                       for k in range(K)) for d in (1, 2, 3)},
        late_p50_ms=_p(late, 50) * 1e3, late_max_ms=max(late) * 1e3,
        serve_tick_p50_ms=_p(call, 50) * 1e3,
        serve_tick_p99_ms=_p(call, 99) * 1e3,
        serve_tick_max_ms=max(call) * 1e3,
        captures=len(cap_ms),
        capture_p50_ms=statistics.median(cap_ms) if cap_ms else None,
        capture_max_ms=max(cap_ms) if cap_ms else None,
        frontend_cycles=len(builds),
        frontend_p50_ms=statistics.median(builds) if builds else None,
        frontend_max_ms=max(builds) if builds else None,
        frontend_over_two_periods=sum(b > 2e3 * period for b in builds))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("serve_paced: needs a CUDA device")
    out = {"card": _card(), "block": BLOCK, "seconds": SECONDS, "by_n": {}}
    for n in SERVE_N:
        pool = StreamPool(n, voice="plain", language="english", block=BLOCK,
                          pin_elems=64)
        for i in range(n):
            pool.feed(i, TEXTS[i % len(TEXTS)])
        pool.flush()
        out["by_n"][n] = paced(pool)
        del pool
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
