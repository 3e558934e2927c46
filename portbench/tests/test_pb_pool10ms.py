"""The pool entry on a tiny cell of pool_en_plain_10ms (block 441: the xla
tick) on the CPU: a sound run is correct and the planted faults of
test_pb_pool.py are not; the three readers of the xla tick on a record
worked by hand, and on a traced CPU run of the tiny cell (the spans the
port records there); nothing on a batch record, on a carry-tick record or
where the port recorded no span of the xla tick."""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from .test_pb_pool import TINY, DropFeed, Shifted, ZeroBlock, _reader

CELL = "pool_en_plain_10ms.stream"
READERS = ("launches_tick.pool10ms", "launch_ms.pool10ms",
           "core_ms.pool10ms")
STAGES = ("jsched", "frames", "carrier", "core", "pack")


def tiny_run(seed, fault=None, seconds=4.0, trace=0):
    from portbench import harness

    torch.set_num_threads(2)
    return harness.run(CELL, seed, seconds, trace, "cpu",
                       time.perf_counter(), overrides=TINY, fault=fault)


def test_a_sound_run_is_correct():
    result, checks = tiny_run(2 ** 33 + 41)
    assert result["correct"] is True, checks
    assert result["attempted"] >= 4 and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "batch_xrt"}


@pytest.mark.parametrize("fault", [DropFeed, ZeroBlock, Shifted],
                         ids=["feed_dropped", "block_zeroed", "shifted"])
def test_a_broken_timed_path_is_not_correct(fault):
    result, checks = tiny_run(2 ** 33 + 97, fault=fault())
    assert result["correct"] is False, checks


def _span(name, parent, a_ms, b_ms, **attrs):
    return SimpleNamespace(call=1, name=name, parent=parent,
                           start_ns=int(a_ms * 1e6), end_ns=int(b_ms * 1e6),
                           attrs=attrs)


def _record():
    """Two xla ticks: `launch` 4 and 6 ms, `core` 1 and 3 ms; eight device
    operations in the window."""
    spans = []
    for t, (launch, core) in ((0, (4, 1)), (10, (6, 3))):
        spans += [_span("host", "tick", t, t + 1, full=False)]
        a = t + 1
        for name in STAGES:
            b = a + (core if name == "core" else 0.5)
            spans.append(_span(name, "launch", a, b))
            a = b
        spans += [_span("launch", "tick", t + 1, t + 1 + launch,
                        program="xla"),
                  _span("tick", None, t, t + 1 + launch, blocks=1)]
    ops = [{"name": f"op{k}", "cat": "kernel", "t": 0.001 * k,
            "dur": 0.0005, "phase": "tick"} for k in range(8)]
    trace = {"ops": ops, "busy_s": 0.004, "window_s": 0.02, "idle": [],
             "phases": []}
    return {"entry": "pool", "window_s": 0.02, "ticks": 2,
            "samples": 2 * 768 * 441, "output": "pcm16",
            "port_spans": spans, "trace": trace}


def test_the_readers_on_a_pool_record():
    rec = _record()
    assert _reader("launches_tick.pool10ms")(rec) == (4.0, "count")
    assert _reader("launch_ms.pool10ms")(rec) == (5.0, "ms")
    assert _reader("core_ms.pool10ms")(rec) == (2.0, "ms")


@pytest.mark.parametrize("name", READERS)
def test_the_readers_read_nothing_elsewhere(name):
    read = _reader(name)
    rec = _record()
    assert read(dict(rec, entry="batch")) is None
    if name.startswith("launches_"):
        assert read(dict(rec, trace=None)) is None
        assert read(dict(rec, ticks=0)) is None
    else:
        assert read(dict(rec, port_spans=[])) is None
        # the carry tick's `launch` (and no stage), and the parent's
        # `launch`, which has no `program`
        carry = [_span("launch", "tick", 1, 2, program="fused"),
                 _span("launch", "tick", 3, 4)]
        assert read(dict(rec, port_spans=carry)) is None
    assert np.isfinite(read(rec)[0])


def test_the_span_readers_on_a_traced_cpu_run(monkeypatch):
    # the harness's traced run on the CPU, the port's spans recorded as
    # under a profiler (no device trace there): the two span readers read
    # the stages the port recorded, the device reader nothing
    from grail_tpu_torch.runtime import trace
    from portbench import harness

    monkeypatch.setattr(trace, "_recording", lambda: True)
    result, _ = tiny_run(2 ** 33 + 7, seconds=1.0, trace=1)
    m = result["metrics"]
    assert "launches_tick.pool10ms" not in m
    for name in ("launch_ms.pool10ms", "core_ms.pool10ms",
                 "tick_host_ms.pool"):
        assert m[name]["unit"] == "ms" and m[name]["value"] > 0, m
    assert m["core_ms.pool10ms"]["value"] < m["launch_ms.pool10ms"]["value"]
    _, layer = harness.listed_metrics(CELL)
    assert set(READERS) <= layer
