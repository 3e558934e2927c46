"""The pool entry (entries/pool.py) on a tiny cell of pool_en_plain on the
CPU: a sound run is correct; the faults that `correct` must catch are not
(a kept session's feed dropped, one kept block zeroed, one kept session
shifted by a block), and neither is the control (on the card too, at the
cell's own size); the feeder reads the sessions' queued audio O(feeds)
times, not O(N) a tick; and the five readers on records worked by hand:
numbers on a pool record, nothing on a batch record or where the port
recorded no pool span."""

import importlib.util
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from .conftest import ROOT

CELL = "pool_en_plain.stream"
# four sessions of one-word texts: every session is kept
TINY = {"config": {"sessions": 4, "jitter_horizon_s": 0.25},
        "mix": {"words": {"dist": "uniform", "min": 1, "max": 1}},
        "texts": 3, "warm_ticks": 4}
READERS = ("tick_host_ms.pool", "feed_ms.pool", "full_pass.pool",
           "idle_share.pool", "tick_roofline.pool")


def tiny_run(seed, fault=None, seconds=4.0):
    from portbench import harness

    torch.set_num_threads(2)
    return harness.run(CELL, seed, seconds, 0, "cpu", time.perf_counter(),
                       overrides=TINY, fault=fault)


def test_a_sound_run_is_correct():
    result, checks = tiny_run(2 ** 33 + 41)
    assert result["correct"] is True, checks
    assert result["attempted"] >= 4 and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "batch_xrt"}
    assert result["metrics"]["batch_xrt"]["unit"] == "s/s"
    assert set(result["checks"]) == {"audio_gap", "text_repeats"}


class Fault:
    """Faults planted where the entry feeds and where it keeps rows."""

    def feed(self, i, j):
        return True

    def rows(self, t, rows):
        return rows


class DropFeed(Fault):
    """The first feed of session 0 never reaches the pool (the reference
    is given it): the session starts silent."""

    def feed(self, i, j):
        return not (i == 0 and j == 0)


class ZeroBlock(Fault):
    """Tick 30's row of the first kept session zeroed (0.70 s in: past the
    lead silence)."""

    def rows(self, t, rows):
        if t == 30:
            rows = rows.copy()
            rows[0] = 0
        return rows


class Shifted(Fault):
    """The first kept session's rows one block late."""

    def __init__(self):
        self.prev = None

    def rows(self, t, rows):
        rows = rows.copy()
        cur = rows[0].copy()
        rows[0] = 0 if self.prev is None else self.prev
        self.prev = cur
        return rows


@pytest.mark.parametrize("fault", [DropFeed, ZeroBlock, Shifted],
                         ids=["feed_dropped", "block_zeroed", "shifted"])
def test_a_broken_timed_path_is_not_correct(fault):
    result, checks = tiny_run(2 ** 33 + 97, fault=fault())
    assert result["correct"] is False, checks


def test_control_fails_and_the_program_passes_tiny():
    from portbench.control import readings

    torch.set_num_threads(2)
    r = readings(CELL, 2 ** 33 + 5, 4.0, torch.bfloat16, "cpu",
                 overrides=TINY)
    assert r["program"] <= r["limit"] < r["control"], r


def test_the_feeder_reads_queued_audio_per_feed_not_per_tick(monkeypatch):
    from grail_tpu_torch.runtime import stream
    from portbench import harness

    reads = []
    prop = stream.StreamSession.pending_seconds
    monkeypatch.setattr(stream.StreamSession, "pending_seconds", property(
        lambda s: reads.append(1) or prop.fget(s)))
    feeds = []
    feed = stream.StreamPool.feed
    monkeypatch.setattr(stream.StreamPool, "feed", lambda p, i, text, **kw: (
        feeds.append(i), feed(p, i, text, **kw))[1])
    torch.set_num_threads(2)
    # a threshold above a one-word text's audio: feeds within a few ticks
    mix = dict(TINY["mix"], feed_below_s=8.0)
    cell = harness.load_cell(CELL, dict(TINY, mix=mix))
    entry = harness.entry_class(cell.entry)(cell, 2 ** 33 + 3, "cpu")
    entry.setup()
    # one read after each feed, one before each feed but the first four:
    # none on a tick with no feed due
    n0 = len(feeds)
    assert len(reads) == 2 * n0 - 4
    for _ in range(60):
        entry._tick()
    assert len(feeds) > n0
    assert len(reads) == 2 * len(feeds) - 4 < 60 * 4


@pytest.mark.cuda
def test_control_fails_and_the_program_passes_on_the_card(card):
    from portbench.control import readings

    r = readings(CELL, 2 ** 33 + 1, 10.0, torch.bfloat16, "cuda")
    assert r["program"] <= r["limit"] < r["control"], r


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "__"), ROOT / "portbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _span(name, parent, a_ms, b_ms, **attrs):
    return SimpleNamespace(call=1, name=name, parent=parent,
                           start_ns=int(a_ms * 1e6), end_ns=int(b_ms * 1e6),
                           attrs=attrs)


def _record():
    spans = [
        _span("feed", None, 0, 2, session=3, what="feed", elems=40),
        _span("feed", None, 2, 3, session=3, what="flush", elems=2),
        _span("host", "tick", 3, 13, full=True, rebases=2),
        _span("launch", "tick", 13, 14),
        _span("tick", None, 3, 15, blocks=1),
        _span("collect", None, 15, 15.5),
        _span("host", "tick", 16, 16.25, full=False),
        _span("tick", None, 16, 17, blocks=1),
        _span("feed", None, 17, 21, session=1, what="feed", elems=60),
        _span("feed", None, 21, 21.5, session=1, what="flush", elems=0),
        _span("host", "tick", 22, 23, full=False),
        _span("tick", None, 22, 24, blocks=1),
    ]
    ops = [{"name": "fused_synth_kernel", "cat": "kernel", "t": 0.004,
            "dur": 0.002, "phase": "tick"},
           {"name": "Memcpy DtoH", "cat": "gpu_memcpy", "t": 0.0065,
            "dur": 0.001, "phase": "tick"}]
    trace = {"ops": ops, "busy_s": 0.003, "window_s": 0.024, "idle": [],
             "phases": []}
    return {"entry": "pool", "window_s": 0.024, "ticks": 3,
            "samples": 3 * 768 * 1024, "output": "pcm16",
            "port_spans": spans, "trace": trace}


def test_the_readers_on_a_pool_record():
    from portbench.roofline.counts import CHAIN_F32, PEAKS

    rec = _record()
    assert _reader("tick_host_ms.pool")(rec) == (1.0, "ms")
    assert _reader("feed_ms.pool")(rec) == (3.75, "ms")   # (3 + 4.5) / 2
    value, unit = _reader("full_pass.pool")(rec)
    assert unit == "%" and value == pytest.approx(100 / 3)
    value, unit = _reader("idle_share.pool")(rec)
    assert unit == "%" and value == pytest.approx(100 * (1 - 0.003 / 0.024))
    value, unit = _reader("tick_roofline.pool")(rec)
    least = (CHAIN_F32 + 5) * rec["samples"] / PEAKS[
        "fp32_instructions_per_s"]
    assert unit == "%" and value == pytest.approx(100 * least / 0.002)


@pytest.mark.parametrize("name", READERS)
def test_the_readers_read_nothing_elsewhere(name):
    read = _reader(name)
    rec = _record()
    assert read(dict(rec, entry="batch")) is None
    if name.endswith("_roofline.pool") or name.startswith("idle_"):
        assert read(dict(rec, trace=None)) is None
    else:           # a port without the pool's spans (the parent's)
        assert read(dict(rec, port_spans=[])) is None
        batch_only = [_span("batch", None, 0, 5, B=64),
                      _span("prep", "batch", 1, 5)]
        assert read(dict(rec, port_spans=batch_only)) is None
    assert np.isfinite(read(rec)[0])
