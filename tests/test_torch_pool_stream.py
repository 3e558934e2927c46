"""The pool's stream against the benchmark's plain stream reference, on the
CPU: a StreamPool (device="cpu") driven by the benchmark entry's own feeder
(portbench/entries/pool.py: feed + flush once a session's queued audio
drops under the mix's threshold) against portbench/reference/stream.py,
which imports no code of the port and renders the same fed texts as one
utterance from position 0, in both pool cells: pool_en_plain.stream
(block 1,024, the plain carry tick) and pool_en_plain_10ms.stream (block
441, the xla tick); the reference's element list against StreamSession's;
and the pool's spans (runtime/trace.py) under a profiler and without one,
with the xla tick's five stages.

Tolerance: each cell's own limit on `audio_gap` (1e-2 of full scale, set on
the card from 150-165 s of six sessions: the program read up to 4.6e-4,
the reference in bfloat16 at least 1.36, at block 1,024). Here, over a few
seconds, the 16-bit truncation turns a float32 difference of an ulp into
one code here and there (~3.1e-5); the bfloat16 reference fails the same
limit (portbench/tests/test_pb_pool.py).
"""

import functools

import numpy as np
import pytest
import torch

from grail_tpu_torch.runtime import stream as pstream
from grail_tpu_torch.runtime import trace
from portbench import harness
from portbench.reference.stream import elements

torch.set_num_threads(2)

CELL = "pool_en_plain.stream"
CELL_10MS = "pool_en_plain_10ms.stream"
# four sessions of one-word texts, three a session; a lattice window of
# 16 cells (1 s at 16 Hz), so that every session slides it about once a
# second
TINY = {"config": {"sessions": 4, "jitter_horizon_s": 0.25},
        "mix": {"words": {"dist": "uniform", "min": 1, "max": 1}},
        "texts": 3, "warm_ticks": 4}
# ticks a cell's loop runs: 5.6 s of audio a session in both (the first
# rebase comes at ~5.0 s)
TICKS = {CELL: 240, CELL_10MS: 560}


@functools.lru_cache(maxsize=None)
def _driven(name: str):
    """The entry's set-up and TICKS[name] ticks of its loop, drained:
    (entry, check rows)."""
    cell = harness.load_cell(name, TINY)
    entry = harness.entry_class(cell.entry)(cell, 2 ** 33 + 19, "cpu")
    entry.setup()
    first = {i: list(entry.fed[i]) for i in entry.kept_ids}
    for _ in range(TICKS[name]):
        entry._tick()
    entry._take(entry.pool.drain())
    entry.first = first
    return entry, entry.verify()


@pytest.fixture(scope="module")
def driven():
    return _driven(CELL)


@pytest.fixture(scope="module")
def driven_10ms():
    entry, checks = _driven(CELL_10MS)
    assert entry.pool.backend == "xla" and entry.block == 441
    return entry, checks


def _matches_the_stream_reference(name, entry, checks):
    value, limit = {n: (v, lim) for n, v, lim, _ in checks}["audio_gap"]
    assert value <= limit == harness.load_cell(name).limits["audio_gap"]
    assert len(entry.gaps) == 4
    assert entry.collected == TICKS[name] + int(TINY["warm_ticks"])
    rows = np.concatenate(entry.kept_rows[entry.kept_ids[0]])
    assert rows.dtype == np.int16 and np.abs(rows).max() > 300


def test_pool_matches_the_stream_reference(driven):
    _matches_the_stream_reference(CELL, *driven)


def test_pool_10ms_on_the_xla_tick_matches_the_stream_reference(driven_10ms):
    _matches_the_stream_reference(CELL_10MS, *driven_10ms)


def test_the_run_crossed_feeds_slides_and_rebases(driven):
    _crossed_feeds_slides_and_rebases(*driven)


def test_the_10ms_run_crossed_feeds_slides_and_rebases(driven_10ms):
    _crossed_feeds_slides_and_rebases(*driven_10ms)


def _crossed_feeds_slides_and_rebases(entry, _):
    sessions = [entry.pool.sessions[i] for i in entry.kept_ids]
    # a feed made while the session spoke, after set-up's first one
    assert all(len(entry.fed[i]) > len(entry.first[i]) for i in
               entry.kept_ids), entry.fed
    assert all(s._lat_base > 0 for s in sessions)              # slides
    assert any(s._consumed_samples < s._jitter_pos for s in sessions)
    # never ran dry: no idle silence was appended
    assert all(s._horizon_tail == 0 for s in sessions)


@pytest.mark.parametrize("texts", [
    ["hello there.", "why you.", "we go."],
    ["a.", "aeio."],
    ["the quick brown fox jumps over the lazy dog."],
])
def test_reference_elements_equal_the_sessions(texts):
    s = pstream.StreamSession(voice="plain", language="english", seed=3,
                              device="cpu")
    for t in texts:
        s.feed(t)
        s.flush()
    ref = elements(texts, "plain", "english")
    got = [(int(e.phoneme), e.length, e.blend_length, e.frequency)
           for e in s._elements]
    want = [(int(e.phoneme), e.length, e.blend_length, e.frequency)
            for e in ref]
    assert got == want


def test_pool_spans_and_tallies_under_a_profiler():
    pool = pstream.StreamPool(2, voice="plain", language="english",
                              block=1024, output="pcm16", device="cpu",
                              jitter_horizon_s=0.25)
    trace.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        pool.feed(0, "[rate:8]hello hello", parse_commands=True)
        pool.flush(0)
        for _ in range(30):
            pool.tick_pipelined()
        pool.drain()
    got = trace.spans()
    ticks = [s for s in got if s.name == "tick"]
    hosts = [s for s in got if s.name == "host"]
    assert len(ticks) == len(hosts) == 30
    assert all(s.parent is None and s.attrs["blocks"] == 1 for s in ticks)
    assert {s.parent for s in hosts} == {"tick"}
    assert sum(s.name == "launch" and s.parent == "tick" for s in got) == 30
    assert sum(s.name == "collect" and s.parent is None for s in got) == 30
    # the first tick's full pass uploads every session's rows at once
    first = hosts[0].attrs
    assert first["full"] is True
    assert first["score_rows_uploaded"] == 2
    assert first["lattice_rows_uploaded"] == 2
    assert first["full_uploads"] == 2
    assert any(h.attrs["full"] is False for h in hosts)
    assert sum(h.attrs.get("rebases", 0) for h in hosts) >= 1
    feeds = [s for s in got if s.name == "feed"]
    assert [(s.parent, s.attrs["session"], s.attrs["what"]) for s in feeds] \
        == [(None, 0, "feed"), (None, 0, "flush")]
    assert sum(s.attrs["elems"] for s in feeds) > 0
    # every span of one tick shares the root's call id
    assert {s.call for s in got if s.parent == "tick"} <= \
        {s.call for s in ticks}


def test_pool_spans_cost_one_check_without_a_profiler():
    assert trace.span("tick") is trace._OFF
    trace.clear()
    pool = pstream.StreamPool(2, voice="plain", language="english",
                              block=1024, output="pcm16", device="cpu")
    pool.feed(1, "hello")
    pool.flush(1)
    pool.tick_pipelined()
    pool.tick_pipelined()
    pool.drain()
    assert trace.spans() == []


STAGES = ("jsched", "frames", "carrier", "core", "pack")


def _stage_pool(block):
    pool = pstream.StreamPool(2, voice="plain", language="english",
                              block=block, output="pcm16", device="cpu",
                              jitter_horizon_s=0.25)
    pool.feed(0, "hello there")
    pool.feed(1, "why")
    pool.flush()
    return pool


def test_xla_tick_stages_nest_in_launch_once_a_tick():
    # block 441: the xla tick's five stages in `launch` (program 'xla'),
    # once a tick each, in order, with the audio and the carried rows
    # bit-equal to a twin's ticks recorded by no profiler; block 1,024:
    # `launch` of the carry tick ('fused') and no stage; a solo session's
    # read of the xla tick opens no `launch`, so it records no stage
    ticks = 6
    pool, twin = _stage_pool(441), _stage_pool(441)
    assert pool.backend == "xla"
    carry = _stage_pool(1024)
    solo = pstream.StreamSession(voice="plain", language="english", seed=1,
                                 block=441, device="cpu")
    solo.feed("aeio")
    solo.flush()
    trace.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        got = [pool.read_block() for _ in range(ticks)]
        xla = trace.spans()
        trace.clear()
        carry.read_block()
        solo.read(441)
    assert trace.span("tick") is trace._OFF
    want = [twin.read_block() for _ in range(ticks)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(pool._sf, twin._sf) and torch.equal(pool._si,
                                                           twin._si)
    launches = [s for s in xla if s.name == "launch"]
    assert len(launches) == ticks
    assert all(s.parent == "tick" and s.attrs["program"] == "xla"
               for s in launches)
    stages = [s for s in xla if s.name in STAGES]
    assert [s.name for s in stages] == list(STAGES) * ticks
    for k, launch in enumerate(launches):
        for s in stages[5 * k:5 * k + 5]:
            assert s.parent == "launch" and s.call == launch.call
            assert launch.start_ns <= s.start_ns <= s.end_ns \
                <= launch.end_ns
    rest = trace.spans()
    assert [s.attrs["program"] for s in rest if s.name == "launch"] == \
        ["fused"]
    assert not [s for s in rest if s.name in STAGES]


# twelve sessions whose seeds share a lattice stagger (seed % 4 == 0 at a
# 0.25 s window) and twelve spread over the other three, so that more than
# eight slide on one pass and fewer than all
SEEDS = [4 * k for k in range(12)] + [4 * k + 1 + k % 3 for k in range(12)]
# tick -> (sessions, text) fed and flushed before it: more than eight
# sessions' revisions move on tick 3 and all of them on tick 30, more than
# eight lattices on tick 29; tick 31's long text grows E past the pin
FEEDS = {0: (range(12), "hello there, how are you"),
         3: (range(12, 24), "why not go on then"),
         30: (range(24), "we go."),
         31: ([5], "the quick brown fox jumps over the lazy dog. " * 2)}
MANY_TICKS = 34


def _moved(before, after) -> int:
    """Sessions whose per-session key entries moved between two upload
    keys (revisions and voices, or lattice versions)."""
    if before is None or before is after:
        return 0
    return sum(any(b[i] != a[i] for b, a in zip(before[1:], after[1:]))
               for i in range(len(after[1])))


def test_many_changed_sessions_scatter_equal_to_whole_uploads(monkeypatch):
    def mk():
        return pstream.StreamPool(24, voice="plain", language="english",
                                  block=1024, jitter_horizon_s=0.25,
                                  pin_elems=64, seeds=SEEDS, device="cpu")

    pool, twin = mk(), mk()
    moved = []        # a tick's sessions whose scores, lattices moved
    # the spans as a profiler records them, without the profiler's rows of
    # every operation of the CPU ticks
    monkeypatch.setattr(trace, "_recording", lambda: True)
    trace.clear()
    for k in range(MANY_TICKS):
        ids, text = FEEDS.get(k, ((), ""))
        for p in (pool, twin):
            for i in ids:
                p.feed(i, text)
                p.flush(i)
        keys = pool._cache_key, pool._lat_key
        twin._cache_key = twin._lat_key = None     # the whole path
        np.testing.assert_array_equal(pool.read_block(),
                                      twin.read_block())
        moved.append((_moved(keys[0], pool._cache_key),
                      _moved(keys[1], pool._lat_key)))
        for name in ("n", "scal", "vec", "par", "offsets", "lat_base"):
            assert torch.equal(pool._dev[name], twin._dev[name]), name
        assert all(torch.equal(a, b) for a, b in
                   zip(pool._dev["lat"], twin._dev["lat"]))
    hosts = [s.attrs for s in trace.spans() if s.name == "host"][::2]
    assert len(hosts) == MANY_TICKS
    first, grown = hosts[0], hosts[31]
    assert (first["full_uploads"], first["score_rows_uploaded"],
            first["lattice_rows_uploaded"]) == (2, 24, 24)
    # a new E rebuilds every session's scores, the lattices stay scattered
    assert pool._cache_key[0] > 64
    assert (grown["full_uploads"], grown["score_rows_uploaded"]) == (1, 24)
    for k, h in enumerate(hosts[1:31], 1):
        assert h.get("full_uploads", 0) == 0, (k, h)
        assert (h.get("score_rows_uploaded", 0),
                h.get("lattice_rows_uploaded", 0)) == moved[k], (k, h)
    assert (moved[3][0], moved[30][0]) == (12, 24)      # all: scattered
    assert max(m[1] for m in moved[1:31]) > 8
    np.testing.assert_array_equal(pool.read_block(), twin.read_block())


def test_pool_passes_sorts_every_host_pass():
    # benchmarks/pool_passes' span window on the CPU pool: every tick's host
    # pass in one kind, the tallies summed, the wrapped names restored (its
    # times say nothing here)
    from grail_tpu_torch.benchmarks import pool_passes

    cell = harness.load_cell(CELL, TINY)
    entry = harness.entry_class(cell.entry)(cell, 2 ** 33 + 19, "cpu")
    entry.setup()
    full_pass = pstream.StreamPool._prepare_tick_full
    r = pool_passes.spans_window(entry, 2.0)
    assert pstream.StreamPool._prepare_tick_full is full_pass
    assert trace.span("tick") is trace._OFF
    kinds = r["kinds"]
    assert sum(k["n"] for k in kinds.values()) == r["ticks"] > 0
    assert "whole" not in kinds and not r["tallies"].get("full_uploads")
    assert kinds["fast"]["n"] > 0 and r["parts_s"] == {}


def test_xla_tick_stages_sorts_device_work_by_stage():
    # benchmarks/xla_tick_stages: a device operation goes to the innermost
    # port span open at its launch on the launching thread (a trace worked
    # by hand), and the spans window of the tiny 10-ms cell's CPU pool
    # times every span and stage (its times say nothing here)
    from grail_tpu_torch.benchmarks import xla_tick_stages as xs

    def x(name, ts, dur, tid=1, **kw):
        return dict({"ph": "X", "name": name, "ts": ts, "dur": dur,
                     "tid": tid}, **kw)

    def launched(corr, ts, tid=1, dur=2.0):
        return [x("cudaLaunchKernel", ts, 1, tid, cat="cuda_runtime",
                  args={"correlation": corr}),
                x(f"k{corr}", 200 + corr, dur, 7, cat="kernel",
                  args={"correlation": corr})]

    events = [x("grail.tick", 0, 100), x("grail.launch", 10, 80),
              x("grail.core", 20, 20), x("grail.pack", 50, 10),
              *launched(1, 25), *launched(2, 30), *launched(3, 70),
              *launched(4, 5), *launched(5, 30, tid=2)]
    got = xs.by_span(events)
    assert {k: v[0] for k, v in got.items()} == \
        {"core": 2, "launch": 1, "tick": 1, "": 1}
    assert got["core"][1] == pytest.approx(4e-6)

    cell = harness.load_cell(CELL_10MS, TINY)
    entry = harness.entry_class(cell.entry)(cell, 2 ** 33 + 19, "cpu")
    entry.setup()
    r = xs.spans_window(entry, 0.5)
    assert trace.span("tick") is trace._OFF
    assert r["ticks"] > 0 and set(r["median_ms"]) == set(xs.SPANS)
