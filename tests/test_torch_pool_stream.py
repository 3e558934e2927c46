"""The pool's stream against the benchmark's plain stream reference, on the
CPU: a StreamPool (device="cpu", the plain carry tick) driven by the
benchmark entry's own feeder (portbench/entries/pool.py: feed + flush once
a session's queued audio drops under the mix's threshold) against
portbench/reference/stream.py, which imports no code of the port and
renders the same fed texts as one utterance from position 0; the
reference's element list against StreamSession's; and the pool's spans
(runtime/trace.py) under a profiler and without one.

Tolerance: the cell's own limit on `audio_gap` (1e-2 of full scale, set on
the card from 150-165 s of six sessions: the program read up to 4.6e-4,
the reference in bfloat16 at least 1.36). Here, over 5.6 s, the 16-bit
truncation turns a float32 difference of an ulp into one code here and
there (~3.1e-5); the bfloat16 reference fails the same limit
(portbench/tests/test_pb_pool.py).
"""

import numpy as np
import pytest
import torch

from grail_tpu_torch.runtime import stream as pstream
from grail_tpu_torch.runtime import trace
from portbench import harness
from portbench.reference.stream import elements

torch.set_num_threads(2)

CELL = "pool_en_plain.stream"
# four sessions of one-word texts, three a session; a lattice window of
# 16 cells (1 s at 16 Hz), so that every session slides it about once a
# second
TINY = {"config": {"sessions": 4, "jitter_horizon_s": 0.25},
        "mix": {"words": {"dist": "uniform", "min": 1, "max": 1}},
        "texts": 3, "warm_ticks": 4}
TICKS = 240                   # 5.6 s of audio a session


@pytest.fixture(scope="module")
def driven():
    """The entry's set-up and TICKS ticks of its loop, drained: (entry,
    check rows)."""
    cell = harness.load_cell(CELL, TINY)
    entry = harness.entry_class(cell.entry)(cell, 2 ** 33 + 19, "cpu")
    entry.setup()
    first = {i: list(entry.fed[i]) for i in entry.kept_ids}
    for _ in range(TICKS):
        entry._tick()
    entry._take(entry.pool.drain())
    entry.first = first
    return entry, entry.verify()


def test_pool_matches_the_stream_reference(driven):
    entry, checks = driven
    gap = dict((name, (value, limit)) for name, value, limit, _ in checks)
    value, limit = gap["audio_gap"]
    assert value <= limit == harness.load_cell(CELL).limits["audio_gap"]
    assert len(entry.gaps) == 4
    assert entry.collected == TICKS + int(TINY["warm_ticks"])
    rows = np.concatenate(entry.kept_rows[entry.kept_ids[0]])
    assert rows.dtype == np.int16 and np.abs(rows).max() > 300


def test_the_run_crossed_feeds_slides_and_rebases(driven):
    entry, _ = driven
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
