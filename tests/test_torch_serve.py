"""The port's serve mode (StreamPool.serve_start / serve_tick / serve_stop)
against grail_tpu's on the CPU, and against the port's own read_block.

The JAX pool runs backend="fused_interpret" (its kernel in interpret mode,
as its own suite runs it), the port device="cpu": its serve mode runs the
plain tick eagerly with the same frontend thread, locks, swaps and offset
correction as on a card, where the tick is a CUDA graph's replay
(tests/test_torch_cuda.py holds that against eager launches). The
schedules are grail_tpu's own serve tests' (tests/test_runtime.py,
tests/test_serving_review.py).

Tolerances: audio against JAX sample_error_db < -100 per session, as in
tests/test_torch_stream.py (XLA:CPU contracts a*b+c into FMAs inside the
interpreted kernel and the port never does); counters, offsets, the jitter
state and the seeds bit for bit. The port against itself: bit for bit.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from grail_tpu.runtime import stream as jstream

from grail_tpu_torch.runtime import stream as pstream
from grail_tpu_torch.utils import sample_error_db

torch.set_num_threads(2)

BLOCK = 1024
N = 4
TICKS = 12
FEED_TICK = 5
TEXTS = ["hello", "hi there", "go on", "stop it"]


def _fed(mod, **kw):
    """A pool of N sessions of grail_tpu's serve tests, each fed a text."""
    pool = mod.StreamPool(N, voice="plain", language="english", block=BLOCK,
                          pin_elems=64, **kw)
    for i in range(N):
        pool.feed(i, TEXTS[i])
        pool.flush(i)
    return pool


def _serve(pool, ticks=TICKS, feed_tick=FEED_TICK, audio=np.asarray):
    """grail_tpu's schedule: serve_start(period=9999) (the frontend idles),
    a feed to session 1 at `feed_tick` published by an explicit
    _serve_build(), `ticks` served ticks. Returns the audio of each tick;
    the pool is still serving."""
    pool.serve_start(period=9999)
    got = []
    for k in range(ticks):
        if k == feed_tick:
            pool.feed(1, " more")
            pool.flush(1)
            assert pool._serve_build()
        got.append(audio(pool.serve_tick()))
    return got


def _read(pool, ticks=TICKS, feed_tick=FEED_TICK):
    """The same schedule through read_block."""
    got = []
    for k in range(ticks):
        if k == feed_tick:
            pool.feed(1, " more")
            pool.flush(1)
        got.append(pool.read_block())
    return got


@pytest.fixture(scope="module")
def served():
    """(jax pool, port pool, jax audio, port audio, jax served offsets,
    port served offsets); both pools stopped after the last tick."""
    jp, pp = _fed(jstream, backend="fused_interpret"), _fed(pstream,
                                                            device="cpu")
    ja = _serve(jp)
    pa = _serve(pp, audio=lambda t: t.numpy())
    joff = np.asarray(jp._serve_dev["offsets"])
    poff = pp._serve_off.numpy().copy()
    jp.serve_stop()
    pp.serve_stop()
    return (jp, pp, np.concatenate(ja, axis=1), np.concatenate(pa, axis=1),
            joff, poff)


def test_served_audio_matches_jax_serve(served):
    _, _, ja, pa, _, _ = served
    assert pa.shape == ja.shape == (N, TICKS * BLOCK)
    assert pa.dtype == np.float32
    for i in range(N):
        assert (sample_error_db(pa[i], ja[i]) < -100
                or np.array_equal(pa[i], ja[i])), i
    assert (np.abs(pa).max(axis=1) > 0.01).sum() >= 2


@pytest.mark.parametrize("what", [
    "consumed", "jitter_pos", "lat_base", "served_offsets", "jitter_state",
    "seed", "elements"])
def test_served_state_equals_jax_serve(served, what):
    jp, pp, _, _, joff, poff = served

    def host(attr):
        return ([attr(s) for s in jp.sessions],
                [attr(s) for s in pp.sessions])

    if what == "consumed":
        a, b = host(lambda s: s._consumed_samples)
        assert a == b
    elif what == "jitter_pos":
        a, b = host(lambda s: s._jitter_pos)
        assert a == b == [TICKS * BLOCK] * N
    elif what == "lat_base":
        a, b = host(lambda s: s._lat_base)
        assert a == b
    elif what == "elements":
        a, b = host(lambda s: len(s._elements))
        assert a == b
    elif what == "served_offsets":
        np.testing.assert_array_equal(poff, joff)
        # the served offsets are the resynced host counters
        np.testing.assert_array_equal(
            poff, [s._consumed_samples for s in pp.sessions])
    elif what == "jitter_state":
        jphi, jcell = pp._jstates
        np.testing.assert_array_equal(
            jphi.numpy().view(np.int32),
            np.asarray(jp._jstates[0]).view(np.int32))
        np.testing.assert_array_equal(jcell.numpy(),
                                      np.asarray(jp._jstates[1]))
    else:
        np.testing.assert_array_equal(
            pp._si[:, 1].numpy().view(np.uint32),
            np.asarray(jp._states.seed))


@pytest.mark.parametrize("output", ["f32", "pcm16", "ulaw"])
def test_serve_ticks_equal_read_block(output):
    # serve mode moves the host pass to the frontend: not a sample changes.
    # Against a pool fed at the same tick, every session bit for bit;
    # against a pool never fed the extra text, the other sessions
    kw = dict(device="cpu", output=output)
    pool, unfed_pool = _fed(pstream, **kw), _fed(pstream, **kw)
    got = _serve(pool, audio=lambda t: t.numpy())
    ref = _read(_fed(pstream, **kw))
    unfed = _read(unfed_pool, feed_tick=None)
    assert got[0].dtype == ref[0].dtype
    for k in range(TICKS):
        np.testing.assert_array_equal(got[k], ref[k])
        np.testing.assert_array_equal(got[k][[0, 2, 3]],
                                      unfed[k][[0, 2, 3]])
    pool.serve_stop()
    assert len(pool.sessions[1]._elements) > \
        len(unfed_pool.sessions[1]._elements)


def test_serve_crosses_slides_and_rebases_bit_equal():
    # a build every tick, as read_block prepares every tick, over ticks that
    # slide 0.3 s lattice windows (the copy-on-write lattice scatter) and
    # rebase a fast session's score
    def mk():
        pool = pstream.StreamPool(3, voice="plain", language="english",
                                  block=BLOCK, jitter_horizon_s=0.3,
                                  seeds=[3, 7, 6], device="cpu")
        pool.feed(0, "[rate:8]hello hello", parse_commands=True)
        pool.feed(1, "[pitch:180]aeio", parse_commands=True)
        pool.flush()
        return pool

    ref_pool, pool = mk(), mk()
    pool.serve_start(period=9999)
    published = 0
    for k in range(30):
        published += pool._serve_build()
        np.testing.assert_array_equal(pool.serve_tick().numpy(),
                                      ref_pool.read_block())
    assert published >= 3
    assert torch.equal(pool._sf, ref_pool._sf)
    assert torch.equal(pool._si, ref_pool._si)
    pool.serve_stop()
    assert [s._lat_base for s in pool.sessions] == \
        [s._lat_base for s in ref_pool.sessions]
    assert sum(s._lat_base > 0 for s in pool.sessions) >= 2
    s0 = pool.sessions[0]
    assert s0._consumed_samples < s0._jitter_pos        # a rebase
    np.testing.assert_array_equal(pool.read_block(), ref_pool.read_block())


def _published(dev: dict) -> dict:
    """A published set's device tables by name (the lattices apart)."""
    out = {}
    for name, v in dev.items():
        if isinstance(v, tuple):
            out.update((f"{name}{j}", t) for j, t in enumerate(v))
        elif isinstance(v, torch.Tensor):
            out[name] = v
    return out


def test_serve_scatters_many_changed_sessions_into_a_copy(monkeypatch):
    # ten of twelve sessions fed between two builds, and ten lattice windows
    # sliding on one build (their seeds share a stagger at a 0.25 s window):
    # only their rows are rebuilt, scattered into a copy of the set that
    # the ticks read, which stays as it was published
    seeds = [4 * k for k in range(10)] + [5, 10]

    def mk():
        pool = pstream.StreamPool(12, voice="plain", language="english",
                                  block=BLOCK, jitter_horizon_s=0.25,
                                  pin_elems=64, seeds=seeds, device="cpu")
        for i in range(12):
            pool.feed(i, TEXTS[i % N])
            pool.flush(i)
        return pool

    pool, twin = mk(), mk()
    lattices = {id(s._lattice): i for i, s in enumerate(pool.sessions)}
    built = {"scores": [], "lattices": []}
    build_score = pstream.StreamSession._build_score
    rows = pstream._IncrementalLattice.rows

    def count_scores(s, pad_to):
        if s._pool_ref[0] is pool:
            built["scores"].append(s._pool_ref[1])
        return build_score(s, pad_to)

    def count_lattices(lat, cells):
        if id(lat) in lattices:
            built["lattices"].append(lattices[id(lat)])
        return rows(lat, cells)

    monkeypatch.setattr(pstream.StreamSession, "_build_score", count_scores)
    monkeypatch.setattr(pstream._IncrementalLattice, "rows", count_lattices)
    pool.serve_start(period=9999)
    twin._prepare_tick()                # serve_start's first build
    many = {"scores": 0, "lattices": 0}
    for k in range(32):
        if k == 3:
            for p in (pool, twin):
                for i in range(1, 11):
                    p.feed(i, " more")
                    p.flush(i)
        pub = _published((pool._swap_pending or pool._serve_cur)["dev"])
        held = {name: t.clone() for name, t in pub.items()}
        for v in built.values():
            v.clear()
        if pool._serve_build():
            new = _published(pool._swap_pending["dev"])
            for name, t in pub.items():
                assert torch.equal(t, held[name]), (k, name)
            for what, names in (("scores", ("n", "scal", "vec", "par")),
                                ("lattices", ("lat0", "lat1", "lat2",
                                              "lat_base"))):
                if built[what]:
                    assert all(new[x] is not pub[x] for x in names), k
        for what, ids in built.items():
            assert len(ids) < 12, (k, what)
            if len(ids) > 8:
                many[what] += 1
        if k == 3:
            assert sorted(built["scores"]) == list(range(1, 11))
        np.testing.assert_array_equal(pool.serve_tick().numpy(),
                                      twin.read_block())
    pool.serve_stop()
    assert many == {"scores": 1, "lattices": 1}
    np.testing.assert_array_equal(pool.read_block(), twin.read_block())


def test_pin_elems_fixes_the_bucket_as_jax_does():
    Es = []
    for mod, kw in ((jstream, dict(backend="fused_interpret")),
                    (pstream, dict(device="cpu"))):
        pool = mod.StreamPool(2, voice="plain", language="english",
                              block=BLOCK, pin_elems=48, **kw)
        pool.feed(0, "hi")
        pool.flush(0)
        dev = pool._prepare_tick()
        E = (np.asarray(dev["scores"].length).shape[1] if mod is jstream
             else dev["n"].shape[1])
        Es.append((E, pool._cache_key[0], pool._quiet[2], pool._quiet[4]))
    assert Es[0] == Es[1] == (64, 64, 64, 48)
    assert pstream._bucket(48) == 64
    # no pin: the bucket follows the score
    pool = pstream.StreamPool(1, voice="plain", language="english",
                              device="cpu")
    pool.feed(0, "hi")
    pool.flush(0)
    assert pool._prepare_tick()["n"].shape[1] == 16


def test_growth_past_the_pin_publishes_a_new_set():
    def mk():
        pool = pstream.StreamPool(2, voice="plain", language="english",
                                  block=BLOCK, pin_elems=16, device="cpu")
        pool.feed(0, "hi")
        pool.flush(0)
        return pool

    long = ("a much longer feed that grows the element bucket past its pin "
            "for sure, yes indeed it does grow")
    ref_pool, pool = mk(), mk()
    pool.serve_start(period=9999)
    np.testing.assert_array_equal(pool.serve_tick().numpy(),
                                  ref_pool.read_block())
    E0 = pool._cache_key[0]
    cur = pool._serve_cur
    for p in (pool, ref_pool):
        p.feed(0, long)
        p.flush(0)
    assert pool._serve_build()
    assert pool._cache_key[0] > E0 == 16
    np.testing.assert_array_equal(pool.serve_tick().numpy(),
                                  ref_pool.read_block())
    assert pool._serve_cur is not cur
    assert pool._serve_cur["dev"]["n"].shape[1] == pool._cache_key[0]
    pool.serve_stop()


def test_checkpoints_raise_while_serving_and_work_after():
    pool = _fed(pstream, device="cpu")
    twin = _fed(pstream, device="cpu")
    blob = pool.save()
    pool.serve_start(period=0.05)
    try:
        got = [pool.serve_tick().numpy() for _ in range(3)]
        for call in (pool.save, lambda: pool.load(blob),
                     pool.sessions[0].save_state,
                     lambda: pool.sessions[0].load_state(b"ignored")):
            with pytest.raises(RuntimeError, match="serve"):
                call()
        with pytest.raises(RuntimeError, match="serve"):
            pool.read_block()
    finally:
        pool.serve_stop()
    pool.serve_stop()                    # a second stop is a no-op
    with pytest.raises(RuntimeError, match="serve_start"):
        pool.serve_tick()
    ref = [twin.read_block() for _ in range(3)]
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    # after serve_stop the same calls work, and the pool continues exactly
    # as one that was never served
    payload = pool.sessions[0].save_state()
    pool.sessions[0].load_state(payload)
    pool.load(pool.save())
    np.testing.assert_array_equal(pool.read_block(), twin.read_block())
    np.testing.assert_array_equal(pool.read_block(), twin.read_block())


def test_held_outputs_outlive_later_ticks():
    # a sink holds tick k while ticks k+1..k+3 are served
    pool, twin = _fed(pstream, device="cpu"), _fed(pstream, device="cpu")
    ref = [twin.read_block() for _ in range(6)]
    pool.serve_start(period=9999)
    held = [pool.serve_tick() for _ in range(2)]
    later = [pool.serve_tick() for _ in range(4)]
    pool.serve_stop()
    for t, r in zip(held + later, ref):
        np.testing.assert_array_equal(t.numpy(), r)


def _wait(cond, timeout=20.0):
    import time

    t = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < t, "timed out"
        time.sleep(0.002)


def test_a_failed_frontend_cycle_reaches_the_tick(monkeypatch):
    # a frontend cycle that raises publishes nothing, hands its error to
    # the next serve_tick, and the next cycle retries the publish
    pool = _fed(pstream, device="cpu")
    pool.serve_start(period=0.01)
    try:
        pool.serve_tick()
        key = pool._serve_pub_key
        real, failed = pool._prepare_tick, []

        def fails_once(samples=None):
            if not failed:
                failed.append(True)
                raise ValueError("frontend fault")
            return real(samples)

        monkeypatch.setattr(pool, "_prepare_tick", fails_once)
        pool.feed(1, " more")
        pool.flush(1)
        _wait(lambda: failed)
        with pytest.raises(RuntimeError, match="frontend") as e:
            _wait(lambda: pool._serve_error is not None)
            pool.serve_tick()
        assert isinstance(e.value.__cause__, ValueError)
        _wait(lambda: pool._serve_pub_key != key)   # the retry published
        assert np.isfinite(pool.serve_tick().numpy()).all()
    finally:
        pool.serve_stop()


def test_serve_mode_threaded_soak():
    # the frontend rebuilds on its own period while a feeder thread feeds
    # and this thread runs the real-time ticks: no exceptions, finite
    # audio, someone speaks, and the lockstep counters lose no tick
    pool = pstream.StreamPool(N, voice="plain", language="english",
                              block=BLOCK, pin_elems=64, device="cpu")
    pool.feed(0, "hello")
    pool.flush(0)
    errors = []

    def feeder():
        import random

        rng = random.Random(0)
        try:
            for _ in range(40):
                i = rng.randrange(N)
                pool.feed(i, rng.choice(["go ", "on ", "hi ", "la "]))
                pool.flush(i)
        except Exception as e:           # reported by the assertion below
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        pool.serve_start(period=0.005)
        th = threading.Thread(target=feeder)
        th.start()
        blocks = []
        try:
            for _ in range(60):
                blocks.append(pool.serve_tick().numpy())
        finally:
            th.join(timeout=60)
            pool.serve_stop()
    finally:
        sys.setswitchinterval(switch)
    assert not th.is_alive()
    assert not errors, errors
    audio = np.concatenate(blocks, axis=1)
    assert np.isfinite(audio).all()
    assert np.abs(audio).max() > 0.01
    assert pool._serve_ticks == 60
    assert [s._jitter_pos for s in pool.sessions] == [60 * BLOCK] * N
    assert np.isfinite(pool.read_block()).all()


def test_paced_run_counts_every_tick():
    # benchmarks/serve_paced's paced run on the CPU pool: every tick reaches
    # the sink in order, the frontend cycles on its own period, the feeder
    # feeds, and the pool reads on after it (its times say nothing here)
    from grail_tpu_torch.benchmarks import serve_paced

    pool = _fed(pstream, device="cpu")
    r = serve_paced.paced(pool, seconds=0.3)
    period = BLOCK / pool.sample_rate
    assert r["ticks"] == int(0.3 / period) == pool._serve_ticks
    # grail_tpu's cadence: 12 feeds a second over the pool, 7 periods apart
    # at least (one feed, at tick 0, in this run)
    assert r["feed_every"] == max(7, int(np.ceil(12 / (N * period))))
    assert r["captures"] == 0
    assert r["frontend_cycles"] > 0
    assert set(r["misses"]) == {1, 2, 3}
    assert r["misses"][1] >= r["misses"][2] >= r["misses"][3] >= 0
    assert np.isfinite(pool.read_block()).all()
