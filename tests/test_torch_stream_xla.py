"""The port's xla tick (runtime/stream._xla_tick: StreamPool(backend="xla"),
pools and sessions at a block that is not a multiple of 128, and serve mode
on such a pool) against grail_tpu's xla pools and sessions on the CPU, where
the port runs the two recurrences' plain versions; and a long session read
against the oracle.

Tolerances: audio sample_error_db < -100 per session (the same algorithm in
the same precision; XLA:CPU contracts a*b+c into FMAs and the port never
does); the jitter state, the Lehmer seeds and the host counters bit for
bit; serve mode against the port's own read_block bit for bit. The long
read: the fidelity gate, < -60 dB against the oracle's DSP chain.
"""

import numpy as np
import pytest
import torch

from grail_tpu.runtime import stream as jstream

from grail_tpu_torch.oracle.native import gold_dsp_chain
from grail_tpu_torch.runtime import stream as pstream
from grail_tpu_torch.synth import kernel_fused as kf
from grail_tpu_torch.utils import sample_error_db, spectral_error_db
from grail_tpu_torch.voices import get_spec

torch.set_num_threads(2)

FEEDS = {0: "[rate:8]hello hello", 1: "[pitch:180]aeio"}   # 2 idles
SEEDS = [3, 7, 6]
SAMPLES = 30 * 1024        # per pool run, whatever the block
# the long-form text of benchmarks/fidelity_suite.py: 86.5 s with voice
# plain, english
LONG_EN = ("the quick brown fox jumps over the lazy dog, while seventeen "
           "synthesizers hum along in the hall. is anyone still listening "
           "to this? the formants drift on and on.")


def _pool_kw(block):
    return dict(voice="plain", language="english", block=block,
                jitter_horizon_s=0.3, seeds=SEEDS)


def _feed(pool):
    for i, text in FEEDS.items():
        pool.feed(i, text, parse_commands=True)
    pool.flush()


def _read(pool, n, to_np=np.asarray):
    return np.concatenate([to_np(pool.read_block()) for _ in range(n)],
                          axis=1)


@pytest.fixture(scope="module", params=[(1024, "xla"), (441, None)],
                ids=["xla-1024", "block-441"])
def pools(request):
    """(jax pool, port pool, jax audio, port audio): grail_tpu's xla pool
    and the port's, fed alike, each read SAMPLES samples, lattice windows
    sliding."""
    block, backend = request.param
    jp = jstream.StreamPool(3, backend="xla", **_pool_kw(block))
    pp = pstream.StreamPool(3, device="cpu", backend=backend,
                            **_pool_kw(block))
    for p in (jp, pp):
        _feed(p)
    n = SAMPLES // block
    return jp, pp, _read(jp, n), _read(pp, n)


def test_xla_pool_audio_matches_jax(pools):
    jp, pp, ja, pa = pools
    assert pp.backend == jp.backend == "xla"
    assert pa.shape == ja.shape and pa.dtype == np.float32
    for i in (0, 1):
        assert sample_error_db(pa[i], ja[i]) < -100, i
        assert np.abs(pa[i]).max() > 0.01
    np.testing.assert_array_equal(pa[2], ja[2])          # idle: silence


def test_xla_pool_state_matches_jax(pools):
    jp, pp, _, _ = pools
    jphi, jcell = pp._jstates
    np.testing.assert_array_equal(jphi.numpy().view(np.int32),
                                  np.asarray(jp._jstates[0]).view(np.int32))
    np.testing.assert_array_equal(jcell.numpy(), np.asarray(jp._jstates[1]))
    np.testing.assert_array_equal(pp._si[:, 1].numpy().view(np.uint32),
                                  np.asarray(jp._states.seed))
    for attr in ("_consumed_samples", "_jitter_pos", "_lat_base"):
        assert ([getattr(s, attr) for s in pp.sessions]
                == [getattr(s, attr) for s in jp.sessions]), attr
    assert sum(s._lat_base > 0 for s in pp.sessions) >= 2   # slides ran


def test_block_441_session_matches_jax():
    kw = dict(voice="plain", language="english", block=441, seed=5)
    js = jstream.StreamSession(**kw)
    ps = pstream.StreamSession(device="cpu", **kw)
    for s in (js, ps):
        s.feed("hello world")
        s.flush()
    ja = np.concatenate([js.read() for _ in range(60)] + [js.read(700)])
    pa = np.concatenate([ps.read() for _ in range(60)] + [ps.read(700)])
    assert pa.shape == ja.shape == (60 * 441 + 700,)
    assert sample_error_db(pa, ja) < -100
    assert ps._jitter_pos == js._jitter_pos == 62 * 441
    np.testing.assert_array_equal(ps._si[0, 1:2].numpy().view(np.uint32),
                                  np.asarray(js._state.seed).reshape(1))


@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_xla_pool_checkpoints_cross_packages(direction):
    kw = _pool_kw(441)
    src = (pstream.StreamPool(3, device="cpu", **kw)
           if direction == "port-to-jax"
           else jstream.StreamPool(3, backend="xla", **kw))
    _feed(src)
    _read(src, 20)
    blob = src.save()
    ref = _read(src, 20)
    dst = (jstream.StreamPool(3, backend="xla", **dict(kw, seeds=[9, 9, 9]))
           if direction == "port-to-jax"
           else pstream.StreamPool(3, device="cpu",
                                   **dict(kw, seeds=[9, 9, 9])))
    dst.load(blob)
    got = _read(dst, 20)
    for i in (0, 1):
        assert sample_error_db(got[i], ref[i]) < -100, i
    np.testing.assert_array_equal(got[2], ref[2])
    for a, b in zip(src.sessions, dst.sessions):
        assert a._jitter_pos == b._jitter_pos
        assert a._lattice._pitch_state.state == b._lattice._pitch_state.state


def test_serve_mode_on_an_xla_pool_equals_read_block():
    # serve mode on the xla tick: a build every tick (feeds land between
    # ticks, windows slide), bit for bit the read_block twin's
    kw = dict(_pool_kw(441), pin_elems=64, device="cpu")
    pool, twin = pstream.StreamPool(3, **kw), pstream.StreamPool(3, **kw)
    for p in (pool, twin):
        _feed(p)
    twin._prepare_tick()       # serve_start's first build, before tick 0
    pool.serve_start(period=9999)
    for t in range(80):
        if t == 7:
            for p in (pool, twin):
                p.feed(2, "go on")
                p.flush(2)
        pool._serve_build()
        got = pool.serve_tick().numpy()
        np.testing.assert_array_equal(got, twin.read_block())
        assert torch.equal(pool._sf, twin._sf)
        assert torch.equal(pool._si, twin._si)
    pool.serve_stop()
    assert sum(s._lat_base > 0 for s in pool.sessions) >= 2
    np.testing.assert_array_equal(pool.read_block(), twin.read_block())


def test_pool_backend_rules():
    for backend, block, want in (("xla", 1024, "xla"), (None, 441, "xla"),
                                 ("fused", 1000, "xla"), (None, 1024,
                                                          "fused")):
        pool = pstream.StreamPool(1, device="cpu", backend=backend,
                                  block=block)
        assert pool.backend == want
        assert pool.read_block().shape == (1, block)
    for bad in (dict(block=0), dict(backend="scan")):
        with pytest.raises(ValueError):
            pstream.StreamPool(1, device="cpu", **bad)


def test_long_session_read_matches_oracle():
    # a long StreamSession.read (86.5 s, 1 s blocks: the xla tick) against
    # the oracle's DSP chain over the session's own elements
    s = pstream.StreamSession(voice="plain", language="english",
                              block=44100, device="cpu")
    s.feed(LONG_EN)
    s.flush()
    gold = gold_dsp_chain(list(s._elements), get_spec("plain"),
                          jitter_seed=0)
    assert len(gold) > 85 * 44100
    kf_launches = dict(kf.LAUNCHES)
    out = s.read(len(gold))
    assert kf.LAUNCHES == kf_launches                 # plain on the CPU
    assert np.isfinite(out).all()
    assert spectral_error_db(out, gold) < -60
    assert sample_error_db(out, gold) < -60
