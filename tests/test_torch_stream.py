"""The port's serving path (runtime/stream.py and the fused synthesizer's
carry mode) against grail_tpu's on the CPU: the JAX pool runs
backend="fused_interpret" (its kernel in interpret mode, as its own suite
runs it), the port device="cpu" (the plain version). Both get the same
seeds, texts and commands.

Tolerances: audio sample_error_db < -100 per session and, for one tick,
max-abs <= 1e-5 (the same algorithm in the same precision; XLA:CPU
contracts a*b+c into FMAs inside the interpreted kernel and the port never
does, so the frequency stream differs by an ulp here and there and the
exact f32 carrier carries that on). The jitter state, the Lehmer seed and
every host counter agree bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from grail_tpu.api import text_to_score
from grail_tpu.runtime import stream as jstream
from grail_tpu.synth.jitter import JitterLattice, build_lattice
from grail_tpu.synth.schedule import get_schedule
from grail_tpu.synth.score import stack_scores
from grail_tpu.synth.synthesize import SynthState
from grail_tpu.voices import get_voice

from grail_tpu_torch import convert
from grail_tpu_torch.runtime import stream as pstream
from grail_tpu_torch.synth import kernel_fused as pk
from grail_tpu_torch.utils import sample_error_db

torch.set_num_threads(2)

BLOCK = 1024
TICKS = 30
FEEDS = {0: "[rate:8]hello hello", 1: "[pitch:180]aeio"}   # 2 idles
POOL = dict(voice="plain", language="english", block=BLOCK,
            jitter_horizon_s=0.3, seeds=[3, 7, 6])


def _pools(n_ticks=TICKS):
    """The JAX pool and the port's, fed alike, each read n_ticks blocks:
    (jax pool, port pool, jax audio [3, T], port audio [3, T])."""
    jp = jstream.StreamPool(3, backend="fused_interpret", **POOL)
    pp = pstream.StreamPool(3, device="cpu", **POOL)
    for p in (jp, pp):
        for i, text in FEEDS.items():
            p.feed(i, text, parse_commands=True)
        p.flush()
    ja = np.concatenate([np.asarray(jp.read_block())
                         for _ in range(n_ticks)], axis=1)
    pa = np.concatenate([pp.read_block() for _ in range(n_ticks)], axis=1)
    return jp, pp, ja, pa


@pytest.fixture(scope="module")
def pools():
    return _pools()


def test_pool_audio_matches_jax_pool(pools):
    _, _, ja, pa = pools
    assert pa.shape == ja.shape == (3, TICKS * BLOCK)
    assert pa.dtype == np.float32
    for i in (0, 1):
        assert sample_error_db(pa[i], ja[i]) < -100, i
    assert np.abs(pa[0]).max() > 0.01 and np.abs(pa[1]).max() > 0.01
    np.testing.assert_array_equal(pa[2], ja[2])          # idle: silence
    assert np.abs(pa[2]).max() < 1e-5


def test_pool_crossed_slides_and_a_rebase(pools):
    _, pp, _, _ = pools
    bases = [s._lat_base for s in pp.sessions]
    assert sum(b > 0 for b in bases) >= 2, bases         # window slides
    # a rebase drops consumed elements and moves the score's origin
    s0 = pp.sessions[0]
    assert s0._consumed_samples < s0._jitter_pos
    assert pp._lag_samples == TICKS * BLOCK


@pytest.mark.parametrize("what", [
    "lat_base", "consumed", "jitter_pos", "elements", "drift_t0", "rev",
    "offsets", "lattice_base_dev", "jitter_state", "seed"])
def test_pool_state_equals_jax_pool(pools, what):
    jp, pp, _, _ = pools

    def host(p, attr):
        return [attr(s) for s in p.sessions]

    if what == "lat_base":
        assert host(jp, lambda s: s._lat_base) == \
            host(pp, lambda s: s._lat_base)
    elif what == "consumed":
        assert host(jp, lambda s: s._consumed_samples) == \
            host(pp, lambda s: s._consumed_samples)
    elif what == "jitter_pos":
        assert host(jp, lambda s: s._jitter_pos) == \
            host(pp, lambda s: s._jitter_pos)
    elif what == "elements":
        assert host(jp, lambda s: len(s._elements)) == \
            host(pp, lambda s: len(s._elements))
    elif what == "drift_t0":
        assert host(jp, lambda s: float(s._drift_t0)) == \
            host(pp, lambda s: float(s._drift_t0))
    elif what == "rev":
        assert host(jp, lambda s: s._rev) == host(pp, lambda s: s._rev)
    elif what == "offsets":
        np.testing.assert_array_equal(pp._dev["offsets"].numpy(),
                                      np.asarray(jp._dev["offsets"]))
    elif what == "lattice_base_dev":
        np.testing.assert_array_equal(pp._lat_base_dev.numpy(),
                                      np.asarray(jp._lat_base_dev))
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


def _tick_inputs(seed=5, lat_base=(7, 3), pos=(60_000, 31_000)):
    """One tick's numpy inputs for N = 2 lanes at jitter positions `pos`
    (absolute samples) with lattice windows starting at absolute cells
    `lat_base`, score offsets into each lane's score, and a carried state
    with nonzero filters, seeds and carrier phases."""
    voice = get_voice("plain")
    inc = voice.jitter_frequency
    texts = ["hello there", "aeio"]
    E = max(text_to_score(t, voice).num_elems for t in texts)
    scores = stack_scores([text_to_score(t, voice, pad_to=E) for t in texts])
    W = 64
    lats = [build_lattice(s, 441_000, inc) for s in (11, 12)]   # 160 cells
    lattice = JitterLattice(*(np.stack([f[b:b + W] for f, b in zip(
        fs, lat_base)]) for fs in zip(*lats)))
    sched = get_schedule(inc)
    js = [sched.state_at(p) for p in pos]
    rng = np.random.default_rng(seed)
    f = lambda: (rng.standard_normal((2, 8)) * 1e-3).astype(np.float32)
    state = (np.asarray([0.25, 0.625], np.float32), f(), f(), f(),
             np.asarray([12345, 2 ** 32 - 5], np.uint32))
    return dict(voice=voice, scores=scores, lattice=lattice,
                offsets=np.asarray([30_000, 25_000], np.int32),
                jstate=(np.asarray([p for p, _ in js], np.float32),
                        np.asarray([c for _, c in js], np.int32)),
                lat_base=np.asarray(lat_base, np.int32), state=state)


def _port_tick(x, lattice=None, lat_base=None):
    """The port's serving tick (runtime/stream._tick, the plain version) on
    _tick_inputs' numpy inputs: (audio [2, BLOCK], sf, si [2, 5])."""
    v = x["voice"]
    sc = x["scores"]
    pscore = convert.score_from_numpy(
        [np.asarray(f) for f in sc.elem], sc.has_sound, sc.length,
        sc.blend_length, sc.cum_length)
    tables = pk.build_tables(
        pscore, convert.lattice_from_numpy(
            *(x["lattice"] if lattice is None else lattice)),
        (v.jitter_frequency, v.jitter_delta_frequency,
         v.jitter_delta_formant_frequency, v.jitter_delta_amplitude),
        v.sample_rate)
    sf, si = pk.state_rows(convert.state_from_numpy(*x["state"]))
    jphi, jcell = map(torch.from_numpy, x["jstate"])
    si = torch.cat([si, jphi.view(torch.int32)[:, None], jcell[:, None]],
                   dim=1).contiguous()
    dev = dict(n=tables.n, scal=tables.scal, vec=tables.vec, par=tables.par,
               lat=(tables.latp, tables.latf, tables.lata),
               lat_base=torch.from_numpy(
                   x["lat_base"] if lat_base is None else lat_base),
               offsets=torch.from_numpy(x["offsets"]),
               inc=float(np.float32(v.jitter_frequency)))
    return pstream._tick("plain", dev, sf, si, BLOCK)


def test_carry_plain_matches_jax_tick():
    x = _tick_inputs()
    v = x["voice"]
    jp = (jnp.float32(v.jitter_frequency),
          *(jnp.asarray([getattr(v, a)] * 2, jnp.float32) for a in (
              "jitter_delta_frequency", "jitter_delta_formant_frequency",
              "jitter_delta_amplitude")))
    ja, jst, joff, jjs = jstream._stream_tick_fused_body(
        x["scores"], x["lattice"], jp, jnp.float32(v.sample_rate),
        jnp.asarray(x["offsets"]), tuple(map(jnp.asarray, x["jstate"])),
        jnp.asarray(x["lat_base"]),
        SynthState(*(jnp.asarray(a) for a in x["state"])), BLOCK,
        interpret=True)
    pa, _, psi = _port_tick(x)
    ja, pa = np.asarray(ja), pa.numpy()
    assert pa.shape == ja.shape == (2, BLOCK)
    for b in range(2):
        assert np.abs(pa[b]).max() > 0.01
        assert sample_error_db(pa[b], ja[b]) < -100, b
        assert np.abs(pa[b] - ja[b]).max() <= 1e-5, b
    psi = psi.numpy()
    np.testing.assert_array_equal(psi[:, 3], np.asarray(jjs[0]).view(
        np.int32))
    np.testing.assert_array_equal(psi[:, 4], np.asarray(jjs[1]))
    np.testing.assert_array_equal(psi[:, 1].view(np.uint32),
                                  np.asarray(jst.seed))
    # the cells it stepped to are the host schedule's, bit for bit
    sched = get_schedule(v.jitter_frequency)
    for b, p in enumerate((60_000, 31_000)):
        ph, c = sched.state_at(p + BLOCK)
        assert psi[b, 4] == c
        assert psi[b, 3] == np.float32(ph).view(np.int32)


def test_carry_plain_reads_rows_relative_to_lat_base():
    # the same lattice content seen through a window that starts K cells
    # later renders the same audio: rows are read at cell - lat_base
    x = _tick_inputs(lat_base=(0, 0))
    outs = []
    for K in (0, 5):
        lat = JitterLattice(*(np.asarray(f)[:, K:] for f in x["lattice"]))
        outs.append(_port_tick(x, lat, np.full(2, K, np.int32))[0])
    assert torch.equal(outs[0], outs[1])
    # synth_fused is the host mode's entry and takes a schedule
    with pytest.raises(ValueError, match="sched"):
        pk.synth_fused(None, BLOCK, "plain")


def test_read_blocks_matches_single_ticks():
    # one launch of 2 blocks carries the state exactly as two launches do
    def run(reader):
        pool = pstream.StreamPool(2, voice="plain", language="english",
                                  block=BLOCK, device="cpu")
        pool.feed(0, "hello")
        pool.flush(0)
        pool.feed(1, "aeio")
        pool.flush(1)
        return reader(pool)

    ahead = run(lambda p: np.concatenate(
        [p.read_blocks(2), p.read_blocks(2)], axis=1))
    single = run(lambda p: np.concatenate(
        [p.read_block() for _ in range(4)], axis=1))
    assert ahead.shape == single.shape == (2, 4 * BLOCK)
    np.testing.assert_allclose(ahead, single, atol=5e-4)
    assert sample_error_db(ahead.ravel(), single.ravel()) < -60


def test_pipelined_ticks_match_sync_ticks():
    def mk():
        pool = pstream.StreamPool(2, voice="plain", language="english",
                                  block=BLOCK, device="cpu")
        pool.feed(0, "hello world ")
        pool.flush(0)
        return pool

    p1 = mk()
    sync = [p1.read_block() for _ in range(4)]
    p2 = mk()
    assert p2.tick_pipelined() is None
    piped = [p2.tick_pipelined() for _ in range(3)] + [p2.drain()]
    assert p2.drain() is None
    for a, b in zip(sync, piped):
        np.testing.assert_array_equal(a, b)


def test_solo_read_matches_jax_solo_read():
    # JAX's solo read runs its XLA block program, the port's the carry tick
    # on one lane; odd read sizes go through the residual buffer
    def feed(s):
        s.feed("hello")
        s.flush()
        return s

    js = feed(jstream.StreamSession(voice="plain", language="english",
                                    seed=2, block=BLOCK))
    ps = feed(pstream.StreamSession(voice="plain", language="english",
                                    seed=2, block=BLOCK, device="cpu"))
    ref = np.concatenate([js.read(1500), js.read(5 * BLOCK)])
    got = np.concatenate([ps.read(1500), ps.read(5 * BLOCK)])
    assert got.shape == ref.shape
    assert np.abs(got).max() > 0.01
    assert sample_error_db(got, ref) < -100
    assert ps._jitter_pos == js._jitter_pos
    assert ps._consumed_samples == js._consumed_samples


def test_output_codes_match_jax():
    rng = np.random.default_rng(3)
    x = np.concatenate([
        rng.uniform(-1.2, 1.2, 4096),
        [0.0, -0.0, 1.0, -1.0, 1e-4, -1e-4, 0.5, np.nan, np.inf, -np.inf,
         32767.5 / 32767, 2.0]]).astype(np.float32)
    for conv in ("_pcm16_body", "_ulaw_body"):
        want = np.asarray(getattr(jstream, conv)(jnp.asarray(x)))
        got = getattr(pstream, conv)(torch.from_numpy(x)).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    codes = np.arange(256, dtype=np.uint8)
    dec = pstream.ulaw_decode(codes)
    np.testing.assert_array_equal(dec, jstream.ulaw_decode(codes))
    # round trip: every code decodes to a value that encodes back to it
    # (0x7F, -0, encodes as +0 = 0xFF)
    back = pstream._ulaw_body(torch.from_numpy(
        dec.astype(np.float32) / 32767.0)).numpy()
    ok = (back == codes) | ((codes == 0x7F) & (back == 0xFF))
    assert ok.all(), codes[~ok]


@pytest.mark.parametrize("output", ["pcm16", "ulaw"])
def test_pool_output_formats(output):
    def mk(out):
        pool = pstream.StreamPool(2, voice="plain", language="english",
                                  block=BLOCK, device="cpu", output=out)
        pool.feed(0, "hello ")
        pool.flush(0)
        return np.concatenate([pool.read_block() for _ in range(3)], axis=1)

    a32 = mk("f32")
    got = mk(output)
    want = getattr(pstream, f"_{output}_body")(torch.from_numpy(a32)).numpy()
    assert got.dtype == (np.int16 if output == "pcm16" else np.uint8)
    np.testing.assert_array_equal(got, want)


def test_jax_pool_checkpoint_loads_into_the_port():
    # the state-carrying function of the slice: a JAX pool's save() blob
    # restores into the port, which continues as the JAX pool does
    kw = dict(voice="plain", language="english", block=BLOCK)
    jp = jstream.StreamPool(3, backend="fused_interpret", seeds=[3, 1, 4],
                            **kw)
    for i, t in enumerate(["hello world ", "aeio ", ""]):
        if t:
            jp.feed(i, t)
            jp.flush(i)
    for _ in range(3):
        jp.read_block()
    blob = jp.save()
    ref = np.concatenate([np.asarray(jp.read_block()) for _ in range(3)],
                         axis=1)

    pp = pstream.StreamPool(3, seeds=[9, 9, 9], device="cpu", **kw)
    pp.load(blob)
    assert [s._lattice._pitch_state.state for s in pp.sessions] == \
        [s._lattice._pitch_state.state for s in jp.sessions]
    blob2 = pp.save()
    got = np.concatenate([pp.read_block() for _ in range(3)], axis=1)
    for i in (0, 1):
        assert sample_error_db(got[i], ref[i]) < -100, i
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_array_equal(
        pp._si[:, 1].numpy().view(np.uint32), np.asarray(jp._states.seed))
    # the port's own checkpoint round-trips bit for bit
    pp2 = pstream.StreamPool(3, seeds=[0, 0, 0], device="cpu", **kw)
    pp2.load(blob2)
    again = np.concatenate([pp2.read_block() for _ in range(3)], axis=1)
    np.testing.assert_array_equal(again, got)


def test_port_pool_checkpoint_loads_into_jax():
    # the other direction: the port's pool save() blob, and one pool
    # session's save_state(), restore into grail_tpu's pools, which
    # continue as the port does
    kw = dict(voice="plain", language="english", block=BLOCK)
    pp = pstream.StreamPool(3, seeds=[3, 1, 4], device="cpu", **kw)
    for i, t in enumerate(["hello world ", "aeio ", ""]):
        if t:
            pp.feed(i, t)
            pp.flush(i)
    for _ in range(3):
        pp.read_block()
    blob = pp.save()
    session_blob = pp.sessions[0].save_state()
    ref = np.concatenate([pp.read_block() for _ in range(3)], axis=1)
    seeds = pp._si[:, 1].numpy().view(np.uint32)

    jp = jstream.StreamPool(3, backend="fused_interpret", seeds=[9, 9, 9],
                            **kw)
    jp.load(blob)
    assert [s._lattice._pitch_state.state for s in jp.sessions] == \
        [s._lattice._pitch_state.state for s in pp.sessions]
    got = np.concatenate([np.asarray(jp.read_block()) for _ in range(3)],
                         axis=1)
    for i in (0, 1):
        assert sample_error_db(got[i], ref[i]) < -100, i
    np.testing.assert_array_equal(got[2], ref[2])        # the silent lane
    np.testing.assert_array_equal(np.asarray(jp._states.seed), seeds)

    # a session's blob, into another pool's session that has read other
    # text at another pool lag
    jq = jstream.StreamPool(3, backend="fused_interpret", seeds=[5, 5, 5],
                            **kw)
    jq.feed(0, "aeio ")
    jq.flush(0)
    for _ in range(2):
        jq.read_block()
    jq.sessions[0].load_state(session_blob)
    got0 = np.concatenate([np.asarray(jq.read_block())[0] for _ in range(3)])
    assert sample_error_db(got0, ref[0]) < -100
    assert int(np.asarray(jq._states.seed)[0]) == int(seeds[0])
    assert jq.sessions[0]._jitter_pos == pp.sessions[0]._jitter_pos


def test_pool_session_checkpoint_restore():
    # a pool-owned session's load_state scatters its rows back into the
    # pool; the next tick re-renders what a restored solo session renders
    pool = pstream.StreamPool(2, voice="plain", language="english",
                              block=BLOCK, device="cpu")
    pool.feed(0, "hello world ")
    pool.flush(0)
    pool.read_block()
    blob = pool.sessions[0].save_state()
    pool.read_block()
    pool.sessions[0].load_state(blob)
    after = pool.read_block()[0]
    solo = pstream.StreamSession(voice="plain", language="english",
                                 block=BLOCK, device="cpu")
    solo.load_state(blob)
    np.testing.assert_array_equal(after, solo.read())


@pytest.mark.parametrize("kwargs,match", [
    (dict(mesh=object()), "make_mesh"),       # not a mesh
    (dict(output="wat"), "output"),
    (dict(backend="pallas"), "backend"),
])
def test_pool_rejects_what_is_not_ported(kwargs, match):
    with pytest.raises(ValueError, match=match):
        pstream.StreamPool(2, device="cpu", **kwargs)


def test_pool_backend_names_and_solo_read_on_pool_session():
    for backend in (None, "fused", "fused_interpret"):
        pool = pstream.StreamPool(1, device="cpu", backend=backend)
        assert pool.read_block().shape == (1, BLOCK)
    with pytest.raises(RuntimeError, match="StreamPool"):
        pool.sessions[0].read()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pstream.StreamPool(1)          # device="cuda" is the default
