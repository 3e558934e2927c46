"""The port's core backend (backend="core", grail_tpu's "pallas") on the CPU:
its per-sample prep (sequencer, jitter, coefficient streams) and the plain
version of its recurrence kernel against the JAX package's functions, and
its unsplit and split programs against grail_tpu's pallas programs (the
Pallas kernel in interpret mode), from the same numpy inputs.

Tolerances, each with its reason:
  * integers and selections (valid masks, element picks, Lehmer seeds, the
    Q32 carrier phase) are bit-equal;
  * the sequencer's frames are bit-equal to eager JAX's, which rounds
    every op on its own as the port does; against jitted JAX they agree
    within 16 ulps of each field's largest value: XLA:CPU contracts a*b+c
    into one FMA (the blend alpha's t = C - k1*dt, which cancels near an
    element's end; the lerps), the port never does;
  * the jitter and the coefficient streams likewise: bit-equal to eager
    JAX, within a few ulps of each field's largest value of jitted JAX;
  * audio: < -100 dB per utterance and max-abs <= 1e-5 (the same algorithm
    in the same precision, tests/test_torch_fused.py's bound); the split
    against the unsplit program < -90 dB (the JAX suite's own bound); the
    oracle < -60 dB (the fidelity gate).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import grail_tpu.api as japi
import grail_tpu.synth.kernel as jkernel
from grail_tpu import languages
from grail_tpu.oracle import oracle_pipeline
from grail_tpu.synth import jitter as jjit
from grail_tpu.synth import sequencer as jseq
from grail_tpu.synth.elem import SynthesisElem as JElem
from grail_tpu.synth.jitter import JitterLattice, build_lattice
from grail_tpu.synth.schedule import device_window
from grail_tpu.synth.score import stack_scores
from grail_tpu.synth.synthesize import SynthState as JState
from grail_tpu.voices import get_voice
from grail_tpu.voices.preset_generic import SPEC

import grail_tpu_torch as g
import grail_tpu_torch.api as papi
from grail_tpu_torch import convert
from grail_tpu_torch.synth import jitter as pjit
from grail_tpu_torch.synth import kernel as pk
from grail_tpu_torch.synth import sequencer as pseq
from grail_tpu_torch.synth.elem import SynthesisElem as PElem
from grail_tpu_torch.utils import sample_error_db, spectral_error_db

torch.set_num_threads(2)

TEXTS = ["ae", "ea"]
SEEDS = [0, 1]
BLK = 4096


def _close(port, ref, ulps=4):
    """Within `ulps` units in the last place of the field's largest value."""
    port, ref = np.asarray(port, np.float32), np.asarray(ref, np.float32)
    assert port.shape == ref.shape
    scale = np.spacing(np.float32(max(np.abs(ref).max(), 1e-30)))
    assert np.abs(port - ref).max() <= ulps * scale


def _scores(texts, voice):
    """JAX scores padded to one element count, and the port's batched Score
    of tensors from the same numpy leaves."""
    E = max(japi.text_to_score(t, voice).num_elems for t in texts)
    scores = [japi.text_to_score(t, voice, pad_to=E) for t in texts]
    b = stack_scores(scores)
    ps = convert.score_from_numpy([np.asarray(f) for f in b.elem],
                                  b.has_sound, b.length, b.blend_length,
                                  b.cum_length)
    return scores, ps


# ---------------------------------------------------------------------------
# sequencer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate", [None, 22050])
def test_expand_score_matches_jax(rate):
    v = get_voice("generic")
    if rate:
        v = v.resampled(float(rate))
    sr = float(v.sample_rate)
    scores, ps = _scores(["aeae", "ea"], v)
    ps = ps.to("cpu")
    n_end = japi._score_num_samples(scores[0], sr)
    jfun = jax.jit(lambda s, off: jseq.expand_score(s, sr, BLK, offset=off))
    # start, mid-utterance, the split's pre-roll, past the end
    offsets = [0, n_end // 2, -BLK, n_end - BLK // 2]
    for pair in (offsets[:2], offsets[2:]):
        pe, pv = pseq.expand_score(ps, sr, BLK, offset=torch.tensor(pair))
        pf, pfv = pseq.expand_frequency(ps, sr, BLK,
                                        offset=torch.tensor(pair))
        # one prelude: the frequency stream is expand_score's, bit for bit
        assert torch.equal(pf, pe.frequency) and torch.equal(pfv, pv)
        for lane, off in enumerate(pair):
            # eager JAX rounds every op on its own, as the port does
            je, jv = jseq.expand_score(scores[lane], sr, BLK, offset=off)
            np.testing.assert_array_equal(pv[lane].numpy(), np.asarray(jv))
            for x, y in zip(pe, je):
                np.testing.assert_array_equal(x[lane].numpy(), np.asarray(y))
            jf, _ = jseq.expand_frequency(scores[lane], sr, BLK, offset=off)
            np.testing.assert_array_equal(pf[lane].numpy(), np.asarray(jf))
            # jitted, XLA:CPU contracts t = C - k1*dt into one FMA; t cancels
            # near an element's end, so alpha moves by up to ulp(C) /
            # blend_length and a blended field by |cur - nxt| times that
            # (6 ulps of the field's largest value measured)
            je, jv = jfun(scores[lane], jnp.int32(off))
            np.testing.assert_array_equal(pv[lane].numpy(), np.asarray(jv))
            for x, y in zip(pe, je):
                _close(x[lane].numpy(), y, ulps=16)
    # one int offset for every lane
    pe, pv = pseq.expand_score(ps, sr, BLK, offset=BLK)
    for lane in range(2):
        je, jv = jseq.expand_score(scores[lane], sr, BLK, offset=BLK)
        np.testing.assert_array_equal(pv[lane].numpy(), np.asarray(jv))
        for x, y in zip(pe, je):
            np.testing.assert_array_equal(x[lane].numpy(), np.asarray(y))


# ---------------------------------------------------------------------------
# jitter
# ---------------------------------------------------------------------------

def _frames(rng, B, T):
    """Random frames in the synthesizer's ranges, [B, T(, 8)] numpy."""
    u = lambda lo, hi, *s: (lo + (hi - lo) * rng.random(s)).astype(np.float32)
    return [u(0.002, 0.006, B, T), u(0.02, 0.07, B, T, 8),
            u(0.001, 0.004, B, T, 8), u(0.02, 0.05, B, T, 8),
            u(0.0, 0.5, B, T, 8), u(0.0, 0.5, B, T, 8),
            u(0.0, 0.3, B, T, 8)]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("per_lane", [False, True])
def test_apply_jitter_matches_jax(masked, per_lane):
    rng = np.random.default_rng(7)
    B, T, inc = 2, BLK, get_voice("generic").jitter_frequency
    fields = _frames(rng, B, T)
    mask = rng.random((B, T)) > 0.2
    lat = JitterLattice(*(np.stack(f) for f in zip(
        *(build_lattice(sd, 3 * T, inc) for sd in (3, 4)))))
    phi, cell = device_window(inc, 0, 3 * T)
    start = T + 17
    if per_lane:
        deltas = [np.asarray(d, np.float32) for d in
                  ([0.01, 0.02], [0.003, 0.001], [0.2, 0.5])]
    else:
        deltas = [np.float32(d) for d in (0.01, 0.003, 0.2)]
    ax = 0 if per_lane else None

    def one(f, lt, m, df, dff, da):
        return jjit.apply_jitter(JElem(*f), lt, df, dff, da,
                                 jjit.sched_slice((phi, cell), start, T),
                                 mask=m if masked else None)

    run = jax.vmap(one, in_axes=(0, 0, 0, ax, ax, ax))
    args = ([jnp.asarray(f) for f in fields], lat, jnp.asarray(mask), *deltas)
    plat = pjit.lattice_to(lat, "cpu")
    psched = pjit.sched_slice(convert.schedule_from_numpy(phi, cell), start,
                              T)
    pdel = [torch.from_numpy(d) if per_lane else float(d) for d in deltas]
    pout = pjit.apply_jitter(PElem(*fields).to("cpu"), plat, *pdel, psched,
                             mask=torch.from_numpy(mask) if masked else None)
    # eager JAX: bit for bit; jitted (FMA-contracted lerps): a few ulps
    for x, y in zip(pout, run(*args)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    for x, y in zip(pout, jax.jit(run)(*args)):
        _close(x.numpy(), y)
    # the fields jitter does not touch pass through unchanged
    assert np.array_equal(pout.formant_bw.numpy(), fields[2])


def test_sched_slice_per_lane_rows():
    phi = torch.arange(100, dtype=torch.float32)
    cell = torch.arange(100, dtype=torch.int32)
    p, c = pjit.sched_slice((phi, cell), torch.tensor([3, 50]), 8)
    assert p.shape == (2, 8) and p[1, 0] == 50 and c[0, 7] == 10
    with pytest.raises(ValueError, match="outside"):
        pjit.sched_slice((phi, cell), 95, 8)


# ---------------------------------------------------------------------------
# the DSP core: prep streams and the recurrence
# ---------------------------------------------------------------------------

def _core_inputs(seed, B, T):
    rng = np.random.default_rng(seed)
    fields = [np.moveaxis(f, 0, 1).copy() for f in _frames(rng, B, T)]
    f8 = lambda: (rng.standard_normal((B, 8)) * 1e-3).astype(np.float32)
    state = (np.asarray([0.25, 0.9], np.float32)[:B], f8(), f8(), f8(),
             np.asarray([12345, 2 ** 32 - 5], np.uint32)[:B])
    return fields, state


def _jstate(st):
    return JState(*(jnp.asarray(x) for x in st))


def test_precompute_streams_matches_jax():
    fields, st = _core_inputs(1, 2, 1024)
    args = (JElem(*(jnp.asarray(f) for f in fields)), _jstate(st))
    ps, pph, pseed = pk.precompute_streams(PElem(*fields).to("cpu"),
                                           convert.state_from_numpy(*st))
    # eager JAX: every stream bit for bit
    js, jph, jseed = jkernel.precompute_streams(*args)
    for x, y in zip(ps, js):
        assert x.shape == (1024, 8, 2) and x.is_contiguous()
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    # jitted: the seed and the Q32 phase bit for bit, the streams (FMA-
    # contracted products) within a few ulps
    js, jph, jseed = jax.jit(jkernel.precompute_streams)(*args)
    np.testing.assert_array_equal(pseed.numpy(),
                                  np.asarray(jseed).astype(np.int64))
    np.testing.assert_array_equal(pph.numpy().view(np.int32),
                                  np.asarray(jph).view(np.int32))
    for x, y in zip(ps, js):
        _close(x.numpy(), y, ulps=8)


def test_carrier_phase_and_noise_bit_equal():
    from grail_tpu.synth import synthesize as jsyn
    from grail_tpu_torch.synth import synthesize as psyn

    rng = np.random.default_rng(3)
    f = (0.001 + 0.01 * rng.random((3000, 2))).astype(np.float32)
    p0 = np.asarray([0.0, 0.999], np.float32)
    jp, jpo = jsyn.carrier_phase(jnp.asarray(f), jnp.asarray(p0))
    pp, ppo = psyn.carrier_phase(torch.from_numpy(f), torch.from_numpy(p0))
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ppo.numpy(), np.asarray(jpo))
    seed = np.asarray([7, 2 ** 32 - 1], np.uint32)
    jn, js = jsyn.block_noise(jnp.asarray(seed), 500)
    pn, ps = psyn.block_noise(torch.from_numpy(seed.astype(np.int64)), 500)
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js).astype(np.int64))


def test_synth_core_reference_matches_jax_kernel():
    # the recurrence alone, on the JAX prep's own streams: one jit computes
    # the streams and runs the interpreted kernel on them
    fields, st = _core_inputs(2, 2, 512)
    run = jax.jit(lambda e, s: (jkernel.precompute_streams(e, s)[0],
                                jkernel.synth_core_pallas(e, s,
                                                          interpret=True)))
    js, (ja, jst) = run(JElem(*(jnp.asarray(f) for f in fields)), _jstate(st))
    pstate = convert.state_from_numpy(*st)
    lp, b, c = (x.T.contiguous() for x in pstate[1:4])
    pa, plp, pb, pc = pk.synth_core_reference(
        [torch.from_numpy(np.array(x)) for x in js], lp, b, c)
    ja = np.asarray(ja)
    assert pa.shape == ja.shape == (512, 2)
    for lane in range(2):
        assert sample_error_db(pa[:, lane].numpy(), ja[:, lane]) < -100
    assert np.abs(pa.numpy() - ja).max() <= 1e-5
    for x, y in ((plp, jst.filter_state_a), (pb, jst.filter_state_b),
                 (pc, jst.filter_state_c)):
        np.testing.assert_allclose(x.T.numpy(), np.asarray(y), atol=1e-6)


def test_synth_core_state_continues_like_jax():
    # two calls with the state carried, against synth_core_pallas
    # (interpret) the same way (tests/test_kernel.py's continuity test)
    fields, st = _core_inputs(4, 2, 512)
    run = jax.jit(lambda e, s: jkernel.synth_core_pallas(e, s,
                                                         interpret=True))
    halves = [[f[:256] for f in fields], [f[256:] for f in fields]]
    jst, pst = _jstate(st), convert.state_from_numpy(*st)
    for h in halves:
        ja, jst = run(JElem(*(jnp.asarray(f) for f in h)), jst)
        pa, pst = pk.synth_core(PElem(*h).to("cpu"), pst, "plain")
        assert np.abs(pa.numpy() - np.asarray(ja)).max() <= 1e-5
    np.testing.assert_array_equal(pst.seed.numpy(),
                                  np.asarray(jst.seed).astype(np.int64))
    np.testing.assert_array_equal(pst.phase.numpy().view(np.int32),
                                  np.asarray(jst.phase).view(np.int32))
    for k in ("filter_state_a", "filter_state_b", "filter_state_c"):
        np.testing.assert_allclose(getattr(pst, k).numpy(),
                                   np.asarray(getattr(jst, k)), atol=1e-6)
    # one call over the whole: the same Lehmer state, and the same filter
    # state but for the carried phase, which the halves round to f32 at the
    # seam (as grail_tpu's carrier_phase returns it)
    _, pst_full = pk.synth_core(PElem(*fields).to("cpu"),
                                convert.state_from_numpy(*st), "plain")
    assert torch.equal(pst_full.seed, pst.seed)
    torch.testing.assert_close(pst_full.filter_state_b, pst.filter_state_b,
                               rtol=0, atol=1e-6)


def test_synth_core_dispatch():
    fields, st = _core_inputs(5, 2, 64)
    elems, state = PElem(*fields).to("cpu"), convert.state_from_numpy(*st)
    with pytest.raises(ValueError, match="CUDA"):
        pk.synth_core(elems, state, "kernel")
    with pytest.raises(ValueError, match="impl"):
        pk.synth_core(elems, state, "cuda")


# ---------------------------------------------------------------------------
# the programs
# ---------------------------------------------------------------------------

def _case(texts=TEXTS, seeds=SEEDS):
    v = get_voice("generic")
    sr = float(v.sample_rate)
    scores, ps = _scores(texts, v)
    Ns = [japi._score_num_samples(s, sr) for s in scores]
    jp = tuple(jnp.float32(x) for x in (
        v.jitter_frequency, v.jitter_delta_frequency,
        v.jitter_delta_formant_frequency, v.jitter_delta_amplitude))

    def lattices(T):
        return JitterLattice(*(np.stack(f) for f in zip(
            *(build_lattice(sd, T, v.jitter_frequency) for sd in seeds))))

    pscores = [convert.score_from_numpy([np.asarray(f) for f in s.elem],
                                        s.has_sound, s.length, s.blend_length,
                                        s.cum_length) for s in scores]
    return dict(v=v, sr=sr, batched=stack_scores(scores), Ns=Ns, jp=jp,
                lattices=lattices, pscores=pscores, seeds=seeds)


@functools.lru_cache(maxsize=None)
def _unsplit():
    c = _case()
    T = japi._round_up(max(c["Ns"]), BLK)
    inc = c["v"].jitter_frequency
    out = np.asarray(japi._synth_jit_batch(
        c["batched"], c["lattices"](T), c["jp"], jnp.float32(c["sr"]),
        device_window(inc, 0, T), T, backend="pallas_interpret"))
    port = [o.numpy() for o in g.synthesize_scores(
        c["pscores"], "generic", c["seeds"], device="cpu", backend="core")]
    return c, [out[i, :n] for i, n in enumerate(c["Ns"])], port


def _assert_matches(port, ref):
    for o, r in zip(port, ref):
        assert o.shape == r.shape
        assert sample_error_db(o, r) < -100
        assert np.abs(o - r).max() <= 1e-5


def test_unsplit_core_program_matches_jax_pallas():
    _, ref, port = _unsplit()
    _assert_matches(port, ref)


@pytest.mark.parametrize("S", [2, 4])
def test_split_core_program_matches_jax_split(S, monkeypatch):
    # grail_tpu's split program runs its Pallas kernel compiled for the TPU;
    # interpret it here, as tests/test_split.py does (the shapes differ from
    # that file's, so no jit cache entry traced without the patch is hit)
    orig = jkernel.synth_core_pallas
    monkeypatch.setattr(jkernel, "synth_core_pallas",
                        lambda e, s, interpret=False: orig(e, s,
                                                           interpret=True))
    c = _case()
    T = japi._round_up(max(c["Ns"]), S * BLK)
    inc = c["v"].jitter_frequency
    out = np.asarray(japi._synth_jit_split(
        c["batched"], c["lattices"](T), c["jp"], jnp.float32(c["sr"]),
        device_window(inc, -japi.WARMUP, T + japi.WARMUP), T, S))
    port = [o.numpy() for o in papi._synthesize_split(
        c["pscores"], "generic", c["seeds"], S=S, device="cpu",
        backend="core")]
    _assert_matches(port, [out[i, :n] for i, n in enumerate(c["Ns"])])
    # and the split against the port's own unsplit program
    for o, r in zip(port, _unsplit()[2]):
        assert sample_error_db(o, r) < -90


def test_core_backend_matches_oracle():
    # utterance 0 is synthesize("ae"), seed 0
    port = _unsplit()[2][0]
    gold = oracle_pipeline("ae", SPEC, languages.generic())
    assert spectral_error_db(port, gold) < -60
    assert sample_error_db(port, gold) < -55


def test_core_pre_pass_matches_port_stream():
    # the pre-pass's seam phases are the Q32 phase that the split's
    # frequency stream (jitter masked off past the end) reaches at each
    # block boundary
    c = _case()
    S = 4
    T = japi._round_up(max(c["Ns"]), S * BLK)
    b = papi._Batch(c["pscores"], "generic", c["seeds"])
    lanes = b.core_lanes(T, "cpu")
    sched = g.synth.schedule.device_window(b.v0.jitter_frequency,
                                           -papi.WARMUP, T + papi.WARMUP,
                                           "cpu")
    q = papi._core_pre_pass(lanes, T, c["sr"], sched)
    assert q.shape == (T // BLK, 2) and bool((q[0] == 0).all())
    full = device_window(b.v0.jitter_frequency, 0, T)
    f, valid = pseq.expand_score(lanes.score, c["sr"], T)
    f = pjit.apply_jitter(f, lanes.lattice, *lanes.deltas,
                          convert.schedule_from_numpy(*full),
                          mask=valid).frequency
    fq = (f * 2.0 ** 32).to(torch.int64)
    want = (torch.cumsum(fq, 1) - fq)[:, ::BLK].T & 0xFFFFFFFF
    assert torch.equal(q, want)


# ---------------------------------------------------------------------------
# backend names and routing
# ---------------------------------------------------------------------------

def test_backend_names():
    sc = [g.text_to_score("ae")]
    a = g.synthesize_scores(sc, device="cpu", backend="pallas")[0]
    b = g.synthesize_scores(sc, device="cpu", backend="core")[0]
    assert torch.equal(a, b)
    # grail_tpu's '_interpret' names are other names of the same programs,
    # and None is the default backend
    c = g.synthesize_scores(sc, device="cpu", backend="pallas_interpret")[0]
    assert torch.equal(a, c)
    assert torch.equal(
        g.synthesize_scores(sc, device="cpu", backend="fused_interpret")[0],
        g.synthesize_scores(sc, device="cpu", backend=None)[0])
    for bad in ("wat", "Fused", 3):
        with pytest.raises(ValueError, match="backend"):
            g.synthesize_scores(sc, device="cpu", backend=bad)
        with pytest.raises(ValueError, match="backend"):
            g.synthesize_batch(["ae"], device="cpu", backend=bad)
    for ec in (True, "kernel"):
        with pytest.raises(ValueError, match="exact_carrier"):
            g.synthesize_scores(sc, device="cpu", backend="core",
                                exact_carrier=ec)


def test_route_core_backend():
    sr = 44100.0
    long_n = int(31 * sr)
    for be in ("core", "pallas"):
        assert g.route(2, 1000, None, "cpu", sr, be) == ("plain", "q32", 1,
                                                         4096)
        # no automatic exact carrier: Q32 at any length, as in grail_tpu
        assert g.route(1, long_n, None, "cpu", sr, be) == (
            "plain", "q32", 1, 334 * 4096)
        assert g.route(1, 1000, False, "cpu", sr, be)[1] == "q32"
        with pytest.raises(ValueError, match="exact_carrier"):
            g.route(1, 1000, True, "cpu", sr, be)
    with pytest.raises(ValueError, match="backend"):
        g.route(1, 1000, None, "cpu", sr, "wat")
    # the other programs' names route too (tests/test_torch_xla_core.py)
    assert g.route(1, 1000, None, "cpu", sr, "xla")[2:] == (1, 4096)
