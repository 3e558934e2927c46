"""The port's overlap-save split on the CPU: the split route against the JAX
package's split-fused program (interpret mode), against the port's own
unsplit route and against the oracle; the plain Q32 pre-pass against the JAX
pre-pass kernel; the skip-ahead seeds; and the split decision.

Tolerances, each with its reason:
  * split vs JAX split: < -110 dB per utterance, max-abs <= 1e-5. The same
    algorithm in the same precision; XLA:CPU contracts a*b+c into FMAs in
    the interpreted kernel and the port never does, so floats agree to ulps.
  * split vs unsplit: < -90 dB, max-abs < 1e-4 (the JAX suite's own bounds,
    tests/test_split.py): each segment's filter state comes from a WARMUP
    pre-roll instead of the exact history.
  * split vs oracle: the fidelity gate, < -60 dB spectral error.
  * pre-pass vs JAX: the seam phases within 256 units of 2^-32 (see
    test_pre_pass_plain_matches_jax_kernel).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import grail_tpu.api as japi
from grail_tpu import languages
from grail_tpu.core import rng as jrng
from grail_tpu.oracle import oracle_pipeline
from grail_tpu.synth.jitter import JitterLattice, build_lattice
from grail_tpu.synth.kernel_fused import phase_q32_pre_block
from grail_tpu.synth.score import stack_scores
from grail_tpu.voices import get_voice
from grail_tpu.voices.preset_generic import SPEC

import grail_tpu_torch as g
import grail_tpu_torch.api as papi
from grail_tpu_torch import convert
from grail_tpu_torch.core import rng as prng
from grail_tpu_torch.synth import kernel_fused as pk
from grail_tpu_torch.utils import sample_error_db, spectral_error_db

torch.set_num_threads(2)

TEXTS = ["ae", "ea"]
SEEDS = [0, 1]


def _case(S, rate=None, voices=("generic", "generic")):
    """JAX and port inputs for TEXTS split into S segments."""
    vs = [get_voice(v) for v in voices]
    if rate:
        vs = [v.resampled(float(rate)) for v in vs]
    sr = float(vs[0].sample_rate)
    E = max(japi.text_to_score(t, v).num_elems for t, v in zip(TEXTS, vs))
    scores = [japi.text_to_score(t, v, pad_to=E) for t, v in zip(TEXTS, vs)]
    Ns = [japi._score_num_samples(s, sr) for s in scores]
    T = japi._round_up(max(Ns), S * japi.BLOCK_SIZE)
    inc = vs[0].jitter_frequency
    lat = JitterLattice(*(np.stack(f) for f in zip(
        *(build_lattice(sd, T, inc) for sd in SEEDS))))
    multi = voices[0] != voices[1]
    deltas = [[v.jitter_delta_frequency for v in vs],
              [v.jitter_delta_formant_frequency for v in vs],
              [v.jitter_delta_amplitude for v in vs]]
    jp = (jnp.float32(inc),) + tuple(
        jnp.asarray(d, jnp.float32) if multi else jnp.float32(d[0])
        for d in deltas)
    pscores = [convert.score_from_numpy(
        [np.asarray(f) for f in s.elem], s.has_sound, s.length,
        s.blend_length, s.cum_length) for s in scores]
    pvoices = [g.get_voice(v) for v in voices]
    if rate:
        pvoices = [v.resampled(float(rate)) for v in pvoices]
    return dict(S=S, T=T, Ns=Ns, sr=sr, inc=inc, batched=stack_scores(scores),
                lat=lat, jp=jp, pscores=pscores, pvoices=pvoices)


CASES = {"S2": (2, None, ("generic", "generic")),
         "S4": (4, None, ("generic", "generic")),
         "S4_22050": (4, 22050, ("generic", "generic")),
         "S2_mixed_voice": (2, None, ("plain", "bright"))}


@functools.lru_cache(maxsize=None)
def _run_case(name):
    """A case's JAX split-fused output and the port's split and unsplit
    outputs, computed once."""
    c = _case(*CASES[name])
    S, T = c["S"], c["T"]
    pre, seg, shift = japi._split_sched(c["inc"], T, S)
    out = np.asarray(japi._synth_jit_split_fused(
        c["batched"], c["lat"], c["jp"], jnp.float32(c["sr"]), pre, seg,
        shift, T, S, interpret=True))
    c["jax"] = [out[i, :n] for i, n in enumerate(c["Ns"])]
    c["port"] = [o.numpy() for o in papi._synthesize_split(
        c["pscores"], c["pvoices"], SEEDS, S=S, device="cpu")]
    c["unsplit"] = [o.numpy() for o in papi.synthesize_scores(
        c["pscores"], c["pvoices"], SEEDS, device="cpu")]
    c["name"] = name
    return c


@pytest.fixture(params=sorted(CASES))
def split_case(request):
    return _run_case(request.param)


def test_split_matches_jax_split_fused(split_case):
    c = split_case
    assert [len(o) for o in c["port"]] == c["Ns"]
    for o, r in zip(c["port"], c["jax"]):
        assert sample_error_db(o, r) < -110
        assert np.abs(o - r).max() <= 1e-5


def test_split_matches_port_unsplit(split_case):
    c = split_case
    for o, r in zip(c["port"], c["unsplit"]):
        assert o.shape == r.shape
        assert sample_error_db(o, r) < -90
        assert np.abs(o - r).max() < 1e-4
    if c["name"] == "S2_mixed_voice":       # the voices differ
        assert sample_error_db(c["port"][0], c["port"][1]) > -20


def test_split_matches_oracle():
    # utterance 0 of the generic 44.1 kHz case is synthesize("ae"), seed 0
    c = _run_case("S2")
    gold = oracle_pipeline("ae", SPEC, languages.generic())
    assert spectral_error_db(c["port"][0], gold) < -60
    assert sample_error_db(c["port"][0], gold) < -55


@pytest.mark.parametrize("p", [0, 1, 4095, 4096, 10 ** 6])
def test_lehmer_skip_matches_jax(p):
    assert prng.lehmer_skip(p) == jrng.lehmer_skip(p)


def test_lehmer_skip_rejects_negative():
    with pytest.raises(ValueError, match=">= 0"):
        prng.lehmer_skip(-1)


@pytest.mark.parametrize("S", [2, 8])
def test_split_lane_setup_matches_jax(S):
    c = _case(S)
    T, B = c["T"], 2
    jg0, jseed, *_, jg0_lane, _ = japi._split_lane_setup(
        c["batched"], c["lat"], *c["jp"][1:], T, S, B)
    tables = papi._Batch(c["pscores"], c["pvoices"], SEEDS).tables(T, "cpu")
    g0, seed_lane, tables_t, g0_lane = papi._split_lane_setup(tables, T, S)
    np.testing.assert_array_equal(np.asarray(g0), np.asarray(jg0))
    np.testing.assert_array_equal(seed_lane.numpy(),
                                  np.asarray(jseed).astype(np.int64))
    np.testing.assert_array_equal(g0_lane.numpy(), np.asarray(jg0_lane))
    # s-major tiling: lane s*B + b holds utterance b
    for x, xt in zip(tables, tables_t):
        assert torch.equal(xt.reshape((S,) + tuple(x.shape))[S - 1], x)
    # segment 0's pre-roll seed lands on state 0 at the first real sample
    a_w, s_w = prng.lehmer_skip(papi.WARMUP)
    assert (a_w * int(seed_lane[0]) + s_w) & 0xFFFFFFFF == 0


@pytest.mark.parametrize("rate", [None, 22050])
def test_pre_pass_plain_matches_jax_kernel(rate):
    """The plain pre-pass against JAX's phase_q32_pre_block in interpret
    mode. They integrate the same stream but do not agree bit for bit on
    the CPU: XLA:CPU contracts a*b+c into FMAs in the interpreted kernel's
    frequency chain, so a few samples' trunc(freq * 2^32) differ by one unit
    and the sums by a few dozen units of 2^-32. On the card the kernel and
    this plain version agree bit for bit (tests/test_torch_cuda.py)."""
    c = _case(4, rate)
    T = c["T"]
    pre, _, _ = japi._split_sched(c["inc"], T, 4)
    want = np.asarray(phase_q32_pre_block(
        c["batched"], c["lat"], c["jp"][0], c["jp"][1], c["sr"], T,
        japi.BLOCK_SIZE, sched=pre, interpret=True)).astype(np.int64)
    tables = papi._Batch(c["pscores"], c["pvoices"], SEEDS).tables(T, "cpu")
    ppre, _ = papi._split_sched(c["inc"], T, 4, "cpu")
    got = pk.phase_q32_pre_block(tables, ppre, T, papi.BLOCK_SIZE,
                                 "plain").numpy()
    assert got.shape == want.shape == (T // papi.BLOCK_SIZE, 2)
    d = (got - want) % 2 ** 32
    assert np.minimum(d, 2 ** 32 - d).max() <= 256
    assert (got[0] == 0).all()


def test_seam_phase_equals_unsplit_final_phase():
    # the pre-pass's phase at a segment boundary is the Q32 phase the
    # unsplit synthesizer holds after that many samples: both integrate
    # one frequency stream (freq_chain), so they agree bit for bit
    c = _case(4)
    T = c["T"]
    tables = papi._Batch(c["pscores"], c["pvoices"], SEEDS).tables(T, "cpu")
    pre, _ = papi._split_sched(c["inc"], T, 4, "cpu")
    q = pk.phase_q32_pre_block(tables, pre, T, papi.BLOCK_SIZE, "plain")
    n = 3 * (T // 4) - papi.WARMUP                  # segment 3's start
    sf = torch.zeros(2, 24)
    si = torch.zeros(2, 3, dtype=torch.int32)
    _, _, si_o = pk.synth_fused_reference(tables, pre[0][:n], pre[1][:n],
                                          sf, si, n, False)
    assert torch.equal(si_o[:, 0].to(torch.int64) & 0xFFFFFFFF,
                       q[n // papi.BLOCK_SIZE])


@pytest.mark.parametrize("S", [2, 8])
def test_split_sched_windows(S):
    # the pre-pass schedule and the segment rows are views of one window:
    # row s holds exactly the schedule of samples s*Ts - W + 1 .. (s+1)*Ts
    from grail_tpu_torch.synth.schedule import get_schedule

    inc = g.get_voice("generic").jitter_frequency
    T, W = S * 2 * papi.BLOCK_SIZE, papi.WARMUP
    Ts = T // S
    (phi, cell), (sphi, scell) = papi._split_sched(inc, T, S, "cpu")
    sch = get_schedule(inc)
    assert np.array_equal(phi.numpy(), sch.window(0, T)[0])
    assert np.array_equal(cell.numpy(), sch.window(0, T)[1])
    assert sphi.shape == scell.shape == (S, Ts + W)
    assert sphi.stride() == scell.stride() == (Ts, 1)
    for s in range(S):
        want_phi, want_cell = sch.window(s * Ts - W, Ts + W)
        assert np.array_equal(sphi[s].numpy(), want_phi)
        assert np.array_equal(scell[s].numpy(), want_cell)
    assert sphi[1, W].data_ptr() == phi[Ts].data_ptr()      # no copies


def test_pre_pass_dispatch():
    c = _case(2)
    tables = papi._Batch(c["pscores"], c["pvoices"], SEEDS).tables(c["T"],
                                                                   "cpu")
    pre, _ = papi._split_sched(c["inc"], c["T"], 2, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        pk.phase_q32_pre_block(tables, pre, c["T"], 4096, "kernel")
    with pytest.raises(ValueError, match="impl"):
        pk.phase_q32_pre_block(tables, pre, c["T"], 4096, "cuda")
    with pytest.raises(ValueError, match="blk"):
        pk.phase_q32_pre_block(tables, pre, c["T"], 1000, "plain")
    with pytest.raises(ValueError, match="S >= 2"):
        papi._split_program(tables, c["T"], 1, "plain", c["inc"])


def test_choose_split_worked_examples():
    # bench.py's 64 texts: 8 segments, 512 lanes of 49,152 samples, one
    # wave on a card that holds 660 blocks
    assert papi.choose_split(64, 356352, 660) == (8, 360448)
    # a 2 s solo utterance: 32 segments of 4,096 + WARMUP samples
    assert papi.choose_split(1, 88200, 660) == (32, 131072)


def _estimate(B, maxN, slots, S):
    """choose_split's estimated time, written out independently."""
    T = -(-max(maxN, 1) // (S * 4096)) * S * 4096
    waves = -(-(S * B) // slots)
    return waves * (T if S == 1 else T // S + papi.WARMUP)


@pytest.mark.parametrize("slots", [1, 64, 528, 660])
def test_choose_split_properties(slots):
    for B in (1, 2, 3, 7, 64, 100, 300, 659, 660, 661, 2000):
        for maxN in (0, 1, 4096, 5000, 88200, 356352, 1323000):
            S, T = papi.choose_split(B, maxN, slots)
            assert S & (S - 1) == 0 and 1 <= S <= papi.MAX_SPLIT
            assert T % (S * papi.BLOCK_SIZE) == 0 and T >= max(maxN, 1)
            assert T == papi._round_up(max(maxN, 1), S * papi.BLOCK_SIZE)
            if B >= slots or maxN <= papi.BLOCK_SIZE:
                assert S == 1                 # full card, or one block
                continue
            # the least estimate; ties go to the smaller S
            est = {s: _estimate(B, maxN, slots, s)
                   for s in (2 ** i for i in range(8))}
            assert est[S] == min(est.values())
            assert all(est[s] > est[S] for s in est if s < S)


def test_route_on_cpu_and_kcar_stay_unsplit():
    sr = 44100.0
    for B in (1, 2, 64):
        for maxN in (4096, 88200, 356352):
            assert papi.route(B, maxN, None, "cpu", sr)[2:] == (
                1, papi._round_up(maxN, 4096))
            assert papi.route(B, maxN, True, "cpu", sr) == (
                "plain", "kcar", 1, papi._round_up(maxN, 4096))
    long_n = int(31 * sr)
    assert papi.route(1, long_n, None, "cpu", sr)[1:3] == ("kcar", 1)
