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


def _one_element(s):
    """The score cut to its longest sounding element alone (E = 1)."""
    j = int(np.argmax(np.asarray(s.length) * np.asarray(s.has_sound)))
    return _rebuild(s, slice(j, j + 1), None)


def _zero_lengths(s):
    """The score with its interior element 1 made zero-length: its end
    repeats the end before it."""
    return _rebuild(s, slice(None), [1])


def _rebuild(s, keep, zero):
    length = np.asarray(s.length, np.float32)[keep].copy()
    if zero:
        length[zero] = 0.0
    return s._replace(
        elem=type(s.elem)(*(np.asarray(f)[keep] for f in s.elem)),
        has_sound=np.asarray(s.has_sound)[keep], length=length,
        blend_length=np.asarray(s.blend_length)[keep],
        cum_length=np.cumsum(length, dtype=np.float32))


def _case(S, rate=None, voices=("generic", "generic"), edit=None):
    """JAX and port inputs for TEXTS split into S segments; `edit` changes
    each padded JAX score before both sides read it."""
    vs = [get_voice(v) for v in voices]
    if rate:
        vs = [v.resampled(float(rate)) for v in vs]
    sr = float(vs[0].sample_rate)
    E = max(japi.text_to_score(t, v).num_elems for t, v in zip(TEXTS, vs))
    scores = [japi.text_to_score(t, v, pad_to=E) for t, v in zip(TEXTS, vs)]
    if edit is not None:
        scores = [edit(sc) for sc in scores]
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
    _pre_pass_vs_jax(_case(4, rate))


@pytest.mark.parametrize("edit", [_one_element, _zero_lengths],
                         ids=["e1", "repeated_ends"])
def test_pre_pass_plain_matches_jax_kernel_edge_scores(edit):
    # one element per utterance, and zero-length elements whose ends repeat
    # (the card's kernel walks its element index over those), with the
    # bound and its reason as above
    n = _pre_pass_vs_jax(_case(4, edit=edit)).n
    if edit is _one_element:
        assert n.shape[1] == 1
    else:
        assert bool((n[:, 1:] == n[:, :-1]).any())


def _pre_pass_vs_jax(c):
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
    return tables


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


def test_route_on_cpu_stays_unsplit_and_kcar_splits_on_the_card(
        monkeypatch):
    sr = 44100.0
    for B in (1, 2, 64):
        for maxN in (4096, 88200, 356352):
            assert papi.route(B, maxN, None, "cpu", sr)[2:] == (
                1, papi._round_up(maxN, 4096))
            assert papi.route(B, maxN, True, "cpu", sr) == (
                "plain", "kcar", 1, papi._round_up(maxN, 4096))
    long_n = int(31 * sr)
    assert papi.route(1, long_n, None, "cpu", sr)[1:3] == ("kcar", 1)
    # on a card (its 528 slots stand in for the occupancy query) the exact
    # carrier takes choose_split's S as Q32 does; S = 1 where that gives 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(papi, "fused_synth_slots", lambda dev: 528)
    for B in (1, 2, 64, 256, 528, 600):
        for maxN in (4096, 88200, long_n, int(120 * sr)):
            want = papi.choose_split(B, maxN, 528)
            for exact in (True, "kernel"):
                assert papi.route(B, maxN, exact, "cuda", sr) == (
                    "kernel", "kcar") + want
            if maxN > 30 * sr:
                assert papi.route(B, maxN, None, "cuda", sr) == (
                    "kernel", "kcar") + want
    assert papi.route(64, int(120 * sr), None, "cuda", sr)[1:3] == ("kcar", 8)
    assert papi.route(256, int(120 * sr), None, "cuda", sr)[1:3] == (
        "kcar", 2)
    assert papi.route(528, int(120 * sr), None, "cuda", sr)[1:3] == (
        "kcar", 1)
    assert papi.route(2, 4096, True, "cuda", sr)[1:3] == ("kcar", 1)


def _kcar_case(S, texts):
    """Plain tables and the split schedule of `texts` (generic voice) at S
    segments, and the unsplit plain carrier's track over samples 1..T."""
    b = papi._Batch([g.text_to_score(t) for t in texts], "generic",
                    list(range(len(texts))))
    T = papi._round_up(max(b.Ns), S * papi.BLOCK_SIZE)
    tables = b.tables(T, "cpu")
    pre, seg = papi._split_sched(b.v0.jitter_frequency, T, S, "cpu")
    B = len(texts)
    fc = pk.freq_chain(tables, pk._k1(B, T, None, "cpu"), *pre)
    track, _ = pk.f32_carrier(fc.freq_j, torch.zeros(B))
    return b, T, tables, pre, seg, track


# the seams: (texts, S; first, stride, count or None for the split's own).
# The split's at S = 4 ("ae" ends before segment 3: its seam lies in the
# padding, silence at f = 0.25); S = 2 with "ae" shorter than a segment;
# seams on either side of the plain version's block boundaries; every step
# of the first 3,000 (every wrap there); an odd stride
SEAM_CASES = {"split_s4": (("ae", "ea", "aeae"), 4, None),
              "short_lane_s2": (("ae", "aeaeaeae"), 2, None),
              "block_edges": (("ae", "ea"), 2,
                              (pk._SEAM_BLOCK - 1, pk._SEAM_BLOCK, 3)),
              "every_step": (("ae", "ea"), 2, (0, 1, 3000)),
              "odd_stride": (("ae", "ea"), 2, (4095, 12289, 5))}


@pytest.mark.parametrize("case", sorted(SEAM_CASES))
def test_kcar_seams_plain_equal_unsplit_carrier(case):
    # the seam pre-pass's phase after m steps is the unsplit f32 carrier's
    # pre-update phase at sample m + 1, bit for bit: one frequency stream
    # (freq_chain), one recurrence (f32_carrier), carried across blocks
    texts, S, seams = SEAM_CASES[case]
    b, T, tables, pre, _, track = _kcar_case(S, texts)
    if seams is None:
        seams = (T // S - papi.WARMUP, T // S, S - 1)
    first, stride, count = seams
    got = pk.kcar_seam_phases(tables, pre, first, stride, count, "plain")
    assert got.shape == (count, len(texts)) and got.dtype == torch.float32
    for i in range(count):
        assert torch.equal(got[i], track[:, first + i * stride])
    if case == "split_s4":
        assert T - T // S - papi.WARMUP > b.Ns[0]      # a seam past "ae"
    if case == "short_lane_s2":
        assert b.Ns[0] < T // S                        # shorter than Ts
    if case == "every_step":           # seams on wraps, where the phase falls
        assert (track[:, 1:3000] < track[:, :2999]).sum() > 10


def test_kcar_split_pre_roll_returns_to_phase_zero():
    # segment 0 starts W samples before the stream at phase 0: its pre-roll
    # is silence (f = 0.25 exactly), so the phase is 0 again at sample 1,
    # the unsplit lane's starting phase
    b, T, tables, _, seg, _ = _kcar_case(2, ("ae", "ea"))
    W = papi.WARMUP
    sf = torch.zeros(2, 24)
    si = torch.zeros(2, 3, dtype=torch.int32)
    g0 = torch.full((2,), -W, dtype=torch.int32)
    _, _, si_o = pk.synth_fused_reference(
        tables, seg[0][0, :W].contiguous(), seg[1][0, :W].contiguous(), sf,
        si, W, True, g0=g0)
    assert torch.equal(si_o[:, 2], torch.zeros(2, dtype=torch.int32))


def test_kcar_seam_dispatch():
    _, T, tables, pre, _, _ = _kcar_case(2, ("ae",))
    with pytest.raises(ValueError, match="CUDA"):
        pk.kcar_seam_phases(tables, pre, 0, 4096, 1, "kernel")
    with pytest.raises(ValueError, match="impl"):
        pk.kcar_seam_phases(tables, pre, 0, 4096, 1, "cuda")
    for seams in ((-1, 1, 1), (0, 0, 2), (0, 1, 0), (0, 2 ** 30, 3)):
        with pytest.raises(ValueError, match="first|int32"):
            pk.kcar_seam_phases(tables, pre, *seams, "plain")


@functools.lru_cache(maxsize=None)
def _kcar_unsplit():
    c = _case(2)
    return [o.numpy() for o in papi.synthesize_scores(
        c["pscores"], c["pvoices"], SEEDS, device="cpu", exact_carrier=True)]


@pytest.mark.parametrize("S", [2, 4])
def test_split_kcar_matches_port_unsplit(S):
    # the exact carrier split at S segments, each seeded by the seam
    # pre-pass, against the unsplit exact carrier: the carrier is the same
    # bit for bit, so the bounds are test_split_matches_port_unsplit's, the
    # filters' pre-roll alone
    c = _case(S)
    out = papi._synthesize_split(c["pscores"], c["pvoices"], SEEDS, S=S,
                                 device="cpu", exact_carrier=True)
    for o, r in zip(out, _kcar_unsplit()):
        assert o.shape == r.shape
        assert sample_error_db(o.numpy(), r) < -90
        assert np.abs(o.numpy() - r).max() < 1e-4
