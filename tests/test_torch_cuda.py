"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc and skip elsewhere. They import
neither jax nor grail_tpu, so they run on a machine without JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import grail_tpu_torch as g
import grail_tpu_torch.api as papi
from grail_tpu_torch.api import _round_up, _score_num_samples
from grail_tpu_torch.synth import kernel_fused as kf
from grail_tpu_torch.synth.jitter import JitterLattice, build_lattice
from grail_tpu_torch.synth.schedule import device_window
from grail_tpu_torch.synth.score import stack_scores

pytestmark = pytest.mark.cuda

# bench.py's batch: 64 texts of 8-15 characters, the main path's B = 64
BENCH_TEXTS = tuple(("aeae" * 4)[:8 + (i % 8)] for i in range(64))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def card_mesh(cuda, tmp_path):
    """make_mesh(1, 1, "cuda") in a one-rank gloo group of this process (no
    second process), the group torn down after the test."""
    import torch.distributed as dist

    from grail_tpu_torch.parallel import make_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        yield make_mesh(1, 1, "cuda")
    finally:
        dist.destroy_process_group()


def _tables(texts, voices, device, seeds=None, T=None):
    voices = [g.get_voice(v) for v in voices]
    sr = float(voices[0].sample_rate)
    E = max(g.text_to_score(t, v).num_elems for t, v in zip(texts, voices))
    scores = [g.text_to_score(t, v, pad_to=E) for t, v in zip(texts, voices)]
    T = T or _round_up(max(_score_num_samples(s, sr) for s in scores), 4096)
    seeds = seeds or list(range(len(texts)))
    inc = voices[0].jitter_frequency
    lat = JitterLattice(*(np.stack(f) for f in zip(
        *(build_lattice(sd, T, inc) for sd in seeds))))
    jp = (inc, [v.jitter_delta_frequency for v in voices],
          [v.jitter_delta_formant_frequency for v in voices],
          [v.jitter_delta_amplitude for v in voices])
    tables = kf.build_tables(stack_scores(scores), lat, jp, sr, device=device)
    return tables, device_window(inc, 0, T, device), T


@pytest.mark.parametrize("kcar,texts,T", [
    (False, ("ae", "ea", "aeae"), None), (True, ("ae", "ea", "aeae"), None),
    (False, BENCH_TEXTS, None), (True, BENCH_TEXTS, 65536)],
    ids=["q32", "kcar", "q32_b64", "kcar_b64_t65536"])
def test_kernel_equals_plain_bitwise(cuda, kcar, texts, T):
    # no FMA contraction in the kernel and one op order in both: the audio
    # and the whole carried state agree bit for bit. Also at the main
    # path's unsplit shape, bench.py's 64 texts: Q32 over their whole
    # length, kcar over the first 65,536 samples (its plain carrier is a
    # second loop over the samples)
    tables, (phi, cell), T = _tables(texts, ["generic"] * len(texts), cuda,
                                     T=T)
    B = tables.n.shape[0]
    sf = torch.randn(B, 24, device=cuda) * 1e-3
    si = torch.tensor([[123456789, 42, 0]] * B, dtype=torch.int32,
                      device=cuda)
    si[:, 2] = torch.full((B,), 0.25, device=cuda).view(torch.int32)
    n0 = kf.LAUNCHES["fused_synth"]
    a, sf_k, si_k = kf.fused_synth_cuda(tables, phi, cell, sf, si, T, kcar)
    assert kf.LAUNCHES["fused_synth"] == n0 + 1
    r, sf_r, si_r = kf.synth_fused_reference(tables, phi, cell, sf, si, T,
                                             kcar)
    torch.cuda.synchronize()
    assert torch.equal(si_k, si_r)
    assert torch.equal(sf_k, sf_r)
    assert torch.equal(a, r)
    assert bool(torch.isfinite(a).all())


def test_kernel_multivoice(cuda):
    tables, (phi, cell), T = _tables(["aeae", "aeae"], ["plain", "bright"],
                                     cuda, seeds=[1, 1])
    sf = torch.zeros(2, 24, device=cuda)
    si = torch.zeros(2, 3, dtype=torch.int32, device=cuda)
    a, _, _ = kf.fused_synth_cuda(tables, phi, cell, sf, si, T, False)
    r, _, _ = kf.synth_fused_reference(tables, phi, cell, sf, si, T, False)
    assert torch.equal(a, r)


def test_wrapper_rejects_bad_inputs(cuda):
    tables, (phi, cell), T = _tables(["ae"], ["generic"], cuda)
    sf = torch.zeros(1, 24, device=cuda)
    si = torch.zeros(1, 3, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="multiple"):
        kf.fused_synth_cuda(tables, phi, cell, sf, si, T - 1, False)
    with pytest.raises(ValueError, match="dtype"):
        kf.fused_synth_cuda(tables, phi.double(), cell, sf, si, T, False)
    with pytest.raises(ValueError, match="shape"):
        kf.fused_synth_cuda(tables, phi[:-128], cell, sf, si, T, False)
    with pytest.raises(ValueError, match="device"):
        kf.fused_synth_cuda(tables, phi.cpu(), cell, sf, si, T, False)


def test_synthesize_batch_on_cuda_matches_cpu(cuda):
    # the card's route splits ["ae", "ea"]; the CPU's is unsplit, so the
    # card is held against the CPU's split at the same S
    from grail_tpu_torch.utils import sample_error_db

    scores = [g.text_to_score(t) for t in ("ae", "ea")]
    Ns = [_score_num_samples(s, 44100.0) for s in scores]
    _, _, S, _ = g.route(2, max(Ns), None, cuda, 44100.0)
    assert S > 1
    n0 = dict(kf.LAUNCHES)
    on_card = g.synthesize_batch(["ae", "ea"], device="cuda")
    assert kf.LAUNCHES["fused_synth"] == n0["fused_synth"] + 1
    assert kf.LAUNCHES["phase_q32_pre"] == n0["phase_q32_pre"] + 1
    on_cpu = papi._synthesize_split(scores, S=S, device="cpu")
    for a, b in zip(on_card, on_cpu):
        assert a.device.type == "cuda" and a.shape == b.shape
        assert sample_error_db(a.cpu().numpy(), b.numpy()) < -100


def test_synthesize_batch_exact_carrier_on_cuda_matches_cpu(cuda):
    # the exact carrier splits on the card as Q32 does: one launch of the
    # seam pre-pass and one of kernel 1, no Q32 pre-pass; held against the
    # CPU's same split (the CPU's route is unsplit)
    from grail_tpu_torch.utils import sample_error_db

    scores = [g.text_to_score(t) for t in ("ae", "ea")]
    Ns = [_score_num_samples(s, 44100.0) for s in scores]
    _, carrier, S, _ = g.route(2, max(Ns), True, cuda, 44100.0)
    assert carrier == "kcar" and S > 1
    n0 = dict(kf.LAUNCHES)
    on_card = g.synthesize_batch(["ae", "ea"], device="cuda",
                                 exact_carrier=True)
    assert {k: kf.LAUNCHES[k] - n0[k] for k in n0
            if kf.LAUNCHES[k] != n0[k]} == {"fused_synth": 1, "kcar_seam": 1}
    on_cpu = papi._synthesize_split(scores, S=S, device="cpu",
                                    exact_carrier=True)
    for a, b in zip(on_card, on_cpu):
        assert a.device.type == "cuda" and a.shape == b.shape
        assert sample_error_db(a.cpu().numpy(), b.numpy()) < -100


def _split_setup(cuda, S, texts=("ae", "ea", "aeae"), seeds=(0, 1, 2)):
    """Tables and schedules of the split route for `texts` at S segments."""
    scores = [g.text_to_score(t) for t in texts]
    b = papi._Batch(scores, "generic", list(seeds))
    T = _round_up(max(b.Ns), S * papi.BLOCK_SIZE)
    tables = b.tables(T, cuda)
    pre, seg = papi._split_sched(b.v0.jitter_frequency, T, S, cuda)
    return tables, pre, seg, T


def test_pre_pass_kernel_equals_plain_bitwise(cuda):
    tables, pre, _, T = _split_setup(cuda, 4)
    n0 = kf.LAUNCHES["phase_q32_pre"]
    k = kf.phase_q32_pre_block(tables, pre, T, papi.BLOCK_SIZE, "kernel")
    assert kf.LAUNCHES["phase_q32_pre"] == n0 + 1
    r = kf.phase_q32_pre_block(tables, pre, T, papi.BLOCK_SIZE, "plain")
    torch.cuda.synchronize()
    assert k.shape == (T // papi.BLOCK_SIZE, 3)
    assert torch.equal(k, r)


def test_seam_phase_equals_unsplit_kernel_phase(cuda):
    # the pre-pass's phase at each segment boundary is the Q32 phase that
    # unsplit kernel 1 holds after that many samples, bit for bit
    S = 4
    tables, pre, _, T = _split_setup(cuda, S)
    q = kf.phase_q32_pre_block(tables, pre, T, papi.BLOCK_SIZE, "kernel")
    sf = torch.zeros(3, 24, device=cuda)
    si = torch.zeros(3, 3, dtype=torch.int32, device=cuda)
    for s in range(1, S):
        n = s * (T // S) - papi.WARMUP
        _, _, si_o = kf.fused_synth_cuda(tables, pre[0][:n], pre[1][:n],
                                         sf, si, n, False)
        torch.cuda.synchronize()
        assert torch.equal(si_o[:, 0].to(torch.int64) & 0xFFFFFFFF,
                           q[n // papi.BLOCK_SIZE])


@pytest.mark.parametrize("texts,S,kcar", [(("ae", "ea", "aeae"), 4, False),
                                          (BENCH_TEXTS, 8, False),
                                          (("ae", "ea", "aeae"), 4, True),
                                          (BENCH_TEXTS, 8, True)],
                         ids=["s4", "b64_s8", "kcar_s4", "kcar_b64_s8"])
def test_split_kernel_equals_plain_bitwise(cuda, texts, S, kcar):
    # split lanes: per-lane offsets g0, schedule rows, seam phases (Q32, or
    # the exact carrier's from the seam pre-pass), seeds; also at the main
    # path's split, bench.py's 64 texts on 512 lanes
    tables, _, _, T = _split_setup(cuda, S, texts, list(range(len(texts))))
    tables_t, (phi, cell), state, q, g0, _ = papi._split_lanes(
        tables, T, S, "kernel", g.get_voice("generic").jitter_frequency,
        kcar=kcar)
    sf, si = kf.state_rows(state, q)
    args = (tables_t, phi, cell, sf, si, T // S + papi.WARMUP, kcar)
    a, sf_k, si_k = kf.fused_synth_cuda(*args, g0=g0)
    r, sf_r, si_r = kf.synth_fused_reference(*args, g0=g0)
    torch.cuda.synchronize()
    assert torch.equal(si_k, si_r)
    assert torch.equal(sf_k, sf_r)
    assert torch.equal(a, r)


def _sentence_batch(cuda):
    """The first batch of the benchmark's sentences mix
    (portbench/traffic, seed 4111222333): its 64 texts, their _Batch
    (voice plain, english, seeds 0..63) and the card's route for it."""
    from portbench.traffic import generator

    texts = generator.batches(generator.load_mix("sentences"), 4111222333,
                              1)[0]
    v = g.get_voice("plain")
    b = papi._Batch([papi.score_from_phoneme_elems(
        g.text_to_phoneme_elems(t, v, "english"), v) for t in texts], v,
        list(range(len(texts))))
    return texts, b, g.route(b.B, max(b.Ns), None, cuda, b.sr)


# the exact carrier's seams: (texts, S; first, stride, count, or None for
# the split's own). The split at S = 4 ("ae" ends before segment 3: its
# seam lies in padding, silence at f = 0.25); "ae" shorter than a segment;
# every step of the first 6,000 (a seam on every wrap there); an odd
# stride; random tables with every other element's frequency negative
KCAR_SEAM_CASES = {"split_s4": (("ae", "ea", "aeae"), 4, None),
                   "short_lane_s2": (("ae", "aeaeaeae"), 2, None),
                   "every_step": (("ae", "ea", "aeae"), 2, (0, 1, 6000)),
                   "odd_stride": (("ae", "ea", "aeae"), 4, (4095, 12289, 5)),
                   "negative_freq": (None, None, (100, 3001, 7))}


@pytest.mark.parametrize("case", sorted(KCAR_SEAM_CASES))
def test_kcar_seam_kernel_equals_plain_bitwise(cuda, case):
    texts, S, seams = KCAR_SEAM_CASES[case]
    if texts is None:
        tables, pre = _pre_tables(cuda, 3, 12, 40, 28672, repeated=True)
        tables.scal[:, 1::2, 0] *= -1
    else:
        tables, pre, _, T = _split_setup(cuda, S, texts,
                                         list(range(len(texts))))
        seams = seams or (T // S - papi.WARMUP, T // S, S - 1)
    n0 = dict(kf.LAUNCHES)
    k = kf.kcar_seam_phases(tables, pre, *seams, "kernel")
    assert {k_: kf.LAUNCHES[k_] - n0[k_] for k_ in n0
            if kf.LAUNCHES[k_] != n0[k_]} == {"kcar_seam": 1}
    r = kf.kcar_seam_phases(tables, pre, *seams, "plain")
    torch.cuda.synchronize()
    assert k.shape == r.shape == (seams[2], tables.n.shape[0])
    assert torch.equal(k, r)


@pytest.mark.parametrize("case", ["s4", "short_lane_s2", "sentences"])
def test_kcar_seams_equal_unsplit_kernel_phase(cuda, case):
    # each seam is the f32 phase that unsplit kernel 1 (kcar) holds after
    # g0 samples, bit for bit, also at the sentences mix's split (64 lanes
    # to ~120 s, S = 8); and segment 0's pre-roll (silence from phase 0)
    # brings kernel 1 back to phase 0 at sample 1, the unsplit start
    if case == "sentences":
        _, b, (_, carrier, S, T) = _sentence_batch(cuda)
        assert (carrier, S) == ("kcar", 8)
        tables = b.tables(T, cuda)
        pre, seg = papi._split_sched(b.v0.jitter_frequency, T, S, cuda)
    else:
        S, texts = (4, ("ae", "ea", "aeae")) if case == "s4" else (
            2, ("ae", "aeaeaeae"))
        tables, pre, seg, T = _split_setup(cuda, S, texts,
                                           list(range(len(texts))))
    B = tables.n.shape[0]
    Ts, W = T // S, papi.WARMUP
    seams = kf.kcar_seam_phases(tables, pre, Ts - W, Ts, S - 1, "kernel")
    sf = torch.zeros(B, 24, device=cuda)
    si = torch.zeros(B, 3, dtype=torch.int32, device=cuda)
    for s in range(1, S):
        n = s * Ts - W
        _, _, si_o = kf.fused_synth_cuda(tables, pre[0][:n], pre[1][:n],
                                         sf, si, n, True)
        torch.cuda.synchronize()
        assert torch.equal(si_o[:, 2], seams[s - 1].view(torch.int32)), s
    g0 = torch.full((B,), -W, dtype=torch.int32, device=cuda)
    _, _, si_o = kf.fused_synth_cuda(tables, seg[0][0, :W], seg[1][0, :W],
                                     sf, si, W, True, g0=g0)
    torch.cuda.synchronize()
    assert torch.equal(si_o[:, 2], si[:, 2])


def test_kcar_seam_on_a_wrap_equals_unsplit_kernel_phase(cuda):
    # a seam just after a wrap (the step into it subtracted 1) at kernel 1's
    # chunk grain: the seam pre-pass's phase there is unsplit kernel 1's,
    # bit for bit; the wraps are found from the pre-pass at every step
    tables, pre, _, _ = _split_setup(cuda, 8, BENCH_TEXTS, list(range(64)))
    L = 65536
    every = kf.kcar_seam_phases(tables, pre, 1, 1, L, "kernel")
    wrapped = (every[1:] < every[:-1]).any(1).cpu()   # into step i + 2
    m = next(m for m in range(128, L + 1, 128) if wrapped[m - 2])
    B = tables.n.shape[0]
    sf = torch.zeros(B, 24, device=cuda)
    si = torch.zeros(B, 3, dtype=torch.int32, device=cuda)
    _, _, si_o = kf.fused_synth_cuda(tables, pre[0][:m], pre[1][:m], sf, si,
                                     m, True)
    seam = kf.kcar_seam_phases(tables, pre, m, 1, 1, "kernel")
    torch.cuda.synchronize()
    assert torch.equal(si_o[:, 2], every[m - 1].view(torch.int32))
    assert torch.equal(seam[0], every[m - 1])


def test_kcar_split_route_on_sentences(cuda):
    # the benchmark's sentences (past 30 s): the route splits the exact
    # carrier 8 ways, one seam pre-pass and one kernel 1 launch a call;
    # against the same batch unsplit on the card within 1e-4 a sample (the
    # carrier is the same bit for bit; the filters' pre-roll differs)
    texts, b, (impl, carrier, S, T) = _sentence_batch(cuda)
    assert (impl, carrier, S) == ("kernel", "kcar", 8)
    n0 = dict(kf.LAUNCHES)
    split = g.synthesize_batch(texts, "plain", "english",
                               seeds=list(range(len(texts))), device="cuda")
    torch.cuda.synchronize()
    assert {k: kf.LAUNCHES[k] - n0[k] for k in n0
            if kf.LAUNCHES[k] != n0[k]} == {"fused_synth": 1, "kcar_seam": 1}
    unsplit = b.run("kernel", "kcar", 1,
                    _round_up(max(b.Ns), papi.BLOCK_SIZE), cuda)
    for a, r in zip(split, unsplit):
        assert a.shape == r.shape
        assert float((a - r).abs().max()) < 1e-4


def test_kcar_seam_wrapper_rejects_bad_inputs(cuda):
    tables, (phi, cell), _, T = _split_setup(cuda, 2)
    with pytest.raises(ValueError, match="at least"):
        kf.kcar_seam_cuda(tables, phi[:100], cell[:100], 0, 4096, 2)
    with pytest.raises(ValueError, match="stride"):
        kf.kcar_seam_cuda(tables, phi, cell, 0, 0, 2)
    with pytest.raises(ValueError, match="dtype"):
        kf.kcar_seam_cuda(tables, phi.double(), cell, 0, 4096, 2)
    with pytest.raises(ValueError, match="device"):
        kf.kcar_seam_cuda(tables, phi, cell.cpu(), 0, 4096, 2)


def test_wrapper_rejects_bad_split_inputs(cuda):
    tables, _, (phi, cell), T = _split_setup(cuda, 2)
    Text = T // 2 + papi.WARMUP
    sf = torch.zeros(3, 24, device=cuda)
    si = torch.zeros(3, 3, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="rows"):       # 2 rows, 3 lanes
        kf.fused_synth_cuda(tables, phi, cell, sf, si, Text, False)
    t6 = kf.FusedTables(*(x.repeat((2,) + (1,) * (x.dim() - 1))
                          for x in tables))
    sf6, si6 = sf.repeat(2, 1), si.repeat(2, 1)
    with pytest.raises(ValueError, match="strides"):    # a view and a copy
        kf.fused_synth_cuda(t6, phi, cell.contiguous(), sf6, si6, Text,
                            False)
    with pytest.raises(ValueError, match="shape"):      # rows too short
        kf.fused_synth_cuda(t6, phi[:, :-128], cell[:, :-128], sf6, si6,
                            Text, False)
    g0 = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="g0"):
        kf.fused_synth_cuda(tables, phi[0].contiguous(),
                            cell[0].contiguous(), sf, si, Text, False, g0=g0)


def test_slots_from_the_card(cuda):
    # the occupancy query counts the launch's own 160 threads and dynamic
    # shared memory: the blocks it reports per SM fit in the SM's shared
    # memory at that size, and the budget of 4 blocks per SM holds
    slots = kf.fused_synth_slots(cuda)
    props = torch.cuda.get_device_properties(cuda)
    sms = props.multi_processor_count
    geo = kf.fused_synth_geometry(cuda)
    assert slots % sms == 0 and slots == geo["blocks_per_sm"] * sms
    assert geo["threads"] == kf.CHUNK + 32
    assert geo["dynamic_smem"] > 48 * 1024
    assert geo["blocks_per_sm"] * (geo["dynamic_smem"] + geo["static_smem"]) \
        <= geo["sm_smem"]
    assert slots >= 4 * sms
    assert 0 < geo["registers"] <= 96
    # bench.py's 64 texts still split 8 ways in one wave
    b = papi._Batch([g.text_to_score(t) for t in BENCH_TEXTS], "generic",
                    None)
    S = g.route(64, max(b.Ns), None, cuda, 44100.0)[2]
    assert S == 8 and S * 64 <= slots


def _pre_tables(device, B, E, W, T, seed=0, repeated=False):
    """Tables the pre-pass reads (n, scal, latp, par; the rest zero) for B
    utterances of E elements: random non-decreasing ends below T, each
    utterance's last sample mid-chunk; `repeated` makes elements 1 and E//2
    zero-length. With W past a few hundred, a random schedule whose cells
    reach past both ends of the lattice (clamped); else the real one."""
    rng = np.random.default_rng(seed)
    ends = np.sort(rng.integers(1, int(T * 0.95), size=(B, E)), axis=1)
    if repeated:
        ends[:, 1] = ends[:, 0]
        ends[:, E // 2] = ends[:, E // 2 - 1]
    ends[:, -1] = np.maximum(ends[:, -2] if E > 1 else 1,
                             T - 1000 + rng.integers(0, 500, B))
    dt = np.float32(1 / 44100)
    scal = np.zeros((B, E, 4), np.float32)
    scal[..., 0] = rng.uniform(0.002, 0.006, (B, E))
    scal[..., 1] = ends * dt
    scal[..., 2] = rng.uniform(0.01, 0.05, (B, E))
    scal[..., 3] = rng.integers(0, 2, (B, E))
    par = np.zeros((B, 4), np.float32)
    par[:, 0] = rng.uniform(0.0002, 0.0006, B)
    par[:, 3] = dt
    F = 8

    def t(x):
        return torch.from_numpy(x).to(device)

    tables = kf.FusedTables(
        t(ends.astype(np.int32)), t(scal), torch.zeros(B, E, 6, F,
                                                       device=device),
        t(rng.standard_normal((B, W)).astype(np.float32) * 0.5),
        torch.zeros(B, W, F, device=device),
        torch.zeros(B, W, F, device=device), t(par))
    if W > 512:
        sched = (t(rng.random(T).astype(np.float32)),
                 t(rng.integers(-3, W + 3, T).astype(np.int32)))
    else:
        sched = device_window(g.get_voice("generic").jitter_frequency, 0, T,
                              device)
    return tables, sched


# (B, E, W, chunks, repeated ends): one chunk; 75 chunks at B = 64 (runs of
# 8 chunks, the last one 3); E = 1; repeated ends; B = 1 over 128 chunks
# (8 warps a chunk); 2 and 4 warps a chunk; runs of 4 with repeated ends; a
# lattice too large to stage (read from global memory)
PRE_CASES = {"one_chunk": (3, 16, 134, 1, False),
             "b64_partial_run": (64, 16, 134, 75, False),
             "e1": (2, 1, 10, 5, False),
             "repeated_ends": (3, 12, 40, 11, True),
             "b1_128_chunks": (1, 16, 134, 128, False),
             "b8_two_warps_a_chunk": (8, 16, 134, 80, False),
             "b4_four_warps_a_chunk": (4, 12, 134, 80, True),
             "b64_repeated": (64, 9, 134, 19, True),
             "unstaged_w13000": (2, 8, 13000, 3, False)}


@pytest.mark.parametrize("case", sorted(PRE_CASES))
def test_pre_pass_edges_equal_plain_bitwise(cuda, case):
    B, E, W, nc, repeated = PRE_CASES[case]
    T = nc * kf.CHUNK_PRE
    tables, (phi, cell) = _pre_tables(cuda, B, E, W, T, repeated=repeated)
    n0 = kf.LAUNCHES["phase_q32_pre"]
    k = kf.phase_q32_pre_cuda(tables, phi, cell, T)
    assert kf.LAUNCHES["phase_q32_pre"] == n0 + 1
    r = kf.phase_q32_pre_reference(tables, phi, cell, T)
    torch.cuda.synchronize()
    assert k.shape == (B, nc)
    assert torch.equal(k, r)
    # a schedule 4 bytes off 16-byte alignment takes the scalar loads
    phi2 = torch.cat([phi.new_zeros(1), phi])[1:]
    cell2 = torch.cat([cell.new_zeros(1), cell])[1:]
    assert phi2.data_ptr() % 16
    assert torch.equal(kf.phase_q32_pre_cuda(tables, phi2, cell2, T), r)


def test_pre_pass_geometry(cuda):
    # runs of 8 one-warp chunks at B = 64; a single utterance's few chunks
    # take 8 warps each, so it still spreads over the card; tables past
    # 48 KB unstaged
    geo = kf.phase_q32_pre_geometry(64, 16, 134, 360448, cuda)
    assert geo["threads"] == 256 and geo["blocks"] == 64 * 44
    assert geo["dynamic_smem"] == (16 * 5 + 134) * 4
    assert 0 < geo["registers"] <= 255
    solo = kf.phase_q32_pre_geometry(1, 16, 134, 131072, cuda)
    assert solo["threads"] == 256 and solo["blocks"] == 128
    big = kf.phase_q32_pre_geometry(2, 8, 13000, 3072, cuda)
    assert big["dynamic_smem"] == 0


@pytest.mark.parametrize("texts,S", [(("aea",), 32),
                                     (BENCH_TEXTS, 8)],
                         ids=["solo_s32", "b64_s8"])
def test_seam_phase_at_main_path_geometry(cuda, texts, S):
    # the seams of the main path's two splits (B = 1 with 8 warps a chunk,
    # B = 64 in runs of 8 chunks) equal unsplit kernel 1's Q32 phase bit
    # for bit
    tables, pre, _, T = _split_setup(cuda, S, texts, list(range(len(texts))))
    q = kf.phase_q32_pre_block(tables, pre, T, papi.BLOCK_SIZE, "kernel")
    B = len(texts)
    sf = torch.zeros(B, 24, device=cuda)
    si = torch.zeros(B, 3, dtype=torch.int32, device=cuda)
    for s in (2, S // 2, S - 1):    # segment 1 of the solo split starts at 0
        n = s * (T // S) - papi.WARMUP
        _, _, si_o = kf.fused_synth_cuda(tables, pre[0][:n], pre[1][:n],
                                         sf, si, n, False)
        torch.cuda.synchronize()
        assert torch.equal(si_o[:, 0].to(torch.int64) & 0xFFFFFFFF,
                           q[n // papi.BLOCK_SIZE])


def _edge_case(cuda, mode, T):
    """Kernel 1's arguments in `mode` for lanes of T samples: (args, kw,
    launch counter). q32 and kcar: three utterances sharing a [T] schedule,
    each lane at its own offset inside its utterance; track1: one lane
    reading a carrier track; track4: the split's shape, four lanes of one
    utterance at offsets `step` apart with overlapping schedule and track
    rows; carry: three lanes of the serving tick, T samples each."""
    rng = np.random.default_rng(T)
    if mode == "carry":
        x = _carry_setup(cuda, 3)
        return ((x["tables"], None, None, x["sf"], x["si"], T, True),
                dict(g0=x["g0"], lat_base=x["lat_base"], inc=x["inc"]),
                "fused_synth_carry")
    tables, (phi, cell), _ = _tables(["ae", "ea", "aeae"], ["generic"] * 3,
                                     cuda)
    kw, counter = {}, "fused_synth"
    if mode == "track4":
        step = T // 2 + 128
        tables = kf.FusedTables(*(x[2:3].repeat((4,) + (1,) * (x.dim() - 1))
                                  .contiguous() for x in tables))
        n_win = 3 * step + T
        car = torch.from_numpy(rng.random(n_win).astype(np.float32)).to(cuda)
        phi, cell, car = (x[:n_win].as_strided((4, T), (step, 1))
                          for x in (phi, cell, car))
        kw = dict(carrier=car, g0=torch.tensor(
            [7_000 + s * step for s in range(4)], dtype=torch.int32,
            device=cuda))
        counter = "fused_synth_track"
    else:
        phi, cell = phi[:T], cell[:T]
        if mode == "track1":
            tables = kf.FusedTables(*(x[2:3] for x in tables))
            kw = dict(carrier=torch.from_numpy(
                rng.random(T).astype(np.float32)).to(cuda))
            counter = "fused_synth_track"
        kw["g0"] = torch.tensor([3_000, 5_000, 9_000][:tables.n.shape[0]],
                                dtype=torch.int32, device=cuda)
    B = tables.n.shape[0]
    sf = torch.from_numpy(rng.standard_normal((B, 24)).astype(np.float32)
                          * 1e-3).to(cuda)
    si = torch.tensor([[123456789, 42, 0]] * B, dtype=torch.int32,
                      device=cuda)
    si[:, 2] = torch.full((B,), 0.25, device=cuda).view(torch.int32)
    return (tables, phi, cell, sf, si, T, mode == "kcar"), kw, counter


@pytest.mark.parametrize("T", [128, 256, 384])
@pytest.mark.parametrize("mode", ["q32", "kcar", "track1", "track4",
                                  "carry"])
def test_pipeline_edges_equal_plain_bitwise(cuda, mode, T):
    # one, two and three chunks: the ring's fill, a hand-over in each
    # direction, and a drain after an odd count; audio, sf and si bit for
    # bit in every mode
    args, kw, counter = _edge_case(cuda, mode, T)
    n0 = dict(kf.LAUNCHES)
    out_k = kf.fused_synth_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert kf.LAUNCHES[counter] == n0[counter] + 1
    assert all(kf.LAUNCHES[k] == n0[k] for k in n0 if k != counter)
    out_p = kf.synth_fused_reference(*args, **kw)
    assert out_k[0].shape == (args[0].n.shape[0], T)
    for name, k, p in zip(("audio", "sf", "si"), out_k, out_p):
        assert torch.equal(k, p), name
    assert bool(torch.isfinite(out_k[0]).all())
    assert float(out_k[0].abs().max()) > 0


# ---------------------------------------------------------------------------
# kernel 3: the core backend's recurrence (synth/csrc/synth_core.cu)
# ---------------------------------------------------------------------------

def _core_streams(device, B, T, seed=0):
    """The prep's seven [T, 8, B] streams from random frames in the
    synthesizer's ranges, and a random carried state (lp, b, c) [8, B]."""
    from grail_tpu_torch.synth import kernel as pk
    from grail_tpu_torch.synth.elem import SynthesisElem
    from grail_tpu_torch.synth.synthesize import SynthState

    rng = np.random.default_rng(seed)

    def u(lo, hi, *shape):
        return (lo + (hi - lo) * rng.random(shape)).astype(np.float32)

    elems = SynthesisElem(u(0.002, 0.006, T, B), u(0.02, 0.07, T, B, 8),
                          u(0.001, 0.004, T, B, 8), u(0.02, 0.05, T, B, 8),
                          u(0.0, 0.5, T, B, 8), u(0.0, 0.5, T, B, 8),
                          u(0.0, 0.3, T, B, 8)).to(device)
    state = SynthState.init(B, device)._replace(
        seed=torch.arange(B, dtype=torch.int64, device=device) * 7919)
    streams = pk.precompute_streams(elems, state)[0]
    lp, b, c = (torch.from_numpy(rng.standard_normal((8, B)).astype(
        np.float32) * 1e-3).to(device) for _ in range(3))
    return streams, lp, b, c


@pytest.mark.parametrize("B,T", [(37, 4096), (5, 100)])
def test_core_kernel_equals_plain_bitwise(cuda, B, T):
    # odd B leaves a block's last lanes idle; T = 100 ends mid-chunk
    from grail_tpu_torch.synth import kernel as pk

    streams, lp, b, c = _core_streams(cuda, B, T)
    n0 = pk.LAUNCHES["synth_core"]
    k = pk.synth_core_cuda(streams, lp, b, c)
    assert pk.LAUNCHES["synth_core"] == n0 + 1
    r = pk.synth_core_reference(streams, lp, b, c)
    torch.cuda.synchronize()
    assert k[0].shape == (T, B)
    for x, y in zip(k, r):
        assert torch.equal(x, y)
    assert bool(torch.isfinite(k[0]).all())


def test_core_kernel_state_continues(cuda):
    # two launches with the state carried equal one launch over both halves
    from grail_tpu_torch.synth import kernel as pk

    streams, lp, b, c = _core_streams(cuda, 19, 4096, seed=1)
    whole = pk.synth_core_cuda(streams, lp, b, c)
    first = pk.synth_core_cuda([s[:1500].contiguous() for s in streams],
                               lp, b, c)
    second = pk.synth_core_cuda([s[1500:].contiguous() for s in streams],
                                *first[1:])
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([first[0], second[0]]), whole[0])
    for x, y in zip(second[1:], whole[1:]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("T", [1, 31, 100, 4096])
@pytest.mark.parametrize("B", [1, 3, 5, 37, 512, 513])
def test_core_ring_equals_plain_bitwise(cuda, B, T):
    # tensor copies at B % 4 == 0 (steps past T zero-filled), 4-byte
    # copies with the lanes past B zero-filled otherwise; T below one
    # stage, between stages, and many
    from grail_tpu_torch.synth import kernel as pk

    streams, lp, b, c = _core_streams(cuda, B, T, seed=B + T)
    k = pk.synth_core_cuda(streams, lp, b, c)
    r = pk.synth_core_reference(streams, lp, b, c)
    torch.cuda.synchronize()
    for x, y in zip(k, r):
        assert torch.equal(x, y)


@pytest.mark.parametrize("B", [5, 512])
def test_core_state_continues_across_stages(cuda, B):
    # launches split at 37 and 37 + 70 samples (not multiples of a stage)
    # with the state carried equal one launch
    from grail_tpu_torch.synth import kernel as pk

    streams, lp, b, c = _core_streams(cuda, B, 300, seed=2)
    whole = pk.synth_core_cuda(streams, lp, b, c)
    outs, state = [], (lp, b, c)
    for lo, hi in ((0, 37), (37, 107), (107, 300)):
        part = pk.synth_core_cuda([s[lo:hi] for s in streams], *state)
        outs.append(part[0])
        state = part[1:]
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(outs), whole[0])
    for x, y in zip(state, whole[1:]):
        assert torch.equal(x, y)


def test_core_misaligned_streams_take_the_narrow_copies(cuda):
    # B % 4 == 0 but a stream 4 bytes off 16-byte alignment: no tensor map
    # can describe it, so the 4-byte copies run
    from grail_tpu_torch.synth import kernel as pk

    streams, lp, b, c = _core_streams(cuda, 8, 100, seed=3)
    shifted = []
    for s in streams:
        buf = torch.empty(s.numel() + 1, device=cuda)
        x = buf[1:].view(s.shape)
        x.copy_(s)
        shifted.append(x)
    assert shifted[0].data_ptr() % 16 and shifted[0].is_contiguous()
    k = pk.synth_core_cuda(shifted, lp, b, c)
    r = pk.synth_core_reference(streams, lp, b, c)
    torch.cuda.synchronize()
    for x, y in zip(k, r):
        assert torch.equal(x, y)


def test_core_geometry(cuda):
    # 4 lanes per block: a consumer warp of 8 formants x 4 lanes and a
    # producer warp; the core route's 512 lanes give 128 blocks; the ring
    # leaves room for 2 blocks per SM
    from grail_tpu_torch.synth import kernel as pk

    geo = pk.synth_core_geometry(512, cuda)
    assert geo["blocks"] == 128 and geo["threads"] == 64
    assert geo["copies"] == "tma" and geo["blocks_per_sm"] >= 2
    assert geo["dynamic_smem"] > 48 * 1024
    assert 0 < geo["registers"] <= 255
    odd = pk.synth_core_geometry(513, cuda)
    assert odd["blocks"] == 129 and odd["copies"] == "cp.async 4 B"


def test_core_wrapper_rejects_bad_inputs(cuda):
    from grail_tpu_torch.synth import kernel as pk

    streams, lp, b, c = _core_streams(cuda, 4, 64)
    with pytest.raises(ValueError, match="shape"):
        pk.synth_core_cuda(streams, lp[:, :3], b, c)
    with pytest.raises(ValueError, match="dtype"):
        pk.synth_core_cuda([streams[0].double()] + list(streams[1:]), lp, b,
                           c)
    with pytest.raises(ValueError, match="contiguous"):
        pk.synth_core_cuda([s.transpose(0, 2).contiguous().transpose(0, 2)
                            for s in streams], lp, b, c)
    with pytest.raises(ValueError, match="device"):
        pk.synth_core_cuda(streams, lp.cpu(), b, c)


def test_core_backend_on_cuda_matches_cpu(cuda):
    # the card's core route against the CPU's core program at the same S
    from grail_tpu_torch.synth import kernel as pk
    from grail_tpu_torch.utils import sample_error_db

    scores = [g.text_to_score(t) for t in ("ae", "ea")]
    Ns = [_score_num_samples(s, 44100.0) for s in scores]
    _, carrier, S, _ = g.route(2, max(Ns), None, cuda, 44100.0, "core")
    assert carrier == "q32"
    n0 = dict(pk.LAUNCHES)
    on_card = g.synthesize_batch(["ae", "ea"], device="cuda", backend="core")
    torch.cuda.synchronize()
    assert pk.LAUNCHES["synth_core"] > n0["synth_core"]
    assert pk.LAUNCHES["fused_synth"] == n0["fused_synth"]
    assert pk.LAUNCHES["phase_q32_pre"] == n0["phase_q32_pre"]
    on_cpu = (papi._synthesize_split(scores, S=S, device="cpu",
                                     backend="core") if S > 1 else
              g.synthesize_scores(scores, device="cpu", backend="core"))
    for a, b in zip(on_card, on_cpu):
        assert a.device.type == "cuda" and a.shape == b.shape
        assert sample_error_db(a.cpu().numpy(), b.numpy()) < -100


def test_core_route_on_the_card(cuda):
    # the core backend splits to CORE_MAX_LANES lanes on the card
    from grail_tpu_torch.synth import kernel as pk

    for B, maxN in ((64, 356_000), (1, 88_190)):
        assert g.route(B, maxN, None, cuda, 44100.0, "core") == (
            ("kernel", "q32") + papi.choose_split(B, maxN, pk.CORE_MAX_LANES))


# ---------------------------------------------------------------------------
# kernel 1's carry mode and the serving path (runtime/stream.py)
# ---------------------------------------------------------------------------

def _carry_setup(device, N, seed=0):
    """Carry-mode inputs for N lanes: tables over sliding lattice windows
    of 64 rows (row 0 at absolute cell lat_base != 0), per-lane score
    offsets, and
    carried rows sf [N, 24], si [N, 5] with nonzero filters, seeds, carrier
    phases and each lane's exact jitter state at its own position."""
    from grail_tpu_torch.synth.schedule import get_schedule

    rng = np.random.default_rng(seed)
    voice = g.get_voice("plain")
    inc = voice.jitter_frequency
    texts = ["hello there", "aeio", "the quick brown fox"]
    E = max(g.text_to_score(t, voice).num_elems for t in texts)
    base = [g.text_to_score(t, voice, pad_to=E) for t in texts]
    scores = stack_scores([base[i % 3] for i in range(N)])
    W = 64
    pos = rng.integers(200_000, 380_000, N)     # cells 72 to 138
    sched = get_schedule(inc)
    js = [sched.state_at(int(p)) for p in pos]
    # every third lane reads past its window's last row (the clamp edge)
    lat_base = np.asarray([max(c - (70 if i % 3 == 2 else
                                    int(rng.integers(0, 8))), 0)
                           for i, (_, c) in enumerate(js)], np.int32)
    lats = [build_lattice(int(s), 882_000, inc) for s in range(N)]
    lattice = JitterLattice(*(np.stack([f[b:b + W] for f, b in zip(
        fs, lat_base)]) for fs in zip(*lats)))
    jp = (inc, voice.jitter_delta_frequency,
          voice.jitter_delta_formant_frequency, voice.jitter_delta_amplitude)
    tables = kf.build_tables(scores, lattice, jp, voice.sample_rate,
                             device=device)
    sf = torch.from_numpy(rng.standard_normal((N, 24)).astype(np.float32)
                          * 1e-3).to(device)
    si = np.zeros((N, 5), np.int32)
    si[:, 1] = rng.integers(0, 2 ** 31, N)
    si[:, 2] = rng.random(N).astype(np.float32).view(np.int32)
    si[:, 3] = np.asarray([p for p, _ in js], np.float32).view(np.int32)
    si[:, 4] = [c for _, c in js]
    return dict(tables=tables, sf=sf, si=torch.from_numpy(si).to(device),
                g0=torch.from_numpy(rng.integers(22_050, 60_000, N).astype(
                    np.int32)).to(device),
                lat_base=torch.from_numpy(lat_base).to(device), inc=inc)


@pytest.mark.parametrize("N", [3, 128, 512])
def test_carry_kernel_equals_plain_bitwise(cuda, N):
    # five ticks, each version carrying its own state and the offsets
    # advancing by a block: audio, sf, si (seed, carrier phase, jitter
    # phase and absolute cell) bit for bit at every tick; N = 512 is the
    # serving pool's main width
    x = _carry_setup(cuda, N)
    blk = 1024
    kst = pst = (x["sf"], x["si"])
    g0 = x["g0"]
    for tick in range(5):
        kw = dict(g0=g0, lat_base=x["lat_base"], inc=x["inc"])
        n0 = dict(kf.LAUNCHES)
        a, *kst = kf.fused_synth_cuda(x["tables"], None, None, *kst, blk,
                                      True, **kw)
        assert kf.LAUNCHES["fused_synth_carry"] == \
            n0["fused_synth_carry"] + 1
        assert kf.LAUNCHES["fused_synth"] == n0["fused_synth"]
        r, *pst = kf.synth_fused_reference(x["tables"], None, None, *pst,
                                           blk, True, **kw)
        torch.cuda.synchronize()
        assert torch.equal(kst[1], pst[1]), tick
        assert torch.equal(kst[0], pst[0]), tick
        assert torch.equal(a, r), tick
        assert bool(torch.isfinite(a).all())
        g0 = g0 + blk
    assert float(a.abs().max()) > 0.01
    # the jitter state moved on by five blocks of the recurrence
    assert bool((kst[1][:, 4] >= x["si"][:, 4]).all())
    assert bool((kst[1][:, 4] > x["si"][:, 4]).any())


def test_carry_wrapper_rejects_bad_inputs(cuda):
    x = _carry_setup(cuda, 2)
    kw = dict(g0=x["g0"], lat_base=x["lat_base"], inc=x["inc"])
    with pytest.raises(ValueError, match="si"):
        kf.fused_synth_cuda(x["tables"], None, None, x["sf"],
                            x["si"][:, :3].contiguous(), 1024, True, **kw)
    with pytest.raises(ValueError, match="lat_base"):
        kf.fused_synth_cuda(x["tables"], None, None, x["sf"], x["si"], 1024,
                            True, g0=x["g0"], lat_base=x["lat_base"].long(),
                            inc=x["inc"])
    with pytest.raises(ValueError, match="inc"):
        kf.fused_synth_cuda(x["tables"], None, None, x["sf"], x["si"], 1024,
                            True, g0=x["g0"])
    phi, cell = device_window(x["inc"], 0, 1024, cuda)
    with pytest.raises(ValueError, match="carry"):
        kf.fused_synth_cuda(x["tables"], phi, cell, x["sf"],
                            x["si"][:, :3].contiguous(), 1024, True, **kw)


def _fed_pool(device, n=3):
    from grail_tpu_torch.runtime.stream import StreamPool

    pool = StreamPool(n, voice="plain", language="english", device=device,
                      jitter_horizon_s=0.3, seeds=[3, 7, 6][:n])
    pool.feed(0, "[rate:8]hello hello", parse_commands=True)
    pool.feed(1, "[pitch:180]aeio", parse_commands=True)
    pool.flush()
    return pool


def test_pool_on_cuda_matches_cpu(cuda):
    # ten ticks through a window slide: the card's pool launches the carry
    # kernel once per tick and renders what the CPU's plain pool renders
    from grail_tpu_torch.utils import sample_error_db

    on_card, on_cpu = _fed_pool("cuda"), _fed_pool("cpu")
    for p in (on_card, on_cpu):
        for _ in range(16):
            p.read_block()
    n0 = dict(kf.LAUNCHES)
    a = np.concatenate([on_card.read_block() for _ in range(10)], axis=1)
    assert kf.LAUNCHES["fused_synth_carry"] == n0["fused_synth_carry"] + 10
    assert all(kf.LAUNCHES[k] == n0[k] for k in n0
               if k != "fused_synth_carry")
    b = np.concatenate([on_cpu.read_block() for _ in range(10)], axis=1)
    assert [s._lat_base for s in on_card.sessions] == \
        [s._lat_base for s in on_cpu.sessions]
    assert any(s._lat_base > 0 for s in on_card.sessions)
    for i in range(3):
        assert sample_error_db(a[i], b[i]) < -100 or np.array_equal(a[i],
                                                                    b[i])
    assert torch.equal(on_card._si.cpu(), on_cpu._si)


def test_solo_read_on_cuda_matches_cpu(cuda):
    from grail_tpu_torch.runtime.stream import StreamSession
    from grail_tpu_torch.utils import sample_error_db

    outs = []
    for device in ("cuda", "cpu"):
        s = StreamSession(voice="plain", language="english", device=device)
        s.feed("hello")
        s.flush()
        n0 = kf.LAUNCHES["fused_synth_carry"]
        outs.append(s.read(4 * 1024))
        assert kf.LAUNCHES["fused_synth_carry"] == n0 + (
            4 if device == "cuda" else 0)
    assert np.abs(outs[0]).max() > 0.01
    assert sample_error_db(outs[0], outs[1]) < -100 or np.array_equal(
        *outs)


# ---- serve mode: the served tick as a CUDA graph's replay -----------------

_SERVE_TEXTS = ("[rate:8]hello hello", "[pitch:180]aeio", "go on now",
                "all lines are busy", "every call is important to us")


def _serve_pools(n, output="f32", **kw):
    """Two pools on the card fed alike, 0.3 s lattice windows (so windows
    slide) and a [rate:8] session (so its score rebases); every third
    session is left for a later feed: (the pool to serve, its twin)."""
    from grail_tpu_torch.runtime.stream import StreamPool

    def mk():
        pool = StreamPool(n, voice="plain", language="english",
                          output=output, jitter_horizon_s=0.3, **kw)
        for i in range(n):
            if i % 3 != 2:
                pool.feed(i, _SERVE_TEXTS[i % len(_SERVE_TEXTS)],
                          parse_commands=True)
        pool.flush()
        return pool

    return mk(), mk()


def _late_feeds(t, n, pools):
    """The feeds of the served schedule at tick t, to every pool alike."""
    for p in pools:
        if t == 8:
            for i in range(2, n, 3):
                p.feed(i, "open the door")
                p.flush(i)
        elif t == 20:
            p.feed(0, " and more")
            p.flush(0)


@pytest.mark.parametrize("output", ["f32", "pcm16", "ulaw"])
@pytest.mark.parametrize("N", [3, 128])
def test_served_graph_equals_eager_ticks(cuda, N, output):
    # a build before every served tick, as read_block prepares every tick:
    # each served tick (one graph replay) equals the twin's eager carry
    # launch and conversion, audio and carried rows bit for bit, over ticks
    # that cross feeds, window slides and a rebase
    pool, twin = _serve_pools(N, output, pin_elems=64)
    pool.serve_start(period=9999)
    n0, c0 = dict(kf.LAUNCHES), pool._serve_captures
    ticks, loud = 36, 0
    for t in range(ticks):
        _late_feeds(t, N, (pool, twin))
        pool._serve_build()
        a = pool.serve_tick()
        b = twin.read_block(sync=False)
        assert a.dtype == b.dtype and a.shape == (N, 1024)
        assert torch.equal(a, b), t
        assert torch.equal(pool._sf, twin._sf), t
        assert torch.equal(pool._si, twin._si), t
        loud += int((a != a[:, :1]).any(dim=1).sum())
    assert loud > 0
    # the served ticks count one carry launch each, as the twin's do
    assert kf.LAUNCHES["fused_synth_carry"] == \
        n0["fused_synth_carry"] + 2 * ticks
    assert all(kf.LAUNCHES[k] == n0[k] for k in n0
               if k != "fused_synth_carry")
    assert pool._serve_captures >= c0 + 3       # a graph per published set
    pool.serve_stop()
    assert any(s._lat_base > 0 for s in pool.sessions)
    s0 = pool.sessions[0]
    assert s0._consumed_samples < s0._jitter_pos          # a rebase
    # serve_stop, then read_block continues exactly
    for _ in range(3):
        assert torch.equal(pool.read_block(sync=False),
                           twin.read_block(sync=False))


def test_serve_recaptures_on_an_e_change(cuda):
    pool, twin = _serve_pools(2, pin_elems=16)
    pool.serve_start(period=9999)
    assert torch.equal(pool.serve_tick(), twin.read_block(sync=False))
    E0, c0, cur = pool._cache_key[0], pool._serve_captures, pool._serve_cur
    for p in (pool, twin):
        p.feed(1, " a much longer feed that grows the element bucket past "
                  "its pin for sure, yes indeed it does grow")
        p.flush(1)
    assert pool._serve_build()
    assert pool._cache_key[0] > E0 == 16
    assert pool._serve_captures == c0 + 1
    assert torch.equal(pool.serve_tick(), twin.read_block(sync=False))
    assert pool._serve_cur is not cur
    assert pool._serve_cur["dev"]["n"].shape[1] == pool._cache_key[0]
    pool.serve_stop()


def test_served_outputs_outlive_later_ticks(cuda):
    # the graph's output buffer is rewritten by every replay; serve_tick
    # returns a copy: tick k's tensor still holds tick k after k+1..k+3
    pool, twin = _serve_pools(3, pin_elems=64)
    ref = [twin.read_block(sync=False) for _ in range(8)]
    pool.serve_start(period=9999)
    got = [pool.serve_tick() for _ in range(8)]
    torch.cuda.synchronize()
    for k, (a, b) in enumerate(zip(got, ref)):
        assert torch.equal(a, b), k
    assert len({t.data_ptr() for t in got[4:]}) == 4
    pool.serve_stop()


# the kernel each LAUNCHES key counts, as the profiler's trace names it
_TRACED = {"fused_synth_carry": "fused_synth_kernel",
           "carrier_scan": "carrier_scan_kernel",
           "jsched_scan": "jsched_scan_kernel"}


@pytest.mark.parametrize("mode,block", [("served", 1024), ("eager", 1024),
                                        ("served", 441), ("eager", 441),
                                        ("mesh", 1024)],
                         ids=["served", "eager", "served_xla", "eager_xla",
                              "eager_mesh"])
def test_steady_served_ticks_copy_nothing_from_the_host(cuda, mode, block,
                                                        request):
    # a steady tick copies nothing from the host: the profiler sees the
    # tick's kernels once a tick and no host->device copy. Served: one
    # replay and one device copy; eager: read_block on the fused tick, the
    # xla tick and a one-rank mesh's tick, the default 60 s windows (none
    # slides), every session fed
    # (a warm-up step of the profiler first: without it a trace of 20
    # served ticks once missed one graph-launched kernel)
    import contextlib

    from grail_tpu_torch.runtime.stream import _TICK_LAUNCHES, StreamPool

    with contextlib.ExitStack() as stack:
        if mode == "served":
            pool, _ = _serve_pools(3, pin_elems=64, block=block)
            pool.serve_start(period=9999)
            stack.callback(pool.serve_stop)
            tick = pool.serve_tick
        else:
            kw = {}
            if mode == "mesh":
                kw["mesh"] = request.getfixturevalue("card_mesh")
            pool = StreamPool(3, voice="plain", language="english",
                              block=block, **kw)
            for i in range(3):
                pool.feed(i, _SERVE_TEXTS[i + 2])
            pool.flush()
            for _ in range(4):
                pool.read_block()
            tick = pool.read_block
        names = _TICK_LAUNCHES[pool._program]
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        sched = torch.profiler.schedule(wait=0, warmup=1, active=1)
        with torch.profiler.profile(activities=acts, schedule=sched,
                                    acc_events=True) as prof:
            for _ in range(3):
                tick()
            torch.cuda.synchronize()
            prof.step()
            n0 = dict(kf.LAUNCHES)
            for _ in range(5):
                tick()
            torch.cuda.synchronize()
            prof.step()
    ev = {e.key: e.count for e in prof.key_averages()}
    assert sum(c for k, c in ev.items() if "HtoD" in k) == 0, ev
    for name in names:
        assert sum(c for k, c in ev.items() if _TRACED[name] in k) == 5, ev
        assert kf.LAUNCHES[name] == n0[name] + 5


def test_captures_run_on_the_frontend_thread(cuda):
    # after serve_start, every capture is the frontend thread's: the
    # real-time thread (here the test's) only adopts and replays
    import threading
    import time

    pool, twin = _serve_pools(3, pin_elems=64)
    pool.serve_start(period=0.005)
    threads, real = [], pool._serve_capture

    def recording(swap):
        threads.append(threading.current_thread().name)
        return real(swap)

    pool._serve_capture = recording
    try:
        for t in range(30):
            if t % 5 == 0:
                pool.feed(t % 3, "go ")
                pool.flush(t % 3)
            assert bool(torch.isfinite(pool.serve_tick()).all())
            time.sleep(0.005)
    finally:
        pool.serve_stop()
    assert threads and set(threads) == {"StreamPool-frontend"}, threads


def test_a_failed_capture_raises_and_publishes_nothing(cuda, monkeypatch):
    from grail_tpu_torch.runtime import stream as st

    pool, _ = _serve_pools(3, pin_elems=64)
    pool.serve_start(period=9999)
    pool.serve_tick()
    real = st._served_tick

    def fails(*args):
        real(*args)
        raise RuntimeError("capture fault")

    monkeypatch.setattr(st, "_served_tick", fails)
    key, c0, cur = pool._serve_pub_key, pool._serve_captures, \
        pool._serve_cur
    pool.feed(2, "hello")
    pool.flush(2)
    with pytest.raises(RuntimeError, match="capture fault"):
        pool._serve_build()
    assert pool._serve_pub_key == key and pool._serve_captures == c0
    assert pool._swap_pending is None
    pool.serve_tick()                        # the old set serves on
    assert pool._serve_cur is cur
    monkeypatch.undo()
    assert pool._serve_build()               # the retry publishes
    pool.serve_tick()
    assert pool._serve_cur is not cur
    pool.serve_stop()


def test_one_rank_mesh_pool_equals_the_pool_on_the_card(card_mesh):
    # StreamPool(mesh=) on a one-rank mesh (gloo, so no second process):
    # one carry launch a tick, its reads, save() and served ticks equal to
    # the unsharded pool's (tests/test_torch_pool_mesh.py runs meshes of
    # several ranks on the CPU)
    import io

    from grail_tpu_torch.runtime.stream import StreamPool

    def mk(**kw):
        pool = StreamPool(6, voice="plain", language="english", pin_elems=64,
                          **kw)
        for i in range(6):
            pool.feed(i, _SERVE_TEXTS[i % len(_SERVE_TEXTS)],
                      parse_commands=True)
        pool.flush()
        return pool

    sharded, ref = mk(mesh=card_mesh), mk()
    assert sharded.device == torch.device(
        "cuda", torch.cuda.current_device())      # the mesh's device
    assert sharded.local_sessions == range(6)
    n0 = kf.LAUNCHES["fused_synth_carry"]
    got = [sharded.read_block(sync=False) for _ in range(4)]
    assert kf.LAUNCHES["fused_synth_carry"] == n0 + 4
    for a in got:
        assert torch.equal(a, ref.read_block(sync=False))
    za, zb = (np.load(io.BytesIO(p.save())) for p in (sharded, ref))
    assert za.files == zb.files
    for k in za.files:
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    for p in (sharded, ref):
        p.serve_start(period=9999)
    try:
        for _ in range(4):
            assert torch.equal(sharded.serve_tick(), ref.serve_tick())
    finally:
        for p in (sharded, ref):
            p.serve_stop()


def test_one_rank_mesh_pipeline_equals_the_xla_program_on_the_card(
        cuda, card_mesh):
    # sharded_pipeline on a one-rank card mesh (gloo, in process) renders
    # the single-process xla program's Q32 audio for bench.py's 64 texts,
    # and like it launches no kernel (tests/test_torch_parallel.py runs
    # meshes of several ranks on the CPU)
    from grail_tpu_torch.parallel import sharded_pipeline
    from grail_tpu_torch.utils import sample_error_db

    b = papi._Batch([g.text_to_score(t) for t in BENCH_TEXTS], "generic",
                    None)
    T = _round_up(max(b.Ns), 8192)
    lattices, jparams = b.jitter(T)
    n0 = dict(kf.LAUNCHES)
    ref = papi._xla_run(papi._core_unsplit_setup(
        b.core_lanes(T, cuda), T, b.sr, jparams[0]), "q32").cpu().numpy()
    out = sharded_pipeline(stack_scores(b.scores), lattices, jparams, b.sr,
                           T, card_mesh)
    torch.cuda.synchronize()
    assert kf.LAUNCHES == n0
    assert out.device.type == "cuda" and tuple(out.shape) == (64, T)
    out = out.cpu().numpy()
    assert np.isfinite(out).all()
    for k in range(64):
        assert sample_error_db(out[k], ref[k]) < -100, k


# ---- the host_track mode (the solo long-form route) and the FP32 probe -----

def _long_form_lanes(cuda):
    """The long-form route's own split of LONG_EN (86.5 s, voice plain,
    english) on this card, with its native carrier track: (lanes,
    schedule rows, g0, track rows, lane length, sf, si)."""
    from grail_tpu_torch.benchmarks.kernel1_ab import LONG_EN

    v = g.get_voice("plain")
    pel = g.text_to_phoneme_elems(LONG_EN, v, "english")
    b = papi._Batch([papi.score_from_phoneme_elems(pel, v)], v, [0])
    impl, carrier, S, T = g.route(1, b.Ns[0], None, cuda, b.sr, track=True)
    assert (impl, carrier) == ("kernel", "track") and S > 1
    track = papi._carrier_track_for(pel, v, 0)
    lanes, seg, state, q, g0, car = papi._split_lanes(
        b.tables(T, cuda), T, S, "kernel", v.jitter_frequency, track)
    return (lanes, seg, g0, car, T // S + papi.WARMUP,
            *kf.state_rows(state, q))


@pytest.mark.parametrize("S", [1, 4, None],
                         ids=["unsplit", "split4", "long_form_route"])
def test_host_track_kernel_equals_plain_bitwise(cuda, S):
    # the track replaces both carrier accumulators; kernel and plain version
    # read the same track, so audio and carried state agree bit for bit.
    # S None: every lane of the long-form route's split on the card, reading
    # the text's own native track
    if S is None:
        lanes, sched, g0, car, Tl, sf, si = _long_form_lanes(cuda)
    else:
        tables, (phi, cell), T = _tables(["aeae"], ["generic"], cuda)
        rng = np.random.default_rng(S)
        track = rng.random(T - 11).astype(np.float32)
        if S == 1:
            car = papi._pad_track(track, T, cuda)
            sched, lanes, g0, Tl = (phi, cell), tables, None, T
        else:
            T = _round_up(T, S * 4096)
            lanes, seg, state, q, g0, car = papi._split_lanes(
                tables, T, S, "kernel",
                g.get_voice("generic").jitter_frequency, track)
            sched, Tl = seg, T // S + papi.WARMUP
            assert car.stride() == seg[0].stride() and not q.any()
        B = lanes.n.shape[0]
        sf = torch.randn(B, 24, device=cuda) * 1e-3
        si = torch.tensor([[123456789, 42, 7]] * B, dtype=torch.int32,
                          device=cuda)
    n0 = dict(kf.LAUNCHES)
    out_k = kf.fused_synth_cuda(lanes, *sched, sf, si, Tl, False, g0=g0,
                                carrier=car)
    torch.cuda.synchronize()
    assert kf.LAUNCHES["fused_synth_track"] == n0["fused_synth_track"] + 1
    assert all(kf.LAUNCHES[k] == n0[k] for k in n0
               if k != "fused_synth_track")
    out_p = kf.synth_fused_reference(lanes, *sched, sf, si, Tl, False, g0=g0,
                                     carrier=car)
    for k, p in zip(out_k, out_p):
        assert torch.equal(k, p)
    assert out_k[0].abs().max() > 0.01
    # the Q32 and f32 phase columns pass through
    assert torch.equal(out_k[2][:, 0], si[:, 0])
    assert torch.equal(out_k[2][:, 2], si[:, 2])


def test_host_track_wrapper_checks(cuda):
    tables, (phi, cell), T = _tables(["ae"], ["generic"], cuda)
    sf = torch.zeros(1, 24, device=cuda)
    si = torch.zeros(1, 3, dtype=torch.int32, device=cuda)
    car = torch.zeros(T, device=cuda)
    with pytest.raises(ValueError, match="carrier track"):
        kf.fused_synth_cuda(tables, phi, cell, sf, si, T, True, carrier=car)
    with pytest.raises(ValueError, match="carrier track"):
        kf.fused_synth_cuda(tables, None, None, sf,
                            torch.zeros(1, 5, dtype=torch.int32, device=cuda),
                            T, False, inc=0.0004, carrier=car)
    with pytest.raises(ValueError, match="shape or strides"):
        kf.fused_synth_cuda(tables, phi, cell, sf, si, T, False,
                            carrier=car[:-1])
    with pytest.raises(ValueError, match="dtype"):
        kf.fused_synth_cuda(tables, phi, cell, sf, si, T, False,
                            carrier=car.double())
    with pytest.raises(ValueError, match="device"):
        kf.fused_synth_cuda(tables, phi, cell, sf, si, T, False,
                            carrier=car.cpu())


def test_solo_track_route_on_cuda_matches_cpu(cuda):
    # exact_carrier=True on one utterance: the host track, split kept, one
    # launch of the track mode and no Q32 pre-pass; held against the CPU's
    # split with the same track at the same S
    from grail_tpu_torch.utils import sample_error_db

    pel = g.text_to_phoneme_elems("hello there", "plain", "english")
    v = g.get_voice("plain")
    track = papi._carrier_track_for(pel, v, 0)
    score = papi.score_from_phoneme_elems(pel, v)
    N = _score_num_samples(score, 44100.0)
    impl, carrier, S, T = g.route(1, N, True, cuda, 44100.0, track=True)
    assert (impl, carrier) == ("kernel", "track") and S > 1
    n0 = dict(kf.LAUNCHES)
    a = g.synthesize("hello there", "plain", "english", exact_carrier=True)
    assert kf.LAUNCHES["fused_synth_track"] == n0["fused_synth_track"] + 1
    assert all(kf.LAUNCHES[k] == n0[k] for k in n0
               if k != "fused_synth_track")
    b = papi._synthesize_split([score], v, [0], S=S, device="cpu",
                               carrier_tracks=[track])[0]
    assert a.device.type == "cuda" and a.shape == b.shape == (N,)
    assert sample_error_db(a.cpu().numpy(), b.numpy()) < -100
    k = g.synthesize("hello there", "plain", "english",
                     exact_carrier="kernel")
    np.testing.assert_allclose(a.cpu().numpy(), k.cpu().numpy(), atol=5e-5,
                               rtol=0)


def test_long_form_route_on_the_card(cuda, tmp_path, monkeypatch):
    # the solo long-form route at full width, from the command line to a
    # WAV: an 86.5 s text takes the host track on the split, one launch of
    # kernel 1's track mode and no other kernel; its audio passes the
    # fidelity gate against the native oracle (< -60 dB spectral error)
    # and stays within 5e-5 per 30 s of audio of the in-kernel
    # recurrence's route (the two frequency chains' ulps add up over the
    # f32 carrier recurrence: 4.64e-5 was read at 86.5 s). Then one REPL
    # line on the card.
    import io
    import sys

    from grail_tpu_torch import cli, interactive
    from grail_tpu_torch.benchmarks.kernel1_ab import LONG_EN
    from grail_tpu_torch.oracle.native import gold_dsp_chain
    from grail_tpu_torch.runtime.wav import load_wav
    from grail_tpu_torch.utils import spectral_error_db
    from grail_tpu_torch.voices import get_spec

    v = g.get_voice("plain")
    sr = float(v.sample_rate)
    pel = g.text_to_phoneme_elems(LONG_EN, v, "english")
    N = _score_num_samples(papi.score_from_phoneme_elems(pel, v), sr)
    impl, carrier, S, _ = g.route(1, N, None, cuda, sr, track=True)
    assert (impl, carrier) == ("kernel", "track") and S > 1
    wav = str(tmp_path / "long.wav")
    n0 = dict(kf.LAUNCHES)
    assert cli.main(["-v", "plain", "-l", "english", "-o", wav, "-s",
                     LONG_EN]) == 0
    torch.cuda.synchronize()
    assert {k: kf.LAUNCHES[k] - n0[k] for k in n0
            if kf.LAUNCHES[k] != n0[k]} == {"fused_synth_track": 1}
    pcm, wav_sr = load_wav(wav)
    assert wav_sr == int(sr) and len(pcm) == N and np.isfinite(pcm).all()
    a = g.synthesize(LONG_EN, "plain", "english").cpu().numpy()
    assert np.abs(a - pcm).max() <= 1.5 / 32767     # one PCM step
    assert spectral_error_db(a, gold_dsp_chain(pel, get_spec("plain"),
                                               0)) < -60
    assert g.route(1, N, "kernel", cuda, sr)[1:3] == ("kcar", S)
    k = g.synthesize(LONG_EN, "plain", "english",
                     exact_carrier="kernel").cpu().numpy()
    assert np.abs(a - k).max() <= 5e-5 * max(1.0, N / sr / 30.0)

    repl = str(tmp_path / "repl.wav")
    monkeypatch.setattr(sys, "stdin", io.StringIO("hello\n"))
    n0 = dict(kf.LAUNCHES)
    assert interactive.main(["-o", repl, "--block", "1024"]) == 0
    assert {k for k in n0 if kf.LAUNCHES[k] != n0[k]} == \
        {"fused_synth_carry"}
    out, _ = load_wav(repl)
    assert np.isfinite(out).all() and np.abs(out).max() > 0.01


def test_fma_peak_kernel_against_plain(cuda):
    from grail_tpu_torch.benchmarks import fma_peak as fp

    rng = np.random.default_rng(0)
    x = torch.from_numpy((1.0 + 0.5 * rng.random((16, 8, 128)))
                         .astype(np.float32)).to(cuda)
    iters, grid = 64, 2
    plain = fp.fma_peak_reference(x, grid, iters)
    n0 = fp.LAUNCHES["fma_peak"]
    out = fp.fma_peak(x, grid, iters, "mul_add")
    fused = fp.fma_peak(x, grid, iters, "fma")
    torch.cuda.synchronize()
    assert fp.LAUNCHES["fma_peak"] == n0 + 2
    assert out.shape == plain.shape == (grid, x.numel())
    assert torch.equal(out, plain)                 # two roundings per update
    # one rounding per update: each step's error is under one ulp of a
    # value below 2, 2^-23 * 2 per step at most
    assert (fused - plain).abs().max() <= iters * 2.0 ** -22
    assert not torch.equal(fused, plain)
    with pytest.raises(ValueError, match="multiple"):
        fp.fma_peak_cuda(x.reshape(-1)[:100], 1, 4)
    with pytest.raises(ValueError, match="variant"):
        fp.fma_peak_cuda(x, 1, 4, "fused")
    m = fp.measure(iters=256)
    for variant in fp.VARIANTS:
        assert m[variant]["ms"] > 0 and m[variant]["instructions_per_s"] > 0


# ---------------------------------------------------------------------------
# seq_scan.cu: the xla core's and the xla tick's two f32 recurrences
# ---------------------------------------------------------------------------

def _freq_rows(T, B, seed=0):
    """A carrier frequency stream [T, B]: voiced pitches, a run of the
    silent frame's 0.25 and a zero lane, so that every wrap rule shows."""
    rng = np.random.default_rng(seed)
    f = (0.002 + 0.01 * rng.random((T, B))).astype(np.float32)
    f[: min(T, 9)] = np.float32(0.25)
    if B > 2:
        f[:, 2] = 0.0
    return f


@pytest.mark.parametrize("T,B", [(441, 512), (4096, 64), (4096, 1), (7, 3)])
def test_carrier_scan_kernel_equals_plain(cuda, T, B):
    from grail_tpu_torch.synth import seq_scan as sq

    f = torch.from_numpy(_freq_rows(T, B)).to(cuda)
    p0 = torch.linspace(0.0, 0.999, B, device=cuda)
    n0 = dict(kf.LAUNCHES)
    tk, pk = sq.carrier_scan(p0, f)
    assert kf.LAUNCHES["carrier_scan"] == n0["carrier_scan"] + 1
    tp, pp = sq.carrier_scan(p0, f, impl="plain")
    assert tk.shape == (T, B) and torch.equal(tk, tp) and torch.equal(pk, pp)
    # the state carries over two calls as over one
    h = T // 2
    t1, q1 = sq.carrier_scan(p0, f[:h])
    t2, q2 = sq.carrier_scan(q1, f[h:])
    assert torch.equal(torch.cat([t1, t2]), tk) and torch.equal(q2, pk)


@pytest.mark.parametrize("T,B", [(441, 512), (4096, 64), (4096, 1), (7, 3)])
@pytest.mark.parametrize("inc", [0.0002, 0.3])
def test_jsched_scan_kernel_equals_plain(cuda, T, B, inc):
    from grail_tpu_torch.synth import seq_scan as sq

    jphi = torch.linspace(0.0, 0.99995, B, device=cuda)
    jcell = torch.arange(B, dtype=torch.int32, device=cuda) * 7
    n0 = dict(kf.LAUNCHES)
    k = sq.jsched_scan(jphi, jcell, inc, T)
    assert kf.LAUNCHES["jsched_scan"] == n0["jsched_scan"] + 1
    p = sq.jsched_scan(jphi, jcell, inc, T, impl="plain")
    assert k[0].shape == k[1].shape == (B, T)
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    h = T // 2
    a = sq.jsched_scan(jphi, jcell, inc, h)
    b = sq.jsched_scan(a[2], a[3], inc, T - h)
    assert torch.equal(torch.cat([a[0], b[0]], 1), k[0])
    assert torch.equal(torch.cat([a[1], b[1]], 1), k[1])
    assert torch.equal(b[2], k[2]) and torch.equal(b[3], k[3])


def test_seq_scan_wrappers_reject_bad_inputs(cuda):
    from grail_tpu_torch.synth import seq_scan as sq

    f = torch.zeros(8, 4, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        sq.carrier_scan_cuda(torch.zeros(4, device=cuda), f.double())
    with pytest.raises(ValueError, match="shape"):
        sq.carrier_scan_cuda(torch.zeros(3, device=cuda), f)
    with pytest.raises(ValueError, match="CUDA"):
        sq.carrier_scan_cuda(torch.zeros(4), f.cpu())
    with pytest.raises(ValueError, match="dtype"):
        sq.jsched_scan_cuda(torch.zeros(4, device=cuda),
                            torch.zeros(4, device=cuda), 0.1, 8)


def test_xla_routes_on_cuda_match_cpu(cuda):
    # the xla batch with exact_carrier="kernel" launches carrier_scan once a
    # block and no other kernel; the scan core and the Q32 xla route match
    # the CPU too
    from grail_tpu_torch.utils import sample_error_db

    texts = ["ae", "ea", "aeae"]
    for kw, want in ((dict(exact_carrier="kernel"), {"carrier_scan"}),
                     (dict(exact_carrier=False), set()),
                     (dict(backend="scan"), {"carrier_scan"})):
        kw = dict({"backend": "xla"}, **kw)
        n0 = dict(kf.LAUNCHES)
        a = g.synthesize_batch(texts, **kw)
        torch.cuda.synchronize()
        moved = {k for k in n0 if kf.LAUNCHES[k] != n0[k]}
        assert moved == want, (kw, moved)
        if kw.get("exact_carrier") == "kernel":
            T = _round_up(max(x.shape[0] for x in a), 4096)
            assert (kf.LAUNCHES["carrier_scan"] - n0["carrier_scan"]
                    == T // 4096)
        b = g.synthesize_batch(texts, device="cpu", **kw)
        for x, y in zip(a, b):
            assert x.device.type == "cuda" and x.shape == y.shape
            assert sample_error_db(x.cpu().numpy(), y.numpy()) < -100


@pytest.mark.parametrize("block", [441, 1024])
def test_xla_pool_kernel_equals_plain(cuda, block):
    # each xla tick on the card (its two kernels) equals the same tick with
    # the recurrences' plain versions on the card, from the same state
    from grail_tpu_torch.runtime import stream as st

    pool = st.StreamPool(4, voice="plain", language="english", block=block,
                         backend="xla", jitter_horizon_s=0.3)
    for i in range(3):
        pool.feed(i, _SERVE_TEXTS[i % len(_SERVE_TEXTS)])
    pool.flush()
    n0 = dict(kf.LAUNCHES)
    ticks = 30 * 1024 // block          # 0.7 s: the 0.3 s windows slide
    for t in range(ticks):
        sf0, si0 = pool._sf.clone(), pool._si.clone()
        a = pool.read_block(sync=False)
        ins = dict(pool._dev, offsets=pool._dev["offsets"] - block)
        ref = st._xla_tick("plain", ins, sf0, si0, block)
        for x, y in zip((a, pool._sf, pool._si), ref):
            assert torch.equal(x, y), t
    assert kf.LAUNCHES["carrier_scan"] == n0["carrier_scan"] + ticks
    assert kf.LAUNCHES["jsched_scan"] == n0["jsched_scan"] + ticks
    assert kf.LAUNCHES["fused_synth_carry"] == n0["fused_synth_carry"]
    assert any(s._lat_base > 0 for s in pool.sessions)


def test_xla_pool_on_cuda_matches_cpu(cuda):
    from grail_tpu_torch.runtime.stream import StreamPool
    from grail_tpu_torch.utils import sample_error_db

    def run(device):
        pool = StreamPool(3, voice="plain", language="english", block=441,
                          device=device)
        pool.feed(0, "hello world")
        pool.feed(1, "aeio")
        pool.flush()
        return np.concatenate([pool.read_block() for _ in range(40)], 1)

    a, b = run("cuda"), run("cpu")
    for i in (0, 1):
        assert sample_error_db(a[i], b[i]) < -100


@pytest.mark.parametrize("N", [3, 128])
def test_served_xla_graph_equals_eager_ticks(cuda, N):
    # serve mode on an xla pool: one graph per published set holding the
    # xla tick (its two kernels and torch ops), each replay equal to the
    # twin's eager tick, counted as one launch of each kernel
    pool, twin = _serve_pools(N, pin_elems=64, block=441)
    assert pool.backend == "xla"
    pool.serve_start(period=9999)
    n0 = dict(kf.LAUNCHES)
    ticks = 80                  # 0.8 s: the 0.3 s windows slide
    for t in range(ticks):
        _late_feeds(t, N, (pool, twin))
        pool._serve_build()
        a = pool.serve_tick()
        b = twin.read_block(sync=False)
        assert torch.equal(a, b), t
        assert torch.equal(pool._sf, twin._sf), t
        assert torch.equal(pool._si, twin._si), t
    for k in ("carrier_scan", "jsched_scan"):
        assert kf.LAUNCHES[k] == n0[k] + 2 * ticks
    assert kf.LAUNCHES["fused_synth_carry"] == n0["fused_synth_carry"]
    pool.serve_stop()
    assert any(s._lat_base > 0 for s in pool.sessions)
    assert torch.equal(pool.read_block(sync=False),
                       twin.read_block(sync=False))


def test_xla_tick_stages_under_a_profiler_on_the_card(cuda):
    # the xla tick's five stage spans (runtime/trace.py) on the card, under
    # a profiler: eager ticks record them in `launch` once a tick, with
    # audio and rows bit-equal to a twin's unprofiled ticks; serve mode
    # captures the tick under the profiler, once also inside an open span,
    # so that the stages' profiler ranges run inside the capture, and every
    # replay equals the twin's eager tick and counts one launch of each
    # kernel
    from grail_tpu_torch.runtime import trace

    stages = ("jsched", "frames", "carrier", "core", "pack")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    pool, twin = _serve_pools(3, pin_elems=64, block=441)
    assert pool.backend == "xla"
    trace.clear()
    with torch.profiler.profile(activities=acts):
        got = [pool.read_block(sync=False) for _ in range(6)]
        torch.cuda.synchronize()
    for t, a in enumerate(got):
        assert torch.equal(a, twin.read_block(sync=False)), t
    assert torch.equal(pool._sf, twin._sf) and torch.equal(pool._si,
                                                           twin._si)
    spans = trace.spans()
    assert [s.attrs["program"] for s in spans if s.name == "launch"] == \
        ["xla"] * 6
    assert [(s.name, s.parent) for s in spans if s.name in stages] == \
        [(n, "launch") for n in stages] * 6

    trace.clear()
    with torch.profiler.profile(activities=acts):
        pool.serve_start(period=9999)
        n0, c0 = dict(kf.LAUNCHES), pool._serve_captures
        for t in range(24):
            _late_feeds(t, 3, (pool, twin))
            if t == 8:
                with trace.span("launch"):
                    assert pool._serve_build()
            else:
                pool._serve_build()
            a = pool.serve_tick()
            assert torch.equal(a, twin.read_block(sync=False)), t
        torch.cuda.synchronize()
    spans = trace.spans()
    root, = [s for s in spans if s.name == "launch" and s.parent is None]
    assert [s.name for s in spans if s.call == root.call
            and s.name in stages] == list(stages)
    # the twin's eager ticks record theirs in the pool's `launch`
    assert sum(s.name in stages for s in spans) == 5 * 25
    assert pool._serve_captures > c0
    for k in ("carrier_scan", "jsched_scan"):
        assert kf.LAUNCHES[k] == n0[k] + 2 * 24
    assert torch.equal(pool._sf, twin._sf) and torch.equal(pool._si,
                                                           twin._si)
    pool.serve_stop()
