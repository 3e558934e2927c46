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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _tables(texts, voices, device, seeds=None):
    voices = [g.get_voice(v) for v in voices]
    sr = float(voices[0].sample_rate)
    E = max(g.text_to_score(t, v).num_elems for t, v in zip(texts, voices))
    scores = [g.text_to_score(t, v, pad_to=E) for t, v in zip(texts, voices)]
    T = _round_up(max(_score_num_samples(s, sr) for s in scores), 4096)
    seeds = seeds or list(range(len(texts)))
    inc = voices[0].jitter_frequency
    lat = JitterLattice(*(np.stack(f) for f in zip(
        *(build_lattice(sd, T, inc) for sd in seeds))))
    jp = (inc, [v.jitter_delta_frequency for v in voices],
          [v.jitter_delta_formant_frequency for v in voices],
          [v.jitter_delta_amplitude for v in voices])
    tables = kf.build_tables(stack_scores(scores), lat, jp, sr, device=device)
    return tables, device_window(inc, 0, T, device), T


@pytest.mark.parametrize("kcar", [False, True], ids=["q32", "kcar"])
def test_kernel_equals_plain_bitwise(cuda, kcar):
    # no FMA contraction in the kernel and one op order in both: the audio
    # and the whole carried state agree bit for bit
    tables, (phi, cell), T = _tables(["ae", "ea", "aeae"],
                                     ["generic", "generic", "generic"], cuda)
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
    # the exact carrier cannot split: the card's route stays unsplit and
    # launches the fused kernel alone, held against the CPU's same route
    from grail_tpu_torch.utils import sample_error_db

    Ns = [_score_num_samples(g.text_to_score(t), 44100.0)
          for t in ("ae", "ea")]
    assert g.route(2, max(Ns), True, cuda, 44100.0)[1:3] == ("kcar", 1)
    n0 = dict(kf.LAUNCHES)
    on_card = g.synthesize_batch(["ae", "ea"], device="cuda",
                                 exact_carrier=True)
    assert kf.LAUNCHES["fused_synth"] == n0["fused_synth"] + 1
    assert kf.LAUNCHES["phase_q32_pre"] == n0["phase_q32_pre"]
    on_cpu = g.synthesize_batch(["ae", "ea"], device="cpu",
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


def test_split_kernel_equals_plain_bitwise(cuda):
    # split lanes: per-lane offsets g0, schedule rows, seam phases, seeds
    S = 4
    tables, _, _, T = _split_setup(cuda, S)
    tables_t, (phi, cell), state, q, g0, _ = papi._split_lanes(
        tables, T, S, "kernel", g.get_voice("generic").jitter_frequency)
    sf, si = kf.state_rows(state, q)
    args = (tables_t, phi, cell, sf, si, T // S + papi.WARMUP, False)
    a, sf_k, si_k = kf.fused_synth_cuda(*args, g0=g0)
    r, sf_r, si_r = kf.synth_fused_reference(*args, g0=g0)
    torch.cuda.synchronize()
    assert torch.equal(si_k, si_r)
    assert torch.equal(sf_k, sf_r)
    assert torch.equal(a, r)


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
    texts = [("aeae" * 4)[:8 + (i % 8)] for i in range(64)]
    b = papi._Batch([g.text_to_score(t) for t in texts], "generic", None)
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
                                     (tuple(("aeae" * 4)[:8 + (i % 8)]
                                            for i in range(64)), 8)],
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


@pytest.mark.parametrize("N", [3, 128])
def test_carry_kernel_equals_plain_bitwise(cuda, N):
    # five ticks, each version carrying its own state and the offsets
    # advancing by a block: audio, sf, si (seed, carrier phase, jitter
    # phase and absolute cell) bit for bit at every tick
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


# ---- the host_track mode (the solo long-form route) and the FP32 probe -----

@pytest.mark.parametrize("S", [1, 4], ids=["unsplit", "split4"])
def test_host_track_kernel_equals_plain_bitwise(cuda, S):
    # the track replaces both carrier accumulators; kernel and plain version
    # read the same track, so audio and carried state agree bit for bit
    tables, (phi, cell), T = _tables(["aeae"], ["generic"], cuda)
    rng = np.random.default_rng(S)
    track = rng.random(T - 11).astype(np.float32)
    if S == 1:
        car = papi._pad_track(track, T, cuda)
        sched, lanes, g0, Tl = (phi, cell), tables, None, T
    else:
        T = _round_up(T, S * 4096)
        lanes, seg, state, q, g0, car = papi._split_lanes(
            tables, T, S, "kernel", g.get_voice("generic").jitter_frequency,
            track)
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
