"""dp x sp sharding (grail_tpu_torch/parallel/) against grail_tpu's
parallel/sharded.py on the CPU, at tests/test_parallel.py's sizes (T =
8192, B = 8 and 4). The port's ranks are spawned processes on a gloo group
(parallel/_ranks.py: one spawn per mesh shape runs every case of that
shape, and a module fixture holds the results); grail_tpu runs under
shard_map on the 8 virtual devices of conftest.py, at the same mesh shape.

Tolerances:
  * sp against grail_tpu's sp: the same arithmetic in the same order and
    the same rounding tree (associative_scan), so < -110 dB, XLA:CPU's FMA
    contraction leaving ulps; seeds and phases bit-equal (integer math);
    filter states atol 1e-5, as test_parallel.py holds them;
  * sp against the port's single-process synthesize_block, the state
    continuation and sharded_pipeline against either reference:
    test_parallel.py's bounds (< -100 dB; seed bit-equal, phase atol
    1e-6);
  * dp against the (1, 1) mesh: bit-equal (no collective, the same
    per-lane arithmetic).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grail_tpu.api import _round_up, _score_num_samples, text_to_score
from grail_tpu.parallel.sharded import make_mesh as jmake_mesh
from grail_tpu.parallel.sharded import sharded_pipeline as jpipeline
from grail_tpu.parallel.sharded import synthesize_block_sp as jblock_sp
from grail_tpu.synth.elem import SynthesisElem as JElem
from grail_tpu.synth.jitter import JitterLattice, build_lattice
from grail_tpu.synth.score import stack_scores
from grail_tpu.voices import get_voice

from grail_tpu_torch import convert
from grail_tpu_torch.api import _CoreLanes, _core_unsplit_setup, _xla_run
from grail_tpu_torch.parallel import _ranks, make_mesh
from grail_tpu_torch.synth.elem import SynthesisElem
from grail_tpu_torch.synth.jitter import lattice_to
from grail_tpu_torch.synth.synthesize import synthesize_block
from grail_tpu_torch.utils import sample_error_db

torch.set_num_threads(2)

T, B = 8192, 8
SP_MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]
# every spawn and its cases (parallel/_ranks.cpu_cases)
SPAWNS = {(1, 1): ("pipe",), (2, 1): ("sp", "pipe"), (4, 1): ("pipe",),
          (1, 2): ("sp", "bad"), (2, 2): ("sp", "cont", "pipe"),
          (1, 4): ("sp",)}
SPAWN_TIMEOUT = 120.0


def _fields(T, B, seed):
    """tests/test_parallel.py's _elems, as numpy [T, B(, 8)] fields in
    SynthesisElem order."""
    rng = np.random.default_rng(seed)
    return [np.full((T, B), 0.003, np.float32),
            (0.02 + 0.05 * rng.random((T, B, 8))).astype(np.float32),
            np.full((T, B, 8), 0.002, np.float32),
            np.full((T, B, 8), 0.036, np.float32),
            np.full((T, B, 8), 0.3, np.float32),
            np.full((T, B, 8), 0.2, np.float32),
            np.full((T, B, 8), 0.125, np.float32)]


def _pipe_inputs():
    """tests/test_parallel.py's pipeline batch: (grail_tpu's (Score,
    lattices), the port's (Score, lattices), jparams, sample rate, T)."""
    texts = ["ae", "ea", "aa", "ee"]
    voice = get_voice("generic")
    sr = float(voice.sample_rate)
    E = max(text_to_score(t).num_elems for t in texts)
    scores = [text_to_score(t, pad_to=E) for t in texts]
    Tp = _round_up(max(_score_num_samples(s, sr) for s in scores), 8192)
    lat = JitterLattice(*(np.stack(f) for f in zip(
        *[build_lattice(i, Tp, voice.jitter_frequency)
          for i in range(len(texts))])))
    batched = stack_scores(scores)
    jp = (voice.jitter_frequency, voice.jitter_delta_frequency,
          voice.jitter_delta_formant_frequency,
          voice.jitter_delta_amplitude)
    pscore = convert.score_from_numpy(
        [np.asarray(f) for f in batched.elem], batched.has_sound,
        batched.length, batched.blend_length, batched.cum_length)
    plat = convert.lattice_from_numpy(*(np.asarray(f) for f in lat))
    return (batched, lat), (pscore, plat), jp, sr, Tp


def _assemble(results, key, n_data, n_seq):
    """The global [T, B] audio and the [B]-row final state from the ranks'
    shards of case `key`; each 'seq' rank's state must be its row's."""
    outs = {r["coord"]: r[key] for r in results}
    audio = torch.cat([torch.cat([outs[(d, i)][0] for i in range(n_seq)])
                       for d in range(n_data)], dim=1)
    for d in range(n_data):
        for i in range(1, n_seq):
            for a, b in zip(outs[(d, 0)][1], outs[(d, i)][1]):
                assert torch.equal(a, b), (d, i)
    state = [torch.cat([outs[(d, 0)][1][k] for d in range(n_data)])
             for k in range(5)]
    return audio.numpy(), [x.numpy() for x in state]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("ranks"))
    sp, cont = _fields(T, B, 0), _fields(2 * T, 4, 1)
    jpipe, ppipe, jp, sr, Tp = _pipe_inputs()
    torch.save({"sp": sp, "cont": cont, "pipe": (*ppipe, jp, sr, Tp)},
               os.path.join(work, "inputs.pt"))
    res = {}
    for (nd, ns), cases in SPAWNS.items():
        _ranks.spawn(_ranks.cpu_cases, nd * ns,
                     (nd * ns, nd, ns, work, cases), SPAWN_TIMEOUT)
        res[(nd, ns)] = _ranks.load_results(work, f"{nd}x{ns}", nd * ns)
    return {"res": res, "sp": sp, "cont": cont, "jpipe": jpipe,
            "ppipe": ppipe, "jp": jp, "sr": sr, "T": Tp}


def _db(a, b):
    return max(sample_error_db(np.asarray(a)[:, k], np.asarray(b)[:, k])
               for k in range(np.shape(b)[1]))


@pytest.mark.parametrize("n_data,n_seq", SP_MESHES)
def test_sp_matches_grail_tpu(runs, n_data, n_seq):
    audio, st = _assemble(runs["res"][(n_data, n_seq)], "sp", n_data, n_seq)
    mesh = jmake_mesh(n_data, n_seq)
    j_out, j_st = jax.jit(lambda x: jblock_sp(x, mesh))(
        JElem(*(jnp.asarray(f) for f in runs["sp"])))
    assert _db(audio, j_out) < -110
    np.testing.assert_array_equal(st[4], np.asarray(j_st.seed).astype(
        np.int64))
    np.testing.assert_array_equal(st[0], np.asarray(j_st.phase))
    for k in (1, 2, 3):
        np.testing.assert_allclose(st[k], np.asarray(j_st[k]), atol=1e-5)


@pytest.mark.parametrize("n_data,n_seq", SP_MESHES)
def test_sp_matches_single_process(runs, n_data, n_seq):
    audio, st = _assemble(runs["res"][(n_data, n_seq)], "sp", n_data, n_seq)
    ref, ref_st = synthesize_block(SynthesisElem(
        *(torch.from_numpy(f) for f in runs["sp"])), block_size=T)
    assert _db(audio, ref.numpy()) < -100
    np.testing.assert_array_equal(st[4], ref_st.seed.numpy())
    np.testing.assert_allclose(st[0], ref_st.phase.numpy(), atol=1e-6)
    for k in (1, 2, 3):
        np.testing.assert_allclose(st[k], ref_st[k].numpy(), atol=1e-5)


def test_sp_state_continuation(runs):
    """Two sp blocks chained through the returned state against one long
    block (test_parallel.py's test_sp_state_continuation, mesh (2, 2))."""
    parts = {r["coord"]: r["cont"] for r in runs["res"][(2, 2)]}
    got = torch.cat([torch.cat([torch.cat([parts[(d, i)][h]
                                           for i in range(2)])
                                for d in range(2)], dim=1)
                     for h in range(2)])
    full, _ = synthesize_block(SynthesisElem(
        *(torch.from_numpy(f) for f in runs["cont"])), block_size=2 * T)
    assert _db(got.numpy(), full.numpy()) < -100


def test_pipeline_matches_grail_tpu(runs):
    (jscore, jlat), jp, sr, Tp = runs["jpipe"], runs["jp"], runs["sr"], \
        runs["T"]
    mesh = jmake_mesh(2, 2)
    jpf = tuple(jnp.float32(x) for x in jp)
    ref = jax.jit(lambda s, l: jpipeline(s, l, jpf, jnp.float32(sr), Tp,
                                         mesh))(jscore, jlat)
    for r in runs["res"][(2, 2)]:       # every rank returns the global [B, T]
        assert r["pipe"].shape == (4, Tp)
        assert _db(r["pipe"].numpy().T, np.asarray(ref).T) < -100


def test_pipeline_matches_xla_program(runs):
    """Against the port's single-process xla program on the same batch
    (the counterpart of the _synth_jit_batch(..., "xla") reference of
    test_parallel.py)."""
    pscore, plat = runs["ppipe"]
    jp = runs["jp"]
    lanes = _CoreLanes(pscore.to("cpu"), lattice_to(plat, "cpu"),
                       tuple(float(np.float32(x)) for x in jp[1:]))
    ref = _xla_run(_core_unsplit_setup(lanes, runs["T"], runs["sr"], jp[0]),
                   "q32")
    got = runs["res"][(2, 2)][0]["pipe"]
    assert _db(got.numpy().T, ref.numpy().T) < -100


@pytest.mark.parametrize("n_data", [2, 4])
def test_dp_bit_equal(runs, n_data):
    one = runs["res"][(1, 1)][0]["pipe"]
    for r in runs["res"][(n_data, 1)]:
        assert torch.equal(r["pipe"], one)


def test_bad_configurations_raise(runs):
    """T % n_seq != 0 and a mesh that does not fill the world raise
    ValueError on every rank (mesh (1, 2)); so does a mesh with no
    process group."""
    for r in runs["res"][(1, 2)]:
        assert all(msg is not None for msg in r["bad"]), r["bad"]
    with pytest.raises(ValueError):
        make_mesh(1, 1, "cpu")
