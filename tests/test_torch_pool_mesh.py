"""The mesh-sharded StreamPool (StreamPool(mesh=), parallel.
sharded_stream_tick_fn) on the CPU, against the port's unsharded pool and
grail_tpu's sharded pool, at tests/test_parallel.py's sizes: N = 8, block
1,024, voice plain, english, its four texts on sessions 0-3.

The port's ranks are spawned processes on a gloo group
(parallel/_ranks.pool_cpu_cases: one spawn per mesh shape runs every case,
and a module fixture holds the results); (4, 1) is grail_tpu's test shape,
(2, 2) has 'seq' replicating each data row. grail_tpu's pool runs
backend="fused_interpret" under shard_map on the 8 virtual devices of
conftest.py.

Tolerances: against the port's unsharded pool bit for bit (the same
per-lane arithmetic, no FMA contraction in the port); against grail_tpu
its own bounds, atol 2e-6 and < -100 dB per session (XLA:CPU contracts
a*b+c inside the interpreted kernel).
"""

import io
import os

import numpy as np
import pytest
import torch

from grail_tpu.parallel.sharded import make_mesh as jmake_mesh
from grail_tpu.runtime import stream as jstream

from grail_tpu_torch.parallel import _ranks
from grail_tpu_torch.runtime import stream as pstream
from grail_tpu_torch.utils import sample_error_db

torch.set_num_threads(2)

N, BLOCK, TICKS, FEED_TICK = 8, 1024, 3, 3
TEXTS = ["hello", "world", "aeio", "tpu go"]
MESHES = [(4, 1), (2, 2)]
CASES = ("rows", "load", "serve", "bad")
SPAWN_TIMEOUT = 120.0
KW = dict(voice="plain", language="english", block=BLOCK)


def _fed(mod, **kw):
    pool = mod.StreamPool(N, **KW, **kw)
    for i, t in enumerate(TEXTS):
        pool.feed(i, t)
        pool.flush(i)
    return pool


def _ticks(pool, ticks=TICKS):
    return np.concatenate([np.asarray(pool.read_block())
                           for _ in range(ticks)], axis=1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The unsharded port pool's rows (f32, pcm16), its blob after TICKS
    ticks and the TICKS after it; each mesh's rank results."""
    work = str(tmp_path_factory.mktemp("pool_ranks"))
    ref = {}
    for output in ("pcm16", "f32"):         # the f32 pool goes on
        pool = _fed(pstream, device="cpu", output=output)
        ref[output] = _ticks(pool)
    blob = pool.save()
    cont = _ticks(pool)
    torch.save(dict(n=N, block=BLOCK, texts=TEXTS, ticks=TICKS,
                    feed_tick=FEED_TICK, blob=blob),
               os.path.join(work, "pool_inputs.pt"))
    res = {}
    for nd, ns in MESHES:
        _ranks.spawn(_ranks.pool_cpu_cases, nd * ns,
                     (nd * ns, nd, ns, work, CASES), SPAWN_TIMEOUT)
        res[(nd, ns)] = _ranks.load_results(work, f"pool_{nd}x{ns}", nd * ns)
    return dict(ref=ref, blob=blob, cont=cont, res=res)


@pytest.fixture(scope="module")
def jax_rows():
    """grail_tpu's sharded pool on make_mesh(4, 1): TICKS ticks."""
    return _ticks(_fed(jstream, backend="fused_interpret",
                       mesh=jmake_mesh(4, 1)))


def _gathered(results, key):
    """The rows of `key` over the mesh, in session order: seq coordinate 0
    of each data row."""
    by = {r["coord"]: r[key] for r in results}
    n_data = 1 + max(d for d, _ in by)
    return torch.cat([torch.as_tensor(by[(d, 0)])
                      for d in range(n_data)]).numpy()


def _arrays(blob):
    z = np.load(io.BytesIO(blob))
    return {k: z[k] for k in z.files}


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_each_rank_owns_its_data_row(runs, mesh):
    n_data, n_seq = mesh
    k = N // n_data
    rows = {}
    for r in runs["res"][mesh]:
        d, i = r["coord"]
        assert r["local"] == range(d * k, (d + 1) * k)
        assert r["rows_f32"].shape == (k, TICKS * BLOCK)
        rows.setdefault(d, r["rows_f32"])
        assert torch.equal(r["rows_f32"], rows[d]), (d, i)   # 'seq' copies
    assert sorted(rows) == list(range(n_data))


@pytest.mark.parametrize("output", ["f32", "pcm16"])
@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_rows_equal_the_unsharded_pool(runs, mesh, output):
    ref = runs["ref"][output]
    for r in runs["res"][mesh]:
        got = r[f"rows_{output}"].numpy()
        lo, hi = r["local"].start, r["local"].stop
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref[lo:hi])
    assert (np.abs(ref).max(axis=1) > 0).sum() >= 3      # fed ones speak


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_rows_match_grail_tpu_sharded_pool(runs, jax_rows, mesh):
    got = _gathered(runs["res"][mesh], "rows_f32")
    np.testing.assert_allclose(got, jax_rows, atol=2e-6)
    for i in range(N):
        assert sample_error_db(got[i], jax_rows[i]) < -100, i


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_bad_configurations_raise_on_every_rank(runs, mesh):
    """grail_tpu's rules (n divisible by 'data', the fused tick, so no
    'xla' and no block that is not a multiple of 128) and the device's; a
    bad inline command or an unterminated one raises on every rank,
    whichever owns the session, and the other ranks keep no text."""
    n_data, _ = mesh
    for r in runs["res"][mesh]:
        bad = r["bad"]
        assert (bad["n6"] is not None) == (6 % n_data != 0)
        assert None not in (bad["xla"], bad["block441"], bad["device"]), bad
        assert None not in bad["command"] + bad["fragment"], bad
        for i, n_el in enumerate(r["elements"]):
            if i in r["local"]:
                assert (n_el > 0) == (i < len(TEXTS)), i
            else:
                assert n_el == 0, i


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_serve_mode_matches_read_block(runs, mesh):
    """grail_tpu's test_sharded_pool_serve_mode_matches_read_block: served
    ticks bit-equal to a twin's read_block before the feed to session 1,
    and on every other session at every tick."""
    for r in runs["res"][mesh]:
        got, ref = r["serve"]
        others = [j for j, i in enumerate(r["local"]) if i != 1]
        for k, (a, b) in enumerate(zip(got, ref)):
            if k < FEED_TICK:
                assert torch.equal(a, b), k
            assert torch.equal(a[others], b[others]), k


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_save_equals_the_unsharded_blob(runs, mesh):
    want = _arrays(runs["blob"])
    for r in runs["res"][mesh]:
        got = _arrays(r["blob"])
        assert list(got) == list(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_mesh_blob_continues_in_an_unsharded_pool(runs, mesh):
    r0 = runs["res"][mesh][0]
    pool = pstream.StreamPool(N, device="cpu", **KW)
    pool.load(r0["blob"])
    got = _ticks(pool)
    np.testing.assert_array_equal(got, _gathered(runs["res"][mesh], "cont"))
    np.testing.assert_array_equal(got, runs["cont"])


def test_mesh_blob_loads_into_grail_tpu(runs):
    res = runs["res"][(4, 1)]
    jp = jstream.StreamPool(N, backend="fused_interpret", **KW)
    jp.load(res[0]["blob"])
    got = _ticks(jp)
    want = _gathered(res, "cont")
    for i in range(N):
        assert sample_error_db(got[i], want[i]) < -100, i


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_unsharded_blob_loads_into_a_mesh_pool(runs, mesh):
    for r in runs["res"][mesh]:
        lo, hi = r["local"].start, r["local"].stop
        np.testing.assert_array_equal(r["load"].numpy(),
                                      runs["cont"][lo:hi])

