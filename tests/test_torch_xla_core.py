"""The port's xla and scan cores (synth/synthesize.py, the carrier and jitter
recurrences of synth/seq_scan.py, and the 'xla'/'scan' backends of api.py)
against grail_tpu's on the CPU, where the port runs the recurrences' plain
versions.

Tolerances: the associative scans and _block_core mirror JAX's combination
tree, so they round as jax.lax.associative_scan does but for XLA:CPU's FMA
contraction: max-abs <= 1e-6 and < -100 dB (-120 to -130 dB measured).
The two f32 recurrences are bit-equal. The routes (batch, solo) are held at
< -100 dB per utterance; the port's own invariants (block continuity,
batched against unbatched) at grail_tpu's own bounds (tests/test_stages.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grail_tpu.api as japi
from grail_tpu import languages as jlanguages
from grail_tpu.oracle import oracle_pipeline
from grail_tpu.runtime.stream import _jsched_scan as j_jsched_scan
from grail_tpu.synth import synthesize as js
from grail_tpu.synth.elem import SynthesisElem as JElem
from grail_tpu.voices.preset_generic import SPEC as JSPEC

import grail_tpu_torch as g
import grail_tpu_torch.api as papi
from grail_tpu_torch.synth import kernel_fused as kf
from grail_tpu_torch.synth import synthesize as ps
from grail_tpu_torch.synth.seq_scan import carrier_scan, jsched_scan
from grail_tpu_torch.utils import sample_error_db, spectral_error_db

torch.set_num_threads(2)

SR = 44100.0
TOL_DB = -100.0


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _fields(T, random_ff, seed=0, B=None):
    """test_stages.py's streams: formant frequencies random per sample
    (test_synth_core_matches_oracle) or constant, breath random
    (test_block_state_continuity); [T] fields, or [T, B] with per-lane
    carrier frequencies."""
    rng = np.random.default_rng(seed)
    lead = (T,) if B is None else (T, B)
    ff = (0.02 + 0.05 * rng.random(lead + (8,), np.float32)).astype(
        np.float32) if random_ff else np.full(lead + (8,), 0.05, np.float32)
    freq = np.full(lead, 120.0 / SR, np.float32)
    if B is not None:
        freq = freq * (1.0 + np.arange(B, dtype=np.float32))
    return dict(
        frequency=freq, formant_freq=ff,
        formant_bw=np.full(lead + (8,), 100.0 / SR, np.float32),
        formant_smooth=np.full(lead + (8,), 1600.0 / SR, np.float32),
        formant_breath=rng.random(lead + (8,)).astype(np.float32),
        formant_turb=np.full(lead + (8,), 0.2, np.float32),
        formant_amp=np.full(lead + (8,), 0.125, np.float32))


def _jelem(f):
    return JElem(**{k: jnp.asarray(v) for k, v in f.items()})


def _pelem(f):
    """The port's frames [T, B(, 8)]; unbatched fields ([T] frequency) get
    B = 1."""
    unbatched = f["frequency"].ndim == 1
    return g.SynthesisElem(**{k: torch.from_numpy(np.ascontiguousarray(
        v[:, None] if unbatched else v)) for k, v in f.items()})


def _close(port, ref, max_abs=1e-6):
    port, ref = np.asarray(port, np.float32), np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = float(np.abs(port - ref).max())
    assert err <= max_abs, err
    assert sample_error_db(port.reshape(-1), ref.reshape(-1)) < TOL_DB


# ---------------------------------------------------------------------------
# associative scans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4095, 4096])
@pytest.mark.parametrize("kind", ["affine", "svf"])
def test_associative_scan_matches_jax(kind, n):
    rng = np.random.default_rng(n)
    k = 2 if kind == "affine" else 6
    # contractions, as the filters' operators are
    xs = [(rng.random((n, 3, 8)) * 0.9).astype(np.float32) for _ in range(k)]
    if kind == "affine":
        want = js.affine_scan_cum(*map(jnp.asarray, xs))
        got = ps.affine_scan_cum(*map(torch.from_numpy, xs))
    else:
        xs[:4] = [x * np.float32(0.5) for x in xs[:4]]
        want = js.svf_scan_cum(*map(jnp.asarray, xs))
        got = ps.svf_scan_cum(*map(torch.from_numpy, xs))
    assert len(got) == k
    for a, b in zip(got, want):
        assert a.shape == (n, 3, 8)
        err = float(np.abs(a.numpy() - np.asarray(b)).max())
        assert err <= 1e-6, err


def test_associative_scan_is_inclusive_and_ordered():
    # a non-commutative combine: the scan of (a_k, b_k) maps s0 to s_k
    a = torch.tensor([0.5, 2.0, 0.25, 4.0, 0.5])
    b = torch.tensor([1.0, -1.0, 3.0, 0.0, 2.0])
    s, want = torch.tensor(0.75), []
    for ak, bk in zip(a, b):
        s = ak * s + bk
        want.append(float(s))
    got = ps._affine_scan(a, b, torch.tensor(0.75))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


# ---------------------------------------------------------------------------
# the block core and the scan core
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("random_ff", [True, False],
                         ids=["random-formants", "constant-formants"])
def test_block_core_matches_jax(random_ff):
    f = _fields(4096, random_ff)
    jo, jst = jax.jit(js._block_core)(_jelem(f), js.SynthState.init(()))
    pe = _pelem(f)
    po, pst = ps._block_core(pe, ps.SynthState.init(1, "cpu"))
    _close(po[:, 0].numpy(), jo)
    for a, b in zip(pst[:4], jst[:4]):
        _close(a[0].numpy(), b)
    assert int(pst.seed[0]) == int(jst.seed)
    # synthesize_block of one block is the block core
    bo, _ = ps.synthesize_block(pe)
    assert torch.equal(bo, po)
    jb, _ = jax.jit(js.synthesize_block)(_jelem(f))
    _close(bo[:, 0].numpy(), jb)


def test_block_core_carrier_track_matches_jax():
    f = _fields(4096, True)
    car = (np.arange(4096, dtype=np.float32) * np.float32(0.0027)) % 1
    st = js.SynthState.init(())._replace(phase=jnp.float32(0.3))
    jo, jst = jax.jit(js._block_core)(_jelem(f), st, jnp.asarray(car))
    pst0 = ps.SynthState.init(1, "cpu")._replace(
        phase=torch.tensor([0.3]))
    po, pst = ps._block_core(_pelem(f), pst0,
                             carrier=torch.from_numpy(car[:, None]))
    _close(po[:, 0].numpy(), jo)
    assert float(pst.phase[0]) == float(jst.phase) == np.float32(0.3)


def test_block_state_continuity():
    # one 8192 block == two 4096 halves with the state carried
    f = _fields(8192, False, seed=1)
    pe = _pelem(f)
    full, st_full = ps.synthesize_block(pe, block_size=8192)
    h1, st = ps.synthesize_block(g.SynthesisElem(*(x[:4096] for x in pe)))
    h2, st2 = ps.synthesize_block(g.SynthesisElem(*(x[4096:] for x in pe)),
                                  st)
    np.testing.assert_allclose(torch.cat([h1, h2]).numpy(), full.numpy(),
                               atol=2e-5)
    for a, b in zip(st_full[:4], st2[:4]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)
    assert torch.equal(st_full.seed, st2.seed)
    # and the two-block loop of synthesize_block is the chained halves
    two, _ = ps.synthesize_block(pe)
    assert torch.equal(two, torch.cat([h1, h2]))


def test_batched_core_matches_unbatched():
    f = _fields(4096, True, seed=2, B=3)
    pe = _pelem(f)
    out_b, _ = ps.synthesize_block(pe)
    for b in range(3):
        out_1, _ = ps.synthesize_block(g.SynthesisElem(
            *(x[:, b:b + 1] for x in pe)))
        np.testing.assert_allclose(out_b[:, b].numpy(), out_1[:, 0].numpy(),
                                   atol=2e-5)


def test_synthesize_scan_matches_jax():
    f = _fields(4096, True)
    jo, jst = jax.jit(js.synthesize_scan)(_jelem(f))
    po, pst = ps.synthesize_scan(_pelem(f))
    assert sample_error_db(po[:, 0].numpy(), np.asarray(jo)) < TOL_DB
    assert float(pst.phase[0]) == float(jst.phase)       # f32 recurrence
    assert int(pst.seed[0]) == int(jst.seed)
    # with a carrier track: the returned phase steps past the last sample
    car = (np.arange(4096, dtype=np.float32) * np.float32(0.0031)) % 1
    jo, jst = jax.jit(js.synthesize_scan)(_jelem(f),
                                          carrier=jnp.asarray(car))
    po, pst = ps.synthesize_scan(_pelem(f),
                                 carrier=torch.from_numpy(car[:, None]))
    assert sample_error_db(po[:, 0].numpy(), np.asarray(jo)) < TOL_DB
    assert _bits(pst.phase.numpy())[0] == _bits(np.asarray(jst.phase))


# ---------------------------------------------------------------------------
# the two f32 recurrences (plain versions here; the kernel: test_torch_cuda)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(441, 3), (4096, 2), (7, 1)])
def test_carrier_scan_bit_equal_to_jax(shape):
    rng = np.random.default_rng(shape[0])
    f = (rng.random(shape) * 0.02).astype(np.float32)
    f[:5] = np.float32(0.25)                       # the silent frame's 0.25
    p0 = np.linspace(0.0, 0.999, shape[1]).astype(np.float32)
    jt, jp = js.carrier_scan(jnp.asarray(p0), jnp.asarray(f))
    pt, pp = carrier_scan(torch.from_numpy(p0), torch.from_numpy(f))
    np.testing.assert_array_equal(_bits(pt.numpy()), _bits(np.asarray(jt)))
    np.testing.assert_array_equal(_bits(pp.numpy()), _bits(np.asarray(jp)))
    # the numpy runs and the float32 loop are one function
    lt, lp = kf._f32_carrier_loop(torch.from_numpy(f.T.copy()),
                                  torch.from_numpy(p0))
    assert torch.equal(lt.T, pt) and torch.equal(lp, pp)


@pytest.mark.parametrize("inc,T", [(120.0 / SR * 0.05, 4096),
                                   (0.002, 441), (0.3, 1000)])
def test_jsched_scan_bit_equal_to_jax(inc, T):
    jphi = np.array([0.0, 0.9999, 0.5], np.float32)
    jcell = np.array([0, 7, 123], np.int32)
    phis, cells, (pf, cf) = j_jsched_scan(jnp.asarray(jphi),
                                          jnp.asarray(jcell), inc, T)
    phi, cell, p2, c2 = jsched_scan(torch.from_numpy(jphi),
                                    torch.from_numpy(jcell), inc, T)
    assert phi.shape == cell.shape == (3, T)
    np.testing.assert_array_equal(_bits(phi.numpy().T), _bits(phis))
    np.testing.assert_array_equal(cell.numpy().T, np.asarray(cells))
    np.testing.assert_array_equal(_bits(p2.numpy()), _bits(np.asarray(pf)))
    np.testing.assert_array_equal(c2.numpy(), np.asarray(cf))
    loop = kf._jitter_carry_loop(torch.from_numpy(jphi),
                                 torch.from_numpy(jcell), inc, T)
    for a, b in zip(loop, (phi, cell, p2, c2)):
        assert torch.equal(a, b)


def test_recurrence_wrappers_refuse_what_they_cannot_run():
    f = torch.zeros(4, 2)
    with pytest.raises(ValueError, match="impl"):
        carrier_scan(torch.zeros(2), f, impl="fast")
    with pytest.raises(ValueError, match="CUDA"):
        carrier_scan(torch.zeros(2), f, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        jsched_scan(torch.zeros(2), torch.zeros(2, dtype=torch.int32), 0.1,
                    4, impl="kernel")


# ---------------------------------------------------------------------------
# the API's xla and scan routes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gold_ae():
    return oracle_pipeline("ae", JSPEC, jlanguages.generic())


@pytest.fixture(scope="module")
def scan_ae():
    return g.synthesize("ae", device="cpu", backend="scan").numpy()


@pytest.mark.parametrize("kw", [dict(use_scan=True), dict(backend="scan"),
                                dict(backend="xla")],
                         ids=["use_scan", "scan", "xla"])
def test_synthesize_ae_matches_jax(kw, scan_ae):
    got = (scan_ae if kw.get("backend") == "scan"
           else g.synthesize("ae", device="cpu", **kw).numpy())
    want = np.asarray(japi.synthesize("ae", **kw))
    assert got.shape == want.shape and got.dtype == np.float32
    assert sample_error_db(got, want) < TOL_DB
    if kw.get("use_scan"):
        np.testing.assert_array_equal(got, scan_ae)   # the same program


def test_scan_matches_oracle(gold_ae, scan_ae):
    # as the JAX suite holds its scan core (tests/test_pipeline.py)
    assert spectral_error_db(scan_ae, gold_ae) < -60
    assert sample_error_db(scan_ae, gold_ae) < -55


def test_synthesize_batch_xla_matches_jax():
    texts = ["ae", "ea", "aa", "ee"]
    got = g.synthesize_batch(texts, device="cpu", backend="xla",
                             seeds=[0, 1, 2, 3])
    want = japi.synthesize_batch(texts, backend="xla", seeds=[0, 1, 2, 3])
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert sample_error_db(a.numpy(), np.asarray(b)) < TOL_DB


@pytest.mark.parametrize("ec", [True, "kernel"])
def test_xla_exact_carrier_matches_jax(ec):
    got = g.synthesize_batch(["ae", "ea"], device="cpu", backend="xla",
                             exact_carrier=ec)
    want = japi.synthesize_batch(["ae", "ea"], backend="xla",
                                 exact_carrier=ec)
    assert g.route(2, 1000, ec, "cpu", SR, "xla")[1] == "kcar"
    for a, b in zip(got, want):
        assert sample_error_db(a.numpy(), np.asarray(b)) < TOL_DB


def test_xla_track_at_b1_matches_jax():
    # one host track handed to both packages (the port's native pre-pass)
    pel = papi.text_to_phoneme_elems("aeae")
    track = papi._carrier_track_for(pel, g.get_voice("generic"), 0)
    assert track is not None
    got = g.synthesize_scores([g.text_to_score("aeae")], device="cpu",
                              backend="xla", carrier_tracks=[track])[0]
    want = japi.synthesize_scores([japi.text_to_score("aeae")],
                                  backend="xla", carrier_tracks=[track])[0]
    assert sample_error_db(got.numpy(), np.asarray(want)) < TOL_DB
    assert g.route(1, 1000, None, "cpu", SR, "xla", track=True)[1] == "track"
    # synthesize(exact_carrier=True) reads the same track
    solo = g.synthesize("aeae", device="cpu", backend="xla",
                        exact_carrier=True)
    assert torch.equal(solo, got)


def test_pad_samples_to_and_sample_rate():
    psc, jsc = g.text_to_score("ae"), japi.text_to_score("ae")
    got = g.synthesize_score(psc, "generic", pad_samples_to=70000,
                             device="cpu")
    want = japi.synthesize_score(jsc, "generic", pad_samples_to=70000)
    assert got.shape == want.shape
    assert sample_error_db(got.numpy(), np.asarray(want)) < TOL_DB
    with pytest.raises(ValueError, match="pad_samples_to"):
        g.synthesize_score(psc, "generic", pad_samples_to=100, device="cpu")
    # a sample rate other than the voice's takes xla when no backend is named
    got = g.synthesize_score(psc, "generic", sample_rate=22050, device="cpu")
    want = japi.synthesize_score(jsc, "generic", sample_rate=22050)
    assert got.shape == want.shape
    assert sample_error_db(got.numpy(), np.asarray(want)) < TOL_DB
    for be in ("fused", "core"):
        with pytest.raises(ValueError, match="sample_rate"):
            g.synthesize_score(psc, "generic", sample_rate=22050,
                               device="cpu", backend=be)
        with pytest.raises(ValueError, match="pad_samples_to"):
            g.synthesize_score(psc, "generic", pad_samples_to=70000,
                               device="cpu", backend=be)


def test_route_xla_and_scan():
    long_n = int(31 * SR)
    assert g.default_backend() == "fused"
    for be in ("xla", "scan"):
        assert g.route(64, 1000, None, "cpu", SR, be) == ("plain", (
            "kcar" if be == "scan" else "q32"), 1, 4096)
        assert g.route(1, long_n, None, "cpu", SR, be) == (
            "plain", "kcar", 1, 334 * 4096)
    assert g.route(1, 1000, False, "cpu", SR, "scan")[1] == "kcar"
    assert g.route(1, 1000, False, "cpu", SR, "xla")[1] == "q32"
    assert g.route(2, 1000, None, "cpu", SR, "xla", track=True)[1] == "q32"
    with pytest.raises(ValueError, match="split"):
        papi._synthesize_split([g.text_to_score("ae")], S=2, device="cpu",
                               backend="xla")
