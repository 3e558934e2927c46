"""The plain fused synthesizer of the port against the JAX package's fused
Pallas kernel (interpret mode, as the JAX suite runs it on the CPU), from the
same numpy inputs carried across with grail_tpu_torch.convert.

Tolerances: audio sample_error_db < -100 per utterance and max-abs <= 1e-5
(the same algorithm in the same precision). The Lehmer seed and the Q32
phase agree bit for bit. The exact f32 carrier phase agrees to a few ulps
only: XLA:CPU contracts a*b+c into FMAs inside the interpreted kernel (the
port never does), so the frequency stream differs in its last bit here and
there and the f32 recurrence carries that on; the recurrence itself is held
bit-exact in test_torch_core.py, and the CUDA kernel against this plain
version bit for bit in test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from grail_tpu.api import (_round_up, _score_num_samples, synthesize_scores,
                           text_to_score)
from grail_tpu.synth.jitter import JitterLattice, build_lattice
from grail_tpu.synth.kernel_fused import build_tables, synth_fused_pallas
from grail_tpu.synth.schedule import device_window
from grail_tpu.synth.score import Score, stack_scores
from grail_tpu.synth.synthesize import SynthState
from grail_tpu.voices import get_voice

import grail_tpu_torch.api as papi
from grail_tpu_torch import convert
from grail_tpu_torch.synth import kernel_fused as pk
from grail_tpu_torch.synth.synthesize import SynthState as PState
from grail_tpu_torch.utils import sample_error_db

torch.set_num_threads(2)


def _setup(texts, voices, seeds):
    """JAX inputs for a batch, and the port's, from the same numpy leaves."""
    vs = [get_voice(v) for v in voices]
    sr = float(vs[0].sample_rate)
    E = max(text_to_score(t, v).num_elems for t, v in zip(texts, vs))
    scores = [text_to_score(t, v, pad_to=E) for t, v in zip(texts, vs)]
    Ns = [_score_num_samples(s, sr) for s in scores]
    T = _round_up(max(Ns), 4096)
    inc = vs[0].jitter_frequency
    lat = JitterLattice(*(np.stack(f) for f in zip(
        *(build_lattice(sd, T, inc) for sd in seeds))))
    multi = len(set(voices)) > 1
    deltas = [[v.jitter_delta_frequency for v in vs],
              [v.jitter_delta_formant_frequency for v in vs],
              [v.jitter_delta_amplitude for v in vs]]
    jp = (jnp.float32(inc),) + tuple(
        jnp.asarray(d, jnp.float32) if multi else jnp.float32(d[0])
        for d in deltas)
    batched = stack_scores(scores)
    phi, cell = device_window(inc, 0, T)
    jtables = build_tables(batched, lat, jp, jnp.float32(sr))

    pscore = convert.score_from_numpy(
        [np.asarray(f) for f in batched.elem], batched.has_sound,
        batched.length, batched.blend_length, batched.cum_length)
    ptables = pk.build_tables(pscore, convert.lattice_from_numpy(*lat),
                              tuple(np.asarray(x) for x in jp), sr)
    psched = convert.schedule_from_numpy(np.asarray(phi), np.asarray(cell))
    return dict(jtables=jtables, jsched=(phi[:, None], cell[:, None]),
                ptables=ptables, psched=psched, T=T, Ns=Ns)


@pytest.fixture(scope="module")
def ae_ea():
    return _setup(["ae", "ea"], ["generic", "generic"], [0, 1])


def _run_both(s, kcar, state=None):
    jstate = pstate = None
    if state is not None:
        jstate = SynthState(*(jnp.asarray(x) for x in state))
        pstate = PState(*(torch.from_numpy(np.asarray(x)) for x in state))
        pstate = pstate._replace(seed=pstate.seed.to(torch.int64))
    ja, jst, _ = synth_fused_pallas(s["jtables"], s["T"], state=jstate,
                                    sched=s["jsched"], exact_carrier=kcar,
                                    interpret=True)
    pa, pst = pk.synth_fused(s["ptables"], s["T"], "plain", state=pstate,
                             sched=s["psched"], exact_carrier=kcar)
    return np.asarray(ja).T, jst, pa.numpy(), pst


def _assert_close(s, ja, pa):
    assert pa.shape == ja.shape
    for b, n in enumerate(s["Ns"]):
        assert sample_error_db(pa[b, :n], ja[b, :n]) < -100, b
    assert np.abs(pa - ja).max() <= 1e-5


def test_tables_match_jax_layout(ae_ea):
    jt, pt = ae_ea["jtables"], ae_ea["ptables"]
    np.testing.assert_array_equal(pt.n.numpy(), np.asarray(jt.n).T)
    scal = np.moveaxis(np.asarray(jt.scal), -1, 0)            # [B, E, 8]
    np.testing.assert_array_equal(pt.scal.numpy(), scal[..., :4])
    vec = np.moveaxis(np.asarray(jt.vec), -1, 0)              # [B, E, 48]
    np.testing.assert_array_equal(pt.vec.numpy().reshape(vec.shape), vec)
    np.testing.assert_array_equal(pt.latp.numpy(), np.asarray(jt.latp).T)
    for p, j in ((pt.latf, jt.latf), (pt.lata, jt.lata)):
        np.testing.assert_array_equal(p.numpy(),
                                      np.moveaxis(np.asarray(j), -1, 0))
    par = np.asarray(jt.par).T                                # [B, 8]
    np.testing.assert_array_equal(pt.par.numpy(), par[:, [1, 2, 3, 4]])


@pytest.mark.parametrize("kcar", [False, True], ids=["q32", "kcar"])
def test_plain_matches_jax_kernel(ae_ea, kcar):
    ja, jst, pa, pst = _run_both(ae_ea, kcar)
    _assert_close(ae_ea, ja, pa)
    np.testing.assert_array_equal(pst.seed.numpy(),
                                  np.asarray(jst.seed).astype(np.int64))
    jph = np.asarray(jst.phase).view(np.int32)
    pph = pst.phase.numpy().view(np.int32)
    if kcar:
        assert np.abs(pph.astype(np.int64) - jph).max() <= 16
    else:
        np.testing.assert_array_equal(pph, jph)
    for k in ("filter_state_a", "filter_state_b", "filter_state_c"):
        np.testing.assert_allclose(getattr(pst, k).numpy(),
                                   np.asarray(getattr(jst, k)), atol=1e-6)


def test_plain_matches_jax_kernel_from_state(ae_ea):
    # a carried-in state: exact carrier from phase 0.25, Lehmer seed 12345,
    # nonzero filter memories
    rng = np.random.default_rng(2)
    f = lambda: (rng.standard_normal((2, 8)) * 1e-3).astype(np.float32)
    state = (np.asarray([0.25, 0.75], np.float32), f(), f(), f(),
             np.asarray([12345, 2 ** 32 - 5], np.uint32))
    ja, jst, pa, pst = _run_both(ae_ea, True, state)
    _assert_close(ae_ea, ja, pa)
    np.testing.assert_array_equal(pst.seed.numpy(),
                                  np.asarray(jst.seed).astype(np.int64))


def test_plain_matches_jax_kernel_multivoice():
    # per-lane jitter deltas (two voices in one batch)
    s = _setup(["aeae", "aeae"], ["plain", "bright"], [1, 1])
    ja, jst, pa, pst = _run_both(s, False)
    _assert_close(s, ja, pa)
    np.testing.assert_array_equal(pst.phase.numpy().view(np.int32),
                                  np.asarray(jst.phase).view(np.int32))
    assert sample_error_db(pa[0], pa[1]) > -20     # the voices differ


def test_interior_zero_span_matches_xla():
    # an interior zero-length element: the JAX fused kernel's row basis
    # cannot take it (its API routes to the XLA path); the port's per-sample
    # gathers can, and must match that XLA path
    s = text_to_score("aea")
    lengths = np.asarray(s.length).copy()
    lengths[1] = 0.0
    z = Score.build(elem=s.elem, has_sound=s.has_sound,
                    length=jnp.asarray(lengths), blend_length=s.blend_length)
    ref = synthesize_scores([z], backend="xla")[0]
    pz = convert.score_from_numpy([np.asarray(f) for f in z.elem],
                                  z.has_sound, z.length, z.blend_length,
                                  z.cum_length)
    out = papi.synthesize_scores([pz], device="cpu")[0].numpy()
    assert out.shape == ref.shape
    assert sample_error_db(out, ref) < -60
    assert np.abs(out - ref).max() < 5e-4


def test_dispatch_by_device(ae_ea):
    t = ae_ea["ptables"]
    sf = torch.zeros(2, 24)
    si = torch.zeros(2, 3, dtype=torch.int32)
    phi, cell = ae_ea["psched"]
    # the route picks the implementation from the device; the kernel's
    # wrapper takes CUDA tensors only and never falls back to the plain one
    assert papi.route(2, 256, False, "cpu", 44100.0)[0] == "plain"
    with pytest.raises(ValueError, match="CUDA"):
        pk.fused_synth_cuda(t, phi, cell, sf, si, 128, False)
    with pytest.raises(ValueError, match="CUDA"):
        pk.synth_fused(t, 256, "kernel", sched=(phi[:256], cell[:256]))
    with pytest.raises(ValueError, match="impl"):
        pk.synth_fused(t, 256, "cpu", sched=(phi[:256], cell[:256]))
    a, _ = pk.synth_fused(t, 256, "plain", sched=(phi[:256], cell[:256]))
    r = pk.synth_fused_reference(t, phi[:256], cell[:256], sf, si, 256,
                                 False)
    assert torch.equal(a, r[0])


def test_build_tables_rejects_decreasing_boundaries():
    s = text_to_score("aea")
    lengths = np.asarray(s.length, np.float32).copy()
    lengths[2] = -0.2
    bad = convert.score_from_numpy(
        [np.asarray(f)[None] for f in s.elem], np.asarray(s.has_sound)[None],
        lengths[None], np.asarray(s.blend_length)[None],
        np.cumsum(lengths)[None].astype(np.float32))
    lat = convert.lattice_from_numpy(*(np.asarray(f)[None] for f in
                                       build_lattice(0, 4096, 0.0004)))
    with pytest.raises(ValueError, match="non-decreasing"):
        pk.build_tables(bad, lat, (0.0004, 0.0, 0.0, 0.0), 44100.0)


def test_kernel1_ab_stamps_the_checkout_kernel(tmp_path):
    # benchmarks/kernel1_ab.py's `phases` patches clock64() stamps into a
    # copy of fused_synth.cu at fixed anchors: each must stand exactly once
    # in the checkout's source, or the stage split silently measures nothing
    from pathlib import Path

    from grail_tpu_torch.benchmarks import kernel1_ab as ab

    src = (Path(pk.__file__).parent / "csrc" / "fused_synth.cu").read_text()
    text, names = ab._stamped(src)
    assert names == ab._PIPELINE_NAMES
    assert text.count("clock64()") >= 8 and "grail_phases_read" in text
    with pytest.raises(ValueError, match="anchors"):
        ab._stamped(src.replace("bar_sync(BAR_FULL", "bar_sync(BAR_X"))
    # no card here: the script refuses before it builds anything
    assert ab.main(["turns", str(tmp_path / "old.cu")]) == 1
    assert ab.main(["nosuch", "x"]) == 2
