"""The CUDA kernel against its plain PyTorch version, on the card.

These tests need an NVIDIA GPU and nvcc and skip elsewhere. They import
neither jax nor grail_tpu, so they run on a machine without JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import grail_tpu_torch as g
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
    from grail_tpu_torch.utils import sample_error_db

    n0 = kf.LAUNCHES["fused_synth"]
    on_card = g.synthesize_batch(["ae", "ea"], device="cuda")
    assert kf.LAUNCHES["fused_synth"] == n0 + 1
    on_cpu = g.synthesize_batch(["ae", "ea"], device="cpu")
    for a, b in zip(on_card, on_cpu):
        assert a.device.type == "cuda" and a.shape == b.shape
        assert sample_error_db(a.cpu().numpy(), b.numpy()) < -100
