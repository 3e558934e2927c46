"""Core modules of the port against the JAX package's: Lehmer RNG, the fast
approximations, the jitter schedule and lattices, and the two carriers.
Bit-exact throughout."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from grail_tpu.core import approx as japprox
from grail_tpu.core import rng as jrng
from grail_tpu.synth import jitter as jjitter
from grail_tpu.synth import schedule as jschedule
from grail_tpu.synth.kernel_fused import _lehmer_chunk_tables
from grail_tpu.synth.synthesize import carrier_phase, carrier_scan

from grail_tpu_torch.core import approx as papprox
from grail_tpu_torch.core import rng as prng
from grail_tpu_torch.synth import jitter as pjitter
from grail_tpu_torch.synth import schedule as pschedule
from grail_tpu_torch.synth.kernel_fused import f32_carrier, q32_carrier

torch.set_num_threads(2)

N_POINTS = 1 << 20
INC = 16.0 / 44100.0


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _u32_states(n, seed=0):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    s[:6] = [0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 2, 2 ** 32 - 1]
    return s


@pytest.mark.parametrize("n", [1, 127, 5000])
def test_lehmer_affine_equal(n):
    for a, b in zip(jrng.lehmer_affine(n), prng.lehmer_affine(n)):
        np.testing.assert_array_equal(a, b)


def test_lehmer_chunk_tables_equal():
    j = _lehmer_chunk_tables(128, 1)[:, :, 0]
    np.testing.assert_array_equal(prng.lehmer_chunk_tables(128).view(np.int32),
                                  j)


def test_random_f32_from_state_bit_exact():
    s = _u32_states(N_POINTS)
    want = jrng.np_random_f32_from_state(s)
    got = prng.random_f32_from_state(torch.from_numpy(s.astype(np.int64)))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    via_jax = jax.jit(jrng.random_f32_from_state)(jnp.asarray(s))
    np.testing.assert_array_equal(_bits(np.asarray(via_jax)), _bits(want))


def test_mul32_matches_uint64_product():
    a = _u32_states(N_POINTS, 1).astype(np.uint64)
    s = _u32_states(N_POINTS, 2).astype(np.uint64)
    want = (a * s) & np.uint64(0xFFFFFFFF)
    got = prng.mul32(torch.from_numpy(a.astype(np.int64)),
                     torch.from_numpy(s.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint64), want)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 32 - 1])
def test_lehmer_block_states_equal(seed):
    want = jrng.lehmer_states(seed, 10000)
    got = prng.lehmer_block_states(torch.tensor([seed], dtype=torch.int64),
                                   10000)[0]
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def _points(lo, hi):
    rng = np.random.default_rng(5)
    x = np.concatenate([np.linspace(lo, hi, N_POINTS // 2, endpoint=False),
                        rng.uniform(lo, hi, N_POINTS // 2)]).astype(np.float32)
    return x


def test_tan_approx_parts_bit_exact():
    # the JAX function evaluated on numpy float32 arrays is the reference's
    # op order with no FMA contraction (XLA:CPU contracts a*b+c under jit)
    x = _points(0.0, 0.5)
    jN, jD = japprox.tan_approx_parts(x)
    pN, pD = papprox.tan_approx_parts(torch.from_numpy(x))
    np.testing.assert_array_equal(_bits(pN.numpy()), _bits(jN))
    np.testing.assert_array_equal(_bits(pD.numpy()), _bits(jD))


def test_exp_approx_bit_exact():
    x = _points(0.0, 1.0)
    want = japprox.np_exp_approx(x)
    got = papprox.exp_approx(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    via_jax = jax.jit(japprox.exp_approx)(jnp.asarray(x))
    np.testing.assert_array_equal(_bits(np.asarray(via_jax)), _bits(want))


@pytest.mark.parametrize("inc", [INC, 16.0 / 22050.0, 0.002, 3e-6])
@pytest.mark.parametrize("phase0", [0.0, 0.9995])
def test_np_simulate_equals_sequential_loop(inc, phase0):
    T = 60000
    out = [(np.zeros(T, np.float32), np.zeros(T, np.int32)) for _ in "ab"]
    w0 = jschedule._np_simulate(np.float32(inc), np.float32(phase0), T,
                                *out[0])
    w1 = pschedule._np_simulate(np.float32(inc), np.float32(phase0), T,
                                *out[1])
    assert w0 == w1
    np.testing.assert_array_equal(_bits(out[0][0]), _bits(out[1][0]))
    np.testing.assert_array_equal(out[0][1], out[1][1])


@pytest.mark.parametrize("start,length", [(0, 69632), (-4096, 10000),
                                          ((1 << 20) - 700, 3000)],
                         ids=["head", "preroll", "checkpoint"])
def test_schedule_window_equal(start, length):
    jp, jc = jschedule.get_schedule(INC).window(start, length)
    pp, pc = pschedule.get_schedule(INC).window(start, length)
    np.testing.assert_array_equal(_bits(jp), _bits(pp))
    np.testing.assert_array_equal(jc, pc)
    k = start + length
    js, jcell = jschedule.get_schedule(INC).state_at(k)
    ps, pcell = pschedule.get_schedule(INC).state_at(k)
    assert _bits(np.float32(js)) == _bits(np.float32(ps)) and jcell == pcell


def test_device_window_memoized_per_device():
    a = pschedule.device_window(INC, 0, 4096, "cpu")
    b = pschedule.device_window(INC, 0, 4096, torch.device("cpu"))
    assert a is b
    assert a[0].dtype == torch.float32 and a[1].dtype == torch.int32
    phi, cell = pschedule.get_schedule(INC).window(0, 4096)
    np.testing.assert_array_equal(a[0].numpy(), phi)
    np.testing.assert_array_equal(a[1].numpy(), cell)


@pytest.mark.parametrize("seed,T,inc", [(0, 69632, INC), (5, 4096, INC),
                                        (123, 200000, 16.0 / 22050.0)])
def test_build_lattice_equal(seed, T, inc):
    j = jjitter.build_lattice(seed, T, inc)
    p = pjitter.build_lattice(seed, T, inc)
    for a, b in zip(j, p):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert pjitter.MAX_JITTER_INC == jjitter.MAX_JITTER_INC


def _freq_stream(T=20000, B=3):
    rng = np.random.default_rng(11)
    f = rng.uniform(0.001, 0.01, (T, B)).astype(np.float32)
    f[:50] = 0.25                        # the silent-frame constant
    f[100:140, 1] = 0.5                  # the Nyquist clamp
    return f


def test_q32_carrier_bit_exact():
    f = _freq_stream()
    p0 = np.asarray([0.0, 0.5, 0.999], np.float32)
    jph, jout = carrier_phase(jnp.asarray(f), jnp.asarray(p0))
    q0 = torch.from_numpy((np.mod(p0, 1.0) * np.float32(2.0 ** 32))
                          .astype(np.uint32).astype(np.int64))
    pph, pq = q32_carrier(torch.from_numpy(f.T.copy()), q0)
    np.testing.assert_array_equal(_bits(pph.numpy().T), _bits(np.asarray(jph)))
    pout = (pq.to(torch.float32) * (1.0 / 2 ** 32)).numpy()
    np.testing.assert_array_equal(_bits(pout), _bits(np.asarray(jout)))


def test_f32_carrier_bit_exact():
    f = _freq_stream(T=6000)
    p0 = np.asarray([0.0, 0.5, 0.999], np.float32)
    jtrack, jfinal = carrier_scan(jnp.asarray(p0), jnp.asarray(f))
    ptrack, pfinal = f32_carrier(torch.from_numpy(f.T.copy()),
                                 torch.from_numpy(p0))
    np.testing.assert_array_equal(_bits(ptrack.numpy().T),
                                  _bits(np.asarray(jtrack)))
    np.testing.assert_array_equal(_bits(pfinal.numpy()),
                                  _bits(np.asarray(jfinal)))
