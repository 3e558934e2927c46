"""Lehmer LCG random numbers, reproduced bit-exactly and in closed form.

The reference generator (grail-rs src/lib.rs:36-55) is the affine
recurrence on u32:

    state' = state * 16807 + 1        (mod 2^32)

and converts a state to a float in [-1, 1] with the IEEE-754 mantissa trick:

    bits = (state >> 9) | 0x3F800000   ->  float in [1, 2)
    value = (float - 1.5) * 2.0

The k-th state has the closed form state_k(seed) = A^k * seed + S_k
(mod 2^32) with S_k = sum_{i<k} A^i, so a whole block of samples draws its
noise in parallel. The numpy half of this module is a copy of
grail_tpu/core/rng.py; the tensor half holds states as int64 in [0, 2^32)
(torch has little uint32 arithmetic) and forms every 32x32-bit product from
16-bit limbs, so no int64 product overflows.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .constants import LEHMER_A

_U32 = np.uint32
_MASK = np.uint64(0xFFFFFFFF)
MASK32 = 0xFFFFFFFF

# cache: length -> (powA, S) uint32 arrays of that length
_affine_cache: dict = {}


def lehmer_affine(n: int):
    """Return (powA, S): uint32 arrays of length n+1 with

        powA[k] = A^k mod 2^32,   S[k] = sum_{i<k} A^i mod 2^32

    so that the state after k steps from `seed` is powA[k]*seed + S[k].
    Built with log2(n) doubling steps: S_{m+k} = A^k * S_m + S_k.
    """
    n = int(n)
    for cap in sorted(_affine_cache):
        if cap >= n:
            powA, S = _affine_cache[cap]
            return powA[: n + 1], S[: n + 1]

    powA = np.array([1, LEHMER_A], dtype=np.uint64)
    S = np.array([0, 1], dtype=np.uint64)
    while len(powA) < n + 1:
        m = len(powA)
        # extend indices [m, 2m-2]: composing j steps after (m-1) steps gives
        #   A^(m-1+j) = A^(m-1) * A^j   and   S_(m-1+j) = A^j * S_(m-1) + S_j
        new_powA = (powA[m - 1] * powA[1:m]) & _MASK
        new_S = (powA[1:m] * S[m - 1] + S[1:m]) & _MASK
        powA = np.concatenate([powA, new_powA])
        S = np.concatenate([S, new_S])
    powA32 = powA[: n + 1].astype(_U32)
    S32 = S[: n + 1].astype(_U32)
    if n <= (1 << 22):  # don't cache unboundedly large tables
        _affine_cache[n] = (powA32, S32)
    return powA32, S32


def lehmer_states(seed, n: int) -> np.ndarray:
    """uint32 states after 1..n steps from `seed` (vectorized, host-side)."""
    powA, S = lehmer_affine(n)
    seed = np.uint64(int(seed) & 0xFFFFFFFF)
    states = (powA[1:].astype(np.uint64) * seed + S[1:].astype(np.uint64)) & _MASK
    return states.astype(_U32)


def np_random_f32_from_state(states: np.ndarray) -> np.ndarray:
    """Convert uint32 Lehmer states to floats in [-1, 1] (bit-exact)."""
    bits = ((states.astype(_U32) >> _U32(9)) | _U32(0x3F800000)).view(np.float32)
    return ((bits - np.float32(1.5)) * np.float32(2.0)).astype(np.float32)


def np_lehmer_draws(seed, n: int) -> np.ndarray:
    """The first n float draws of the reference RNG from `seed`."""
    return np_random_f32_from_state(lehmer_states(seed, n))


class NpLehmer:
    """Stateful sequential reference RNG (the streaming lattice's heads)."""

    def __init__(self, seed: int = 0):
        self.state = int(seed) & 0xFFFFFFFF

    def next_f32(self) -> np.float32:
        self.state = (self.state * LEHMER_A + 1) & 0xFFFFFFFF
        bits = np.uint32((self.state >> 9) | 0x3F800000)
        f = bits.view(np.float32)
        return np.float32((f - np.float32(1.5)) * np.float32(2.0))


def lehmer_chunk_tables(chunk: int) -> np.ndarray:
    """uint32 [2, chunk] relative skip tables: row 0 is A^(k+1), row 1 is
    S_(k+1), so sample k of a chunk whose previous state is `seed` has state
    A^(k+1)*seed + S_(k+1). The fused kernel carries `seed` from chunk to
    chunk (it is the chunk's last state)."""
    powA, S = lehmer_affine(chunk)
    return np.stack([powA[1:], S[1:]])


def lehmer_skip(p: int):
    """(A^p mod 2^32, S_p mod 2^32) for one skip distance p >= 0, as host
    ints by affine exponentiation in O(log p) steps: the state p steps after
    `seed` is A^p * seed + S_p. The split path seeds its segments with it."""
    a, b = LEHMER_A, 1          # one step: x -> A*x + 1
    ra, rb = 1, 0               # identity
    p = int(p)
    if p < 0:
        raise ValueError(f"lehmer_skip distance must be >= 0, got {p}")
    while p:
        if p & 1:
            ra, rb = (a * ra) & MASK32, (a * rb + b) & MASK32
        a, b = (a * a) & MASK32, (a * b + b) & MASK32
        p >>= 1
    return ra, rb


# ---------------------------------------------------------------------------
# Tensor variants (int64 holding uint32 values)
# ---------------------------------------------------------------------------

def mul32(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(a * s) mod 2^32 for int64 tensors holding uint32 values, from 16-bit
    limbs of `s`: a*s_lo < 2^48 and a*s_hi < 2^48, so nothing overflows."""
    lo = s & 0xFFFF
    hi = s >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK32


def random_f32_from_state(states: torch.Tensor) -> torch.Tensor:
    """int64 uint32-valued Lehmer states -> float32 in [-1, 1] (bit-exact
    with np_random_f32_from_state)."""
    bits = ((states >> 9) | 0x3F800000).to(torch.int32)
    return (bits.view(torch.float32) - 1.5) * 2.0


@functools.lru_cache(maxsize=16)
def _block_tables(n: int, device: str):
    """The (A^k, S_k), k = 1..n, tables of lehmer_block_states on `device`,
    memoized: a block loop uploads them once, not once per block (an upload
    from pageable memory waits for the device)."""
    powA, S = lehmer_affine(n)
    return (torch.from_numpy(powA[1:].astype(np.int64)).to(device),
            torch.from_numpy(S[1:].astype(np.int64)).to(device))


def lehmer_block_states(seed: torch.Tensor, n: int) -> torch.Tensor:
    """[..., n] int64 states after 1..n steps from int64 `seed` [...]."""
    pa, s = _block_tables(int(n), str(seed.device))
    return (mul32(pa, seed[..., None]) + s) & MASK32


__all__ = [
    "lehmer_affine", "lehmer_states", "np_random_f32_from_state",
    "np_lehmer_draws", "NpLehmer", "lehmer_chunk_tables", "lehmer_skip",
    "mul32",
    "random_f32_from_state", "lehmer_block_states",
]
