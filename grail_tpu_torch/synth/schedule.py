"""Exact value-noise phase schedule (reference f32 accumulation).

The reference's three jitter generators step a SHARED phase recurrence once
per sample (grail-rs src/lib.rs:236-249, 287-300):

    phase += increment            # f32, rounds every add
    if phase > 1.0:               # strictly greater
        phase -= 1.0              # exact (Sterbenz), advance the lattice

Because every add rounds, the wrap schedule and the per-sample blend
fraction drift from the closed form floor(k*inc), so the synthesizer
consumes the exact schedule: per-sample `phi` (f32 post-wrap phase) and
`cell` (int32 wrap count = lattice cell index). It depends only on the f32
rate, so every lane of every batch shares one instance per rate.

  * `PhaseSchedule.state_at(k)`       -> (phase, cell) after k steps
  * `PhaseSchedule.window(start, n)`  -> (phi, cell) numpy arrays for samples
    start+1 .. start+n (samples <= 0 report (0.0, 0))
  * `device_window(inc, start, n, device)` -> the same as tensors, memoized
    per device.

A copy of grail_tpu/synth/schedule.py: the simulation runs in the host
library (`_simulate`: runtime/native.native_jitter_schedule, the C++ loop
gn_jitter_phase_schedule); `_np_simulate`, its vectorised numpy twin, stays
as the tests' other side.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

import numpy as np
import torch

from ..runtime.native import native_jitter_schedule
from ..runtime.trace import annotate

_CHK = 1 << 20        # checkpoint cadence (samples)
_SEG = 1 << 16        # longest run _np_simulate accumulates in one call


def _np_simulate(inc: np.float32, phase0: np.float32, T: int,
                 phi: np.ndarray, cell: np.ndarray) -> int:
    """T steps of the reference recurrence from phase0 into phi/cell (cell
    counts wraps since this call's start). Returns the wrap count.

    Between two wraps the recurrence is a plain f32 running sum, and
    np.add.accumulate over float32 rounds each partial sum exactly as the
    sequential `phase = f32(phase + inc)` does — so each run up to the next
    wrap is one vectorized call, bit-identical to the per-sample loop of
    grail_tpu/synth/schedule._np_simulate."""
    inc = np.float32(inc)
    one = np.float32(1.0)
    phase = np.float32(phase0)
    wraps = 0
    k = 0
    while k < T:
        # the steps to the next wrap, +2 for rounding; a short guess only
        # costs another pass
        n = min(T - k, _SEG,
                max(1, int((1.0 - float(phase)) / float(inc)) + 2))
        run = np.empty(n + 1, np.float32)
        run[0] = phase
        run[1:] = inc
        seq = np.add.accumulate(run, dtype=np.float32)[1:]
        over = np.flatnonzero(seq > one)
        if len(over):
            m = int(over[0])
            phi[k:k + m] = seq[:m]
            cell[k:k + m] = wraps
            phase = np.float32(seq[m] - one)
            wraps += 1
            phi[k + m] = phase
            cell[k + m] = wraps
            k += m + 1
        else:
            phi[k:k + n] = seq
            cell[k:k + n] = wraps
            phase = seq[-1]
            k += n
    return wraps


def _simulate(inc: np.float32, phase0: np.float32, T: int,
              phi: np.ndarray, cell: np.ndarray) -> int:
    """T steps of the reference recurrence from phase0 into phi/cell
    (cell counts wraps since this call's start), in the host library;
    bit-equal to _np_simulate. Returns the wrap count."""
    return native_jitter_schedule(inc, phase0, T, phi, cell)


class PhaseSchedule:
    """Checkpointed exact phase schedule for one f32 jitter rate.

    Memory is O(max_position / 2^20) checkpoints; a window re-simulates at
    most 2^20 + length steps. Thread-safe.
    """

    def __init__(self, inc: float):
        self.inc = np.float32(inc)
        assert self.inc > 0, "jitter rate must be positive"
        # checkpoint i = state after i*_CHK steps
        self._ck_phase = [np.float32(0.0)]
        self._ck_cell = [0]
        self._lock = threading.Lock()
        self._scratch_phi = np.empty(_CHK, np.float32)
        self._scratch_cell = np.empty(_CHK, np.int32)

    def _ensure_checkpoints(self, k: int) -> None:
        """Extend checkpoints to cover step k (lock held)."""
        while (len(self._ck_phase) - 1) * _CHK < k:
            w = _simulate(self.inc, self._ck_phase[-1], _CHK,
                          self._scratch_phi, self._scratch_cell)
            self._ck_phase.append(np.float32(self._scratch_phi[-1]))
            self._ck_cell.append(self._ck_cell[-1] + int(w))

    def state_at(self, k: int) -> Tuple[np.float32, int]:
        """(phase, cell) after k steps; k <= 0 is the pre-stream origin."""
        if k <= 0:
            return np.float32(0.0), 0
        k = int(k)
        with self._lock:
            self._ensure_checkpoints(k)
            i = k // _CHK
            rem = k - i * _CHK
            if rem == 0:
                return self._ck_phase[i], self._ck_cell[i]
            w = _simulate(self.inc, self._ck_phase[i], rem,
                          self._scratch_phi, self._scratch_cell)
            return (np.float32(self._scratch_phi[rem - 1]),
                    self._ck_cell[i] + int(w))

    def window(self, start: int, length: int) -> Tuple[np.ndarray, np.ndarray]:
        """Per-sample (phi f32 [length], cell i32 [length]) for absolute
        samples start+1 .. start+length. Samples <= 0 report (0.0, 0)."""
        length = int(length)
        start = int(start)
        phi = np.zeros(length, np.float32)
        cell = np.zeros(length, np.int32)
        lead = max(0, -start)              # samples <= 0 at the head
        n = length - lead
        if n <= 0:
            return phi, cell
        k0 = start + lead                  # == max(start, 0)
        with self._lock:
            self._ensure_checkpoints(k0 + n)
            i = k0 // _CHK
            rem = k0 - i * _CHK
            phase = self._ck_phase[i]
            base_cell = self._ck_cell[i]
            if rem:
                w = _simulate(self.inc, phase, rem,
                              self._scratch_phi, self._scratch_cell)
                phase = np.float32(self._scratch_phi[rem - 1])
                base_cell += int(w)
            _simulate(self.inc, phase, n, phi[lead:], cell[lead:])
        if base_cell:
            cell[lead:] += np.int32(base_cell)
        return phi, cell


_schedules: Dict[float, PhaseSchedule] = {}
_schedules_lock = threading.Lock()


def get_schedule(inc) -> PhaseSchedule:
    key = float(np.float32(inc))
    with _schedules_lock:
        s = _schedules.get(key)
        if s is None:
            s = _schedules[key] = PhaseSchedule(key)
        return s


# Repeat synthesis calls in one shape bucket must not re-upload the
# schedule: key on (rate bits, start, length, device) and hold the tensors.
_device_cache: Dict[Tuple[float, int, int, str], Tuple] = {}
_device_lock = threading.Lock()
_DEVICE_CACHE_MAX = 64


def device_window(inc, start: int, length: int, device):
    """(phi f32 [length], cell int32 [length]) tensors on `device` for
    samples start+1 .. start+length, memoized per device. Tells the span
    open on this thread, if any, whether the memo held them (`hit`)."""
    device = torch.device(device)
    key = (float(np.float32(inc)), int(start), int(length), str(device))
    with _device_lock:
        hit = _device_cache.get(key)
    annotate(hit=hit is not None)
    if hit is not None:
        return hit
    phi, cell = get_schedule(inc).window(start, length)
    out = (torch.from_numpy(phi).to(device), torch.from_numpy(cell).to(device))
    with _device_lock:
        if len(_device_cache) >= _DEVICE_CACHE_MAX:
            _device_cache.clear()
        _device_cache[key] = out
    return out


__all__ = ["PhaseSchedule", "get_schedule", "device_window"]
