"""Error metrics (copies of grail_tpu/utils.py's): the fidelity measures
the port is held to."""

from __future__ import annotations

import numpy as np


def stft_mag(x: np.ndarray, n_fft: int = 1024, hop: int = 256) -> np.ndarray:
    """Magnitude STFT with a Hann window (host-side, for metrics only)."""
    x = np.asarray(x, np.float64)
    if len(x) < n_fft:
        x = np.pad(x, (0, n_fft - len(x)))
    win = np.hanning(n_fft)
    n_frames = 1 + (len(x) - n_fft) // hop
    frames = np.stack([x[i * hop: i * hop + n_fft] * win for i in range(n_frames)])
    return np.abs(np.fft.rfft(frames, axis=-1))


def spectral_error_db(test: np.ndarray, ref: np.ndarray,
                      n_fft: int = 1024, hop: int = 256) -> float:
    """10*log10( sum(| |A|-|B| |^2) / sum(|B|^2) ) over STFT magnitudes.
    Target: < -60 dB vs the reference oracle."""
    n = min(len(test), len(ref))
    A = stft_mag(np.asarray(test)[:n], n_fft, hop)
    B = stft_mag(np.asarray(ref)[:n], n_fft, hop)
    num = np.sum((A - B) ** 2)
    den = np.sum(B ** 2)
    if den == 0:
        return -np.inf if num == 0 else np.inf
    return float(10.0 * np.log10(num / den + 1e-300))


def sample_error_db(test: np.ndarray, ref: np.ndarray) -> float:
    """10*log10( sum((a-b)^2) / sum(b^2) ) in the time domain."""
    n = min(len(test), len(ref))
    a = np.asarray(test, np.float64)[:n]
    b = np.asarray(ref, np.float64)[:n]
    den = np.sum(b ** 2)
    num = np.sum((a - b) ** 2)
    if den == 0:
        return -np.inf if num == 0 else np.inf
    return float(10.0 * np.log10(num / den + 1e-300))


__all__ = ["stft_mag", "spectral_error_db", "sample_error_db"]
