"""RIFF/WAV 16-bit PCM writer/reader (the copy of grail_tpu/runtime/wav.py).

Mirrors the reference CLI's hand-rolled writer (examples/cli.rs:28-67):
mono, 16-bit PCM, samples scaled by i16::MAX with plain truncation toward
zero (Rust `as i16` semantics).
"""

from __future__ import annotations

import struct

import numpy as np


def encode_wav(data: np.ndarray, sample_rate: int) -> bytes:
    data = np.asarray(data, np.float32)
    # Rust `(x * i16::MAX as f32) as i16`: truncate toward zero, saturate,
    # NaN -> 0 (float->int casts in numpy are undefined for NaN; Rust's
    # `as` is defined to give 0 — match it here and in the native encoder)
    scaled = np.trunc(data * 32767.0)
    scaled = np.where(np.isnan(scaled), 0.0, scaled)
    pcm = np.clip(scaled, -32768, 32767).astype(np.int16)
    payload = pcm.tobytes()
    header = b"".join([
        b"RIFF",
        struct.pack("<I", 36 + len(payload)),
        b"WAVE",
        b"fmt ",
        struct.pack("<IHHIIHH", 16, 1, 1, int(sample_rate),
                    int(sample_rate) * 2, 2, 16),
        b"data",
        struct.pack("<I", len(payload)),
    ])
    return header + payload


def save_wav(path: str, data: np.ndarray, sample_rate: int) -> None:
    """Write `data` as a WAV through the host library's encoder
    (runtime/native.py, built at first use; the same bytes as encode_wav)."""
    from .native import native_encode_wav

    payload = native_encode_wav(data, sample_rate)
    with open(path, "wb") as f:
        f.write(payload)


def load_wav(path: str):
    """Minimal 16-bit mono PCM reader (for tests/benchmarks)."""
    with open(path, "rb") as f:
        raw = f.read()
    assert raw[:4] == b"RIFF" and raw[8:12] == b"WAVE"
    pos = 12
    sample_rate = None
    data = None
    while pos + 8 <= len(raw):
        cid = raw[pos:pos + 4]
        size = struct.unpack("<I", raw[pos + 4:pos + 8])[0]
        body = raw[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt, ch, sample_rate = struct.unpack("<HHI", body[:8])
            bits = struct.unpack("<H", body[14:16])[0]
            assert fmt == 1 and ch == 1, "only mono PCM supported"
            # without this, an 8/24/32-bit file was silently reinterpreted
            # as int16 (wrong sample count, garbage amplitudes)
            assert bits == 16, f"only 16-bit PCM supported, got {bits}-bit"
        elif cid == b"data":
            data = np.frombuffer(body, np.int16).astype(np.float32) / 32767.0
        pos += 8 + size + (size & 1)
    return data, sample_rate


__all__ = ["encode_wav", "save_wav", "load_wav"]
