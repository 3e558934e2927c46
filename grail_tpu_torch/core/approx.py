"""Fast math approximations — these exact formulas are *part of the sound*.

The reference synthesizer does not use true tan/exp; it uses cheap polynomial
approximations, and the output waveform depends on their exact shape
(grail-rs src/lib.rs:60-82). The functions are elementwise add/mul (and
tan_approx's one division) and keep the JAX package's operation order
(grail_tpu/core/approx.py), so a tensor evaluated here rounds exactly as the
numpy evaluation of the same expression does. The CUDA kernel
(synth/csrc/fused_synth.cu) writes tan_approx_parts and exp_approx out in
C++.
"""

from __future__ import annotations

import numpy as np


def tan_approx(x):
    """Approximation of tan(pi * x), accurate for x in [0, 0.5): the
    Bhaskara-I form N/D (grail-rs src/lib.rs:60-70), with its division. The
    SVF gain g = tan(pi * f) of the round-1 core's coefficient prep
    (synth/synthesize._svf_coeffs). Its denominator differs from
    tan_approx_parts's D by one product reassociation."""
    return ((1.0 - x) * x * (5.0 - 4.0 * (x + 0.5) * (0.5 - x))) / (
        (x + 0.5) * (5.0 - 4.0 * (1.0 - x) * x) * (0.5 - x)
    )


def tan_approx_parts(x):
    """(numerator N, denominator D) with N/D the Bhaskara tan(pi*x)
    approximation: N = q*(5-4p), D = p*(5-4q) with p=(x+0.5)(0.5-x),
    q=(1-x)x. The fused synthesizer composes N and D into a single-division
    SVF coefficient expression."""
    u = 1.0 - x
    v = x + 0.5
    p = v * (0.5 - x)
    q = u * x
    return q * (5.0 - 4.0 * p), p * (5.0 - 4.0 * q)


def exp_approx(x):
    """Approximation of exp(-2*pi*x) ~= (1 - x)^5, accurate for x in [0, 1]
    (the one-pole lowpass coefficient)."""
    o = 1.0 - x
    o2 = o * o
    return o2 * o2 * o


def np_tan_approx(x):
    """tan_approx in numpy float32, the same operation order (the oracle's)."""
    x = np.asarray(x, np.float32)
    half = np.float32(0.5)
    one = np.float32(1.0)
    num = (one - x) * x * (np.float32(5.0) - np.float32(4.0) * (x + half) * (half - x))
    den = (x + half) * (np.float32(5.0) - np.float32(4.0) * (one - x) * x) * (half - x)
    return (num / den).astype(np.float32)


def np_exp_approx(x):
    """exp_approx in numpy float32 (the oracle's)."""
    x = np.asarray(x, np.float32)
    o = (np.float32(1.0) - x).astype(np.float32)
    o2 = (o * o).astype(np.float32)
    return (o2 * o2 * o).astype(np.float32)


__all__ = ["tan_approx", "tan_approx_parts", "exp_approx",
           "np_tan_approx", "np_exp_approx"]
