"""The comparison that decides `correct`: the widest gap of an answer.

An answer is the audio of one utterance (or of one session over a span),
as it reached the host. Its gap is the largest absolute difference from
the reference's audio over the same samples, in units of full scale (1.0:
float audio's [-1, 1], 32767 in 16-bit PCM), so a quiet span is held to
the same measure as a loud one; an answer of another length than the
reference's, or with a value that is not finite, has the gap inf.
"""

from __future__ import annotations

import numpy as np


def gap(prog: np.ndarray, ref: np.ndarray) -> float:
    prog = np.asarray(prog, np.float64)
    ref = np.asarray(ref, np.float64)
    if prog.shape != ref.shape or not np.isfinite(prog).all():
        return float("inf")
    return float(np.max(np.abs(prog - ref))) if ref.size else 0.0


def rows(gaps, limits: dict):
    """Check rows (name, value, limit, ok): the worst gap of the sample and
    the count of answers that never came."""
    worst = max(gaps) if gaps else float("inf")
    lim = float(limits["audio_gap"])
    return [("audio_gap", worst, lim, worst <= lim)]
