"""frontend_ms.batch: host ms of the two public frontend functions
(api.text_to_phoneme_elems, synth.score.score_from_phoneme_elems) over one
batch's texts, timed apart just before that batch's call; the median over
the window's batches. Layer: host frontend. Moves batch_xrt."""

import statistics


def read(rec):
    ms = [(b - a) * 1e3 for label, a, b in rec.get("spans", ())
          if rec.get("entry") == "batch" and label == "frontend_probe"]
    return (statistics.median(ms), "ms") if ms else None
