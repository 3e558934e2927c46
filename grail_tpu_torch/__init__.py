"""grail_tpu_torch — the grail_tpu formant synthesizer on PyTorch and CUDA.

The port of the JAX package (grail_tpu/) to one NVIDIA H100: the host
frontend (text, languages, voices, scores, jitter schedule) is numpy, the
device path is PyTorch, and the per-sample synthesis chain runs in one
hand-written CUDA kernel (synth/csrc/fused_synth.cu) with a plain PyTorch
version beside it. Streaming sessions and the StreamPool server
(runtime/stream.py) run the same kernel in its carry mode, one launch per
tick. The command line (cli.py) and the REPL (interactive.py) run on the
card by default; a long solo utterance reads its carrier phase from the
native host pre-pass (oracle/native.py, runtime/native.py).

Numerics: every per-sample parameter lookup is an index gather (the JAX
package's one-hot matmuls existed only because TPU gathers are slow), so no
matrix product, and therefore no TF32, is anywhere on the path. The kernel
is compiled without FMA contraction, so each float32 operation rounds as
the plain version's does.

The package imports torch and numpy only: never jax, never grail_tpu.
"""

__version__ = "0.1.0"

from .api import (route, synthesize, synthesize_batch, synthesize_score,
                  synthesize_scores, text_to_phoneme_elems, text_to_score)
from .core.constants import DEFAULT_SAMPLE_RATE, NUM_FORMANTS
from .languages import get_language, language_names, register_language
from .runtime.stream import StreamPool, StreamSession, ulaw_decode
from .synth.elem import SynthesisElem
from .text.intonate import PhonemeElem, intonate
from .text.language import Language, TranscriptionRule
from .text.phonemes import Phoneme
from .text.transcribe import transcribe, transcribe_chars
from .voices import (PhonemeSpec, Voice, VoiceSpec, get_voice, register_voice,
                     voice_names)

__all__ = [
    "route", "synthesize", "synthesize_batch", "synthesize_score",
    "synthesize_scores", "text_to_phoneme_elems", "text_to_score",
    "DEFAULT_SAMPLE_RATE", "NUM_FORMANTS",
    "SynthesisElem", "Phoneme", "Language", "TranscriptionRule",
    "PhonemeElem", "intonate", "transcribe", "transcribe_chars",
    "Voice", "VoiceSpec", "PhonemeSpec", "get_voice", "register_voice",
    "voice_names", "get_language", "register_language", "language_names",
    "StreamSession", "StreamPool", "ulaw_decode",
]
