from .phonemes import Phoneme, is_sound, sound_index
from .language import Language, TranscriptionRule
from .transcribe import transcribe, transcribe_chars
from .intonate import PhonemeElem, intonate

__all__ = [
    "Phoneme", "is_sound", "sound_index",
    "Language", "TranscriptionRule",
    "transcribe", "transcribe_chars",
    "PhonemeElem", "intonate",
]
