"""Phoneme inventory.

The reference generates its `Phoneme` enum + `VoiceStorage` struct with a
macro (grail-rs src/lib.rs:623-689) and currently only instantiates
A and E (marked TODO! there). The target configs require a *full*
inventory including noise-excited fricatives and plosives, so we define a
reduced-IPA set here. The three special marker phonemes keep the reference's
exact semantics (src/lib.rs:633-648):

  SILENCE  - fade in/out surrounding phonemes
  STOP     - glottal stop; behaves like silence but marks plosive closure
  GLIDE    - blend marker for diphthongs

Sound phonemes are an ordered registry; a Voice supplies one SynthesisElem
per sound phoneme (packed as a [P, ...] parameter table on device).
"""

from __future__ import annotations

from enum import IntEnum
from typing import Tuple

# --- special (non-sound) phonemes, indices 0..2 like the reference enum order
_SPECIALS = ["SILENCE", "STOP", "GLIDE"]

# --- sound phonemes: reduced IPA subset.
# Vowels first (reference ships A and E; we keep them at the front so the
# minimal generic voice stays table-compatible), then nasals/liquids/glides,
# then fricatives (breath/turbulence-excited) and plosive releases
# (used after a STOP marker).
_SOUNDS = [
    # vowels
    "A",    # as in f_a_ther
    "E",    # as in b_e_d
    "I",    # as in mach_i_ne
    "O",    # as in th_o_ught
    "U",    # as in b_oo_t
    "AE",   # as in c_a_t
    "AH",   # as in b_u_t (schwa-ish)
    "IH",   # as in b_i_t
    "EH",   # as in b_ai_t
    "UH",   # as in b_oo_k
    "OW",   # as in b_oa_t
    # nasals / liquids / semivowels
    "M", "N", "NG",
    "L", "R", "W", "Y",
    # voiced fricatives
    "V", "Z", "ZH", "DH",
    # voiceless fricatives (fully breath-excited)
    "F", "S", "SH", "TH", "H",
    # plosive releases (short bursts; preceded by STOP for closure)
    "P", "B", "T", "D", "K", "G",
]

_ALL = _SPECIALS + _SOUNDS

Phoneme = IntEnum("Phoneme", {name: i for i, name in enumerate(_ALL)})

NUM_SPECIALS: int = len(_SPECIALS)
NUM_SOUND_PHONEMES: int = len(_SOUNDS)
NUM_PHONEMES: int = len(_ALL)

SOUND_PHONEMES: Tuple[Phoneme, ...] = tuple(Phoneme(i + NUM_SPECIALS) for i in range(NUM_SOUND_PHONEMES))


def is_sound(p: "Phoneme | int") -> bool:
    """True for phonemes that have an associated SynthesisElem.

    Mirrors VoiceStorage::get returning None for Silence/Stop/Glide
    (reference src/lib.rs:664-671).
    """
    return int(p) >= NUM_SPECIALS


def sound_index(p: "Phoneme | int") -> int:
    """Index of a sound phoneme into a voice's packed parameter table."""
    i = int(p) - NUM_SPECIALS
    if i < 0:
        raise ValueError(f"{Phoneme(int(p)).name} is a special phoneme with no sound")
    return i


__all__ = [
    "Phoneme",
    "NUM_SPECIALS",
    "NUM_SOUND_PHONEMES",
    "NUM_PHONEMES",
    "SOUND_PHONEMES",
    "is_sound",
    "sound_index",
]
