"""'english' — a grapheme->phoneme ruleset over the full inventory.

A practical longest-match ruleset (the transcriber picks the longest
matching rule, so digraphs beat single letters automatically). Plosives
emit STOP (closure) + release, matching the reference's phoneme-model note
that plosives need a marker phoneme (src/lib.rs:628-648). Diphthongs use
GLIDE for seamless blending.
"""

from __future__ import annotations

from ..text.language import Language
from ..text.phonemes import Phoneme as P

S = P.SILENCE
STOP = P.STOP
G = P.GLIDE

_RULES = [
    # whitespace / punctuation -> silence
    (" ", [S]), (",", [S]), (".", [S, S]), ("!", [S, S]), ("?", [S, S]),
    ("-", [S]), ("'", []), ("\n", [S, S]), ("\t", [S]),
    # digraphs & common clusters (longest match wins)
    ("ch", [STOP, P.T, P.SH]),
    ("ck", [STOP, P.K]),
    ("sh", [P.SH]),
    ("th", [P.TH]),
    ("ph", [P.F]),
    ("wh", [P.W]),
    ("ng", [P.NG]),
    ("qu", [STOP, P.K, P.W]),
    ("oo", [P.U]),
    ("ee", [P.I]),
    ("ea", [P.I]),
    ("ou", [P.AH, G, P.U]),
    ("ow", [P.AH, G, P.U]),
    ("ai", [P.EH, G, P.IH]),
    ("ay", [P.EH, G, P.IH]),
    ("oi", [P.O, G, P.IH]),
    ("oy", [P.O, G, P.IH]),
    ("oa", [P.OW]),
    ("igh", [P.AH, G, P.IH]),
    ("tion", [P.SH, P.AH, P.N]),
    # prefix closure: the reference automaton has NO backtracking — when a
    # longer rule's candidacy breaks, it falls back to the rule at the OLD
    # window bottom only if that rule's length equals the consumed prefix
    # (src/lib.rs:1152-1155). Every proper prefix of a multi-char rule must
    # therefore itself be a rule, or inputs like "time"/"big"/"patio" get
    # their prefix swallowed into silence (tests/test_transcribe.py pins
    # the dead-end semantics; test_completeness pins these words).
    ("ti", [STOP, P.T, P.IH]),
    ("tio", [STOP, P.T, P.IH, P.O]),
    ("ig", [P.IH, STOP, P.G]),
    ("q", [STOP, P.K]),
    # single letters
    ("a", [P.AE]),
    ("b", [STOP, P.B]),
    ("c", [STOP, P.K]),
    ("d", [STOP, P.D]),
    ("e", [P.EH]),
    ("f", [P.F]),
    ("g", [STOP, P.G]),
    ("h", [P.H]),
    ("i", [P.IH]),
    ("j", [STOP, P.D, P.ZH]),
    ("k", [STOP, P.K]),
    ("l", [P.L]),
    ("m", [P.M]),
    ("n", [P.N]),
    ("o", [P.O]),
    ("p", [STOP, P.P]),
    ("r", [P.R]),
    ("s", [P.S]),
    ("t", [STOP, P.T]),
    ("u", [P.AH]),
    ("v", [P.V]),
    ("w", [P.W]),
    ("x", [STOP, P.K, P.S]),
    ("y", [P.Y]),
    ("z", [P.Z]),
]

from ..text.language import IntonationRules

# English prosody: marked declination, strong question rise, alternating
# lexical-ish stress
_INTONATION = IntonationRules(declination=0.25, question_rise=1.25,
                              statement_fall=0.90, accent_period=2,
                              accent_gain=1.07)

LANGUAGE = Language.from_pairs(_RULES, case_sensitive=False, name="english",
                               intonation=_INTONATION)
