"""'espanol' — a Spanish-orthography ruleset (shallow orthography maps
nearly 1:1 to the reduced-IPA inventory; digraphs ll/rr/ch/qu handled by
longest match)."""

from __future__ import annotations

from ..text.language import Language
from ..text.phonemes import Phoneme as P

S = P.SILENCE
STOP = P.STOP

_RULES = [
    (" ", [S]), (",", [S]), (".", [S, S]), ("!", [S, S]), ("?", [S, S]),
    ("¡", []), ("¿", []), ("-", [S]),
    ("ch", [STOP, P.T, P.SH]),
    ("ll", [P.Y]),
    ("rr", [P.R, P.R]),
    ("qu", [STOP, P.K]),
    ("gue", [STOP, P.G, P.EH]),
    ("gui", [STOP, P.G, P.I]),
    # prefix closure (no-backtracking automaton; see preset_english.py):
    # without these, "guapo" loses "gua" and a dangling "q" swallows
    ("gu", [STOP, P.G, P.U]),
    ("q", [STOP, P.K]),
    ("ce", [P.S, P.EH]),
    ("ci", [P.S, P.I]),
    ("ge", [P.H, P.EH]),
    ("gi", [P.H, P.I]),
    ("a", [P.A]),
    ("b", [STOP, P.B]),
    ("c", [STOP, P.K]),
    ("d", [STOP, P.D]),
    ("e", [P.EH]),
    ("f", [P.F]),
    ("g", [STOP, P.G]),
    ("h", []),              # silent in Spanish
    ("i", [P.I]),
    ("j", [P.H]),
    ("k", [STOP, P.K]),
    ("l", [P.L]),
    ("m", [P.M]),
    ("n", [P.N]),
    ("ñ", [P.N, P.Y]),
    ("o", [P.O]),
    ("p", [STOP, P.P]),
    ("r", [P.R]),
    ("s", [P.S]),
    ("t", [STOP, P.T]),
    ("u", [P.U]),
    ("v", [STOP, P.B]),     # betacism
    ("w", [P.W]),
    ("x", [STOP, P.K, P.S]),
    ("y", [P.Y]),
    ("z", [P.S]),           # seseo
]

from ..text.language import IntonationRules

# Spanish prosody: flatter declination, syllable-timed (weaker accent),
# moderate final rise on questions
_INTONATION = IntonationRules(declination=0.16, question_rise=1.18,
                              statement_fall=0.93, accent_period=3,
                              accent_gain=1.04, final_lengthen=1.2)

LANGUAGE = Language.from_pairs(_RULES, case_sensitive=False, name="espanol",
                               intonation=_INTONATION)
