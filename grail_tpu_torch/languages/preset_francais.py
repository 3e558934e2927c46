"""'francais' — a pragmatic French grapheme->phoneme ruleset.

French orthography is position-dependent (silent finals, liaison) beyond
what a longest-match automaton can express; this preset takes the standard
approximations within the reduced-IPA inventory (text/phonemes.py):
nasal vowels render as vowel+N, front rounded u ([y]) as IH, schwa-e as AH,
j/ge/gi as ZH, silent h dropped. Every multi-char rule is prefix-closed
(tests/test_completeness.py::test_rulesets_are_prefix_closed) — the
no-backtracking automaton swallows input otherwise.
"""

from __future__ import annotations

from ..text.language import IntonationRules, Language
from ..text.phonemes import Phoneme as P

S = P.SILENCE
STOP = P.STOP
G = P.GLIDE

_RULES = [
    # whitespace / punctuation -> silence
    (" ", [S]), (",", [S]), (".", [S, S]), ("!", [S, S]), ("?", [S, S]),
    ("-", [S]), ("'", []), ("\n", [S, S]), ("\t", [S]),
    # trigraphs / digraphs (longest match wins; all prefix-closed)
    ("eau", [P.O]),
    ("ea", [P.EH, P.A]),      # prefix closure for eau (rare standalone)
    ("au", [P.O]),
    ("ou", [P.U]),
    ("oi", [P.W, P.A]),
    ("ai", [P.EH]),
    ("ain", [P.AE, P.N]),     # nasal
    ("ei", [P.EH]),
    ("ein", [P.AE, P.N]),     # nasal
    ("eu", [P.UH]),
    ("ch", [P.SH]),
    ("gn", [P.N, P.Y]),
    ("qu", [STOP, P.K]),
    ("q", [STOP, P.K]),
    ("ph", [P.F]),
    ("th", [STOP, P.T]),
    ("on", [P.O, P.N]),       # nasal approximations
    ("an", [P.A, P.N]),
    ("en", [P.A, P.N]),
    ("in", [P.AE, P.N]),
    ("un", [P.AH, P.N]),
    ("il", [P.I, P.L]),
    ("ill", [P.I, P.Y]),
    ("ille", [P.I, P.Y]),
    ("ll", [P.L]),
    ("ce", [P.S, P.AH]),
    ("ci", [P.S, P.I]),
    ("ge", [P.ZH, P.AH]),
    ("gi", [P.ZH, P.I]),
    # accented letters (ASCII-only case folding: add uppercase variants)
    ("ç", [P.S]), ("Ç", [P.S]),
    ("é", [P.EH]), ("É", [P.EH]),
    ("è", [P.EH]), ("È", [P.EH]),
    ("ê", [P.EH]), ("Ê", [P.EH]),
    ("à", [P.A]), ("À", [P.A]),
    ("â", [P.A]), ("Â", [P.A]),
    ("ô", [P.O]), ("Ô", [P.O]),
    ("î", [P.I]), ("Î", [P.I]),
    ("ï", [P.I]), ("Ï", [P.I]),
    ("û", [P.U]), ("ù", [P.U]),
    ("œ", [P.UH]),
    # single letters
    ("a", [P.A]),
    ("b", [STOP, P.B]),
    ("c", [STOP, P.K]),
    ("d", [STOP, P.D]),
    ("e", [P.AH]),            # schwa
    ("f", [P.F]),
    ("g", [STOP, P.G]),
    ("h", []),                # silent
    ("i", [P.I]),
    ("j", [P.ZH]),
    ("k", [STOP, P.K]),
    ("l", [P.L]),
    ("m", [P.M]),
    ("n", [P.N]),
    ("o", [P.O]),
    ("p", [STOP, P.P]),
    ("r", [P.R]),
    ("s", [P.S]),
    ("t", [STOP, P.T]),
    ("u", [P.IH]),            # [y] approximated as IH
    ("v", [P.V]),
    ("w", [P.W]),
    ("x", [STOP, P.K, P.S]),
    ("y", [P.I]),
    ("z", [P.Z]),
]

# French prosody: gentle declination, phrase-final stress (longer final
# window), clear continuation/question rise
_INTONATION = IntonationRules(declination=0.18, question_rise=1.25,
                              statement_fall=0.90, accent_period=3,
                              accent_gain=1.03)

LANGUAGE = Language.from_pairs(_RULES, case_sensitive=False, name="francais",
                               intonation=_INTONATION)
