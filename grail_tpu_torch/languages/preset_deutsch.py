"""'deutsch' — a German grapheme->phoneme ruleset over the full inventory.

German orthography is comparatively regular; the longest-match transcriber
handles its many digraphs/trigraphs directly ("sch" beats "ch" beats "c").
Approximations within the reduced-IPA inventory (text/phonemes.py): front
rounded vowels map to their unrounded neighbours (ö→EH, ü→IH), both ich-
and ach-laut map to H. Word-initial "s(p|t)" takes the standard [SH] onset
via space-prefixed rules (mid-sentence; utterance-initial words fall to
the coda [s] rule). Plosives emit STOP + release, diphthongs use GLIDE,
exactly like the english preset.

Uppercase umlauts get explicit rules: the reference's case folding is
ASCII-only (src/lib.rs:1127-1133), so `case_sensitive=False` does not fold
'Ä' to 'ä'.
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
    # trigraphs / digraphs (longest match wins)
    ("sch", [P.SH]),
    ("tsch", [STOP, P.T, P.SH]),
    ("ch", [P.H]),
    ("ck", [STOP, P.K]),
    ("chs", [STOP, P.K, P.S]),
    ("ph", [P.F]),
    ("th", [STOP, P.T]),
    ("tz", [STOP, P.T, P.S]),
    ("qu", [STOP, P.K, P.V]),
    ("ng", [P.NG]),
    # s+p/s+t: [SH] onset only after a word boundary (space-prefixed rules);
    # word-internal/final st/sp — the majority case (ist, fenster, wespe) —
    # stays [s]. Utterance-initial words lack the leading space and fall to
    # the coda rule; mid-sentence onsets are the common case and win.
    (" sp", [S, P.SH, STOP, P.P]),
    (" st", [S, P.SH, STOP, P.T]),
    # prefix closure for the space-prefixed family: without " sc"/" sch",
    # the " s" fallback would consume the 's' of every mid-sentence
    # "sch..." word and the trigraph would never match
    (" s", [S, P.Z]),
    (" sc", [S, P.Z, STOP, P.K]),
    (" sch", [S, P.SH]),
    ("sp", [P.S, STOP, P.P]),
    ("st", [P.S, STOP, P.T]),
    ("ss", [P.S]),
    ("ß", [P.S]),
    # prefix closure (no-backtracking automaton; see preset_english.py):
    # without these, "nichts"/"rechts" lose their final [ts] cluster
    ("ts", [STOP, P.T, P.S]),
    ("tsc", [STOP, P.T, P.S, STOP, P.K]),
    ("sc", [P.Z, STOP, P.K]),
    ("q", [STOP, P.K]),
    # vowel digraphs / diphthongs
    ("ie", [P.I]),
    ("ei", [P.AH, G, P.IH]),
    ("ai", [P.AH, G, P.IH]),
    ("au", [P.AH, G, P.U]),
    ("eu", [P.O, G, P.IH]),
    ("äu", [P.O, G, P.IH]),
    ("Äu", [P.O, G, P.IH]),
    ("aa", [P.A]),
    ("ee", [P.EH]),
    ("oo", [P.O]),
    ("eh", [P.EH]),
    ("ah", [P.A]),
    ("oh", [P.OW]),
    ("uh", [P.U]),
    ("äh", [P.EH]),
    ("öh", [P.EH]),
    ("üh", [P.IH]),
    # umlauts (lower + upper: ASCII-only case folding)
    ("ä", [P.EH]), ("Ä", [P.EH]),
    ("ö", [P.EH]), ("Ö", [P.EH]),
    ("ü", [P.IH]), ("Ü", [P.IH]),
    # single letters
    ("a", [P.A]),
    ("b", [STOP, P.B]),
    ("c", [STOP, P.K]),
    ("d", [STOP, P.D]),
    ("e", [P.EH]),
    ("f", [P.F]),
    ("g", [STOP, P.G]),
    ("h", [P.H]),
    ("i", [P.IH]),
    ("j", [P.Y]),
    ("k", [STOP, P.K]),
    ("l", [P.L]),
    ("m", [P.M]),
    ("n", [P.N]),
    ("o", [P.O]),
    ("p", [STOP, P.P]),
    ("r", [P.R]),
    ("s", [P.Z]),          # single s is voiced [z] in onset position
    ("t", [STOP, P.T]),
    ("u", [P.U]),
    ("v", [P.F]),          # Vogel -> [f]
    ("w", [P.V]),          # Wasser -> [v]
    ("x", [STOP, P.K, P.S]),
    ("y", [P.IH]),
    ("z", [STOP, P.T, P.S]),
]

# German prosody: flatter declination than English, clear question rise,
# longer phrase-final lengthening
_INTONATION = IntonationRules(declination=0.20, question_rise=1.20,
                              statement_fall=0.88, accent_period=2,
                              accent_gain=1.05)

LANGUAGE = Language.from_pairs(_RULES, case_sensitive=False, name="deutsch",
                               intonation=_INTONATION)
