"""'plain' — a full-inventory voice covering every sound phoneme.

The reference ships only A/E (src/lib.rs:686-689, marked TODO!); the
framework's target configs require the complete reduced-IPA inventory
including noise-excited fricatives and plosive releases. Formant targets
are drawn from standard acoustic-phonetics tables (Peterson-Barney-style
vowel formants; consonant loci approximated), mapped onto grail's parameter
model: `breath` blends the saw carrier toward white noise per formant
(voiceless sounds use breath=1), `turb` multiplies glottal-open noise in
(aspiration), and plosives are short release bursts preceded by a STOP
closure emitted by the language ruleset.
"""

from __future__ import annotations

from .voice import PhonemeSpec, VoiceSpec

_SMOOTH = (1600.0,) * 8


def _phon(f1, f2, f3, f4=3500.0, bw=(70, 110, 160, 200), amps=(0.4, 0.3, 0.2, 0.1),
          hi_amp=(0.0, 0.0), breath=(0.1, 0.05, 0.05, 0.05, 0.0, 0.0, 0.0, 0.0),
          turb=(0.15, 0.1, 0.05, 0.0, 0.0, 0.0, 0.0, 0.0)):
    """Voiced sound: 4 voice formants + 2 upper fixed + 2 spare."""
    return PhonemeSpec(
        freq=(f1, f2, f3, f4, 4500.0, 5500.0, 6500.0, 7500.0),
        bw=(bw[0], bw[1], bw[2], bw[3], 250.0, 300.0, 350.0, 400.0),
        smooth=_SMOOTH,
        turb=tuple(turb),
        breath=tuple(breath),
        amp=(amps[0], amps[1], amps[2], amps[3], hi_amp[0], hi_amp[1], 0.0, 0.0),
    )


def _fric(centers, bws, amps, voiced=False):
    """Fricative: noise-excited bandpass bank. Voiceless = breath 1 on all
    bands; voiced keeps a low-frequency carrier formant."""
    f = list(centers) + [7000.0] * (8 - len(centers))
    b = list(bws) + [500.0] * (8 - len(bws))
    a = list(amps) + [0.0] * (8 - len(amps))
    breath = (0.15,) + (1.0,) * 7 if voiced else (1.0,) * 8
    turb = (0.3,) * 8
    return PhonemeSpec(freq=tuple(f), bw=tuple(b), smooth=(3000.0,) * 8,
                       turb=turb, breath=breath, amp=tuple(a))


def _burst(center, bw, voiced):
    """Plosive release burst at the articulation locus."""
    breath = (0.2,) + (1.0,) * 7 if voiced else (1.0,) * 8
    return PhonemeSpec(
        freq=(200.0 if voiced else center, center, center * 1.3, 4000.0,
              5000.0, 6000.0, 7000.0, 8000.0),
        bw=(100.0, bw, bw * 1.5, 600.0, 700.0, 800.0, 900.0, 1000.0),
        smooth=(3000.0,) * 8,
        turb=(0.4,) * 8,
        breath=breath,
        amp=(0.3 if voiced else 0.0, 0.5, 0.3, 0.1, 0.05, 0.0, 0.0, 0.0),
    )


SPEC = VoiceSpec(
    name="plain",
    phonemes={
        # --- vowels (Peterson-Barney-ish, male) --------------------------
        "A":  _phon(730, 1090, 2440),
        "E":  _phon(530, 1840, 2480),
        "I":  _phon(270, 2290, 3010),
        "O":  _phon(570, 840, 2410),
        "U":  _phon(300, 870, 2240),
        "AE": _phon(660, 1720, 2410),
        "AH": _phon(640, 1190, 2390),
        "IH": _phon(390, 1990, 2550),
        "EH": _phon(460, 2000, 2600),
        "UH": _phon(440, 1020, 2240),
        "OW": _phon(480, 920, 2300),
        # --- nasals (low F1 murmur, damped uppers) -----------------------
        "M":  _phon(250, 1200, 2400, bw=(60, 300, 300, 300), amps=(0.55, 0.15, 0.1, 0.05)),
        "N":  _phon(250, 1700, 2600, bw=(60, 300, 300, 300), amps=(0.55, 0.15, 0.1, 0.05)),
        "NG": _phon(250, 2300, 2750, bw=(60, 300, 300, 300), amps=(0.55, 0.15, 0.1, 0.05)),
        # --- liquids / semivowels ---------------------------------------
        "L":  _phon(380, 1200, 2600),
        "R":  _phon(420, 1300, 1600, bw=(70, 120, 120, 200)),
        "W":  _phon(300, 700, 2300),
        "Y":  _phon(280, 2250, 3000),
        # --- voiced fricatives ------------------------------------------
        "V":  _fric((350, 1400, 4000, 5500), (100, 400, 800, 900),
                    (0.45, 0.15, 0.25, 0.15), voiced=True),
        "Z":  _fric((300, 4500, 5500, 6500), (100, 600, 700, 800),
                    (0.4, 0.2, 0.25, 0.15), voiced=True),
        "ZH": _fric((300, 2500, 3500, 4500), (100, 500, 600, 700),
                    (0.4, 0.25, 0.2, 0.15), voiced=True),
        "DH": _fric((350, 1600, 5000, 6000), (100, 500, 900, 1000),
                    (0.45, 0.2, 0.2, 0.15), voiced=True),
        # --- voiceless fricatives ---------------------------------------
        "F":  _fric((1400, 4000, 5500, 7000), (500, 800, 900, 1000),
                    (0.25, 0.3, 0.25, 0.2)),
        "S":  _fric((5000, 6000, 7000, 8000), (500, 600, 700, 800),
                    (0.25, 0.35, 0.25, 0.15)),
        "SH": _fric((2500, 3300, 4200, 5000), (400, 500, 600, 700),
                    (0.3, 0.3, 0.25, 0.15)),
        "TH": _fric((1400, 5500, 6500, 7500), (600, 900, 1000, 1100),
                    (0.25, 0.3, 0.25, 0.2)),
        "H":  _fric((600, 1500, 2500, 3500), (300, 400, 500, 600),
                    (0.35, 0.3, 0.2, 0.15)),
        # --- plosive releases (preceded by STOP closure) ----------------
        "P":  _burst(800, 300, voiced=False),
        "B":  _burst(800, 300, voiced=True),
        "T":  _burst(4200, 600, voiced=False),
        "D":  _burst(4200, 600, voiced=True),
        "K":  _burst(2000, 400, voiced=False),
        "G":  _burst(2000, 400, voiced=True),
    },
    center_frequency_hz=120.0,
    jitter_frequency_hz=16.0,
    jitter_delta_frequency_hz=6.0,
    jitter_delta_formant_frequency_hz=6.0,
    jitter_delta_amplitude=0.2,
)
