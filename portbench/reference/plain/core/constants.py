"""Global constants for the grail_tpu_torch formant synthesizer.

Parity notes (reference: Dimev/grail-rs):
  - DEFAULT_SAMPLE_RATE mirrors grail-rs src/lib.rs:21
  - NUM_FORMANTS mirrors grail-rs src/lib.rs:24

All frequency-valued synthesis parameters are *normalized to the sample
rate*: 0.0 is DC, 1.0 is the sample frequency, 0.5 is Nyquist.
"""

DEFAULT_SAMPLE_RATE: float = 44100.0

NUM_FORMANTS: int = 8

# Lehmer LCG parameters (reference src/lib.rs:36-55): state' = state * A + C mod 2^32
LEHMER_A: int = 16807
LEHMER_C: int = 1
