// The reference's carrier phase track from the frequency chain alone.
//
// The solo long-form route reads the reference's float32 carrier phase for
// every sample (src/lib.rs:520-525: emit the phase, then `phase += f`, and
// `phase -= 1` once it reaches 1). native/grail_oracle.cpp's
// gn_carrier_phase_track produces it by running the whole oracle chain
// without its filter: every sample it still blends all six formant fields,
// steps both formant noise generators and jitters the formants, none of
// which the carrier reads. This function computes only what the carrier
// reads, with the same bits:
//
//   * the sequencer's state machine (src/lib.rs:856-932), as the oracle
//     writes it, and its 4-case crossfade restricted to `frequency`: every
//     expression as the oracle's (`x * (1 - a) + y * a`, with x and y the
//     next and current elements' frequencies, or one of them twice);
//   * the frequency jitter alone: `freq_noise` is the first generator built
//     from the seed and draws from its own copy of the Lehmer state after
//     its two init draws (src/lib.rs:218-249), so the formant generators
//     never reach the frequency;
//   * the carrier recurrence.
//
// One loop carries three float32 chains, each one dependent add or
// subtract a sample: the countdown, the noise's phase and the carrier. The
// division `time / blend` and the blends of a sample wait on no other
// sample's, so the core overlaps them and the three chains. (Computing a
// block's frequencies first and running the carrier over the block after
// puts the carrier's chain behind the block's other work instead: 12-20 %
// slower on both hosts measured, an H100 machine's and a Xeon.)
// `fminf(x, 1)` (a library call at -O2) is written inline with the same
// result everywhere: a NaN first operand gives 1, as the zero-blend corner
// (0 / 0) needs.
//
// Contract (gn_carrier_phase_track's, without the formant fields): element i
// has sound parameters iff present[i] != 0; writes the PRE-update phase of
// every sample to phase_out and returns the number of samples; -1 if `cap`
// is too small; -2 - i if element i's length is not finite.
//
// Build: -O2 -std=c++17 -fPIC -ffp-contract=off, no fast-math (every float32
// operation rounds on its own, as the oracle's and numpy's do).

#include <cstdint>

namespace {

// Lehmer RNG (reference random_f32, src/lib.rs:36-55)
struct Lehmer {
    uint32_t state;
    float next() {
        state = state * 16807u + 1u;
        const uint32_t bits = (state >> 9) | 0x3F800000u;
        float f;
        __builtin_memcpy(&f, &bits, 4);
        return (f - 1.5f) * 2.0f;
    }
};

// fminf(x, 1.0f): a NaN x gives 1.0f
inline float min1(float x) { return x < 1.0f ? x : 1.0f; }

}  // namespace

extern "C" int64_t gt_carrier_track(const int32_t* present,
                                    const float* length, const float* blend,
                                    const float* frequency, int64_t e,
                                    float sample_rate, uint32_t jitter_seed,
                                    float jf, float jdf, float* phase_out,
                                    int64_t cap) {
    for (int64_t i = 0; i < e; ++i) {
        if (!(length[i] - length[i] == 0.0f)) return -2 - i;  // inf or NaN
    }

    // freq_noise (ValueNoise): two init draws, then its own copy of the state
    Lehmer rng{jitter_seed};
    float n_cur = rng.next();
    float n_next = rng.next();
    float n_phase = 0.0f;

    // the sequencer: cur/nxt are -1 for "no element"
    int64_t pulled = 0;
    int64_t cur = -1, nxt = -1;
    float time = 0.0f;
    const float dt = 1.0f / sample_rate;

    // the current segment's crossfade: silent, or x * (1 - a) + y * a with
    // a = min(time / bl, 1)
    bool silent = true;
    float x = 0.0f, y = 0.0f, bl = 0.0f;

    float carrier = 0.0f;
    for (int64_t n = 0;; ++n) {
        time = time - dt;
        if (time < 0.0f) {
            if (cur >= 0 && nxt >= 0) {
                cur = nxt;
                nxt = pulled < e ? pulled++ : -1;
                time = time + length[cur];
            } else if (cur < 0 && nxt < 0) {
                cur = pulled < e ? pulled++ : -1;
                nxt = pulled < e ? pulled++ : -1;
                if (cur >= 0) time = time + length[cur];
            } else {
                return n;
            }
            if (cur < 0) return n;
            const bool has_b = present[cur] != 0;
            const bool has_c = nxt >= 0 && present[nxt] != 0;
            silent = !has_b && !has_c;
            if (has_b && has_c) {             // c.blend(b, a)
                x = frequency[nxt];
                y = frequency[cur];
            } else if (has_b) {               // b.copy_silent().blend(b, a)
                x = y = frequency[cur];
            } else if (has_c) {               // c.blend(c.copy_silent(), a)
                x = y = frequency[nxt];
            }
            bl = blend[cur];
        }
        float fr;
        if (silent) {
            fr = 0.25f;
        } else {
            const float a = min1(time / bl);
            const float ia = 1.0f - a;
            fr = x * ia + y * a;
        }
        n_phase = n_phase + jf;
        if (n_phase > 1.0f) {
            n_phase = n_phase - 1.0f;
            n_cur = n_next;
            n_next = rng.next();
        }
        const float fn = n_cur * (1.0f - n_phase) + n_next * n_phase;
        const float f = fr + (fn * jdf);
        if (n == cap) return -1;
        phase_out[n] = carrier;
        carrier = carrier + f;
        if (carrier >= 1.0f) carrier = carrier - 1.0f;
    }
}
