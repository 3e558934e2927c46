// The reference sequencer's drift countdown in closed form, a float32
// binade at a time.
//
// The reference Sequencer decrements `time` by dt = 1/sr in float32 every
// sample (src/lib.rs:859-887); native/grail_native.cpp's
// gn_drift_boundaries2 runs that countdown one dependent subtract a sample.
// This function gives the same counts and the same residual bits with a few
// float32 steps an element.
//
// Why it can jump. Let t be a float32 in the binade [2^e, 2^(e+1)) with
// spacing u = 2^(e-23), t = m * u, m an integer in [2^23, 2^24). While the
// exact difference t - dt stays in that binade, fl(t - dt) is the multiple
// of u nearest to m * u - dt, ties to an even m: (m - r) * u with r = dt/u
// rounded to an integer. Where dt/u is not k + 1/2, r is round(dt/u) at every
// step of the binade. Where it is (one binade per rate), the tie goes to the
// even one of m - k and m - k - 1, so a step from an even m takes the even
// one of k and k + 1, and every step leaves m even: once m is even, r is
// fixed too. So a run of j steps is m -= j * r, and the count grows by j.
//
// Which steps stay explicit (a real float32 t - dt, one at a time):
//   * a step whose result would be the binade's lowest value 2^e or below:
//     the exact difference can then lie in the lower binade, whose spacing
//     is finer, and round there. A jump stops where m - r > 2^23 still holds
//     for its last step, so every jumped step's exact difference is at
//     least 2^e + u/2;
//   * every step from a binade whose lowest value is below 2 * dt: there the
//     loop's exit test (t - dt < 0) can come inside the binade;
//   * the first step of the tie binade from an odd m;
//   * every step from a t that is not a normal float32 (subnormal, inf);
//   * every step when dt is not a positive normal float32 (the whole
//     countdown then runs as the loop does).
// An r of 0 above the binade's lowest value is the stall: the loop's next
// step would be t - dt == t.
//
// Contract (gn_drift_boundaries2's): per element t = (t - dt) + L, then the
// countdown while !(t - dt < 0) and t == t; counts_cum[i] is the cumulative
// end sample of element i (its entry sample included), residuals[i] the t
// left after it (the t0 of a stream continuing there). Returns -1, or the
// index of an element that is NaN or stalls the countdown (counts_cum and
// residuals are then written up to the element before it). *steps receives
// the number of explicit float32 countdown steps taken.
//
// Build: -O2 -std=c++17 -fPIC -ffp-contract=off, no fast-math (every float32
// operation rounds on its own, as the loop's and numpy's do).

#include <cstdint>
#include <cstring>

namespace {

inline uint32_t bits_of(float x) {
    uint32_t b;
    std::memcpy(&b, &x, sizeof b);
    return b;
}

inline float float_of(uint32_t b) {
    float x;
    std::memcpy(&x, &b, sizeof x);
    return x;
}

constexpr uint32_t kExpMask = 0x7f800000u;
constexpr uint32_t kFracMask = 0x007fffffu;
constexpr uint32_t kHidden = 0x00800000u;       // 2^23: a binade's lowest m

}  // namespace

extern "C" int64_t gt_drift_boundaries(const float* lengths, int64_t e,
                                       float sr, float t0,
                                       int64_t* counts_cum, float* residuals,
                                       int64_t* steps) {
    const float dt = 1.0f / sr;
    const uint32_t dbits = bits_of(dt);
    const uint32_t dexp = (dbits & kExpMask) >> 23;
    const uint32_t dsig = (dbits & kFracMask) | kHidden;
    // the closed form needs dt > 0 and normal; otherwise every step is
    // explicit, as in the loop
    const bool jumps = dt > 0.0f && dexp != 0 && dexp != 0xff;
    const float two_dt = 2.0f * dt;
    float t = t0;
    int64_t cum = 0;
    int64_t explicit_steps = 0;
    for (int64_t i = 0; i < e; ++i) {
        if (!(lengths[i] == lengths[i])) {               // NaN length
            *steps = explicit_steps;
            return i;
        }
        t = (t - dt) + lengths[i];
        int64_t count = 1;                               // the entry sample
        while (!(t - dt < 0.0f) && t == t) {
            const uint32_t b = bits_of(t);
            const uint32_t texp = (b & kExpMask) >> 23;
            // t > 0 here (t >= dt > 0 for finite t), so b has no sign bit
            if (jumps && texp != 0 && texp != 0xff
                    && float_of(b & kExpMask) >= two_dt) {
                // dt / u = dsig / 2^s, with u = 2^(texp - 150) and
                // dt = dsig * 2^(dexp - 150); s >= 1 since 2^e >= 2 dt
                const uint32_t s = texp - dexp;
                uint32_t m = (b & kFracMask) | kHidden;
                uint64_t r;
                bool tie = false;
                if (s >= 26) {
                    r = 0;                               // dt / u < 1/2
                } else {
                    const uint64_t k = dsig >> s;
                    const uint64_t rem = dsig & ((1u << s) - 1u);
                    const uint64_t half = 1u << (s - 1);
                    if (rem == half) {
                        tie = true;
                        r = (k & 1u) ? k + 1 : k;        // from an even m
                    } else {
                        r = rem > half ? k + 1 : k;
                    }
                }
                // from m == 2^23 the exact difference falls below 2^e
                if (m > kHidden && !(tie && (m & 1u))) {
                    if (r == 0) {                        // the stall
                        *steps = explicit_steps;
                        return i;
                    }
                    // the last jumped step must leave m > 2^23
                    const uint64_t room = m - kHidden;
                    if (room > r) {
                        const uint64_t j = (room - 1) / r;
                        m -= static_cast<uint32_t>(j * r);
                        count += static_cast<int64_t>(j);
                        t = float_of((b & kExpMask) | (m & kFracMask));
                        continue;
                    }
                }
            }
            const float t2 = t - dt;
            ++explicit_steps;
            if (t2 == t) {                               // no progress
                *steps = explicit_steps;
                return i;
            }
            t = t2;
            ++count;
        }
        cum += count;
        counts_cum[i] = cum;
        residuals[i] = t;
    }
    *steps = explicit_steps;
    return -1;
}
