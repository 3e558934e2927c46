"""Kernel 1 (synth/csrc/fused_synth.cu) against another version of its
source, on one card.

    python -m grail_tpu_torch.benchmarks.kernel1_ab turns OLD.cu
    python -m grail_tpu_torch.benchmarks.kernel1_ab phases SRC.cu
    python -m grail_tpu_torch.benchmarks.kernel1_ab kcar SEED

OLD.cu is a fused_synth.cu with the same C interface, built beside its own
seq_freq.cuh, for example the parent commit's, unpacked from git into a
directory that .gitignore lists:

    git archive <commit> grail_tpu_torch/synth/csrc | tar -x -C build/old

Both modes build the source they are given with nvcc and the package's flags
into build/grail_tpu_torch/ and run it at kernel 1's main-path shapes: the
B = 64 split of bench.py's 64 texts (voice generic, Q32), the same texts
unsplit, the 86.5 s long-form text on its track split (voice plain, english)
and on the unsplit kcar lane, one carry tick of a StreamPool at N = 128 and
512, and 1, 2 and 3 chunks at B = 64.

turns: launches the checkout's kernel and OLD.cu on the same arguments,
checks that their outputs are bit-equal, then times them in the order old,
new, new, old (CUDA events around `reps` launches through the C function,
median of 5).

phases: a copy of SRC.cu (either schedule), patched with clock64() stamps
and built on its own, splits a chunk's cycles per block, averaged over the
blocks; the stamped kernel's time is printed beside the unstamped one.
For the sequential schedule that the kernel had before its two-stage
pipeline (per chunk: the feed-forward, __syncthreads, the 8-thread
recurrence, __syncthreads, the output, __syncthreads): seq_freq, the
carrier, polyBLEP + coefficients, the feed-forward barrier, the recurrence
and the output. For the pipeline (the checkout's source): the consumer's
wait for a full buffer and the rest of its time, the producers' wait for
an empty buffer and their whole time.

kcar: the exact carrier's route at the benchmark's sentences shape, the
first batch of portbench's sentences mix from SEED (64 texts, voice plain,
english; run from the repository's root): kernel 1 `kcar` unsplit on 64
lanes against the split, the seam pre-pass (synth/csrc/kcar_seam.cu) and
kernel 1 on S * 64 lanes, each by CUDA events (median of 5), the seam
pre-pass also per step of its depth (its last seam); the split program as
the route enqueues it (`api._split_program`: the lanes' glue, the two
kernels); the plain seam pre-pass on the card over the first 65,536 steps
(host clock, once); the SM clock that nvidia-smi reads after the timing.

One JSON line per shape, then one with all of them; every line names the
card (nvidia-smi's name and power limit).
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..synth import _build

LONG_EN = ("the quick brown fox jumps over the lazy dog, while seventeen "
           "synthesizers hum along in the hall. is anyone still listening "
           "to this? the formants drift on and on.")
SERVE_TEXTS = ("all good things come to those who wait",
               "every call is important to us",
               "i am here to help you today",
               "open the door and come in please")
NSLOT = 10   # phases: per block 6 cycle sums, chunks, SM id, start, end


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _load(src: Path, name: str, include: Path) -> ctypes.CDLL:
    """Build one kernel source (its headers in `include`) into a library of
    its own and bind the launch functions it defines."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / name
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                          str(include), "-shared", "-o", str(out), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}"
                           f"{res.stderr}")
    print(json.dumps({"built": str(src), "ptxas": [
        ln.strip() for ln in (res.stdout + res.stderr).splitlines()
        if "registers" in ln or "Compiling entry" in ln]}), flush=True)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    argtypes = {"grail_fused_synth": [p] * 18 + [i] * 8 + [ctypes.c_float, p],
                "grail_phase_q32_pre": [p] * 7 + [i] * 4 + [p],
                "grail_synth_core": [p] * 14 + [i] * 2 + [p],
                "grail_phases_read": [p, i], "grail_phases_clear": []}
    text = src.read_text()
    for fn, types in argtypes.items():
        if f"{fn}(" in text:
            getattr(lib, fn).argtypes = types
            getattr(lib, fn).restype = i
    return lib


class _Recorder:
    """Stands in for the package's library inside a wrapper: forwards every
    call to `lib` and keeps the arguments of the launch named `fn`."""

    def __init__(self, lib, fn: str):
        self.lib, self.fn, self.argv = lib, fn, None

    def __getattr__(self, name):
        target = getattr(self.lib, name)
        if name != self.fn:
            return target

        def call(*argv):
            self.argv = argv
            return target(*argv)

        return call


def _record(lib, fn: str, call):
    """(the C arguments that call() passes to the library's `fn`, with `lib`
    standing in for the library, and call()'s outputs as a tuple, kept
    alive: the arguments point into them)."""
    rec = _Recorder(lib, fn)
    saved = _build._lib
    _build._lib = rec
    try:
        outs = call()
    finally:
        _build._lib = saved
    return rec.argv, outs if isinstance(outs, tuple) else (outs,)


def _ms(fn, reps: int, rounds: int = 5) -> float:
    """Median over `rounds` of the CUDA-event time of `reps` calls, per
    call, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(rounds):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        ts.append(e0.elapsed_time(e1) / reps)
    return statistics.median(ts)


def shapes(dev):
    """{name: (fused_synth_cuda args, kwargs, reps)} at the main path's
    shapes (see the module doc)."""
    import grail_tpu_torch as g
    import grail_tpu_torch.api as papi
    from ..api import BLOCK_SIZE, WARMUP, _round_up
    from ..runtime.stream import StreamPool
    from ..synth import kernel_fused as kf
    from ..synth.schedule import device_window

    out = {}
    voice = g.get_voice("generic")
    sr, inc = float(voice.sample_rate), voice.jitter_frequency
    texts = [("aeae" * 4)[:8 + (i % 8)] for i in range(64)]
    batch = papi._Batch([g.text_to_score(t) for t in texts], voice, None)
    _, _, S, T = g.route(64, max(batch.Ns), None, dev, sr)
    tables = batch.tables(T, dev)
    lanes, (phi, cell), state, q, g0, _ = papi._split_lanes(
        tables, T, S, "kernel", inc)
    sf, si = kf.state_rows(state, q)
    Ts = T // S + WARMUP
    out[f"split {S * 64}x{Ts}"] = ((lanes, phi, cell, sf, si, Ts, False),
                                   dict(g0=g0), 1)
    Tu = _round_up(max(batch.Ns), BLOCK_SIZE)
    tab = batch.tables(Tu, dev)
    phi, cell = device_window(inc, 0, Tu, dev)
    z = (torch.zeros(64, 24, device=dev),
         torch.zeros(64, 3, dtype=torch.int32, device=dev))
    out[f"unsplit 64x{Tu}"] = ((tab, phi, cell, *z, Tu, False), {}, 1)
    for n in (128, 256, 384):
        out[f"chunks 64x{n}"] = ((tab, phi[:n], cell[:n], *z, n, False), {},
                                 50)

    lv = g.get_voice("plain")
    pel = g.text_to_phoneme_elems(LONG_EN, lv, "english")
    lb = papi._Batch([papi.score_from_phoneme_elems(pel, lv)], lv, [0])
    N = lb.Ns[0]
    track = papi._carrier_track_for(pel, lv, 0)
    _, _, St, Tt = g.route(1, N, None, dev, sr, track=True)
    lanes, seg, state, q, g0, car = papi._split_lanes(
        lb.tables(Tt, dev), Tt, St, "kernel", lv.jitter_frequency, track)
    sf, si = kf.state_rows(state, q)
    Ts = Tt // St + WARMUP
    out[f"track {St}x{Ts}"] = ((lanes, seg[0], seg[1], sf, si, Ts, False),
                               dict(g0=g0, carrier=car), 1)
    T1 = _round_up(N, BLOCK_SIZE)
    phi, cell = device_window(lv.jitter_frequency, 0, T1, dev)
    out[f"kcar 1x{T1}"] = ((lb.tables(T1, dev), phi, cell,
                            torch.zeros(1, 24, device=dev),
                            torch.zeros(1, 3, dtype=torch.int32, device=dev),
                            T1, True), {}, 1)

    for n in (128, 512):
        pool = StreamPool(n, voice="plain", language="english",
                          device="cuda")
        for i in range(n):
            pool.feed(i, SERVE_TEXTS[i % len(SERVE_TEXTS)])
        pool.flush()
        for _ in range(4):
            pool.read_block()
        ins = pool._prepare_tick()
        tables = kf.FusedTables(ins["n"], ins["scal"], ins["vec"],
                                *ins["lat"], ins["par"])
        out[f"carry {n}x{pool.block}"] = (
            (tables, None, None, pool._sf, pool._si, pool.block, True),
            dict(g0=ins["offsets"], lat_base=ins["lat_base"],
                 inc=ins["inc"]), 50)
    return out


def _argv(lib, args, kw):
    """The C arguments fused_synth_cuda passes for (args, kw), launched
    through `lib`, and its outputs."""
    from ..synth import kernel_fused as kf

    return _record(lib, "grail_fused_synth",
                   lambda: kf.fused_synth_cuda(*args, **kw))


def turns(old_src: Path):
    dev = torch.device("cuda", 0)
    card = _card()
    new = _build.load_library()
    old = _load(old_src, "libgrail_kernel1_old.so", old_src.parent)
    res = {}
    for name, (args, kw, reps) in shapes(dev).items():
        argv, outs = _argv(new, args, kw)
        torch.cuda.synchronize()
        want = [t.clone() for t in outs]
        if old.grail_fused_synth(*argv) != 0:
            raise RuntimeError(f"{name}: the old kernel's launch failed")
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(outs, want))
        t = [_ms(lambda: lib.grail_fused_synth(*argv), reps)
             for lib in (old, new, new, old)]
        r = {"shape": name, "bit_equal": same, "old_ms": [t[0], t[3]],
             "new_ms": [t[1], t[2]],
             "new_over_old": (t[1] + t[2]) / (t[0] + t[3]), "card": card}
        res[name] = r
        print(json.dumps(r), flush=True)
        if not same:
            raise AssertionError(f"{name}: old and new outputs differ")
    return res


_HEADER = (
    "__device__ unsigned long long g_clk[65536 * 10];\n"
    "static __device__ __forceinline__ unsigned long long gtime() {\n"
    "  unsigned long long t;\n"
    "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
    "  return t;\n}\n"
    "static __device__ __forceinline__ unsigned smid() {\n"
    "  unsigned r;\n"
    "  asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(r));\n"
    "  return r;\n}\n")

# the stamps of each schedule: (anchor in its source, text put before it,
# text put after it); per block, slots 0-5 hold cycle sums, 6 the chunks, 7
# the SM, 8-9 the globaltimer at the start and the end. A barrier defers
# its blocking (BAR.SYNC.DEFER_BLOCKING): a clock read right after it can
# issue before the wait ends, so each stamp after a barrier first waits
# for a shared load that the barrier orders (`_AFTER_BAR`; the value never
# matches, the branch only makes the clock read depend on the load)
_AFTER_BAR = ("    if (((volatile float*){})[{}] == 12345.f) acc[{}] += 1;\n")
_SEQUENTIAL = (
    ('#include "seq_freq.cuh"\n', "", _HEADER),
    ("  float lp = 0.f, bs = 0.f, cs = 0.f;\n", "",
     "  unsigned long long acc[6] = {0, 0, 0, 0, 0, 0};\n"
     "  const unsigned long long g_start = gtime();\n"
     "  int nch = 0;\n"),
    ("  for (int c0 = 0; c0 < T; c0 += CHUNK) {\n", "",
     "    long long c_a = clock64();\n"),
    ("    const float freq_j = sq.freq_j;\n", "",
     "    long long c_b = clock64();\n"),
    ("    // polyBLEP saw", "    long long c_c = clock64();\n", ""),
    ("    __syncthreads();\n\n    // ---- D:",
     "    long long c_d = clock64();\n", ""),
    ("    // ---- D:", _AFTER_BAR.format("s_d", 0, 3)
     + "    long long c_e = clock64();\n", ""),
    ("    // ---- output:", _AFTER_BAR.format("s_d", 0, 4)
     + "    long long c_f = clock64();\n", ""),
    ("    __syncthreads();   // shared streams are rewritten by the next "
     "chunk\n", "",
     _AFTER_BAR.format("s_d", 0, 5) + "    long long c_g = clock64();\n"
     "    acc[0] += c_b - c_a; acc[1] += c_c - c_b; acc[2] += c_d - c_c;\n"
     "    acc[3] += c_e - c_d; acc[4] += c_f - c_e; acc[5] += c_g - c_f;\n"
     "    ++nch;\n"),
    ("  if (t < NF) {\n    sf_out[b * 3 * NF + t] = lp;\n",
     "  if (t == 0 && b < 65536) {\n"
     "    for (int i = 0; i < 6; ++i) g_clk[b * 10 + i] = acc[i];\n"
     "    g_clk[b * 10 + 6] = nch;\n"
     "    g_clk[b * 10 + 7] = smid();\n"
     "    g_clk[b * 10 + 8] = g_start;\n"
     "    g_clk[b * 10 + 9] = gtime();\n  }\n", ""),
)
_SEQUENTIAL_NAMES = ("seq_freq", "carrier", "polyblep_coefficients",
                     "ff_barrier", "recurrence", "output")

# the two-stage pipeline: the consumer's lane 0 splits its time into waiting
# for a full buffer and the rest (recurrence, output, hand-over); producer
# thread 0 counts its waits for an empty buffer and its whole time
_PIPELINE = (
    ('#include "seq_freq.cuh"\n', "", _HEADER),
    ("    float lp = 0.f, bs = 0.f, cs = 0.f;\n", "",
     "    unsigned long long acc[2] = {0, 0};\n"
     "    const unsigned long long g_start = gtime();\n"
     "    long long c_prev = clock64();\n"),
    ("      bar_sync(BAR_FULL + (k & 1), NTHREADS);\n",
     "      long long c_w = clock64();\n      acc[1] += c_w - c_prev;\n",
     "  " + _AFTER_BAR.format("buf", "NSTREAM * NF * ROW", 0)
     + "      c_prev = clock64();\n      acc[0] += c_prev - c_w;\n"),
    ("    if (lane < NF) {\n      sf_out[b * 3 * NF + lane] = lp;\n",
     "    acc[1] += clock64() - c_prev;\n"
     "    if (lane == 0 && b < 65536) {\n"
     "      g_clk[b * 10 + 0] = acc[0];\n"
     "      g_clk[b * 10 + 1] = acc[1];\n"
     "      g_clk[b * 10 + 6] = nch;\n"
     "      g_clk[b * 10 + 7] = smid();\n"
     "      g_clk[b * 10 + 8] = g_start;\n"
     "      g_clk[b * 10 + 9] = gtime();\n    }\n", ""),
    ("  for (int k = 0; k < nch; ++k) {\n    const int kk",
     "  unsigned long long p_wait = 0;\n"
     "  const long long p_start = clock64();\n", ""),
    ("    if (k >= 2) bar_sync(BAR_EMPTY + par_k, NTHREADS);\n",
     "    long long p_w = clock64();\n",
     _AFTER_BAR.format("ring", "par_k * BUF_FLOATS + t", 0).replace(
         "acc[0]", "p_wait") + "    p_wait += clock64() - p_w;\n"),
    ("  if (t == 0) {\n    int* sob",
     "  if (t == 0 && b < 65536) {\n"
     "    g_clk[b * 10 + 2] = p_wait;\n"
     "    g_clk[b * 10 + 3] = clock64() - p_start;\n  }\n", ""),
)
_PIPELINE_NAMES = ("consumer_waits_full", "consumer_works",
                   "producer_waits_empty", "producer_all")


def _stamped(src: str):
    """(stamped source, slot names) of whichever schedule `src` has; raises
    if it has neither."""
    for table, names in ((_SEQUENTIAL, _SEQUENTIAL_NAMES),
                         (_PIPELINE, _PIPELINE_NAMES)):
        if all(src.count(anchor) == 1 for anchor, _, _ in table):
            break
    else:
        raise ValueError("phases: the source has neither schedule's anchors")
    for anchor, before, after in table:
        i = src.index(anchor)
        src = src[:i] + before + anchor + after + src[i + len(anchor):]
    return src + ("\nextern \"C\" int grail_phases_read(unsigned long long* "
                  "host, int nb) {\n  return (int)cudaMemcpyFromSymbol(host, "
                  "g_clk, (size_t)nb * 10 * 8);\n}\n"), names


def phases(src: Path):
    dev = torch.device("cuda", 0)
    card = _card()
    text, names = _stamped(src.read_text())
    stamped = _build.BUILD_DIR / "fused_synth_phases.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stamped.write_text(text)
    plain = _load(src, "libgrail_kernel1_src.so", src.parent)
    lib = _load(stamped, "libgrail_kernel1_phases.so", src.parent)
    lib.grail_phases_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.grail_phases_read.restype = ctypes.c_int
    k = len(names)
    res = {}
    for name, (args, kw, reps) in shapes(dev).items():
        argv, outs = _argv(plain, args, kw)
        nb = outs[0].shape[0]
        ms = _ms(lambda: plain.grail_fused_synth(*argv), reps)
        ms_stamped = _ms(lambda: lib.grail_fused_synth(*argv), reps)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (nb * NSLOT))()
        if lib.grail_phases_read(ctypes.cast(buf, ctypes.c_void_p), nb):
            raise RuntimeError("phases: reading the stamps failed")
        a = np.frombuffer(buf, np.uint64).reshape(nb, NSLOT).astype(float)
        per = a[:, :k] / a[:, 6:7]
        # a chunk is what one thread's stamps span: the six phases of the
        # sequential schedule, the consumer's wait + work in the pipeline
        span = per if k == 6 else per[:, :2]
        r = {"shape": name, "ms": ms, "ms_stamped": ms_stamped,
             "cycles_per_chunk": dict(zip(names, per.mean(0).tolist())),
             "chunk_cycles": float(span.sum(1).mean()),
             "chunk_ns": float(((a[:, 9] - a[:, 8]) / a[:, 6]).mean()),
             "blocks_per_sm": int(np.bincount(a[:, 7].astype(int)).max()),
             "card": card}
        res[name] = r
        print(json.dumps(r), flush=True)
    return res


def kcar(seed: int):
    """The kcar route at the sentences shape (see the module doc)."""
    import time

    import grail_tpu_torch as g
    import grail_tpu_torch.api as papi
    from portbench.traffic import generator

    from ..synth import kernel_fused as kf
    from ..synth.schedule import device_window

    dev = torch.device("cuda", 0)
    card = _card()
    texts = generator.batches(generator.load_mix("sentences"), seed, 1)[0]
    v = g.get_voice("plain")
    b = papi._Batch([papi.score_from_phoneme_elems(
        g.text_to_phoneme_elems(t, v, "english"), v) for t in texts], v,
        list(range(len(texts))))
    _, carrier, S, T = g.route(b.B, max(b.Ns), None, dev, b.sr)
    inc, W = v.jitter_frequency, papi.WARMUP
    tables = b.tables(T, dev)
    sched = papi._split_sched(inc, T, S, dev)
    pre = sched[0]
    Ts = T // S
    seams = (Ts - W, Ts, S - 1)
    depth = Ts - W + (S - 2) * Ts
    lanes, seg, state, q, g0, _ = papi._split_lanes(
        tables, T, S, "kernel", inc, sched=sched, kcar=True)
    sf, si = kf.state_rows(state, q)
    T1 = papi._round_up(max(b.Ns), papi.BLOCK_SIZE)
    tab1 = b.tables(T1, dev)
    phi1, cell1 = device_window(inc, 0, T1, dev)
    z = (torch.zeros(b.B, 24, device=dev),
         torch.zeros(b.B, 3, dtype=torch.int32, device=dev))
    ms = {
        "seam": _ms(lambda: kf.kcar_seam_cuda(tables, *pre, *seams), 1),
        "split_kernel1": _ms(lambda: kf.fused_synth_cuda(
            lanes, *seg, sf, si, Ts + W, True, g0=g0), 1),
        "split_program": _ms(lambda: papi._split_program(
            tables, T, S, "kernel", inc, sched=sched, kcar=True), 1),
        "unsplit_kernel1": _ms(lambda: kf.fused_synth_cuda(
            tab1, phi1, cell1, *z, T1, True), 1)}
    t0 = time.perf_counter()
    kf.kcar_seam_reference(tables, *pre, 65536, 1, 1)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    r = {"shape": f"kcar B={b.B} maxN={max(b.Ns)}", "carrier": carrier,
         "S": S, "T": T, "T_unsplit": T1, "seam_depth": depth,
         "lane_samples_past_end": int(sum(T1 - n for n in b.Ns)),
         "ms": ms, "seam_ns_per_step": ms["seam"] * 1e6 / depth,
         "plain_seam_s_65536_steps": plain_s, "sm_clock": clocks,
         "seed": seed, "card": card}
    print(json.dumps(r), flush=True)
    return r


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2 or argv[0] not in ("turns", "phases", "kcar"):
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel1_ab: needs a CUDA device", file=sys.stderr)
        return 1
    torch.cuda.set_device(0)
    if argv[0] == "kcar":
        res = kcar(int(argv[1]))
    else:
        res = (turns if argv[0] == "turns" else phases)(
            Path(argv[1]).resolve())
    print(json.dumps({argv[0]: res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
