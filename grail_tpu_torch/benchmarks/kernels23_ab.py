"""Kernels 2 (synth/csrc/phase_q32_pre.cu) and 3 (synth/csrc/synth_core.cu)
against other versions of their sources, on one card.

    python -m grail_tpu_torch.benchmarks.kernels23_ab turns OLD_CSRC
    python -m grail_tpu_torch.benchmarks.kernels23_ab phases CSRC

OLD_CSRC and CSRC are directories holding a phase_q32_pre.cu with its
seq_freq.cuh and a synth_core.cu with the checkout's C interfaces (turns
also reads OLD_CSRC's fused_synth.cu), for example the parent commit's,
unpacked from git into a directory that .gitignore lists:

    git archive <commit> grail_tpu_torch/synth/csrc | tar -x -C build/old

Both modes build the sources they are given with nvcc and the package's
flags into build/grail_tpu_torch/ and run them at the kernels' main-path
shapes: kernel 2 on the split of bench.py's 64 texts (B = 64, voice generic)
and of the 2 s text "aea" (B = 1), kernel 3 on the first 4,096-sample block
of the core program's own streams for the same 64 texts, split (512 lanes)
and unsplit (64 lanes).

turns: launches the checkout's kernels and OLD_CSRC's on the same
arguments, checks that their outputs are bit-equal, then times them in the
order old, new, new, old (CUDA events around `reps` launches through the C
function, median of 5); for kernel 3 also the new kernel's rate in TB/s and
the rate at which PyTorch's reductions read the same seven streams; then
kernel 1's turns against OLD_CSRC's fused_synth.cu (kernel1_ab.turns),
which shares seq_freq.cuh with kernel 2.

phases: copies of CSRC's two kernels (either version: the anchors of both
are known), patched with clock64() stamps and built on their own, split the
cycles of a thread's work, averaged over the stamped threads. Kernel 2
(thread 0 of each block in the version that searches per sample, lane 0 of
each warp in the one that walks): the element search and the rest of the
chain per sample. Kernel 3, per chunk of steps: in the version that loads
into registers (thread 0 of each block) the loads, the recurrence, the
formant sum and its two barriers; in the ring's (consumer thread 0 and the
producer's lane 0 of each block) the consumer's wait for a full slot, its
recurrence, its release and barrier and its formant sum, and the
producer's wait for an empty slot and its copies' issue. The stamped
kernel's time is printed beside the unstamped one, with a record's
nanoseconds, the stamped launch's span on the device's clock (first start
to last end: a kernel time that no host launch rate limits) and the most
records one SM held at once.

One JSON line per shape, then one with all of them; every line names the
card (nvidia-smi's name and power limit).
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

import numpy as np
import torch

from ..synth import _build
from .kernel1_ab import _HEADER, _card, _load, _ms, _record

SOLO_TEXT = "aea"
NSLOT = 10   # per record: up to 6 cycle sums, units, SM id, start, end


def _argv(wrapper, fn: str, *args):
    """The C arguments `wrapper(*args)` passes to the library's `fn`, and
    its outputs (kept alive: the arguments point into them)."""
    return _record(_build.load_library(), fn, lambda: wrapper(*args))


def shapes(dev):
    """{name: (kernel, wrapper, args, reps)} at the main path's shapes (see
    the module doc); kernel 2 or 3."""
    import grail_tpu_torch as g
    import grail_tpu_torch.api as papi
    from ..synth import kernel as pk
    from ..synth import kernel_fused as kf

    out = {}
    voice = g.get_voice("generic")
    sr, inc = float(voice.sample_rate), voice.jitter_frequency
    texts = [("aeae" * 4)[:8 + (i % 8)] for i in range(64)]
    batch = papi._Batch([g.text_to_score(t) for t in texts], voice, None)
    solo = papi._Batch([g.text_to_score(SOLO_TEXT)], voice, None)
    for label, bt, reps in (("batch", batch, 20), ("aea", solo, 200)):
        _, _, S, T = g.route(len(bt.Ns), max(bt.Ns), None, dev, sr)
        tables = bt.tables(T, dev)
        pre, _ = papi._split_sched(inc, T, S, dev)
        B = tables.n.shape[0]
        out[f"pre {label} {B}x{T} S={S}"] = (
            2, kf.phase_q32_pre_cuda, (tables, *pre, T), reps)
    _, _, S, T = g.route(64, max(batch.Ns), None, dev, sr, "core")
    T_u = papi._round_up(max(batch.Ns), papi.BLOCK_SIZE)
    for setup in (papi._core_split_setup(batch.core_lanes(T, dev), T, S, sr,
                                         inc),
                  papi._core_unsplit_setup(batch.core_lanes(T_u, dev), T_u,
                                           sr, inc)):
        elems, _ = setup.frames(0)
        streams = pk.precompute_streams(elems, setup.state)[0]
        lp, b, c = (x.T.contiguous() for x in setup.state[1:4])
        L = lp.shape[1]
        out[f"core {L}x{streams[0].shape[0]}"] = (
            3, pk.synth_core_cuda, (streams, lp, b, c), 10)
    return out


_FN = {2: "grail_phase_q32_pre", 3: "grail_synth_core"}


def _outputs(kernel, args, argv, outs):
    """(argv, the tensors the C function writes). Kernel 2's wrapper
    returns a converted copy of its int32 sums, so the sums get a buffer of
    their own here, filled by one launch of the checkout's kernel."""
    if kernel != 2:
        return argv, outs
    tables, T = args[0], args[3]
    sums = torch.empty(tables.n.shape[0], T // 1024, dtype=torch.int32,
                       device=tables.n.device)
    argv = argv[:6] + (ctypes.c_void_p(sums.data_ptr()),) + argv[7:]
    lib = _build.load_library()
    _build.raise_on(lib, lib.grail_phase_q32_pre(*argv), "phase_q32_pre")
    return argv, (sums,)


def kernel_ms(kernel: int, wrapper, args, reps: int) -> float:
    """Kernel 2's or 3's own time at `args`: the C launch that `wrapper`
    makes, repeated `reps` times between two CUDA events (median of 5), so
    that the wrapper's host work does not count."""
    fn = _FN[kernel]
    argv, outs = _outputs(kernel, args, *_argv(wrapper, fn, *args))
    lib = _build.load_library()
    return _ms(lambda: getattr(lib, fn)(*argv), reps)


def turns(old_dir: Path):
    from . import kernel1_ab

    dev = torch.device("cuda", 0)
    card = _card()
    old = {2: _load(old_dir / "phase_q32_pre.cu", "libgrail_kernel2_old.so",
                    old_dir),
           3: _load(old_dir / "synth_core.cu", "libgrail_kernel3_old.so",
                    old_dir)}
    new = _build.load_library()
    res = {}
    for name, (kernel, wrapper, args, reps) in shapes(dev).items():
        fn = _FN[kernel]
        argv, outs = _outputs(kernel, args, *_argv(wrapper, fn, *args))
        torch.cuda.synchronize()
        want = [t.clone() for t in outs]
        if getattr(old[kernel], fn)(*argv) != 0:
            raise RuntimeError(f"{name}: the old kernel's launch failed")
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(outs, want))
        t = [_ms(lambda: getattr(lib, fn)(*argv), reps)
             for lib in (old[kernel], new, new, old[kernel])]
        r = {"kernel": kernel, "shape": name, "bit_equal": same,
             "old_ms": [t[0], t[3]], "new_ms": [t[1], t[2]],
             "new_over_old": (t[1] + t[2]) / (t[0] + t[3]), "card": card}
        if kernel == 3:
            # the rate the card reads the same streams at in PyTorch's own
            # reductions (each stream read once, contiguously), beside the
            # rate of the kernel's reads: streams, state in and out, audio
            streams = args[0]
            n_read = sum(x.numel() * 4 for x in streams)
            read_ms = _ms(lambda: [x.sum() for x in streams], reps)
            n_bytes = n_read + sum(x.numel() * 4 for x in outs[:1]) + \
                2 * sum(x.numel() * 4 for x in args[1:])
            r.update(read_ms=read_ms, read_tb_per_s=n_read / read_ms / 1e9,
                     new_tb_per_s=n_bytes / min(t[1], t[2]) / 1e9)
        res[name] = r
        print(json.dumps(r), flush=True)
        if not same:
            raise AssertionError(f"{name}: old and new outputs differ")
    res["kernel 1"] = kernel1_ab.turns(old_dir / "fused_synth.cu")
    return res


# The stamps of each version: (anchor in its source, text put before it,
# text put after it). A record holds cycle sums in slots 0-5, in slot 6 the
# units they cover (samples or chunks), then the SM and the globaltimer at
# the start and the end. A comparison with a value that never occurs makes a
# clock read wait for the load or result it names.
_PRE_SEARCH = (   # kernel 2, a binary search per sample, 4 samples a thread
    ('#include "seq_freq.cuh"\n', "", _HEADER),
    ("  __shared__ uint32_t s_warp[PRE_THREADS / 32];\n", "",
     "  unsigned long long acc_c[2] = {0, 0};\n"
     "  const unsigned long long g_start = gtime();\n"
     "  int nsm = 0, dummy = 0;\n"),
    ("    const int k = c * PRE_CHUNK + i;   // 0-based sample; k1 = k + 1\n",
     "",
     "    long long c_a = clock64();\n"
     "    {\n      int lo = 0, hi = E;\n      while (lo < hi) {\n"
     "        const int mid = (lo + hi) >> 1;\n"
     "        if (nb[mid] < k + 1) lo = mid + 1; else hi = mid;\n      }\n"
     "      dummy += lo;\n    }\n"
     "    long long c_b = clock64();\n"),
    ("    acc += __float2uint_rz(sq.freq_j * 4294967296.0f);\n", "",
     "    if (acc == 12345u) dummy += 1;\n"
     "    acc_c[0] += c_b - c_a;\n    acc_c[1] += clock64() - c_b;\n"
     "    ++nsm;\n"),
    ("    sums[(size_t)b * (T / PRE_CHUNK) + c] = tot;\n", "",
     "    const int rec = b * gridDim.x + c;\n"
     "    if (rec < 65536) {\n"
     "      g_clk[rec * 10 + 0] = acc_c[0];\n"
     "      g_clk[rec * 10 + 1] = acc_c[1];\n"
     "      g_clk[rec * 10 + 5] = dummy;\n"
     "      g_clk[rec * 10 + 6] = nsm;\n"
     "      g_clk[rec * 10 + 7] = smid();\n"
     "      g_clk[rec * 10 + 8] = g_start;\n"
     "      g_clk[rec * 10 + 9] = gtime();\n    }\n"),
)
_PRE_SEARCH_NAMES = ("search", "chain_after_search")

_PRE_WALK = (   # kernel 2, staged tables and a walking index
    ('#include "seq_freq.cuh"\n', "", _HEADER),
    ("  const int lane = threadIdx.x & 31;\n", "",
     "  const unsigned long long g_start = gtime();\n"
     "  const long long c_0 = clock64();\n  int dummy = 0;\n"),
    ("  const int k0 = c * PRE_CHUNK + ((w % wpc) * 32 + lane) * per;   "
     "// 0-based\n", "", "  const long long c_a = clock64();\n"),
    ("  uint32_t acc = 0;\n#pragma unroll 2\n",
     "  if (next == 12345) dummy += 1;\n"
     "  const long long c_b = clock64();\n", ""),
    ("#pragma unroll\n  for (int o = 16;",
     "  if (acc == 12345u) dummy += 1;\n"
     "  const long long c_c = clock64();\n"
     "  const int rec = (blockIdx.y * gridDim.x + blockIdx.x)\n"
     "      * (blockDim.x >> 5) + w;\n"
     "  if (lane == 0 && rec < 65536) {\n"
     "    g_clk[rec * 10 + 0] = c_b - c_a;\n"
     "    g_clk[rec * 10 + 1] = c_c - c_b;\n"
     "    g_clk[rec * 10 + 2] = c_a - c_0;\n"
     "    g_clk[rec * 10 + 5] = dummy;\n"
     "    g_clk[rec * 10 + 6] = per;\n"
     "    g_clk[rec * 10 + 7] = smid();\n"
     "    g_clk[rec * 10 + 8] = g_start;\n"
     "    g_clk[rec * 10 + 9] = gtime();\n  }\n", ""),
)
_PRE_WALK_NAMES = ("search", "walk_and_chain", "staging")

_AFTER_BAR = "    if (((volatile float*){})[0] == 12345.f) dummy += 1;\n"
_CORE_SYNC = (   # kernel 3, loads into registers, two barriers per chunk
    ("#define CT 16       // time steps per register chunk\n", "", _HEADER),
    ("  float lp = 0.f, bs = 0.f, cs = 0.f;\n", "",
     "  unsigned long long acc_c[5] = {0, 0, 0, 0, 0};\n"
     "  const unsigned long long g_start = gtime();\n"
     "  int nch = 0, dummy = 0;\n"),
    ("  for (int t0 = 0; t0 < T; t0 += CT) {\n", "",
     "    const long long c_a = clock64();\n"),
    ("#pragma unroll\n    for (int k = 0; k < CT; ++k) {\n      if (k < n) {\n"
     "        const float lpn",
     "    if (al[0] == 12345.f || a22[CT - 1] == 12345.f) dummy += 1;\n"
     "    const long long c_b = clock64();\n", ""),
    ("    __syncthreads();\n    for (int i = f * LANES + l;",
     "    if (bs == 12345.f) dummy += 1;\n"
     "    const long long c_c = clock64();\n", ""),
    ("    for (int i = f * LANES + l;",
     _AFTER_BAR.format("s_y") + "    const long long c_d = clock64();\n",
     ""),
    ("    __syncthreads();   // s_y is rewritten by the next chunk\n",
     "    const long long c_e = clock64();\n",
     _AFTER_BAR.format("s_y") + "    const long long c_f = clock64();\n"
     "    acc_c[0] += c_b - c_a; acc_c[1] += c_c - c_b;\n"
     "    acc_c[2] += c_d - c_c; acc_c[3] += c_e - c_d;\n"
     "    acc_c[4] += c_f - c_e; ++nch;\n"),
    ("  if (on) {\n    lp_out[si] = lp;\n",
     "  if (l == 0 && f == 0 && blockIdx.x < 65536) {\n"
     "    const int rec = blockIdx.x;\n"
     "    for (int i = 0; i < 5; ++i) g_clk[rec * 10 + i] = acc_c[i];\n"
     "    g_clk[rec * 10 + 5] = dummy;\n"
     "    g_clk[rec * 10 + 6] = nch;\n"
     "    g_clk[rec * 10 + 7] = smid();\n"
     "    g_clk[rec * 10 + 8] = g_start;\n"
     "    g_clk[rec * 10 + 9] = gtime();\n  }\n", ""),
)
_CORE_SYNC_NAMES = ("loads", "recurrence", "barrier_1", "formant_sum",
                    "barrier_2")

_CORE_RING = (   # kernel 3, two consumer warps and a producer warp
    ("#define SMEM_BYTES", _HEADER, ""),
    ("  if (TMA && p != 0) return;\n", "",
     "  unsigned long long pw = 0, pi = 0;\n"),
    ("    if (s >= NSTAGE) mbar_wait(empty + slot, (s / NSTAGE - 1) & 1);\n",
     "    const long long q0 = clock64();\n",
     "    const long long q1 = clock64();\n    pw += q1 - q0;\n"),
    ("      cp_async_arrive(full + slot);\n    }\n", "",
     "    pi += clock64() - q1;\n"),
    ("}\n\n// The recurrence over the n steps",
     "  if (p == 0 && blockIdx.x < 65536) {\n"
     "    g_clk[blockIdx.x * 10 + 4] = pw;\n"
     "    g_clk[blockIdx.x * 10 + 5] = pi;\n  }\n", ""),
    ("  const int nst = (T + CT - 1) / CT;\n", "",
     "  const unsigned long long g_start = gtime();\n  int dummy = 0;\n"),
    ("  float lp = 0.f, bs = 0.f, cs = 0.f;\n", "",
     "  unsigned long long acc_c[4] = {0, 0, 0, 0};\n  int nch = 0;\n"),
    ("    mbar_wait(full + slot, (s / NSTAGE) & 1);\n",
     "    const long long c_a = clock64();\n",
     "    if (((volatile float*)ring)[slot * STAGE_FLOATS + c] == 12345.f)\n"
     "      dummy += 1;\n    const long long c_b = clock64();\n"),
    ("    // the slot's values are all in registers and used: release it\n",
     "    if (bs == 12345.f) dummy += 1;\n"
     "    const long long c_c = clock64();\n", ""),
    ("    bar_consumers();\n", "",
     "    if (((volatile float*)sy)[c] == 12345.f) dummy += 1;\n"
     "    const long long c_d = clock64();\n"),
    ("        audio[(size_t)(t0 + k) * B + b0 + lo] = acc * 0.25f;\n"
     "      }\n    }\n", "",
     "    const long long c_e = clock64();\n"
     "    acc_c[0] += c_b - c_a; acc_c[1] += c_c - c_b;\n"
     "    acc_c[2] += c_d - c_c; acc_c[3] += c_e - c_d; ++nch;\n"),
    ("  if (on) {\n    lp_out[si] = lp;\n",
     "  if (c == 0 && blockIdx.x < 65536) {\n"
     "    const int rec = blockIdx.x;\n"
     "    for (int i = 0; i < 4; ++i) g_clk[rec * 10 + i] = acc_c[i];\n"
     "    g_clk[rec * 10 + 6] = nch + (dummy == 7777777);\n"
     "    g_clk[rec * 10 + 7] = smid();\n"
     "    g_clk[rec * 10 + 8] = g_start;\n"
     "    g_clk[rec * 10 + 9] = gtime();\n  }\n", ""),
)
_CORE_RING_NAMES = ("consumer_waits_full", "recurrence",
                    "release_and_barrier", "formant_sum",
                    "producer_waits_empty", "producer_issue")

SCHEDULES = {2: ((_PRE_SEARCH, _PRE_SEARCH_NAMES),
                 (_PRE_WALK, _PRE_WALK_NAMES)),
             3: ((_CORE_SYNC, _CORE_SYNC_NAMES),
                 (_CORE_RING, _CORE_RING_NAMES))}


def _stamped(src: str, kernel: int):
    """(stamped source, slot names) of whichever version of kernel 2 or 3
    `src` is; raises if it matches neither."""
    for table, names in SCHEDULES[kernel]:
        if all(src.count(anchor) == 1 for anchor, _, _ in table):
            break
    else:
        raise ValueError(f"phases: the source of kernel {kernel} has neither "
                         "version's anchors")
    for anchor, before, after in table:
        i = src.index(anchor)
        src = src[:i] + before + anchor + after + src[i + len(anchor):]
    return src + ("\nextern \"C\" int grail_phases_read(unsigned long long* "
                  "host, int nb) {\n  return (int)cudaMemcpyFromSymbol(host, "
                  "g_clk, (size_t)nb * 10 * 8);\n}\n"
                  "extern \"C\" int grail_phases_clear(void) {\n"
                  "  void* p;\n  cudaError_t e = cudaGetSymbolAddress(&p, "
                  "g_clk);\n  if (e == cudaSuccess) e = cudaMemset(p, 0, "
                  "sizeof(g_clk));\n  return (int)e;\n}\n"), names


def phases(src_dir: Path):
    dev = torch.device("cuda", 0)
    card = _card()
    libs = {}
    for kernel, fname in ((2, "phase_q32_pre.cu"), (3, "synth_core.cu")):
        text, names = _stamped((src_dir / fname).read_text(), kernel)
        stamped = _build.BUILD_DIR / f"kernel{kernel}_phases.cu"
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        stamped.write_text(text)
        libs[kernel] = (
            _load(src_dir / fname, f"libgrail_kernel{kernel}_src.so",
                  src_dir),
            _load(stamped, f"libgrail_kernel{kernel}_phases.so", src_dir),
            names)
    res = {}
    for name, (kernel, wrapper, args, reps) in shapes(dev).items():
        plain, lib, names = libs[kernel]
        fn = _FN[kernel]
        argv, _ = _outputs(kernel, args, *_argv(wrapper, fn, *args))
        ms = _ms(lambda: getattr(plain, fn)(*argv), reps)
        if lib.grail_phases_clear():
            raise RuntimeError("phases: clearing the stamps failed")
        ms_stamped = _ms(lambda: getattr(lib, fn)(*argv), reps)
        torch.cuda.synchronize()
        nrec = 65536
        buf = (ctypes.c_ulonglong * (nrec * NSLOT))()
        if lib.grail_phases_read(ctypes.cast(buf, ctypes.c_void_p), nrec):
            raise RuntimeError("phases: reading the stamps failed")
        a = np.frombuffer(buf, np.uint64).reshape(nrec, NSLOT).astype(float)
        a = a[a[:, 9] > 0]          # the records this launch wrote
        k = len(names)
        per = a[:, :k] / a[:, 6:7]
        # records one SM held at once: the most of one SM whose globaltimer
        # spans hold the median record's midpoint
        mid = np.median((a[:, 8] + a[:, 9]) / 2)
        live = (a[:, 8] <= mid) & (a[:, 9] >= mid)
        r = {"kernel": kernel, "shape": name, "ms": ms,
             "ms_stamped": ms_stamped, "records": int(len(a)),
             "unit": "sample" if kernel == 2 else "chunk",
             "cycles_per_unit": dict(zip(names, per.mean(0).tolist())),
             "record_ns": float((a[:, 9] - a[:, 8]).mean()),
             # the last stamped launch on the device's clock: its first
             # record's start to its last record's end
             "span_ns": float(a[:, 9].max() - a[:, 8].min()),
             "most_live_records_per_sm": int(np.bincount(
                 a[live, 7].astype(int)).max()) if live.any() else 0,
             "card": card}
        res[name] = r
        print(json.dumps(r), flush=True)
    return res


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2 or argv[0] not in ("turns", "phases"):
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernels23_ab: needs a CUDA device", file=sys.stderr)
        return 1
    torch.cuda.set_device(0)
    res = (turns if argv[0] == "turns" else phases)(Path(argv[1]).resolve())
    print(json.dumps({argv[0]: res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
