#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA GPU.

    python3 chip_smoke.py

Run it from the root of a checkout: it builds the kernels from the
checkout's sources (nvcc, into build/grail_tpu_torch/) and imports nothing
of JAX. Phases, one line each; any failure raises and exits non-zero:

  1. device — needs torch.cuda; prints nvidia-smi's name and power limit.
  2. build — compiles every source under grail_tpu_torch/synth/csrc/: the
     fused synthesizer (fused_synth.cu), the split's Q32 seam pre-pass
     (phase_q32_pre.cu), the core backend's recurrence (synth_core.cu),
     the issue-rate probe (fma_peak.cu) and the xla core's two f32
     recurrences (seq_scan.cu), one nvcc per source, all at once.
  3. kernel vs plain, unsplit — bench.py's 64 texts, voice generic,
     T = 65536, both carrier modes: final integer state bit-equal, audio
     < -100 dB per utterance and max-abs <= 1e-5 against the plain PyTorch
     version on the same card.
  4. main path — synthesize_batch(64 texts, device="cuda") must take the
     overlap-save split (S > 1, from the card's resident-block capacity)
     and launch both kernels; outputs finite, of length
     floor(cum_length[-1] * sr); two short utterances held against the CPU
     split at the same S at < -100 dB. Then synthesize() of a 2 s text
     alone: split too, both kernels launched, held against the CPU split.
     Then the unsplit route, synthesize_batch(64 texts, exact_carrier=True):
     S = 1, the fused kernel launched and the pre-pass not; two short
     utterances held against the CPU's exact carrier at < -100 dB.
  5. unsplit kernel vs plain and timing at the phase-4 texts (B = 64,
     T = round_up(maxN, 4096), seeds 0, Q32), as phase 3; the kernel's time
     (CUDA events, median of 5 after a warm-up) beside one plain run's.
  6. the split at the main path's shapes (B = 64, S and T as phase 4):
     the pre-pass kernel's [nb, B] seam phases bit-equal to its plain
     version's; each segment boundary's phase bit-equal to the final Q32
     state of unsplit kernel 1 run to that sample; split kernel 1 against
     its plain version over the S*B lanes as in phase 3; the split output
     against the unsplit Q32 program on the same tables (< -90 dB). Times
     of both kernels beside their plain versions'. Kernel 2's bound counts
     the function's own operations per sample (the chain, the Q32 sum and
     a compare and select that keep the element index), with the count
     that charged a binary search per sample printed beside it; its time
     is its own C launch repeated between two CUDA events, beside one
     wrapper call's (which counts the wrapper's host work too).
  7. end to end — host stages, synthesize_batch(64 texts) and
     synthesize(2 s text) wall times and aggregate x realtime, each beside
     the card's name and power limit.
  8. kernel 3 (synth_core.cu, the core backend's recurrence) against its
     plain version on the core program's own streams at the phase-4 texts,
     unsplit (64 lanes) and at the core route's split (S*64 lanes): the
     first 3 blocks of 4096 samples with the state carried, audio and final
     state bit-equal; its time per block (its C launch repeated, beside one
     wrapper call) beside one plain run and the bound; its launch geometry
     (blocks, threads, dynamic shared bytes, registers, blocks per SM,
     tensor copies or 4-byte cp.async).
  9. the core path — synthesize_batch(64 texts, device="cuda",
     backend="core") must launch synth_core and neither other kernel;
     outputs finite, of length floor(cum_length[-1] * sr); "ae","ea" held
     against the CPU's core program at the same S at < -100 dB. Then
     synthesize() of the 2 s text with backend="core", the same way.
 10. the core path's times: kernel 3 per block, and per call as the sum
     of CUDA-event times around each of its launches in one run of the
     core program (median of 5 runs), unsplit and at the core route's S;
     the core program; end to end.
 11. the serving path (runtime/stream.py, kernel 1's carry mode): the main
     path StreamPool(512, device="cuda"), voice plain, english, fed
     staggered texts over 44 ticks with 0.3 s lattice windows, so that
     every window slides; it must launch fused_synth_carry once per tick
     and no other kernel, give finite audio, and ticks 20-29 are held bit
     for bit (audio, sf, si) against the plain version on the card from
     the same state. Then at N = 128 and 512 (60 s windows, every session
     fed): a torch.profiler window of 20 steady-state ticks, after a
     warm-up step of the profiler, that must see the 20 launches and no
     host->device copy, and the times: the carry kernel per tick beside
     the plain version and the bound, _prepare_tick's fast path, full pass
     and full pass with one feed, read_block, the tick_pipelined period,
     read_blocks(8), each as a share of the 23.22 ms block budget.
 12. the FP32 issue-rate probe (fma_peak.cu), run right after the build
     because every operations bound below is stated against its result:
     both variants at 4,096 updates of the [256, 8, 128] tile, 8 grid steps;
     mul_add bit-equal to its plain version, fma within 4,096 ulps of it;
     both rates beside the data sheet's.
 13. the native carrier pre-pass and kernel 1's host_track mode: the host
     library built from native/*.cpp; the native track bit-equal to its
     plain numpy version on a short utterance; kernel 1 reading the track
     bit-equal (audio, sf, si) to its plain version on all the lanes of the
     long-form split (the 86.5 s text below).
 14. the solo long-form path at full width: an 86.5 s English text, voice
     plain, through cli.main(... -o wav -s) must route (kernel, track,
     S > 1) and launch fused_synth_track once and no other kernel; the WAV
     read back finite and of the expected length; synthesize() of the same
     text < -60 dB spectral error against the native oracle
     (pass_spectral_minus60) and within 5e-5 per 30 s of audio of the
     in-kernel recurrence's route (exact_carrier="kernel", S = 1). Times:
     the pre-pass cold and warm (it is memoized), the track's upload, the
     track route's program and kernel, the unsplit kcar kernel, end to
     end. Then one REPL line (interactive.main fed "hello") on the card.
 15. serve mode (StreamPool.serve_start / serve_tick / serve_stop), the
     served tick one replay of a CUDA graph captured on the frontend
     thread: at N = 512, then 128 (plain, english, block 1,024, 60 s
     windows, every session fed, pin_elems=64), 40 served ticks with the
     staggered feeds published by explicit _serve_build() calls, bit-equal
     (audio, sf, si) to a twin pool's read_block at every tick and ticks
     15-24 to the plain version from the same state; exactly one
     fused_synth_carry per served tick and no other kernel; a
     torch.profiler window of 20 steady served ticks that must see the 20
     launches and 0 host->device copies, with the device idle share beside
     phase 11's; serve_tick's host time per call (p50, p99 of 200), the
     graph replay, serve_tick and the eager tick by CUDA events,
     _serve_build with and without a feed; a paced run of 10 s at the
     23.22 ms block period with the frontend on its own period and a feed
     every 7 periods (the cadence of grail_tpu's benchmarks/latency.py):
     the frontend cycles, the captures (all on the frontend thread) and
     the deadline misses at sink depth 2, which must be 0; at N = 512 two
     more paced runs with a feed every period, the frontend on the host
     library and then on its Python and numpy twins, their misses
     printed, not gated.
 16. the xla and scan cores and the xla tick (seq_scan.cu, the two f32
     recurrences: carrier_scan and jsched_scan): both entry points
     bit-equal to their plain versions at [441, 512], [4096, 64] and one
     lane of 4,096 with the state carried over two calls, timed beside the
     plain loops and their bounds; synthesize_batch(64 texts,
     backend="xla") at full width (S = 1, T = 356,352, 87 blocks) launching
     no kernel on its Q32 carrier and carrier_scan once a block with
     exact_carrier="kernel", finite, each utterance within -60 dB of the
     fused route, "ae"/"ea"-style pairs against the CPU's xla route at
     < -100 dB, its end-to-end and program times beside the fused route's;
     synthesize("ae", backend="scan") against the CPU with its time; the
     xla tick at block 441 (10 ms): StreamPool(512) over 40 ticks with
     window slides, one carrier_scan and one jsched_scan per tick, ticks
     20-29 bit-equal to the plain recurrences; at N = 128 and 512 a
     profiler window of 20 steady ticks (both kernels each tick, 0
     host->device copies) and read_block as a share of the 10.0 ms
     budget; a block-1,024 xla pool within -60 dB of the fused pool; serve
     mode on the xla pool as phase 15 (20 served ticks bit-equal to a
     twin's read_block, replay times, a paced 10 s run at the 10 ms
     period, its deadline misses printed, not gated).
 17. dp x sp sharding (grail_tpu_torch/parallel/, no kernel): bench.py's 64
     texts at T = round_up(max N, 8192) = 360,448, Q32, through
     sharded_pipeline on four meshes, each a spawn of ranks
     (parallel/_ranks.chip_case) on cuda:0: (1, 1) over NCCL, held against
     the port's single-process xla program on the same batch (< -100 dB
     per utterance); (1, 2) and (1, 4) over gloo, ranks sharing the card
     (NCCL refuses two ranks on one card), against (1, 1) (< -100 dB,
     final seeds and phases bit-equal); (2, 1) over gloo, bit-equal to
     (1, 1). No rank launches a kernel. Per mesh: wall time per call, per
     rank the sp core's CUDA-event time, each gather's time, the peak of
     allocated device memory, and the torch ops per call; the shared-card
     meshes are labelled as such, not as a scaling figure.
 18. the native host tier (runtime/native.py: the host library built from
     native/*.cpp with this machine's g++, no kernel): at full width, the
     native transcriber on the 64 texts (generic) and the 86.5 s long_en
     text (english) equal to the Python automaton, the drift boundaries of
     their element lengths (counts and residual bits) equal to the numpy
     twin, and the jitter schedule window of the long-form route
     (3,814,268 samples, PhaseSchedule.window) bit-equal to the numpy
     twin. Times on the host clock, median of 5, native and numpy in turns
     in one process: each binding beside its twin on those inputs; the
     B = 64 host frontend by stage (transcription, intonation, drift
     boundaries, the score build, stacking and padding) and whole, with
     the host library and with the twins; StreamPool's first tick at N =
     128 and 512 (serving cell) with each. The numbers also go to
     chiprun_out/chip_smoke_native.json.
 19. the mesh-sharded pool (StreamPool(mesh=), parallel.
     sharded_stream_tick_fn; kernel 1's carry mode on each rank's
     sessions): the serving cell, N = 512, block 1,024, plain, english,
     every session fed, pin_elems=64, on meshes (1, 1) over NCCL and (2, 1)
     and (4, 1) over gloo, each a spawn of ranks
     (parallel/_ranks.pool_chip_case) that share cuda:0. The parent runs the
     unsharded pool once (20 ticks, save(), 3 ticks) and writes it to
     build/chip_smoke_pool_mesh/. Each rank: 20 eager ticks of its own
     rows bit-equal to the unsharded rows, three of them (audio, sf, si)
     bit-equal to the plain carry version on the same inputs, exactly one
     fused_synth_carry a tick and no other kernel, no host->card copy
     dispatched in ticks 2-19; save() (gathered over the mesh) equal to
     the unsharded blob array for array, the 3 ticks after it bit-equal,
     and on rank 0 the blob continuing bit-equal in an unsharded pool; 20
     served ticks (one counted replay each) bit-equal to a twin's
     read_block, with a feed to session 1 at tick 3 (grail_tpu's pattern).
     Per rank: feeding, the first tick (the host pass over its N / n_data
     sessions), steady read_block (host clock, median of 5), the tick and
     the served replay (CUDA events, median of 5); per mesh the spawn's
     wall time. Ranks that share one card and one host give no scaling
     figure. The numbers also go to chiprun_out/chip_smoke_pool_mesh.json.

Then one JSON line naming each kernel with its launches (its path's run),
error, times, bound and the shape they were taken at (fused_synth: the
split's, with the unsplit time beside it; synth_core: one launch of the
core route, with the per-call time and the unsplit launch beside it;
fused_synth_carry: one tick at N = 512, with N = 128 beside it,
phase 15's served numbers as served_*, and phase 19's launches per rank
per tick by mesh as mesh_launches_per_tick;
fused_synth_track: the long-form split's lanes; fma_peak: the mul_add
variant, with the fma variant beside it; carrier_scan and jsched_scan: the
xla tick's shape [441, 512], the xla batch's block [4096, 64] beside it,
launches from phase 16's tick main path); phase_q32_pre and synth_core
also carry their launch geometry with ptxas's registers per template
instance (`geometry`) and their wrapper call's time (`call_ms`). bound_ms states operations
against the card's peak FP32 instruction rate, 33.5e12 per second: half the
data sheet's 67 TFLOP/s, which counts an FMA as two, while the counts here
are one per instruction. bound_measured_ms states them against the mul_add
rate the probe measured in this run (measured_issue_rate), which moves with
the card's clocks. The last line is {"ok": true, "device": {...}}.

    python3 chip_smoke.py --scaling

adds, before the JSON lines, the unsplit kernel's time at B = 1 ... 1056
over the phase-5 T, the exact carrier's at B = 64, both fused-backend
kernels' times over the segment count S at B = 64 and at B = 1 (2 s), the
core program's and kernel 3's times over S at the same two batches, and
the host frontend split into text_to_phoneme_elems and
score_from_phoneme_elems; it also writes them to
chiprun_out/chip_smoke_scaling.json.
"""

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
B = 64
SCALING_B = (1, 64, 132, 264, 528, 1056)
SCALING_S = {64: (1, 2, 4, 8, 16), 1: (1, 8, 32, 64)}
T_CHECK = 65536
REPS = 5
TOL_DB = -100.0
TOL_ABS = 1e-5
SPLIT_TOL_DB = -90.0   # split against unsplit: the JAX suite's bound
SOLO_TEXT = "aea"      # 88,190 samples at 44.1 kHz: a 2 s utterance
SCALING_S_CORE = {64: (1, 2, 4, 8, 16, 32, 64), 1: (1, 8, 32, 64, 128)}
CORE_CHECK_BLOCKS = 3  # 4096-sample blocks of kernel 3 held against plain

# the bound of a kernel: the larger of its bytes (each input read once, each
# output written once) over the memory rate of one H100 SXM (NVIDIA's data
# sheet) and its operations over the card's peak FP32 instruction rate. The
# counts below are one per instruction, and the kernels are built with
# -fmad=false, so they issue a multiply and an add where the data sheet's
# 67 TFLOP/s counts one fused multiply-add as two operations: the rate that
# bounds them is half the data sheet's, 33.5e12 instructions per second
# (benchmarks/fma_peak.py's PEAK_FP32_INSTRUCTIONS). The
# rate the probe (phase 12) measures on this card for an unfused multiply +
# add is kept beside it, set before any bound is computed; it lies below the
# peak and moves with the clocks, so it is stated but bounds nothing.
MEM_BYTES_PER_S = 3.35e12
RATES = {"measured": None}        # the probe's mul_add instructions per s
# operations per lane-sample, counted from the sources (float and integer
# ops alike, at the float32 rate):
#  - synth_core.cu: per formant lp 2, b' 5, c' 5, b' + b 1; the 7-add
#    formant sum and the 0.25 product
CORE_OPS = 8 * 13 + 8
#  - seq_freq.cuh: ~18 for alpha, the pick and the pitch jitter, plus 3 per
#    step of the binary search over the element ends (see search_steps)
SEQ_OPS = 18
#  - fused_synth.cu beyond seq_freq: Q32 carrier and its warp scan ~10,
#    polyBLEP saw ~17, Lehmer noise ~8, jitter scales 3, output 9; per
#    formant ~75 feed-forward (5 picks, amplitude, jitter, breath, exp and
#    tan approximations with one division, the seven coefficients) and 13
#    in the recurrence
FUSED_OPS = 10 + 17 + 8 + 3 + 9 + 8 * (75 + 13)
#  - phase_q32_pre.cu beyond seq_freq: the Q32 scale, truncation and add
PRE_OPS = 3
#  - the element index as the function needs it, not as a kernel happens to
#    find it: the ends are non-decreasing in the sample, so one compare with
#    the next end and a select per sample keep the count (the binary search
#    per sample, 3 per step, is how kernel 1 and the first kernel 2 found it)
ELEM_OPS = 2
#  - fused_synth.cu's carry mode beyond FUSED_OPS: the jitter step (add,
#    compare, subtract, cell increment)
JITTER_OPS = 4
#  - fused_synth.cu's host_track mode: the Q32 scale, truncation, warp scan
#    and conversion (~10) give way to one load of the track
TRACK_OPS = FUSED_OPS - 10 + 1

# the solo long-form path (phases 13-14): benchmarks/fidelity_suite.py's
# long_en text, 86.5 s with the stub intonator (0.5 s per phoneme)
LONG_EN = ("the quick brown fox jumps over the lazy dog, while seventeen "
           "synthesizers hum along in the hall. is anyone still listening "
           "to this? the formants drift on and on.")
LONG_VOICE, LONG_LANGUAGE = "plain", "english"
TRACK_CHECK_TEXT = "hi"     # native track vs its plain numpy version
GATE_DB = -60.0             # the fidelity gate: spectral error vs the oracle
# track route vs the in-kernel recurrence: the two frequency chains' ulps
# add up over the f32 carrier recurrence, so the bound grows with length:
# 5e-5 per 30 s of audio (at least 5e-5); 4.64e-5 was read at 86.5 s
KCAR_ATOL_PER_30S = 5e-5
PROBE_ITERS = 4096

# the serving phase (StreamPool, kernel 1's carry mode): voice plain,
# language english, 1,024-sample blocks, every session fed text
SERVE_N = (128, 512)        # timed; the main path runs the last
SERVE_BLOCK = 1024
SERVE_TICKS = 44            # main-path ticks
SERVE_FEED_TICKS = 32       # odd sessions are fed 8 per tick over these
SERVE_CHECK = range(20, 30)  # main-path ticks held against the plain version
SLIDE_HORIZON_S = 0.3       # main path: lattice windows of 16 cells, so
#                             every session's window slides by tick ~29
PROFILE_TICKS = 20          # steady-state ticks under torch.profiler
PROFILE_ATTEMPTS = 3        # windows, if a trace misses counted launches
PROFILE_SETTLE_S = 0.1      # pause before the active window
PIPE_TICKS = 50             # tick_pipelined periods timed
READ_AHEAD = 8              # read_blocks(k)
# serve mode (phase 15): the serving cell at full width, N = 512 then 128,
# pin_elems = 64 (the cell's E), 60 s windows, every session fed as above
SERVED_TICKS = 40           # served ticks held against a twin's read_block
SERVED_PLAIN = range(15, 25)  # of them, held against the plain version
HOST_CALLS = 200            # serve_tick host times (p50, p99)
PACED_S = 10.0              # the paced run: real time held for 10 s,
FEED_EVERY = 7              # a feed every 7 block periods at most (the
#                             cadence of grail_tpu's benchmarks/latency.py,
#                             max(7, ceil(12 / (N * period))))
SINK_DEPTH = 2              # tick k's audio is due k + 2 block periods in
# phase 16: the xla tick at 10 ms blocks (441 samples at 44.1 kHz, the frame
# of real-time voice stacks such as WebRTC's 10 ms audio callback), the
# serving cell's texts and widths otherwise
XLA_BLOCK = 441
XLA_TICKS = 80              # main-path ticks: 0.8 s, so that 0.3 s windows
#                             slide (from ~0.5 s on: a window holds at least
#                             16 cells)
XLA_CHECK = tuple(range(20, 30)) + tuple(range(70, 80))   # against plain
XLA_SERVED_TICKS = 20       # served ticks held against a twin's read_block
XLA_SERVED_PLAIN = range(10, 20)
XLA_VS_FUSED_TICKS = 20     # block-1,024 ticks, xla pool against fused pool
# phase 17, dp x sp sharding (grail_tpu_torch/parallel/): the B = 64 texts
# at T = round_up(max N, SP_ALIGN), Q32, each mesh in its own spawn of ranks
# that all use cuda:0 (NCCL refuses two ranks on one card: the one-rank mesh
# runs over NCCL, the shared ones over gloo)
SP_ALIGN = 8192
SP_MESHES = ((1, 1, "nccl"), (1, 2, "gloo"), (1, 4, "gloo"), (2, 1, "gloo"))
SP_REPS = 3                 # timed calls per rank
SP_TIMEOUT = 600.0          # seconds per spawn
SP_DP_DB = -130.0           # (2, 1) against (1, 1), if not bit-equal
# phase 19, the mesh-sharded pool: the serving cell (N = 512, block 1,024,
# pin_elems = 64) on each mesh, a spawn of ranks sharing cuda:0 (NCCL for
# the one-rank mesh, gloo for the shared ones, as phase 17)
POOL_MESHES = ((1, 1, "nccl"), (2, 1, "gloo"), (4, 1, "gloo"))
POOL_MESH_TICKS = 20        # eager ticks held against the unsharded pool,
#                             and served ticks against a twin's read_block
POOL_MESH_PLAIN = (10, 11, 12)  # of them, held against the plain version
POOL_MESH_CONT = 3          # ticks after save(), in either pool
POOL_MESH_TIMEOUT = 300.0   # seconds per spawn
SEQ_SHAPES = ((441, 512), (4096, 64))   # [T, lanes]: the tick, the batch
SEQ_REPS = 50               # launches between two events, seq_scan's own time
# seq_scan.cu per lane-sample: the carrier's add, compare, subtract and
# select; the jitter phase's add, compare, subtract, select and cell add
CARRIER_OPS = 4
JSCHED_OPS = 5
SERVE_TEXTS = (              # each opens on a vowel, so it sounds early
    "all good things come to those who wait",
    "every call is important to us",
    "i am here to help you today",
    "open the door and come in please",
    "a formant synthesizer speaks in many voices",
    "our office hours are nine to five",
    "all lines are busy right now",
    "each voice can change its pitch",
)


def bench_texts():
    """bench.py's batch: 64 texts of 8-15 characters ("aeae...")."""
    return [("aeae" * 4)[: 8 + (i % 8)] for i in range(B)]


def search_steps(E):
    """Steps of the kernels' binary search over E element ends."""
    return int(E).bit_length()


def ptxas_registers(log, name):
    """{entry: registers} from a ptxas log for the kernels whose mangled
    name holds `name` (one entry per template instance)."""
    out, entry = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry is not None and name in entry:
            out[entry] = int(m.group(1))
            entry = None
    return out


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def carry_tick_bytes(ins, si0, si1, blk):
    """The bytes one carry tick must move, from this run's data: the audio
    written, the carried rows (sf, si) read and written, offsets, lat_base,
    par and the Lehmer tables read, and per lane only the lattice rows its
    cells reach (each cell's row and the next, from the cell in si0 to the
    one in si1) and the score elements its samples reach (those ending in
    the tick, plus the one it ends in and the next), with 4 B per step of
    the search over the element ends."""
    from grail_tpu_torch.synth import kernel_fused as kf

    n_tab, W = ins["n"], ins["lat"][0].shape[1]
    N, E = n_tab.shape
    row_b = sum(x[0, 0].numel() * x.element_size() for x in ins["lat"])
    elem_b = sum(x[0, 0].numel() * x.element_size()
                 for x in (n_tab, ins["scal"], ins["vec"]))
    r0, r1 = ((s[:, 4] - ins["lat_base"]).clamp(0, W - 2)
              for s in (si0, si1))
    rows = int((r1 - r0 + 2).sum())
    off = ins["offsets"]
    ends = [(n_tab < (off + k)[:, None]).sum(dim=1) for k in (0, blk)]
    elems = int((ends[1] - ends[0] + 2).clamp(max=E).sum())
    return (N * blk * 4 + 2 * nbytes(ins["sf"], si0) + nbytes(
        off, ins["lat_base"], ins["par"], kf._lehmer_table(off.device))
        + rows * row_b + elems * elem_b + N * 4 * search_steps(E))


def bound(n_bytes, ops):
    """(bound_ms, bound_by, bound_measured_ms) of a kernel that must move
    n_bytes and issue ops instructions: against the card's peak instruction
    rate, and against the probe's measured mul_add rate beside it."""
    from grail_tpu_torch.benchmarks.fma_peak import PEAK_FP32_INSTRUCTIONS

    t_bytes = n_bytes / MEM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_INSTRUCTIONS * 1e3
    measured = max(t_bytes, ops / RATES["measured"] * 1e3)
    if t_bytes >= t_ops:
        return t_bytes, "bytes", measured
    return t_ops, "operations", measured


def launches_ms(fn, n):
    """fn() repeated n times between two CUDA events, per call: the median
    of REPS such windows, after one warm-up window."""
    import torch

    times = []
    for k in range(REPS + 1):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n):
            if fn() != 0:
                raise RuntimeError("a kernel launch failed")
        e1.record()
        torch.cuda.synchronize()
        if k:
            times.append(e0.elapsed_time(e1) / n)
    return statistics.median(times)


def median_ms(fn, reps=REPS):
    """Median CUDA-event time of fn() over `reps` runs, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def once_ms(fn):
    """(result, CUDA-event time in ms) of one run of fn()."""
    import torch

    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1)


def host_ms(fn, sync=False):
    """Median host-clock time of fn() over REPS runs, after one warm-up."""
    import torch

    times = []
    for _ in range(REPS + 1):
        t0 = time.perf_counter()
        fn()
        if sync:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def main():
    if not os.path.isdir(os.path.join(ROOT, "grail_tpu_torch")):
        sys.exit("chip_smoke.py: no grail_tpu_torch/ beside this script; run "
                 "it from the root of a checkout of the repository")
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    # ---- 1: device -----------------------------------------------------
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch finds no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"[1 device] {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; {torch.cuda.device_count()} device(s)",
          flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- 2: build ------------------------------------------------------
    from grail_tpu_torch.synth import _build

    t0 = time.perf_counter()
    _build.load_library()
    ptxas = [ln.strip() for ln in _build.build_info["log"].splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    from grail_tpu_torch.synth.kernel_fused import fused_synth_geometry

    geo = fused_synth_geometry(dev)
    print(f"[2 build] {os.path.relpath(_build.build_info['path'], ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc, all sources at once, "
          f"{_build.build_info['seconds']:.2f} s); {'; '.join(ptxas)}; "
          f"fused_synth launch: {geo['threads']} threads per block, "
          f"{geo['dynamic_smem']} B dynamic + {geo['static_smem']} B static "
          f"shared, {geo['registers']} registers, {geo['blocks_per_sm']} "
          f"blocks per SM", flush=True)

    import grail_tpu_torch as g
    import grail_tpu_torch.api as papi
    from grail_tpu_torch.api import BLOCK_SIZE, WARMUP, _round_up
    from grail_tpu_torch.benchmarks import kernels23_ab as k23
    from grail_tpu_torch.synth import kernel_fused as kf

    regs = {name: ptxas_registers(_build.build_info["log"], name)
            for name in ("phase_q32_pre_kernel", "synth_core_kernel")}
    print(f"[2 build] ptxas registers by entry: {regs}", flush=True)
    from grail_tpu_torch.synth.schedule import device_window
    from grail_tpu_torch.utils import sample_error_db

    def drive(label, fn, expect):
        """Run one path with every launch count set to 0 just before it;
        returns (outputs, launch counts) and fails unless exactly the
        kernels in `expect` were launched (each at least once)."""
        for k in kf.LAUNCHES:
            kf.LAUNCHES[k] = 0
        outs = fn()
        torch.cuda.synchronize()
        counts = dict(kf.LAUNCHES)
        if any((n >= 1) != (k in expect) for k, n in counts.items()):
            raise AssertionError(f"{label} launched {counts}, expected "
                                 f"exactly {sorted(expect)}")
        return outs, counts

    # ---- 12: the FP32 issue-rate probe (before every bound) -------------
    probe = probe_phase(card, dev, drive)

    texts = bench_texts()
    voice = g.get_voice("generic")
    sr = float(voice.sample_rate)
    inc = voice.jitter_frequency

    def frontend():   # what synthesize_batch runs on the host per batch
        return [g.text_to_score(t) for t in texts]

    def batch_for(scores):
        # seed 0 for every utterance, as synthesize_batch defaults to
        return papi._Batch(scores, voice, None)

    def zero_state(nb=B):
        return (torch.zeros(nb, 24, dtype=torch.float32, device=dev),
                torch.zeros(nb, 3, dtype=torch.int32, device=dev))

    def check(label, k, r):
        """Kernel output k against plain output r, both (audio, sf, si):
        integer state bit-equal, audio < TOL_DB per lane and max-abs
        <= TOL_ABS, filter state max-abs <= TOL_ABS. Returns max-abs."""
        (a, sf_k, si_k), (p, sf_r, si_r) = k, r
        torch.cuda.synchronize()
        if not torch.equal(si_k, si_r):
            raise AssertionError(f"{label}: integer state differs: "
                                 f"{si_k[:2].tolist()} vs {si_r[:2].tolist()}")
        a, p = a.cpu().numpy(), p.cpu().numpy()
        if not np.isfinite(a).all():
            raise AssertionError(f"{label}: non-finite kernel output")
        err = float(np.abs(a - p).max())
        db = max(sample_error_db(a[b], p[b]) for b in range(len(a)))
        sf_err = float((sf_k - sf_r).abs().max())
        if not (err <= TOL_ABS and db < TOL_DB and sf_err <= TOL_ABS):
            raise AssertionError(f"{label}: kernel vs plain max-abs {err}, "
                                 f"worst {db} dB, state {sf_err}")
        print(f"[kernel vs plain] {label}: integer state bit-equal; audio "
              f"max-abs {err}, worst lane {db} dB, filter state "
              f"max-abs {sf_err}, bit-equal samples "
              f"{float((a == p).mean())}", flush=True)
        return err

    def against_cpu(label, on_card, on_cpu):
        """The card's outputs against the CPU's on the same route."""
        dbs = [sample_error_db(a.cpu().numpy(), b.numpy())
               for a, b in zip(on_card, on_cpu)]
        if not all(a.shape == b.shape for a, b in zip(on_card, on_cpu)) \
                or not all(d < TOL_DB for d in dbs):
            raise AssertionError(f"{label}: cuda vs cpu {dbs} dB")
        return dbs

    def check_outputs(label, outs, Ns):
        for o, n in zip(outs, Ns):
            if o.device.type != "cuda" or tuple(o.shape) != (n,):
                raise AssertionError(f"{label}: output {tuple(o.shape)} on "
                                     f"{o.device}, expected ({n},) on cuda")
            if not bool(torch.isfinite(o).all()):
                raise AssertionError(f"{label}: non-finite output")

    def against_cpu_split(label, text_list, on_card, S):
        """The card's outputs against the CPU's split at the same S."""
        scores = [g.text_to_score(t) for t in text_list]
        return against_cpu(label, on_card, papi._synthesize_split(
            scores, voice, S=S, device="cpu"))

    # ---- 3: unsplit kernel vs plain on the card ------------------------
    scores = frontend()
    batch = batch_for(scores)
    tables = batch.tables(T_CHECK, dev)
    phi, cell = device_window(inc, 0, T_CHECK, dev)
    sf, si = zero_state()
    max_abs = 0.0
    for kcar in (False, True):
        args = (tables, phi, cell, sf, si, T_CHECK, kcar)
        max_abs = max(max_abs, check(
            f"[3] carrier={'kcar' if kcar else 'q32'} B={B} T={T_CHECK}",
            kf.fused_synth_cuda(*args), kf.synth_fused_reference(*args)))

    # ---- 4: the main path ----------------------------------------------
    Ns = batch.Ns
    slots = kf.fused_synth_slots(dev)
    _, _, S, T_split = g.route(B, max(Ns), None, dev, sr)
    if S < 2:
        raise AssertionError(f"route picked S={S} for the {B} texts")
    both = {"fused_synth", "phase_q32_pre"}
    outs, launches = drive("synthesize_batch",
                           lambda: g.synthesize_batch(texts, device="cuda"),
                           both)
    check_outputs("synthesize_batch", outs, Ns)
    short = ["ae", "ea"]
    s_short = g.route(2, max(papi._Batch([g.text_to_score(t) for t in short],
                                         voice, None).Ns),
                      None, dev, sr)[2]
    db_cpu = against_cpu_split("'ae','ea'", short,
                               g.synthesize_batch(short, device="cuda"),
                               s_short)
    audio_s = sum(Ns) / sr
    print(f"[4 main path] synthesize_batch({B} texts, device='cuda'): "
          f"slots {slots} (resident blocks of fused_synth on this card), "
          f"S={S}, T={T_split}, {S * B} lanes of {T_split // S + WARMUP} "
          f"samples; launches {launches}; {B} finite outputs of "
          f"floor(cum_length[-1]*sr) samples, {audio_s:.3f} s of audio; "
          f"'ae','ea' (S={s_short}) cuda vs cpu split {db_cpu} dB",
          flush=True)
    solo_score = g.text_to_score(SOLO_TEXT)
    solo_n = papi._Batch([solo_score], voice, None).Ns[0]
    _, _, s_solo, t_solo = g.route(1, solo_n, None, dev, sr)
    if s_solo < 2:
        raise AssertionError(f"route picked S={s_solo} for {SOLO_TEXT!r}")
    solo, solo_launches = drive(
        "synthesize", lambda: g.synthesize(SOLO_TEXT, device="cuda"), both)
    check_outputs("synthesize", [solo], [solo_n])
    db_solo = against_cpu_split(repr(SOLO_TEXT), [SOLO_TEXT], [solo], s_solo)
    print(f"[4 main path] synthesize({SOLO_TEXT!r}, device='cuda'), "
          f"{solo_n / sr:.3f} s: S={s_solo}, T={t_solo}; launches "
          f"{solo_launches}; cuda vs cpu split {db_solo} dB", flush=True)
    # the unsplit route: the exact carrier (also the automatic choice past
    # EXACT_CARRIER_AUTO_SECONDS) cannot split, so it launches kernel 1 alone
    route_x = g.route(B, max(Ns), True, dev, sr)
    if route_x[1:3] != ("kcar", 1):
        raise AssertionError(f"exact carrier routed as {route_x}")
    outs_x, launches_x = drive(
        "synthesize_batch exact_carrier",
        lambda: g.synthesize_batch(texts, device="cuda", exact_carrier=True),
        {"fused_synth"})
    check_outputs("synthesize_batch exact_carrier", outs_x, Ns)
    db_x = against_cpu(
        "'ae','ea' exact carrier",
        g.synthesize_batch(short, device="cuda", exact_carrier=True),
        g.synthesize_batch(short, device="cpu", exact_carrier=True))
    del outs_x
    print(f"[4 main path] synthesize_batch({B} texts, device='cuda', "
          f"exact_carrier=True): unsplit (S=1, T={route_x[3]}, carrier "
          f"kcar); launches {launches_x}; {B} finite outputs; 'ae','ea' "
          f"cuda vs cpu (both unsplit, kcar) {db_x} dB", flush=True)

    # ---- 5: unsplit kernel vs plain, and timing, at the phase-4 texts ---
    T = _round_up(max(Ns), BLOCK_SIZE)
    tables = batch.tables(T, dev)
    phi, cell = device_window(inc, 0, T, dev)
    args = (tables, phi, cell, sf, si, T, False)
    unsplit_ms = median_ms(lambda: kf.fused_synth_cuda(*args))
    k_out = kf.fused_synth_cuda(*args)
    r_out, unsplit_plain_ms = once_ms(lambda: kf.synth_fused_reference(*args))
    max_abs = max(max_abs, check(f"[5] unsplit carrier=q32 B={B} T={T}",
                                 k_out, r_out))
    del k_out, r_out, tables
    print(f"[5 timing] fused_synth unsplit B={B} T={T} q32: kernel "
          f"{unsplit_ms} ms (CUDA events, median of {REPS}), plain PyTorch "
          f"{unsplit_plain_ms} ms (CUDA events, one run); card {card}",
          flush=True)

    # ---- 6: the split at the main path's shapes --------------------------
    split = split_inputs(papi, kf, batch, T_split, S, dev)
    tables, pre, T_ = split["tables"], split["pre"], T_split
    q_k = kf.phase_q32_pre_block(tables, pre, T_, BLOCK_SIZE, "kernel")
    q_p, pre_plain_ms = once_ms(lambda: kf.phase_q32_pre_block(
        tables, pre, T_, BLOCK_SIZE, "plain"))
    if not torch.equal(q_k, q_p):
        bad = int((q_k != q_p).sum())
        raise AssertionError(f"[6] phase_q32_pre: {bad} seam phases differ")
    # the kernel's own time: its C launch repeated between two events; one
    # wrapper call between two events also counts the wrapper's host work
    pre_ms = k23.kernel_ms(2, kf.phase_q32_pre_cuda, (tables, *pre, T_), 20)
    pre_call_ms = median_ms(lambda: kf.phase_q32_pre_cuda(tables, *pre, T_))
    E_, W_ = tables.n.shape[1], tables.latp.shape[1]
    pre_bytes = (nbytes(tables.n, tables.scal, tables.latp, tables.par)
                 + T_ * 8 + B * (T_ // kf.CHUNK_PRE) * 4)
    pre_bound = bound(pre_bytes, B * T_ * (SEQ_OPS + ELEM_OPS + PRE_OPS))
    # the count before it was restated: a binary search per sample
    pre_bound_search = bound(
        pre_bytes, B * T_ * (SEQ_OPS + 3 * search_steps(E_) + PRE_OPS))
    pre_geo = kf.phase_q32_pre_geometry(B, E_, W_, T_, dev)
    pre_geo["ptxas_registers"] = regs["phase_q32_pre_kernel"]
    print(f"[6 split] phase_q32_pre B={B} T={T_} E={E_} W={W_}: "
          f"[{T_ // BLOCK_SIZE}, {B}] seam phases bit-equal to plain; kernel "
          f"{pre_ms} ms (20 launches per event pair, median of 5; one "
          f"wrapper call {pre_call_ms} ms), plain PyTorch {pre_plain_ms} ms "
          f"(one run); bound {bound_text(pre_bound)} at "
          f"{SEQ_OPS + ELEM_OPS + PRE_OPS} operations a sample (counted with "
          f"a binary search per sample, {SEQ_OPS + 3 * search_steps(E_) + PRE_OPS}: "
          f"{pre_bound_search[0]} ms); launch {pre_geo}; card {card}",
          flush=True)
    sf0, si0 = zero_state()
    for s in range(1, S):
        n = s * (T_ // S) - WARMUP
        _, _, si_n = kf.fused_synth_cuda(tables, pre[0][:n], pre[1][:n], sf0,
                                         si0, n, False)
        want = kf._u32_to_i32(q_k[n // BLOCK_SIZE])
        if not torch.equal(si_n[:, 0], want):
            raise AssertionError(f"[6] seam {s} (sample {n}): unsplit "
                                 f"kernel 1's Q32 phase differs from the "
                                 f"pre-pass's")
    print(f"[6 split] seams: at each of the {S - 1} segment boundaries "
          f"s*Ts - W the pre-pass's phase equals unsplit fused_synth's final "
          f"Q32 state bit for bit", flush=True)
    L, Text = S * B, T_ // S + WARMUP
    sargs = split["args"]
    tables_t, phi_s, _, sf_s, si_s = sargs[:5]
    fused_bound = bound(
        nbytes(*tables_t, sf_s, si_s, split["g0"]) + phi_s.shape[0] * Text * 8
        + L * Text * 4 + nbytes(sf_s, si_s),
        L * Text * (SEQ_OPS + 3 * search_steps(tables_t.n.shape[1])
                    + FUSED_OPS))
    split_ms = median_ms(lambda: kf.fused_synth_cuda(*sargs,
                                                     g0=split["g0"]))
    k_out = kf.fused_synth_cuda(*sargs, g0=split["g0"])
    r_out, split_plain_ms = once_ms(lambda: kf.synth_fused_reference(
        *sargs, g0=split["g0"]))
    max_abs = max(max_abs, check(f"[6] split carrier=q32 {L} lanes x {Text}",
                                 k_out, r_out))
    del k_out, r_out
    program_ms = median_ms(lambda: papi._split_program(tables, T_, S,
                                                       "kernel", inc))
    out_split = papi._split_program(tables, T_, S, "kernel", inc)
    out_unsplit = kf.fused_synth_cuda(tables, *pre, sf0, si0, T_, False)[0]
    a, r = out_split.cpu().numpy(), out_unsplit.cpu().numpy()
    dbs = [sample_error_db(a[b, :n], r[b, :n]) for b, n in enumerate(Ns)]
    err_su = max(float(np.abs(a[b, :n] - r[b, :n]).max())
                 for b, n in enumerate(Ns))
    if not max(dbs) < SPLIT_TOL_DB:
        raise AssertionError(f"[6] split vs unsplit: worst {max(dbs)} dB")
    print(f"[6 split] fused_synth split {L} lanes x {Text}: kernel "
          f"{split_ms} ms (median of {REPS}), plain PyTorch {split_plain_ms} "
          f"ms (one run); split program (pre-pass + tiling + kernel) "
          f"{program_ms} ms; split vs unsplit Q32 on the same tables: worst "
          f"utterance {max(dbs)} dB, max-abs {err_su}; kernel 1's bound "
          f"{bound_text(fused_bound)}; card {card}", flush=True)
    del split, tables, out_split, out_unsplit
    torch.cuda.empty_cache()

    # ---- 7: end to end ---------------------------------------------------
    front_ms = host_ms(frontend)
    upload_ms = host_ms(lambda: batch.tables(T_split, dev), sync=True)
    e2e_ms = host_ms(lambda: g.synthesize_batch(texts, device="cuda"),
                     sync=True)
    solo_ms = host_ms(lambda: g.synthesize(SOLO_TEXT, device="cuda"),
                      sync=True)
    print(f"[7 timing] host frontend {front_ms} ms, lattices + table build "
          f"and upload {upload_ms} ms; end-to-end synthesize_batch {e2e_ms} "
          f"ms for {audio_s:.3f} s of audio: aggregate "
          f"{audio_s / (e2e_ms / 1e3)} x realtime end to end, "
          f"{audio_s / (program_ms / 1e3)} x realtime in the split program; "
          f"synthesize({SOLO_TEXT!r}) {solo_ms} ms for {solo_n / sr:.3f} s, "
          f"{solo_n / sr / (solo_ms / 1e3)} x realtime; card {card}",
          flush=True)

    # ---- 8: kernel 3 (the core backend) against its plain version ------
    from grail_tpu_torch.synth import kernel as pk

    _, _, S_core, T_core = g.route(B, max(Ns), None, dev, sr, "core")
    setups = {"unsplit": (B, T, papi._core_unsplit_setup(
        batch.core_lanes(T, dev), T, sr, inc))}
    if S_core > 1:
        setups["split"] = (S_core * B, T_core, papi._core_split_setup(
            batch.core_lanes(T_core, dev), T_core, S_core, sr, inc))
    core = {}
    for label, (L_c, T_c, setup) in setups.items():
        core[label] = core_check(f"[8] {label}", setup, L_c, T_c, card)
    core_main = core["split" if S_core > 1 else "unsplit"]
    del setups
    torch.cuda.empty_cache()

    # ---- 9: the core backend's main path -------------------------------
    def core_cpu(text_list, S_):
        scores_ = [g.text_to_score(t) for t in text_list]
        if S_ > 1:
            return papi._synthesize_split(scores_, voice, S=S_, device="cpu",
                                          backend="core")
        return g.synthesize_scores(scores_, voice, device="cpu",
                                   backend="core")

    outs_c, launches_c = drive(
        "synthesize_batch backend=core",
        lambda: g.synthesize_batch(texts, device="cuda", backend="core"),
        {"synth_core"})
    check_outputs("synthesize_batch backend=core", outs_c, Ns)
    del outs_c
    s_short_c = g.route(2, max(papi._Batch([g.text_to_score(t)
                                            for t in short], voice,
                                           None).Ns),
                        None, dev, sr, "core")[2]
    db_core = against_cpu(
        "'ae','ea' core",
        g.synthesize_batch(short, device="cuda", backend="core"),
        core_cpu(short, s_short_c))
    print(f"[9 core path] synthesize_batch({B} texts, device='cuda', "
          f"backend='core'): at most {pk.CORE_MAX_LANES} lanes, "
          f"S={S_core}, T={T_core}, "
          f"{core_main['lanes']} lanes of {core_main['nb']} blocks; launches "
          f"{launches_c}; {B} finite outputs of floor(cum_length[-1]*sr) "
          f"samples; 'ae','ea' (S={s_short_c}) cuda vs cpu core {db_core} dB",
          flush=True)
    _, _, s_solo_c, t_solo_c = g.route(1, solo_n, None, dev, sr, "core")
    solo_c, solo_launches_c = drive(
        "synthesize backend=core",
        lambda: g.synthesize(SOLO_TEXT, device="cuda", backend="core"),
        {"synth_core"})
    check_outputs("synthesize backend=core", [solo_c], [solo_n])
    db_solo_c = against_cpu(f"{SOLO_TEXT!r} core", [solo_c],
                            core_cpu([SOLO_TEXT], s_solo_c))
    print(f"[9 core path] synthesize({SOLO_TEXT!r}, device='cuda', "
          f"backend='core'): S={s_solo_c}, T={t_solo_c}; launches "
          f"{solo_launches_c}; cuda vs cpu core {db_solo_c} dB", flush=True)

    # ---- 10: the core backend's times ----------------------------------
    lanes_c = batch.core_lanes(T_core, dev)
    core_program_ms, core_call_ms, core_calls = time_core_program(
        core_program(papi, lanes_c, T_core, S_core, sr, inc))
    lanes_c = batch.core_lanes(T, dev)
    _, unsplit_call_ms, unsplit_calls = time_core_program(
        core_program(papi, lanes_c, T, 1, sr, inc))
    del lanes_c
    torch.cuda.empty_cache()
    core_e2e_ms = host_ms(lambda: g.synthesize_batch(
        texts, device="cuda", backend="core"), sync=True)
    core_solo_ms = host_ms(lambda: g.synthesize(
        SOLO_TEXT, device="cuda", backend="core"), sync=True)
    print(f"[10 core timing] kernel 3 per block ({core_main['lanes']} lanes "
          f"x {BLOCK_SIZE}) {core_main['ms']} ms (its C launch, 10 per event "
          f"pair, median of 5), per "
          f"call {core_call_ms} ms (the sum over its {core_calls} launches "
          f"in one core program run, median of {REPS} runs); unsplit per "
          f"block ({B} lanes) {core['unsplit']['ms']} ms, per call "
          f"{unsplit_call_ms} ms ({unsplit_calls} launches); core program "
          f"(S={S_core}) {core_program_ms} ms; end-to-end synthesize_batch backend='core' "
          f"{core_e2e_ms} ms for {audio_s:.3f} s of audio, "
          f"{audio_s / (core_e2e_ms / 1e3)} x realtime; synthesize("
          f"{SOLO_TEXT!r}, backend='core') {core_solo_ms} ms; card {card}",
          flush=True)

    # ---- 11: the serving path (kernel 1's carry mode) -------------------
    serve = serving(card, dev, drive)
    s512, s128 = (serve["by_n"][n] for n in SERVE_N[::-1])

    # ---- 13-14: the solo long-form route --------------------------------
    lf = long_form(card, dev, drive, check)

    # ---- 15: serve mode (the served tick as a CUDA graph) ----------------
    served = serve_mode(card, dev, drive, serve, dense=(SERVE_N[-1],))
    v512, v128 = (served["by_n"][n] for n in SERVE_N[::-1])

    # ---- 16: seq_scan.cu, the xla and scan cores, the xla tick ----------
    seq = seq_scan_phase(card, dev, g.get_voice("plain").jitter_frequency)
    xb = xla_batch_phase(card, dev, drive, texts, voice, e2e_ms)
    xt = xla_tick_phase(card, dev, drive)
    xs = serve_mode(card, dev, drive, xt, blk=XLA_BLOCK, backend="xla",
                    ticks=XLA_SERVED_TICKS, plain_ticks=XLA_SERVED_PLAIN,
                    tag="16 xla serve mode", gate=False)
    x512, x128 = (xs["by_n"][n] for n in SERVE_N[::-1])
    seq_tick, seq_blk = (seq[shape] for shape in SEQ_SHAPES)

    # ---- 17: dp x sp sharding (parallel/sharded.py) ----------------------
    sharding_phase(card, dev, texts, voice)

    # ---- 18: the native host tier (runtime/native.py) ---------------------
    native_tier_phase(card, texts)

    # ---- 19: the mesh-sharded pool (StreamPool(mesh=)) ---------------------
    pool_mesh = pool_mesh_phase(card)

    if "--scaling" in sys.argv[1:]:
        scaling(texts, batch, T, card, zero_state, dev)

    def seq_entry(name, key, replaces, launches, extra):
        """One seq_scan.cu entry point's line: at the tick's shape, with
        the xla batch's block shape beside it."""
        b1, b2 = seq_tick[f"{key}_bound"], seq_blk[f"{key}_bound"]
        return dict({
            "name": name, "route": "cuda",
            "source": "grail_tpu_torch/synth/csrc/seq_scan.cu",
            "replaces": replaces, "replaces_kind": "lax.scan, no Pallas "
            "kernel", "launches": launches,
            "max_abs_err": max(seq_tick[f"{key}_max_abs"],
                               seq_blk[f"{key}_max_abs"]),
            "ms": seq_tick[f"{key}_ms"], "plain_ms":
            seq_tick[f"{key}_plain_ms"], "bound_ms": b1[0], "bound_by": b1[1],
            "bound_measured_ms": b1[2], "library_ms": None,
            "call_ms": seq_tick[f"{key}_call_ms"],
            "shape": list(SEQ_SHAPES[0]),
            "block_ms": seq_blk[f"{key}_ms"],
            "block_plain_ms": seq_blk[f"{key}_plain_ms"],
            "block_bound_ms": b2[0], "block_shape": list(SEQ_SHAPES[1])},
            **extra)

    xla_extra = {
        "tick_launches": xt["launches"],
        "tick_ms_n512": xt["by_n"][512]["tick_ms"],
        "tick_ms_n128": xt["by_n"][128]["tick_ms"],
        "plain_tick_ms_n512": xt["by_n"][512]["plain_tick_ms"],
        "read_block_ms_n512": xt["by_n"][512]["read_block_ms"],
        "read_block_ms_n128": xt["by_n"][128]["read_block_ms"],
        "tick_budget_ms": xt["budget_ms"],
        "idle_share_n512": xt["by_n"][512]["idle_share"],
        "served_replay_ms_n512": x512["replay_ms"],
        "served_host_p50_ms_n512": x512["host_p50_ms"],
        "served_host_p99_ms_n512": x512["host_p99_ms"],
        "served_misses_n512": x512["misses"],
        "served_replay_ms_n128": x128["replay_ms"],
        "served_misses_n128": x128["misses"]}

    # ms/plain_ms are at `shape` [lanes, samples per lane]: the split's for
    # fused_synth, whose unsplit time at the same texts is unsplit_ms
    print(json.dumps({"kernels": [
        {"name": "fused_synth", "route": "cuda",
         "source": "grail_tpu_torch/synth/csrc/fused_synth.cu",
         "replaces": "grail_tpu/synth/kernel_fused.py:420",
         "launches": launches["fused_synth"], "max_abs_err": max_abs,
         "ms": split_ms, "plain_ms": split_plain_ms,
         "bound_ms": fused_bound[0], "bound_by": fused_bound[1],
         "bound_measured_ms": fused_bound[2],
         "library_ms": None, "shape": [L, Text],
         "unsplit_ms": unsplit_ms, "unsplit_plain_ms": unsplit_plain_ms,
         "unsplit_shape": [B, T]},
        {"name": "phase_q32_pre", "route": "cuda",
         "source": "grail_tpu_torch/synth/csrc/phase_q32_pre.cu",
         "replaces": "grail_tpu/synth/kernel_fused.py:1009",
         "launches": launches["phase_q32_pre"],
         "max_abs_err": float((q_k - q_p).abs().max()),
         "ms": pre_ms, "plain_ms": pre_plain_ms,
         "bound_ms": pre_bound[0], "bound_by": pre_bound[1],
         "bound_measured_ms": pre_bound[2],
         "bound_ms_binary_search": pre_bound_search[0],
         "call_ms": pre_call_ms,
         "library_ms": None, "shape": [B, T_], "geometry": pre_geo},
        {"name": "synth_core", "route": "cuda",
         "source": "grail_tpu_torch/synth/csrc/synth_core.cu",
         "replaces": "grail_tpu/synth/kernel.py:85",
         "launches": launches_c["synth_core"],
         "max_abs_err": core_main["max_abs"],
         "ms": core_main["ms"], "call_ms": core_main["call_ms"],
         "plain_ms": core_main["plain_ms"],
         "bound_ms": core_main["bound"][0],
         "bound_by": core_main["bound"][1],
         "bound_measured_ms": core_main["bound"][2], "library_ms": None,
         "shape": [BLOCK_SIZE, core_main["lanes"]],
         "per_call_ms": core_call_ms, "blocks": core_calls,
         "unsplit_ms": core["unsplit"]["ms"],
         "unsplit_per_call_ms": unsplit_call_ms,
         "unsplit_plain_ms": core["unsplit"]["plain_ms"],
         "unsplit_bound_ms": core["unsplit"]["bound"][0],
         "unsplit_shape": [BLOCK_SIZE, B],
         "geometry": dict(core_main["geometry"],
                          ptxas_registers=regs["synth_core_kernel"]),
         "unsplit_geometry": core["unsplit"]["geometry"]},
        {"name": "fused_synth_carry", "route": "cuda",
         "source": "grail_tpu_torch/synth/csrc/fused_synth.cu",
         "replaces": "grail_tpu/synth/kernel_fused.py:420",
         "launches": serve["launches"], "max_abs_err": serve["max_abs"],
         "ms": s512["kernel_ms"], "plain_ms": s512["plain_ms"],
         "bound_ms": s512["bound_ms"], "bound_by": s512["bound_by"],
         "bound_measured_ms": s512["bound_measured_ms"],
         "library_ms": None, "shape": [SERVE_N[-1], SERVE_BLOCK],
         "per": "tick", "device_ms": s512["kernel_device_ms"],
         "n128_ms": s128["kernel_ms"],
         "n128_device_ms": s128["kernel_device_ms"],
         "n128_plain_ms": s128["plain_ms"],
         "n128_bound_ms": s128["bound_ms"],
         "read_blocks8_kernel_ms": s512["read_blocks8_kernel_ms"],
         "read_blocks8_host_ms": s512["read_blocks8_ms"],
         "served_launches": served["launches"],
         "served_max_abs_err": v512["max_abs"],
         "served_replay_ms": v512["replay_ms"],
         "served_tick_ms": v512["tick_ms"],
         "served_eager_ms": v512["eager_ms"],
         "served_host_p50_ms": v512["host_p50_ms"],
         "served_host_p99_ms": v512["host_p99_ms"],
         "served_idle_share": v512["idle_share"],
         "read_block_idle_share": v512["read_block_idle_share"],
         "served_capture_ms": v512["capture_p50_ms"],
         "served_build_fed_ms": v512["build_fed_ms"],
         "served_misses_depth2": v512["misses_depth2"],
         "served_feed_every_period_misses": v512["dense_misses"],
         "n128_served_replay_ms": v128["replay_ms"],
         "n128_served_host_p50_ms": v128["host_p50_ms"],
         "n128_served_host_p99_ms": v128["host_p99_ms"],
         "n128_served_idle_share": v128["idle_share"],
         "n128_served_misses_depth2": v128["misses_depth2"],
         "mesh_launches_per_tick": {
             tag: [r["launches_per_tick"] for r in m["ranks"]]
             for tag, m in pool_mesh["meshes"].items()}},
        {"name": "fused_synth_track", "route": "cuda",
         "source": "grail_tpu_torch/synth/csrc/fused_synth.cu",
         "replaces": "grail_tpu/synth/kernel_fused.py:420",
         "launches": lf["launches"], "max_abs_err": lf["max_abs"],
         "ms": lf["kernel_ms"], "plain_ms": lf["plain_ms"],
         "bound_ms": lf["bound"][0], "bound_by": lf["bound"][1],
         "bound_measured_ms": lf["bound"][2], "library_ms": None,
         "shape": lf["shape"], "program_ms": lf["program_ms"],
         "kcar_unsplit_ms": lf["kcar_ms"],
         "kcar_unsplit_shape": [1, lf["T_kcar"]],
         "spectral_error_db": lf["spectral_db"],
         "pass_spectral_minus60": lf["pass_spectral_minus60"]},
        {"name": "fma_peak", "route": "cuda",
         "source": "grail_tpu_torch/synth/csrc/fma_peak.cu",
         "replaces": "benchmarks/vpu_peak.py:44",
         "launches": probe["launches"], "max_abs_err": probe["max_abs"],
         "ms": probe["mul_add"]["ms"], "plain_ms": probe["plain_ms"],
         "bound_ms": probe["bound"][0], "bound_by": probe["bound"][1],
         "bound_measured_ms": probe["bound"][2], "library_ms": None,
         "shape": probe["shape"], "variant": "mul_add",
         "measured_issue_rate": probe["mul_add"]["instructions_per_s"],
         "peak_issue_rate": probe["peak_issue_rate"],
         "peak_share": probe["mul_add"]["peak_share"],
         "datasheet_share": probe["mul_add"]["datasheet_share"],
         "fma_ms": probe["fma"]["ms"],
         "fma_bound_ms": probe["fma_bound_ms"],
         "fma_instructions_per_s": probe["fma"]["instructions_per_s"],
         "fma_peak_share": probe["fma"]["peak_share"],
         "fma_datasheet_share": probe["fma"]["datasheet_share"],
         "fma_max_abs_err": probe["fma_max_abs"]},
        seq_entry("carrier_scan", "carrier",
                  "grail_tpu/synth/synthesize.py:182", xt["launches"],
                  dict(xla_extra, batch_kcar_launches=xb["launches"],
                       xla_program_kcar_ms=xb["program_kcar_ms"],
                       xla_program_ms=xb["program_ms"],
                       fused_program_ms=xb["fused_program_ms"],
                       xla_e2e_ms=xb["e2e_ms"],
                       xla_vs_fused_db=xb["db_fused"],
                       scan_ae_ms=xb["scan_ms"])),
        seq_entry("jsched_scan", "jsched",
                  "grail_tpu/runtime/stream.py:207", xt["launches"],
                  xla_extra)]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


def bound_text(b):
    """A bound (see `bound`) for a printed line."""
    from grail_tpu_torch.benchmarks.fma_peak import PEAK_FP32_INSTRUCTIONS

    return (f"{b[0]} ms ({b[1]}; operations at the card's peak "
            f"{PEAK_FP32_INSTRUCTIONS:.4g} instructions/s; {b[2]} ms at "
            f"the measured mul_add rate {RATES['measured']:.4g}/s)")


def probe_phase(card, dev, drive):
    """Phase 12: the FP32 issue-rate probe (benchmarks/fma_peak.py). Both
    variants at PROBE_ITERS updates of the [256, 8, 128] tile over 8 grid
    steps, held against the plain version at the same iters (mul_add bit
    for bit, fma within PROBE_ITERS ulps of a value below 2); then the
    timed launches, with the launch counts set to 0 just before. Sets the
    measured rate that every bound is stated beside."""
    import numpy as np
    import torch

    from grail_tpu_torch.benchmarks import fma_peak as fp

    rng = np.random.default_rng(12)
    x = torch.from_numpy((1.0 + 0.5 * rng.random(fp.TILE))
                         .astype(np.float32)).to(dev)
    plain, plain_ms = once_ms(lambda: fp.fma_peak_reference(
        x, fp.GRID, PROBE_ITERS))
    out = fp.fma_peak(x, fp.GRID, PROBE_ITERS, "mul_add")
    fused = fp.fma_peak(x, fp.GRID, PROBE_ITERS, "fma")
    torch.cuda.synchronize()
    max_abs = float((out - plain).abs().max())
    fma_abs = float((fused - plain).abs().max())
    if not torch.equal(out, plain):
        raise AssertionError(f"[12 probe] mul_add differs from the plain "
                             f"version (max-abs {max_abs})")
    if not (fma_abs <= PROBE_ITERS * 2.0 ** -22
            and bool(torch.isfinite(fused).all())):
        raise AssertionError(f"[12 probe] fma vs plain max-abs {fma_abs}")
    m, counts = drive("fma_peak probe",
                      lambda: fp.measure(iters=PROBE_ITERS, device=dev),
                      {"fma_peak"})
    RATES["measured"] = m["mul_add"]["instructions_per_s"]
    # the mul_add variant must round twice per update, so its work is two
    # instructions; the fma variant's is one
    bnd, fma_bnd = (bound(nbytes(x, out), fp.instructions(
        x.numel(), fp.GRID, PROBE_ITERS, v)) for v in fp.VARIANTS)
    m.update(launches=counts["fma_peak"], max_abs=max_abs,
             fma_max_abs=fma_abs, plain_ms=plain_ms,
             shape=[fp.GRID, x.numel()], bound=bnd, fma_bound_ms=fma_bnd[0],
             peak_issue_rate=fp.PEAK_FP32_INSTRUCTIONS)
    print(f"[12 probe] fma_peak, tile {list(fp.TILE)} x {fp.GRID} grid steps "
          f"x {PROBE_ITERS} updates x = x*a + b: mul_add bit-equal to the "
          f"plain version, fma max-abs {fma_abs} from it; launches {counts}; "
          f"mul_add (FMUL + FADD) {m['mul_add']['ms']} ms, "
          f"{m['mul_add']['instructions_per_s']:.6g} instructions/s "
          f"({m['mul_add']['peak_share']:.4f} of the card's peak "
          f"{fp.PEAK_FP32_INSTRUCTIONS:.4g} instructions/s; = FLOP/s, "
          f"{m['mul_add']['datasheet_share']:.4f} of the data sheet's "
          f"{fp.DATASHEET_FP32_FLOPS:.3g}); fma (FFMA) "
          f"{m['fma']['ms']} ms, {m['fma']['instructions_per_s']:.6g} "
          f"instructions/s ({m['fma']['peak_share']:.4f} of the peak), "
          f"{m['fma']['flops_per_s']:.6g} FLOP/s "
          f"({m['fma']['datasheet_share']:.4f} of the data sheet's); CUDA "
          f"events, median of {fp.REPS}; plain PyTorch {plain_ms} ms (one "
          f"run); the probe's own bound {bound_text(bnd)}, the fma "
          f"variant's {fma_bnd[0]} ms; every kernel's operations bound uses "
          f"the peak rate, with the measured one beside it; card {card}",
          flush=True)
    return m


def long_form(card, dev, drive, check):
    """Phases 13 and 14: the native carrier pre-pass, kernel 1's host_track
    mode against its plain version on the long-form split's own lanes, and
    the solo long-form path from the command line to a WAV, held against the
    native oracle and the in-kernel recurrence. Returns the numbers of the
    fused_synth_track entry."""
    import io
    import tempfile

    import numpy as np
    import torch

    import grail_tpu_torch as g
    import grail_tpu_torch.api as papi
    from grail_tpu_torch import cli, interactive
    from grail_tpu_torch.api import BLOCK_SIZE, WARMUP, _round_up
    from grail_tpu_torch.oracle import native as onat
    from grail_tpu_torch.runtime import native as rnat
    from grail_tpu_torch.runtime.wav import load_wav
    from grail_tpu_torch.synth import kernel_fused as kf
    from grail_tpu_torch.synth.schedule import device_window
    from grail_tpu_torch.utils import sample_error_db, spectral_error_db
    from grail_tpu_torch.voices import get_spec

    # ---- 13: the host library, the pre-pass, the host_track mode --------
    t0 = time.perf_counter()
    rnat.load_library()
    print(f"[13 native] {os.path.relpath(rnat.build_info['path'], ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s (host compiler, "
          f"{' '.join(rnat.CXXFLAGS)})", flush=True)
    spec = get_spec(LONG_VOICE)
    pel = g.text_to_phoneme_elems(TRACK_CHECK_TEXT, LONG_VOICE, LONG_LANGUAGE)
    ref = onat.carrier_phase_track_reference(pel, spec, 0)
    for name, nat in (
            ("the oracle's", onat.native_carrier_phase_track(pel, spec, 0)),
            ("the port's", rnat.native_carrier_track(pel, spec, 0))):
        if nat.shape != ref.shape or not np.array_equal(
                nat.view(np.uint32), ref.view(np.uint32)):
            raise AssertionError(f"[13] {name} native carrier track differs "
                                 "from its plain version")
    print(f"[13 native] carrier track of {TRACK_CHECK_TEXT!r} "
          f"({len(ref)} samples): the oracle's and the port's native "
          f"pre-pass bit-equal to the plain numpy version", flush=True)

    voice = g.get_voice(LONG_VOICE)
    sr, inc = float(voice.sample_rate), voice.jitter_frequency
    pelems = g.text_to_phoneme_elems(LONG_EN, voice, LONG_LANGUAGE)
    score = papi.score_from_phoneme_elems(pelems, voice)
    batch = papi._Batch([score], voice, [0])
    N = batch.Ns[0]
    papi._carrier_cache.clear()
    t0 = time.perf_counter()
    track = papi._carrier_track_for(pelems, voice, 0)
    pre_cold_ms = (time.perf_counter() - t0) * 1e3
    pre_warm_ms = host_ms(lambda: papi._carrier_track_for(pelems, voice, 0))
    impl, carrier, S, T = g.route(1, N, None, dev, sr, track=True)
    if (impl, carrier) != ("kernel", "track") or S < 2:
        raise AssertionError(f"[13] long-form routed {(impl, carrier, S, T)}")
    tables = batch.tables(T, dev)
    upload_ms = host_ms(lambda: papi._split_carrier(track, T, S, dev),
                        sync=True)
    tables_t, seg, state, q, g0, car = papi._split_lanes(
        tables, T, S, "kernel", inc, track)
    sf, si = kf.state_rows(state, q)
    Text = T // S + WARMUP
    args = (tables_t, seg[0], seg[1], sf, si, Text, False)
    kw = dict(g0=g0, carrier=car)
    k_out = kf.fused_synth_cuda(*args, **kw)
    r_out, plain_ms = once_ms(lambda: kf.synth_fused_reference(*args, **kw))
    max_abs = check(f"[13] host_track {S} lanes x {Text}", k_out, r_out)
    for name, x, y in zip(("audio", "sf", "si"), k_out, r_out):
        if not torch.equal(x, y):
            raise AssertionError(f"[13] host_track: the kernel's {name} "
                                 f"differs from the plain version's")
    del k_out, r_out
    kernel_ms = median_ms(lambda: kf.fused_synth_cuda(*args, **kw))
    program_ms = median_ms(lambda: papi._split_program(
        tables, T, S, "kernel", inc, track))
    bnd = bound(
        nbytes(*tables_t, sf, si, g0) + (WARMUP + T) * 12 + S * Text * 4
        + nbytes(sf, si),
        S * Text * (SEQ_OPS + 3 * search_steps(tables_t.n.shape[1])
                    + TRACK_OPS))
    T1 = _round_up(N, BLOCK_SIZE)
    tables1 = batch.tables(T1, dev)
    phi1, cell1 = device_window(inc, 0, T1, dev)
    sf1 = torch.zeros(1, 24, dtype=torch.float32, device=dev)
    si1 = torch.zeros(1, 3, dtype=torch.int32, device=dev)
    kcar_ms = median_ms(lambda: kf.fused_synth_cuda(
        tables1, phi1, cell1, sf1, si1, T1, True))
    print(f"[13 host_track] {LONG_VOICE}/{LONG_LANGUAGE}, {N} samples "
          f"({N / sr:.3f} s): route (kernel, track, S={S}, T={T}), {S} lanes "
          f"of {Text} samples; kernel 1 reading the track bit-equal to its "
          f"plain version (audio, sf, si); kernel {kernel_ms} ms (CUDA "
          f"events, median of {REPS}), plain PyTorch {plain_ms} ms (one "
          f"run), bound {bound_text(bnd)}; track route's program (track "
          f"upload + tiling + kernel) {program_ms} ms; the unsplit kcar "
          f"kernel for the same utterance (1 lane x {T1}) {kcar_ms} ms; "
          f"native pre-pass {pre_cold_ms} ms cold, {pre_warm_ms} ms warm "
          f"(memoized), {N / sr / (pre_cold_ms / 1e3)} x realtime cold; "
          f"track upload ({(WARMUP + T) * 4} bytes from pinned memory) "
          f"{upload_ms} ms; card {card}", flush=True)
    del tables, tables_t, tables1, car, seg
    torch.cuda.empty_cache()

    # ---- 14: the command line to a WAV, at full width ---------------------
    build_dir = os.path.dirname(rnat.build_info["path"])
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        wav = os.path.join(tmp, "long.wav")

        def cli_run():
            rc = cli.main(["-v", LONG_VOICE, "-l", LONG_LANGUAGE, "-o", wav,
                           "-s", LONG_EN])
            if rc != 0:
                raise AssertionError(f"[14] the CLI exited with {rc}")

        _, counts = drive("cli long-form", cli_run, {"fused_synth_track"})
        if counts["fused_synth_track"] != 1:
            raise AssertionError(f"[14] the CLI launched {counts}")
        pcm, wav_sr = load_wav(wav)
        repl_wav = os.path.join(tmp, "repl.wav")
        stdin = sys.stdin
        sys.stdin = io.StringIO("hello\n")
        try:
            (_, repl_counts) = drive(
                "interactive", lambda: interactive.main(
                    ["-o", repl_wav, "--block", "1024"]),
                {"fused_synth_carry"})
        finally:
            sys.stdin = stdin
        repl, _ = load_wav(repl_wav)
    if wav_sr != int(sr) or len(pcm) != N or not np.isfinite(pcm).all():
        raise AssertionError(f"[14] WAV: {len(pcm)} samples at {wav_sr} Hz, "
                             f"expected {N} at {int(sr)}")
    if not (np.isfinite(repl).all() and np.abs(repl).max() > 0.01):
        raise AssertionError("[14] the REPL's output is silent or not finite")

    audio = g.synthesize(LONG_EN, LONG_VOICE, LONG_LANGUAGE)
    a = audio.cpu().numpy()
    if a.shape != (N,) or float(np.abs(a - pcm).max()) > 1.5 / 32767:
        raise AssertionError("[14] the WAV is not synthesize()'s audio")
    gold = onat.gold_dsp_chain(pelems, spec, 0)
    spectral_db = spectral_error_db(a, gold)
    sample_db = sample_error_db(a, gold)
    pass_spectral_minus60 = bool(spectral_db < GATE_DB)
    if not pass_spectral_minus60:
        raise AssertionError(f"[14] spectral error {spectral_db} dB against "
                             f"the oracle: the gate is {GATE_DB}")
    route_k = g.route(1, N, "kernel", dev, sr)
    if route_k[1:3] != ("kcar", 1):
        raise AssertionError(f"[14] exact_carrier='kernel' routed {route_k}")
    kcar, _ = drive("synthesize exact_carrier='kernel'", lambda: g.synthesize(
        LONG_EN, LONG_VOICE, LONG_LANGUAGE, exact_carrier="kernel"),
        {"fused_synth"})
    kcar_err = float((audio - kcar).abs().max())
    kcar_atol = KCAR_ATOL_PER_30S * max(1.0, N / sr / 30.0)
    if not kcar_err <= kcar_atol:
        raise AssertionError(f"[14] track route vs kcar route: max-abs "
                             f"{kcar_err} > {kcar_atol}")
    kcar_db = spectral_error_db(kcar.cpu().numpy(), gold)

    def synth(**kwargs):
        return g.synthesize(LONG_EN, LONG_VOICE, LONG_LANGUAGE, **kwargs)

    def cold():
        papi._carrier_cache.clear()
        synth()

    e2e_warm_ms = host_ms(synth, sync=True)
    e2e_cold_ms = host_ms(cold, sync=True)
    e2e_kcar_ms = host_ms(lambda: synth(exact_carrier="kernel"), sync=True)
    front_ms = host_ms(lambda: papi.score_from_phoneme_elems(
        g.text_to_phoneme_elems(LONG_EN, voice, LONG_LANGUAGE), voice))
    print(f"[14 long-form] cli.main(-v {LONG_VOICE} -l {LONG_LANGUAGE} -o "
          f"long.wav -s <{len(LONG_EN)} characters>): route (kernel, track, "
          f"S={S}, T={T}); launches {counts}; WAV read back: {len(pcm)} "
          f"finite samples at {wav_sr} Hz ({N / sr:.3f} s), within one PCM "
          f"step of synthesize()'s audio; against the native oracle "
          f"(gold_dsp_chain, {len(gold)} samples): spectral error "
          f"{spectral_db} dB, sample error {sample_db} dB, "
          f"pass_spectral_minus60 {pass_spectral_minus60}; against the kcar "
          f"route (exact_carrier='kernel', S=1, launches fused_synth) "
          f"max-abs {kcar_err} (atol {kcar_atol}: {KCAR_ATOL_PER_30S} per "
          f"30 s), whose own spectral error "
          f"is {kcar_db} dB; REPL: interactive.main fed 'hello' on the "
          f"card, launches {repl_counts}, {len(repl)} finite samples", 
          flush=True)
    print(f"[14 timing] synthesize(<{N / sr:.3f} s>), host clock with a "
          f"final synchronize, median of {REPS}: track route {e2e_warm_ms} "
          f"ms with the pre-pass memoized (warm), {e2e_cold_ms} ms with the "
          f"memo emptied before each run (cold: the pre-pass runs), "
          f"{N / sr / (e2e_cold_ms / 1e3)} x realtime cold; kcar route "
          f"(unsplit) {e2e_kcar_ms} ms; of it the host frontend (text -> "
          f"score) {front_ms} ms; card {card}", flush=True)
    return dict(launches=counts["fused_synth_track"], max_abs=max_abs,
                kernel_ms=kernel_ms, plain_ms=plain_ms, bound=bnd,
                shape=[S, Text], program_ms=program_ms, kcar_ms=kcar_ms,
                T_kcar=T1, spectral_db=spectral_db,
                pass_spectral_minus60=pass_spectral_minus60)


def core_check(label, setup, lanes, T, card):
    """Kernel 3 against its plain version on a core program's own streams:
    the first CORE_CHECK_BLOCKS blocks of `setup`, the state carried from
    the kernel's output; audio and final state must be bit-equal. Then the
    kernel's time per block (CUDA events, median of REPS) beside one run of
    the plain version and the bound. Returns those numbers and the largest
    absolute difference (0.0 when bit-equal) of audio and state."""
    import torch

    from grail_tpu_torch.api import BLOCK_SIZE
    from grail_tpu_torch.synth import kernel as pk
    from grail_tpu_torch.synth.synthesize import SynthState

    state = setup.state
    n_check = min(CORE_CHECK_BLOCKS, setup.nb)
    max_abs = 0.0
    for i in range(n_check):
        elems, _ = setup.frames(i)
        streams, phase, seed = pk.precompute_streams(elems, state)
        lp, b, c = (x.T.contiguous() for x in state[1:4])
        k = pk.synth_core_cuda(streams, lp, b, c)
        r, plain_ms = once_ms(lambda: pk.synth_core_reference(streams, lp, b,
                                                              c))
        for name, x, y in zip(("audio", "lp", "b", "c"), k, r):
            max_abs = max(max_abs, float((x - y).abs().max()))
            if not torch.equal(x, y):
                raise AssertionError(
                    f"{label} block {i}: kernel 3's {name} differs from the "
                    f"plain version's (max-abs {float((x - y).abs().max())})")
        if not bool(torch.isfinite(k[0]).all()):
            raise AssertionError(f"{label} block {i}: non-finite audio")
        state = SynthState(phase=phase, filter_state_a=k[1].T,
                           filter_state_b=k[2].T, filter_state_c=k[3].T,
                           seed=seed)
    from grail_tpu_torch.benchmarks import kernels23_ab as k23

    # the kernel's own time (its C launch repeated between two events) and
    # one wrapper call's, which counts the wrapper's host work too
    ms = k23.kernel_ms(3, pk.synth_core_cuda, (streams, lp, b, c), 10)
    call_ms = median_ms(lambda: pk.synth_core_cuda(streams, lp, b, c))
    bnd = bound(nbytes(*streams, lp, b, c) + BLOCK_SIZE * lanes * 4
                + nbytes(lp, b, c), BLOCK_SIZE * lanes * CORE_OPS)
    geo = pk.synth_core_geometry(lanes, streams[0].device)
    out = {"lanes": lanes, "nb": setup.nb, "T": T, "ms": ms,
           "call_ms": call_ms, "plain_ms": plain_ms, "max_abs": max_abs, "bound": bnd,
           "geometry": geo}
    print(f"{label}: synth_core {lanes} lanes x {BLOCK_SIZE} samples, "
          f"{n_check} blocks with the state carried: audio and final lp, b, "
          f"c bit-equal to the plain version; kernel {ms} ms per block "
          f"(10 launches per event pair, median of 5; one wrapper call "
          f"{call_ms} ms); plain PyTorch {plain_ms} ms per block (one "
          f"run); bound {bound_text(bnd)}; launch {geo}; card {card}",
          flush=True)
    return out


def core_program(papi, lanes, T, S, sr, inc):
    """The core program on the card over `lanes` at S segments (S = 1:
    unsplit), as synthesize_scores runs it; a function of no arguments."""
    if S > 1:
        return lambda: papi._core_split_program(lanes, T, S, sr, inc,
                                                 "kernel")
    return lambda: papi._core_run(papi._core_unsplit_setup(lanes, T, sr, inc),
                                  "kernel")


def time_core_program(program):
    """(program ms, kernel 3 ms, kernel 3 launches) of a core program: the
    medians over REPS runs, after a warm-up, of the CUDA-event time around
    the whole of program() and of the sum of the CUDA-event times around
    each call of kernel 3's wrapper in it, and the launches in one run."""
    import torch

    from grail_tpu_torch.synth import kernel as pk

    wrapper = pk.IMPLEMENTATIONS["kernel"]
    events = []

    def timed(*args):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = wrapper(*args)
        e1.record()
        events.append((e0, e1))
        return out

    pk.IMPLEMENTATIONS["kernel"] = timed
    try:
        runs = []
        for _ in range(REPS + 1):
            events.clear()
            _, ms = once_ms(program)
            runs.append((ms, sum(a.elapsed_time(b) for a, b in events)))
    finally:
        pk.IMPLEMENTATIONS["kernel"] = wrapper
    return (statistics.median(r[0] for r in runs[1:]),
            statistics.median(r[1] for r in runs[1:]), len(events))


def split_inputs(papi, kf, batch, T, S, dev):
    """The split of `batch` at S segments, as api._split_program runs it:
    tables at T, the pre-pass schedule, and kernel 1's arguments over the
    S*B lanes (tiled tables, segment schedule rows, sf, si, Ts + W, Q32)
    with the per-lane offsets g0."""
    from grail_tpu_torch.api import WARMUP

    inc = batch.v0.jitter_frequency
    tables = batch.tables(T, dev)
    pre, _ = papi._split_sched(inc, T, S, dev)
    tables_t, (phi, cell), state, q, g0, _ = papi._split_lanes(
        tables, T, S, "kernel", inc)
    sf, si = kf.state_rows(state, q)
    return {"tables": tables, "pre": pre, "g0": g0,
            "args": (tables_t, phi, cell, sf, si, T // S + WARMUP, False)}


def device_us(avg):
    """Device time (us) of one torch.profiler key_averages() entry."""
    for name in ("device_time_total", "cuda_time_total"):
        v = getattr(avg, name, None)
        if v is not None:
            return float(v)
    return 0.0


CARRY_KERNELS = {"fused_synth_kernel": "fused_synth_carry"}
XLA_KERNELS = {"carrier_scan_kernel": "carrier_scan",
               "jsched_scan_kernel": "jsched_scan"}


def profiled_ticks(label, tick, kernels=CARRY_KERNELS):
    """Run tick() PROFILE_TICKS times under torch.profiler and read the
    window: host->device and device->host copies, each kernel of `kernels`
    ({name in the trace: LAUNCHES key}) as the trace saw it and as the
    launch count read it, the device time by name, the first kernel's
    device time per launch and the device idle share (the window's wall
    time less its device time). A warm-up step of the profiler (3 ticks,
    not recorded) comes first, and the active window starts after the
    card has drained and a short pause: without them traces of 20 ticks
    missed from 1 to 13 of the window's first kernels. A window whose
    trace misses launches that the counts read is measured again, up to
    PROFILE_ATTEMPTS windows in all, each printed. Fails unless every
    kernel was seen and counted PROFILE_TICKS times in one window and no
    copy went host->device."""
    import torch

    from grail_tpu_torch.synth import kernel_fused as kf

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1)
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with torch.profiler.profile(activities=acts, schedule=sched,
                                    acc_events=True) as prof:
            for _ in range(3):
                tick()
            torch.cuda.synchronize()
            prof.step()
            time.sleep(PROFILE_SETTLE_S)
            l0 = dict(kf.LAUNCHES)
            t0 = time.perf_counter()
            for _ in range(PROFILE_TICKS):
                tick()
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
            launched = {n: kf.LAUNCHES[k] - l0[k]
                        for n, k in kernels.items()}
            prof.step()
        avgs = prof.key_averages()
        ev = {e.key: e.count for e in avgs}
        h2d = sum(c for k, c in ev.items() if "HtoD" in k)
        d2h = sum(c for k, c in ev.items() if "DtoH" in k)
        seen = {n: sum(c for k, c in ev.items() if n in k) for n in kernels}
        if h2d or any(v != PROFILE_TICKS for v in launched.values()):
            break           # a fault of the program, not of the trace
        if all(v == PROFILE_TICKS for v in seen.values()):
            break
        print(f"{label}: profiler window {attempt} of {PROFILE_ATTEMPTS} "
              f"saw launches {seen} where the counts read {launched}; "
              f"measured again", flush=True)
    if (any(v != PROFILE_TICKS for v in seen.values())
            or any(v != PROFILE_TICKS for v in launched.values()) or h2d):
        raise AssertionError(
            f"{label}: in {PROFILE_TICKS} steady ticks the profiler saw "
            f"launches {seen} and {h2d} host->device copies; the launch "
            f"counts read {launched}")
    first = next(iter(kernels))
    kern = seen[first]
    # device time: the device-side entries (kernels, copies), not the
    # profiler's own step spans
    dev_ms = {e.key: device_us(e) / 1e3 for e in avgs
              if getattr(e, "device_type", None)
              == torch.autograd.DeviceType.CUDA
              and not e.key.startswith("ProfilerStep")}
    kern_dev_ms = sum(v for k_, v in dev_ms.items() if first in k_) / kern
    return dict(h2d=h2d, d2h=d2h, kernels=kern, seen=seen,
                window_ms=window_ms, dev_ms=dev_ms,
                kernel_device_ms=kern_dev_ms,
                idle=1.0 - sum(dev_ms.values()) / window_ms)


def serving(card, dev, drive):
    """Phase 11: the serving path. The main path is StreamPool(512,
    device="cuda") fed staggered texts over SERVE_TICKS ticks with the
    lattice windows sliding; it must launch fused_synth_carry and no other
    kernel, and SERVE_CHECK of its ticks are held bit for bit against the
    plain version on the card, from the same state and inputs. Then, at
    each N in SERVE_N (the default 60 s windows, every session fed), a
    torch.profiler window of PROFILE_TICKS steady-state ticks (0
    host->device copies required) and the times. Returns the numbers."""
    import numpy as np
    import torch

    from grail_tpu_torch.runtime import stream as st
    from grail_tpu_torch.synth import kernel_fused as kf

    blk = SERVE_BLOCK
    N = SERVE_N[-1]
    texts = [SERVE_TEXTS[i % len(SERVE_TEXTS)] for i in range(N)]
    budget_ms = blk / 44100.0 * 1e3
    out = {"budget_ms": budget_ms, "by_n": {}}

    # ---- the main path ---------------------------------------------------
    def main_path():
        pool = st.StreamPool(N, voice="plain", language="english", block=blk,
                             jitter_horizon_s=SLIDE_HORIZON_S)
        for i in range(0, N, 2):
            pool.feed(i, texts[i])
        pool.flush()
        audio, max_abs = [], 0.0
        for t in range(SERVE_TICKS):
            if t < SERVE_FEED_TICKS:        # 8 odd sessions join per tick
                for i in range(2 * t + 1, N, 2 * SERVE_FEED_TICKS):
                    pool.feed(i, texts[i])
                    pool.flush(i)
            if t in SERVE_CHECK:
                sf0, si0 = pool._sf.clone(), pool._si.clone()
            a = pool.read_block(sync=False)
            if t in SERVE_CHECK:
                # the same tick's inputs (the offsets before their advance)
                ins = dict(pool._dev, offsets=pool._dev["offsets"] - blk)
                ref = st._tick("plain", ins, sf0, si0, blk)
                for name, x, y in zip(("audio", "sf", "si"),
                                      (a, pool._sf, pool._si), ref):
                    max_abs = max(max_abs, float(
                        (x.double() - y.double()).abs().max()))
                    if not torch.equal(x, y):
                        raise AssertionError(
                            f"[11 serving] tick {t}: the carry kernel's "
                            f"{name} differs from the plain version's")
            audio.append(a)
        return pool, torch.cat(audio, dim=1), max_abs

    (pool, audio, max_abs), counts = drive(
        "StreamPool serving", main_path, {"fused_synth_carry"})
    if counts["fused_synth_carry"] != SERVE_TICKS:
        raise AssertionError(f"[11 serving] {counts['fused_synth_carry']} "
                             f"carry launches for {SERVE_TICKS} ticks")
    if not bool(torch.isfinite(audio).all()):
        raise AssertionError("[11 serving] non-finite audio")
    peak = audio.abs().amax(dim=1).cpu().numpy()
    bases = np.asarray([s._lat_base for s in pool.sessions])
    if (bases > 0).sum() < N // 2 or (peak > 0.01).sum() < N // 4:
        raise AssertionError(f"[11 serving] slid {(bases > 0).sum()}, "
                             f"sounding {(peak > 0.01).sum()} of {N}")
    out.update(launches=counts["fused_synth_carry"], max_abs=max_abs)
    print(f"[11 serving] main path StreamPool({N}, device='cuda'), voice "
          f"plain, english, block {blk}, jitter_horizon_s "
          f"{SLIDE_HORIZON_S}: {SERVE_TICKS} ticks, half the sessions fed "
          f"up front and 8 more per tick over {SERVE_FEED_TICKS} ticks; "
          f"launches {counts}; audio finite, {(peak > 0.01).sum()} of {N} "
          f"sessions sounding; {(bases > 0).sum()} windows slid (lat_base "
          f"up to {bases.max()}); ticks {SERVE_CHECK.start}-"
          f"{SERVE_CHECK.stop - 1} bit-equal to the plain version on the "
          f"card (audio, sf, si; max-abs {max_abs})", flush=True)
    del pool, audio
    torch.cuda.empty_cache()

    # ---- steady state and times at each N ----------------------------------
    for n in SERVE_N:
        texts_n = texts[:n]
        pool = st.StreamPool(n, voice="plain", language="english", block=blk)
        t0 = time.perf_counter()
        for i in range(n):
            pool.feed(i, texts_n[i])
        pool.flush()
        feed_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        pool.read_block()
        first_ms = (time.perf_counter() - t0) * 1e3
        for _ in range(3):
            pool.read_block()

        # the profiler window: steady-state ticks copy nothing host->device;
        # the count means something only where the trace saw the launches
        pw = profiled_ticks(f"[11 serving] N={n}", pool.read_block)
        window_ms, kern_dev_ms, idle = (pw[k] for k in (
            "window_ms", "kernel_device_ms", "idle"))
        h2d, d2h, kern = pw["h2d"], pw["d2h"], pw["kernels"]
        print(f"[11 serving] N={n} steady state, {PROFILE_TICKS} ticks under "
              f"torch.profiler: host->device copies {h2d}, device->host "
              f"{d2h}, fused_synth_kernel launches {kern}; "
              f"read_block window {window_ms} ms; carry kernel device time "
              f"{kern_dev_ms} ms per launch; device time by name "
              f"{json.dumps(pw['dev_ms'])}; device idle share {idle}",
              flush=True)

        # times
        ins = pool._prepare_tick()
        sf, si = pool._sf, pool._si
        kern_ms = median_ms(lambda: st._tick("kernel", ins, sf, si, blk))
        # the bound's bytes: this tick's own, from its state before and after
        si1 = st._tick("kernel", ins, sf, si, blk)[2]
        tick_b = carry_tick_bytes(dict(ins, sf=sf), si, si1, blk)
        _, plain_ms = once_ms(lambda: st._tick("plain", ins, sf, si, blk))
        fast_ms = host_ms(pool._prepare_tick)

        def full_pass():
            pool._quiet = None
            pool._prepare_tick()

        full_ms = host_ms(full_pass)
        k = [0]

        def feed_one():                      # a feed: one session's rows
            k[0] = (k[0] + 1) % n
            pool.feed(k[0], "a ")
            pool._prepare_tick()

        scatter_ms = host_ms(feed_one, sync=True)
        pool.read_block()                    # re-arm the fast path
        tick_ms = host_ms(pool.read_block)
        pool.tick_pipelined()
        periods = []
        for _ in range(PIPE_TICKS):
            t0 = time.perf_counter()
            pool.tick_pipelined()
            periods.append((time.perf_counter() - t0) * 1e3)
        pool.drain()
        pipe_ms = statistics.median(periods)
        rb_ms = host_ms(lambda: pool.read_blocks(READ_AHEAD))
        ins8 = pool._prepare_tick(blk * READ_AHEAD)
        sf, si = pool._sf, pool._si
        kern8_ms = median_ms(lambda: st._tick("kernel", ins8, sf, si,
                                              blk * READ_AHEAD))
        E = ins["n"].shape[1]
        bnd = bound(tick_b, n * blk * (SEQ_OPS + 3 * search_steps(E)
                                       + FUSED_OPS + JITTER_OPS))
        row = dict(
            E=E, cells=ins["lat"][0].shape[1], feed_ms=feed_ms,
            first_tick_ms=first_ms, kernel_ms=kern_ms, plain_ms=plain_ms,
            bound_ms=bnd[0], bound_by=bnd[1], bound_measured_ms=bnd[2],
            bound_bytes=tick_b,
            prepare_fast_ms=fast_ms,
            prepare_full_ms=full_ms, prepare_feed_scatter_ms=scatter_ms,
            read_block_ms=tick_ms, pipelined_period_ms=pipe_ms,
            read_blocks8_ms=rb_ms, read_blocks8_kernel_ms=kern8_ms,
            kernel_device_ms=kern_dev_ms, idle_share=idle,
            profiler=dict(h2d=h2d, d2h=d2h, kernels=kern,
                          window_ms=window_ms))
        out["by_n"][n] = row
        share = {k_: row[k_] / budget_ms for k_ in (
            "kernel_ms", "prepare_fast_ms", "prepare_full_ms",
            "prepare_feed_scatter_ms", "read_block_ms",
            "pipelined_period_ms")}
        share8 = {k_: row[k_] / (READ_AHEAD * budget_ms) for k_ in (
            "read_blocks8_ms", "read_blocks8_kernel_ms")}
        print(f"[11 serving] N={n} times (block budget {budget_ms} ms): "
              f"E={E}, window {row['cells']} cells; feeding {n} texts "
              f"{feed_ms} ms, first tick (all scores built and uploaded) "
              f"{first_ms} ms; carry kernel {kern_ms} ms per tick (CUDA "
              f"events, median of {REPS}), plain PyTorch {plain_ms} ms (one "
              f"run), bound {bound_text(bnd)} (the tick's bytes "
              f"{tick_b}); _prepare_tick fast path "
              f"{fast_ms} ms, full pass {full_ms} ms, full pass with one "
              f"session fed (score rows scattered) {scatter_ms} ms; "
              f"read_block {tick_ms} ms; tick_pipelined period {pipe_ms} ms "
              f"(median of {PIPE_TICKS}); read_blocks({READ_AHEAD}) "
              f"{rb_ms} ms, its kernel {kern8_ms} ms; shares of the budget "
              f"{json.dumps(share)}, of {READ_AHEAD} budgets "
              f"{json.dumps(share8)}; card {card}", flush=True)
        del pool, ins, ins8
        torch.cuda.empty_cache()
    return out


def serve_mode(card, dev, drive, phase11, blk=SERVE_BLOCK, backend=None,
               ticks=SERVED_TICKS, plain_ticks=SERVED_PLAIN,
               tag="15 serve mode", gate=True, dense=()):
    """Phase 15 (and phase 16's xla tick with blk, backend, ticks,
    plain_ticks and tag of its own; its deadline misses printed, not gated,
    when gate is False): serve mode at the serving cell's full width, N =
    512 then 128 (voice plain, english, block 1,024, 60 s windows, every
    session fed, pin_elems = 64). Per N: SERVED_TICKS served ticks with the
    staggered feeds published by explicit _serve_build() calls, each bit
    for bit (audio, sf, si) equal to a twin pool's read_block and
    SERVED_PLAIN of them to the plain version from the same state, one
    fused_synth_carry launch per served tick and no other kernel; a
    torch.profiler window of PROFILE_TICKS steady served ticks (0
    host->device copies, the carry kernel once a tick, the device idle
    share beside phase 11's); the times (serve_tick's host time per call,
    p50 and p99 of HOST_CALLS; the graph replay, serve_tick and the eager
    tick by CUDA events; _serve_build with and without a feed); then a
    paced run of PACED_S seconds, the frontend thread on its own period
    and a feeder thread feeding a session every FEED_EVERY block periods
    (grail_tpu's cadence): the frontend cycles, the capture
    times on the frontend thread and the deadline misses at sink depth
    SINK_DEPTH, which must be 0; at each N in `dense`, two more paced runs
    with a feed every block period, with the host library and with its
    Python and numpy twins (_twins), their misses printed, not gated.
    Returns the numbers."""
    import gc
    import queue
    import random
    import threading

    import numpy as np
    import torch

    from grail_tpu_torch.runtime import stream as st

    period = blk / 44100.0
    program = "xla" if backend == "xla" or blk % 128 else "fused"
    expect = set(st._TICK_LAUNCHES[program])
    kernels = XLA_KERNELS if program == "xla" else CARRY_KERNELS
    out = {"by_n": {}}
    for n in SERVE_N[::-1]:
        texts = [SERVE_TEXTS[i % len(SERVE_TEXTS)] for i in range(n)]
        label = f"[{tag}] N={n}"

        def mk():
            pool = st.StreamPool(n, voice="plain", language="english",
                                 block=blk, pin_elems=64, backend=backend)
            for i in range(0, n, 2):
                pool.feed(i, texts[i])
            pool.flush()
            return pool

        def feed(pool, t):          # the odd sessions join over the ticks
            if t < SERVE_FEED_TICKS:
                for i in range(2 * t + 1, n, 2 * SERVE_FEED_TICKS):
                    pool.feed(i, texts[i])
                    pool.flush(i)

        # the twin: the same schedule through read_block (eager launches)
        twin = mk()
        twin._prepare_tick()    # serve_start's first host pass, before the
        ref = []                # feeds of tick 0, runs here too
        for t in range(ticks):
            feed(twin, t)
            a = twin.read_block(sync=False)
            ref.append((a, twin._sf.clone(), twin._si.clone()))
        del twin
        pool = mk()
        t0 = time.perf_counter()
        pool.serve_start(period=9999)   # the frontend idles: builds below
        start_ms = (time.perf_counter() - t0) * 1e3

        def served():
            max_abs = 0.0
            for t in range(ticks):
                feed(pool, t)
                pool._serve_build()
                if t in plain_ticks:
                    sf0, si0 = pool._sf.clone(), pool._si.clone()
                a = pool.serve_tick()
                for name, x, y in zip(("audio", "sf", "si"),
                                      (a, pool._sf, pool._si), ref[t]):
                    if not torch.equal(x, y):
                        raise AssertionError(
                            f"{label} tick {t}: the served {name} differs "
                            f"from the twin's read_block")
                if t in plain_ticks:
                    # the same tick's inputs: the adopted set, the offsets
                    # before their advance
                    ins = dict(pool._serve_cur["dev"],
                               offsets=pool._serve_off - blk)
                    plain = st._TICKS[program]("plain", ins, sf0, si0, blk)
                    for name, x, y in zip(("audio", "sf", "si"),
                                          (a, pool._sf, pool._si), plain):
                        max_abs = max(max_abs, float(
                            (x.double() - y.double()).abs().max()))
                        if not torch.equal(x, y):
                            raise AssertionError(
                                f"{label} tick {t}: the served {name} "
                                f"differs from the plain version's")
            return max_abs

        max_abs, counts = drive(f"{tag} N={n}", served, expect)
        if any(counts[k] != ticks for k in expect):
            raise AssertionError(f"{label}: launches {counts} for {ticks} "
                                 f"served ticks")
        audio = torch.cat([r[0] for r in ref], dim=1)
        sounding = int((audio.abs().amax(dim=1) > 0.01).sum())
        if not bool(torch.isfinite(audio).all()) or sounding < n // 4:
            raise AssertionError(f"{label}: audio finite "
                                 f"{bool(torch.isfinite(audio).all())}, "
                                 f"{sounding} of {n} sounding")
        del ref, audio
        print(f"{label}: StreamPool({n}, pin_elems=64), serve_start "
              f"{start_ms} ms (the first build, one eager tick, the first "
              f"capture); block {blk}, {program} tick; {ticks} served ticks "
              f"with the odd sessions fed over {SERVE_FEED_TICKS} ticks, "
              f"each published by _serve_build(): launches {counts}; audio, "
              f"sf and si bit-equal to a twin's read_block at every tick, "
              f"ticks {plain_ticks.start}-{plain_ticks.stop - 1} to the "
              f"plain version (max-abs {max_abs}); {sounding} of {n} "
              f"sounding; "
              f"{pool._serve_captures} graphs captured", flush=True)

        # the profiler window: steady served ticks, each fetched as
        # read_block fetches it in phase 11
        pw = profiled_ticks(label, lambda: pool.serve_tick().cpu(), kernels)
        window_ms, kern_dev_ms, idle = (pw[k] for k in (
            "window_ms", "kernel_device_ms", "idle"))
        h2d, d2h, kern = pw["h2d"], pw["d2h"], pw["kernels"]
        idle11 = phase11["by_n"][n]["idle_share"]
        print(f"{label} steady state, {PROFILE_TICKS} served ticks (each "
              f"fetched with .cpu()) under torch.profiler: host->device "
              f"copies {h2d}, device->host {d2h}, kernel launches "
              f"{pw['seen']} (the launch counts agree); window "
              f"{window_ms} ms; {next(iter(kernels))} device time "
              f"{kern_dev_ms} ms; device time by name "
              f"{json.dumps(pw['dev_ms'])}; device idle share {idle} "
              f"(read_block's: {idle11})", flush=True)

        # times
        host = []
        for _ in range(HOST_CALLS):
            t0 = time.perf_counter()
            pool.serve_tick()
            host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        p50, p99 = (float(x) for x in np.percentile(host, [50, 99]))
        tick_ms = median_ms(pool.serve_tick)
        cur = pool._serve_cur
        sf, si, off = (x.clone() for x in (pool._sf, pool._si,
                                           pool._serve_off))
        tick = pool._tick_program(blk)
        eager_ms = median_ms(lambda: st._served_tick(
            tick, cur["dev"], sf, si, off, blk))
        replay_ms = median_ms(cur["graph"].replay)   # state moves on: last
        quiet_ms = host_ms(pool._serve_build)        # nothing to publish
        k = [0]

        def build_fed():                             # one session's rows
            k[0] = (k[0] + 1) % n
            pool.feed(k[0], "a ")
            pool._serve_build()

        fed_ms = host_ms(build_fed, sync=True)
        pool.serve_stop()

        # the paced run: this thread holds the real-time schedule, the
        # frontend runs on its own period, a feeder thread feeds a session
        # every block period and a sink thread fetches each tick in order.
        # The garbage collector is off for the run, as in a real-time audio
        # loop (grail_tpu's benchmarks/latency.py does the same).
        def paced(every, suffix=""):
            """One paced run with a feed every `every` block periods:
            (deadline misses by sink depth, capture times, ticks)."""
            pool.serve_start()
            captures, capture = [], pool._serve_capture

            def timed_capture(swap):
                t0 = time.perf_counter()
                capture(swap)
                captures.append((threading.current_thread().name,
                                 (time.perf_counter() - t0) * 1e3))

            pool._serve_capture = timed_capture
            builds, build = [], pool._serve_build

            def timed_build():
                t0 = time.perf_counter()
                published = build()
                builds.append((time.perf_counter() - t0) * 1e3)
                return published

            pool._serve_build = timed_build
            K = int(PACED_S / period)
            avail, dispatch, call = [None] * K, [None] * K, [None] * K
            fetched, errors = queue.Queue(), []
            rng = random.Random(0)
            t_start = None                  # set once the collector has run

            def sink():
                while True:
                    item = fetched.get()
                    if item is None:
                        return
                    kk, a = item
                    h = a.cpu()
                    avail[kk] = time.perf_counter()
                    if not bool(torch.isfinite(h).all()):
                        errors.append(f"tick {kk} not finite")

            def feeder():
                try:
                    for kk in range(0, K, int(every)):
                        dt = (t_start + (kk + 0.5) * period
                              - time.perf_counter())
                        if dt > 0:
                            time.sleep(dt)
                        i = rng.randrange(n)
                        pool.feed(i, texts[rng.randrange(n)] + " ")
                        pool.flush(i)
                except Exception as e:      # reported below
                    errors.append(repr(e))

            threads = [threading.Thread(target=sink),
                       threading.Thread(target=feeder)]
            gc.collect()
            gc.disable()
            try:
                t_start = time.perf_counter() + 2 * period
                for th in threads:
                    th.start()
                for kk in range(K):
                    target = t_start + kk * period
                    dt = target - time.perf_counter()
                    if dt > 0:
                        time.sleep(dt)
                    t0 = time.perf_counter()
                    dispatch[kk] = t0 - target
                    a = pool.serve_tick()
                    call[kk] = time.perf_counter() - t0
                    fetched.put((kk, a))
            finally:
                fetched.put(None)
                for th in threads:
                    th.join(timeout=60)
                gc.enable()
            frontend_error = pool._serve_error
            pool.serve_stop()
            pool._serve_capture, pool._serve_build = capture, build
            if errors or frontend_error is not None or any(
                    a is None for a in avail):
                raise AssertionError(f"{label} paced run{suffix}: {errors}, "
                                     f"frontend {frontend_error!r}")
            misses = {d: sum(avail[kk] > t_start + (kk + d) * period
                             for kk in range(K)) for d in (1, 2, 3)}
            names = {name for name, _ in captures}
            cap_ms = [ms for _, ms in captures]
            if names - {"StreamPool-frontend"}:
                raise AssertionError(f"{label}: captures on threads {names}")
            late, calls = sorted(dispatch), sorted(call)
            fetch = sorted(avail[kk] - t_start - kk * period
                           for kk in range(K))
            print(f"{label} paced run{suffix}: {K} ticks at the "
                  f"{period * 1e3} ms block period ({PACED_S} s), a feed "
                  f"every {int(every)} periods, the frontend on its own "
                  f"period: deadline misses at sink depth "
                  f"1/2/3 {misses[1]}/{misses[2]}/{misses[3]}; dispatch late "
                  f"p50 {late[K // 2] * 1e3} ms, max {late[-1] * 1e3} ms; "
                  f"serve_tick p50 {calls[K // 2] * 1e3} ms, p99 "
                  f"{calls[int(K * 0.99)] * 1e3} ms, max "
                  f"{calls[-1] * 1e3} ms; "
                  f"audio on the host after its dispatch time p50 "
                  f"{fetch[K // 2] * 1e3} ms, max {fetch[-1] * 1e3} ms; "
                  f"{len(builds)} frontend cycles, p50 "
                  f"{statistics.median(builds)} ms, max {max(builds)} ms, "
                  f"{sum(b > 2 * period * 1e3 for b in builds)} longer "
                  f"than two block periods; "
                  f"{len(cap_ms)} captures on the frontend thread, p50 "
                  f"{statistics.median(cap_ms) if cap_ms else None} ms, max "
                  f"{max(cap_ms) if cap_ms else None} ms", flush=True)
            return misses, cap_ms, K

        every = int(max(FEED_EVERY, -(-12.0 // (n * period))))
        misses, cap_ms, K = paced(every)
        if misses[SINK_DEPTH] and gate:
            raise AssertionError(f"{label}: {misses[SINK_DEPTH]} deadline "
                                 f"misses at sink depth {SINK_DEPTH}")
        dense_misses = {}
        if n in dense:
            # a feed every block period, with the host library and with the
            # Python and numpy twins in its place: printed, not gated
            dense_misses["native"] = paced(1, " with a feed every period")[0]
            with _twins():
                dense_misses["twins"] = paced(
                    1, " with a feed every period, the frontend on the "
                    "Python and numpy twins")[0]
        row = dict(launches=counts[next(iter(kernels.values()))],
                   max_abs=max_abs, misses=misses,
                   serve_start_ms=start_ms, host_p50_ms=p50,
                   host_p99_ms=p99, tick_ms=tick_ms, replay_ms=replay_ms,
                   eager_ms=eager_ms, kernel_device_ms=kern_dev_ms,
                   idle_share=idle, read_block_idle_share=idle11,
                   build_quiet_ms=quiet_ms, build_fed_ms=fed_ms,
                   capture_p50_ms=(statistics.median(cap_ms) if cap_ms
                                   else None),
                   capture_max_ms=max(cap_ms) if cap_ms else None,
                   captures=len(cap_ms), paced_ticks=K,
                   misses_depth2=misses[SINK_DEPTH],
                   dense_misses=dense_misses,
                   profiler=dict(h2d=h2d, d2h=d2h, kernels=kern,
                                 window_ms=window_ms))
        out["by_n"][n] = row
        print(f"{label} times (block budget {period * 1e3} ms): serve_tick "
              f"host time p50 {p50} ms, p99 {p99} ms ({HOST_CALLS} calls); "
              f"CUDA events (median of {REPS}): the graph replay {replay_ms} "
              f"ms, serve_tick (replay and copy-out) {tick_ms} ms, the eager "
              f"tick (launches op by op) {eager_ms} ms, the eager tick's "
              f"kernel {phase11['by_n'][n]['kernel_ms']} ms; "
              f"_serve_build with nothing to publish {quiet_ms} ms, with "
              f"one session fed (scatter into a copy, capture, device work "
              f"synchronised) {fed_ms} ms; card {card}", flush=True)
        del pool, cur
        torch.cuda.empty_cache()
    out["launches"] = out["by_n"][SERVE_N[-1]]["launches"]
    return out


def seq_scan_phase(card, dev, inc):
    """Phase 16, the kernel: seq_scan.cu's two entry points against their
    plain versions on the card, bit for bit, at the xla tick's shape
    [441, 512], the xla batch's block [4096, 64] and one lane of 4,096
    samples with the state carried over two calls; their times (CUDA
    events) beside the plain loops' (one run) and the bound. Launches made
    here compare and time; the main path's are counted elsewhere."""
    import numpy as np
    import torch

    from grail_tpu_torch.synth import seq_scan as sq

    rng = np.random.default_rng(0)
    out = {}
    for T, L in SEQ_SHAPES + ((4096, 1),):
        f = (0.002 + 0.01 * rng.random((T, L))).astype(np.float32)
        f[:9] = np.float32(0.25)              # the silent frame's wraps
        f = torch.from_numpy(f).to(dev)
        p0 = torch.from_numpy(rng.random(L).astype(np.float32)).to(dev)
        jphi = torch.from_numpy(rng.random(L).astype(np.float32)).to(dev)
        jcell = torch.from_numpy(rng.integers(0, 1000, L).astype(
            np.int32)).to(dev)
        if L == 1:                            # two calls, the state carried
            h = T // 2
            a1, q1 = sq.carrier_scan(p0, f[:h])
            a2, q2 = sq.carrier_scan(q1, f[h:])
            car_k = (torch.cat([a1, a2]), q2)
            j1 = sq.jsched_scan(jphi, jcell, inc, h)
            j2 = sq.jsched_scan(j1[2], j1[3], inc, T - h)
            js_k = (torch.cat([j1[0], j2[0]], 1), torch.cat([j1[1], j2[1]],
                                                            1), *j2[2:])
        else:
            car_k = sq.carrier_scan(p0, f)
            js_k = sq.jsched_scan(jphi, jcell, inc, T)
        car_p, car_plain_ms = once_ms(
            lambda: sq.carrier_scan(p0, f, impl="plain"))
        js_p, js_plain_ms = once_ms(
            lambda: sq.jsched_scan(jphi, jcell, inc, T, impl="plain"))
        row = {"carrier_plain_ms": car_plain_ms, "jsched_plain_ms":
               js_plain_ms}
        for name, k, p_ in (("carrier", car_k, car_p),
                            ("jsched", js_k, js_p)):
            row[f"{name}_max_abs"] = max(float(
                (x.double() - y.double()).abs().max()) for x, y in zip(k, p_))
            for x, y in zip(k, p_):
                if not torch.equal(x, y):
                    raise AssertionError(f"[16 seq_scan] {name}_scan "
                                         f"[{T}, {L}]: the kernel differs "
                                         "from the plain version")
        if L > 1:
            # the kernels' own time: their C launches repeated between two
            # events; one wrapper call between two events also counts the
            # wrapper's host work
            import ctypes

            from grail_tpu_torch.synth._build import load_library

            lib, vp = load_library(), ctypes.c_void_p
            stream = vp(torch.cuda.current_stream(dev).cuda_stream)
            track, pf = torch.empty_like(f), torch.empty_like(p0)
            phi_o = torch.empty(T, L, device=dev)
            cell_o = torch.empty(T, L, dtype=torch.int32, device=dev)
            jp_o, jc_o = torch.empty_like(jphi), torch.empty_like(jcell)
            c_args = [vp(t.data_ptr()) for t in (f, p0, track, pf)] + [
                T, L, stream]
            j_args = ([vp(jphi.data_ptr()), vp(jcell.data_ptr()),
                       float(np.float32(inc))]
                      + [vp(t.data_ptr()) for t in (phi_o, cell_o, jp_o,
                                                    jc_o)] + [T, L, stream])
            row["carrier_ms"] = launches_ms(
                lambda: lib.grail_carrier_scan(*c_args), SEQ_REPS)
            row["jsched_ms"] = launches_ms(
                lambda: lib.grail_jsched_scan(*j_args), SEQ_REPS)
            row["carrier_call_ms"] = median_ms(
                lambda: sq.carrier_scan_cuda(p0, f))
            row["jsched_call_ms"] = median_ms(lambda: sq.jsched_scan_cuda(
                jphi, jcell, inc, T))
            # bytes: the frequencies read and the track written, or the
            # phases and cells written, and the [L] states; operations
            # per lane-sample as the sources count them
            row["carrier_bound"] = bound(T * L * 8 + L * 8,
                                         T * L * CARRIER_OPS)
            row["jsched_bound"] = bound(T * L * 8 + L * 16,
                                        T * L * JSCHED_OPS)
        out[(T, L)] = row
        print(f"[16 seq_scan] [{T}, {L}]{' (two calls)' if L == 1 else ''}: "
              f"carrier_scan and jsched_scan bit-equal to their plain "
              f"versions (outputs and final states); "
              + (f"carrier_scan {row['carrier_ms']} ms, jsched_scan "
                 f"{row['jsched_ms']} ms (their own launches, {SEQ_REPS} "
                 f"between two CUDA events, median of {REPS}); one wrapper "
                 f"call {row['carrier_call_ms']} / {row['jsched_call_ms']} "
                 f"ms; "
                 f"bounds {bound_text(row['carrier_bound'])} / "
                 f"{bound_text(row['jsched_bound'])}; "
                 if L > 1 else "")
              + f"plain loops {car_plain_ms} / {js_plain_ms} ms (one run); "
              f"card {card}", flush=True)
    return out


def xla_batch_phase(card, dev, drive, texts, voice, fused_e2e_ms):
    """Phase 16, the cores: synthesize_batch(64 texts, backend="xla") at
    full width (S = 1, no lane padding) launches no kernel on its Q32
    carrier and carrier_scan once a block with exact_carrier="kernel";
    finite outputs of the right length, each within -60 dB of the fused
    route on the card, "ae","ea" against the CPU's xla route; the scan core
    (synthesize("ae", backend="scan")) against the CPU; the times."""
    import numpy as np
    import torch

    import grail_tpu_torch as g
    import grail_tpu_torch.api as papi
    from grail_tpu_torch.api import BLOCK_SIZE, _round_up
    from grail_tpu_torch.utils import sample_error_db

    sr = float(voice.sample_rate)
    scores = [g.text_to_score(t) for t in texts]
    b = papi._Batch(scores, voice, None)
    Ns, maxN = b.Ns, max(b.Ns)
    route_x = g.route(B, maxN, None, dev, sr, "xla")
    T = route_x[3]
    if route_x[1:] != ("q32", 1, _round_up(maxN, BLOCK_SIZE)):
        raise AssertionError(f"[16 xla] routed as {route_x}")
    nb = T // BLOCK_SIZE

    def outputs_ok(label, outs):
        for o, n in zip(outs, Ns):
            if (o.device.type != "cuda" or tuple(o.shape) != (n,)
                    or not bool(torch.isfinite(o).all())):
                raise AssertionError(f"{label}: output {tuple(o.shape)}, "
                                     f"expected ({n},) finite on cuda")

    outs, counts = drive("xla batch", lambda: g.synthesize_batch(
        texts, backend="xla"), set())
    outputs_ok("[16 xla batch]", outs)
    outs_k, counts_k = drive("xla batch kcar", lambda: g.synthesize_batch(
        texts, backend="xla", exact_carrier="kernel"), {"carrier_scan"})
    outputs_ok("[16 xla batch kcar]", outs_k)
    if counts_k["carrier_scan"] != nb:
        raise AssertionError(f"[16 xla batch kcar] {counts_k} for {nb} "
                             "blocks")
    # each carrier against the fused route's same carrier: Q32 against the
    # split's Q32, the f32 recurrence against the kernel's own (the two
    # carriers drift apart by up to -60 dB over seconds, docs/PARITY.md)
    fused = g.synthesize_batch(texts)
    db_fused = [sample_error_db(x.cpu().numpy(), y.cpu().numpy())
                for x, y in zip(outs, fused)]
    fused = g.synthesize_batch(texts, exact_carrier="kernel")
    db_fused_k = [sample_error_db(x.cpu().numpy(), y.cpu().numpy())
                  for x, y in zip(outs_k, fused)]
    if max(db_fused) >= GATE_DB or max(db_fused_k) >= GATE_DB:
        raise AssertionError(f"[16 xla batch] against the fused route: "
                             f"worst {max(db_fused)} / {max(db_fused_k)} dB")
    del fused
    short = texts[:2]
    db_cpu = []
    for kw, on_card in ((dict(), outs), (dict(exact_carrier="kernel"),
                                         outs_k)):
        ref = g.synthesize_batch(short, backend="xla", device="cpu", **kw)
        db_cpu += [sample_error_db(x.cpu().numpy(), y.numpy())
                   for x, y in zip(on_card, ref)]
    if max(db_cpu) >= TOL_DB:
        raise AssertionError(f"[16 xla batch] cuda vs cpu {db_cpu} dB")
    del outs, outs_k
    torch.cuda.empty_cache()
    audio_s = sum(Ns) / sr
    print(f"[16 xla batch] synthesize_batch({B} texts, backend='xla'): route "
          f"{route_x} ({nb} blocks of {BLOCK_SIZE}); launches {counts}; with "
          f"exact_carrier='kernel' {counts_k}; {B} finite outputs of the "
          f"right length; against the fused route on the card worst "
          f"{max(db_fused)} dB (q32), {max(db_fused_k)} dB (kcar); "
          f"{short} against the CPU's xla route {db_cpu} dB", flush=True)

    # times: end to end (host clock) and the program (CUDA events), beside
    # the fused route's
    e2e_ms = host_ms(lambda: g.synthesize_batch(texts, backend="xla"),
                     sync=True)
    e2e_k_ms = host_ms(lambda: g.synthesize_batch(
        texts, backend="xla", exact_carrier="kernel"), sync=True)
    prog_ms = median_ms(lambda: b.run("kernel", "q32", 1, T, dev, "xla"))
    prog_k_ms = median_ms(lambda: b.run("kernel", "kcar", 1, T, dev, "xla"))
    impl, carrier, S_f, T_f = g.route(B, maxN, None, dev, sr)
    fused_prog_ms = median_ms(lambda: b.run(impl, carrier, S_f, T_f, dev))
    print(f"[16 xla batch] times: end to end {e2e_ms} ms (q32), {e2e_k_ms} "
          f"ms (kcar), {audio_s / (e2e_ms / 1e3)} x realtime; the xla "
          f"program {prog_ms} ms (q32), {prog_k_ms} ms (kcar) (CUDA events, "
          f"median of {REPS}); the fused route: end to end {fused_e2e_ms} "
          f"ms (phase 7), program {fused_prog_ms} ms (S={S_f}); card {card}",
          flush=True)

    # the scan core: a Python loop over samples on the card
    t0 = time.perf_counter()
    scan, counts_s = drive("scan", lambda: g.synthesize(
        "ae", backend="scan"), {"carrier_scan"})
    scan_ms = (time.perf_counter() - t0) * 1e3
    ref = g.synthesize("ae", backend="scan", device="cpu")
    db_scan = sample_error_db(scan.cpu().numpy(), ref.numpy())
    if db_scan >= TOL_DB or scan.shape != ref.shape:
        raise AssertionError(f"[16 scan] cuda vs cpu {db_scan} dB")
    xla_ae = g.synthesize("ae", backend="xla")
    print(f"[16 scan] synthesize('ae', backend='scan') on the card: "
          f"{scan.shape[0]} samples in {scan_ms} ms (host clock, one run: "
          f"one step of torch ops per sample); launches {counts_s}; cuda "
          f"vs cpu {db_scan} dB; against the xla route "
          f"{sample_error_db(scan.cpu().numpy(), xla_ae.cpu().numpy())} dB; "
          f"card {card}", flush=True)
    return dict(route=route_x, launches=counts_k["carrier_scan"],
                db_fused=max(db_fused), db_fused_kcar=max(db_fused_k),
                db_cpu=max(db_cpu), e2e_ms=e2e_ms, e2e_kcar_ms=e2e_k_ms,
                program_ms=prog_ms, program_kcar_ms=prog_k_ms,
                fused_program_ms=fused_prog_ms, scan_ms=scan_ms,
                scan_db=db_scan)


def xla_tick_phase(card, dev, drive):
    """Phase 16, the xla tick: the main path StreamPool(512) at block 441
    (10 ms at 44.1 kHz: not a multiple of 128, so the xla tick), plain,
    english, 0.3 s lattice windows, fed as phase 11 over XLA_TICKS ticks
    (windows slide from ~0.5 s on): one carrier_scan and one jsched_scan
    launch per tick and no other kernel, ticks XLA_CHECK bit-equal (audio,
    sf, si) to the same tick with the recurrences' plain versions from the
    same state. Then at N = 128
    and 512 (60 s windows, every session fed): a torch.profiler window of
    PROFILE_TICKS steady ticks (both kernels each tick, 0 host->device
    copies), the tick's times and read_block as a share of the 10.0 ms
    budget; and a pool at block 1,024 with backend='xla' against the fused
    pool fed alike (< -60 dB per sounding session). Returns the numbers."""
    import numpy as np
    import torch

    from grail_tpu_torch.runtime import stream as st
    from grail_tpu_torch.utils import sample_error_db

    blk = XLA_BLOCK
    N = SERVE_N[-1]
    texts = [SERVE_TEXTS[i % len(SERVE_TEXTS)] for i in range(N)]
    budget_ms = blk / 44100.0 * 1e3
    out = {"budget_ms": budget_ms, "by_n": {}}

    def main_path():
        pool = st.StreamPool(N, voice="plain", language="english", block=blk,
                             jitter_horizon_s=SLIDE_HORIZON_S)
        if pool.backend != "xla":
            raise AssertionError(f"block {blk} chose {pool.backend}")
        for i in range(0, N, 2):
            pool.feed(i, texts[i])
        pool.flush()
        audio, max_abs = [], 0.0
        for t in range(XLA_TICKS):
            if t < SERVE_FEED_TICKS:
                for i in range(2 * t + 1, N, 2 * SERVE_FEED_TICKS):
                    pool.feed(i, texts[i])
                    pool.flush(i)
            if t in XLA_CHECK:
                sf0, si0 = pool._sf.clone(), pool._si.clone()
            a = pool.read_block(sync=False)
            if t in XLA_CHECK:
                ins = dict(pool._dev, offsets=pool._dev["offsets"] - blk)
                ref = st._xla_tick("plain", ins, sf0, si0, blk)
                for name, x, y in zip(("audio", "sf", "si"),
                                      (a, pool._sf, pool._si), ref):
                    max_abs = max(max_abs, float(
                        (x.double() - y.double()).abs().max()))
                    if not torch.equal(x, y):
                        raise AssertionError(
                            f"[16 xla tick] tick {t}: the {name} differs "
                            "from the plain recurrences'")
            audio.append(a)
        return pool, torch.cat(audio, dim=1), max_abs

    (pool, audio, max_abs), counts = drive(
        "xla tick", main_path, {"carrier_scan", "jsched_scan"})
    if any(counts[k] != XLA_TICKS for k in ("carrier_scan", "jsched_scan")):
        raise AssertionError(f"[16 xla tick] launches {counts} for "
                             f"{XLA_TICKS} ticks")
    peak = audio.abs().amax(dim=1).cpu().numpy()
    bases = np.asarray([s._lat_base for s in pool.sessions])
    if not bool(torch.isfinite(audio).all()) or (peak > 0.01).sum() < N // 4 \
            or not (bases > 0).any():
        raise AssertionError(
            f"[16 xla tick] finite {bool(torch.isfinite(audio).all())}, "
            f"sounding {(peak > 0.01).sum()}, slid {(bases > 0).sum()}")
    out.update(launches=counts["carrier_scan"], max_abs=max_abs)
    print(f"[16 xla tick] main path StreamPool({N}, block={blk}) -> backend "
          f"'{pool.backend}', plain, english, jitter_horizon_s "
          f"{SLIDE_HORIZON_S}: {XLA_TICKS} ticks; launches {counts}; audio "
          f"finite, {(peak > 0.01).sum()} of {N} sounding; "
          f"{(bases > 0).sum()} windows slid; ticks 20-29 and 70-79 "
          f"bit-equal to the plain recurrences on the card (audio, sf, si; "
          f"max-abs {max_abs})", flush=True)
    del pool, audio
    torch.cuda.empty_cache()

    for n in SERVE_N:
        pool = st.StreamPool(n, voice="plain", language="english",
                             block=blk)
        for i in range(n):
            pool.feed(i, texts[i])
        pool.flush()
        for _ in range(4):
            pool.read_block()
        pw = profiled_ticks(f"[16 xla tick] N={n}", pool.read_block,
                            XLA_KERNELS)
        ins = pool._prepare_tick()
        sf, si = pool._sf, pool._si
        tick_ms = median_ms(lambda: st._xla_tick("kernel", ins, sf, si, blk))
        _, plain_ms = once_ms(lambda: st._xla_tick("plain", ins, sf, si,
                                                   blk))
        rb_ms = host_ms(pool.read_block)
        row = dict(kernel_ms=tick_ms, tick_ms=tick_ms, plain_tick_ms=plain_ms,
                   read_block_ms=rb_ms, idle_share=pw["idle"],
                   carrier_device_ms=pw["kernel_device_ms"],
                   device_ms=pw["dev_ms"], window_ms=pw["window_ms"],
                   profiler=dict(h2d=pw["h2d"], d2h=pw["d2h"],
                                 seen=pw["seen"]))
        out["by_n"][n] = row
        print(f"[16 xla tick] N={n}, block {blk} (budget {budget_ms} ms), "
              f"{PROFILE_TICKS} steady ticks under torch.profiler: "
              f"host->device copies {pw['h2d']}, device->host {pw['d2h']}, "
              f"launches {pw['seen']}; window {pw['window_ms']} ms; "
              f"carrier_scan device time {pw['kernel_device_ms']} ms per "
              f"launch; device time by name {json.dumps(pw['dev_ms'])}; "
              f"device idle share {pw['idle']}; the tick {tick_ms} ms (CUDA "
              f"events, median of {REPS}), with the plain recurrences "
              f"{plain_ms} ms (one run); read_block {rb_ms} ms = "
              f"{rb_ms / budget_ms} of the budget; card {card}", flush=True)
        del pool, ins
        torch.cuda.empty_cache()

    # backend='xla' at block 1,024 against the fused pool fed alike
    def fed(backend):
        pool = st.StreamPool(128, voice="plain", language="english",
                             block=1024, backend=backend)
        for i in range(128):
            pool.feed(i, texts[i])
        pool.flush()
        return torch.cat([pool.read_block(sync=False)
                          for _ in range(XLA_VS_FUSED_TICKS)], 1).cpu()

    ax, af = fed("xla"), fed("fused")
    dbs = [sample_error_db(ax[i].numpy(), af[i].numpy()) for i in range(128)
           if float(af[i].abs().max()) > 0.01]
    if len(dbs) < 32 or max(dbs) >= GATE_DB:
        raise AssertionError(f"[16 xla tick] xla vs fused pool: {len(dbs)} "
                             f"sounding, worst {max(dbs, default=None)} dB")
    out["db_vs_fused"] = max(dbs)
    print(f"[16 xla tick] StreamPool(128, block=1024, backend='xla') "
          f"against the fused pool fed alike, {XLA_VS_FUSED_TICKS} ticks: "
          f"worst of {len(dbs)} sounding sessions {max(dbs)} dB", flush=True)
    return out


def sharding_phase(card, dev, texts, voice):
    """Phase 17, dp x sp sharding (grail_tpu_torch/parallel/) at full
    width: sharded_pipeline of the B = 64 texts, T = round_up(max N,
    SP_ALIGN), Q32, on each mesh of SP_MESHES, every mesh a spawn of ranks
    (parallel/_ranks.chip_case) on cuda:0. (1, 1) over NCCL against the
    port's single-process xla program on the same batch (< TOL_DB per
    utterance); (1, 2) and (1, 4), ranks sharing the card over gloo,
    against (1, 1) (< TOL_DB, final seeds and phases bit-equal); (2, 1)
    against (1, 1), bit-equal (dp has no collective). No rank may launch a
    kernel. Per mesh: wall ms per call, the sp core's CUDA-event ms and the
    gathers' ms per rank, peak allocated bytes per rank, torch ops per
    call; also written to chiprun_out/chip_smoke_sharding.json. The
    gathers, in order: the carrier's Q32 totals, the lowpass's and the SVF
    bank's operator totals over 'seq', the [B_local, T_local] output blocks
    over the mesh; a mesh axis of size 1 gathers nothing."""
    import shutil

    import numpy as np
    import torch

    import grail_tpu_torch as g
    import grail_tpu_torch.api as papi
    from grail_tpu_torch.api import _round_up
    from grail_tpu_torch.parallel import _ranks
    from grail_tpu_torch.synth.score import stack_scores
    from grail_tpu_torch.utils import sample_error_db

    b = papi._Batch([g.text_to_score(t) for t in texts], voice, None)
    T = _round_up(max(b.Ns), SP_ALIGN)
    lattices, jparams = b.jitter(T)
    work = os.path.join(ROOT, "build", "chip_smoke_sharding")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    torch.save((stack_scores(b.scores), lattices, jparams, b.sr, T),
               os.path.join(work, "batch.pt"))

    # the reference: the port's single-process xla program, same batch
    setup = papi._core_unsplit_setup(b.core_lanes(T, dev), T, b.sr,
                                     jparams[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = papi._xla_run(setup, "q32")
    torch.cuda.synchronize()
    xla_ms = (time.perf_counter() - t0) * 1e3
    ref = ref.cpu().numpy()
    del setup
    torch.cuda.empty_cache()      # the ranks need the card's memory

    def worst_db(a, r):
        return max(sample_error_db(a[k], r[k]) for k in range(len(r)))

    runs, summary = {}, {"B": B, "T": T, "card": card,
                         "xla_program_ms": xla_ms, "meshes": {}}
    for nd, ns, backend in SP_MESHES:
        world, tag = nd * ns, f"{nd}x{ns}"
        t0 = time.perf_counter()
        _ranks.spawn(_ranks.chip_case, world,
                     (world, nd, ns, work, backend, SP_REPS), SP_TIMEOUT)
        spawn_s = time.perf_counter() - t0
        rs = _ranks.load_results(work, f"card_{tag}", world)
        out = rs[0]["out"]
        if tuple(out.shape) != (B, T) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"[17 sharding] {tag}: output "
                                 f"{tuple(out.shape)}, expected ({B}, {T}) "
                                 "finite")
        launched = {k: n for r in rs for k, n in r["launches"].items() if n}
        if launched:
            raise AssertionError(f"[17 sharding] {tag} launched {launched}; "
                                 "the sp path launches no kernel")
        by = {r["coord"]: r["state"] for r in rs}
        for (d, i), st in by.items():
            if not all(torch.equal(x, y) for x, y in zip(st, by[(d, 0)])):
                raise AssertionError(f"[17 sharding] {tag}: rank {(d, i)}'s "
                                     "final state differs from its row's")
        state = [torch.cat([by[(d, 0)][k] for d in range(nd)])
                 for k in range(5)]
        out = out.numpy()
        runs[(nd, ns)] = (out, state)
        one_out, one_state = runs[(1, 1)]
        if (nd, ns) == (1, 1):
            check = f"against the xla program {worst_db(out, ref)} dB worst"
            if worst_db(out, ref) >= TOL_DB:
                raise AssertionError(f"[17 sharding] {tag}: {check}")
        else:
            db = worst_db(out, one_out)
            same = {name: bool(torch.equal(state[k], one_state[k]))
                    for k, name in enumerate(("phase", "filter_a",
                                              "filter_b", "filter_c",
                                              "seed"))}
            check = (f"against (1, 1): worst {db} dB, bit-equal audio "
                     f"{bool(np.array_equal(out, one_out))}, final state "
                     f"bit-equal {same}")
            if nd == 1 and not (db < TOL_DB and same["seed"]
                                and same["phase"]):
                raise AssertionError(f"[17 sharding] {tag}: {check}")
            if ns == 1 and not np.array_equal(out, one_out):
                diff = float(np.abs(out - one_out).max())
                if db >= SP_DP_DB:
                    raise AssertionError(f"[17 sharding] {tag}: {check}, "
                                         f"max-abs {diff}")
                check += f", max-abs {diff} (held at {SP_DP_DB} dB)"
        ranks = [{"coord": r["coord"], "backend": r["backend"],
                  "wall_ms": statistics.median(r["wall_ms"]),
                  "sp_core_ms": statistics.median(r["core_ms"]),
                  "gather_ms": r["gather_ms"],
                  "peak_bytes": r["peak_bytes"]} for r in rs]
        summary["meshes"][tag] = dict(
            backend=backend, ranks=ranks, ops_per_call=rs[0]["ops"],
            wall_ms=max(x["wall_ms"] for x in ranks), spawn_s=spawn_s,
            check=check)
        label = ("one rank on the card" if world == 1 else
                 f"{world} ranks sharing one card, not a scaling figure")
        print(f"[17 sharding] mesh {tag} over {backend} ({label}): "
              f"sharded_pipeline({B} texts, T={T}) {check}; no kernel "
              f"launched; wall ms per call (median of {SP_REPS}, slowest "
              f"rank) {summary['meshes'][tag]['wall_ms']}; per rank "
              f"{json.dumps(ranks)}; torch ops per call (rank 0) "
              f"{rs[0]['ops']}; spawn {spawn_s:.1f} s; card {card}",
              flush=True)
    print(f"[17 sharding] the single-process xla program on the same batch "
          f"({T // 4096} blocks): {xla_ms} ms (host clock, one run); card "
          f"{card}", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_sharding.json"),
              "w") as f:
        json.dump(summary, f, indent=1)
    shutil.rmtree(work, ignore_errors=True)
    return summary


def pool_mesh_phase(card):
    """Phase 19, the mesh-sharded StreamPool at the serving cell's width:
    the unsharded pool on the card (POOL_MESH_TICKS eager ticks, save(),
    POOL_MESH_CONT ticks) written to build/chip_smoke_pool_mesh/, then one
    spawn of parallel/_ranks.pool_chip_case ranks per mesh of POOL_MESHES,
    which check themselves against it (see pool_chip_case) and save their
    numbers. Prints a line per mesh and writes
    chiprun_out/chip_smoke_pool_mesh.json. Returns the numbers."""
    import shutil

    import torch

    from grail_tpu_torch.parallel import _ranks
    from grail_tpu_torch.runtime import stream as st

    n, blk = SERVE_N[-1], SERVE_BLOCK
    texts = [SERVE_TEXTS[i % len(SERVE_TEXTS)] for i in range(n)]
    work = os.path.join(ROOT, "build", "chip_smoke_pool_mesh")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    pool = st.StreamPool(n, voice="plain", language="english", block=blk,
                         pin_elems=64)
    for i, t in enumerate(texts):
        pool.feed(i, t)
        pool.flush(i)
    rows = torch.cat([pool.read_block(sync=False)
                      for _ in range(POOL_MESH_TICKS)], 1).cpu()
    blob = pool.save()
    cont = torch.cat([pool.read_block(sync=False)
                      for _ in range(POOL_MESH_CONT)], 1).cpu()
    del pool
    torch.cuda.empty_cache()
    torch.save(dict(n=n, block=blk, texts=texts, ticks=POOL_MESH_TICKS,
                    rows=rows, blob=blob, cont=cont),
               os.path.join(work, "pool_mesh.pt"))

    summary = {"n": n, "block": blk, "card": card, "meshes": {}}
    for nd, ns, backend in POOL_MESHES:
        world, tag = nd * ns, f"{nd}x{ns}"
        t0 = time.perf_counter()
        _ranks.spawn(_ranks.pool_chip_case, world,
                     (world, nd, ns, work, backend, POOL_MESH_PLAIN),
                     POOL_MESH_TIMEOUT)
        spawn_s = time.perf_counter() - t0
        rs = _ranks.load_results(work, f"card_pool_{tag}", world)
        summary["meshes"][tag] = dict(backend=backend, spawn_s=spawn_s,
                                      ranks=rs)
        label = ("one rank on the card" if world == 1 else
                 f"{world} ranks sharing one card and one host, not a "
                 "scaling figure")
        print(f"[19 pool mesh] mesh {tag} over {backend} ({label}): "
              f"StreamPool({n}, block {blk}, pin_elems=64, mesh), every "
              f"session fed; per rank {POOL_MESH_TICKS} eager ticks "
              f"bit-equal to the unsharded pool, ticks "
              f"{list(POOL_MESH_PLAIN)} to the plain version, one "
              f"fused_synth_carry a tick, no host->card copy in ticks 2-"
              f"{POOL_MESH_TICKS - 1}; save() equal to the unsharded blob "
              f"and {POOL_MESH_CONT} ticks after it bit-equal (rank 0 also "
              f"in an unsharded pool); {POOL_MESH_TICKS} served ticks "
              f"bit-equal to a twin's read_block, a feed to session 1 at "
              f"tick 3; per rank {json.dumps(rs)}; spawn {spawn_s:.1f} s; "
              f"card {card}", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           "chip_smoke_pool_mesh.json"), "w") as f:
        json.dump(summary, f, indent=1)
    shutil.rmtree(work, ignore_errors=True)
    return summary


@contextlib.contextmanager
def _twins():
    """The port's host frontend with the Python and numpy versions of the
    three native loops (transcription, drift boundaries, jitter schedule)
    in place of the host library: the baseline phase 18 times it against."""
    from grail_tpu_torch.runtime import native as rn
    from grail_tpu_torch.synth import schedule as sch
    from grail_tpu_torch.synth import score as sc
    from grail_tpu_torch.text.transcribe import transcribe_chars

    saved = (rn.native_transcribe, sc.native_drift_boundaries,
             sch.native_jitter_schedule)
    rn.native_transcribe = lambda text, language: list(
        transcribe_chars(text, language))
    sc.native_drift_boundaries = sc._reference_boundary_samples_np
    sch.native_jitter_schedule = sch._np_simulate
    try:
        yield
    finally:
        (rn.native_transcribe, sc.native_drift_boundaries,
         sch.native_jitter_schedule) = saved


def turns(fn_native, fn_twin, reps=REPS):
    """(native ms, twin ms): host-clock medians of `reps` runs of each,
    taken in turns after one warm-up run of each; fn_twin runs inside
    _twins()."""
    tn, tp = [], []
    for k in range(reps + 1):
        for fn, ctx, out in ((fn_native, contextlib.nullcontext, tn),
                             (fn_twin, _twins, tp)):
            with ctx():
                t0 = time.perf_counter()
                fn()
                ms = (time.perf_counter() - t0) * 1e3
            if k:
                out.append(ms)
    return statistics.median(tn), statistics.median(tp)


def native_tier_phase(card, texts):
    """Phase 18: the native host tier. Checks, at full width: the native
    transcriber against the Python automaton, the native drift boundaries
    against the numpy twin (counts and residual bits), the long-form
    route's jitter schedule window against the numpy twin (bits). Then the
    times (see the module docstring). Returns the numbers."""
    import numpy as np
    import torch

    import grail_tpu_torch as g
    import grail_tpu_torch.api as papi
    from grail_tpu_torch.languages import get_language
    from grail_tpu_torch.runtime import native as rn
    from grail_tpu_torch.runtime import stream as st
    from grail_tpu_torch.synth import schedule as sch
    from grail_tpu_torch.synth import score as sc
    from grail_tpu_torch.text.intonate import intonate
    from grail_tpu_torch.text.transcribe import transcribe, transcribe_chars

    tag = "[18 native host tier]"
    t0 = time.perf_counter()
    rn.load_library()
    load_s = time.perf_counter() - t0
    voice, lvoice = g.get_voice("generic"), g.get_voice(LONG_VOICE)
    gen, en = get_language("generic"), get_language(LONG_LANGUAGE)
    items = [(t, gen, voice) for t in texts] + [(LONG_EN, en, lvoice)]

    # ---- checks --------------------------------------------------------
    n_ph = 0
    for t, lang, _ in items:
        got = [int(p) for p in rn.native_transcribe(t, lang)]
        if got != [int(p) for p in transcribe_chars(t, lang)]:
            raise AssertionError(f"{tag} transcription of {t[:20]!r} "
                                 f"differs from the Python automaton")
        n_ph += len(got)
    lengths = [(np.float32([pe.length for pe in sc.merge_glides(
        g.text_to_phoneme_elems(t, v, lang))]), float(v.sample_rate))
        for t, lang, v in items]
    n_el = 0
    for L, sr in lengths:
        (a_c, a_r), (b_c, b_r) = (rn.native_drift_boundaries(L, sr),
                                  sc._reference_boundary_samples_np(L, sr))
        if not (np.array_equal(a_c, b_c) and np.array_equal(
                a_r.view(np.uint32), np.asarray(b_r).view(np.uint32))):
            raise AssertionError(f"{tag} drift boundaries differ from the "
                                 f"numpy twin")
        n_el += len(L)
    drift_samples = int(sum(sc._reference_boundary_samples_np(L, sr)[0][-1]
                            for L, sr in lengths))
    N_long = papi._score_num_samples(
        g.text_to_score(LONG_EN, lvoice, LONG_LANGUAGE),
        float(lvoice.sample_rate))
    inc = np.float32(lvoice.jitter_frequency)
    phi, cell = sch.PhaseSchedule(inc).window(0, N_long)
    phi_p, cell_p = np.empty(N_long, np.float32), np.empty(N_long, np.int32)
    wraps = sch._np_simulate(inc, np.float32(0.0), N_long, phi_p, cell_p)
    if not (np.array_equal(phi.view(np.uint32), phi_p.view(np.uint32))
            and np.array_equal(cell, cell_p)):
        raise AssertionError(f"{tag} the jitter schedule window differs "
                             f"from the numpy twin")
    print(f"{tag} host library {os.path.relpath(rn.build_info['path'], ROOT)}"
          f" (built in {rn.build_info['seconds']} s when first loaded in "
          f"this process; {load_s} s here); transcription of {len(texts)} "
          f"texts and long_en ({n_ph} phonemes) equal to the Python "
          f"automaton; drift boundaries of their {n_el} elements "
          f"({drift_samples} samples) equal to the numpy twin, counts and "
          f"residual bits; the long-form jitter schedule window "
          f"({N_long} samples, {wraps} wraps) bit-equal to the numpy twin",
          flush=True)

    # ---- each binding beside its twin -------------------------------------
    out = {"card": card, "samples_long": N_long, "phonemes": n_ph,
           "elements": n_el, "drift_samples": drift_samples}
    def transcribe_all():
        return [transcribe(t, lang) for t, lang, _ in items]

    def drift_all():
        return [sc._reference_boundary_samples(L, sr) for L, sr in lengths]

    def jitter_long():
        return sch._simulate(inc, np.float32(0.0), N_long, phi, cell)

    out["binding"] = {name: dict(zip(("native_ms", "twin_ms"), turns(fn, fn)))
                      for name, fn in (("transcription", transcribe_all),
                                       ("drift_boundaries", drift_all),
                                       ("jitter_schedule", jitter_long))}
    print(f"{tag} each binding beside its Python or numpy twin (host clock, "
          f"median of {REPS}, in turns): " + "; ".join(
              f"{k} {v['native_ms']} ms vs {v['twin_ms']} ms "
              f"({v['twin_ms'] / v['native_ms']}x)"
              for k, v in out["binding"].items())
          + f" (transcription and drift: the {len(texts)} texts and long_en;"
          f" jitter: {N_long} steps); card {card}", flush=True)

    # ---- the B = 64 host frontend by stage --------------------------------
    phs = [transcribe(t, gen) for t in texts]
    pels = [intonate(ph, gen, voice, contour=False, speaking_rate=1.0)
            for ph in phs]
    if [list(p) for p in pels] != [list(g.text_to_phoneme_elems(t))
                                   for t in texts]:
        raise AssertionError(f"{tag} the stage breakdown does not rebuild "
                             f"text_to_phoneme_elems")
    sr = float(voice.sample_rate)
    n_refs = [sc._reference_boundary_samples(
        [pe.length for pe in sc.merge_glides(p)], sr)[0] for p in pels]
    scores = [sc.score_from_phoneme_elems(p, voice, n_ref=n)
              for p, n in zip(pels, n_refs)]

    def stack_pad():
        batch = papi._Batch(scores, voice, None)
        return sc.stack_scores(batch.scores)

    stages = {
        "transcription": lambda: [transcribe(t, gen) for t in texts],
        "intonation": lambda: [intonate(ph, gen, voice, contour=False,
                                        speaking_rate=1.0) for ph in phs],
        "drift_boundaries": lambda: [sc._reference_boundary_samples(
            [pe.length for pe in sc.merge_glides(p)], sr) for p in pels],
        "score_build": lambda: [sc.score_from_phoneme_elems(
            p, voice, n_ref=n) for p, n in zip(pels, n_refs)],
        "stack_and_pad": stack_pad,
        "frontend": lambda: [g.text_to_score(t) for t in texts]}
    out["frontend_b64"] = {
        name: dict(zip(("native_ms", "twin_ms"), turns(fn, fn)))
        for name, fn in stages.items()}
    print(f"{tag} the B = {len(texts)} host frontend by stage (host clock, "
          f"median of {REPS}, with the host library and with the twins in "
          f"turns): " + "; ".join(
              f"{k} {v['native_ms']} ms (twins {v['twin_ms']} ms)"
              for k, v in out["frontend_b64"].items())
          + "; the score build is merge_glides, selection by the voice "
          f"table and the boundary retargeting, the drift given; card "
          f"{card}", flush=True)

    # ---- StreamPool's first tick --------------------------------------------
    out["first_tick"] = {}
    for n in SERVE_N:
        serve_texts = [SERVE_TEXTS[i % len(SERVE_TEXTS)] for i in range(n)]
        times = {"feed": [], "first": []}

        def first_tick():
            pool = st.StreamPool(n, voice="plain", language="english",
                                 block=SERVE_BLOCK)
            t0 = time.perf_counter()
            for i in range(n):
                pool.feed(i, serve_texts[i])
            pool.flush()
            t1 = time.perf_counter()
            pool.read_block()
            t2 = time.perf_counter()
            times["feed"].append((t1 - t0) * 1e3)
            times["first"].append((t2 - t1) * 1e3)
            del pool
            torch.cuda.empty_cache()

        first_native, first_twin = turns(first_tick, first_tick)
        out["first_tick"][n] = {
            "native_ms": first_native, "twin_ms": first_twin,
            "first_tick_native_ms": statistics.median(times["first"][2::2]),
            "first_tick_twin_ms": statistics.median(times["first"][3::2]),
            "feed_native_ms": statistics.median(times["feed"][2::2]),
            "feed_twin_ms": statistics.median(times["feed"][3::2])}
    print(f"{tag} StreamPool(N, device='cuda') feeding N texts and its first "
          f"tick (all scores built and uploaded; host clock, median of "
          f"{REPS}, in turns): " + "; ".join(
              f"N={n}: first tick {v['first_tick_native_ms']} ms (twins "
              f"{v['first_tick_twin_ms']} ms), feed {v['feed_native_ms']} ms "
              f"(twins {v['feed_twin_ms']} ms)"
              for n, v in out["first_tick"].items())
          + f"; card {card}", flush=True)
    path = os.path.join(ROOT, "chiprun_out", "chip_smoke_native.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return out


def scaling(texts, batch, T, card, zero_state, dev):
    """Unsplit kernel time against the batch size, the exact carrier's
    cost, both kernels' times against the segment count S, and the host
    frontend's two stages; printed and written to chiprun_out/."""
    import torch

    import grail_tpu_torch as g
    import grail_tpu_torch.api as papi
    from grail_tpu_torch.api import BLOCK_SIZE, _round_up
    from grail_tpu_torch.synth import kernel as pk
    from grail_tpu_torch.synth import kernel_fused as kf
    from grail_tpu_torch.synth.schedule import device_window
    from grail_tpu_torch.synth.score import score_from_phoneme_elems

    voice = g.get_voice("generic")
    out = {"card": card, "T": T, "kernel_ms_by_B": {},
           "slots": kf.fused_synth_slots(dev),
           "choose_split": {}, "split_ms_by_S": {}}
    phi, cell = device_window(voice.jitter_frequency, 0, T, dev)
    for nb in SCALING_B:
        sub = papi._Batch([batch.scores[i % B] for i in range(nb)], voice,
                          None)
        tables = sub.tables(T, dev)
        sf, si = zero_state(nb)
        for kcar in (False, True) if nb == B else (False,):
            ms = median_ms(lambda: kf.fused_synth_cuda(
                tables, phi, cell, sf, si, T, kcar))
            if kcar:
                out["kernel_ms_kcar_B64"] = ms
            else:
                out["kernel_ms_by_B"][nb] = ms
        del tables
        torch.cuda.empty_cache()
    solo = papi._Batch([g.text_to_score(SOLO_TEXT)], voice, None)
    for nb, sub in ((B, batch), (1, solo)):
        maxN = max(sub.Ns)
        out["choose_split"][nb] = g.route(nb, maxN, None, dev,
                                          voice.sample_rate)[2:]
        rows = out["split_ms_by_S"][nb] = {}
        for S in SCALING_S[nb]:
            TS = _round_up(maxN, S * BLOCK_SIZE)
            if S == 1:
                tables = sub.tables(TS, dev)
                ph, ce = device_window(voice.jitter_frequency, 0, TS, dev)
                sf, si = zero_state(nb)
                rows[S] = {"T": TS, "fused_synth_ms": median_ms(
                    lambda: kf.fused_synth_cuda(tables, ph, ce, sf, si, TS,
                                                False))}
            else:
                sp = split_inputs(papi, kf, sub, TS, S, dev)
                rows[S] = {
                    "T": TS,
                    "phase_q32_pre_ms": median_ms(lambda: kf.phase_q32_pre_cuda(
                        sp["tables"], *sp["pre"], TS)),
                    "fused_synth_ms": median_ms(lambda: kf.fused_synth_cuda(
                        *sp["args"], g0=sp["g0"])),
                    "program_ms": median_ms(lambda: papi._split_program(
                        sp["tables"], TS, S, "kernel",
                        voice.jitter_frequency))}
                del sp
            torch.cuda.empty_cache()
    # the core backend: its program and kernel 3 over S
    sr, inc = float(voice.sample_rate), voice.jitter_frequency
    out["core_max_lanes"] = pk.CORE_MAX_LANES
    out["core_choose_split"], out["core_ms_by_S"] = {}, {}
    for nb, sub in ((B, batch), (1, solo)):
        maxN = max(sub.Ns)
        out["core_choose_split"][nb] = g.route(nb, maxN, None, dev, sr,
                                               "core")[2:]
        rows = out["core_ms_by_S"][nb] = {}
        for S in SCALING_S_CORE[nb]:
            TS = _round_up(maxN, S * BLOCK_SIZE)
            lanes = sub.core_lanes(TS, dev)
            setup = (papi._core_split_setup(lanes, TS, S, sr, inc) if S > 1
                     else papi._core_unsplit_setup(lanes, TS, sr, inc))
            streams = pk.precompute_streams(setup.frames(0)[0],
                                            setup.state)[0]
            lp, b, c = (x.T.contiguous() for x in setup.state[1:4])
            blk_ms = median_ms(lambda: pk.synth_core_cuda(streams, lp, b, c))
            program_ms, call_ms, calls = time_core_program(
                core_program(papi, lanes, TS, S, sr, inc))
            rows[S] = {"T": TS, "lanes": S * nb, "blocks": calls,
                       "synth_core_block_ms": blk_ms,
                       "synth_core_call_ms": call_ms,
                       "program_ms": program_ms}
            del lanes, setup, streams
            torch.cuda.empty_cache()
    pelems = [g.text_to_phoneme_elems(t) for t in texts]
    out["text_to_phoneme_elems_ms"] = host_ms(
        lambda: [g.text_to_phoneme_elems(t) for t in texts])
    out["score_from_phoneme_elems_ms"] = host_ms(
        lambda: [score_from_phoneme_elems(p, voice) for p in pelems])
    print(f"[scaling] fused_synth unsplit T={T} q32 kernel ms by B "
          f"{out['kernel_ms_by_B']}; kcar at B={B} "
          f"{out['kernel_ms_kcar_B64']} ms (CUDA events, median of {REPS}); "
          f"slots {out['slots']}; route's (S, T) {out['choose_split']}; "
          f"split ms by S (B=64 texts; B=1 {SOLO_TEXT!r}) "
          f"{json.dumps(out['split_ms_by_S'])}; host, {B} texts: "
          f"text_to_phoneme_elems {out['text_to_phoneme_elems_ms']} ms, "
          f"score_from_phoneme_elems {out['score_from_phoneme_elems_ms']} "
          f"ms; card {card}", flush=True)
    print(f"[scaling] core backend: at most {out['core_max_lanes']} "
          f"lanes; route's "
          f"(S, T) {out['core_choose_split']}; by S (B=64 texts; B=1 "
          f"{SOLO_TEXT!r}) {json.dumps(out['core_ms_by_S'])}; card {card}",
          flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_scaling.json"),
              "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
