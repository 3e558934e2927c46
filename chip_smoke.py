#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA GPU.

    python3 chip_smoke.py

Run it from the root of a checkout: it builds the fused kernel from the
checkout's sources (nvcc, into build/grail_tpu_torch/) and imports nothing
of JAX. Phases, one line each; any failure raises and exits non-zero:

  1. device — needs torch.cuda; prints nvidia-smi's name and power limit.
  2. build — compiles grail_tpu_torch/synth/csrc/fused_synth.cu.
  3. kernel vs plain — bench.py's 64 texts, voice generic, T = 65536, both
     carrier modes: final integer state bit-equal, audio < -100 dB per
     utterance and max-abs <= 1e-5 against the plain PyTorch version on the
     same card.
  4. main path — synthesize_batch(64 texts, device="cuda"): the kernel's
     launch count must advance; outputs finite, of length
     floor(cum_length[-1] * sr); two short utterances held against the
     device="cpu" path at < -100 dB.
  5. kernel vs plain and timing at the phase-4 shapes (B = 64 and the T
     synthesize_batch pads to, seeds 0, Q32): the kernel's output held
     against one run of the plain version as in phase 3; the kernel's time
     (CUDA events, median of 5 after a warm-up) beside the plain run's; the
     host stages, the end-to-end synthesize_batch wall time and aggregate
     x realtime, each beside the card's name and power limit.

Then one JSON line naming each kernel with its launches, error and times,
and the last line {"ok": true, "device": {...}}.

    python3 chip_smoke.py --scaling

adds, before the JSON lines, the kernel's time at B = 1 ... 1056 over the
phase-4 T, the exact carrier's at B = 64, and the host frontend split into
text_to_phoneme_elems and score_from_phoneme_elems; it also writes them to
chiprun_out/chip_smoke_scaling.json.
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
B = 64
SCALING_B = (1, 64, 132, 264, 528, 1056)
T_CHECK = 65536
REPS = 5
TOL_DB = -100.0
TOL_ABS = 1e-5


def bench_texts():
    """bench.py's batch: 64 texts of 8-15 characters ("aeae...")."""
    return [("aeae" * 4)[: 8 + (i % 8)] for i in range(B)]


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
             if "registers" in ln]
    print(f"[2 build] {os.path.relpath(_build.build_info['path'], ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc "
          f"{_build.build_info['seconds']:.2f} s); {'; '.join(ptxas)}",
          flush=True)

    import grail_tpu_torch as g
    from grail_tpu_torch.api import BLOCK_SIZE, _round_up, _score_num_samples
    from grail_tpu_torch.synth import kernel_fused as kf
    from grail_tpu_torch.synth.jitter import JitterLattice, build_lattice
    from grail_tpu_torch.synth.schedule import device_window
    from grail_tpu_torch.synth.score import pad_score, stack_scores
    from grail_tpu_torch.utils import sample_error_db

    texts = bench_texts()
    voice = g.get_voice("generic")
    sr = float(voice.sample_rate)
    inc = voice.jitter_frequency
    jparams = (inc, voice.jitter_delta_frequency,
               voice.jitter_delta_formant_frequency,
               voice.jitter_delta_amplitude)

    def frontend():   # what synthesize_batch runs on the host per batch
        scores = [g.text_to_score(t) for t in texts]
        E = max(s.num_elems for s in scores)
        return [pad_score(s, E) for s in scores]

    def tables_for(T, scores):
        # seed 0 for every utterance, as synthesize_batch defaults to: one
        # lattice, stacked per utterance
        lat = build_lattice(0, T, inc)
        lats = JitterLattice(*(np.stack([f] * len(scores)) for f in lat))
        return (kf.build_tables(stack_scores(scores), lats, jparams, sr,
                                device=dev),
                device_window(inc, 0, T, dev))

    def zero_state(nb=B):
        return (torch.zeros(nb, 24, dtype=torch.float32, device=dev),
                torch.zeros(nb, 3, dtype=torch.int32, device=dev))

    def check(label, k, r):
        """Kernel output k against plain output r, both (audio, sf, si):
        integer state bit-equal, audio < TOL_DB per utterance and max-abs
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
              f"max-abs {err}, worst utterance {db} dB, filter state "
              f"max-abs {sf_err}, bit-equal samples "
              f"{float((a == p).mean())}", flush=True)
        return err

    # ---- 3: kernel vs plain on the card --------------------------------
    scores = frontend()
    tables, (phi, cell) = tables_for(T_CHECK, scores)
    sf, si = zero_state()
    max_abs = 0.0
    for kcar in (False, True):
        args = (tables, phi, cell, sf, si, T_CHECK, kcar)
        max_abs = max(max_abs, check(
            f"[3] carrier={'kcar' if kcar else 'q32'} B={B} T={T_CHECK}",
            kf.fused_synth_cuda(*args), kf.synth_fused_reference(*args)))

    # ---- 4: the main path ----------------------------------------------
    kf.LAUNCHES["fused_synth"] = 0
    outs = g.synthesize_batch(texts, device="cuda")
    torch.cuda.synchronize()
    launches = kf.LAUNCHES["fused_synth"]
    if launches < 1:
        raise AssertionError("synthesize_batch did not launch fused_synth")
    Ns = [_score_num_samples(s, sr) for s in scores]
    for t, o, n in zip(texts, outs, Ns):
        if o.device.type != "cuda" or tuple(o.shape) != (n,):
            raise AssertionError(f"{t!r}: output {tuple(o.shape)} on "
                                 f"{o.device}, expected ({n},) on cuda")
        if not bool(torch.isfinite(o).all()):
            raise AssertionError(f"{t!r}: non-finite output")
    short = ["ae", "ea"]
    on_card = [o.cpu().numpy() for o in g.synthesize_batch(short,
                                                           device="cuda")]
    on_cpu = [o.numpy() for o in g.synthesize_batch(short, device="cpu")]
    db_cpu = [sample_error_db(a, b) for a, b in zip(on_card, on_cpu)]
    if not all(len(a) == len(b) for a, b in zip(on_card, on_cpu)) or \
            not all(d < TOL_DB for d in db_cpu):
        raise AssertionError(f"cuda vs cpu path: {db_cpu} dB")
    audio_s = sum(Ns) / sr
    print(f"[4 main path] synthesize_batch({B} texts, device='cuda'): "
          f"fused_synth launches {launches}; {B} finite outputs of "
          f"floor(cum_length[-1]*sr) samples, {audio_s:.3f} s of audio; "
          f"'ae','ea' cuda vs cpu path {db_cpu} dB", flush=True)

    # ---- 5: kernel vs plain, and timing, at the phase-4 shapes ---------
    T = _round_up(max(Ns), BLOCK_SIZE)
    tables, (phi, cell) = tables_for(T, scores)
    sf, si = zero_state()
    args = (tables, phi, cell, sf, si, T, False)
    kernel_ms = median_ms(lambda: kf.fused_synth_cuda(*args))
    k_out = kf.fused_synth_cuda(*args)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    r_out = kf.synth_fused_reference(*args)
    e1.record()
    torch.cuda.synchronize()
    plain_ms = e0.elapsed_time(e1)
    max_abs = max(max_abs, check(f"[5] carrier=q32 B={B} T={T}", k_out,
                                 r_out))
    del k_out, r_out
    print(f"[5 timing] fused_synth B={B} T={T} q32: kernel {kernel_ms} ms "
          f"(CUDA events, median of {REPS}), plain PyTorch {plain_ms} ms "
          f"(CUDA events, one run); card {card}", flush=True)

    def host_ms(fn, sync=False):
        times = []
        for _ in range(REPS + 1):
            t0 = time.perf_counter()
            fn()
            if sync:
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times[1:])

    front_ms = host_ms(frontend)
    upload_ms = host_ms(lambda: tables_for(T, scores), sync=True)

    def e2e():
        g.synthesize_batch(texts, device="cuda")

    e2e_ms = host_ms(e2e, sync=True)
    print(f"[5 timing] host frontend {front_ms} ms, lattices + table build "
          f"and upload {upload_ms} ms (schedule memoized), end-to-end synthesize_batch "
          f"{e2e_ms} ms for {audio_s:.3f} s of audio: aggregate "
          f"{audio_s / (e2e_ms / 1e3)} x realtime end to end, "
          f"{audio_s / (kernel_ms / 1e3)} x realtime in the kernel; "
          f"card {card}", flush=True)

    if "--scaling" in sys.argv[1:]:
        scaling(texts, scores, T, tables_for, zero_state, host_ms, card)

    print(json.dumps({"kernels": [{
        "name": "fused_synth", "route": "cuda",
        "source": "grail_tpu_torch/synth/csrc/fused_synth.cu",
        "replaces": "grail_tpu/synth/kernel_fused.py:420",
        "launches": launches, "max_abs_err": max_abs,
        "ms": kernel_ms, "plain_ms": plain_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


def scaling(texts, scores, T, tables_for, zero_state, host_ms, card):
    """Kernel time against the batch size, the exact carrier's cost, and the
    host frontend's two stages; printed and written to chiprun_out/."""
    import torch

    import grail_tpu_torch as g
    from grail_tpu_torch.synth import kernel_fused as kf
    from grail_tpu_torch.synth.score import score_from_phoneme_elems

    out = {"card": card, "T": T, "kernel_ms_by_B": {}}
    for nb in SCALING_B:
        tables, (phi, cell) = tables_for(T, [scores[i % B]
                                             for i in range(nb)])
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
    voice = g.get_voice("generic")
    pelems = [g.text_to_phoneme_elems(t) for t in texts]
    out["text_to_phoneme_elems_ms"] = host_ms(
        lambda: [g.text_to_phoneme_elems(t) for t in texts])
    out["score_from_phoneme_elems_ms"] = host_ms(
        lambda: [score_from_phoneme_elems(p, voice) for p in pelems])
    print(f"[6 scaling] fused_synth T={T} q32 kernel ms by B "
          f"{out['kernel_ms_by_B']}; kcar at B={B} "
          f"{out['kernel_ms_kcar_B64']} ms (CUDA events, median of {REPS}); "
          f"host, {B} texts: text_to_phoneme_elems "
          f"{out['text_to_phoneme_elems_ms']} ms, score_from_phoneme_elems "
          f"{out['score_from_phoneme_elems_ms']} ms; card {card}", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_scaling.json"),
              "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
