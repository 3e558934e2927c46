"""The FP32 issue-rate probe: sustained multiply-add throughput of the card.

Counterpart of benchmarks/vpu_peak.py (the JAX package's measured vector
peak on a TPU core). The kernel, synth/csrc/fma_peak.cu, updates every
element of an f32 tile `iters` times by x = x * a + b, once per grid step,
in registers, and stores each step's result: out [grid, n]. It has two
variants, because the port's kernels are built with -fmad=false and so
issue a multiply and an add where a data sheet counts one fused
multiply-add as two operations:

  * 'mul_add': __fmul_rn then __fadd_rn, two instructions per update, the
    instruction mix the port's kernels issue. Its rate, in instructions
    per second over all lanes, shows how close unfused code comes to the
    card's peak instruction rate (PEAK_FP32_INSTRUCTIONS, half the data
    sheet's FLOP/s), which is the operations bound of those kernels.
  * 'fma': __fmaf_rn, one instruction per update, two floating-point
    operations: the figure a data sheet states.

`fma_peak_reference` is the plain version (a loop of x * a + b in torch);
'mul_add' equals it bit for bit, 'fma' rounds once per update instead of
twice, so it agrees within `iters` ulps of a value near 1. `fma_peak` runs
the kernel for a CUDA tensor and the plain version for a CPU tensor.
`measure` times both variants on the card with CUDA events.

    python -m grail_tpu_torch.benchmarks.fma_peak      # one JSON line
"""

from __future__ import annotations

import json
import statistics
import sys

import torch

from ..synth._build import LAUNCHES, raise_on

TILE = (256, 8, 128)     # the tile of benchmarks/vpu_peak.py
GRID = 8                 # and its grid steps
ITERS = 4096
REPS = 5                 # timed launches per variant; the median is kept
A, B = 1.0000001, -1e-7  # keep the values near 1.0: no denormals
VARIANTS = ("mul_add", "fma")
# the data sheet's FP32 rate of an H100 SXM outside the tensor cores, in
# floating-point operations per second; it counts an FMA as two, so the
# card's peak FP32 instruction rate (FFMA, FMUL and FADD alike: one per lane
# and clock) is half of it
DATASHEET_FP32_FLOPS = 67e12
PEAK_FP32_INSTRUCTIONS = DATASHEET_FP32_FLOPS / 2


def fma_peak_reference(x: torch.Tensor, grid: int = GRID, iters: int = ITERS,
                       a: float = A, b: float = B) -> torch.Tensor:
    """Plain PyTorch version: `iters` updates x = x * a + b (each product
    and each sum rounded to f32), the same for every grid step: [grid, n]."""
    a32 = torch.tensor(a, dtype=torch.float32, device=x.device)
    b32 = torch.tensor(b, dtype=torch.float32, device=x.device)
    v = x.reshape(-1).to(torch.float32).clone()
    for _ in range(iters):
        v = v * a32 + b32
    return v.expand(grid, -1).contiguous()


def fma_peak_cuda(x: torch.Tensor, grid: int = GRID, iters: int = ITERS,
                  variant: str = "mul_add", a: float = A,
                  b: float = B) -> torch.Tensor:
    """Launch synth/csrc/fma_peak.cu on the current stream: out [grid, n]
    for the f32 CUDA tensor x (n elements, contiguous)."""
    import ctypes

    from ..synth._build import load_library

    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    if x.device.type != "cuda" or x.dtype != torch.float32 \
            or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous float32 CUDA tensor, got "
                         f"{x.dtype} on {x.device}")
    n = x.numel()
    lib = load_library()
    blk = lib.grail_fma_peak_block()
    if grid < 1 or iters < 0 or n < 1 or (grid * n) % blk \
            or grid * n >= 2 ** 31:
        raise ValueError(f"need grid >= 1, iters >= 0 and grid * n a "
                         f"multiple of {blk} below 2^31, got grid={grid}, "
                         f"n={n}, iters={iters}")
    out = torch.empty(grid, n, dtype=torch.float32, device=x.device)
    p = ctypes.c_void_p
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.grail_fma_peak(p(x.data_ptr()), p(out.data_ptr()), n, grid,
                                iters, a, b, int(variant == "fma"), p(stream))
        LAUNCHES["fma_peak"] += 1
    raise_on(lib, rc, "fma_peak kernel launch")
    return out


def fma_peak(x: torch.Tensor, grid: int = GRID, iters: int = ITERS,
             variant: str = "mul_add") -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return fma_peak_reference(x, grid, iters)
    return fma_peak_cuda(x, grid, iters, variant)


def instructions(n: int, grid: int, iters: int, variant: str) -> int:
    """FP32 instructions (one per lane) the probe issues in one launch."""
    return n * grid * iters * (2 if variant == "mul_add" else 1)


def measure(iters: int = ITERS, device="cuda") -> dict:
    """Time both variants on the card at TILE and GRID (CUDA events, median
    of REPS after one warm-up launch). Per variant: device ms, instructions
    issued per second with their share of the card's peak instruction rate,
    and floating-point operations per second (an FMA counts as two) with
    their share of the data sheet's rate."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("the probe measures a card: device must be CUDA")
    x = torch.ones(TILE, dtype=torch.float32, device=dev)
    n = x.numel()
    out = {"shape": list(TILE), "grid": GRID, "iters": iters,
           "device": torch.cuda.get_device_name(dev)}
    for variant in VARIANTS:
        fma_peak_cuda(x, GRID, iters, variant)
        torch.cuda.synchronize(dev)
        times = []
        for _ in range(REPS):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fma_peak_cuda(x, GRID, iters, variant)
            e1.record()
            torch.cuda.synchronize(dev)
            times.append(e0.elapsed_time(e1))
        ms = statistics.median(times)
        ins = instructions(n, GRID, iters, variant) / (ms * 1e-3)
        flops = ins * (2 if variant == "fma" else 1)
        out[variant] = {"ms": ms, "instructions_per_s": ins,
                        "peak_share": ins / PEAK_FP32_INSTRUCTIONS,
                        "flops_per_s": flops,
                        "datasheet_share": flops / DATASHEET_FP32_FLOPS}
    return out


def main() -> int:
    print(json.dumps(measure()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
