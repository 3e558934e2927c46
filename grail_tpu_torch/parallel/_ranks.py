"""Rank bodies for the sharded program: the CPU tests' cases
(tests/test_torch_parallel.py) and the card's phase of chip_smoke.py.

A spawned child re-imports its target's module, so the targets live here,
in a module that imports no jax (the test module does). Each rank joins a
process group through a `file://` rendezvous under the caller's work
directory (no TCP port), builds the mesh, runs its cases, and saves what
the parent compares with torch.save into that directory. The parent
(`spawn`) starts the ranks with the spawn method, never fork (the parent
may hold threads), and waits for them with a deadline.
"""

from __future__ import annotations

import os
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..synth._build import LAUNCHES
from ..synth.elem import SynthesisElem
from . import sharded
from .sharded import make_mesh, sharded_pipeline, synthesize_block_sp

_PG_TIMEOUT = timedelta(seconds=300)


def spawn(fn, nprocs: int, args: tuple, timeout: float):
    """Run fn(rank, *args) in `nprocs` spawned processes; raise if one
    fails (its traceback in the message) or if they are not all done after
    `timeout` seconds (then every one is killed)."""
    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks of {fn.__name__} still "
                                   f"running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)


def _join(rank: int, world: int, workdir: str, tag: str, backend: str,
          device: str):
    """Join the group of this spawn: one thread of torch per rank (many
    ranks share the host's cores), the card's device 0 for "cuda" (NCCL
    bound to it)."""
    torch.set_num_threads(1)
    bound = None
    if device == "cuda":
        torch.cuda.set_device(0)
        bound = torch.device("cuda", 0) if backend == "nccl" else None
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(workdir, f"{tag}.pg"),
        rank=rank, world_size=world, timeout=_PG_TIMEOUT, device_id=bound)


def local_shard(fields, d: int, n_data: int, i: int, n_seq: int, device):
    """Rank (d, i)'s shard of global time-major frames (seven numpy arrays
    [T, B(, 8)]): rows i * T/n_seq.., lanes d * B/n_data.., as tensors."""
    T, B = np.shape(fields[0])[:2]
    tl, bl = T // n_seq, B // n_data
    return SynthesisElem(*(torch.as_tensor(
        np.ascontiguousarray(np.asarray(x)[i * tl:(i + 1) * tl,
                                           d * bl:(d + 1) * bl]),
        dtype=torch.float32, device=device) for x in fields))


def _errors(*calls) -> list:
    """The ValueError message of each call (None where it did not raise)."""
    out = []
    for call in calls:
        try:
            call()
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def cpu_cases(rank: int, world: int, n_data: int, n_seq: int, workdir: str,
              cases: tuple):
    """The CPU tests' cases on a gloo mesh of (n_data, n_seq), inputs from
    workdir/inputs.pt (written by the test):

      sp    synthesize_block_sp of the 'sp' frames from the zero state:
            this rank's audio [T_local, B_local] and final state;
      cont  the 'cont' frames as two blocks, the second from the first's
            state: this rank's audio of each;
      pipe  sharded_pipeline of the 'pipe' batch: the global [B, T];
      bad   T % n_seq != 0 to sharded_pipeline and a mesh that does not
            fill the world: their ValueError messages.

    Saves {case: result} to workdir/<mesh>_r<rank>.pt."""
    tag = f"{n_data}x{n_seq}"
    _join(rank, world, workdir, tag, "gloo", "cpu")
    try:
        inp = torch.load(os.path.join(workdir, "inputs.pt"),
                         weights_only=False)
        mesh = make_mesh(n_data, n_seq, "cpu")
        d, i = mesh.get_local_rank("data"), mesh.get_local_rank("seq")
        res = {"coord": (d, i)}
        if "sp" in cases:
            out, st = synthesize_block_sp(
                local_shard(inp["sp"], d, n_data, i, n_seq, "cpu"), mesh)
            res["sp"] = (out, tuple(st))
        if "cont" in cases:
            e = inp["cont"]
            half = np.shape(e[0])[0] // 2
            h1, st = synthesize_block_sp(local_shard(
                [x[:half] for x in e], d, n_data, i, n_seq, "cpu"), mesh)
            h2, _ = synthesize_block_sp(local_shard(
                [x[half:] for x in e], d, n_data, i, n_seq, "cpu"), mesh, st)
            res["cont"] = (h1, h2)
        if "pipe" in cases:
            res["pipe"] = sharded_pipeline(*inp["pipe"], mesh)
        if "bad" in cases:
            score, lat, jp, sr, T = inp["pipe"]
            res["bad"] = _errors(
                lambda: sharded_pipeline(score, lat, jp, sr, T + 1, mesh),
                lambda: make_mesh(world, world, "cpu"))
        torch.save(res, os.path.join(workdir, f"{tag}_r{rank}.pt"))
    finally:
        dist.destroy_process_group()


class _Probe:
    """Times the sp core (CUDA events around each _sp_core call) and, when
    `sync` is set, each gather (host clock between two synchronizes, which
    stalls the program: only in a call of its own); keeps the last final
    state. Installed over sharded's module functions in this rank only."""

    def __init__(self):
        self.core, self.gathers, self.sync, self.state = [], [], False, None
        self._core, self._gather = sharded._sp_core, sharded._gather
        sharded._sp_core = self._timed_core
        sharded._gather = self._timed_gather

    def _timed_core(self, *args):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = self._core(*args)
        ev[1].record()
        self.core.append(ev)
        self.state = out[1]
        return out

    def _timed_gather(self, t, group=None):
        if not self.sync:
            return self._gather(t, group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self._gather(t, group)
        torch.cuda.synchronize()
        self.gathers.append((time.perf_counter() - t0) * 1e3)
        return out

    def core_ms(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.core)


def _op_count(fn) -> int:
    """aten operations that one call of fn dispatches."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def chip_case(rank: int, world: int, n_data: int, n_seq: int, workdir: str,
              backend: str, reps: int):
    """sharded_pipeline of workdir/batch.pt's batch on a (n_data, n_seq)
    mesh whose ranks all use cuda:0, over `backend`: a warm-up call, a call
    with each gather timed alone, `reps` timed calls (host clock between a
    barrier and a synchronize; the sp core by CUDA events) with the peak
    of allocated device memory over them, and one call under an op counter.
    Saves the output [B, T] (rank 0), the final state of this rank's lanes,
    its numbers and its kernel launch counts (the sp path launches none) to
    workdir/<mesh>_r<rank>.pt."""
    tag = f"card_{n_data}x{n_seq}"
    _join(rank, world, workdir, tag, backend, "cuda")
    try:
        score, lat, jp, sr, T = torch.load(
            os.path.join(workdir, "batch.pt"), weights_only=False)
        mesh = make_mesh(n_data, n_seq, "cuda")
        probe = _Probe()

        def run():
            out = sharded_pipeline(score, lat, jp, sr, T, mesh)
            torch.cuda.synchronize()
            return out

        run()
        probe.sync = True
        run()
        gathers = list(probe.gathers)
        probe.sync = False
        torch.cuda.reset_peak_memory_stats()
        walls, cores = [], []
        for _ in range(reps):
            dist.barrier()
            torch.cuda.synchronize()
            probe.core = []
            t0 = time.perf_counter()
            out = run()
            walls.append((time.perf_counter() - t0) * 1e3)
            cores.append(probe.core_ms())
        peak = torch.cuda.max_memory_allocated()
        ops = _op_count(run)
        res = {"coord": (mesh.get_local_rank("data"),
                         mesh.get_local_rank("seq")),
               "state": tuple(x.cpu() for x in probe.state),
               "wall_ms": walls, "core_ms": cores, "gather_ms": gathers,
               "peak_bytes": peak, "ops": ops,
               "backend": dist.get_backend(), "launches": dict(LAUNCHES)}
        if rank == 0:
            res["out"] = out.cpu()
        torch.save(res, os.path.join(workdir, f"{tag}_r{rank}.pt"))
    finally:
        dist.destroy_process_group()


def load_results(workdir: str, tag: str, world: int) -> list:
    """The saved results of a spawn's ranks, in rank order."""
    return [torch.load(os.path.join(workdir, f"{tag}_r{r}.pt"),
                       weights_only=False) for r in range(world)]


__all__ = ["spawn", "local_shard", "cpu_cases", "chip_case", "load_results"]
