"""Rank bodies for the sharded programs: the CPU tests' cases
(tests/test_torch_parallel.py, tests/test_torch_pool_mesh.py) and the
card's phases of chip_smoke.py (17: sharded_pipeline; 19: the mesh pool).

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

from ..runtime.stream import StreamPool, _tick
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


# ---- the mesh-sharded StreamPool -------------------------------------------

def mesh_pool(mesh, n: int, texts, **kw):
    """StreamPool(n, voice plain, english, mesh=mesh, **kw) with texts[i]
    fed to session i (every rank feeds every text: the owners keep theirs,
    the other ranks drop them)."""
    pool = StreamPool(n, voice="plain", language="english", mesh=mesh, **kw)
    for i, t in enumerate(texts):
        pool.feed(i, t)
        pool.flush(i)
    return pool


def _rows(pool, ticks: int) -> torch.Tensor:
    """`ticks` read_blocks of a pool, concatenated [rows, ticks*block]."""
    return torch.cat([torch.as_tensor(pool.read_block())
                      for _ in range(ticks)], dim=1)


def pool_cpu_cases(rank: int, world: int, n_data: int, n_seq: int,
                   workdir: str, cases: tuple):
    """The mesh pool's CPU cases on a gloo mesh of (n_data, n_seq), inputs
    from workdir/pool_inputs.pt (n, block, texts, ticks, feed_tick and the
    unsharded pool's blob, written by the test):

      rows   pcm16 and f32 pools: `ticks` ticks of this rank's rows; the
             f32 pool's save() after them and its next `ticks` ticks;
      load   a fresh mesh pool loading the unsharded blob: its `ticks`;
      serve  serve mode with a feed to session 1 at `feed_tick` (published
             by _serve_build), beside a twin's read_block without the feed;
      bad    the ValueError message of each configuration (None where it
             did not raise): n = 6, backend 'xla', block 441, device
             'cuda' on the CPU mesh; of a bad inline command, and of an
             unterminated one at flush, to every session; every session's
             element count after the feeds.

    Saves {case: result} to workdir/pool_<mesh>_r<rank>.pt."""
    tag = f"pool_{n_data}x{n_seq}"
    _join(rank, world, workdir, tag, "gloo", "cpu")
    try:
        inp = torch.load(os.path.join(workdir, "pool_inputs.pt"),
                         weights_only=False)
        n, blk, texts, ticks = (inp[k] for k in ("n", "block", "texts",
                                                 "ticks"))
        mesh = make_mesh(n_data, n_seq, "cpu")
        res = {"coord": (mesh.get_local_rank("data"),
                         mesh.get_local_rank("seq"))}
        if "rows" in cases:
            for output in ("pcm16", "f32"):     # the f32 pool goes on
                pool = mesh_pool(mesh, n, texts, block=blk, output=output)
                res["local"] = pool.local_sessions
                res[f"rows_{output}"] = _rows(pool, ticks)
            res["blob"] = pool.save()
            res["cont"] = _rows(pool, ticks)
        if "load" in cases:
            pool = StreamPool(n, voice="plain", language="english",
                              block=blk, mesh=mesh)
            pool.load(inp["blob"])
            res["load"] = _rows(pool, ticks)
        if "serve" in cases:
            twin = mesh_pool(mesh, n, texts, block=blk, pin_elems=64)
            ref = [torch.as_tensor(twin.read_block()) for _ in range(6)]
            pool = mesh_pool(mesh, n, texts, block=blk, pin_elems=64)
            pool.serve_start(period=9999)
            got = []
            try:
                for k in range(len(ref)):
                    if k == inp["feed_tick"]:
                        pool.feed(1, " more")
                        pool.flush(1)
                        pool._serve_build()
                    got.append(pool.serve_tick())
            finally:
                pool.serve_stop()
            res["serve"] = (got, ref)
        if "bad" in cases:
            pool = mesh_pool(mesh, n, texts, block=blk)
            other = mesh_pool(mesh, n, texts, block=blk)
            bad = dict(zip(("n6", "xla", "block441", "device"), _errors(
                lambda: StreamPool(6, mesh=mesh),
                lambda: StreamPool(n, mesh=mesh, backend="xla"),
                lambda: StreamPool(n, mesh=mesh, block=441),
                lambda: StreamPool(n, mesh=mesh, device="cuda"))))
            bad["command"] = _errors(*(
                lambda i=i: pool.feed(i, "hi [wat:1]", parse_commands=True)
                for i in range(n)))
            bad["fragment"] = _errors(*(
                lambda i=i: (other.feed(i, "[pitch:9", parse_commands=True),
                             other.flush(i)) for i in range(n)))
            res["bad"] = bad
            res["elements"] = [len(s._elements) for s in pool.sessions]
        torch.save(res, os.path.join(workdir, f"{tag}_r{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _h2d_copies(fn) -> int:
    """Copies from the host to the card that one call of fn dispatches
    (aten ops that read a CPU tensor and write a CUDA one)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    def on(x, kind):
        return isinstance(x, torch.Tensor) and x.device.type == kind

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if (any(on(x, "cpu") and x.dim() for x in tree_leaves(
                    (args, kwargs))) and any(on(x, "cuda")
                                              for x in tree_leaves(out))):
                Count.n += 1
            return out

    with Count():
        fn()
    return Count.n


def _cuda_ms(fn, reps: int = 5) -> float:
    """fn's time on the card: CUDA events around each of `reps` calls
    after a warm-up, the median."""
    fn()
    times = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        fn()
        ev[1].record()
        torch.cuda.synchronize()
        times.append(ev[0].elapsed_time(ev[1]))
    return float(np.median(times))


def _host_ms(fn, reps: int = 5) -> float:
    """fn's time on the host clock, ending in a synchronize: the median of
    `reps` calls."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _blob_diffs(blob: bytes, want: bytes) -> list:
    """The keys where two pool blobs differ (names, order, dtypes or
    values)."""
    import io

    a, b = np.load(io.BytesIO(blob)), np.load(io.BytesIO(want))
    if a.files != b.files:
        return ["<keys>"]
    return [k for k in a.files if a[k].dtype != b[k].dtype
            or not np.array_equal(a[k], b[k])]


def pool_chip_case(rank: int, world: int, n_data: int, n_seq: int,
                   workdir: str, backend: str, check: tuple):
    """The mesh pool on the card, every rank on cuda:0 over `backend`, with
    workdir/pool_mesh.pt's inputs (n, block, texts, the unsharded pool's
    rows of `ticks` eager ticks, its blob after them and its rows of the
    `cont` ticks after that, all from the parent):

      * `ticks` eager read_blocks of this rank's rows bit-equal to the
        unsharded rows; at the ticks in `check`, audio, sf and si bit-equal
        to the plain carry version on the same inputs and state; the
        fused_synth_carry launches (one a tick, no other kernel) and the
        host->card copies dispatched in ticks 2.. (0);
      * save() (collective) equal to the unsharded blob array for array;
        the next `cont` ticks bit-equal; rank 0 loads the blob into an
        unsharded pool on the card, which continues bit-equal;
      * serve mode on a mesh pool loaded from the blob: `ticks` served
        ticks (one replay each, its launch counted) with a feed to session
        1 at tick 3, bit-equal to a twin's read_block at ticks 0-2 and on
        every other session at every tick;
      * times: feeding, the first tick (the host pass over the rank's
        sessions), steady read_block (host clock), the tick program and
        the graph replay (CUDA events).

    Any failed check raises. Saves the numbers to
    workdir/card_pool_<mesh>_r<rank>.pt."""
    tag = f"card_pool_{n_data}x{n_seq}"
    _join(rank, world, workdir, tag, backend, "cuda")
    try:
        inp = torch.load(os.path.join(workdir, "pool_mesh.pt"),
                         weights_only=False)
        n, blk, texts, ticks = (inp[k] for k in ("n", "block", "texts",
                                                 "ticks"))
        mesh = make_mesh(n_data, n_seq, "cuda")
        kw = dict(block=blk, pin_elems=64)
        label = f"[19 pool mesh] {n_data}x{n_seq} rank {rank}"

        def fail(what):
            raise AssertionError(f"{label}: {what}")

        t0 = time.perf_counter()
        pool = mesh_pool(mesh, n, texts, **kw)
        feed_ms = (time.perf_counter() - t0) * 1e3
        lo, hi = pool._lo, pool._hi
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        rows, h2d, max_abs = [], 0, 0.0
        for t in range(ticks):
            if t in check:
                sf0, si0 = pool._sf.clone(), pool._si.clone()
            t0 = time.perf_counter()
            if t >= 2:
                box = []
                h2d += _h2d_copies(
                    lambda: box.append(pool.read_block(sync=False)))
                a = box[0]
            else:
                a = pool.read_block(sync=False)
            torch.cuda.synchronize()
            if t == 0:
                first_ms = (time.perf_counter() - t0) * 1e3
            if t in check:
                ins = dict(pool._dev, offsets=pool._dev["offsets"] - blk)
                ref = _tick("plain", ins, sf0, si0, blk)
                for name, x, y in zip(("audio", "sf", "si"),
                                      (a, pool._sf, pool._si), ref):
                    max_abs = max(max_abs, float(
                        (x.double() - y.double()).abs().max()))
                    if not torch.equal(x, y):
                        fail(f"tick {t}: the carry kernel's {name} differs "
                             "from the plain version's")
            rows.append(a.cpu())
        launches = dict(LAUNCHES)
        carry = launches.pop("fused_synth_carry")
        if carry != ticks or any(launches.values()):
            fail(f"launches {dict(LAUNCHES)} for {ticks} ticks")
        if h2d:
            fail(f"{h2d} host->card copies in steady ticks")
        if not torch.equal(torch.cat(rows, 1), inp["rows"][lo:hi]):
            fail("eager rows differ from the unsharded pool's")

        blob = pool.save()
        diffs = _blob_diffs(blob, inp["blob"])
        if diffs:
            fail(f"save() differs from the unsharded blob at {diffs[:5]}")
        cont = inp["cont"]
        got = torch.cat([pool.read_block(sync=False).cpu()
                         for _ in range(cont.shape[1] // blk)], 1)
        if not torch.equal(got, cont[lo:hi]):
            fail("the ticks after save() differ from the unsharded pool's")
        if rank == 0:
            one = StreamPool(n, voice="plain", language="english", **kw)
            one.load(blob)
            got = torch.cat([one.read_block(sync=False).cpu()
                             for _ in range(cont.shape[1] // blk)], 1)
            if not torch.equal(got, cont):
                fail("the mesh blob continues otherwise in an unsharded "
                     "pool")
            del one

        # times on the pool that went on
        read_ms = _host_ms(pool.read_block)
        dev = pool._prepare_tick()
        tick = pool._tick_program(blk)
        tick_ms = _cuda_ms(lambda: tick(dev, pool._sf, pool._si))

        # serve mode against a twin, both from the blob
        twin = StreamPool(n, voice="plain", language="english", mesh=mesh,
                          **kw)
        twin.load(blob)
        ref = [twin.read_block(sync=False) for _ in range(ticks)]
        srv = StreamPool(n, voice="plain", language="english", mesh=mesh,
                         **kw)
        srv.load(blob)
        srv.serve_start(period=9999)
        try:
            n0 = LAUNCHES["fused_synth_carry"]
            got = []
            for t in range(ticks):
                if t == 3:
                    srv.feed(1, " more")
                    srv.flush(1)
                    srv._serve_build()
                got.append(srv.serve_tick())
            torch.cuda.synchronize()
            served = LAUNCHES["fused_synth_carry"] - n0
            replay_ms = _cuda_ms(srv._serve_cur["graph"].replay)
        finally:
            srv.serve_stop()
        if served != ticks:
            fail(f"{served} carry launches for {ticks} served ticks")
        others = [j for j, i in enumerate(range(lo, hi)) if i != 1]
        for t, (a, b) in enumerate(zip(got, ref)):
            if (t < 3 and not torch.equal(a, b)) or not torch.equal(
                    a[others], b[others]):
                fail(f"served tick {t} differs from the twin's read_block")
        res = dict(coord=(mesh.get_local_rank("data"),
                          mesh.get_local_rank("seq")),
                   sessions=(lo, hi), backend=dist.get_backend(),
                   launches_per_tick=carry / ticks,
                   served_launches_per_tick=served / ticks,
                   h2d_steady=h2d, max_abs_err=max_abs,
                   feed_ms=feed_ms, first_tick_ms=first_ms,
                   read_block_ms=read_ms, tick_ms=tick_ms,
                   replay_ms=replay_ms, captures=srv._serve_captures)
        torch.save(res, os.path.join(workdir, f"{tag}_r{rank}.pt"))
    finally:
        dist.destroy_process_group()


def load_results(workdir: str, tag: str, world: int) -> list:
    """The saved results of a spawn's ranks, in rank order."""
    return [torch.load(os.path.join(workdir, f"{tag}_r{r}.pt"),
                       weights_only=False) for r in range(world)]


__all__ = ["spawn", "local_shard", "cpu_cases", "chip_case", "mesh_pool",
           "pool_cpu_cases", "pool_chip_case", "load_results"]
