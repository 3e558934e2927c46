"""Rank bodies of the CPU tests of the sharded programs
(tests/test_torch_parallel.py: sharded_pipeline and synthesize_block_sp;
tests/test_torch_pool_mesh.py: the mesh pool).

A spawned child re-imports its target's module, so the targets live here,
in a module that imports no jax (the test modules do). Each rank joins a
gloo process group through a `file://` rendezvous under the caller's work
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

from ..runtime.stream import StreamPool
from ..synth.elem import SynthesisElem
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


def _join(rank: int, world: int, workdir: str, tag: str):
    """Join the gloo group of this spawn, with one thread of torch per rank
    (many ranks share the host's cores)."""
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, f"{tag}.pg"),
        rank=rank, world_size=world, timeout=_PG_TIMEOUT)


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
    _join(rank, world, workdir, tag)
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
    _join(rank, world, workdir, tag)
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


def load_results(workdir: str, tag: str, world: int) -> list:
    """The saved results of a spawn's ranks, in rank order."""
    return [torch.load(os.path.join(workdir, f"{tag}_r{r}.pt"),
                       weights_only=False) for r in range(world)]


__all__ = ["spawn", "local_shard", "cpu_cases", "mesh_pool", "pool_cpu_cases",
           "load_results"]
