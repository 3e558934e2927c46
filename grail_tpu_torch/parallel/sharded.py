"""dp x sp synthesis and the sharded serving tick over torch.distributed:
the counterpart of grail_tpu/parallel/sharded.py (make_mesh, _sp_core,
synthesize_block_sp, sharded_pipeline, sharded_stream_tick_fn).

Batched synthesis has no cross-utterance reductions, so data parallelism
('data') shards utterances and needs no collective at all. Sequence
parallelism ('seq') splits one utterance's time axis: its four per-sample
recurrences (Q32 carrier phase, Lehmer noise, one-pole lowpass, the 2x2
SVF bank) are affine, so each shard

  1. computes its local cumulative operators (affine_scan_cum /
     svf_scan_cum of synth/synthesize.py, JAX's odd/even tree),
  2. all_gathers the per-shard totals over 'seq' ([B, 8]-sized tensors),
  3. folds the totals of the shards before it into its incoming state,
  4. applies them locally.

The carrier's prefix is the wrapped uint32 sum of the earlier shards' Q32
totals (one gather of [B] values); the noise needs none, its states are
closed-form (core/rng.py's skip tables at the shard's offset). The
arithmetic and its order are grail_tpu's, so the phase and the seeds equal
its bit for bit and the filters agree to float rounding.

torch runs SPMD: one process per rank, where JAX runs one controller over
a device mesh. So a mesh here is a torch.distributed DeviceMesh with dims
("data", "seq") over an initialised default process group, each rank owning
its device, and each rank passes and gets back its own shard where
grail_tpu's functions take and return global arrays (sharded_pipeline is
the exception: it returns the global [B, T] on every rank). The backend is
the caller's choice (init_process_group): NCCL for one rank per card, gloo
on the CPU or for ranks that share a card. Under gloo the small totals of
CUDA tensors are staged through the host explicitly; nothing switches
backend or device on a failure, a failed collective raises.

Like grail_tpu's, the sp core is plain tensor code with the Q32 carrier
only, and it reaches no kernel.

Serving (sharded_stream_tick_fn, behind StreamPool(mesh=)) shards sessions
over 'data' and is embarrassingly parallel: each rank runs the fused
synthesizer's carry tick on the sessions it owns, with no collective.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.approx import exp_approx
from ..core.rng import MASK32, _block_tables, mul32, random_f32_from_state
from ..synth.elem import SynthesisElem
from ..synth.jitter import (JitterLattice, apply_jitter, lattice_to,
                            sched_slice)
from ..synth.schedule import device_window
from ..synth.score import Score
from ..synth.sequencer import expand_score
from ..synth.synthesize import (_INV_Q32, _Q32, SynthState, _polyblep,
                                _svf_coeffs, affine_scan_cum, q32_carrier,
                                svf_scan_cum)

_DIMS = ("data", "seq")


def make_mesh(n_data: int, n_seq: int = 1, device="cuda"):
    """The ("data", "seq") DeviceMesh of shape (n_data, n_seq) over the
    default process group, whose world size must be n_data * n_seq: rank r
    sits at (r // n_seq, r % n_seq), so the ranks of one data row are
    consecutive and 'seq' coordinate j is rank j of that row's group.

    grail_tpu's third parameter is a list of devices; under SPMD each rank
    owns its device, so here it is the device type ("cuda" or "cpu"; an
    index is dropped). The caller initialises the group (its backend, and
    on a card torch.cuda.set_device) first; anything else raises
    ValueError, where grail_tpu asserts."""
    n_data, n_seq = int(n_data), int(n_seq)
    if n_data < 1 or n_seq < 1:
        raise ValueError(f"mesh ({n_data}, {n_seq}) needs positive sizes")
    if not dist.is_initialized():
        raise ValueError("make_mesh needs an initialised default process "
                         "group (torch.distributed.init_process_group) "
                         f"of {n_data * n_seq} ranks")
    world = dist.get_world_size()
    if world != n_data * n_seq:
        raise ValueError(f"mesh ({n_data}, {n_seq}) needs a world of "
                         f"{n_data * n_seq} ranks, the group has {world}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(torch.device(device).type, (n_data, n_seq),
                            mesh_dim_names=_DIMS)


class _Shard(NamedTuple):
    """This rank's place in a mesh."""

    n_data: int
    d: int            # 'data' coordinate
    n_seq: int
    i: int            # 'seq' coordinate
    seq: object       # the 'seq' process group of this rank's data row
    ranks: list       # world ranks in mesh order (row-major)


def _shard(mesh) -> _Shard:
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if names != _DIMS:
        raise ValueError(f"mesh dims {names}, expected {_DIMS} (make_mesh)")
    ranks = mesh.mesh.flatten().tolist()
    if len(ranks) != dist.get_world_size():
        raise ValueError(f"the mesh covers {len(ranks)} of "
                         f"{dist.get_world_size()} ranks")
    nd, ns = mesh.mesh.shape
    return _Shard(int(nd), mesh.get_local_rank("data"), int(ns),
                  mesh.get_local_rank("seq"), mesh.get_group("seq"), ranks)


def _row_objects(obj, mesh) -> list:
    """all_gather_object of this rank's `obj` over the mesh; the objects of
    'seq' coordinate 0 of each data row, in 'data' order (the ranks of a
    row replicate it). Collective: every rank calls it, on the thread that
    makes the group's other calls."""
    sh = _shard(mesh)
    objs = [None] * dist.get_world_size()
    dist.all_gather_object(objs, obj)
    return [objs[sh.ranks[d * sh.n_seq]] for d in range(sh.n_data)]


def _gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """all_gather of `t` over `group` (None: the world), stacked on a new
    leading axis in the group's rank order; a group of one rank (a mesh
    axis of size 1) has nothing to gather. gloo's path for a CUDA tensor
    stages it through the host, explicitly."""
    n = dist.get_world_size(group)
    if n == 1:
        return t[None]
    staged = t.is_cuda and dist.get_backend(group) == "gloo"
    src = t.cpu() if staged else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.stack(parts)
    return out.to(t.device) if staged else out


def _sp_core(elems: SynthesisElem, state: SynthState, T_total: int, mesh):
    """Shard-local body: this rank's frames [T_local, B_local(, 8)] of an
    utterance batch of T_total samples and the utterance-initial state of
    its lanes -> (audio [T_local, B_local], the final state, the same on
    every 'seq' rank of a data row). grail_tpu/parallel/sharded.py:55."""
    sh = _shard(mesh)
    i, ns = sh.i, sh.n_seq
    T_local = elems.frequency.shape[0]
    off = i * T_local
    f = elems.frequency

    # carrier phase: Q32 fixed point, the prefix the wrapped sum of the
    # earlier shards' totals (int64 sums masked to 32 bits)
    fT = f.movedim(0, -1)                                    # [B, T_local]
    tots = _gather((fT * _Q32).to(torch.int64).sum(-1) & MASK32, sh.seq)
    p0q = (torch.remainder(state.phase, 1.0) * _Q32).to(torch.int64)
    phase, _ = q32_carrier(fT, (p0q + tots[:i].sum(0)) & MASK32)
    phase = phase.movedim(-1, 0)
    phase_final = ((p0q + tots.sum(0)) & MASK32).to(torch.float32) * _INV_Q32
    pb = _polyblep(phase, f)
    saw = (2.0 * phase - 1.0 - pb)[..., None]
    del phase, pb

    # Lehmer noise: the closed-form states of samples off+1 .. off+T_local
    pa, sa = _block_tables(T_total, str(f.device))           # k = 1..T_total
    states = (mul32(pa[off:off + T_local, None], state.seed)
              + sa[off:off + T_local, None]) & MASK32
    noise = random_f32_from_state(states)[..., None]
    seed_final = (mul32(pa[-1], state.seed) + sa[-1]) & MASK32
    del states

    # breath blend + lowpass (distributed affine scan)
    breath = elems.formant_breath
    noise_wave = saw * (1.0 - breath) + noise * breath
    del saw
    alpha = exp_approx(elems.formant_smooth)
    A, Bc = affine_scan_cum(alpha, (1.0 - alpha) * noise_wave)
    del noise_wave, alpha
    lp = _gather(torch.stack([A[-1], Bc[-1]]), sh.seq)       # [ns, 2, B, 8]
    lp_in = lp_final = state.filter_state_a
    for j in range(ns):
        if j < i:
            lp_in = lp[j, 0] * lp_in + lp[j, 1]
        lp_final = lp[j, 0] * lp_final + lp[j, 1]
    state_a = A * lp_in + Bc
    del A, Bc

    turb = (1.0 - elems.formant_turb) + noise * elems.formant_turb
    v0 = (state_a * turb) * elems.formant_amp
    del turb, state_a, noise

    # SVF bank (distributed 2x2 affine scan); the output reads the state
    # before each update
    a1, a2, a3 = _svf_coeffs(elems)
    m11 = 2.0 * a1 - 1.0
    m12 = -2.0 * a2
    m21 = 2.0 * a2
    m22 = 1.0 - 2.0 * a3
    cum = svf_scan_cum(m11, m12, m21, m22, m21 * v0, 2.0 * a3 * v0)
    del m11, m12, m21, m22
    svf = _gather(torch.stack([c[-1] for c in cum]), sh.seq)  # [ns, 6, B, 8]
    b_in, c_in = state.filter_state_b, state.filter_state_c
    b_final, c_final = b_in, c_in
    for j in range(ns):
        t11, t12, t21, t22, tw1, tw2 = svf[j]
        if j < i:
            b_in, c_in = (t11 * b_in + t12 * c_in + tw1,
                          t21 * b_in + t22 * c_in + tw2)
        b_final, c_final = (t11 * b_final + t12 * c_final + tw1,
                            t21 * b_final + t22 * c_final + tw2)
    b_post = cum[0] * b_in + cum[1] * c_in + cum[4]
    c_post = cum[2] * b_in + cum[3] * c_in + cum[5]
    del cum

    b_pre = torch.cat([b_in[None], b_post[:-1]])
    c_pre = torch.cat([c_in[None], c_post[:-1]])
    del b_post, c_post
    v1 = a1 * b_pre + a2 * (v0 - c_pre)
    out = torch.sum(v1, dim=-1) * 0.5
    return out, SynthState(phase=phase_final, filter_state_a=lp_final,
                           filter_state_b=b_final, filter_state_c=c_final,
                           seed=seed_final)


def synthesize_block_sp(elems: SynthesisElem, mesh,
                        state: Optional[SynthState] = None
                        ) -> Tuple[torch.Tensor, SynthState]:
    """Sequence + data parallel synthesis of one time-major block.

    Each rank passes its own shard of the [T, B(, 8)] frames: rows
    i * T_local .. (i + 1) * T_local of the utterances of its data row,
    [T_local, B_local(, 8)] with T = n_seq * T_local, and gets back (its
    audio [T_local, B_local], the final SynthState of its B_local lanes,
    the same on every 'seq' rank). grail_tpu takes and returns global
    arrays; here the shards stay local, because the seven streams whole on
    every rank would cost ~4.4 GB a rank at B = 64, T = 360,448. `state`
    (None: the zero state) is the block-initial state of the rank's
    lanes."""
    T_local, B_local = elems.frequency.shape[:2]
    if T_local < 1:
        raise ValueError("empty shard")
    if state is None:
        state = SynthState.init(B_local, elems.frequency.device)
    return _sp_core(elems, state, T_local * _shard(mesh).n_seq, mesh)


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def sharded_pipeline(score_batch: Score, lattice_batch: JitterLattice,
                     jparams, sample_rate, T: int, mesh, sched=None
                     ) -> torch.Tensor:
    """The dp x sp pipeline: a batched Score [B, E, ...] (host numpy, as
    stack_scores gives it) and its lattices -> audio [B, T] on every rank.

    Every rank receives the whole batch and takes its 'data' rows (B must
    divide by n_data) and its 'seq' window of samples offset + 1 .. offset +
    T_local, offset = i * T_local (T must divide by n_seq): it expands and
    jitters them (expand_score(..., offset=), apply_jitter with its window
    of the schedule), runs the sp core from the zero state, zeroes samples
    past each utterance's end, and all-gathers the [B_local, T_local]
    blocks over the whole mesh, so every rank returns the global [B, T], as
    grail_tpu's global array reads to any caller. dp adds no collective.

    `jparams` = (jitter rate, jdf, jdff, jda), one value each, as in
    grail_tpu (one voice's); `sched` = (phi [T], cell [T]), the jitter
    schedule of samples 1..T (synth/schedule.py), built from the rate when
    None."""
    sh = _shard(mesh)
    B = int(np.shape(score_batch.length)[0])
    T = int(T)
    if T % sh.n_seq or B % sh.n_data:
        raise ValueError(f"T={T} and B={B} must divide by the mesh's "
                         f"(n_data, n_seq) = ({sh.n_data}, {sh.n_seq})")
    dev = _mesh_device(mesh)
    T_local, B_local = T // sh.n_seq, B // sh.n_data
    off = sh.i * T_local
    rows = slice(sh.d * B_local, (sh.d + 1) * B_local)
    jf, jdf, jdff, jda = jparams
    if sched is None:
        sched = device_window(jf, 0, T, dev)
    sched = tuple(torch.as_tensor(x, device=dev) for x in sched)

    score = Score(score_batch.elem[rows], *(np.asarray(x)[rows] for x in
                                            score_batch[1:])).to(dev)
    lattice = lattice_to(JitterLattice(*(np.asarray(x)[rows]
                                         for x in lattice_batch)), dev)
    elems, valid = expand_score(score, float(sample_rate), T_local,
                                offset=off)
    elems = apply_jitter(elems, lattice, *(float(np.float32(x))
                                           for x in (jdf, jdff, jda)),
                         sched_slice(sched, off, T_local))
    elems = SynthesisElem(*(x.transpose(0, 1) for x in elems))
    out, _ = _sp_core(elems, SynthState.init(B_local, dev), T, mesh)
    del elems
    blocks = _gather(out.T * valid)                 # [world, B_local, T_l]
    blocks = blocks[sh.ranks].reshape(sh.n_data, sh.n_seq, B_local, T_local)
    return blocks.permute(0, 2, 1, 3).reshape(B, T)


def sharded_stream_tick_fn(mesh, block: int, interpret: bool = False,
                           out_fmt: str = "f32", lat_window=None):
    """Multi-GPU serving: the StreamPool tick of `block` samples for the
    sessions this rank owns, with sessions sharded over the mesh's 'data'
    axis (grail_tpu's shard_map with every input P('data') and the jitter
    rate P()). Serving is embarrassingly parallel across sessions, so the
    tick has no collective: each rank launches the fused synthesizer's
    carry mode (runtime.stream._tick; the CUDA kernel on a card, its plain
    version only on a CPU mesh) over its rows and converts the audio to
    `out_fmt` ('f32', 'pcm16' or 'ulaw') there. The per-lane arithmetic
    does not depend on the lane count and the port contracts no a*b+c, so
    a rank's rows equal the unsharded pool's bit for bit (grail_tpu's match
    to ~1 ulp).

    Returns tick(dev, sf, si) -> (audio [B_local, block], sf, si). Where
    grail_tpu's program takes the global scores, lattices, jitter
    parameters, offsets, jitter state and SynthState and returns global
    arrays, the port's takes what one rank holds, in the port's state
    layout: `dev`, the device tables of its B_local sessions (score tables
    n/scal/vec/par, the lattice window `lat` and `lat_base`, `offsets`,
    the jitter rate `inc`; StreamPool._prepare_tick builds them), and the
    carried rows sf f32 [B_local, 24] and si int32 [B_local, 5], the jitter
    state in si's last two columns. The offsets are not advanced (the pool
    does that on the device).

    `interpret` is accepted for grail_tpu's callers and changes nothing:
    the mesh's device decides, as 'fused_interpret' is another name for
    'fused'. `lat_window` is accepted too and unused: the kernel reads its
    lattice rows by absolute cell (cell - lat_base) from the window, so
    grail_tpu's truncation of the window has no counterpart."""
    from ..runtime.stream import _OUTPUTS, _converted_tick, _impl

    _shard(mesh)
    if out_fmt not in _OUTPUTS:
        raise ValueError(f"out_fmt must be one of {sorted(_OUTPUTS)}, got "
                         f"{out_fmt!r}")
    return functools.partial(_converted_tick, _impl(_mesh_device(mesh)),
                             "fused", int(block), out_fmt)


__all__ = ["make_mesh", "synthesize_block_sp", "sharded_pipeline",
           "sharded_stream_tick_fn"]
