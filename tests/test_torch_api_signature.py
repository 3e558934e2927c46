"""The port's public names against grail_tpu's.

Each function or class that both packages export takes grail_tpu's
parameters, in grail_tpu's order and with its defaults, so that a
positional call means the same in both; the port may add `device`, last.
Also the two names the port lacked: Score.total_seconds and
oracle.native_oracle_available. `transcribe` and the host library's shared
names (runtime/native.py) are held the same way.
"""

import inspect

import numpy as np
import pytest
import torch

import grail_tpu.api as japi
from grail_tpu.oracle import reference as jref
from grail_tpu.parallel import sharded as jsharded
from grail_tpu.runtime import native as jnative
from grail_tpu.runtime import stream as jstream
from grail_tpu.synth.score import stack_scores as jstack_scores
from grail_tpu.text.transcribe import transcribe as jtranscribe
from grail_tpu.voices.preset_generic import SPEC as JSPEC

import grail_tpu_torch.api as papi
from grail_tpu_torch import convert, oracle
from grail_tpu_torch.parallel import sharded as psharded
from grail_tpu_torch.runtime import native as pnative
from grail_tpu_torch.runtime import stream as pstream
from grail_tpu_torch.text.transcribe import transcribe as ptranscribe
from grail_tpu_torch.voices.preset_generic import SPEC as PSPEC

torch.set_num_threads(2)

PAIRS = [(name, getattr(japi, name), getattr(papi, name))
         for name in japi.__all__ if hasattr(papi, name)] + [
    ("StreamSession", jstream.StreamSession, pstream.StreamSession),
    ("StreamPool", jstream.StreamPool, pstream.StreamPool),
    ("synthesize_block_sp", jsharded.synthesize_block_sp,
     psharded.synthesize_block_sp),
    ("sharded_pipeline", jsharded.sharded_pipeline,
     psharded.sharded_pipeline),
    ("sharded_stream_tick_fn", jsharded.sharded_stream_tick_fn,
     psharded.sharded_stream_tick_fn),
    ("transcribe", jtranscribe, ptranscribe),
] + [(name, getattr(jnative, name), getattr(pnative, name))
     for name in ("native_transcribe", "native_drift_boundaries",
                  "native_jitter_schedule", "native_encode_wav",
                  "NativeRuleset", "available")]


def _params(fn):
    return list(inspect.signature(fn).parameters.values())


def _same(j, p):
    return [(x.name, x.kind, x.default) for x in j] == \
        [(x.name, x.kind, x.default) for x in p]


def test_every_entry_point_is_covered():
    names = {name for name, _, _ in PAIRS}
    assert {"synthesize", "synthesize_batch", "synthesize_scores",
            "synthesize_score", "text_to_score",
            "text_to_phoneme_elems"} <= names


@pytest.mark.parametrize("name,jfn,pfn", PAIRS, ids=[p[0] for p in PAIRS])
def test_parameters_follow_grail_tpu(name, jfn, pfn):
    j, p = _params(jfn), _params(pfn)
    assert _same(j, p[:len(j)]), (name, [x.name for x in p])
    assert [x.name for x in p[len(j):]] in ([], ["device"]), name


def test_make_mesh_parameters():
    """The third parameter differs by design: grail_tpu's is a list of
    devices, the port's the device type of an SPMD rank."""
    j, p = _params(jsharded.make_mesh), _params(psharded.make_mesh)
    assert _same(j[:2], p[:2]) and [x.name for x in p] == [
        "n_data", "n_seq", "device"]


def test_positional_backend_routes_to_xla(monkeypatch):
    """synthesize_scores(s, "generic", None, "xla") is the xla core, as in
    grail_tpu, not exact_carrier="xla" on the fused route."""
    calls = []
    xla_run = papi._xla_run

    def spy(*args, **kwargs):
        calls.append(args[1])
        return xla_run(*args, **kwargs)

    monkeypatch.setattr(papi, "_xla_run", spy)
    s = papi.text_to_score("ae")
    got = papi.synthesize_scores([s], "generic", None, "xla", device="cpu")
    assert calls == ["q32"]
    want = papi.synthesize_scores([s], backend="xla", device="cpu")
    assert torch.equal(got[0], want[0])


def test_score_total_seconds_matches_grail_tpu():
    texts = ["hello", "ae", "guten tag", "a"]
    E = max(japi.text_to_score(t).num_elems for t in texts)
    jb = jstack_scores([japi.text_to_score(t, pad_to=E) for t in texts])
    pb = convert.score_from_numpy([np.asarray(f) for f in jb.elem],
                                  jb.has_sound, jb.length, jb.blend_length,
                                  jb.cum_length)
    want = np.asarray(jb.total_seconds(), np.float32)
    got = pb.total_seconds()
    assert got.dtype == np.float32 and got.shape == (len(texts),)
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    np.testing.assert_array_max_ulp(pb.to("cpu").total_seconds().numpy(),
                                    want, maxulp=1)


def test_native_oracle_available():
    """g++ is here, so the host library builds and loads; the chain it
    binds then matches grail_tpu's numpy oracle bit for bit."""
    assert oracle.native_oracle_available() is True
    got = oracle.native_oracle_dsp_chain(
        papi.text_to_phoneme_elems("a"), PSPEC, jitter_seed=2)
    want = jref.oracle_dsp_chain(japi.text_to_phoneme_elems("a"), JSPEC,
                                 jitter_seed=2)
    assert len(want) > 1000
    np.testing.assert_array_equal(got.view(np.uint32),
                                  np.asarray(want, np.float32).view(
                                      np.uint32))
