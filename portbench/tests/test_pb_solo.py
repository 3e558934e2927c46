"""The solo entry (entries/solo.py) on a tiny cell of cli_en_plain on the
CPU: a sound run is correct, the faults that `correct` must catch are not,
and neither is the control (on the card too, at the cell's own size); and
its two readers (track_ms.solo, idle_track.solo) on records
worked by hand: numbers on a solo record, nothing on a batch record or
where the port recorded no `track` span."""

import importlib.util
import time

import pytest
import torch

from .conftest import ROOT

CELL = "cli_en_plain.sentences"
# one text a group, so that every call of the window is kept and checked
TINY = {"mix": {"batch": 1, "words": {"dist": "uniform", "min": 1,
                                      "max": 1}},
        "batches": 4}
READERS = ("track_ms.solo", "idle_track.solo")


def tiny_run(seed, fault=None):
    from portbench import harness

    torch.set_num_threads(2)
    return harness.run(CELL, seed, 0.5, 0, "cpu", time.perf_counter(),
                       overrides=TINY, fault=fault)


def test_a_sound_run_is_correct():
    result, checks = tiny_run(2 ** 33 + 41)
    assert result["correct"] is True, checks
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "batch_xrt"}
    assert result["metrics"]["batch_xrt"]["unit"] == "s/s"


class Previous:
    """Every call answered with the previous call's audio (the warm calls
    come first, so the window's first call gets a warm call's)."""

    def __init__(self):
        self.last = None

    def __call__(self, out):
        prev, self.last = self.last, out
        return out if prev is None else prev


def altered(out):
    """An answer altered where it is produced: 10 ms negated mid-way."""
    out = out.clone()
    m = out.shape[-1] // 2
    out[..., m:m + 441] *= -1
    return out


@pytest.mark.parametrize("fault", [Previous, lambda: altered],
                         ids=["previous", "altered"])
def test_a_broken_timed_path_is_not_correct(fault):
    result, checks = tiny_run(2 ** 33 + 97, fault=fault())
    assert result["correct"] is False, checks


def test_control_fails_and_the_program_passes_tiny():
    from portbench.control import readings

    torch.set_num_threads(2)
    r = readings(CELL, 2 ** 33 + 5, 0.5, torch.bfloat16, "cpu",
                 overrides=TINY)
    assert r["program"] <= r["limit"] < r["control"], r


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 33 + 1, 2 ** 33 + 2, 2 ** 33 + 3])
def test_control_fails_and_the_program_passes_on_the_card(card, seed):
    from portbench.control import readings

    # a whole window: one text of each group of 64 calls is kept, so a
    # window must run ~6 groups for the check's 6 texts
    r = readings(CELL, seed, 51.0, torch.bfloat16, "cuda")
    assert r["program"] <= r["limit"] < r["control"], r


def _reader(name):
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"test_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _span(call, name, parent, a, b, **attrs):
    from grail_tpu_torch.runtime.trace import Span

    return Span(call, name, parent, round(a * 1e9), round(b * 1e9), attrs)


# two calls. Host clock: roots at 300.00005 and 301.00002 s; the first
# takes the track route (the track 10-90 ms into it), the second does not.
# The harness's program phases open at 0.1 and 1.0 s on the trace's clock
# of a 2-s window; one kernel runs 20 ms of the first call's track.
def _spans(track=True):
    out = []
    for call, t, dur in ((1, 300.00005, 0.4999), (2, 301.00002, 0.1999)):
        if track and call == 1:
            out.append(_span(call, "track", "prep", t + 0.01, t + 0.09,
                             hit=False, samples=2_000_000))
        out += [_span(call, "prep", "batch", t + 0.001, t + dur - 1e-4),
                _span(call, "frontend", "batch", t, t + 0.001),
                _span(call, "batch", None, t, t + dur, B=1)]
    return out


def _record(entry="solo"):
    ops = [{"name": "k", "cat": "kernel", "t": 0.15, "dur": 0.02,
            "phase": "program"},
           {"name": "k", "cat": "kernel", "t": 0.3, "dur": 0.2,
            "phase": "program"},
           {"name": "copy", "cat": "gpu_memcpy", "t": 0.6, "dur": 0.05,
            "phase": "fetch"}]
    phases = [("program", 0.1, 0.5), ("fetch", 0.6, 0.1),
              ("program", 1.0, 0.2), ("fetch", 1.2, 0.05)]
    return {"entry": entry,
            "spans": [("program", 100.0, 100.5), ("fetch", 100.5, 100.6),
                      ("program", 101.0, 101.2), ("fetch", 101.2, 101.25)],
            "trace": {"ops": ops, "busy_s": 0.27, "window_s": 2.0,
                      "idle": [], "phases": phases}}


@pytest.fixture
def port_spans(monkeypatch):
    from grail_tpu_torch.runtime import trace

    def use(spans):
        monkeypatch.setattr(trace, "spans", lambda: list(spans))

    use(_spans())
    return use


def test_the_readers_read_a_solo_record(port_spans):
    ms, unit = _reader("track_ms.solo")(_record())
    assert unit == "ms" and ms == pytest.approx(80.0, abs=1e-6)
    # the track is open 0.11-0.19 s of the window; a kernel runs 0.15-0.17
    share, unit = _reader("idle_track.solo")(_record())
    assert unit == "%" and share == pytest.approx(100 * 0.06 / 2.0, abs=1e-6)


@pytest.mark.parametrize("case", ["batch record", "no track span",
                                  "calls that do not pair"])
def test_the_readers_read_nothing(case, port_spans):
    rec = _record("batch" if case == "batch record" else "solo")
    if case == "no track span":          # a port without the span
        port_spans(_spans(track=False))
    if case == "calls that do not pair":
        rec["spans"] = rec["spans"][:2]
        rec["trace"]["phases"] = rec["trace"]["phases"][:2]
    for name in READERS:
        assert _reader(name)(rec) is None, name
