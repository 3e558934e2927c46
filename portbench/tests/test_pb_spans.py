"""The span readers (frontend_span_ms.batch, prep_ms.batch,
idle_frontend.batch, idle_prep.batch) on a record worked by hand, and the
trace's reduction with the port's spans in it."""

import importlib.util
import sys

import pytest

from portbench import harness
from portbench.trace import reduce_events

from .conftest import ROOT

NAMES = ("frontend_span_ms.batch", "prep_ms.batch", "idle_frontend.batch",
         "idle_prep.batch")


def _shared():
    path = ROOT / "portbench" / "metrics" / "idle_frontend.batch.py"
    spec = importlib.util.spec_from_file_location("spans_shared", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _span(call, name, parent, a, b, **attrs):
    from grail_tpu_torch.runtime.trace import Span

    return Span(call, name, parent, round(a * 1e9), round(b * 1e9), attrs)


# two calls. Host clock: roots at 100.00005 and 101.00002 s, each 0.4999 s
# long, the frontend its first 0.2 s, prep the rest. The harness's program
# phases open 50 and 20 us before them, at 0.1 and 1.0 s on the trace's
# clock, where the probe takes 0.0-0.1 and 0.9-1.0 of a 2-s window.
def _spans():
    out = []
    for call, t in ((1, 100.00005), (2, 101.00002)):
        out += [_span(call, "frontend", "batch", t + 1e-4, t + 0.2),
                _span(call, "launch", "prep", t + 0.3, t + 0.4),
                _span(call, "prep", "batch", t + 0.2, t + 0.4998, S=1),
                _span(call, "batch", None, t, t + 0.4999, B=64)]
    return out


def _record():
    ops = [{"name": "k", "cat": "kernel", "t": 0.35, "dur": 0.2,
            "phase": "program"},                     # in call 1's prep
           {"name": "copy", "cat": "gpu_memcpy", "t": 0.62, "dur": 0.06,
            "phase": "fetch"},
           {"name": "up", "cat": "gpu_memcpy", "t": 1.05, "dur": 0.05,
            "phase": "program"},                     # in call 2's frontend
           {"name": "k", "cat": "kernel", "t": 1.3, "dur": 0.2,
            "phase": "program"}]                     # call 2's prep
    phases = [("frontend_probe", 0.0, 0.1), ("program", 0.1, 0.5),
              ("fetch", 0.6, 0.1), ("frontend_probe", 0.9, 0.1),
              ("program", 1.0, 0.5), ("fetch", 1.5, 0.1)]
    return {"entry": "batch",
            "spans": [("frontend_probe", 99.9, 100.0),
                      ("program", 100.0, 100.5), ("fetch", 100.5, 100.6),
                      ("frontend_probe", 100.9, 101.0),
                      ("program", 101.0, 101.5), ("fetch", 101.5, 101.6)],
            "trace": {"ops": ops, "busy_s": 0.51, "window_s": 2.0,
                      "idle": [], "phases": phases}}


@pytest.fixture
def port_spans(monkeypatch):
    from grail_tpu_torch.runtime import trace

    got = _spans()
    monkeypatch.setattr(trace, "spans", lambda: list(got))
    return got


def test_anchoring_puts_each_span_at_its_trace_time(port_spans):
    calls = _shared().calls(_record(), on_trace=True)
    assert [sorted(c) for c in calls] == [["batch", "frontend", "launch",
                                           "prep"]] * 2
    for c, phase in zip(calls, (0.1, 1.0)):
        assert c["batch"] == pytest.approx((phase, phase + 0.4999))
        assert c["frontend"] == pytest.approx((phase + 1e-4, phase + 0.2))
        assert c["launch"] == pytest.approx((phase + 0.3, phase + 0.4))
    # on the host clock the same spans keep the program phases' times
    host = _shared().calls(_record(), on_trace=False)
    assert host[1]["prep"] == pytest.approx((101.2, 101.4998))


def test_readers_on_the_hand_worked_record(port_spans):
    read = harness.metric_readers()
    rec = _record()
    assert read["frontend_span_ms.batch"](rec) == (pytest.approx(199.9),
                                                   "ms")
    assert read["prep_ms.batch"](rec) == (pytest.approx(299.8), "ms")
    # the window less the probe: 1.8 s. The frontends' 0.3998 s less the
    # upload's 0.05 s in call 2's; the preps' 0.5996 s less the kernels'
    # 0.2 and 0.1998 s
    assert read["idle_frontend.batch"](rec) == (
        pytest.approx(100 * 0.3498 / 1.8), "%")
    assert read["idle_prep.batch"](rec) == (
        pytest.approx(100 * 0.1998 / 1.8), "%")
    # the device row's copy of a program phase (it opens inside the
    # host's) changes nothing
    rec["trace"]["phases"].append(("program", 0.35, 0.2))
    assert read["idle_prep.batch"](rec) == (
        pytest.approx(100 * 0.1998 / 1.8), "%")


def _broken(rec, how):
    if how == "a phase fewer":
        rec["trace"]["phases"].pop(4)
        rec["spans"].pop(4)
    elif how == "a root longer than its phase":
        rec["trace"]["phases"][4] = ("program", 1.0, 0.4)
        rec["spans"][4] = ("program", 101.0, 101.4)
    else:       # "a root 2 ms shorter than its phase"
        rec["trace"]["phases"][4] = ("program", 1.0, 0.502)
        rec["spans"][4] = ("program", 101.0, 101.502)
    return rec


@pytest.mark.parametrize("how", ["a phase fewer",
                                 "a root longer than its phase",
                                 "a root 2 ms shorter than its phase"])
def test_calls_that_do_not_pair_off_read_as_nothing(port_spans, how):
    read = harness.metric_readers()
    rec = _broken(_record(), how)
    assert [read[n](rec) for n in NAMES] == [None] * 4


def test_a_port_without_spans_reads_as_nothing(monkeypatch):
    read = harness.metric_readers()
    from grail_tpu_torch.runtime import trace

    monkeypatch.setattr(trace, "spans", lambda: [])
    assert [read[n](_record()) for n in NAMES] == [None] * 4
    monkeypatch.setitem(sys.modules, "grail_tpu_torch.runtime.trace", None)
    assert [read[n](_record()) for n in NAMES] == [None] * 4


def _events(with_spans: bool):
    """A Chrome trace: the window, a program phase with one launch in it,
    its kernel, a fetch phase with its copy; with the port's grail.* rows
    (and their device-row copies) around the launch."""
    def x(name, ts, dur, tid=1, cat="user_annotation", **args):
        return {"ph": "X", "name": name, "ts": ts, "dur": dur, "tid": tid,
                "cat": cat, "args": args}

    ev = [x("portbench.window", 0, 1000),
          x("portbench.program", 100, 400),
          x("cudaLaunchKernel", 450, 5, cat="cuda_runtime", correlation=7),
          x("fused_synth", 460, 200, tid=7, cat="kernel", correlation=7),
          x("portbench.fetch", 500, 200),
          x("cudaMemcpyAsync", 510, 5, cat="cuda_runtime", correlation=8),
          x("Memcpy DtoH", 660, 30, tid=7, cat="gpu_memcpy", correlation=8)]
    if with_spans:
        ev += [x("grail.batch", 101, 398), x("grail.prep", 300, 198),
               x("grail.launch", 440, 40),
               x("grail.launch", 460, 200, tid=7,
                 cat="gpu_user_annotation")]
    return ev


def test_the_reduction_keeps_its_labels_with_the_spans_in_the_trace():
    plain, spanned = reduce_events(_events(False)), reduce_events(
        _events(True))
    assert [o["phase"] for o in plain["ops"]] == ["program", "fetch"]
    assert spanned == plain
