"""The roofline arithmetic and the metric readers, on records worked by
hand."""

import pytest

from portbench import harness
from portbench.roofline import counts


def test_counts_add_up():
    assert counts.CHAIN_F32 == 14 + 25 + 3 + 8 * 80 + 8 == 690
    assert counts.CHAIN_Q32 == counts.CHAIN_F32 + 3
    # under chip_smoke.py's count of kernel 1 with a walking index
    assert counts.CHAIN_Q32 < 18 + 2 + 751


def test_least_seconds_takes_the_larger_bound():
    # 1e6 samples of the f32 chain: 690e6 / 33.5e12 s of operations
    # against 4e6 / 3.35e12 s of output bytes
    assert counts.least_seconds("kcar", 10 ** 6, "f32") == pytest.approx(
        690e6 / 33.5e12)
    assert counts.least_seconds("q32", 10 ** 6, "f32") == pytest.approx(
        693e6 / 33.5e12)


def _trace(ops, busy, window, phases=()):
    return {"ops": ops, "busy_s": busy, "window_s": window, "idle": [],
            "phases": list(phases)}


def test_readers_on_hand_worked_records():
    read = harness.metric_readers()
    ops = [{"name": "k", "cat": "kernel", "t": 0.0, "dur": 0.01,
            "phase": "program"},
           {"name": "other", "cat": "kernel", "t": 0.5, "dur": 0.04,
            "phase": ""},
           {"name": "copy", "cat": "gpu_memcpy", "t": 0.2, "dur": 0.1,
            "phase": "fetch"}]
    rec = {"entry": "batch",
           "spans": [("frontend_probe", 0.0, 0.25),
                     ("frontend_probe", 1.0, 1.35),
                     ("fetch", 0.3, 0.34), ("program", 0.0, 0.1)],
           "work": [{"samples": 10 ** 6}, {"samples": 2 * 10 ** 6}],
           "carrier": ["kcar", "q32"],
           "trace": _trace(ops, 0.15, 2.0)}
    least = (690e6 + 693e6 * 2) / 33.5e12
    assert read["synth_roofline.batch"](rec) == (
        pytest.approx(100 * least / 0.01), "%")
    assert read["idle_share.batch"](rec) == (pytest.approx(92.5), "%")
    assert read["frontend_ms.batch"](rec) == (pytest.approx(300.0), "ms")
    assert read["fetch_ms.batch"](rec) == (pytest.approx(40.0), "ms")
    # the probe's intervals leave the window and the busy time: the window
    # 2.0 less 0.6 (0.45-0.85 and 1.6-1.8), busy 0.15 less the 0.05 of
    # "other" and "copy" that fall in 0.45-0.85 (0.5-0.54, and none of
    # 0.2-0.3)
    rec["trace"]["phases"] = [("frontend_probe", 0.45, 0.4),
                              ("program", 0.0, 0.1),
                              ("frontend_probe", 1.6, 0.2)]
    assert read["idle_share.batch"](rec) == (
        pytest.approx(100 * (1 - 0.11 / 1.4)), "%")
    rec.pop("trace")
    assert read["synth_roofline.batch"](rec) is None
    assert read["idle_share.batch"](rec) is None


def test_outside_takes_overlapping_intervals_once():
    from portbench.trace import outside

    ops = [{"t": 0.0, "dur": 1.0}, {"t": 0.5, "dur": 1.0},
           {"t": 3.0, "dur": 1.0}]
    tr = _trace(ops, 0.0, 5.0, [("p", 0.8, 0.4), ("p", 1.0, 0.4),
                                ("q", 3.5, 1.0), ("p", 4.5, 1.0)])
    # busy 0-1.5 and 3-4; cut 0.8-1.4 and 4.5-5.0
    busy, window = outside(tr, ("p",))
    assert busy == pytest.approx(2.5 - 0.6)
    assert window == pytest.approx(5.0 - 1.1)
