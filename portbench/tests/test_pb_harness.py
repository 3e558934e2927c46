"""The harness: the result line's keys, a cell added as one JSON file,
no card no result, and the faults that `correct` must catch."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import harness

from .conftest import ROOT, TINY, tiny_run

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", sorted(TINY))
def test_result_line_has_the_contract_keys(cell):
    result, checks = tiny_run(cell, 2 ** 33 + 41)
    assert list(result) == KEYS                  # the checks come last
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert "setup_s" in result["metrics"]
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert result["correct"] is True, checks
    assert result["checks"]["audio_gap"]["limit"] > 0
    json.dumps(result)


def test_a_new_cell_is_one_json_file(tmp_path, monkeypatch):
    tree = tmp_path / "portbench"
    shutil.copytree(harness.HERE, tree,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cell = {"config": "batch_en_plain", "traffic": "sentences",
            "entry": "batch", "why": "a test cell",
            "mix": {"batch": 2, "words": {"dist": "uniform", "min": 1,
                                          "max": 1}},
            "batches": 2, "limits": {"audio_gap": 1e-3}}
    (tree / "workloads" / "batch_en_plain.test.json").write_text(
        json.dumps(cell))
    # and its line in BENCHMARK.json, which names the metrics it reports
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "batch_en_plain.test",
                               "config": "batch_en_plain",
                               "traffic": "sentences", "chips": 1,
                               "why": "a test cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("batch_en_plain.test")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(harness, "HERE", tree)
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    torch.set_num_threads(2)
    result, _ = harness.run("batch_en_plain.test", 5, 1.0, 0, "cpu", 0.0)
    assert result["correct"] is True
    assert result["metrics"]["batch_xrt"]["unit"] == "s/s"


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "batch_en_plain.sentences", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


class Stale:
    """A step that returns its state unchanged: every call answers with
    the first call's answer."""

    def __init__(self):
        self.first = None

    def __call__(self, out):
        if self.first is None:
            self.first = out
        return self.first


def half_batch(outs):
    """Half of the batch left out: the second half answers with the first
    half's audio."""
    h = len(outs) // 2
    return outs[:h] + outs[:len(outs) - h]


def altered(outs):
    """An answer altered where it is produced: 10 ms negated mid-way."""
    out = []
    for o in outs:
        o = o.clone()
        m = o.shape[-1] // 2
        o[..., m:m + 441] *= -1
        out.append(o)
    return out


@pytest.mark.parametrize("cell,fault", [
    ("batch_en_plain.sentences", Stale),
    ("batch_en_plain.sentences", lambda: half_batch),
    ("batch_en_plain.sentences", lambda: altered),
], ids=["batch-stale", "batch-half", "batch-altered"])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    result, checks = tiny_run(cell, 2 ** 33 + 97, fault=fault())
    assert result["correct"] is False, checks
