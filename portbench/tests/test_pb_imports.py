"""What the benchmark's process loads: never JAX or the JAX package, and
the reference nothing of the port. Each in a fresh process."""

import json
import subprocess
import sys

from .conftest import ROOT

BANNED = ("jax", "jaxlib", "flax", "grail_tpu")


def _loaded(code: str):
    p = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys, json\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_harness_entries_metrics_and_reference_load_no_jax():
    top = _loaded(
        "import importlib, pathlib\n"
        "import portbench.run, portbench.harness as h\n"
        "for p in pathlib.Path('portbench/entries').glob('*.py'):\n"
        "    importlib.import_module('portbench.entries.' + p.stem)\n"
        "h.metric_readers()\n"
        "import portbench.reference.render, portbench.control\n"
        "import grail_tpu_torch.api, grail_tpu_torch.synth.score\n")
    assert not top & set(BANNED), top & set(BANNED)


def test_reference_loads_nothing_of_the_port():
    top = _loaded("import portbench.reference.render")
    assert "grail_tpu_torch" not in top
    assert not top & set(BANNED)
