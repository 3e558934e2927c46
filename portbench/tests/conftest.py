"""Shared set-up of the benchmark's own tests: tiny cells on the CPU.

Run from the repository's root:

    python -m pytest portbench/tests -q              # the CPU tests
    python -m pytest portbench/tests -q -m cuda      # on the card

The CPU runs use `harness.run(..., device='cpu')`, which skips run.py's
look for a card and runs the port's plain versions at tiny sizes.
"""

import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a tiny shape of the cells, for the CPU
TINY = {
    "batch_en_plain.sentences": {
        "mix": {"batch": 2, "words": {"dist": "uniform", "min": 1,
                                      "max": 1}},
        "batches": 4},
}
TINY_SECONDS = {"batch_en_plain.sentences": 2.0}


def tiny_run(cell, seed, fault=None, overrides=None):
    from portbench import harness

    torch.set_num_threads(2)
    return harness.run(cell, seed, TINY_SECONDS[cell], 0, "cpu",
                       time.perf_counter(),
                       overrides=overrides or TINY[cell], fault=fault)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell runs at its own size")
    return torch.device("cuda")
