"""The control of the comparison: the reference computed in bfloat16, in
the program's place, must come out as not correct; a sound run must not.
On the CPU at tiny sizes; on the card at the cells' own sizes."""

import pytest
import torch

from portbench.control import readings

from .conftest import TINY, TINY_SECONDS


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_fails_and_the_program_passes_tiny(cell):
    torch.set_num_threads(2)
    r = readings(cell, 2 ** 33 + 5, TINY_SECONDS[cell], torch.bfloat16,
                 "cpu", overrides=TINY[cell])
    assert r["program"] <= r["limit"] < r["control"], r


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["batch_en_plain.sentences",
                                  "batch_en_plain.prompts"])
@pytest.mark.parametrize("seed", [2 ** 33 + 1, 2 ** 33 + 2, 2 ** 33 + 3])
def test_control_fails_and_the_program_passes_on_the_card(card, cell, seed):
    r = readings(cell, seed, 10.0, torch.bfloat16, "cuda")
    assert r["program"] <= r["limit"] < r["control"], r
