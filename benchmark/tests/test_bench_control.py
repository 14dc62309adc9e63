"""On the card: the control (the plain reference in TF32 in the program's
place) fails the comparison that the program passes, at each cell's own
size, on three seeds (``benchmark/control.py`` reads the same numbers)."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness
from benchmark.tests.tiny import PARKED

CELLS = ["tt_stream18.train_full_b16", "tt_offline8.recognize_b256",
         "tt_offline8.train_pruned5_b32"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_where_the_program_passes(card, cell):
    limits = harness.load_json("workloads", cell)["limits"]
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        result = harness.run(cell, seed, 1.0, False, control=True, entry=PARKED.get(cell))
        assert result["correct"], result["checks"]
        assert any(result["control"][name] > limit for name, limit in limits.items()), \
            result["control"]
