"""A whole run of each cell, at a tiny size on the CPU (the look for a card
skipped), comes out correct; with the timed path broken underneath it
comes out not correct, once for each fault the cell can have
(``benchmark/faults.py``)."""

from __future__ import annotations

import pytest

from benchmark import faults, harness
from benchmark.tests.tiny import PARKED, shrink

CELLS = {"tt_stream18.train_full_b16": "train", "tt_offline8.train_pruned5_b32": "train",
         "tt_offline8.recognize_b256": "recognize"}
SEED = 2 ** 31 + 17


def run(cell):
    return harness.run(cell, SEED, 0.2, False, device="cpu", edit=shrink,
                       entry=PARKED.get(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    result = run(cell)
    assert result["correct"], result["checks"]
    assert list(result["checks"]) == list(harness.load_json("workloads", cell)["limits"])
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell,fault", [(c, f) for c, k in CELLS.items()
                                        for f in faults.FAULTS[k]],
                         ids=lambda x: getattr(x, "__name__", x))
def test_a_broken_path_is_not_correct(cell, fault):
    undo = fault()
    try:
        result = run(cell)
    finally:
        undo()
    assert not result["correct"], result["checks"]
