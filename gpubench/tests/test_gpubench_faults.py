"""The check against a broken program: each fault a cell can have
(``gpubench/faults.py``), planted under the timed path at a small size on
the CPU, makes ``correct`` false. The harness's look for a card is skipped
(``--device cpu``); the rest of a run is the run's own."""

import pytest

from _cells import checked
from gpubench.faults import FAULTS, planted

CELLS = {"sample": "abc-sample-ddim50", "train": "deepcad-train", "eval": "deepcad-eval"}
PROTOCOL = {"protocol_step_unchanged": "deepcad-sample"}  # faults of PNDM + DDPM only


def test_sound_runs_are_correct():
    for workload in CELLS.values():
        readings, correct = checked(workload)
        assert correct, (workload, readings)


@pytest.mark.parametrize("kind,fault", [(k, f) for f, kinds in FAULTS.items() for k in kinds])
def test_fault_is_caught(kind, fault):
    with planted(kind, fault):
        readings, correct = checked(PROTOCOL.get(fault, CELLS[kind]))
    assert not correct, (kind, fault, readings)


def test_a_fault_names_its_kind():
    with pytest.raises(ValueError):
        planted("eval", "state_unchanged")
