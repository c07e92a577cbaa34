"""The RATS cell's comparison fails a timed path broken underneath, at
64 x 72 on the CPU, each run in a fresh process: HCFC22, the gas of
least forcing, left unzeroed; CFC11 and CFC12, the closest pair,
swapped; rats_update advancing nothing with the skin temperature. Each
run reads not correct, by the number that holds that fault."""

import pytest

from bench_rats_cell import FAULTS, run_cell, small_root

HELD_BY = {"unzeroed": "rats_relmax", "swapped": "rats_relmax",
           "not_advanced": "forcing_relmax"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_rats_path_is_not_correct(fault, tmp_path):
    out, _, _ = run_cell(small_root(tmp_path), 2**31 + 37, fault)
    assert out["correct"] is False and out["failed"] >= 1
    check = out["checks"][HELD_BY[fault]]
    assert check["value"] > check["limit"]
