"""`correct` comes out false with the timed path broken underneath (the
look for a card skipped; a tiny size on the CPU), once a fault that a
training cell can have; and the control (the reference in fp8 in the
program's place) fails the cell's limits. The one-chip cells have no
exchange between chips to leave out."""

import pytest

from benchmark import calibrate, compare, faults, run, spec


CASES = [("color_neus_dtu.train", f) for f in faults.FAULTS["train"]] + \
    [("color_neus_dtu.extract512", f) for f in faults.FAULTS["extract"]]


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_fails(workload, fault, tiny_workloads):
    with faults.planted(fault):
        r = run.run_cell(workload, 2 ** 32 + 11, 0.2, False, device="cpu",
                         require_card=False, workloads_dir=tiny_workloads)
    assert r["correct"] is False


@pytest.mark.parametrize("workload", ["color_neus_dtu.train", "neus_dtu.train"])
def test_control_fails(workload, tiny_workloads):
    import torch
    cell = spec.Cell(spec.load(), workload, workloads_dir=tiny_workloads)
    for row in calibrate.readings(cell, 2 ** 32 + 13, ["control"], torch.device("cpu")):
        nums = {k: row[k] for k in cell.traffic["limits"]}
        assert compare.judge(nums, cell.traffic["limits"])[0] is False


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["color_neus_dtu.train", "neus_dtu.train"])
def test_control_fails_on_the_card(workload, card):
    """The control at the cell's own size on three seeds."""
    cell = spec.Cell(spec.load(), workload)
    for seed in (2 ** 32 + 21, 2 ** 32 + 22, 2 ** 32 + 23):
        for row in calibrate.readings(cell, seed, ["control"], card):
            nums = {k: row[k] for k in cell.traffic["limits"]}
            assert compare.judge(nums, cell.traffic["limits"])[0] is False


def test_missing_steps_fail():
    """A program that returns fewer steps than the reference followed
    (a bundle left out) fails loss_gap, whatever the steps it kept read."""
    import math
    import torch
    p0 = {"w": torch.zeros(3)}
    ref = {"losses": [1.0, 0.9, 0.8, 0.7], "grad": {"w": torch.ones(3)},
           "params": {"w": torch.full((3,), 0.1)}}
    prog = dict(ref, losses=ref["losses"][:2])
    assert math.isinf(compare.training(prog, ref, p0, 0)["loss_gap"])
    assert compare.training(ref, ref, p0, 0)["loss_gap"] == 0.0
