"""The check sees a broken program: each run here skips the look for a
card and drives a whole tiny run on the CPU (set-up, window, check) with
the timed path broken underneath (``benchmark.faults``: a step that
returns its state unchanged, half of the batch left out with the mean
taken over the rest, an answer altered where it is produced; one chip,
so no exchange between chips to leave out), and ``correct`` must come
out false. The sound run and the control are beside them."""

import math

import pytest

from benchmark.drivers import optim, train
from benchmark.faults import FAULTS, fault
from benchmark.tests import tiny

CELLS = {"adv_open_b4": ("strive_adv_nusc", optim, "optim"),
         "train_b4": ("strive_train_nusc", train, "train")}


def correct(run):
    return all(math.isfinite(v) and v <= lim for _, v, lim in run.checks)


def checked(cell, check=True):
    cfg, driver, _ = CELLS[cell]
    run = tiny.run(cfg, cell)
    driver.setup(run)
    driver.window(run)
    driver.release(run)
    if check:
        driver.check(run)
    return run


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell):
    assert correct(checked(cell))


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_is_not_correct(cell):
    """The reference in TF32 in the program's place fails the check."""
    run = checked(cell, check=False)
    got = CELLS[cell][1].reference_numbers(run, "tf32")
    limits = run.traffic["check"]["limits"]
    assert any(got[n] > lim for n, lim in limits.items())


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("name", FAULTS)
def test_fault_is_not_correct(cell, name):
    with fault(name, CELLS[cell][2]):
        run = checked(cell)
    assert not correct(run)
