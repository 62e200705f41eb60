"""The harness's run with its look for a card skipped and the timed path
broken underneath: ``correct`` must come out false, under each cell's own
limits, for each fault the cell can have.  And the control kept at a size
a test run can hold: the reference in fp8 in the program's place reads
its cell's compared number at least three times the program's.  A tiny
model on the CPU (the port's plain kernels), each cell's own driver."""
from __future__ import annotations

import pytest
import torch

from epbench import common, faults
from epbench import run as R
from test_epbench_reference import PORT

TINY = {"decode": dict(batch=8, prompt_len=4, gen_len=8),
        "train": dict(batch=2, seq_len=16, layers=2)}
# the faults each kind of cell can have
CASES = {"qwen2moe-decode-ll": ("token_altered", "exchange_skipped",
                                "state_unchanged", "half_batch"),
         "qwen2moe-train-ht": ("state_unchanged", "half_batch",
                               "exchange_skipped")}
# the number the control fails in each kind of cell
CONTROL = {"decode": "mean_gap", "train": "grad_diff"}


def tiny_run(cell: str, fault: str = "", control: bool = False):
    c, _, traffic, limits = R.prepare(cell, common.benchmark())
    traffic = dict(traffic, **TINY[traffic["driver"]])
    ctx = R.make_context(c, {"port": PORT}, traffic, torch.device("cpu"),
                         2 ** 31 + 99, 0.2, False, control=control)
    undo = faults.plant(fault) if fault else None
    try:
        rec = common.load_module("traffic", traffic["driver"]).run(ctx)
    finally:
        if undo:
            undo()
    return rec, limits, traffic["driver"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in CASES.items()
                                        for f in fs])
def test_fault_is_not_correct(cell, fault):
    rec, limits, _ = tiny_run(cell, fault)
    correct, checks = R.judge(rec["checks"], limits)
    assert not correct, checks


@pytest.mark.parametrize("cell", list(CASES))
def test_control_reads_three_times_the_program(cell):
    rec, limits, driver = tiny_run(cell, control=True)
    name = CONTROL[driver]
    assert set(rec["checks"]) == set(limits)
    assert rec["control"][name] >= 3 * rec["checks"][name], rec
