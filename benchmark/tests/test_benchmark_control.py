"""The lower-precision control: the reference computed in TF32 (the
operands of every matmul and einsum rounded to TF32), put in the
program's place, reads as not correct under each cell's limits on three
seeds, while the program reads as correct on the same ticks.

The batched cells hold it on the CPU at a tiny size.  The single robot's
do not at a size the CPU runs in seconds (at N=6 and an 80x60 frame the
control's command moves less than at the cell's N=30 and 640x480), so
their test runs at the cells' own size and needs the card; it skips
without one.  Its equal on the card for any cell, a dozen seeds:
``python3 benchmark/readings.py --workload <cell>``."""

import pytest
import torch

import harness
import readings
import run
import tiny

MAN = harness.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]


def _holds(cell, dev, scale, seconds):
    mix = harness.traffic(harness.ROOT, harness.cell(MAN, cell)["traffic"])
    for seed in (101, 202, 303):
        r = readings.readings(cell, seed, seconds, dev, scale=scale)
        assert run.judge(r["sound"], mix["limits"])[0], r["sound"]
        assert not run.judge(r["control"], mix["limits"])[0], r["control"]


@pytest.mark.parametrize("cell", [c for c in CELLS if c.startswith("mc_batch")])
def test_control_reads_not_correct_on_the_cpu(cell):
    _holds(cell, torch.device("cpu"), tiny.scale(cell), 0.3)


@pytest.mark.card
@pytest.mark.parametrize("cell", [c for c in CELLS if c.startswith("single_robot")])
def test_control_reads_not_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the single robot's control is held at the cell's own size")
    _holds(cell, torch.device("cuda", 0), None, 3.0)
