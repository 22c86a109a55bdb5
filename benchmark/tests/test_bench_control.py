"""Each cell's control, the reference in the next precision down put in the
program's place, fails at least one of the cell's compared numbers (at
the CPU's size; the chip's readings at the cells' sizes are in PERF.md).
The program, float32 on the CPU, reads far below the control."""

import pytest

from benchmark import calibrate
from benchmark.tests.small import small_cell


@pytest.mark.parametrize("workload", ["resnet18.train", "vgg16.train",
                                      "resnet18.encrypted_fss"])
def test_the_control_is_not_correct(workload):
    cell = small_cell(workload, per=1)
    limits = cell[3]
    r = calibrate.readings(workload, 2 ** 36 + 9, "cpu", cell, units=1)
    read = r["controls"]["float8" if "train" in workload else "bfloat16"]
    assert any(read[k] > lim["limit"] for k, lim in limits.items())
    assert all(r["program"][k] < read[k] / 10 for k in limits if read[k] > limits[k]["limit"])
