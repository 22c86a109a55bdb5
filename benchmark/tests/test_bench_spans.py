"""The readers of the program's spans on a traced stretch of a small
train cell. On the CPU: the host metrics read numbers, the stream metrics
read None (no CUDA events), the launch count reads 0 or None (a CPU trace
has no device operations), and ``utils.span_closed`` is the program's own
again after the capture. On the card: every reader reads a number, and
the stream metrics add up to about the step's own stream time."""

import dataclasses
from pathlib import Path

import pytest
import torch

from benchmark import run
from benchmark import trace as T
from benchmark.drivers import train as train_driver
from benchmark.tests.small import small_cell

HOST = ("host_ms_per_step", "loader_host_ms_per_step", "h2d_copies_per_step")
STREAM = ("augment_stream_ms_per_step", "model_stream_ms_per_step",
          "optimizer_stream_ms_per_step")


def _captured(tmp_path: Path, device: str, units: int = 2):
    """The span readers and a read of each on a capture of ``units`` steps
    of the small ResNet-18 cell on ``device``, with the noted calls."""
    _, cfg, traffic, _ = small_cell("resnet18.train")
    r = train_driver.Run(cfg, traffic, 2 ** 33 + 7, device)
    r.setup()
    r.window(0.01)
    readers = {m: run._reader(m) for m in HOST + STREAM + ("launches_per_step",)}
    dev, attributed, calls = T.capture(
        r, units, tmp_path / "t.json", device,
        {m: rd.PATCHES for m, rd in readers.items() if getattr(rd, "PATCHES", None)})
    ctx = T.Ctx(unit="step", units=units, images_per_unit=4, unit_seconds=r.unit_seconds,
                cfg=cfg, trace=dev, attributed=attributed)

    def read(m):
        return readers[m].read(dataclasses.replace(ctx, calls=calls.get(m, [])))

    return read, calls


def test_span_readers_on_a_cpu_capture(tmp_path: Path):
    from primia_tpu_torch import utils

    before = utils.span_closed
    read, calls = _captured(tmp_path, "cpu")
    assert utils.span_closed is before
    assert set(calls) == set(HOST + STREAM)
    host, loader = read("host_ms_per_step"), read("loader_host_ms_per_step")
    assert 0 < loader < host
    assert read("h2d_copies_per_step") == 3  # the indices, the labels, the mask
    assert all(read(m) is None for m in STREAM)
    assert read("launches_per_step") in (0, None)


@pytest.mark.cuda
def test_span_readers_on_a_card_capture(tmp_path: Path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    read, calls = _captured(tmp_path, "cuda")
    assert 0 < read("loader_host_ms_per_step") < read("host_ms_per_step")
    assert read("h2d_copies_per_step") == 3
    stream = [read(m) for m in STREAM]
    assert all(x > 0 for x in stream)
    # from the augmentation's start to the optimizer's end, the step less
    # its first and last few operations
    steps = [c for c in calls["host_ms_per_step"] if c[0] == "train.step"]
    step_ms = sum(c[2].elapsed_time(c[3]) for c in steps) / len(steps)
    assert 0.85 * step_ms <= sum(stream) <= step_ms * 1.001
    # the backward's launches from autograd's worker thread are counted:
    # a step launches more than its forward's and optimizer's alone
    assert read("launches_per_step") > 100
