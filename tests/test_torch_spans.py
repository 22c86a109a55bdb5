"""The port's spans and host counters (``utils.span``,
``utils.count_h2d``): silent without a profiler, the seven spans of the
train path under one, nested as the phases are, the loader's span closed
before its ``yield``, the same loss with the profiler on and off, the
host arrays a step copies onto its device, and CUDA timing events only
for a span whose work is on a CUDA device (on the card)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from primia_tpu_torch import utils
from primia_tpu_torch.config import Arguments
from primia_tpu_torch.data.loader import BatchLoader
from primia_tpu_torch.nn import ResNet
from primia_tpu_torch.train.optim import make_optimizer
from primia_tpu_torch.train.steps import build_train_step

CANONICAL = (Path(__file__).resolve().parent.parent / "configs" / "torch"
             / "pneumonia-resnet-pretrained.ini")
LAYERS = (1, 1, 1, 1)
RES = 32
STEP_SPANS = ("train.step", "train.augment", "train.mixup", "train.forward", "train.backward",
              "train.optimizer")
SPANS = ("loader.batch",) + STEP_SPANS
BATCH = 4


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(seed=0):
    """The canonical recipe (its whole augmentation chain, MixUp, Adam) at
    32 px on a small ResNet, a pool of 8 images as a tensor (the
    device-resident path: batches are gathers, their indices uploaded) and
    numpy labels; returns the step, a batch iterator and the generator."""
    args = Arguments.from_ini(CANONICAL)
    args.train_resolution = args.inference_resolution = RES
    args.batch_size = BATCH
    torch.manual_seed(seed)
    model = ResNet(LAYERS, num_classes=3, in_channels=3, input_size=RES)
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.integers(0, 256, (2 * BATCH, RES, RES, 3), dtype=np.uint8))
    labels = rng.integers(0, 3, 2 * BATCH).astype(np.int32)
    step = build_train_step(model, make_optimizer(args, model), args, [0.5] * 3, [0.25] * 3,
                            device="cpu")
    batches = iter(BatchLoader(images, labels, BATCH, seed=seed, drop_last=True))
    return model, step, batches, torch.Generator().manual_seed(seed)


def _one_step(step, batches, gen):
    b = next(batches)
    return step(gen, b.images, b.labels, b.mask, 1e-4)


@pytest.fixture
def closed(monkeypatch):
    """The spans that close, in order, as ``utils.span_closed`` sees them."""
    seen = []
    monkeypatch.setattr(utils, "span_closed",
                        lambda name, host_ns, start, end, counters: seen.append(
                            (name, host_ns, start, end, counters)))
    return seen


def test_no_span_is_handed_on_without_a_profiler(closed):
    _, step, batches, gen = _setup()
    before = dict(utils.counters)
    _one_step(step, batches, gen)
    assert closed == [] and utils.counters == before
    assert utils.span("train.step") is utils.span("loader.batch")  # the shared no-op


def test_a_profiled_step_traces_the_seven_spans_nested(tmp_path, closed):
    _, step, batches, gen = _setup()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _one_step(step, batches, gen)
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    ranges = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"] in SPANS:
            assert e["name"] not in ranges, e["name"]  # once each
            ranges[e["name"]] = (e["ts"], e["ts"] + e["dur"])
    assert set(ranges) == set(SPANS)
    lo, hi = ranges["train.step"]
    phases = [ranges[n] for n in STEP_SPANS[1:]]
    assert all(lo <= a and b <= hi for a, b in phases)
    assert all(b0 <= a1 for (_, b0), (a1, _) in zip(phases, phases[1:]))  # in order
    assert ranges["loader.batch"][1] <= lo  # the loader's batch is not the step's
    # the hook saw the same spans, inner before outer, with their host time
    assert [c[0] for c in closed] == ["loader.batch"] + list(STEP_SPANS[1:]) + ["train.step"]
    assert all(c[1] > 0 and c[2] is None and c[3] is None for c in closed)  # no events off CUDA
    assert closed[-1][1] >= sum(c[1] for c in closed[1:-1])


def test_the_loader_span_closes_before_its_yield(closed):
    _, _, batches, _ = _setup()
    with profile(activities=[ProfilerActivity.CPU]):
        next(batches)
        assert [c[0] for c in closed] == ["loader.batch"]  # closed while the batch is held
        with utils.span("consumer"):
            pass
        next(batches)
    assert [c[0] for c in closed] == ["loader.batch", "consumer", "loader.batch"]


def test_a_step_is_bit_for_bit_the_same_under_a_profiler():
    runs = []
    for traced in (False, True):
        model, step, batches, gen = _setup(seed=5)
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                loss = _one_step(step, batches, gen)
        else:
            loss = _one_step(step, batches, gen)
        runs.append((loss, [p.detach().clone() for p in model.parameters()]))
    (loss0, p0), (loss1, p1) = runs
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def test_a_step_copies_three_host_arrays_onto_its_device(closed):
    _, step, batches, gen = _setup()
    before = dict(utils.counters)
    with profile(activities=[ProfilerActivity.CPU]):
        _one_step(step, batches, gen)
    # the batch's indices (int64), labels (int32) and mask (float32)
    assert utils.counters["h2d_copies"] - before["h2d_copies"] == 3
    by_name = {c[0]: c[4] for c in closed}
    assert by_name["loader.batch"]["h2d_copies"] == before["h2d_copies"] + 1
    assert by_name["train.augment"]["h2d_copies"] == before["h2d_copies"] + 3
    assert by_name["train.step"]["h2d_copies"] == before["h2d_copies"] + 3


@pytest.mark.parametrize("as_tensor", [False, True])
def test_only_host_arrays_count_as_copies(as_tensor):
    """A numpy array counts on every device; a tensor already on the step's
    device does not."""
    from primia_tpu_torch.train.steps import _on

    a = np.zeros(6, np.float32)
    before = utils.counters["h2d_copies"]
    with profile(activities=[ProfilerActivity.CPU]):
        _on(torch.device("cpu"), torch.from_numpy(a) if as_tensor else a)
    assert utils.counters["h2d_copies"] - before == (0 if as_tensor else 1)


def test_each_close_hands_on_the_counters_as_they_were(closed):
    """The hook gets a copy of the host counters at each close, which later
    counts leave as it was."""
    with profile(activities=[ProfilerActivity.CPU]):
        with utils.span("first"):
            utils.count_h2d()
        with utils.span("second"):
            utils.count_h2d()
    (_, first), (_, second) = [(c[0], c[4]) for c in closed]
    assert first is not utils.counters and second is not utils.counters
    assert second["h2d_copies"] == first["h2d_copies"] + 1 == utils.counters["h2d_copies"]


@pytest.mark.parametrize("device", [None, "cpu", torch.device("cpu")])
def test_a_span_off_cuda_records_no_events(closed, device):
    with profile(activities=[ProfilerActivity.CPU]):
        with utils.span("phase", device):
            torch.ones(4).sum()
    assert [(c[0], c[2], c[3]) for c in closed] == [("phase", None, None)]
    assert closed[0][1] > 0


@pytest.mark.cuda
def test_a_span_on_cuda_times_its_stream_and_one_off_it_does_not(closed):
    """On the card, a span whose work is on CUDA records a timing event on
    the stream at each end; a CPU span records none, CUDA initialised or
    not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = torch.randn(2048, 2048, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with utils.span("on_cuda", a.device):
            a @ a
        with utils.span("on_cpu", "cpu"):
            torch.ones(4).sum()
    torch.cuda.synchronize()
    (_, _, start, end, _), (_, _, none0, none1, _) = closed
    assert start.elapsed_time(end) > 0
    assert none0 is None and none1 is None
