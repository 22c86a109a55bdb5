"""The ``swin_b384.train`` cell's harness: the family's MACs against the
published count, the attention's counting functions against a hand count,
the cell cut to 96 px correct on the CPU with planted faults caught, and
the attention readers on a traced stretch (on the CPU: the counter and the
noted calls, no device time; on the card: every reader reads a number)."""

import dataclasses
import time
from pathlib import Path

import pytest
import torch

from benchmark import attention, counts, run
from benchmark import trace as T
from benchmark.common import load_json
from benchmark.drivers import train as train_driver
from benchmark.reference.families import swin
from benchmark.tests.small import small_cell

CELL = "swin_b384.train"
ARCH = load_json(Path(__file__).resolve().parents[1] / "configs" / "swin_b384.json")[
    "architecture"]
READERS = ("attention_ms_per_step", "attention_roofline", "attention_fwd_stream_ms_per_step",
           "mlp_fwd_stream_ms_per_step")


def test_macs_match_the_published_count():
    """Table 1: Swin-B at 384² is 47.0 G (the authors' multiply-adds, at
    1,000 classes), and 15.4 G at 224² with window 7."""
    other, lin = swin.macs(ARCH, 1000)
    assert abs(other + lin - 47.0e9) <= 0.005 * 47.0e9
    assert sum(swin.macs(dict(ARCH, resolution=224), 1000)) == pytest.approx(15.4e9, rel=0.005)
    # the train cell's 3 classes: 6 x 47.08 G FLOPs an image
    assert counts.train_flops_per_image(ARCH) == 6 * sum(swin.macs(ARCH, 3))


def test_attention_counts_against_a_hand_count():
    """Two windows of 4 tokens, one head of dim 2: q k^T and its product with
    v are 4 x 4 x 2 = 32 MACs each a window, 128 FLOPs forward, twice that
    backward: 768 FLOPs. Bytes in bfloat16: 12 tensors of 2 x 4 x 2, the
    bias and its gradient of 4 x 4, and a mask of 2 x 16 bytes."""
    assert attention.flops(2, 1, 4, 2) == 768
    assert attention.least_bytes(2, 1, 4, 2, 2, 0) == 2 * (12 * 16 + 2 * 16)
    assert attention.least_bytes(2, 1, 4, 2, 2, 2) == 2 * (12 * 16 + 2 * 16) + 32
    # a stage-1 block of the cell, shifted: 64 images of 64 windows of 144
    # tokens, 4 heads of 32 -- bound by its bytes (L / 2 = 72 FLOPs a byte)
    bw, h, L, d = 64 * 64, 4, 144, 32
    assert attention.least_seconds(bw, h, L, d, 2, 64) == pytest.approx(
        attention.least_bytes(bw, h, L, d, 2, 64) / counts.PEAK_HBM_BYTES_PER_S)
    assert attention.flops(bw, h, L, d) / attention.least_bytes(bw, h, L, d, 2, 0) \
        == pytest.approx(L / 2, rel=0.01)


def _run(**kw):
    cell = small_cell(CELL, res=96, **kw)
    return run.execute(CELL, 2 ** 35 + 3, 0.5, False, device="cpu", cell=cell,
                       setup_started=time.perf_counter())


def test_a_sound_run_is_correct():
    out = _run()
    assert out["correct"]
    assert set(out["compared"]) == set(small_cell(CELL)[3])


def test_a_step_that_leaves_the_state_unchanged_is_caught(monkeypatch):
    from primia_tpu_torch.train import optim

    monkeypatch.setattr(optim.Adam, "update", lambda self, grads, lr: None)
    out = _run()
    assert not out["correct"] and out["compared"]["update_gap"]["value"] == pytest.approx(1.0)


def test_an_ascent_is_caught(monkeypatch):
    from primia_tpu_torch.train import optim

    descend = optim.Adam.update

    def ascend(self, grads, lr):
        before = [p.detach().clone() for p in self.params]
        descend(self, grads, lr)
        with torch.no_grad():
            for p, b in zip(self.params, before):
                p.copy_(2 * b - p)

    monkeypatch.setattr(optim.Adam, "update", ascend)
    out = _run()
    assert not out["correct"] and out["compared"]["update_dir_median"]["value"] > 1.5


def test_a_loss_over_half_the_batch_is_caught(monkeypatch):
    from primia_tpu_torch.train import losses

    whole = losses.cross_entropy_one_hot

    def half(logits, target, weight=None, reduction="mean", sample_mask=None):
        n = logits.shape[0] // 2
        return whole(logits[:n], target[:n], weight, reduction, sample_mask[:n])

    monkeypatch.setattr(losses, "cross_entropy_one_hot", half)
    assert not _run()["correct"]


def test_an_altered_loss_is_caught(monkeypatch):
    from primia_tpu_torch.train import steps

    build = steps.build_train_step

    def altered(*a, **kw):
        step = build(*a, **kw)
        return lambda *args: step(*args) * 1.1

    monkeypatch.setattr(steps, "build_train_step", altered)
    out = _run()
    assert not out["correct"] and out["compared"]["loss1_gap"]["value"] > 0.09


def _captured(tmp_path: Path, device: str, units: int = 2, res: int = 96, batch: int = 2):
    _, cfg, traffic, _ = small_cell(CELL, res=res, batch=batch)
    r = train_driver.Run(cfg, traffic, 2 ** 33 + 9, device)
    r.setup()
    r.window(0.01)
    readers = {m: run._reader(m) for m in READERS}
    dev, attributed, calls = T.capture(
        r, units, tmp_path / "t.json", device,
        {m: rd.PATCHES for m, rd in readers.items() if getattr(rd, "PATCHES", None)})
    ctx = T.Ctx(unit="step", units=units, images_per_unit=batch, unit_seconds=r.unit_seconds,
                cfg=cfg, trace=dev, attributed=attributed)
    return {m: readers[m].read(dataclasses.replace(ctx, calls=calls.get(m, [])))
            for m in READERS}, calls


def test_attention_readers_on_a_cpu_capture(tmp_path: Path):
    """Each step notes one call a block (24), with the windows' shapes, and
    the counter shows 24 a step; with no device events and no CUDA timing
    events every reader reads None."""
    from benchmark import spans

    read, calls = _captured(tmp_path, "cpu")
    notes = [c for c in calls["attention_roofline"] if c[0] == "call"]
    assert len(notes) == 2 * 24
    # stage 1 at 96 px: 2 images x 64 windows of 9 tokens, 4 heads of 32
    assert notes[0][1:] == (2 * 64, 4, 9, 32, 4, 0) and notes[1][1:] == (2 * 64, 4, 9, 32, 4, 64)
    closes = [c for c in calls["attention_roofline"] if c[0] != "call"]
    assert spans.counter_per_step(closes, "attention_calls") == 24
    names = [c[0] for c in calls["attention_fwd_stream_ms_per_step"]]
    assert names.count("swin.attention") == names.count("swin.mlp") == 2 * 24
    assert all(v is None for v in read.values())


@pytest.mark.cuda
def test_attention_readers_on_a_card_capture(tmp_path: Path):
    """The cell's widths at 384 px, batch 2: the attention kernels take device
    time, their share of the roofline is a share, and both stream metrics
    read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    read, _ = _captured(tmp_path, "cuda", res=384)
    assert read["attention_ms_per_step"] > 0
    assert 0 < read["attention_roofline"] <= 100
    assert read["attention_fwd_stream_ms_per_step"] > 0
    assert read["mlp_fwd_stream_ms_per_step"] > 0
