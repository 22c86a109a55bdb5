"""The ``maxvit_b384.train`` cell's harness: the family's MACs against a hand
count of the published layers, the attention calls a step against a hand
count, the cell cut to 64 px correct on the CPU with planted faults caught,
and the four new readers on a traced stretch (on the CPU: the counter, the
noted calls and the spans' closes, no device time; on the card: every
reader reads a number)."""

import dataclasses
import time
from pathlib import Path

import pytest
import torch

from benchmark import attention, counts, run
from benchmark import trace as T
from benchmark.common import load_json
from benchmark.drivers import train as train_driver
from benchmark.reference.families import maxvit
from benchmark.tests.small import small_cell

CELL = "maxvit_b384.train"
ARCH = load_json(Path(__file__).resolve().parents[1] / "configs" / "maxvit_b384.json")[
    "architecture"]
READERS = ("maxvit_attention_roofline", "mbconv_fwd_stream_ms_per_step",
           "block_attention_fwd_stream_ms_per_step", "grid_attention_fwd_stream_ms_per_step")


def _hand_count(res: int, classes: int) -> int:
    """MaxViT-B's MACs an image, layer by layer, written out apart from the
    family's loop: the stem's two 3x3 convolutions at res / 2; each block's
    1x1 expansion at its input's map, 3x3 depthwise (9 a channel and
    position), 1x1 projection, the first block's 1x1 shortcut, the
    squeeze-excitation's two linear layers (4C x C/4 each); two attention
    halves of 12 N C^2 (qkv, proj, MLP of 4C) and 2 N L C (L = P^2, P =
    res // 32); the 768 x 768 pre-logits and the classifier."""
    p, stem = res // 32, res // 2
    total = 3 * 64 * 9 * stem ** 2 + 64 * 64 * 9 * stem ** 2
    cin, side = 64, stem
    for width, depth in ((96, 2), (192, 6), (384, 14), (768, 2)):
        for b in range(depth):
            src = cin if b == 0 else width
            out = side // 2 if b == 0 else side
            mid = 4 * width
            total += src * mid * side ** 2 + 9 * mid * out ** 2 + mid * width * out ** 2
            total += src * width * out ** 2 if b == 0 else 0
            total += 2 * mid * (width // 4)
            n = out ** 2
            total += 2 * (12 * n * width ** 2 + 2 * n * min(p, out) ** 2 * width)
            side = out
        cin = width
    return total + 768 * 768 + 768 * classes


def test_macs_match_a_hand_count_and_the_published_one():
    """73.2 G MACs an image at 384 px (the paper's 74.2 GFLOPs counts the
    norms and activations too); 23.9 G at 224 px, the paper's 24.0 G."""
    assert sum(maxvit.macs(ARCH, 1000)) == _hand_count(384, 1000)
    assert sum(maxvit.macs(ARCH, 1000)) == pytest.approx(73.2e9, rel=0.001)
    assert sum(maxvit.macs(dict(ARCH, resolution=224), 1000)) == _hand_count(224, 1000)
    assert sum(maxvit.macs(dict(ARCH, resolution=224), 1000)) == pytest.approx(24.0e9, rel=0.005)
    # the train cell's 3 classes: 6 x 73.17 G FLOPs an image
    assert counts.train_flops_per_image(ARCH) == 6 * sum(maxvit.macs(ARCH, 3))


def test_attention_calls_a_step_against_a_hand_count():
    """Two calls a block (block and grid attention), 2 + 6 + 14 + 2 blocks:
    48 a step. Stage 1 at batch 48: 48 images of 64 windows of 144 tokens, 3
    heads of 32, bound by its bytes (L / 2 = 72 FLOPs a byte); stage 4 one
    window an image, 24 heads."""
    assert 2 * sum(ARCH["depths"]) == 48
    bw, h, L, d = 48 * 64, 3, 144, 32
    assert attention.least_seconds(bw, h, L, d, 2, 0) == pytest.approx(
        attention.least_bytes(bw, h, L, d, 2, 0) / counts.PEAK_HBM_BYTES_PER_S)
    assert attention.least_bytes(48, 24, 144, 32, 2, 0) == 2 * (12 * 48 * 24 * 144 * 32
                                                               + 2 * 24 * 144 * 144)


def _run(**kw):
    cell = small_cell(CELL, res=64, batch=2, **kw)
    return run.execute(CELL, 2 ** 35 + 5, 0.5, False, device="cpu", cell=cell,
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


def _captured(tmp_path: Path, device: str, units: int = 2, res: int = 64, batch: int = 2):
    _, cfg, traffic, _ = small_cell(CELL, res=res, batch=batch)
    r = train_driver.Run(cfg, traffic, 2 ** 33 + 11, device)
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


def test_the_readers_on_a_cpu_capture(tmp_path: Path):
    """Each step notes two calls a block (48), with the partitions' shapes,
    and the counter shows 48 a step; each block's three spans close once a
    step; with no device events and no CUDA timing events every reader reads
    None."""
    from benchmark import spans

    read, calls = _captured(tmp_path, "cpu")
    notes = [c for c in calls["maxvit_attention_roofline"] if c[0] == "call"]
    assert len(notes) == 2 * 48
    # stage 1 at 64 px (partition 2, a 16 x 16 map): 2 images x 64 windows of
    # 4 tokens, 3 heads of 32, block then grid; stage 4's 2 x 2 map is one
    assert notes[0][1:] == notes[1][1:] == (2 * 64, 3, 4, 32, 4, 0)
    assert notes[47][1:] == (2, 24, 4, 32, 4, 0)
    closes = [c for c in calls["maxvit_attention_roofline"] if c[0] != "call"]
    assert spans.counter_per_step(closes, "attention_calls") == 48
    for m, name in (("mbconv_fwd_stream_ms_per_step", "maxvit.mbconv"),
                    ("block_attention_fwd_stream_ms_per_step", "maxvit.block"),
                    ("grid_attention_fwd_stream_ms_per_step", "maxvit.grid")):
        assert [c[0] for c in calls[m]].count(name) == 2 * 24, m
    assert all(v is None for v in read.values())


@pytest.mark.cuda
def test_the_readers_on_a_card_capture(tmp_path: Path):
    """The cell's widths at 384 px, batch 2: the attention kernels take device
    time, their share of the roofline is a share, and the three span
    metrics read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    read, _ = _captured(tmp_path, "cuda", res=384)
    assert 0 < read["maxvit_attention_roofline"] <= 100
    for m in READERS[1:]:
        assert read[m] > 0, m
