"""The traced stretch notes the calls that a reader's ``PATCHES`` name,
for that reader alone, and leaves the port's functions as they were."""

from pathlib import Path

from benchmark import run
from benchmark import trace as T
from benchmark.drivers import train as train_driver
from benchmark.tests.small import small_cell


def test_capture_notes_k1_calls_for_its_reader(tmp_path: Path):
    from primia_tpu_torch.ops import image

    before = image.tent_rows
    _, cfg, traffic, _ = small_cell("resnet18.train")
    r = train_driver.Run(cfg, traffic, 2 ** 34 + 1, "cpu")
    r.setup()
    r.window(0.01)
    k1 = run._reader("k1_roofline")
    dev, attributed, calls = T.capture(r, 1, tmp_path / "t.json", "cpu",
                                       {"k1_roofline": k1.PATCHES})
    assert image.tent_rows is before
    assert set(calls) == {"k1_roofline"} and len(calls["k1_roofline"]) >= 2
    planes, coords = calls["k1_roofline"][0]
    assert len(planes) == 3 and len(coords) == 3 and planes[1:] == coords[1:]
    assert attributed.window_us > 0 and not (tmp_path / "t.json").exists()
    assert k1.read(T.Ctx(unit="step", units=1, images_per_unit=4, unit_seconds=r.unit_seconds,
                         cfg=cfg, trace=dev, attributed=attributed,
                         calls=calls["k1_roofline"])) is None  # no device time on the CPU
