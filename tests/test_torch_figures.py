"""The port's paper-figure sweeps (``cli/figure_sigma.py``,
``cli/figure_lambda.py``) against the JAX scripts' CSV layout.

Each sweep trains two values for one epoch on the fixture data through
``primia_tpu_torch.train.loop.main`` on the CPU and appends one row to its
CSV in the working directory; the header and the row are the JAX
``writefile``'s, and the JAX ``visualize_file`` (pandas) renders the
file where pandas is present, as the port's own reader does without it.
"""

import csv
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from primia_tpu_torch.cli import figure_lambda, figure_sigma

ROOT = Path(__file__).resolve().parent.parent
CLASSES = ("bacterial pneumonia", "normal", "viral pneumonia")


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Under the suite's parallel workers, intra-op threads only wait on
    each other (tests/test_torch_mpc.py), so each test runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_materialize_cache(monkeypatch):
    monkeypatch.setenv("PRIMIA_MATERIALIZE_CACHE", "0")


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", ROOT / "figure_scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _check_csv(path: Path, heads, tmp_path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == [str(h) for h in heads] and len(rows) == 2
    assert all(np.isfinite(float(v)) for v in rows[1])
    # the JAX script writes the same bytes for the same row
    ref = tmp_path / "jax.csv"
    _jax_script("sigma").writefile(ref, dict(zip(heads, map(float, rows[1]))), heads)
    assert ref.read_text() == path.read_text()
    assert list(figure_sigma.read_columns(path)) == [str(h) for h in heads]
    pytest.importorskip("pandas")
    pytest.importorskip("matplotlib")
    out = tmp_path / "fig.png"
    _jax_script("sigma").visualize_file(str(path), str(out))
    assert out.stat().st_size > 0
    figure_sigma.visualize_file(path, str(tmp_path / "port.png"))


def test_lambda_sweep_writes_the_jax_csv(fixture_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert figure_lambda.main(["--lambdas", "0.5", "0.9", "--epochs", "1", "--data_dir",
                               str(fixture_dir / "train"), "--batch_size", "4",
                               "--resolution", "28", "--model", "simpleconv",
                               "--device", "cpu"]) == 0
    _check_csv(tmp_path / figure_lambda.RESULTS, [0.5, 0.9], tmp_path)


def test_sigma_sweep_writes_the_jax_csv(tmp_path, monkeypatch):
    from PIL import Image

    data = tmp_path / "fed"
    rng = np.random.default_rng(1)
    for folder, n in (("worker1", 4), ("worker2", 3), ("worker3", 2), ("validation", 3)):
        for ci, cls in enumerate(CLASSES):
            d = data / folder / cls
            d.mkdir(parents=True)
            for i in range(n):
                img = rng.integers(0, 80, (32, 32), dtype=np.uint8) + 40 + 60 * ci
                Image.fromarray(img, mode="L").save(d / f"{i}.jpeg")
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    assert figure_sigma.main(["--sigmas", "1", "2", "--epochs", "1", "--data_dir", str(data),
                              "--batch_size", "4", "--resolution", "28", "--model",
                              "simpleconv", "--device", "cpu"]) == 0
    _check_csv(work / figure_sigma.RESULTS, [1, 2], tmp_path)
