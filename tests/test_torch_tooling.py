"""The port's tooling against the JAX package, on the CPU: ``cli/warm.py``,
``profiler.py`` (the roofline on the same ``OpStat`` lists, the trace
parser on a synthetic trace and on a CPU trace of ``utils.profile``),
``utils.LoggingEngine`` over a share-space forward, the label-CSV
datasets and ``parallel/linalg.py``.

Tolerances: the roofline is pure Python arithmetic, so its numbers and
table are equal. The datasets give equal paths and labels. ``linalg``
reveals the same 24-bit fixed-point sums as the JAX package whatever the
shares, unless a float64 product before the encoding differs in its last
bit between the two libraries; the results agree within 1e-9 relative
(measured: under 1e-13).
"""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primia_tpu import profiler as jax_profiler
from primia_tpu.data import PPPP as JaxPPPP
from primia_tpu.data import ImageFolderFromCSV as JaxImageFolderFromCSV
from primia_tpu.nn.core import PLAIN
from primia_tpu.nn.simpleconv import simpleconv_forward as jax_simpleconv_forward
from primia_tpu.parallel import linalg as jax_linalg
from primia_tpu.utils import LoggingEngine as JaxLoggingEngine
from primia_tpu_torch import profiler, utils
from primia_tpu_torch.cli import warm
from primia_tpu_torch.data import PPPP, ImageFolderFromCSV
from primia_tpu_torch.mpc import fixed
from primia_tpu_torch.mpc import shares as S
from primia_tpu_torch.mpc.engine import (MpcContext, MpcEngine, encode_and_share,
                                         reveal_and_decode)
from primia_tpu_torch.mpc.inference import folded_weights, simpleconv_forward
from primia_tpu_torch.nn.jax_params import to_jax_tree
from primia_tpu_torch.nn.simpleconv import SimpleConv
from primia_tpu_torch.parallel import linalg

LINALG_RTOL = 1e-9


@pytest.fixture(autouse=True)
def _one_intra_op_thread(monkeypatch):
    """Under the suite's parallel workers, intra-op threads only wait on
    each other, so each test runs on one."""
    monkeypatch.setenv("PRIMIA_MATERIALIZE_CACHE", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ warm

def test_warm_runs_the_train_and_eval_steps_on_the_cpu(fixture_dir, tmp_path, capsys,
                                                       monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = tmp_path / "w.ini"
    cfg.write_text(
        "[config]\nbatch_size = 4\ntest_batch_size = 2\n"
        "train_resolution = 28\ninference_resolution = 28\nepochs = 1\n"
        "lr = 1e-3\nend_lr = 1e-4\noptimizer = Adam\nmodel = simpleconv\n"
        "pretrained = no\n"
        "[augmentation]\nrotation = 10\n")
    assert warm.main(["--config", str(cfg), "--data_dir", str(fixture_dir / "train"),
                      "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [line.split(" (")[0] for line in out] == ["train step ran", "eval step ran",
                                                     "warm: 0 kernel libraries built, "
                                                     "2 programs run"]
    assert list(tmp_path.iterdir()) == [cfg]  # no weights written


def test_warm_defaults_to_the_card(fixture_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        warm.main(["--config", "configs/torch/pneumonia-resnet-pretrained.ini",
                   "--data_dir", str(fixture_dir / "train")])


# -------------------------------------------------------------- profiler

def _op_lists():
    rows = [("aten::cudnn_convolution float[8, 3, 224, 224]", 4.0, 2, 1_234_567, 9_876_543_210),
            ("aten::add_ float[1024]", 0.5, 10, 12_288, 0),
            ("tent_rows_kernel", 0.25, 4, 0, 0),
            ("aten::mm float[64, 128], float[128, 256]", 0.003, 3, 163_840, 4_194_304)]
    return ([jax_profiler.OpStat(*r) for r in rows], [profiler.OpStat(*r) for r in rows])


@pytest.mark.parametrize("roofs", [(3350.0, 989.0), (819.0, 197.0)])
def test_roofline_is_the_jax_roofline(roofs):
    jax_ops, ops = _op_lists()
    hbm, tflops = roofs
    want = jax_profiler.roofline(jax_ops, hbm_gbs=hbm, mxu_tflops=tflops, top=3)
    got = profiler.roofline(ops, hbm_gbs=hbm, mxu_tflops=tflops, top=3)
    assert got == want
    for a, b in zip(ops, jax_ops):
        assert a.floor_ms(hbm, tflops) == b.floor_ms(hbm, tflops)
        assert (a.per_call_ms, a.achieved_gbs()) == (b.per_call_ms, b.achieved_gbs())


def test_default_roofs_are_the_h100s():
    assert profiler.device_roofs("NVIDIA H100 80GB HBM3") == (3350.0, 989.0)
    op = profiler.OpStat("x", 1.0, 1, 3_350_000_000, 0)
    assert op.floor_ms() == pytest.approx(1.0)
    with pytest.raises(KeyError):
        profiler.device_roofs("TPU v5 lite")


def _x(cat, name, ts, dur, tid=1, pid=7, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": pid,
            "tid": tid, "args": args}


def _synthetic_trace(path):
    """Two annotated steps on one host thread; step 0 runs a conv (its
    kernel launched inside ``aten::cudnn_convolution`` under
    ``aten::conv2d``) and a copy, step 1 an ``addmm`` from the autograd
    thread and a kernel no op launched (a ``ctypes`` launch)."""
    conv = dict(**{"Input Dims": [[8, 3, 32, 32], [16, 3, 3, 3], [], [], [], []],
                   "Input type": ["float", "float", "ScalarList", "ScalarList",
                                  "ScalarList", "Scalar"],
                   "Concrete Inputs": ["", "", "[1, 1]", "[2, 2]", "[1, 1]", "1"]})
    mm = {"Input Dims": [[64], [32, 128], [128, 64]], "Input type": ["float"] * 3}
    ev = [
        _x("user_annotation", "step#0", 0, 100),
        _x("cpu_op", "aten::conv2d", 10, 50, **{"Input Dims": [[8, 3, 32, 32]],
                                                "Input type": ["float"]}),
        _x("cpu_op", "aten::cudnn_convolution", 12, 40, **conv),
        _x("cpu_op", "aten::empty", 13, 2),
        _x("cuda_runtime", "cudaLaunchKernel", 30, 5, correlation=1),
        _x("cuda_runtime", "cudaMemcpyAsync", 45, 5, correlation=2),
        _x("kernel", "implicit_gemm", 200, 400, tid=3, pid=0, correlation=1),
        _x("gpu_memcpy", "Memcpy DtoD", 600, 100, tid=3, pid=0, correlation=2),
        _x("user_annotation", "step#1", 1000, 100),
        _x("cpu_op", "aten::addmm", 1010, 20, tid=2, **mm),
        _x("cuda_runtime", "cudaLaunchKernel", 1015, 3, tid=2, correlation=3),
        _x("cuda_driver", "cuLaunchKernel", 1050, 3, correlation=4),
        _x("kernel", "sm90_gemm", 1100, 300, tid=3, pid=0, correlation=3),
        _x("kernel", "tent_rows_kernel", 1400, 200, tid=3, pid=0, correlation=4),
        _x("gpu_user_annotation", "step#1", 1100, 500, tid=3, pid=0),
    ]
    path.write_text(json.dumps({"traceEvents": ev + [{"ph": "s", "id": 1, "ts": 30}]}))
    return path


def test_trace_parser_attributes_each_device_event_once(tmp_path):
    trace = _synthetic_trace(tmp_path / "t.json")
    ops = {o.name.split(" ")[0]: o for o in profiler.parse_trace(str(tmp_path))}
    assert sorted(ops) == ["aten::addmm", "aten::cudnn_convolution", "tent_rows_kernel"]
    conv, mm, own = ops["aten::cudnn_convolution"], ops["aten::addmm"], ops["tent_rows_kernel"]
    # the conv's kernel and copy, under the innermost op that launched them
    assert (conv.total_ms, conv.count) == (0.5, 1)
    out = 8 * 16 * 16 * 16  # stride 2, padding 1: 32 -> 16
    assert conv.flops_est == 2 * out * 3 * 3 * 3
    assert conv.bytes_est == 4 * (8 * 3 * 32 * 32 + 16 * 3 * 3 * 3 + out)
    assert mm.flops_est == 2 * 32 * 128 * 64
    assert mm.bytes_est == 4 * (64 + 32 * 128 + 128 * 64 + 32 * 64)
    assert (own.total_ms, own.count, own.bytes_est) == (0.2, 1, 0)
    assert sum(o.total_ms for o in ops.values()) == pytest.approx(1.0)  # every device event
    windows = profiler.module_executions(str(trace), "step#")
    assert [(n, round(s, 6), round(d, 6)) for n, s, d in windows] == [
        ("step#0", 0.0, 0.5), ("step#1", 0.9, 0.5)]
    r = profiler.roofline(profiler.parse_trace(str(trace)))
    assert r["total_ms"] == pytest.approx(1.0) and 0 < r["efficiency"] <= 1


def test_trace_parser_reads_a_cpu_trace_of_utils_profile(tmp_path):
    torch.manual_seed(0)
    conv = torch.nn.Conv2d(3, 8, 3, stride=2, padding=1)
    x = torch.randn(2, 3, 16, 16, requires_grad=True)  # both gradients
    with utils.profile(str(tmp_path)) as prof:
        for i in range(2):
            with torch.profiler.record_function(f"step#{i}"):
                conv(x).relu().sum().backward()
    assert prof is not None
    trace = str(tmp_path / utils.TRACE_FILE)
    assert profiler.parse_trace(trace) == []  # no device events on the CPU
    assert profiler.module_executions(trace, "step#") == []
    ops = profiler.parse_trace(trace, host=True)
    fwd = 2 * 2 * 8 * 8 * 8 * 3 * 3 * 3
    work = {o.name.split(" ")[0]: o for o in ops if o.flops_est}
    # the innermost convolution counts the work; its wrappers count none
    assert "aten::convolution_backward" in work and len(work) == 2
    assert sorted(o.flops_est for o in work.values()) == [fwd, 2 * fwd]
    back = work["aten::convolution_backward"]
    assert back.count == 2 and back.total_ms > 0
    r = profiler.roofline(ops)
    assert r["conv_tflops"] * 1e12 == pytest.approx(2 * 3 * fwd)


# --------------------------------------------------------- LoggingEngine

def test_logging_engine_records_the_jax_op_sequence():
    """SimpleConv@28's share-space forward through the port's MpcEngine
    (SecureNN) and the JAX forward through its plain engine record the
    same ops on operands of the same sizes (NCHW here, NHWC there)."""
    torch.manual_seed(0)
    model = SimpleConv(28, num_classes=3, in_channels=1).eval()
    x = torch.rand(1, 1, 28, 28)
    frac = fixed.DEFAULT_FRAC_BITS
    shared = encode_and_share(S.stream("cpu", 1), folded_weights(model), frac)
    eng = utils.LoggingEngine(MpcEngine(MpcContext(S.stream("cpu", 2), frac, "snn")))
    assert eng.name == "logged(mpc)"
    xs = S.share(S.stream("cpu", 3), fixed.encode(x, frac))
    with torch.inference_mode():
        got = reveal_and_decode(simpleconv_forward(eng, shared, model, xs), frac).float()
        want = model(x)
    assert float((got - want).abs().max()) <= 0.02  # tests/test_mpc.py's tolerance

    params, state = to_jax_tree(model)
    jeng = JaxLoggingEngine(PLAIN)
    jax_out, _ = jax_simpleconv_forward(params, state, jnp.asarray(x.permute(0, 2, 3, 1).numpy()),
                                        E=jeng, resolution=28)
    np.testing.assert_allclose(np.asarray(jax_out), want.numpy(), atol=1e-4)

    def sizes(log):
        return [(op, [math.prod(s) for s in shapes if isinstance(s, tuple)])
                for op, shapes in log]

    assert sizes(eng.log) == sizes(jeng.log)
    assert [op for op, _ in eng.log][:3] == ["conv2d", "bias_add", "relu"]
    assert eng.summary().splitlines()[0].split()[:2] == ["0", "conv2d"]


# -------------------------------------------------------------- datasets

def _write_csvs(tmp_path):
    rows = [("b.jpeg", "Pnemonia", "bacteria", "TRAIN", 1), ("a.jpeg", "Normal", "", "TRAIN", 0),
            ("c.jpeg", "Pnemonia", "Virus", "TEST", 2), ("d.jpeg", "Pnemonia", "Stress-Smoking",
                                                         "TEST", 2),
            ("e.jpeg", "Pneumonia", "Virus", "TRAIN", 2), ("f.jpeg", "Pnemonia", "Virus",
                                                           "TRAIN", 2)]
    meta = tmp_path / "meta.csv"
    meta.write_text("X_ray_image_name,Label,Label_1_Virus_category,Dataset_type,Numeric_Label\n"
                    + "".join(",".join(map(str, r)) + "\n" for r in rows))
    folder = tmp_path / "imgs"
    folder.mkdir()
    for name, *_ in rows:
        (folder / name).write_bytes(b"")
    (folder / ".hidden").write_bytes(b"")
    return meta, folder


def test_label_csv_datasets_match_jax(tmp_path):
    meta, folder = _write_csvs(tmp_path)
    got, want = ImageFolderFromCSV(meta, folder), JaxImageFolderFromCSV(meta, folder)
    assert got.paths == want.paths and [p[-6:] for p in got.paths] == [
        "a.jpeg", "b.jpeg", "c.jpeg", "f.jpeg"]
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.labels.dtype == want.labels.dtype == np.int32
    assert (got.classes, got.channels) == (want.classes, want.channels)
    for train in (True, False):
        got, want = PPPP(meta, train=train), JaxPPPP(meta, train=train)
        assert got.paths == want.paths
        np.testing.assert_array_equal(got.labels, want.labels)
        assert got.labels.dtype == want.labels.dtype == np.int32
        assert got.get_class_occurances() == want.get_class_occurances()
    (folder / "x.jpeg").write_bytes(b"")
    with pytest.raises(AssertionError, match="img label not known x.jpeg"):
        ImageFolderFromCSV(meta, folder)


# ---------------------------------------------------------------- linalg

def _nodes(rng, n=240, p=4, sizes=(80, 80, 80)):
    X = rng.normal(size=(n, p))
    y = 0.8 + X @ np.array([1.5, -2.0, 0.0, 0.7]) + rng.normal(scale=0.1, size=n)
    cut = np.cumsum(sizes)[:-1]
    return np.split(X, cut), np.split(y, cut)


@pytest.mark.parametrize("crypto", [True, False])
def test_linear_regression_matches_jax(crypto):
    Xn, yn = _nodes(np.random.default_rng(0))
    got = linalg.EncryptedLinearRegression(crypto=crypto, device="cpu").fit(Xn, yn)
    want = jax_linalg.EncryptedLinearRegression(crypto=crypto).fit(Xn, yn)
    for a, b in zip(got.summary[:3], want.summary[:3]):
        np.testing.assert_allclose(a, b, rtol=LINALG_RTOL)
    assert got.summary.n_obs == want.summary.n_obs
    assert got.summary.sigma2 == pytest.approx(want.summary.sigma2, rel=LINALG_RTOL)
    np.testing.assert_allclose(got.predict(Xn[0][:5]), want.predict(Xn[0][:5]),
                               rtol=LINALG_RTOL)
    assert got.summarize().splitlines()[2:] == want.summarize().splitlines()[2:]


def test_dash_inv_sym_and_cholesky_qr_match_jax():
    import jax

    rng = np.random.default_rng(1)
    X = [rng.normal(size=(40, 5)) for _ in range(3)]
    C = [rng.normal(size=(len(x), 2)) for x in X]
    y = [x[:, 1] * 0.5 + c @ np.array([0.3, -0.2]) + rng.normal(scale=0.1, size=len(x))
         for x, c in zip(X, C)]
    got = linalg.DASH(device="cpu").fit(X, C, y)
    want = jax_linalg.DASH().fit(X, C, y)
    for a, b in ((got.get_coeff(), want.get_coeff()),
                 (got.get_standard_errors(), want.get_standard_errors()),
                 (got.get_p_values(), want.get_p_values())):
        np.testing.assert_allclose(a, b, rtol=LINALG_RTOL)
    m = X[0].T @ X[0] + np.eye(5)
    np.testing.assert_allclose(linalg.inv_sym(torch.from_numpy(m)).numpy(),
                               np.asarray(jax_linalg.inv_sym(jnp.asarray(m))), rtol=LINALG_RTOL)
    gen = torch.Generator().manual_seed(0)
    Q, R = linalg.cholesky_qr(gen, [torch.from_numpy(x) for x in X])
    jQ, jR = jax_linalg.cholesky_qr(jax.random.PRNGKey(0), [jnp.asarray(x) for x in X])
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), rtol=LINALG_RTOL)
    for q, jq in zip(Q, jQ):
        np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=LINALG_RTOL, atol=1e-12)
    stacked = torch.cat(Q)
    np.testing.assert_allclose((stacked.T @ stacked).numpy(), np.eye(5), atol=1e-6)


def test_linalg_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        linalg.EncryptedLinearRegression()
