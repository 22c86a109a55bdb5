"""The port's data parallelism and multi-process runs against the JAX
package (``tests/test_parallel.py``'s counterpart).

The port runs one rank a process, one device a rank, on
``torch.distributed``; here two (or four) CPU ranks over gloo, spawned by
``primia_tpu_torch.parallel.launch`` on a free port with one intra-op
thread and a deadline. The JAX side runs in this process on its 8-device
CPU mesh (``tests/conftest.py``). Deviation kept: ``slice_topology``
counts one device a rank, where the JAX package counts every device of
the slice. Each test states its limit.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primia_tpu.config import Arguments as JaxArguments
from primia_tpu.nn import ModelDef
from primia_tpu.nn import create_model as jax_create_model
from primia_tpu.nn.resnet import resnet_forward
from primia_tpu.parallel import multihost as jax_multihost
from primia_tpu.parallel.data_parallel import data_parallel_mesh as jax_dp_mesh
from primia_tpu.parallel.data_parallel import shard_batch as jax_shard_batch
from primia_tpu.parallel.data_parallel import shard_train_step as jax_shard_train_step
from primia_tpu.parallel.data_parallel import replicate as jax_replicate
from primia_tpu.train import optim as jax_optim
from primia_tpu.train.steps import TrainState
from primia_tpu_torch.config import Arguments
from primia_tpu_torch.mpc.aggregation import secure_fedavg
from primia_tpu_torch.nn import ResNet, create_model
from primia_tpu_torch.nn.jax_params import from_jax_tree, to_jax_tree
from primia_tpu_torch.parallel import launch, multihost
from primia_tpu_torch.train.steps import build_eval_step, build_train_step

MEAN1, STD1 = np.array([0.5]), np.array([0.25])
MEAN3, STD3 = np.array([0.5, 0.45, 0.4]), np.array([0.25, 0.24, 0.23])
TIMEOUT = 240.0


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Under the suite's parallel workers, intra-op threads only wait on
    each other (tests/test_torch_mpc.py), so each test runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spawn(target, world, payload, env=None):
    return launch.spawn(f"primia_tpu_torch.parallel.launch:{target}", world,
                        {**payload, "device": "cpu"}, device="cpu", timeout=TIMEOUT, env=env)


def _batch(n, res, channels, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, res, res, channels), dtype=np.uint8),
            rng.integers(0, 3, n).astype(np.int32), np.ones(n, np.float32))


# ------------------------------------------------------------- multihost

@pytest.mark.parametrize("n,nodes,want", [(8, 3, (2, 4)), (8, 4, (4, 2)), (8, 8, (8, 1)),
                                          (6, 3, (3, 2)), (1, 3, (1, 1))])
def test_factor_mesh_matches_jax(n, nodes, want):
    assert multihost.factor_mesh(n, nodes) == jax_multihost.factor_mesh(n, nodes) == want


def test_initialize_is_a_noop_without_a_cluster(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize() is False
    assert multihost.backend() is None
    # one device a rank: one process is one device (JAX counts its 8)
    assert multihost.slice_topology() == (0, 1, 1)
    mesh = multihost.federated_mesh(n_nodes=3)
    assert mesh.axis_names == ("node", "data") and mesh.shape == {"node": 1, "data": 1}
    assert mesh.group("node") is None and mesh.index("node") == 0
    with pytest.raises(ValueError):
        multihost.initialize("127.0.0.1:1")


def test_backend_choice():
    assert multihost.choose_backend("cpu", 2) == "gloo"
    # no card here: a CUDA run of 2 ranks on 0 cards shares nothing it has
    assert multihost.choose_backend("cuda", torch.cuda.device_count() + 1) == "gloo"


# ---------------------------------------------------------- launch counts

LAUNCHERS = ("clahe", "clahe_lab", "tent_rows", "tent_bilinear", "dcf_sign", "conv3x3_wgrad",
             "bn_sums", "bn_finalize", "bn_apply", "bn_grad_sums", "bn_grad_finalize", "bn_dx",
             "gaussian_noise", "window_attention_fwd", "window_attention_bwd")


class _FakeTentLibrary:
    """Stands in for the loaded ``csrc/tent.cu``: ``tent_rows`` records
    its arguments and returns ``err``."""

    def __init__(self, err):
        self.err, self.calls = err, []

    def tent_rows(self, *args):
        self.calls.append(args)
        return self.err

    def tent_error_string(self, err):
        return b"an illegal memory access was encountered" if err == 700 else b"unknown"


@pytest.mark.parametrize("err", [0, 700])
def test_a_launch_raises_on_an_error_and_counts_only_a_zero(err, monkeypatch):
    """``_build.launch`` passes the device's current raw stream last; a
    non-zero return raises naming the launcher and the library's error
    text and counts nothing, a 0 counts one launch."""
    from primia_tpu_torch.ops import _build

    lib = _FakeTentLibrary(err)
    monkeypatch.setitem(_build._loaded, "tent", lib)
    monkeypatch.setitem(_build.launches, "tent_rows", 0)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 4096 + index,
                        raising=False)
    if err:
        with pytest.raises(RuntimeError, match=r"^tent_rows launch failed: CUDA error 700 "
                                               r"\(an illegal memory access was encountered\)$"):
            _build.launch("tent", "tent_rows", torch.device("cuda", 0), 11, 12)
    else:
        _build.launch("tent", "tent_rows", torch.device("cuda", 0), 11, 12)
    assert lib.calls == [(11, 12, 4096)]
    assert _build.launches["tent_rows"] == (0 if err else 1)


def test_reset_launches_leaves_every_launcher_at_zero(monkeypatch):
    """After ``reset_launches`` the one count lists the 15 launchers of the
    seven kernel libraries, each at 0."""
    from primia_tpu_torch.ops import _build

    for name in launch.read_launches():
        monkeypatch.setitem(_build.launches, name, 3)
    launch.reset_launches()
    assert launch.read_launches() == dict.fromkeys(LAUNCHERS, 0)


def test_federated_mesh_over_four_ranks():
    """Four ranks, two nodes: a (2, 2) grid of ranks, each rank at its
    (node, data) coordinate, over gloo; ``shard_batch`` over all four
    gives each its quarter."""
    got = _spawn("mesh_info", 4, {"n_nodes": 2})
    for r in got:
        info = r.result
        assert info["topology"] == (r.rank, 4, 4) and info["backend"] == "gloo"
        assert info["ranks"] == [[0, 1], [2, 3]] and info["shape"] == {"node": 2, "data": 2}
        assert (info["node"], info["data"]) == divmod(r.rank, 2)
        assert info["rows"] == [2 * r.rank, 2 * r.rank + 1]


# ------------------------------------------------------ the sharded step

def _jax_model(kind):
    if kind == "simpleconv":
        args = JaxArguments(model="simpleconv", train_resolution=28, inference_resolution=28,
                            batch_size=16, pretrained=False)
        return jax_create_model(args, num_classes=3), args, 28, 1, 16
    fwd = lambda p, s, x, **kw: resnet_forward(p, s, x, layers=(1, 1, 1, 1),  # noqa: E731
                                               pooling="max", input_size=32, **kw)
    md = ModelDef("resnet-18", None, fwd, 32, 3, 3, "max")
    args = JaxArguments(model="resnet-18", train_resolution=32, inference_resolution=32,
                        batch_size=8, pretrained=False)
    return md, args, 32, 3, 8


def _port_model(kind, params, state):
    if kind == "simpleconv":
        model = create_model(Arguments(model="simpleconv", train_resolution=28,
                                       inference_resolution=28), num_classes=3, device="cpu")
    else:
        model = ResNet((1, 1, 1, 1), num_classes=3, in_channels=3, input_size=32)
    model.load_state_dict(from_jax_tree(params, state))
    return model


@pytest.mark.parametrize("kind", ["simpleconv", "resnet"])
def test_two_rank_step_matches_jax_shard_train_step(kind):
    """SimpleConv @ 28 at a global batch of 16, and a one-block ResNet @ 32
    (batch norm) at 8, augmentation and mixup off: two gloo ranks against
    the JAX ``shard_train_step`` on a 2-device mesh from the same weights.
    The loss within 1e-5 relative, every gradient leaf within 1e-4 of its
    largest |g| (JAX's from its SGD update at lr 1), the BN running
    statistics within 1e-5."""
    md, jargs, res, ch, B = _jax_model(kind)
    params, state = md.init(jax.random.PRNGKey(0)) if kind == "simpleconv" else \
        to_jax_tree(_seeded_resnet())
    imgs, labels, mask = _batch(B, res, ch, seed=1)
    mean, std = (MEAN1, STD1) if ch == 1 else (MEAN3, STD3)
    mesh = jax_dp_mesh(2)
    opt = jax_optim.sgd()
    step = jax_shard_train_step(md, opt, jargs, mean, std, mesh=mesh, donate=False)
    ts = TrainState(params, state, opt.init(params))
    ts2, jloss = step(jax_replicate(ts, mesh), jax.random.PRNGKey(0),
                      *jax_shard_batch((jnp.asarray(imgs), jnp.asarray(labels),
                                        jnp.asarray(mask)), mesh), 1.0)
    jgrads = from_jax_tree(jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                                        params, ts2.params), {})
    jstate = from_jax_tree(params, ts2.model_state)

    model = _port_model(kind, params, state)
    args = Arguments(model=jargs.model, train_resolution=res, inference_resolution=res,
                     batch_size=B)
    got = _spawn("train_steps", 2, {"args": args, "model": model, "mean": mean, "std": std,
                                    "batches": [(imgs, labels.astype(np.int64), mask)],
                                    "record": True})
    for r in got:
        np.testing.assert_allclose(r.result["losses"][0], float(jloss), rtol=1e-5)
        for name, g in r.result["grads"].items():
            ref = jgrads[name].numpy()
            np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max(),
                                       err_msg=name)
        for name, t in r.result["state_dict"].items():
            if "running" in name:
                np.testing.assert_allclose(t.numpy(), jstate[name].numpy(), atol=1e-5,
                                           err_msg=name)
    assert kind == "simpleconv" or any("running" in n for n in got[0].result["state_dict"])


def _seeded_resnet():
    torch.manual_seed(5)
    return ResNet((1, 1, 1, 1), num_classes=3, in_channels=3, input_size=32)


def _augmented_args(**kw):
    return Arguments(model="resnet-18", train_resolution=32, inference_resolution=36,
                     batch_size=8, rotation=10.0, translate=0.1, scale=0.1, clahe=True,
                     randomgamma=True, randombrightness=True, elastic=True, cutout=True,
                     albu_prob=0.9, individual_albu_probs=0.7, noise_std=0.05,
                     noise_prob=0.5, mixup=True, mixup_prob=0.9, optimizer="SGD",
                     momentum=0.9, **kw)


@pytest.mark.parametrize("switched", [False, True], ids=["default", "switched_bn"])
def test_two_rank_step_with_augmentation_and_mixup_matches_one_process(switched, monkeypatch):
    """The whole chain (two-pass affine, random crop, CLAHE, the gated
    block, the fused warp, GaussNoise) and MixUp over the global batch:
    two ranks against the port's one-process step from the same generator
    seed, two steps of SGD with momentum (Adam's first step divides each
    gradient by its own magnitude, so it turns rounding into whole steps
    of the learning rate). Float32: the losses within 1e-5 relative, the
    BN running statistics within 1e-5. The switched batch norm
    (``PRIMIA_PALLAS_BN=1``, bfloat16 compute, its plain launches here):
    one step, held to the same limits (a bfloat16 step's weight gradients
    differ by a share between any two batchings, so a second step's loss
    would not)."""
    env = {"PRIMIA_PALLAS_BN": "1"} if switched else None
    if switched:
        monkeypatch.setenv("PRIMIA_PALLAS_BN", "1")
    args = _augmented_args(compute_dtype="bfloat16" if switched else "float32")
    model = _seeded_resnet()
    start = copy.deepcopy(model)
    batches = [_batch(8, 36, 3, seed=s) for s in ((2,) if switched else (2, 3))]
    batches = [(i, lab.astype(np.int64), m) for i, lab, m in batches]
    from primia_tpu_torch.train.optim import make_optimizer

    step = build_train_step(model, make_optimizer(args, model), args, MEAN3, STD3, device="cpu")
    gen = torch.Generator().manual_seed(11)
    want = [float(step(gen, *b, 0.05)) for b in batches]
    assert switched or abs(want[1] - want[0]) > 1e-3
    got = _spawn("train_steps", 2, {"args": args, "model": start, "mean": MEAN3, "std": STD3,
                                    "batches": batches, "seed": 11, "lr": 0.05}, env=env)
    ref = model.state_dict()
    for r in got:
        np.testing.assert_allclose(r.result["losses"], want, rtol=1e-5)
        for name, t in r.result["state_dict"].items():
            if "running" in name:
                np.testing.assert_allclose(t.numpy(), ref[name].numpy(), atol=1e-5,
                                           err_msg=name)


def test_sharded_eval_step_gathers_the_logits():
    """(16, 3) logits on both ranks, equal to the one-process eval within
    1e-6, and the same loss."""
    args = Arguments(model="simpleconv", train_resolution=28, inference_resolution=28,
                     batch_size=16)
    torch.manual_seed(2)
    model = create_model(args, num_classes=3, device="cpu")
    imgs, labels, mask = _batch(16, 28, 1, seed=4)
    labels = labels.astype(np.int64)
    loss, logits = build_eval_step(model, args, MEAN1, STD1, device="cpu")(imgs, labels, mask)
    got = _spawn("eval_step", 2, {"args": args, "model": model, "mean": MEAN1, "std": STD1,
                                  "batch": (imgs, labels, mask)})
    for r in got:
        assert r.result["logits"].shape == (16, 3)
        np.testing.assert_allclose(r.result["logits"].numpy(), logits.numpy(), atol=1e-6)
        np.testing.assert_allclose(r.result["loss"], float(loss), rtol=1e-6)


# ------------------------------------------------ secure FedAvg, 2 ranks

def test_two_process_secure_fedavg():
    """``test_parallel.py:test_multihost_two_process_secure_fedavg``'s
    round: two processes, one node each; the result bit for bit the
    one-process ``secure_fedavg`` of the whole stack, within 2e-3 of
    ``np.average``, on both ranks."""
    full = {"w": np.arange(24.0, dtype=np.float32).reshape(2, 4, 3) / 7.0,
            "bn": {"count": np.array([[3], [5]], np.int64),
                   "mean": np.linspace(-1, 1, 6, dtype=np.float32).reshape(2, 3)}}
    weights = np.array([0.625, 0.375])
    key = (0, 777, 1)
    try:
        got = _spawn("secure_fedavg_round", 2, {"n_nodes": 2, "stacked": full,
                                                "weights": weights, "key": key})
    except RuntimeError as e:
        if any(m in str(e) for m in ("PermissionError", "Address family")):
            pytest.skip(f"the environment forbids the rendezvous: {str(e)[-300:]}")
        raise
    ref = secure_fedavg(key, {"w": torch.from_numpy(full["w"]),
                              "bn": {k: torch.from_numpy(v) for k, v in full["bn"].items()}},
                        weights)
    for r in got:
        assert r.result["topology"] == (r.rank, 2, 2) and r.result["backend"] == "gloo"
        out = r.result["out"]
        assert torch.equal(out["w"], ref["w"]) and torch.equal(out["bn"]["mean"],
                                                              ref["bn"]["mean"])
        assert torch.equal(out["bn"]["count"], torch.tensor([3]))
        np.testing.assert_allclose(out["w"].numpy(),
                                   np.average(full["w"], axis=0, weights=weights), atol=2e-3)
