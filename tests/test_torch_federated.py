"""The port's federated slice against the JAX package: the aggregation, the
worker topology, the server-simulation data tools and federated training
end to end, on the CPU.

Share-space code is held bit for bit: both packages reveal the ring sum of
the nodes' encodings, whatever their shares, so ``secure_fedavg`` and
``secure_average_stats`` must give the same bits. ``plain_fedavg`` sums
in float64 in either package's order and rounds once to float32: within
one float32 ulp. A federated run from one shared checkpoint goes through
both packages and is held by the limits its test states. Inputs are numpy
draws handed to both sides; JAX runs with x64 on, so dtypes are pinned.
"""

import argparse
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import keystr, tree_flatten_with_path

from primia_tpu.config import Arguments as JaxArguments
from primia_tpu.config import read_worker_config as jax_read_worker_config
from primia_tpu.data import distribute as jax_distribute
from primia_tpu.mpc import aggregation as jagg
from primia_tpu.mpc import fixed as jfixed
from primia_tpu.mpc import shares as JS
from primia_tpu.parallel.federated import discover_workers as jax_discover_workers
from primia_tpu.train import checkpoint as jax_ckpt
from primia_tpu_torch.config import Arguments, read_worker_config
from primia_tpu_torch.data import distribute
from primia_tpu_torch.mpc import aggregation as agg
from primia_tpu_torch.mpc import fixed
from primia_tpu_torch.mpc import shares as S
from primia_tpu_torch.nn import ResNet
from primia_tpu_torch.nn.jax_params import jax_leaf_paths, to_jax_tree
from primia_tpu_torch.parallel import federated
from primia_tpu_torch.train import checkpoint as ckpt
from primia_tpu_torch.train.optim import SGD, Adam

ROOT = Path(__file__).resolve().parent.parent
FEDERATED_INI = ROOT / "configs" / "torch" / "pneumonia-resnet-pretrained-federated.ini"
CLASSES = ("bacterial pneumonia", "normal", "viral pneumonia")
STEP = 2.0 ** -16  # one fixed-point step at precision_fractional = 16


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


def _shards(root: Path, image, per_class=(4, 3, 2), validation=3, seed=1):
    """``tests/test_federated.py``'s layout: worker1..3 with 4/3/2 images a
    class (uneven shards) and a validation folder of 3 a class; ``image``
    makes one 32x32 uint8 image from (rng, class index)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    folders = [(f"worker{w + 1}", n) for w, n in enumerate(per_class)] + [("validation",
                                                                           validation)]
    for folder, n in folders:
        for ci, cls in enumerate(CLASSES):
            d = root / folder / cls
            d.mkdir(parents=True)
            for i in range(n):
                Image.fromarray(image(rng, ci), mode="L").save(d / f"{i}.jpeg")
    return root


@pytest.fixture(scope="module")
def fed_dir(tmp_path_factory):
    """The JAX federated tests' images: a flat field a class, noise on top."""
    return _shards(tmp_path_factory.mktemp("fed"), lambda rng, ci: (
        rng.integers(0, 80, (32, 32), dtype=np.uint8) + 40 + 60 * ci))


def _stacked(rng, n=3):
    """A node-stacked tree in the JAX layout with a count leaf."""
    return {
        "params": {"conv": {"w": rng.normal(0, 0.3, (n, 3, 3, 2, 4)).astype(np.float32)},
                   "layer": [{"bn": {"gamma": rng.normal(1, 0.1, (n, 4)).astype(np.float32),
                                     "beta": rng.normal(0, 0.1, (n, 4)).astype(np.float32)}}]},
        "state": {"layer": [{"bn": {"mean": rng.normal(0, 1, (n, 4)).astype(np.float32),
                                    "var": rng.uniform(0.5, 2, (n, 4)).astype(np.float32),
                                    "count": np.array([7, 5, 6][:n], np.int64)}}]},
    }


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


WEIGHTS = {"weighted": np.array([3, 3, 2], np.float64) / 8, "equal": np.full(3, 1 / 3)}


# ------------------------------------------------------------- aggregation

@pytest.mark.parametrize("kind", sorted(WEIGHTS))
def test_plain_fedavg_matches_jax(kind):
    """Weighted and equal weights: every leaf within one float32 ulp (both
    sum in float64 and round once; the order of the sum may differ)."""
    tree = _stacked(np.random.default_rng(0))
    w = WEIGHTS[kind]
    got = agg.plain_fedavg(_torch_tree(tree), w)
    ref = jagg.plain_fedavg(jax.tree.map(jnp.asarray, tree), w)
    for a, b in zip(_leaves(jax.tree.map(lambda t: t.numpy(), got)), _leaves(ref)):
        assert a.dtype == b.dtype
        if a.dtype == np.float32:
            np.testing.assert_array_max_ulp(a, b, maxulp=1)
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", sorted(WEIGHTS))
def test_secure_fedavg_is_bit_equal_to_jax(kind):
    """Bit for bit, with the JAX package's own key: the reveal is the ring
    sum of the encodings whatever the shares. One leaf's encodings are
    near +-2^62, so the node sum itself wraps mod 2^64 where the signs
    agree (the decoded value is then garbage, but the same garbage in
    both)."""
    tree = _stacked(np.random.default_rng(1))
    big = np.random.default_rng(2).choice([-1.0, 1.0], (3, 5)) * 2.0 ** 47 * 1.2
    big[:, 0] = 2.0 ** 47 * 1.2
    tree["params"]["wrap"] = {"w": big.astype(np.float32)}
    w = WEIGHTS[kind]
    got = agg.secure_fedavg((42, 777, 1), _torch_tree(tree), w)
    ref = jagg.secure_fedavg(jax.random.PRNGKey(42), jax.tree.map(jnp.asarray, tree), w)
    for a, b in zip(_leaves(jax.tree.map(lambda t: t.numpy(), got)), _leaves(ref)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    # the wrapped leaf really wrapped: its int64 reveal differs from the
    # exact integer sum of the encodings
    enc = np.round(big.astype(np.float32).astype(np.float64) * w[:, None] * 2 ** 16)
    exact = sum(int(v) for v in enc[:, 0])
    ring = fixed.encode(torch.from_numpy(big.astype(np.float32)).double()
                        * torch.from_numpy(w)[:, None])
    shared = S.share(S.stream("cpu", 1, 2), ring)
    revealed = S.reconstruct(agg.AShareSumNodes(shared))
    assert int(revealed[0]) == (exact + 2 ** 63) % 2 ** 64 - 2 ** 63 != exact


def test_share_space_sum_reveals_the_jax_ring_sum():
    """Encode, share, node-sum and reveal: the int64 reveal equals JAX's,
    bit for bit, for shares drawn from unrelated streams (the shares
    themselves wrap mod 2^64: they are uniform over the ring)."""
    x = np.random.default_rng(3).normal(0, 4, (3, 6, 5))
    ring = fixed.encode(torch.from_numpy(x))
    shared = S.share(S.stream("cpu", 9), ring)
    assert bool((shared.data < 0).any()) and bool((shared.data > 0).any())
    got = S.reconstruct(agg.AShareSumNodes(shared)).numpy()
    jsh = JS.share(jax.random.PRNGKey(9), jfixed.encode(jnp.asarray(x)))
    ref = np.asarray(JS.reconstruct(jagg.AShareSumNodes(jsh)))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, ring.numpy().sum(0))


def test_count_leaves_pass_through_from_node_0_and_leaf_keys_match_jax():
    """``count`` leaves: node 0's value and dtype, never encoded, in both
    aggregations; ``_leaf_key`` is the JAX package's CRC-32 of the same
    key path."""
    tree = _stacked(np.random.default_rng(4))
    for out in (agg.secure_fedavg((1, 2), _torch_tree(tree), WEIGHTS["equal"]),
                agg.plain_fedavg(_torch_tree(tree), WEIGHTS["equal"])):
        count = out["state"]["layer"][0]["bn"]["count"]
        assert count.dtype == torch.int64 and int(count) == 7
    jax_keys = []
    jax.tree_util.tree_map_with_path(
        lambda p, _: jax_keys.append((jagg._leaf_key(p), jagg._is_count_leaf(p))), tree)
    ours = []
    agg.map_with_path(lambda p, _: ours.append((agg._leaf_key(p), agg._is_count_leaf(p))),
                      tree)
    assert sorted(ours) == sorted(jax_keys) and sum(c for _, c in ours) == 1


def test_secure_average_stats_is_bit_equal_to_jax():
    rng = np.random.default_rng(5)
    vals = [rng.uniform(0, 1, 3) for _ in range(3)]
    got = agg.secure_average_stats((7, 1), vals).numpy()
    ref = np.asarray(jagg.secure_average_stats(jax.random.PRNGKey(7), vals))
    assert got.dtype == ref.dtype == np.float32 and got.tobytes() == ref.tobytes()


def test_shares_are_deterministic_across_processes_and_fresh_per_round():
    """The same (seed, 777, round, leaf key) draws the same shares in a
    fresh interpreter whatever its hash salt; the next round draws others
    (the port's copy of ``tests/test_federated.py``'s process test)."""
    prog = textwrap.dedent("""
        import zlib, torch
        from primia_tpu_torch.mpc import fixed, shares as S
        from primia_tpu_torch.mpc.aggregation import _leaf_key
        ring = fixed.encode(torch.linspace(-1, 1, 8, dtype=torch.float64))
        key = _leaf_key(("params", "layer1", 0, "conv1", "w"))
        out = [key]
        for rnd in (1, 2):
            sh = S.share(S.stream("cpu", 42, 777, rnd, key), ring)
            out.append(zlib.crc32(sh.data.numpy().tobytes()))
        print(out)
    """)
    outs = []
    for salt in ("0", "1"):
        env = dict(os.environ, PYTHONHASHSEED=salt)
        r = subprocess.run([sys.executable, "-c", prog], env=env, capture_output=True,
                           text=True, timeout=300, cwd=ROOT)
        assert r.returncode == 0, r.stderr
        outs.append(r.stdout.strip().splitlines()[-1])
    assert outs[0] == outs[1]
    _, round1, round2 = eval(outs[0])
    assert round1 != round2


# ---------------------------------------------------------- the node loop

def _resnet(seed=0):
    torch.manual_seed(seed)
    return ResNet((1, 1, 1, 1), num_classes=3, in_channels=3, input_size=32)


def test_jax_leaf_paths_follow_the_jax_tree():
    """Every leaf of ``to_jax_tree``'s trees, in ``jax.tree.leaves`` order,
    keyed as JAX keys it and named as the module's state dict."""
    model = _resnet()
    params, state = to_jax_tree(model)
    flat = tree_flatten_with_path({"params": params, "state": state})[0]
    ours = jax_leaf_paths(model)
    assert [keystr(p) for p, _ in flat] == [agg._keystr(p) for p, _ in ours]
    sd = model.state_dict()
    for (_, leaf), (_, name) in zip(flat, ours):
        assert sd[name].numel() == np.asarray(leaf).size
    assert {n for _, n in ours} == set(sd)


@pytest.mark.parametrize("secure", [True, False])
def test_nodes_aggregate_in_place_as_the_tree_functions(secure):
    """``FederatedNodes.aggregate`` leaf by leaf on the nodes' modules
    equals the tree function on the node-stacked JAX trees, bit for bit,
    and leaves every node holding it."""
    args = Arguments.from_ini(FEDERATED_INI)
    args.precision_fractional = 16
    nodes = federated.FederatedNodes(args, _resnet(), 3, np.zeros(3), np.ones(3), device="cpu")
    for i, m in enumerate(nodes.models):
        with torch.no_grad():
            for t in m.state_dict().values():
                if t.is_floating_point():
                    t.add_(torch.randn(t.shape, generator=torch.Generator().manual_seed(i)))
                else:
                    t.add_(i)
    trees = [dict(zip(("params", "state"), to_jax_tree(m))) for m in nodes.models]
    stacked = jax.tree.map(lambda *xs: torch.from_numpy(np.stack(xs)), *trees)
    w = WEIGHTS["weighted"]
    ref = (agg.secure_fedavg((5, 777, 1), stacked, w) if secure
           else agg.plain_fedavg(stacked, w))
    nodes.aggregate(w, (5, 777, 1) if secure else None)
    for m in nodes.models:
        got = dict(zip(("params", "state"), to_jax_tree(m)))
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
            assert np.asarray(a).tobytes() == b.numpy().tobytes()


def test_optimizer_reset_is_a_new_optimizer():
    for make in (lambda m: Adam(m, 0.5, 0.99, weight_decay=5e-4),
                 lambda m: SGD(m, momentum=0.9)):
        model = _resnet()
        opt = make(model)
        opt.update([torch.ones_like(p) for p in opt.params], 1e-3)
        opt.reset()
        fresh = make(_resnet()).state_to_jax()
        for a, b in zip(opt.state_to_jax(), fresh):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------ topology and data tools

def test_read_worker_config_matches_jax(tmp_path):
    csv = ROOT / "configs" / "websetting" / "config.csv"
    assert read_worker_config(csv) == jax_read_worker_config(csv)
    bad = tmp_path / "bad.csv"
    bad.write_text("id,alice\nhost,127.0.0.1\n")
    for fn in (read_worker_config, jax_read_worker_config):
        with pytest.raises(ValueError, match="id/host/port"):
            fn(bad)


@pytest.mark.parametrize("where", ["repo_csv", "worker_folders", "no_crypto_provider"])
def test_discover_workers_matches_jax(where, fed_dir, tmp_path, monkeypatch):
    """From the repository root (``configs/websetting/config.csv``: alice,
    bob, charlie), from a directory without it (``worker*`` folders), and
    with a CSV that names no crypto provider (raises unless unencrypted)."""
    if where == "repo_csv":
        monkeypatch.chdir(ROOT)
    else:
        monkeypatch.chdir(tmp_path)
    if where == "no_crypto_provider":
        (tmp_path / "configs" / "websetting").mkdir(parents=True)
        (tmp_path / "configs" / "websetting" / "config.csv").write_text(
            "id,alice,bob\nhost,h,h\nport,1,2\n")
    for unencrypted in (False, True):
        a = Arguments(data_dir=str(fed_dir), unencrypted_aggregation=unencrypted)
        ja = JaxArguments(data_dir=str(fed_dir), unencrypted_aggregation=unencrypted)
        if where == "no_crypto_provider" and not unencrypted:
            for fn, x in ((federated.discover_workers, a), (jax_discover_workers, ja)):
                with pytest.raises(AssertionError, match="crypto provider"):
                    fn(x)
            continue
        got = federated.discover_workers(a)
        assert got == jax_discover_workers(ja)
        want = {"repo_csv": ["alice", "bob", "charlie"], "no_crypto_provider": ["alice", "bob"],
                "worker_folders": ["worker1", "worker2", "worker3"]}[where]
        assert got == want


def _files(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def test_distribute_and_trim_lay_out_the_same_files(tmp_path):
    src = tmp_path / "train"
    for ci, cls in enumerate(CLASSES):
        (src / cls).mkdir(parents=True)
        for i in range(5 + 3 * ci):
            (src / cls / f"img_{ci}_{i}.jpeg").write_bytes(bytes([ci, i]))
        (src / cls / "._hidden.jpeg").write_bytes(b"x")
    outs = {}
    for name, mod in (("port", distribute), ("jax", jax_distribute)):
        dest = tmp_path / name
        counts = mod.distribute(src, dest, num_workers=3)
        outs[name] = (counts, _files(dest), mod.format_distribution(mod.class_distribution(dest)))
        outs[name] += (mod.trim(dest, 2, spare_validation=True), _files(dest))
    assert outs["port"] == outs["jax"]
    assert outs["port"][0] == {"validation": 2, "worker1": 8, "worker2": 7, "worker3": 7}


def test_distribute_cli_stats_and_trim(tmp_path, capsys):
    src = tmp_path / "train"
    for cls in CLASSES:
        (src / cls).mkdir(parents=True)
        for i in range(4):
            (src / cls / f"{i}.png").write_bytes(b"p")
    dest = tmp_path / "sim"
    assert distribute.main(["distribute", "--train_data_src", str(src), "--dest", str(dest)]) == 0
    assert distribute.main(["stats", "--root", str(dest)]) == 0
    assert distribute.main(["trim", "--root", str(dest), "-n", "1", "--yes"]) == 0
    out = capsys.readouterr().out
    assert "worker3" in out and "deleted" in out
    assert all(len(list(d.iterdir())) <= 1 for d in dest.glob("*/*"))


# --------------------------------------------------------------- training

def _ini(tmp_path, replacements, name="fed.ini"):
    text = FEDERATED_INI.read_text()
    for old, new in replacements:
        assert old in text, old
        text = text.replace(old, new)
    ini = tmp_path / name
    ini.write_text(text)
    return ini


TINY = [("batch_size = 200", "batch_size = 4"), ("train_resolution = 224", "train_resolution = 32"),
        ("epochs = 40", "epochs = 2"), ("repetitions_dataset = 5", "repetitions_dataset = 2"),
        ("sync_every_n_batch = 3", "sync_every_n_batch = 2")]


def test_federated_cli_defaults_to_cuda_and_raises_without_a_card(tmp_path, fed_dir,
                                                                  monkeypatch):
    from primia_tpu_torch.cli import train

    assert train.build_parser().parse_args(["--config", "x", "--train_federated"]).device == "cuda"
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--config", str(_ini(tmp_path, TINY)), "--data_dir", str(fed_dir),
                    "--train_federated"])


def test_setup_federated_defaults_to_cuda(tmp_path, fed_dir, monkeypatch):
    """``setup_federated`` runs on the card unless told otherwise, like every
    entry point of the port: without one it raises; ``device="cpu"`` loads
    the shards."""
    import inspect

    assert inspect.signature(federated.setup_federated).parameters["device"].default == "cuda"
    monkeypatch.chdir(tmp_path)
    args = Arguments.from_ini(_ini(tmp_path, TINY), cmd_args=argparse.Namespace(
        data_dir=str(fed_dir), train_federated=True))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        federated.setup_federated(args, verbose=False)
    names, node_imgs = federated.setup_federated(args, verbose=False, device="cpu")[:2]
    assert names == ["worker1", "worker2", "worker3"]
    assert [len(x) for x in node_imgs] == [12, 9, 6]


def test_cli_sets_mixup_lambda_off_one_half_when_federated(tmp_path, monkeypatch):
    """The JAX CLI's guard: federated + mixup + ``mixup_lambda = 0.5`` warns
    and trains with 0.499; without ``--train_federated`` 0.5 stays."""
    from primia_tpu_torch.cli import train
    from primia_tpu_torch.train import loop

    ini = _ini(tmp_path, TINY + [("mixup_prob = 0.9", "mixup_prob = 0.9\nmixup_lambda = 0.5")])
    seen = []
    monkeypatch.setattr(loop, "main", lambda args, device: seen.append(args.mixup_lambda))
    with pytest.warns(RuntimeWarning, match="0.499"):
        train.main(["--config", str(ini), "--data_dir", "d", "--train_federated"])
    train.main(["--config", str(ini), "--data_dir", "d"])
    assert seen == [0.499, 0.5]


def test_node_loop_masks_spent_shards_and_aggregates_on_schedule(tmp_path, fed_dir,
                                                                 monkeypatch):
    """4/3/2 images a class at batch 4: 3, 3 and 2 batches a pass, 2 passes
    (``repetitions_dataset``), so 6, 6 and 4 node steps; the third node
    sits out the last two federated steps. Aggregation at batch 2 and 4 of
    6 (``sync_every_n_batch = 2``) and at the epoch's end, each with its
    own round key, and the optimizers reset after each."""
    monkeypatch.chdir(tmp_path)
    steps, keys = [], []
    step, aggregate = federated.FederatedNodes.step, federated.FederatedNodes.aggregate

    def spy_step(self, batches, lr):
        steps.append([b is not None for b in batches])
        return step(self, batches, lr)

    def spy_aggregate(self, weights, key=None):
        keys.append((len(steps), key, tuple(np.round(weights, 6))))
        return aggregate(self, weights, key)

    monkeypatch.setattr(federated.FederatedNodes, "step", spy_step)
    monkeypatch.setattr(federated.FederatedNodes, "aggregate", spy_aggregate)
    args = Arguments.from_ini(_ini(tmp_path, TINY), cmd_args=argparse.Namespace(
        data_dir=str(fed_dir), train_federated=True))
    assert args.epochs == 1 and args.repetitions_dataset == 2
    federated.main_federated(args, verbose=False, device="cpu", weights_dir=str(tmp_path / "w"))
    assert steps == [[True, True, True]] * 4 + [[True, True, False]] * 2
    w = tuple(np.round(np.array([6, 6, 4]) / 16, 6))
    assert keys == [(3, (42, 777, 1), w), (5, (42, 777, 2), w), (6, (42, 777, 3), w)]


def test_federated_run_matches_jax_from_a_shared_checkpoint(tmp_path, monkeypatch, capsys):
    """One federated run from a shared checkpoint through both packages'
    train CLIs: SGD, augmentation, mixup and CLAHE off, float32, weighted
    secure aggregation every 2 batches, on 4/3/2 images a class.

    At 32 px ResNet-18's last maps are 1x1, and the JAX package's batch
    norm takes the batch variance as E[x^2] - E[x]^2 in float32
    (``primia_tpu/nn/core.py``) where the port's is centred: on a few
    values a channel the two part by far more than rounding, and the runs
    diverge. So the images are 64 px, the batch 3 (every shard a whole
    number of batches) and the images full-range noise rather than flat
    fields. Limits: every parameter within 8 fixed-point steps (8 x 2^-16;
    each of the two aggregations rounds to the 2^-16 grid, so a last-bit
    difference before it can move a value one step), while the run moves
    some parameter further than that; the batch-norm running statistics
    within 2% of each leaf's largest value (the variance formulas above).
    The port's ``final_federated_*.pt`` loads in the JAX package and both
    evaluate CLIs print the same stats table for it."""
    from primia_tpu.cli.evaluate import main as jax_evaluate
    from primia_tpu.cli.train import main as jax_train
    from primia_tpu_torch.cli.evaluate import main as port_evaluate
    from primia_tpu_torch.cli.train import main as port_train
    from primia_tpu_torch.nn import create_model

    data = _shards(tmp_path / "data", lambda rng, ci: (
        rng.integers(0, 256, (32, 32)) // 2 + 40 * ci).astype(np.uint8))
    ini = _ini(tmp_path, [
        ("batch_size = 200", "batch_size = 3"), ("train_resolution = 224", "train_resolution = 64"),
        ("epochs = 40", "epochs = 1"), ("repetitions_dataset = 5", "repetitions_dataset = 1"),
        ("sync_every_n_batch = 3", "sync_every_n_batch = 2"), ("optimizer = Adam", "optimizer = SGD"),
        ("rotation = 30", "rotation = 0"), ("scale = 0.15", "scale = 0"), ("shear = 10", "shear = 0"),
        ("mixup = yes", "mixup = no"), ("clahe = yes", "clahe = no"),
        ("overall_prob = 0.75", "overall_prob = 0"), ("noise_prob = 0.5", "noise_prob = 0")])
    args = Arguments.from_ini(ini)
    torch.manual_seed(5)
    shared = tmp_path / "shared.pt"
    ckpt.save_model(shared, epoch=0, model=create_model(args, num_classes=3, device="cpu"),
                    args=args, val_mean_std=(np.zeros(3), np.ones(3)))
    argv = ["--config", str(ini), "--data_dir", str(data), "--train_federated",
            "--resume_checkpoint", str(shared)]
    finals = {}
    for name, train, extra in (("jax", jax_train, []), ("port", port_train, ["--device", "cpu"])):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        with pytest.warns(UserWarning, match="pretrained"):
            train(argv + extra)
        found = sorted((tmp_path / name / "model_weights").glob("final_federated_*.pt"))
        assert len(found) == 1
        finals[name] = found[0]
    capsys.readouterr()

    got, ref = (jax_ckpt.load_model(finals[k]) for k in ("port", "jax"))
    start = jax_ckpt.load_model(shared)["model_state_dict"]
    assert got["epoch"] == ref["epoch"] == 1 and got["args"].train_federated
    assert sorted(got["optim_state_dict"]) == ["worker1", "worker2", "worker3"]
    for k in ("worker1", "worker2", "worker3"):
        assert type(got["optim_state_dict"][k]).__name__ == "SGDState"
        assert int(got["optim_state_dict"][k].step) == 0  # reset after aggregating
    for a, b in zip(got["val_mean_std"], ref["val_mean_std"]):
        assert a.tobytes() == b.tobytes()
    moved = 0.0
    for a, b, s in zip(*(jax.tree.leaves(t["params"]) for t in (got["model_state_dict"],
                                                              ref["model_state_dict"], start))):
        a, b, s = (np.asarray(v, np.float64) for v in (a, b, s))
        np.testing.assert_allclose(a, b, rtol=0, atol=8 * STEP)
        moved = max(moved, float(np.abs(b - s).max()))
    assert moved > 16 * STEP
    for a, b in zip(*(jax.tree.leaves(t["model_state_dict"]["state"]) for t in (got, ref))):
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                   rtol=0, atol=0.02 * float(np.abs(b).max()))

    argv = ["--data_dir", str(data / "validation"), "--model_weights", str(finals["port"])]
    with pytest.warns(UserWarning, match="pretrained"):
        jax_stats = jax_evaluate(argv)
    jax_table = capsys.readouterr().out
    port_stats = port_evaluate(argv + ["--device", "cpu"])
    port_table = capsys.readouterr().out
    np.testing.assert_array_equal(port_stats["conf_matrix"], jax_stats["conf_matrix"])
    assert port_stats["matthews_coeff"] == jax_stats["matthews_coeff"]
    table = [line for line in port_table.splitlines() if "│" in line]
    assert table and table == [line for line in jax_table.splitlines() if "│" in line]


def test_unencrypted_cli_end_to_end_and_resume_with_kept_optimizers(tmp_path, fed_dir,
                                                                    monkeypatch, capsys):
    """The canonical federated recipe (augmentation, mixup, CLAHE, Adam) at
    32 px through the port's CLI with ``--unencrypted_aggregation``: one
    ``final_federated_*.pt`` with a per-worker optimizer dict, which the
    JAX package loads. Under ``keep_optim_dict = yes`` a second run
    resumes it with every worker's Adam state, and its steps count on."""
    from primia_tpu_torch.cli.train import main as port_train

    monkeypatch.chdir(tmp_path)
    ini = _ini(tmp_path, TINY + [("keep_optim_dict = no", "keep_optim_dict = yes")])
    base = ["--data_dir", str(fed_dir), "--train_federated", "--unencrypted_aggregation",
            "--device", "cpu"]
    assert np.isfinite(port_train(["--config", str(ini)] + base))
    out = capsys.readouterr().out
    assert "Train Epoch: 1" in out and "matthews coeff" in out
    first = sorted((tmp_path / "model_weights").glob("final_federated_*.pt"))
    assert len(first) == 1 and not list((tmp_path / "model_weights").glob("*_epoch_*.pt"))
    state = jax_ckpt.load_model(first[0])
    assert state["epoch"] == 1 and state["args"].unencrypted_aggregation
    osd = state["optim_state_dict"]
    assert sorted(osd) == ["worker1", "worker2", "worker3"]
    assert [int(osd[w].step) for w in sorted(osd)] == [6, 6, 4]
    first[0].rename(tmp_path / "first.pt")

    ini.write_text(ini.read_text().replace("epochs = 2", "epochs = 4"))
    port_train(["--config", str(ini), "--resume_checkpoint", str(tmp_path / "first.pt")] + base)
    assert "Restored per-worker optimizer state" in capsys.readouterr().out
    second = jax_ckpt.load_model(sorted((tmp_path / "model_weights").glob("final_*.pt"))[0])
    assert second["epoch"] == 2
    assert [int(second["optim_state_dict"][w].step) for w in sorted(osd)] == [12, 12, 8]
