"""The port's grid (``primia_tpu_torch/serve``) against the JAX package's.

Port nodes serve on the CPU (``device="cpu"``) on free localhost ports and
are stopped at the end; every client has a timeout of 60 s or less. The
interop checks put a JAX client in front of a port node: the frames are
the same bytes, the answers those of a JAX node on the same data, the
shares bit-equal given the same node secret, and remote logits within
``test_torch_resnet.py``'s 1e-4. A node's ``train_round`` is the port's
own train step, bit for bit; federated training over live port nodes runs
through the port's train CLI and through the JAX package's
``main_federated_ws``; the inference CLI classifies a data owner's hosted
images as it classifies the same files locally.
"""

import json
import shutil
import socket
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from primia_tpu.config import Arguments as JaxArguments
from primia_tpu.data import BatchLoader as JaxBatchLoader
from primia_tpu.nn import create_model as jax_create_model
from primia_tpu.serve import auth as jauth
from primia_tpu.serve import client as jclient
from primia_tpu.serve import node as jnode
from primia_tpu.serve import protocol as jprotocol
from primia_tpu.serve.plan import Plan as JaxPlan
from primia_tpu.train import checkpoint as jax_ckpt
from primia_tpu_torch.config import Arguments
from primia_tpu_torch.data import BatchLoader
from primia_tpu_torch.nn import create_model
from primia_tpu_torch.nn.jax_params import from_jax_tree, to_jax_tree
from primia_tpu_torch.sandbox import _LocalClient
from primia_tpu_torch.serve import auth, client, node, protocol
from primia_tpu_torch.serve.node import GridNode, NodeServer
from primia_tpu_torch.train import checkpoint as ckpt
from primia_tpu_torch.train.dp import select_train_step
from primia_tpu_torch.train.optim import make_optimizer

ROOT = Path(__file__).resolve().parent.parent
FEDERATED_INI = ROOT / "configs" / "torch" / "pneumonia-resnet-pretrained-federated.ini"
TIMEOUT = 60.0
ATOL = RTOL = 1e-4  # test_torch_resnet.py's limit
ENC_TOL = 0.02  # tests/test_mpc.py's encrypted-inference tolerance


@pytest.fixture(autouse=True)
def _one_intra_op_thread(monkeypatch):
    """One intra-op thread (``test_torch_mpc.py``'s fixture), no
    materialize cache."""
    monkeypatch.setenv("PRIMIA_MATERIALIZE_CACHE", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _serve(n):
    """A NodeServer over ``n`` on a free port (ws) whose port + 1000 (HTTP)
    is free too."""
    while True:
        port = _free_port()
        try:
            return NodeServer(n, port=port).start(), port
        except OSError:
            continue


def _jax_tree(model_name, res, seed=0):
    args = JaxArguments(model=model_name, train_resolution=res, inference_resolution=res,
                        batch_size=4, optimizer="SGD", momentum=0.0, lr=0.01)
    params, state = jax_create_model(args, num_classes=3).init(jax.random.PRNGKey(seed))
    return args, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)


@pytest.fixture(scope="module")
def grid(fixture_dir):
    """A port node hosting the fixture's training images at 28 px, served
    on ws and HTTP, and a JAX node on the same images (in process)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PRIMIA_MATERIALIZE_CACHE", "0")
        port_node = GridNode("worker1", data_directory=str(fixture_dir / "train"),
                             inference_resolution=28, channels=1, device="cpu")
        jax_node = jnode.GridNode("worker1", data_directory=str(fixture_dir / "train"),
                                  inference_resolution=28, channels=1)
    server, port = _serve(port_node)
    try:
        yield port_node, jax_node, port
    finally:
        server.stop()


def _jax_client(port, transport):
    return jclient.NodeClient("worker1", "127.0.0.1", port, http_only=transport == "http",
                              timeout=TIMEOUT)


# ------------------------------------------------------------------ wire

def test_frames_are_byte_identical_and_each_package_reads_the_other():
    rng = np.random.default_rng(0)
    for n in (3, 3000):  # a plain frame and a zlib one
        msg = {"type": "train_round", "n": 7, "neg": -300, "lr": 1e-4, "ok": True,
               "none": None, "blob": bytes(range(256)) * 2,
               "i64": rng.integers(-(1 << 62), 1 << 62, (n, 2), dtype=np.int64),
               "u8": rng.integers(0, 256, (n, 3, 1), dtype=np.uint8),
               "f32": rng.normal(size=(2, n)).astype(np.float32),
               "nested": [1, [2.5, "s", {"a": np.arange(4, dtype=np.float32)}], (3, 4)],
               "params": {"['layer1'][0]['conv1']['w']": np.ones((3, 3, 2, 2), np.float32)}}
        frame = protocol.pack(msg)
        assert frame == jprotocol.pack(msg)
        assert frame[:1] == (b"Z" if n > 100 else b"N")
        for back in (protocol.unpack(frame), jprotocol.unpack(frame)):
            for k in ("i64", "u8", "f32"):
                assert back[k].dtype == msg[k].dtype
                np.testing.assert_array_equal(back[k], msg[k])
            assert back["blob"] == msg["blob"] and back["neg"] == -300
            np.testing.assert_array_equal(back["nested"][1][2]["a"], np.arange(4))


@pytest.mark.parametrize("model_name,res", [("resnet-18", 32), ("simpleconv", 224)])
def test_flatten_gives_the_jax_keys_in_the_jax_order(model_name, res):
    args, params, state = _jax_tree(model_name, res)
    model = create_model(Arguments.from_dict(args.to_dict()), num_classes=3, device="cpu")
    model.load_state_dict(from_jax_tree(params, state))
    for got, ref in zip((node._flatten(t) for t in to_jax_tree(model)),
                        (jnode._flatten(t) for t in (params, state))):
        assert list(got) == list(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype and got[k].tobytes() == ref[k].tobytes()
        back = node._flatten(node._unflatten(got))
        assert list(back) == list(ref)
    if model_name == "simpleconv":
        assert {"['bns']['0']['gamma']", "['bns']['1']['gamma']",
                "['bns']['3']['gamma']"} <= set(node._flatten(params))
    else:
        assert "['layer1'][0]['conv1']['w']" in node._flatten(params)


# ------------------------------------------------- a JAX client, a port node

@pytest.mark.parametrize("transport", ["ws", "http"])
def test_status_search_and_get_obj_answer_as_a_jax_node(grid, transport):
    port_node, jax_node, port = grid
    c = _jax_client(port, transport)
    try:
        assert c.status() == jax_node.handle({"type": "status"})
        g = jclient.GridNetwork([c])
        assert g.search("#traindata") == {"worker1": ["#traindata"]}
        assert g.search("#nope") == {}
        for tag in ("#traindata", "#traintargets", "#datamean", "#datastd"):
            got, ref = c.get_obj(tag), jax_node.store[tag]
            assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()
        assert "error" in c.send({"type": "get_obj", "tag": "#nope"})
        assert "unknown message type" in c.send({"type": "bogus"})["error"]
    finally:
        c.close()


def test_data_shares_reconstruct_and_equal_a_jax_node_s(grid):
    port_node, jax_node, port = grid
    jax_node._share_secret = port_node._share_secret
    c = _jax_client(port, "ws")
    try:
        out = c.send({"type": "get_data_shares", "tag": "#traindata", "party": -1, "seed": 3})
        ref = jax_node.handle({"type": "get_data_shares", "tag": "#traindata", "party": -1,
                               "seed": 3})
        assert out["shares"].dtype == np.int64 and out["shares"].tobytes() == ref["shares"].tobytes()
        s0, s1 = out["shares"]
        m = port_node.store["#datamean"].reshape(1, 1, 1, -1)
        s = port_node.store["#datastd"].reshape(1, 1, 1, -1)
        x = (port_node.store["#traindata"].astype(np.float32) / 255.0 - m) / s
        enc = np.round(np.asarray(x, np.float32).astype(np.float64) * (1 << 16)).astype(np.int64)
        np.testing.assert_array_equal((s0.view(np.uint64) + s1.view(np.uint64)).view(np.int64),
                                      enc)
        one = c.send({"type": "get_data_shares", "tag": "#traindata", "party": 1, "seed": 3})
        np.testing.assert_array_equal(one["share"], s1)
    finally:
        c.close()


@pytest.mark.parametrize("transport", ["ws", "http"])
def test_remote_plain_inference_matches_a_jax_node(grid, transport):
    """host_model + run_inference from one JAX init of ResNet-18 at 32 px,
    sent by the JAX client: the port node's logits within 1e-4 of a JAX
    node's, with the JAX node's predictions."""
    port_node, jax_node, port = grid
    args, params, state = _jax_tree("resnet-18", 32, seed=1)
    c = _jax_client(port, transport)
    jax_grid = jclient.GridNetwork([c])
    local = jclient.GridNetwork([_LocalClient(jax_node)])
    imgs = np.random.default_rng(2).integers(0, 256, (3, 32, 32, 1), dtype=np.uint8)
    kw = dict(name="pneu", params=params, model_state=state, args_json=args.to_json(),
              mean=np.array([0.45]), std=np.array([0.22]))
    try:
        assert jax_grid.serve_model("worker1", **kw)["ok"]
        local.serve_model("worker1", **kw)
        assert c.send({"type": "list_models"})["models"] == ["pneu"]
        got = jax_grid.run_remote_inference("worker1", name="pneu", images=imgs)
        ref = local.run_remote_inference("worker1", name="pneu", images=imgs)
        assert got["logits"].shape == (3, 3) and got["logits"].dtype == np.float32
        np.testing.assert_allclose(got["logits"], ref["logits"], atol=ATOL, rtol=RTOL)
        np.testing.assert_array_equal(got["predictions"], ref["predictions"])
        assert got["predictions"].dtype == np.int32 and got["replica"] == 0
        c.send({"type": "delete_model", "name": "pneu"})
        assert c.send({"type": "list_models"})["models"] == []
    finally:
        c.close()


def test_remote_encrypted_inference_equals_the_local_encrypted_predict(grid):
    """SimpleConv at 28 px with an N(0, 0.1) head, served from the port's
    module, with statistics that spread its logits over several times the
    limit: the node's encrypted logits (snn, the node's default protocol;
    seed 0) are the port's local encrypted predict's first call, bit for
    bit, and within the encrypted limit of the plain logits."""
    from primia_tpu_torch.mpc.inference import build_encrypted_predict
    from primia_tpu_torch.train.steps import build_predict_step

    port_node, _, port = grid
    args = Arguments(model="simpleconv", train_resolution=28, inference_resolution=28)
    torch.manual_seed(3)
    model = create_model(args, num_classes=3, device="cpu")
    head = model.classifier[-1]
    with torch.no_grad():
        head.weight.copy_(torch.from_numpy(np.random.default_rng(4).normal(
            0, 0.1, tuple(head.weight.shape)).astype(np.float32)))
    mean, std = np.array([0.1]), np.array([0.05])
    imgs = np.random.default_rng(5).integers(0, 256, (2, 28, 28, 1), dtype=np.uint8)
    g = client.GridNetwork([client.NodeClient("worker1", "127.0.0.1", port, timeout=TIMEOUT)])
    try:
        assert g.serve_model("worker1", name="enc", params=model, args_json=args.to_json(),
                             mean=mean, std=std)["ok"]
        enc = g.run_remote_inference("worker1", name="enc", images=imgs, encrypted=True)
        plain = g.run_remote_inference("worker1", name="enc", images=imgs)
    finally:
        g.clients[0].close()
    local = build_encrypted_predict(model, args, mean, std, "cpu", protocol="snn")(imgs)
    np.testing.assert_array_equal(enc["logits"], local.numpy())
    ref = build_predict_step(model, args, mean, std, "cpu")(imgs).numpy()
    np.testing.assert_array_equal(plain["logits"], ref)
    np.testing.assert_allclose(enc["logits"], ref, atol=ENC_TOL, rtol=0)
    assert np.ptp(ref, axis=1).min() > 10 * ENC_TOL  # the head makes the check mean something


def test_train_round_is_the_port_s_own_step_in_the_jax_node_s_batch_order(grid):
    """A JAX client sends one round (2 passes over the 3-batch shard); the
    reply equals the port's train step run locally from the same trees, on
    the same batches and generator, bit for bit; the port's loader draws
    the JAX loader's batches."""
    port_node, jax_node, port = grid
    args, params, state = _jax_tree("simpleconv", 28)
    seed, n_steps = 11, 5
    c = _jax_client(port, "ws")
    try:
        out = c.send({"type": "train_round", "args": args.to_json(),
                      "params": jnode._flatten(params), "model_state": jnode._flatten(state),
                      "n_steps": n_steps, "lr": 0.01, "seed": seed, "num_classes": 3})
    finally:
        c.close()
    assert "error" not in out, out.get("error")
    assert out["n_batches"] == 3

    pargs = Arguments.from_dict(json.loads(args.to_json()))
    model = create_model(pargs, num_classes=3, device="cpu")
    model.load_state_dict(from_jax_tree(params, state))
    opt = make_optimizer(pargs, model)
    step = select_train_step(model, opt, pargs, port_node.store["#datamean"],
                             port_node.store["#datastd"], None, "cpu")
    imgs, labels = port_node.store["#traindata"], port_node.store["#traintargets"]
    loader = BatchLoader(imgs, labels, 4, shuffle=True, seed=seed, pad_final=True)
    jloader = JaxBatchLoader(jax_node.store["#traindata"], jax_node.store["#traintargets"], 4,
                             shuffle=True, seed=seed, pad_final=True)
    batches = [b for _ in range(2) for b in loader][:n_steps]
    jbatches = [b for _ in range(2) for b in jloader][:n_steps]
    for b, jb in zip(batches, jbatches):
        np.testing.assert_array_equal(b.images, np.asarray(jb.images))
        np.testing.assert_array_equal(b.labels, np.asarray(jb.labels))
    gen = torch.Generator().manual_seed(seed)
    losses = [float(step(gen, b.images, b.labels, b.mask, 0.01)) for b in batches]
    assert out["loss"] == float(np.mean(losses))
    for got, ref in ((out["params"], node._flatten(to_jax_tree(model)[0])),
                     (out["model_state"], node._flatten(to_jax_tree(model)[1]))):
        assert list(got) == list(ref)
        for k in ref:
            assert got[k].tobytes() == ref[k].tobytes(), k
    assert any(not np.array_equal(out["params"][k], v)
               for k, v in jnode._flatten(params).items())


# -------------------------------------------------- federated over the wire

# each node's shard: (split, image indices a class); 12, 6 and 3 images,
# so 3, 2 and 1 batches of 4 and unequal aggregation weights
SHARDS = {"alice": ("train", (0, 1, 2, 3)), "bob": ("test", (0, 1)), "charlie": ("test", (3,))}


@pytest.fixture(scope="module")
def fleet(fixture_dir, tmp_path_factory):
    """Three port nodes at 28 px on distinct shards of unequal size
    (``SHARDS``) and a crypto provider, served; the worker CSV at
    ``<dir>/configs/websetting/config.csv`` and a data directory whose
    ``validation`` is the fixture's test split."""
    root = tmp_path_factory.mktemp("fleet")
    for w, (split, idx) in SHARDS.items():
        for cls in (fixture_dir / split).iterdir():
            (root / "shards" / w / cls.name).mkdir(parents=True)
            for i in idx:
                shutil.copy(cls / f"img_{i}.jpeg", root / "shards" / w / cls.name)
    servers, rows = [], {"id": [], "host": [], "port": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PRIMIA_MATERIALIZE_CACHE", "0")
        try:
            for w in ("alice", "bob", "charlie", "crypto_provider"):
                n = GridNode(w, data_directory=(None if w == "crypto_provider"
                                                else str(root / "shards" / w)),
                             inference_resolution=28, channels=1, device="cpu")
                server, port = _serve(n)
                servers.append(server)
                rows["id"].append(w)
                rows["host"].append("127.0.0.1")
                rows["port"].append(str(port))
            csv = root / "configs" / "websetting" / "config.csv"
            csv.parent.mkdir(parents=True)
            csv.write_text("\n".join(",".join([k] + rows[k]) for k in ("id", "host", "port"))
                           + "\n")
            shutil.copytree(fixture_dir / "test", root / "data" / "validation")
            yield root
        finally:
            for s in servers:
                s.stop()


def test_train_cli_websockets_trains_on_live_nodes_and_evaluates_as_jax(fleet, fixture_dir,
                                                                          monkeypatch, capsys):
    """``--train_federated --websockets`` through the port's train CLI: the
    nodes of the working directory's CSV, SimpleConv at 28 px, one round of
    3 steps a node, weighted secure aggregation. The final checkpoint loads in the
    JAX package, and both evaluate CLIs print the same stats table."""
    from primia_tpu.cli.evaluate import main as jax_evaluate
    from primia_tpu_torch.cli.evaluate import main as port_evaluate
    from primia_tpu_torch.cli.train import main as port_train

    text = FEDERATED_INI.read_text()
    for old, new in (("batch_size = 200", "batch_size = 4"), ("model = resnet-18",
                                                               "model = simpleconv"),
                     ("train_resolution = 224", "train_resolution = 28"),
                     ("pretrained = yes", "pretrained = no"), ("epochs = 40", "epochs = 1"),
                     ("repetitions_dataset = 5", "repetitions_dataset = 1"),

                     ("mixup = yes", "mixup = no"), ("clahe = yes", "clahe = no"),
                     ("rotation = 30", "rotation = 0"), ("scale = 0.15", "scale = 0"),
                     ("shear = 10", "shear = 0"), ("overall_prob = 0.75", "overall_prob = 0"),
                     ("noise_prob = 0.5", "noise_prob = 0")):
        assert old in text, old
        text = text.replace(old, new)
    ini = fleet / "ws.ini"
    ini.write_text(text)
    monkeypatch.chdir(fleet)
    best = port_train(["--config", str(ini), "--data_dir", str(fleet / "data"),
                       "--train_federated", "--websockets", "--device", "cpu"])
    out = capsys.readouterr().out
    assert np.isfinite(best) and "Train Epoch: 1" in out
    finals = sorted((fleet / "model_weights").glob("final_federated_*.pt"))
    assert len(finals) == 1
    state = jax_ckpt.load_model(finals[0])
    assert state["args"].websockets and state["args"].train_federated
    assert sorted(state["optim_state_dict"]) == ["alice", "bob", "charlie"]
    mean, std = state["val_mean_std"]
    assert mean.shape == std.shape == (1,) and np.all(std > 0)

    argv = ["--data_dir", str(fixture_dir / "test"), "--model_weights", str(finals[0])]
    jax_stats = jax_evaluate(argv)
    jax_table = capsys.readouterr().out
    port_stats = port_evaluate(argv + ["--device", "cpu"])
    port_table = capsys.readouterr().out
    np.testing.assert_array_equal(port_stats["conf_matrix"], jax_stats["conf_matrix"])
    assert port_stats["matthews_coeff"] == jax_stats["matthews_coeff"]
    table = [line for line in port_table.splitlines() if "│" in line]
    assert table and table == [line for line in jax_table.splitlines() if "│" in line]


def test_jax_main_federated_ws_trains_one_round_on_port_nodes(fleet, tmp_path):
    from primia_tpu.parallel.federated import main_federated_ws as jax_main_federated_ws

    args = JaxArguments(
        model="simpleconv", train_resolution=28, inference_resolution=28, batch_size=4,
        test_batch_size=6, epochs=1, lr=0.05, end_lr=0.05, optimizer="SGD", momentum=0.0,
        seed=42, test_interval=1, data_dir=str(fleet / "data"), train_federated=True,
        websockets=True, sync_every_n_batch=3, repetitions_dataset=1,
        weighted_averaging=True, unencrypted_aggregation=True,
        save_file=str(tmp_path / "completed.csv"))
    score = jax_main_federated_ws(args, verbose=False, weights_dir=str(tmp_path / "w"),
                                  config_csv=str(fleet / "configs" / "websetting" / "config.csv"))
    assert isinstance(score, float) and np.isfinite(score)
    finals = list((tmp_path / "w").glob("final_federated_*.pt"))
    assert len(finals) == 1 and ckpt.load_model(finals[0])["args"].websockets


def _fleet_args(fleet, tmp_path, secure):
    """The same run for both packages' ``main_federated_ws``: SimpleConv at
    28 px, two epochs of two rounds (two steps a node a round: the node of
    one batch goes round it twice) with a falling learning rate, the last
    epoch saved. Secure aggregation weighs the nodes by their batch counts,
    plain aggregation equally."""
    return JaxArguments(
        model="simpleconv", train_resolution=28, inference_resolution=28, batch_size=4,
        test_batch_size=6, epochs=2, lr=0.05, end_lr=0.01, optimizer="SGD", momentum=0.9,
        seed=42, test_interval=2, data_dir=str(fleet / "data"), train_federated=True,
        websockets=True, sync_every_n_batch=2, repetitions_dataset=1,
        weighted_averaging=secure, unencrypted_aggregation=not secure, clahe=False,
        mixup=False, save_file=str(tmp_path / "completed.csv"))


@pytest.mark.parametrize("secure", [True, False], ids=["secure", "plain"])
def test_aggregate_wire_equals_jax_fedavg_on_distinct_replies(secure):
    """``aggregate_wire`` on three different replies with unequal weights is
    JAX's ``secure_fedavg`` (bit for bit: the reveal is the ring sum of the
    encodings, whatever the masks) or ``plain_fedavg`` (within one float32
    ulp) on the same trees. SimpleConv at 224 px has batch-norm state, whose
    counts come from the first node."""
    from primia_tpu.mpc.aggregation import plain_fedavg, secure_fedavg
    from primia_tpu_torch.nn.jax_params import jax_leaf_paths
    from primia_tpu_torch.parallel.federated import aggregate_wire

    args, params, state = _jax_tree("simpleconv", 224)
    rng = np.random.default_rng(3)
    names = ["alice", "bob", "charlie"]
    trees = [jax.tree.map(lambda a, i=i: (a + (i + 1) * rng.normal(size=a.shape)).astype(a.dtype)
                          if a.dtype.kind == "f" else a + i, (params, state))
             for i in range(3)]
    results = {w: {"params": jnode._flatten(p), "model_state": jnode._flatten(s)}
               for w, (p, s) in zip(names, trees)}
    weights = np.array([0.5, 1 / 3, 1 / 6])
    model = create_model(Arguments.from_dict(json.loads(args.to_json())), num_classes=3,
                         device="cpu")
    got = aggregate_wire(results, names, jax_leaf_paths(model), weights,
                         (42, 777, 1) if secure else None, 16, "cpu")
    stacked = {"p": jax.tree.map(lambda *x: np.stack(x), *[t[0] for t in trees]),
               "s": jax.tree.map(lambda *x: np.stack(x), *[t[1] for t in trees])}
    ref = (secure_fedavg(jax.random.PRNGKey(1), stacked, weights, 16) if secure
           else plain_fedavg(stacked, weights))
    for wire, tree in (("params", ref["p"]), ("model_state", ref["s"])):
        want = jnode._flatten(jax.tree.map(np.asarray, tree))
        assert list(got[wire]) == list(want)
        for k, v in want.items():
            assert got[wire][k].dtype == v.dtype, k
            if secure or v.dtype.kind != "f":
                np.testing.assert_array_equal(got[wire][k], v, err_msg=k)
            else:
                np.testing.assert_allclose(got[wire][k], v, rtol=0,
                                           atol=np.spacing(np.abs(v).max()), err_msg=k)
        assert any(not np.array_equal(results[n][wire][k], want[k])
                   for n in names for k in want)


@pytest.mark.parametrize("secure", [True, False], ids=["secure", "plain"])
def test_port_and_jax_main_federated_ws_give_the_same_checkpoint(fleet, tmp_path, monkeypatch,
                                                                  secure):
    """Both packages' ``main_federated_ws`` against the same three port
    nodes on shards of 12, 6 and 3 images, from JAX's initial tree
    (``init(fold_in(PRNGKey(seed), 0))``, loaded into the port's model):
    two epochs of two rounds (``_fleet_args``). The final checkpoints
    hold the same normalization statistics and, leaf by leaf, the same
    parameters and state within 1e-5 of each leaf's largest value."""
    from primia_tpu.parallel.federated import main_federated_ws as jax_main_federated_ws
    from primia_tpu_torch.parallel import federated

    jargs = _fleet_args(fleet, tmp_path, secure)
    pargs = Arguments.from_dict(json.loads(jargs.to_json()))
    init = jax_create_model(jargs, num_classes=3).init(
        jax.random.fold_in(jax.random.PRNGKey(jargs.seed), 0))
    init = jax.tree.map(np.asarray, init)

    def create_from_jax_init(args, num_classes, device):
        model = create_model(args, num_classes=num_classes, device=device)
        model.load_state_dict(from_jax_tree(*init))
        return model

    monkeypatch.setattr(federated, "create_model", create_from_jax_init)
    csv = str(fleet / "configs" / "websetting" / "config.csv")
    finals = []
    for pkg, run in (("jax", lambda d: jax_main_federated_ws(jargs, verbose=False,
                                                             weights_dir=d, config_csv=csv)),
                     ("port", lambda d: federated.main_federated_ws(
                         pargs, verbose=False, device="cpu", weights_dir=d,
                         config_csv=csv))):
        assert np.isfinite(run(str(tmp_path / pkg)))
        (final,) = (tmp_path / pkg).glob("final_federated_*.pt")
        finals.append(jax_ckpt.load_model(final))
    jax_ck, port_ck = finals
    assert port_ck["epoch"] == jax_ck["epoch"] == 2
    for a, b in zip(port_ck["val_mean_std"], jax_ck["val_mean_std"]):
        np.testing.assert_array_equal(a, b)
    moved = False
    for part in ("params", "state"):
        got = jnode._flatten(port_ck["model_state_dict"][part])
        want = jnode._flatten(jax_ck["model_state_dict"][part])
        start = jnode._flatten(init[0 if part == "params" else 1])
        assert list(got) == list(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=0,
                                       atol=1e-5 * max(np.abs(v).max(), 1e-30), err_msg=k)
            moved |= not np.array_equal(v, start[k])
    assert moved


# ------------------------------------------------------ the inference CLI

@pytest.mark.parametrize("http", [False, True], ids=["ws", "http"])
def test_inference_cli_classifies_a_data_owner_s_images_as_the_local_files(
        http, fixture_dir, tmp_path, capsys):
    from primia_tpu_torch.cli.inference import main

    args = Arguments(model="simpleconv", train_resolution=28, inference_resolution=28)
    torch.manual_seed(6)
    weights = tmp_path / "conv.pt"
    ckpt.save_model(weights, epoch=0, model=create_model(args, num_classes=3, device="cpu"),
                    args=args, val_mean_std=(np.array([0.4]), np.array([0.2])))
    data = fixture_dir / "test" / "normal"
    owner = GridNode("data_owner", data_directory=str(data), inference_resolution=28,
                     channels=1, device="cpu")
    server, port = _serve(owner)
    csv = tmp_path / "remote.csv"
    csv.write_text(f"id,data_owner\nhost,127.0.0.1\nport,{port}\n")
    try:
        argv = ["--model_weights", str(weights), "--batch_size", "3", "--device", "cpu"]
        remote = main(argv + ["--websockets_config", str(csv)]
                      + (["--http_protocol"] if http else []))
    finally:
        server.stop()
    local = main(argv + ["--data_dir", str(data)])
    capsys.readouterr()
    assert len(remote["Inference Results"]) == 4
    assert remote == local


# -------------------------------------------------- plans, FL cycles, sandbox

def test_plans_round_trip_through_a_node_and_a_jax_plan_is_refused():
    from primia_tpu_torch.serve.plan import Plan, Protocol

    n = GridNode("planner", device="cpu")
    n.store["#x"] = np.arange(6, dtype=np.float32).reshape(2, 3)
    g = client.GridNetwork([_LocalClient(n)])
    plan = Plan.trace(lambda x, d: (x * 2 + d["b"], x.sum()), np.ones((2, 3), np.float32),
                      {"b": np.zeros(3, np.float32)}, name="affine")
    assert g.serve_plan("planner", plan)["ok"]
    assert n.handle({"type": "list_plans"})["plans"] == ["affine"]
    b = np.full(3, 0.5, np.float32)
    y, s = g.run_remote_plan("planner", "affine", n.store["#x"], {"b": b})
    np.testing.assert_array_equal(y, n.store["#x"] * 2 + b)
    assert float(s) == 15.0
    # the downloaded plan runs locally; a hosted tag is the last input
    np.testing.assert_array_equal(g.fetch_plan("planner", "affine")(n.store["#x"], {"b": b})[0],
                                  y)
    scale = Plan.trace(lambda k, x: x * k, np.ones(1, np.float32), np.ones((2, 3), np.float32),
                       name="scale")
    g.serve_plan("planner", scale)
    np.testing.assert_array_equal(
        g.run_remote_plan("planner", "scale", np.array([3.0], np.float32), input_tags=["#x"]),
        n.store["#x"] * 3)
    assert "expects 2 inputs" in n.handle({"type": "run_plan", "name": "affine",
                                           "inputs": [b]})["error"]
    # two roles on one node: the pipeline over the wire equals it in process
    double = Plan.trace(lambda x: x * 2, np.ones(3, np.float32), name="double")
    inc = Plan.trace(lambda x: x + 1, np.ones(3, np.float32), name="inc")
    proto = Protocol("p", [("a", double), ("b", inc)]).deploy(g, {"a": "planner",
                                                                  "b": "planner"})
    np.testing.assert_array_equal(proto.run(g, b), proto.run_local(b))
    np.testing.assert_array_equal(
        Protocol.deserialize(proto.serialize()).run_local(b), b * 2 + 1)

    jax_plan = JaxPlan.trace(lambda x: x * 2, np.ones(3, np.float32), name="jaxplan")
    assert n.handle({"type": "host_plan", "name": "jaxplan", "blob": jax_plan.serialize()})["ok"]
    err = n.handle({"type": "run_plan", "name": "jaxplan", "inputs": [b]})["error"]
    assert "JAX plan" in err and "jaxplan" in err


def test_fl_cycle_with_auth_and_restart(tmp_path):
    """The model-centric verbs over a port node with JWT auth (tokens from
    either package) and a warehouse: host, two cycle requests and reports,
    a restart that keeps the version and the averaged parameters."""
    secret = b"test-secret-key"
    n = GridNode("flnode", storage_dir=str(tmp_path / "wh"), auth_secret=secret, device="cpu")
    owner = auth.issue_token(secret, "boss", "owner")
    w1 = jauth.issue_token(secret, "w1", "user")  # a JAX-minted token
    w2 = auth.issue_token(secret, "w2", "user")
    params = {"w": np.ones(4, np.float32)}
    assert n.handle({"type": "fl_host_training", "name": "pneu", "params": params,
                     "server_config": {"max_workers": 2, "min_diffs": 2, "num_cycles": 3},
                     "token": owner}).get("ok")
    assert "error" in n.handle({"type": "fl_host_training", "name": "x", "params": params,
                                "token": w1})
    a = n.handle({"type": "fl_cycle_request", "name": "pneu", "token": w1})
    b = n.handle({"type": "fl_cycle_request", "name": "pneu", "token": w2})
    assert a["status"] == b["status"] == "accepted"
    assert "error" in n.handle({"type": "fl_cycle_request", "name": "pneu"})
    got = n.handle({"type": "fl_get_model", "name": "pneu", "request_key": a["request_key"],
                    "token": w1})
    np.testing.assert_allclose(got["params"]["w"], 1.0)
    diff = {"w": np.full(4, 0.5, np.float32)}
    n.handle({"type": "fl_report", "name": "pneu", "request_key": a["request_key"],
              "diff": diff, "token": w1})
    out = n.handle({"type": "fl_report", "name": "pneu", "request_key": b["request_key"],
                    "diff": diff, "token": w2})
    assert out["model_version"] == 2
    n2 = GridNode("flnode", storage_dir=str(tmp_path / "wh"), auth_secret=secret, device="cpu")
    st = n2.handle({"type": "fl_status", "name": "pneu"})
    assert st["version"] == 2 and st["cycle"] == 2
    c = n2.handle({"type": "fl_cycle_request", "name": "pneu", "token": w1})
    got = n2.handle({"type": "fl_get_model", "name": "pneu", "request_key": c["request_key"],
                     "token": w1})
    np.testing.assert_allclose(got["params"]["w"], 0.5)
    # objects hosted behind the allowed-users gate survive the restart too
    n2.handle({"type": "load_data", "tag": "#s", "array": np.ones(2), "allowed_users": ["w1"],
               "token": owner})
    n3 = GridNode("flnode", storage_dir=str(tmp_path / "wh"), auth_secret=secret, device="cpu")
    assert "array" in n3.handle({"type": "get_obj", "tag": "#s", "token": w1})
    assert "error" in n3.handle({"type": "get_obj", "tag": "#s", "token": w2})


def test_sandbox_hosts_the_jax_sandbox_s_data():
    from primia_tpu.sandbox import create_sandbox as jax_create_sandbox
    from primia_tpu_torch.sandbox import create_sandbox

    sb, jsb = create_sandbox(n_per_class=2, resolution=8, device="cpu"), \
        jax_create_sandbox(n_per_class=2, resolution=8)
    try:
        assert set(sb.nodes) == {"alice", "bob", "charlie", "crypto_provider"}
        assert set(sb.grid.search("#traindata")) == {"alice", "bob", "charlie"}
        for w in ("alice", "bob", "charlie"):
            for tag, ref in jsb.nodes[w].store.items():
                assert sb.nodes[w].store[tag].tobytes() == np.asarray(ref).tobytes(), (w, tag)
    finally:
        sb.close()
        jsb.close()


def test_node_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GridNode("alice")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        node.main(["--id", "alice", "--port", "1"])


def test_launcher_starts_a_port_node_a_csv_row(tmp_path, monkeypatch):
    """``launch_nodes`` builds the JAX launcher's command lines for the
    port's node module, with ``--device`` (no process is started here)."""
    import subprocess

    from primia_tpu.serve import launcher as jlauncher
    from primia_tpu_torch.serve import launcher

    csv = tmp_path / "config.csv"
    csv.write_text("id,alice,bob,crypto_provider\nhost,h1,h2,h3\nport,1,2,3\n")
    (tmp_path / "data" / "worker1").mkdir(parents=True)
    (tmp_path / "data" / "bob").mkdir()
    cmds = {}
    for name, mod in (("port", launcher), ("jax", jlauncher)):
        started = []
        monkeypatch.setattr(subprocess, "Popen", lambda cmd: started.append(cmd) or cmd)
        assert mod.launch_nodes(csv, tmp_path / "data", "x.ini", wait=False) == started
        cmds[name] = started
    for got, ref in zip(cmds["port"], cmds["jax"]):
        assert got[:3] == [ref[0], "-m", "primia_tpu_torch.serve.node"]
        i = got.index("--device")
        assert got[i + 1] == "cuda" and got[3:i] + got[i + 2:] == ref[3:]


def test_autoscale_writes_the_worker_csv_and_node_commands(tmp_path):
    from primia_tpu.serve import autoscale as jautoscale
    from primia_tpu_torch.serve import autoscale

    spec = autoscale.ClusterSpec(name="demo", n_grid_nodes=2)
    assert autoscale.worker_config_csv(spec) == jautoscale.worker_config_csv(
        jautoscale.ClusterSpec(name="demo", n_grid_nodes=2))
    cmds = autoscale.AutoScaler(spec).create_cluster()
    assert "nvidia-h100-80gb" in cmds[0]
    assert sum("primia_tpu_torch.serve.node" in c for c in cmds) == 3
    paths = autoscale.AutoScaler(spec).write_artifacts(tmp_path)
    assert set(paths) == {"provision.sh", "teardown.sh", "main.tf", "config.csv"}
    assert "guest_accelerator" in paths["main.tf"].read_text()
