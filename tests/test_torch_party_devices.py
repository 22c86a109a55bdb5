"""Party-split MPC (``party_devices``) against the unsplit path
(``tests/test_party_sharding.py``'s counterpart).

``party_devices`` keeps each party's half of every sharing on its own
device (``shares.Parties``); the dealer draws on the predict's device in
the unsplit order, so the split logits and aggregates must equal the
unsplit ones bit for bit. Here both parties are on the CPU: the halves
are still held apart, and the count of share halves sent for openings
shows that they meet only there. The card's run (``chip_smoke.py``
phase ``party``) puts party 1 on another device.
"""

import numpy as np
import pytest
import torch

from primia_tpu_torch.config import Arguments
from primia_tpu_torch.mpc import aggregation
from primia_tpu_torch.mpc import shares as S
from primia_tpu_torch.mpc.inference import build_encrypted_predict
from primia_tpu_torch.nn import create_model

CPU2 = ("cpu", "cpu")


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Under the suite's parallel workers, intra-op threads only wait on
    each other (tests/test_torch_mpc.py), so each test runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(batch=4):
    args = Arguments(model="simpleconv", train_resolution=28, inference_resolution=28,
                     pooling_type="max")
    torch.manual_seed(0)
    model = create_model(args, num_classes=3, device="cpu")
    imgs = np.random.default_rng(11).integers(0, 255, (batch, 28, 28, 1), dtype=np.uint8)
    return args, model, imgs


class _Counts:
    """Counts openings (``shares.reconstruct``) and share halves sent
    (``shares.send``)."""

    def __init__(self, monkeypatch):
        self.opens = self.sends = 0
        rec, send = S.reconstruct, S.send

        def counting_reconstruct(x):
            self.opens += 1
            return rec(x)

        def counting_send(h, device):
            self.sends += 1
            return send(h, device)

        monkeypatch.setattr(S, "reconstruct", counting_reconstruct)
        monkeypatch.setattr(S, "send", counting_send)


@pytest.mark.parametrize("protocol", ["snn", "fss"])
def test_party_split_predict_matches_unsplit(protocol, monkeypatch):
    """SimpleConv @ 28, batch 4 under snn and 1 under fss (the CPU's plain
    DCF walk takes about 14 s a batch-1 forward): the split logits equal
    the unsplit ones bit for bit; the split run opens as often as the
    unsplit one and sends exactly two share halves an opening (each
    party's, to the opener), and no half elsewhere."""
    args, model, imgs = _setup(4 if protocol == "snn" else 1)
    mean, std = np.array([0.5]), np.array([0.25])
    counts = _Counts(monkeypatch)
    ref = build_encrypted_predict(model, args, mean, std, "cpu", protocol=protocol,
                                  seed=1)(imgs)
    unsplit_opens, counts.opens = counts.opens, 0
    assert counts.sends == 0
    got = build_encrypted_predict(model, args, mean, std, "cpu", protocol=protocol, seed=1,
                                  party_devices=CPU2)(imgs)
    assert torch.equal(got, ref)
    assert counts.opens == unsplit_opens > 0
    assert counts.sends == 2 * counts.opens


@pytest.mark.parametrize("norm", ["batch", "group"])
def test_party_split_resnet_matches_unsplit(norm):
    """A one-block ResNet @ 32 (padded max-pool stem, strided downsample,
    the average-pool head; with group norm the private norms of
    ``mpc/functions.py``) under snn at batch 2: bit for bit."""
    from primia_tpu_torch.nn import ResNet

    torch.manual_seed(3)
    model = ResNet((1, 1, 1, 1), num_classes=3, in_channels=1, input_size=32, norm=norm)
    with torch.no_grad():
        model.fc.weight.normal_(0, 0.1)
    args = Arguments(model="resnet-18", train_resolution=32, inference_resolution=32,
                     normalization=norm)
    imgs = np.random.default_rng(4).integers(0, 255, (2, 32, 32, 1), dtype=np.uint8)
    ref = build_encrypted_predict(model, args, [0.5], [0.25], "cpu", seed=2)(imgs)
    got = build_encrypted_predict(model, args, [0.5], [0.25], "cpu", seed=2,
                                  party_devices=CPU2)(imgs)
    assert torch.equal(got, ref)


def test_party_split_secure_fedavg_matches_unsplit(monkeypatch):
    """``test_party_sharding.py:test_secure_fedavg_party_sharded``'s tree:
    bit for bit, one opening a leaf."""
    rng = np.random.default_rng(5)
    tree = {"w": torch.from_numpy(rng.normal(size=(3, 16, 8)).astype(np.float32)),
            "b": torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32))}
    weights = np.array([0.5, 0.3, 0.2])
    ref = aggregation.secure_fedavg((4,), tree, weights)
    counts = _Counts(monkeypatch)
    got = aggregation.secure_fedavg((4,), tree, weights, party_devices=CPU2)
    for k in tree:
        assert torch.equal(got[k], ref[k])
    assert counts.opens == 2 and counts.sends == 4


def test_parties_refuse_to_mix_the_party_axis():
    """An op over the party axis, or dealer material that was not delivered,
    raises instead of mixing the halves."""
    d = S.split(torch.arange(12).reshape(2, 6), CPU2, "cpu")
    with pytest.raises(TypeError):
        d.sum(0)
    with pytest.raises(TypeError):
        d + torch.zeros(2, 6, dtype=torch.int64)  # (2, ...) material undelivered
    with pytest.raises(TypeError):
        torch.flip(d, (0,))
    assert torch.equal(S.reconstruct(S.AShare(d)), torch.arange(12).reshape(2, 6).sum(0))
    with pytest.raises(ValueError):
        S.party_devices_of(("cpu",))
