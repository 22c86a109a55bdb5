"""The train step through the JAX package's opt-in kernel switches
(``PRIMIA_PALLAS_WGRAD=1``, ``PRIMIA_PALLAS_BN=1``,
``PRIMIA_PALLAS_AUGMENT=1``), on the CPU, where the port runs K7's and
K8's plain versions.

A bfloat16 ResNet-18 step at full depth from the same weights (carried by
``nn/jax_params.py``) and the same batch, with augmentation and mixup off:
the switched step against the port's default step, and against the JAX
package's ``build_train_step`` with its switch functions patched on and
its Pallas kernels in interpret mode. Also the train CLI end to end with
the switches set. Each test states its limit.

Why the conv weight gradients are not held to the JAX step: in front of
a batch norm, a conv's weight gradient is the small remainder of large
opposite sums (the norm makes the loss blind to the scale of the conv's
output), so the last bits of one bfloat16 backward move it by a large
share (``chip_smoke.py`` reports the default bfloat16 step's distance
from the float32 one beside the switch's). The modules' gradients are
held to the JAX ``custom_vjp``s in ``test_torch_wgrad.py`` and
``test_torch_bn.py``; here the step is held by its loss, its BN running
statistics and the fc's gradients, and its conv and BN gamma/beta
gradients by their distance from a float32 step's beside the default
step's.
"""

import os
from functools import partial
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import primia_tpu.ops.pallas_bn as jbn
import primia_tpu.ops.pallas_wgrad as jw
from primia_tpu.config import Arguments as JaxArguments
from primia_tpu.nn import ModelDef
from primia_tpu.nn.resnet import resnet_forward
from primia_tpu.train import optim as jax_optim
from primia_tpu.train.steps import TrainState
from primia_tpu.train.steps import build_train_step as jax_build_train_step
from primia_tpu_torch.config import Arguments
from primia_tpu_torch.nn import ResNet
from primia_tpu_torch.nn.jax_params import param_leaves, to_jax_tree
from primia_tpu_torch.ops import cuda_bn, cuda_wgrad
from primia_tpu_torch.train.steps import build_train_step

ROOT = Path(__file__).resolve().parent.parent
CANONICAL = ROOT / "configs" / "torch" / "pneumonia-resnet-pretrained.ini"
LAYERS = (2, 2, 2, 2)
SWITCHES = ("PRIMIA_PALLAS_WGRAD", "PRIMIA_PALLAS_BN", "PRIMIA_PALLAS_AUGMENT")
MEAN, STD = np.array([0.5, 0.45, 0.4]), np.array([0.25, 0.24, 0.23])


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Under the suite's parallel workers, intra-op threads only wait on
    each other (tests/test_torch_mpc.py), so each test runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _step_args(cls, res, batch, dtype="bfloat16"):
    args = cls.from_ini(CANONICAL)
    args.train_resolution = args.inference_resolution = res
    args.batch_size = batch
    args.rotation = args.scale = args.shear = args.translate = 0.0
    args.albu_prob = args.noise_prob = 0.0
    args.clahe = args.mixup = args.elastic = False
    args.compute_dtype = dtype
    return args


class _Recorder:
    """Stands in for the optimizer: keeps the gradients it is given."""

    def __init__(self, model):
        self.names = [n for n, _ in param_leaves(model)]
        named = dict(model.named_parameters())
        self.params = [named[n] for n in self.names]

    def update(self, grads, lr):
        self.grads = dict(zip(self.names, grads))


def _batch(res, batch):
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (batch, res, res, 3), dtype=np.uint8)
    labels = np.array([0, 1, 2, 1, 2, 0, 1, 0], np.int32)[:batch]
    return imgs, labels, np.ones(batch, np.float32)


def _init_state(res):
    torch.manual_seed(5)
    return ResNet(LAYERS, num_classes=3, in_channels=3, input_size=res).state_dict()


def _port_step(sd, on, res, batch, dtype="bfloat16"):
    """One port step from the state dict ``sd`` with the switches ``on``
    set and the others unset: (loss, gradients by name, the model after
    the step, plain-version calls by kernel)."""
    model = ResNet(LAYERS, num_classes=3, in_channels=3, input_size=res)
    model = model.to(memory_format=torch.channels_last)
    model.load_state_dict(sd)
    rec = _Recorder(model)
    step = build_train_step(model, rec, _step_args(Arguments, res, batch, dtype), MEAN, STD,
                            device="cpu")
    calls = {"conv3x3_wgrad": 0, "bn_sums": 0, "bn_grad_sums": 0}

    def counted(name, fn):
        def run(*a):
            calls[name] += 1
            return fn(*a)
        return run

    env = {k: ("1" if k in on else "") for k in SWITCHES}
    with mock.patch.dict(os.environ, env), \
            mock.patch.object(cuda_wgrad, "conv3x3_wgrad_plain",
                              counted("conv3x3_wgrad", cuda_wgrad.conv3x3_wgrad_plain)), \
            mock.patch.object(cuda_bn, "channel_sums_plain",
                              counted("bn_sums", cuda_bn.channel_sums_plain)), \
            mock.patch.object(cuda_bn, "grad_channel_sums_plain",
                              counted("bn_grad_sums", cuda_bn.grad_channel_sums_plain)):
        loss = float(step(torch.Generator().manual_seed(0), *_batch(res, batch), 1e-4))
    return loss, rec.grads, model, calls


def _conv_names(grads):
    return [n for n in grads if n.endswith(("conv1.weight", "conv2.weight", "down_conv.weight"))]


def _max_rel(got, want, names):
    return max(float((got[n] - want[n]).abs().max() / want[n].abs().max()) for n in names)


def _l2_rel(got, want, names):
    return max(float((got[n] - want[n]).norm() / want[n].norm()) for n in names)


# 32 px, batch 4: (switches, (K7, K8 sums, K8 gradient sums) calls a step)
CASES = {"all": (SWITCHES, (6, 20, 20)), "wgrad": (SWITCHES[:1], (6, 0, 0)),
         "bn": (SWITCHES[1:2], (0, 20, 20))}


@pytest.fixture(scope="module")
def default_step():
    return _port_step(_init_state(32), (), 32, 4)


@pytest.mark.parametrize("case", list(CASES))
def test_switched_step_counts_its_kernels_and_matches_the_default_step(case, default_step):
    """At 32 px, batch 4: 6 K7 calls a step (layer2's and layer3's three
    stride-1 convs) and 20 + 20 K8 calls (every BN, forward and backward),
    none on the default step. The loss within 1e-2 relative (the switched
    forward rounds y as ``F.batch_norm`` does: equal here), every conv
    weight gradient within 2e-2 of its max |dW| (measured here: 1.7e-2
    with the BN switch, 3e-6 under the wgrad switch alone, whose only
    change is where one float32 sum runs before its rounding to bf16)."""
    on, counts = CASES[case]
    loss_s, grads_s, _, calls_s = _port_step(_init_state(32), on, 32, 4)
    loss_d, grads_d, _, calls_d = default_step
    assert tuple(calls_s.values()) == counts
    assert calls_d == {"conv3x3_wgrad": 0, "bn_sums": 0, "bn_grad_sums": 0}
    assert np.isfinite(loss_s) and abs(loss_s - loss_d) <= 1e-2 * abs(loss_d)
    names = _conv_names(grads_s)
    assert len(names) == 20
    for n in names:
        assert grads_s[n].dtype == torch.float32
    assert _max_rel(grads_s, grads_d, names) <= 2e-2


def test_switched_gradients_are_no_further_from_float32_than_the_default_step():
    """At 64 px, batch 8 (``chip_smoke.py`` holds the same at 224 px, batch
    200): the switched step's conv and BN gamma/beta gradients no further
    from a float32 step's than 1.5 times the default bfloat16 step's
    distance from it, by the largest share of a tensor's max |value| and
    by the l2 share (measured here: 0.56 against 0.69 for the convs' max
    share, 0.53 against 0.54 for gamma/beta's). Two bfloat16 steps differ
    by a large share of these gradients; the float32 step separates that
    share from the switched path's own error."""
    res, batch = 64, 8
    sd = _init_state(res)
    _, grads_s, _, _ = _port_step(sd, SWITCHES, res, batch)
    _, grads_d, _, _ = _port_step(sd, (), res, batch)
    _, grads_f, _, _ = _port_step(sd, (), res, batch, dtype="float32")
    groups = {"conv": _conv_names(grads_d),
              "bn": [n for n in grads_d if grads_d[n].dim() == 1 and not n.startswith("fc.")]}
    assert (len(groups["conv"]), len(groups["bn"])) == (20, 40)
    for names in groups.values():
        for dist in (_max_rel, _l2_rel):
            assert dist(grads_s, grads_f, names) <= 1.5 * dist(grads_d, grads_f, names)


def _jax_interpret_switches():
    orig = jw.conv3x3_wgrad_pallas_v2
    return (mock.patch.dict(os.environ, {"PRIMIA_PALLAS_INTERPRET": "1"}),
            mock.patch.object(jw, "use_pallas_wgrad", lambda: True),
            mock.patch.object(jbn, "use_pallas_bn", lambda: True),
            mock.patch.object(jw, "conv3x3_wgrad_pallas_v2",
                              lambda x_, g_: orig(x_, g_, interpret=True)))


def test_switched_step_matches_the_jax_switched_step():
    """At 64 px, batch 8 (at 32 px layer4 is 1x1 and its BN normalises 4
    values, where two bfloat16 rounding orders move the loss past this
    limit), against the JAX package's train step with
    ``use_pallas_wgrad`` and ``use_pallas_bn`` patched on (its K7 and K8 in
    interpret mode): 6 K7 and 20 + 20 K8 calls; the loss within 1e-2
    relative; the BN running statistics within 2e-2 of each leaf's max
    |value|; the fc's weight and bias gradients within 1e-1 of their max
    (they sum the pooled features against the logits' gradient, so carry
    the two bfloat16 forwards' differences). Both steps compute in bfloat16
    but round at other places: the JAX one casts gamma and beta to
    bfloat16 and runs the stem as a space-to-depth conv."""
    res, batch = 64, 8
    sd = _init_state(res)
    loss_s, grads_s, model_s, calls = _port_step(sd, SWITCHES, res, batch)
    assert calls == {"conv3x3_wgrad": 6, "bn_sums": 20, "bn_grad_sums": 20}
    ref = ResNet(LAYERS, num_classes=3, in_channels=3, input_size=res)
    ref.load_state_dict(sd)
    params, state = to_jax_tree(ref)
    imgs, labels, mask = _batch(res, batch)
    fwd = partial(resnet_forward, layers=LAYERS, pooling="max", input_size=res)
    md = ModelDef("resnet-18", None, fwd, res, 3, 3, "max")
    opt = jax_optim.sgd()
    a, b, c, d = _jax_interpret_switches()
    with a, b, c, d:
        jstep = jax_build_train_step(md, opt, _step_args(JaxArguments, res, batch), MEAN, STD,
                                     donate=False)
        ts, ref_loss = jstep(TrainState(params, state, opt.init(params)),
                             jax.random.PRNGKey(0), jnp.asarray(imgs), jnp.asarray(labels),
                             jnp.asarray(mask), 1.0)
    assert abs(loss_s - float(ref_loss)) <= 1e-2 * abs(float(ref_loss))
    got_state = to_jax_tree(model_s)[1]
    for g, w in zip(jax.tree.leaves(got_state), jax.tree.leaves(ts.model_state)):
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(np.asarray(g, np.float64), w, rtol=0,
                                   atol=2e-2 * max(1e-9, np.abs(w).max()))
    # plain SGD at rate 1: the step moved each parameter by minus its gradient
    for name, key in (("fc.weight", "w"), ("fc.bias", "b")):
        want = np.asarray(params["fc"][key], np.float64) - np.asarray(ts.params["fc"][key],
                                                                      np.float64)
        got = grads_s[name].double().numpy()
        got = got.T if got.ndim == 2 else got
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-1 * np.abs(want).max())


def test_train_cli_runs_through_the_plain_versions_on_the_cpu(tmp_path, fixture_dir,
                                                               monkeypatch):
    """The canonical recipe at 32 px, batch 4, 1 epoch on the fixture with
    the three switches set and ``compute_dtype = bfloat16``: the three
    steps call K7's plain version 6 times each and K8's 20 + 20 times,
    and the run ends with a finite objective and a final checkpoint."""
    from primia_tpu_torch.cli.train import main as port_train

    text = CANONICAL.read_text()
    for old, new in (("batch_size = 200", "batch_size = 4"),
                     ("train_resolution = 224", "train_resolution = 32"),
                     ("epochs = 40", "epochs = 1"),
                     ("num_threads = 16", "num_threads = 16\ncompute_dtype = bfloat16")):
        assert old in text
        text = text.replace(old, new)
    ini = tmp_path / "tiny.ini"
    ini.write_text(text)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PRIMIA_MATERIALIZE_CACHE", "0")
    for k in SWITCHES:
        monkeypatch.setenv(k, "1")
    calls = []
    plain_w, plain_s = cuda_wgrad.conv3x3_wgrad_plain, cuda_bn.channel_sums_plain
    plain_g = cuda_bn.grad_channel_sums_plain
    with mock.patch.object(cuda_wgrad, "conv3x3_wgrad_plain",
                           lambda *a: calls.append("w") or plain_w(*a)), \
            mock.patch.object(cuda_bn, "channel_sums_plain",
                              lambda *a: calls.append("s") or plain_s(*a)), \
            mock.patch.object(cuda_bn, "grad_channel_sums_plain",
                              lambda *a: calls.append("g") or plain_g(*a)):
        best = port_train(["--config", str(ini), "--data_dir", str(fixture_dir / "train"),
                           "--device", "cpu"])
    assert np.isfinite(best)
    assert len(list((tmp_path / "model_weights").glob("final_*.pt"))) == 1
    steps = 3
    assert (calls.count("w"), calls.count("s"), calls.count("g")) == (6 * steps, 20 * steps,
                                                                      20 * steps)
