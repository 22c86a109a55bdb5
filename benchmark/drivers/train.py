"""Closed-loop training: back-to-back train steps through the port's
``build_train_step``, as its train loop dispatches them (no synchronise a
step), on batches that ``data/loader.py:BatchLoader`` gathers from a
device-resident pool of seeded images.

Set-up builds one step with its model and Adam state, drives it through
its first ``reference_steps`` steps on the window's own feed (distinct
rows of the first epoch), keeps what the comparison reads (the losses,
the first gradient from Adam's first moment, the parameters after the
last of them) and hands the same step to the window.
"""

from __future__ import annotations

import itertools
import math
import statistics
import time
from typing import Dict

import torch

from benchmark import common
from benchmark.common import leaf_gap

UNIT = "step"


class Run:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, torch.device(device)
        self.a = dict(cfg["args"])

    # --------------------------------------------------------------- set-up
    def setup(self) -> None:
        from primia_tpu_torch.config import Arguments
        from primia_tpu_torch.data.loader import BatchLoader
        from primia_tpu_torch.nn import create_model
        from primia_tpu_torch.train.optim import make_optimizer
        from primia_tpu_torch.train.steps import build_train_step

        mark = common.Marks()
        args = Arguments.from_dict(self.a)
        arch = self.cfg["architecture"]
        dev = self.device
        g = torch.Generator(device=dev).manual_seed(common.sub_seed(self.seed, 0))
        n_pool = self.cfg["assumed"]["pool_images"]
        images, labels = common.make_images(g, n_pool, args.inference_resolution,
                                            arch["in_channels"], arch["num_classes"])
        self.mean, self.std = common.mean_std(images)
        mark("images")
        model = create_model(args, num_classes=arch["num_classes"], device=dev)
        self.W0, self.B0 = common.make_weights(g, model)  # the start, which the program copies
        common.load_into(model, self.W0, self.B0)
        self.model = model
        self.opt = make_optimizer(args, model)
        self.step = build_train_step(model, self.opt, args, self.mean, self.std, device=dev)
        self.batch = args.batch_size
        self.lr = args.lr
        loader = BatchLoader(images, labels.cpu().numpy(), self.batch,
                             seed=common.sub_seed(self.seed, 1), drop_last=True)
        self.feed = itertools.chain.from_iterable(itertools.repeat(loader))
        self.gen_seed = common.sub_seed(self.seed, 2)
        self.gen = torch.Generator(device=dev).manual_seed(self.gen_seed)
        mark("model_and_step")

        # the first steps, which the reference follows
        self.first = []
        self.losses = []
        for t in range(self.traffic["reference_steps"]):
            b = next(self.feed)
            self.first.append((b.images, torch.as_tensor(b.labels, device=dev)))
            self.losses.append(self.step(self.gen, b.images, b.labels, b.mask, self.lr))
            if t == 0:
                self.grad1 = {n: (m / (1.0 - self.opt.beta1)).clone()
                              for n, m in zip(self.opt.names, self.opt.mu)}
        self.params = {n: p.detach().clone() for n, p in zip(self.opt.names, self.opt.params)}
        mark("first_steps", dev)
        self.run_units(self.traffic["warmup_steps"])
        mark("warmup_steps", dev)
        self.phases = mark.seconds

    def run_units(self, n: int, span=None) -> None:
        for _ in range(n):
            b = next(self.feed)
            if span is None:
                self.step(self.gen, b.images, b.labels, b.mask, self.lr)
            else:
                with span("bench.step"):
                    self.step(self.gen, b.images, b.labels, b.mask, self.lr)

    # --------------------------------------------------------------- window
    def window(self, seconds: float) -> dict:
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda *a: None)
        sync(self.device)
        t0 = time.perf_counter()
        n = 0
        while True:
            self.run_units(1)
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync(self.device)
        elapsed = time.perf_counter() - t0
        self.unit_seconds = elapsed / n
        self.images_per_unit = self.batch
        self.notes = {"steps": n, "step_ms_mean": self.unit_seconds * 1e3}
        return {"attempted": n, "failed": 0,
                "metrics": {"train_images_per_s": n * self.batch / elapsed}}

    def trace_units(self) -> int:
        return self.traffic["trace_steps"]

    # ---------------------------------------------------------------- check
    def release(self) -> None:
        """Drops the program's model, optimizer and step, keeping what the
        comparison reads."""
        self.losses = [float(x) for x in self.losses]
        del self.step, self.opt, self.model, self.feed
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self, ref: Dict, got: Dict = None) -> Dict[str, float]:
        """The numbers of the program's first steps (or of ``got``, a
        reference run put in the program's place) against ``ref``, a
        reference run from the same start; the cell's limits file names
        those compared (PERF.md gives why each is or is not).

        - ``loss1_gap``, ``loss_gap``: the first step's and the worst step's
          relative loss gap;
        - ``grad_gap``, ``grad_gap_median``: the first gradient (Adam's first
          moment over 1 - beta1), the gap of the leaves' norms, of the worst
          leaf and of the median one, each over the larger of the reference
          leaf's norm and the median leaf's;
        - ``update_gap``: the same of the parameters' change over the steps,
          worst leaf, leaving out leaves whose loss gradient is under a
          thousandth of the median leaf's;
        - ``update_dir``, ``update_dir_median``: the same leaves' change, the
          norm of the program's change less the reference's over the
          reference's, of the worst leaf and of the median one: an update of
          the right size in the wrong direction (an ascent, a moment mixed
          up) reads here, where a gap of norms reads nothing;
        - ``head_grad_err``: the output layer's first weight gradient, the
          norm of its difference over the norm of its terms' magnitudes
          (the sum over the batch of |d logits| |h|^T): rounding scales with
          the terms, and no cancellation in their sum inflates it.
        """
        got = got or {"losses": self.losses, "first_grad": self.grad1, "params": self.params}
        steps = [abs(float(p) - r) / abs(r) if math.isfinite(float(p)) else math.inf
                 for p, r in zip(got["losses"], ref["losses"])]
        names = list(ref["params"])
        grad, grad_at, grad_med = leaf_gap(got["first_grad"], ref["first_grad"], names)
        med = sorted(ref["loss_grad_norms"].values())[len(names) // 2]
        moved = [n for n in names if ref["loss_grad_norms"][n] >= 1e-3 * med]
        d_prog = {n: got["params"][n] - self.W0[n] for n in moved}
        d_ref = {n: ref["params"][n] - self.W0[n] for n in moved}
        upd, upd_at, _ = leaf_gap(d_prog, d_ref, moved)
        def align(d, n):  # the change's cosine with the reference's first descent
            g = ref["first_grad"][n].double()
            return -float((d.double() * g).sum()) / max(float(d.double().norm() * g.norm()),
                                                        1e-300)

        dirs = {}
        for n in moved:
            r = align(d_ref[n], n)
            dirs[n] = abs(align(d_prog[n], n) - r) / max(abs(r), 1e-30)
        dir_at = max(dirs, key=dirs.get)
        nc = self.cfg["architecture"]["num_classes"]
        head = next(n for n in names if ref["params"][n].dim() == 2
                    and ref["params"][n].shape[0] == nc)
        herr = float((got["first_grad"][head].double() - ref["first_grad"][head].double())
                     .norm()) / ref["head_terms"]
        self.where = {"grad_gap": grad_at, "update_gap": upd_at, "update_dir": dir_at,
                      "loss_gaps": steps,
                      "left_out_of_update": sorted(set(names) - set(moved))}
        return {"loss1_gap": steps[0], "loss_gap": max(steps), "grad_gap": grad,
                "grad_gap_median": grad_med, "update_gap": upd,
                "update_dir": dirs[dir_at], "update_dir_median": statistics.median(dirs.values()),
                "head_grad_err": herr if math.isfinite(herr) else math.inf}

    def reference(self, precision: str = "float32", half_batch: bool = False) -> Dict:
        from benchmark.reference import train as R

        dev = self.device
        mean = torch.tensor(self.mean, dtype=torch.float32, device=dev)
        std = torch.tensor(self.std, dtype=torch.float32, device=dev)
        return R.steps(self.W0, self.B0, self.first, self.gen_seed, self.cfg, mean, std,
                       precision=precision, half_batch=half_batch)

    def check(self) -> Dict[str, float]:
        return self.readings(self.reference())

    def controls(self, ref: Dict) -> Dict[str, Dict[str, float]]:
        """The readings of what the comparison has to reject, each put in the
        program's place: the reference in float8 (the control: the precision
        below the configuration's bfloat16), the loss over half of each
        batch, the program's losses altered by 10%, its parameters left
        unchanged, its change reversed (an ascent); and, as a witness for the looks of PERF.md, the reference
        with bfloat16 operands."""
        prog = {"losses": self.losses, "first_grad": self.grad1, "params": self.params}
        return {"float8": self.readings(ref, self.reference("float8")),
                "half_batch": self.readings(ref, self.reference(half_batch=True)),
                "loss_altered": self.readings(ref, dict(prog, losses=[1.1 * x for x in
                                                                      self.losses])),
                "state_unchanged": self.readings(ref, dict(prog, params=self.W0)),
                "update_reversed": self.readings(ref, dict(prog, params={
                    n: 2 * self.W0[n] - p for n, p in self.params.items()})),
                "bfloat16_emulated": self.readings(ref, self.reference("bfloat16"))}
