"""Encrypted inference in a closed loop, one client: requests of a fixed
number of uint8 images, each sent when the last has answered, served by
the port's ``build_encrypted_predict``. A request runs from the client's
uint8 batch on the host to its logits on the host.

Set-up makes the model's weights and an image pool from the seed, shares
the weights once (the model owner's step) and serves ``warmup_requests``
requests. After the window every request that was due in it is compared
with the plain reference's logits for its images.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import common

UNIT = "request"


class Run:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, torch.device(device)
        self.a = dict(cfg["args"])

    def setup(self) -> None:
        from primia_tpu_torch.config import Arguments
        from primia_tpu_torch.mpc.inference import build_encrypted_predict
        from primia_tpu_torch.nn import create_model

        args = Arguments.from_dict(self.a)
        arch = self.cfg["architecture"]
        dev = self.device
        g = torch.Generator(device=dev).manual_seed(common.sub_seed(self.seed, 0))
        pool, _ = common.make_images(g, self.traffic["pool_images"], args.inference_resolution,
                                     arch["in_channels"], arch["num_classes"])
        self.mean, self.std = common.mean_std(pool)
        self.pool = pool.cpu().numpy()  # the clients' images, on the host
        model = create_model(args, num_classes=arch["num_classes"], device=dev)
        self.W, self.B = common.make_weights(g, model)
        self.settle(pool[:self.traffic["settle_images"]])
        common.load_into(model, self.W, self.B)
        self.model = model
        self.predict = build_encrypted_predict(
            model, args, self.mean, self.std, dev, precision_fractional=args.precision_fractional,
            protocol=self.traffic["protocol"], seed=common.sub_seed(self.seed, 3))
        self.rng = np.random.default_rng(common.sub_seed(self.seed, 1))
        self.per = self.traffic["images_per_request"]
        self.served: List[tuple] = []
        for _ in range(self.traffic["warmup_requests"]):
            self.serve()
        self.served.clear()

    def settle(self, u8: torch.Tensor) -> None:
        """Batch norm's running statistics set to its inputs' on ``u8``, as
        a served model's match the images it was trained on (the plain
        reference computes them, so both sides are handed the same)."""
        from benchmark.reference import models, predict

        dev = self.device
        mean = torch.tensor(self.mean, dtype=torch.float32, device=dev)
        std = torch.tensor(self.std, dtype=torch.float32, device=dev)
        models.settle_batch_norm(self.W, self.B, predict.preprocess(u8, self.cfg, mean, std),
                                 self.cfg["architecture"])

    def serve(self) -> np.ndarray:
        idx = self.rng.integers(0, len(self.pool), self.per)
        out = self.predict(self.pool[idx]).cpu().numpy()
        self.served.append((idx, out))
        return out

    def run_units(self, n: int, span=None) -> None:
        for _ in range(n):
            if span is None:
                self.serve()
            else:
                with span("bench.request"):
                    self.serve()

    def window(self, seconds: float) -> dict:
        lat = []
        t0 = done = time.perf_counter()
        while True:
            start = done
            self.serve()
            done = time.perf_counter()
            lat.append(done - start)
            if done - t0 >= seconds:
                break
        elapsed = done - t0
        self.unit_seconds = elapsed / len(lat)
        self.images_per_unit = self.per
        self.notes = {"requests": len(lat), "service_ms_mean": self.unit_seconds * 1e3,
                      "latency_ms_p50": float(np.percentile(lat, 50)) * 1e3}
        return {"attempted": len(lat), "failed": 0,
                "metrics": {"encrypted_images_per_s": len(lat) * self.per / elapsed,
                            "encrypted_request_p95_ms": float(np.percentile(lat, 95)) * 1e3}}

    def trace_units(self) -> int:
        return self.traffic["trace_requests"]

    def release(self) -> None:
        del self.predict, self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "float32") -> List[np.ndarray]:
        """The plain reference's logits for every request served since set-up,
        in blocks of images."""
        from benchmark.reference import predict as R

        dev = self.device
        mean = torch.tensor(self.mean, dtype=torch.float32, device=dev)
        std = torch.tensor(self.std, dtype=torch.float32, device=dev)
        idx = np.concatenate([i for i, _ in self.served])
        block = self.traffic["reference_block"]
        outs = []
        for s in range(0, len(idx), block):
            u8 = torch.from_numpy(self.pool[idx[s:s + block]]).to(dev)
            outs.append(R.logits(self.W, self.B, u8, self.cfg, mean, std, precision).cpu())
        flat = torch.cat(outs).numpy()
        return np.split(flat, np.cumsum([len(i) for i, _ in self.served])[:-1])

    def readings(self, ref: List[np.ndarray], got: List[np.ndarray] = None) -> Dict[str, float]:
        got = [o for _, o in self.served] if got is None else got
        scale = max(float(np.abs(r).max()) for r in ref)
        gaps = [float(np.abs(g.astype(np.float64) - r).max()) for g, r in zip(got, ref)]
        gap = max(gaps)
        self.where = {"requests": len(ref), "max_abs_logit": scale, "max_abs_gap": gap,
                      "off_by_over_scale": [i for i, x in enumerate(gaps) if not x <= scale]}
        return {"logit_gap": gap / scale if np.isfinite(gap) else float("inf")}

    def check(self) -> Dict[str, float]:
        return self.readings(self.reference())

    def witness(self, ref: List[np.ndarray], requests: List[int]) -> List[dict]:
        """For requests whose logits are off: the program's plain predict step
        and its encrypted predict with fresh streams on the same images, each
        against the reference (the relative gap a run reads)."""
        from primia_tpu_torch.config import Arguments
        from primia_tpu_torch.mpc.inference import build_encrypted_predict
        from primia_tpu_torch.train.steps import build_predict_step

        args = Arguments.from_dict(self.a)
        plain = build_predict_step(self.model, args, self.mean, self.std, self.device)
        fresh = build_encrypted_predict(
            self.model, args, self.mean, self.std, self.device,
            precision_fractional=args.precision_fractional, protocol=self.traffic["protocol"],
            seed=common.sub_seed(self.seed, 4))
        scale = max(float(np.abs(r).max()) for r in ref)
        out = []
        for i in requests:
            u8 = self.pool[self.served[i][0]]
            gap = lambda got: float(np.abs(got.cpu().double().numpy() - ref[i]).max()) / scale
            out.append({"request": i, "program": float(np.abs(self.served[i][1] - ref[i]).max())
                        / scale, "plain_predict": gap(plain(u8)), "fresh_streams": gap(fresh(u8))})
        return out

    def controls(self, ref: List[np.ndarray]) -> Dict[str, Dict[str, float]]:
        """The readings of the reference in bfloat16 (the precision below the
        float32 that the plain predict states) put in the program's place."""
        return {"bfloat16": self.readings(ref, self.reference("bfloat16"))}
