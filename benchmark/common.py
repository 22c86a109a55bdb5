"""What every driver shares: the benchmark's files, seeded weights and
images made on the device, and the comparison's arithmetic."""

from __future__ import annotations

import json
import math
import statistics
import time
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

import torch
import torch.nn.functional as F

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load_json(path) -> dict:
    return json.loads(Path(path).read_text())


def spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(workload: str, config: str = None, traffic: str = None) -> Tuple[dict, dict, dict, dict]:
    """(workload entry, configuration, traffic mix, limits) of a cell of
    BENCHMARK.json, or, given ``config`` and ``traffic``, of a cell made of
    those files (one not in BENCHMARK.json yet)."""
    if config and traffic:
        w = {"name": workload, "config": config, "traffic": traffic, "chips": 1}
        file = BENCH_DIR / "configs" / f"{config}.json"
    else:
        s = spec()
        w = next((w for w in s["workloads"] if w["name"] == workload), None)
        if w is None:
            raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
        file = ROOT / next(c for c in s["configs"] if c["name"] == w["config"])["file"]
    return (w, load_json(file), load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
            load_json(BENCH_DIR / "limits" / f"{workload}.json"))


class Marks:
    """Seconds between calls, by name: ``mark(name)`` closes the phase
    begun at the last call (with ``device``, once its work has ended)."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self._t = time.perf_counter()

    def __call__(self, name: str, device: torch.device = None) -> None:
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        self.seconds[name] = now - self._t
        self._t = now


def sub_seed(seed: int, k: int) -> int:
    """A 63-bit seed for the k-th stream of a run."""
    return (seed * 1_000_003 + k * 7_919 + 12_345) % (1 << 63)


# ---------------------------------------------------------------- weights

def make_weights(gen: torch.Generator, model: torch.nn.Module):
    """Seeded weights and buffers for ``model``, by name, drawn on the card
    in one call each and cut into leaves: He normal (fan in, which keeps
    the activations' scale through the layers, as a trained network's)
    for convolutions, N(0, 1 / fan_in) for linear weights, 0.01 N for
    biases of convolutions and linear layers; batch norm near identity
    (gamma 1 + 0.1 N, beta 0.1 N, running mean 0.1 N, running variance
    exp(0.2 N))."""
    params = list(model.named_parameters())
    bufs = [(n, b) for n, b in model.named_buffers() if b.is_floating_point()]
    dev = gen.device

    def draw(named):
        total = sum(t.numel() for _, t in named)
        flat = torch.randn(total, generator=gen, device=dev, dtype=torch.float32)
        out, i = {}, 0
        for n, t in named:
            out[n] = flat[i:i + t.numel()].view(t.shape)
            i += t.numel()
        return out

    W, B = draw(params), draw(bufs)
    for n, t in params:
        mod = type(model.get_submodule(n.rsplit(".", 1)[0])).__name__ if "." in n else ""
        leaf = n.rsplit(".", 1)[-1]
        if mod == "Norm":
            W[n] = 1.0 + 0.1 * W[n] if leaf == "weight" else 0.1 * W[n]
        elif t.dim() == 4:
            W[n] = W[n] * math.sqrt(2.0 / (t.shape[1] * t.shape[2] * t.shape[3]))
        elif t.dim() == 2:
            W[n] = W[n] / math.sqrt(t.shape[1])
        else:
            W[n] = 0.01 * W[n]
    for n in B:
        B[n] = torch.exp(0.2 * B[n]) if n.endswith("running_var") else 0.1 * B[n]
    return W, B


@torch.no_grad()
def load_into(model: torch.nn.Module, W: Dict[str, torch.Tensor], B: Dict[str, torch.Tensor]):
    for n, p in model.named_parameters():
        p.copy_(W[n])
    for n, b in model.named_buffers():
        if n in B:
            b.copy_(B[n])


# ----------------------------------------------------------------- images

def make_images(gen: torch.Generator, n: int, res: int, channels: int = 3,
                classes: int = 3):
    """``n`` seeded grey X-ray-like images (uint8, (n, res, res, channels),
    the grey value in every channel) and their labels, made on the card: a
    bright elliptic thorax with a smooth texture, rib stripes, a
    class-dependent opacity (none, one dense focus, diffuse patches) and
    pixel noise."""
    dev = gen.device
    labels = torch.randint(0, classes, (n,), generator=gen, device=dev)
    coarse = torch.rand((n, 3, 6, 6), generator=gen, device=dev)
    fine = torch.rand((n, 1, 24, 24), generator=gen, device=dev)
    geo = torch.rand((n, 4, 1, 1), generator=gen, device=dev)
    noise = torch.randn((n, 1, res, res), generator=gen, device=dev)
    smooth = F.interpolate(coarse, size=(res, res), mode="bilinear", align_corners=False)
    patches = F.interpolate(fine, size=(res, res), mode="bilinear", align_corners=False)
    ax = torch.linspace(-1.0, 1.0, res, device=dev)
    y, x = ax[None, None, :, None], ax[None, None, None, :]
    cy, cx = 0.2 * (geo[:, 0:1] - 0.5), 0.2 * (geo[:, 1:2] - 0.5)
    body = torch.exp(-(((x - cx) / 0.85) ** 2 + ((y - cy) / 0.95) ** 2) ** 2)
    ribs = 0.5 + 0.5 * torch.sin(2 * math.pi * (6.0 * y + 1.5 * x * x + geo[:, 2:3]))
    fy, fx = 0.6 * (geo[:, 3:4] - 0.5), 0.5 * (geo[:, 0:1] - 0.5)
    focus = torch.exp(-((x - fx) ** 2 + (y - fy) ** 2) / 0.02)
    lab = labels.float()[:, None, None, None]
    opacity = torch.where(lab == 1, 0.35 * focus,
                          torch.where(lab == 2, 0.25 * (patches > 0.6).float() * patches, 0.0))
    v = 0.1 + body * (0.35 + 0.25 * smooth[:, :1] + 0.12 * ribs + opacity) \
        + 0.05 * smooth[:, 1:2] + 0.03 * noise
    u8 = (v * 255.0).round().clamp(0, 255).to(torch.uint8)
    return u8.permute(0, 2, 3, 1).expand(n, res, res, channels).contiguous(), labels


def mean_std(u8: torch.Tensor) -> Tuple[List[float], List[float]]:
    """Per-channel mean and (Bessel) std over [0, 1] floats of an NHWC pool."""
    x = u8.reshape(-1, u8.shape[-1]).double() / 255.0
    return x.mean(0).tolist(), x.std(0).tolist()


# -------------------------------------------------------------- comparing

def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             names: Iterable[str]) -> Tuple[float, str, float]:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of the reference leaf's norm and the median leaf's; the
    worst leaf's name; the median of the leaves' gaps."""
    names = list(names)
    rn = {n: float(ref[n].double().norm()) for n in names}
    pn = {n: float(prog[n].double().norm()) for n in names}
    med = statistics.median(rn.values())
    gaps = {}
    for n in names:
        g = abs(pn[n] - rn[n]) / max(rn[n], med, 1e-30)
        gaps[n] = math.inf if math.isnan(g) else g
    at = max(gaps, key=gaps.get)
    return gaps[at], at, statistics.median(gaps.values())
