"""The traced stretch of a run and the reading of its device trace.

``capture`` runs a few of the cell's units (train steps or requests)
under ``torch.profiler`` twice: once recording device activity alone,
while the port's functions that the cell's readers name are wrapped and
each call noted (a reader's ``PATCHES``: K1's shapes, K4's operands; the
wrappers add no device work), and once with the CPU ops,
inside a ``bench.window`` span with a ``bench.step`` or ``bench.request``
span around each unit. The second Chrome trace is read by a frozen copy
of the attribution in ``primia_tpu_torch/profiler.py``: a device event
(kernel, copy or set) belongs to the CPU ops open on its launching thread
when its CUDA call was made, found through the event's correlation id.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")

# the port's kernels by name, then the library's convolutions and GEMMs by
# the tokens of their names (chip_smoke.py's split); the rest is the
# elementwise tail: activations, batch-norm passes, the augmentation's
# arithmetic, the optimizer's foreach passes, the share arithmetic
_PORT = (("tent_rows", "k1"), ("tent_bilinear", "k2"), ("clahe", "k3"), ("dcf_sign", "k4"),
         ("conv3x3_wgrad", "k7"), ("bn_sums_kernel", "k8"), ("bn_finalize_kernel", "k8"),
         ("bn_apply_kernel", "k8"), ("bn_grad_sums_kernel", "k8"),
         ("bn_grad_finalize_kernel", "k8"), ("bn_dx_kernel", "k8"),
         ("gaussian_noise", "k5"))
_CONV = ("xmma", "cudnn", "conv", "gemm", "Nhwc", "Nchw", "cutlass", "wgrad", "dgrad", "fprop",
         "implicit", "nvjet")


def category(name: str) -> str:
    for token, cat in _PORT:
        if token in name:
            return cat
    if "Memcpy" in name or "Memset" in name:
        return "memcpy"
    if any(t in name for t in _CONV):
        return "convolution"
    return "elementwise"


@dataclass
class DeviceEvent:
    name: str
    ts: float   # microseconds, the trace's clock
    dur: float
    ops: Tuple[str, ...]  # the CPU ops open at its launch, outermost first


@dataclass
class Trace:
    window: Tuple[float, float]
    device: List[DeviceEvent]
    host: List[Tuple[float, float, str]]  # the window's thread: (ts, end, name)
    busy_us: float = 0.0
    gaps: List[Tuple[float, float]] = field(default_factory=list)

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]


@dataclass
class Ctx:
    """What a per-layer metric's reader reads."""
    unit: str                 # "step" or "request"
    units: int                # units in the traced stretch
    images_per_unit: int
    unit_seconds: float       # mean seconds a unit in the untraced window
    cfg: dict
    trace: Optional[Trace]    # device activity alone, timed by the host
    attributed: Optional[Trace]  # a second stretch, with the CPU ops
    calls: list = field(default_factory=list)  # what the reader's PATCHES noted

    def device_us(self, pred) -> float:
        return sum(e.dur for e in self.trace.device if pred(e)) if self.trace else 0.0


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _events(path: str) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    return [e for e in (data["traceEvents"] if isinstance(data, dict) else data)
            if e.get("ph") == "X"]


def parse_device(path: str, wall_us: float) -> Trace:
    """A trace of device activity alone over a stretch that the host's clock
    timed at ``wall_us``: its device events, their busy union and the
    window's length."""
    device = [DeviceEvent(e["name"], e["ts"], e.get("dur", 0), ())
              for e in _events(path) if e.get("cat") in DEVICE_CATEGORIES]
    busy = _merge([(e.ts, e.ts + e.dur) for e in device])
    t0 = busy[0][0] if busy else 0.0
    t = Trace((t0, t0 + wall_us), device, [])
    t.busy_us = min(sum(b - a for a, b in busy), wall_us)
    return t


def parse(path: str, window_name: str = "bench.window") -> Trace:
    """A trace of CPU ops and device activity: each device event with the
    CPU ops open at its launch, the host spans of the window's thread, and
    the device's idle gaps inside the ``window_name`` span."""
    events = _events(path)
    win = next(e for e in events if e.get("cat") == "user_annotation"
               and e["name"] == window_name)
    w0, w1 = win["ts"], win["ts"] + win.get("dur", 0)
    main = (win.get("pid"), win.get("tid"))

    # correlation id -> the CPU ops open around the launching call
    by_thread = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "cpu_op" or (e.get("cat") in LAUNCH_CATEGORIES
                                        and "correlation" in e.get("args", {})):
            by_thread[(e.get("pid"), e.get("tid"))].append(e)
    launched: Dict[int, Tuple[str, ...]] = {}
    for thread in by_thread.values():
        thread.sort(key=lambda e: (e["ts"], e.get("cat") != "cpu_op", -e.get("dur", 0)))
        stack: List[dict] = []
        for e in thread:
            while stack and stack[-1]["ts"] + stack[-1].get("dur", 0) < e["ts"]:
                stack.pop()
            if e.get("cat") == "cpu_op":
                stack.append(e)
            else:
                launched[e["args"]["correlation"]] = tuple(s["name"] for s in stack)

    device = [DeviceEvent(e["name"], e["ts"], e.get("dur", 0),
                          launched.get(e.get("args", {}).get("correlation"), ()))
              for e in events if e.get("cat") in DEVICE_CATEGORIES
              and w0 <= e["ts"] <= w1]
    host = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
                  if e.get("cat") in HOST_CATEGORIES and (e.get("pid"), e.get("tid")) == main
                  and e["ts"] <= w1 and e["ts"] + e.get("dur", 0) >= w0)
    t = Trace((w0, w1), device, host)
    busy = _merge([(e.ts, min(e.ts + e.dur, w1)) for e in device])
    t.busy_us = sum(b - a for a, b in busy)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    t.gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
              if edges[i + 1] > edges[i]]
    return t


def _host_label(t: Trace, a: float, b: float) -> str:
    """The innermost host span open across the whole gap (a, b), else the
    innermost open at its middle."""
    for lo, hi in ((a, b), ((a + b) / 2, (a + b) / 2)):
        spans = [s for s in t.host if s[0] <= lo and s[1] >= hi]
        if spans:
            return min(spans, key=lambda s: s[1] - s[0])[2]
    return "no host span"


def breakdown(t: Trace, attributed: Trace, top: int = 10) -> dict:
    """The device operations that took most time in ``t``, and the longest
    idle gaps of ``attributed`` (traced with the CPU ops, which stretch the
    host's time), each labelled with what the host was doing."""
    by_name: Dict[str, float] = collections.defaultdict(float)
    for e in t.device:
        by_name[e.name] += e.dur / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(attributed.gaps, key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n[:200], s] for n, s in ops],
            "idle_gaps": [[_host_label(attributed, a, b)[:200], (b - a) / 1e6]
                          for a, b in gaps]}


# ------------------------------------------------------------------ capture

@contextlib.contextmanager
def _patched(module_name: str, attr: str, note):
    """Wraps ``module.attr`` so that each call's arguments go to ``note``;
    does nothing where the program has no such function."""
    import importlib

    try:
        mod = importlib.import_module(module_name)
        orig = getattr(mod, attr)
    except (ImportError, AttributeError):
        yield
        return

    def wrapper(*args, **kw):
        note(*args, **kw)
        return orig(*args, **kw)

    setattr(mod, attr, wrapper)
    try:
        yield
    finally:
        setattr(mod, attr, orig)


def capture(run, n_units: int, path: Path, device: str = "cuda",
            patches: Dict[str, list] = None):
    """Two traced stretches of ``n_units`` each. The first records device
    activity alone, timed by the host's clock from synchronise to
    synchronise (the CPU ops' recording would stretch the host's share);
    meanwhile each function that a reader's ``PATCHES`` names is wrapped,
    and its note appends what it needs of each call to that reader's list
    (notes keep references and launch nothing on the device). The second
    records the CPU ops too, with a span around the stretch and each unit,
    to attribute device events to the ops that launched them and to label
    idle gaps. ``patches``: {metric: [(module, attribute, note)]}. Returns
    (device trace, attributed trace, {metric: noted calls}). On the CPU
    (tests) both traces have no device events."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    patches = patches or {}
    calls: Dict[str, list] = {m: [] for m in patches}
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    path.parent.mkdir(parents=True, exist_ok=True)

    def traced(activities, spans):
        sync()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            if spans:
                with record_function("bench.window"):
                    run.run_units(n_units, span=record_function)
                    sync()
            else:
                run.run_units(n_units)
                sync()
            wall = time.perf_counter() - t0
        prof.export_chrome_trace(str(path))
        return wall

    try:
        with contextlib.ExitStack() as stack:
            for metric, wraps in patches.items():
                for module_name, attr, note in wraps:
                    stack.enter_context(_patched(
                        module_name, attr, functools.partial(note, calls[metric])))
            wall = traced([ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU], False)
        dev = parse_device(str(path), wall * 1e6)
        traced([ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []), True)
        attributed = parse(str(path))
    finally:
        if path.exists():
            os.remove(path)
    return dev, attributed, calls
