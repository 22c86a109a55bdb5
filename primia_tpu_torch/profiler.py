"""Device-trace analysis: per-op timing, byte/FLOP attribution, roofline.

Port of ``primia_tpu/profiler.py``. The JAX module parses an XLA xplane;
this one parses the Chrome trace that ``utils.profile`` writes
(``torch.profiler`` with ``record_shapes``):

* every device event (a kernel, a copy or a set: the trace's ``kernel``,
  ``gpu_memcpy`` and ``gpu_memset`` rows) is attributed to the one aten op
  that launched it: the event's ``correlation`` id names the CUDA API
  call that launched it (a ``cuda_runtime`` or ``cuda_driver`` row), and
  the launching op is the innermost ``cpu_op`` on that call's thread
  whose span holds the call. So a kernel counts once, under its op; a
  kernel no op launched (a ``ctypes`` launch of the port's own kernels
  outside any aten op) stands under its own name;
* an op's bytes are its recorded inputs, each read once (shapes and
  dtypes), plus its output: computed for convolutions and matrix
  products, else taken as large as its largest input (the elementwise
  contract; an upper estimate for reductions). FLOPs are counted for
  convolutions (forward from the weight, stride, padding and dilation;
  backward from the gradient's shape and output mask) and matrix
  products;
* :func:`module_executions` gives each annotated step's device window
  (``torch.profiler.record_function`` ranges), so the gaps between steps
  show the device's idle time.

:class:`OpStat` and :func:`roofline` are the JAX package's, with the same
fields and arithmetic; the default roofs are the H100 SXM's (NVIDIA's
data sheet: 3.35 TB/s of HBM3, 989 TFLOP/s dense bf16 on the tensor
cores), and :func:`device_roofs` looks a card's roofs up by its
``torch.cuda.get_device_name()``.
"""

from __future__ import annotations

import bisect
import collections
import glob
import json
import math
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

H100_SXM_HBM_GBS = 3350.0
H100_SXM_BF16_TFLOPS = 989.0
ROOFS = {"NVIDIA H100 80GB HBM3": (H100_SXM_HBM_GBS, H100_SXM_BF16_TFLOPS)}

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")

# the trace's names of the dtypes (c10's), in bytes
_DTYPE_BYTES = {
    "double": 8, "float": 4, "c10::BFloat16": 2, "c10::Half": 2,
    "c10::Float8_e4m3fn": 1, "c10::Float8_e5m2": 1, "long int": 8, "int": 4,
    "short int": 2, "signed char": 1, "unsigned char": 1, "bool": 1,
    "c10::complex<float>": 8, "c10::complex<double>": 16,
}

# conv forward ops: indices of (stride, padding, dilation) among the inputs
_CONV_ARGS = {
    "aten::conv2d": (3, 4, 5), "aten::convolution": (3, 4, 5),
    "aten::_convolution": (3, 4, 5), "aten::cudnn_convolution": (3, 2, 4),
    "aten::mkldnn_convolution": (4, 3, 5), "aten::_slow_conv2d_forward": (4, 5, None),
}
_MATMULS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm", "aten::matmul",
            "aten::linear", "aten::_int_mm")


def device_roofs(name: Optional[str] = None) -> Tuple[float, float]:
    """(HBM GB/s, dense bf16 tensor-core TFLOP/s) of the card named
    ``name`` (default: ``torch.cuda.get_device_name()``)."""
    if name is None:
        import torch

        name = torch.cuda.get_device_name()
    if name not in ROOFS:
        raise KeyError(f"no roofs for {name!r}; known: {sorted(ROOFS)}")
    return ROOFS[name]


@dataclass
class OpStat:
    name: str
    total_ms: float
    count: int
    bytes_est: int
    flops_est: int

    @property
    def per_call_ms(self) -> float:
        return self.total_ms / max(self.count, 1)

    def achieved_gbs(self) -> float:
        per = self.per_call_ms
        return (self.bytes_est / 1e9) / (per / 1e3) if per > 0 else 0.0

    def floor_ms(self, hbm_gbs: float = H100_SXM_HBM_GBS,
                 mxu_tflops: float = H100_SXM_BF16_TFLOPS) -> float:
        """Per-call roofline floor: max of the HBM time and the
        tensor-core time, capped at the measured time (the byte estimate
        is an estimate)."""
        floor = max(self.bytes_est / (hbm_gbs * 1e9),
                    self.flops_est / (mxu_tflops * 1e12)) * 1e3
        return min(floor, self.per_call_ms)


# ------------------------------------------------------------ the trace

def find_trace(path: str) -> str:
    """Resolve a trace dir (as passed to ``utils.profile``) or a direct
    ``.json`` file to the newest trace file."""
    if os.path.isfile(path):
        return path
    hits = sorted(glob.glob(os.path.join(path, "**", "*.json"), recursive=True),
                  key=os.path.getmtime)
    if not hits:
        raise FileNotFoundError(f"no .json trace under {path}")
    return hits[-1]


def _events(path: str) -> List[dict]:
    with open(find_trace(path)) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X"]


def _tensors(op: dict) -> List[Tuple[str, List[int]]]:
    args = op.get("args", {})
    return [(t, list(d)) for t, d in zip(args.get("Input type", []), args.get("Input Dims", []))
            if t in _DTYPE_BYTES and isinstance(d, list)
            and all(isinstance(x, int) for x in d)]


def _concrete(op: dict, i: Optional[int], default):
    vals = op.get("args", {}).get("Concrete Inputs", [])
    if i is None or i >= len(vals) or not vals[i]:
        return default
    try:
        v = json.loads(vals[i].lower())
    except ValueError:
        return default
    return v


def _nbytes(dt: str, shape: Sequence[int]) -> int:
    return _DTYPE_BYTES[dt] * (math.prod(shape) if shape else 1)


def _pair(v) -> Tuple[int, int]:
    return (v[0], v[-1]) if isinstance(v, list) and v else (int(v), int(v))


def _estimates(op: dict) -> Tuple[int, int]:
    """(bytes, FLOPs) of one call of ``op``: inputs read once, the output
    written once."""
    name, ts = op["name"], _tensors(op)
    if not ts:
        return 0, 0
    inputs = sum(_nbytes(dt, sh) for dt, sh in ts)
    dt0 = ts[0][0]
    out, flops = max(_nbytes(dt, sh) for dt, sh in ts), 0
    shapes = [sh for _, sh in ts]
    if name in _CONV_ARGS and len(shapes) >= 2 and len(shapes[0]) == 4 == len(shapes[1]):
        (n, _, h, w), (o, cg, kh, kw) = shapes[0], shapes[1]
        si, pi, di = _CONV_ARGS[name]
        (sh, sw), (ph, pw), (dh, dw) = (_pair(_concrete(op, i, d)) for i, d in
                                        ((si, 1), (pi, 0), (di, 1)))
        ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
        wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
        flops = 2 * n * ho * wo * o * cg * kh * kw
        out = _nbytes(dt0, (n, o, ho, wo))
    elif name == "aten::convolution_backward" and len(shapes) >= 3:
        (n, o, ho, wo), x, wt = shapes[0], shapes[1], shapes[2]
        mask = _concrete(op, 10, [True, True, True])
        one = 2 * n * ho * wo * o * math.prod(wt[1:])
        flops = one * (int(bool(mask[0])) + int(bool(mask[1])))
        out = (_nbytes(dt0, x) * bool(mask[0]) + _nbytes(ts[2][0], wt) * bool(mask[1])
               + _nbytes(dt0, (o,)) * bool(mask[2]))
    elif name in _MATMULS and len(shapes) >= 2:
        a, b = shapes[-2], shapes[-1]
        if name in ("aten::addmm", "aten::baddbmm") and len(shapes) >= 3:
            a, b = shapes[1], shapes[2]
        if name == "aten::linear":
            a, b = shapes[0], shapes[1][::-1]
        if len(a) >= 2 and len(b) >= 2 and a[-1] == b[-2]:
            rows = math.prod(a[:-1])
            flops = 2 * rows * a[-1] * b[-1]
            out = _nbytes(dt0, (rows, b[-1]))
    return inputs + out, flops


def _op_name(op: dict) -> str:
    ts = _tensors(op)
    return op["name"] + ("" if not ts else " " + ", ".join(f"{dt}{sh}" for dt, sh in ts))


def _by_thread(events):
    groups = collections.defaultdict(list)
    for e in events:
        groups[(e.get("pid"), e.get("tid"))].append(e)
    return groups


def _launching_ops(events: List[dict]) -> Dict[int, dict]:
    """correlation id -> the innermost ``cpu_op`` whose span holds the
    CUDA API call that launched the device event."""
    items = [e for e in events if e.get("cat") == "cpu_op"
             or (e.get("cat") in LAUNCH_CATEGORIES and "correlation" in e.get("args", {}))]
    out: Dict[int, dict] = {}
    for thread in _by_thread(items).values():
        # an op before the calls it holds; an enclosing op before its children
        thread.sort(key=lambda e: (e["ts"], e.get("cat") != "cpu_op", -e.get("dur", 0)))
        stack: List[dict] = []
        for e in thread:
            while stack and stack[-1]["ts"] + stack[-1].get("dur", 0) < e["ts"]:
                stack.pop()
            if e.get("cat") == "cpu_op":
                stack.append(e)
            elif stack:
                out[e["args"]["correlation"]] = stack[-1]
    return out


def _counts_work(name: str) -> bool:
    return name in _CONV_ARGS or name in _MATMULS or name == "aten::convolution_backward"


def _self_times(events: List[dict]) -> List[Tuple[dict, float, bool]]:
    """Each ``cpu_op`` row with its own time (its span less its direct
    children's, in the trace's microseconds) and whether it wraps another
    convolution or matrix product (``aten::conv2d`` around
    ``aten::mkldnn_convolution``)."""
    out = []
    for thread in _by_thread([e for e in events if e.get("cat") == "cpu_op"]).values():
        thread.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        own = {id(e): e.get("dur", 0) for e in thread}
        wraps = set()
        stack: List[dict] = []
        for e in thread:
            while stack and stack[-1]["ts"] + stack[-1].get("dur", 0) <= e["ts"]:
                stack.pop()
            if stack:
                own[id(stack[-1])] -= e.get("dur", 0)
                if _counts_work(e["name"]):
                    wraps.update(id(a) for a in stack)
            stack.append(e)
        out += [(e, own[id(e)], id(e) in wraps) for e in thread]
    return out


def parse_trace(path: str, *, host: bool = False) -> List[OpStat]:
    """Per-op stats from a trace of ``utils.profile``: each device event's
    time under the op that launched it (``count``: the op's calls that
    launched device work). With ``host`` (a trace of a CPU run, which
    has no device events), each op's own CPU time instead (its span less
    its children's); an op that wraps a convolution or matrix product
    then counts no bytes or FLOPs, which its inner op counts."""
    events = _events(path)
    wrappers = set()
    if host:
        timed = _self_times(events)
        units = [(us, op, op) for op, us, _ in timed]
        wrappers = {id(op) for op, _, wraps in timed if wraps}
    else:
        launch = _launching_ops(events)
        units = [(e.get("dur", 0), e, launch.get(e.get("args", {}).get("correlation")))
                 for e in events if e.get("cat") in DEVICE_CATEGORIES]
    stats: Dict[str, list] = {}
    for us, ev, op in units:
        key = ev["name"] if op is None else _op_name(op)
        s = stats.setdefault(key, [0.0, set(), op])
        s[0] += us / 1e3
        s[1].add(id(ev if op is None else op))
    out = []
    for key, (ms, calls, op) in stats.items():
        nbytes, flops = (0, 0) if op is None or id(op) in wrappers else _estimates(op)
        out.append(OpStat(name=key, total_ms=ms, count=len(calls), bytes_est=nbytes,
                          flops_est=flops))
    out.sort(key=lambda o: -o.total_ms)
    return out


def module_executions(path: str, prefix: str = ""):
    """(annotation, start_ms, duration_ms) for each ``record_function``
    range whose name starts with ``prefix``: the span on the device of
    the events launched inside it, from the trace's first device event,
    time-ordered. The gaps between rows are the device's idle time
    between steps."""
    events = _events(path)
    calls = {e["args"]["correlation"]: e["ts"] for e in events
             if e.get("cat") in LAUNCH_CATEGORIES and "correlation" in e.get("args", {})}
    dev = sorted(((calls[e["args"]["correlation"]], e) for e in events
                  if e.get("cat") in DEVICE_CATEGORIES
                  and e.get("args", {}).get("correlation") in calls),
                 key=lambda t: t[0])
    if not dev:
        return []
    t0 = min(e["ts"] for _, e in dev)
    launched = [t for t, _ in dev]
    rows = []
    for a in events:
        if a.get("cat") != "user_annotation" or not a["name"].startswith(prefix):
            continue
        lo = bisect.bisect_left(launched, a["ts"])
        hi = bisect.bisect_right(launched, a["ts"] + a.get("dur", 0))
        mine = [e for _, e in dev[lo:hi]]
        if mine:
            start = min(e["ts"] for e in mine)
            end = max(e["ts"] + e.get("dur", 0) for e in mine)
            rows.append((a["name"], (start - t0) / 1e3, (end - start) / 1e3))
    rows.sort(key=lambda r: r[1])
    return rows


def roofline(ops: List[OpStat], *, hbm_gbs: float = H100_SXM_HBM_GBS,
             mxu_tflops: float = H100_SXM_BF16_TFLOPS, top: int = 25) -> dict:
    """Roofline summary + a printable table of the top ops. Each device
    event is in one row only (:func:`parse_trace`), so the rows add up
    without the JAX module's exclusion of control-flow rows."""
    total = sum(o.total_ms for o in ops)
    floor = sum(o.floor_ms(hbm_gbs, mxu_tflops) * o.count for o in ops)
    flops = sum(o.flops_est * o.count for o in ops)
    lines = [f"{'ms/call':>9} {'GB/s':>7} {'%HBMroof':>8}  op"]
    for o in ops[:top]:
        bw = o.achieved_gbs()
        lines.append(f"{o.per_call_ms*1e3:8.0f}u {bw:7.0f} "
                     f"{100 * bw / hbm_gbs:7.0f}%  {o.name[:100]}")
    return {
        "total_ms": total,
        "floor_ms": floor,
        "efficiency": floor / total if total else 0.0,
        "conv_tflops": flops / 1e12,
        "table": "\n".join(lines),
    }
