"""Observability utilities: op tracing and device profiling.

Port of ``primia_tpu/utils.py``. The reference's only introspection tools
are ``LoggingTensor`` (logs each op as it forwards down the tensor chain,
``syft/frameworks/torch/tensors/decorators/logging.py``) and per-message
``verbose`` prints; it has no profiler (SURVEY.md §5).

* :class:`LoggingEngine` is the LoggingTensor equivalent for the engine
  protocol: wrap an engine (the port's ``mpc/engine.py:MpcEngine``) and
  every op a share-space forward runs is recorded with its operand shapes.
* :func:`profile` wraps ``torch.profiler`` into a context manager that
  records the CUDA activity and the ops' input shapes and writes a
  Chrome/Perfetto trace, which ``profiler.py`` attributes op by op.
* :func:`span` names a phase of the program (``train.step``,
  ``loader.batch``, ...) in that trace, with its host time, its stream
  time on a CUDA device and the host :data:`counters` at its close, all
  handed to :func:`span_closed`. Without a running profiler it is a
  shared no-op.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, List, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler


class LoggingEngine:
    """Engine decorator: records every op call as (name, arg shapes).

    >>> eng = LoggingEngine(MpcEngine(ctx))
    >>> simpleconv_forward(eng, P, model, x)
    >>> eng.log  # [("conv2d", [(1, 1, 28, 28), (32, 1, 3, 3), 1, 0]), ...]
    """

    def __init__(self, inner):
        self._inner = inner
        self.name = f"logged({inner.name})"
        self.log: List[Tuple[str, List[Any]]] = []

    def __getattr__(self, op):
        target = getattr(self._inner, op)
        if not callable(target):
            return target

        def wrapper(*args, **kwargs):
            shapes = [getattr(a, "shape", a) for a in args]
            self.log.append((op, shapes))
            return target(*args, **kwargs)

        return wrapper

    def summary(self) -> str:
        lines = [f"{i:3d}  {op:10s} {shapes}" for i, (op, shapes) in enumerate(self.log)]
        return "\n".join(lines)


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profile(logdir: str = "build/primia_trace"):
    """Capture a trace viewable in Perfetto or ``chrome://tracing``:
    ``torch.profiler`` over the block, the CPU's ops with their input
    shapes and, on a host with a card, the CUDA kernels and copies; the
    card is synchronised before the trace closes. Yields the profiler
    (its ``key_averages()`` stay readable) and writes
    ``<logdir>/trace.json``.

    >>> with profile("build/trace"):
    ...     step(...)  # traced
    """
    from torch.profiler import ProfilerActivity, profile as torch_profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with torch_profile(activities=activities, record_shapes=True) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, TRACE_FILE)
    prof.export_chrome_trace(path)
    print(f"[profile] trace written to {path}")


# ---------------------------------------------------------------- counters

# host counters, counted only while a profiler runs: ``h2d_copies``, the
# host arrays copied onto a step's device by ``train/steps.py:_on`` and
# ``data/loader.py:BatchLoader``'s index upload (:func:`count_h2d`);
# ``attention_calls``, the calls of ``nn/swin.py:window_attention`` (one a
# Swin-B block; two a MaxViT-B block, its block and its grid attention)
counters: Dict[str, int] = {"h2d_copies": 0, "attention_calls": 0}


def count(name: str) -> None:
    """Counts one event in ``counters[name]``, while a profiler runs."""
    if _autograd_profiler._is_profiler_enabled:
        counters[name] += 1


def count_h2d() -> None:
    """Counts one host array copied onto a step's device, while a profiler
    runs."""
    count("h2d_copies")


# ------------------------------------------------------------------- spans

def span_closed(name: str, host_ns: int, start_event, end_event,
                counters: Dict[str, int]) -> None:
    """Called as each :func:`span` closes under a profiler: its name, its
    host nanoseconds, its CUDA timing events on its device's current
    stream (None for a span off CUDA; ``start_event.elapsed_time(
    end_event)`` once the stream has passed them) and a copy of the host
    counters at the close. Does nothing; a reader of the spans replaces
    this module attribute, which :class:`_Span` looks up at each call
    (bind it by ``utils.span_closed``, never by ``from ... import``)."""


class _Span:
    __slots__ = ("name", "_cuda", "_range", "_event", "_t0")

    def __init__(self, name: str, cuda):
        self.name, self._cuda = name, cuda

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._event = self._record()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        host_ns = time.perf_counter_ns() - self._t0
        end = self._record()
        self._range.__exit__(*exc)
        span_closed(self.name, host_ns, self._event, end, dict(counters))
        return False

    def _record(self):
        if self._cuda is None:
            return None
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self._cuda))
        return event


_NO_SPAN = contextlib.nullcontext()


def span(name: str, device=None):
    """A context naming a phase of the program. While a torch profiler
    runs, it opens ``torch.profiler.record_function(name)`` (a range on
    the trace's clock, which Kineto aligns with the device's events),
    times its host nanoseconds and, where ``device`` (the device the
    phase's work runs on) is a CUDA device, records a timing event on its
    current stream at each end, then hands them with the counters to
    :func:`span_closed`. Otherwise it is a shared no-op context: one
    check of the profiler's flag.

    >>> with span("train.forward", device):
    ...     logits = model(x)
    """
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    device = None if device is None else torch.device(device)
    return _Span(name, device if device is not None and device.type == "cuda" else None)
