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
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, List, Tuple


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
def profile(logdir: str = "build/primia_trace", host_only: bool = False):
    """Capture a trace viewable in Perfetto or ``chrome://tracing``:
    ``torch.profiler`` over the block, the CPU's ops with their input
    shapes and, on a host with a card, the CUDA kernels and copies; the
    card is synchronised before the trace closes. Yields the profiler
    (its ``key_averages()`` stay readable) and writes
    ``<logdir>/trace.json``. ``host_only`` prints the block's wall time
    instead and yields None.

    >>> with profile("build/trace"):
    ...     step(...)  # traced
    """
    if host_only:
        t0 = time.perf_counter()
        yield None
        print(f"[profile] wall: {time.perf_counter() - t0:.3f}s")
        return
    import torch
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
