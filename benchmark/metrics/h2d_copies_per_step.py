"""Host arrays copied onto the device a train step, by the program's own
``h2d_copies`` counter: its change across each ``loader.batch`` and
``train.step`` span (``benchmark/spans.py``), a step."""

from benchmark import spans

PATCHES = spans.PATCHES


def read(ctx):
    return spans.counter_per_step(ctx.calls, "h2d_copies")
