"""Host milliseconds a train step of the program's ``train.step`` and
``loader.batch`` spans (``benchmark/spans.py``), in the stretch traced
with device activity alone: the host's cost of dispatching one step, to
set beside the device's busy milliseconds a step."""

from benchmark import spans

PATCHES = spans.PATCHES


def read(ctx):
    return spans.host_ms(ctx.calls, (spans.STEP, spans.LOADER))
