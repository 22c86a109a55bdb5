"""Stream milliseconds a train step of the program's ``maxvit.mbconv`` spans
(``nn/maxvit.py``: each block's MBConv, from its shortcut and pre-norm to
its residual add, forward only), each from its start event to its end event,
summed over the step's closes, one a block. None off CUDA or for a model
without them."""

from benchmark import attention, spans

PATCHES = spans.PATCHES


def read(ctx):
    return attention.stream_ms_per_step(ctx.calls, "maxvit.mbconv")
