"""Stream milliseconds a train step of the program's ``train.forward``
(the autocast forward and the loss) and ``train.backward`` spans
(``benchmark/spans.py``), each from its start event to its end event,
the stream's idle waits inside included. None off CUDA."""

from benchmark import spans

PATCHES = spans.PATCHES


def read(ctx):
    return spans.stream_ms(ctx.calls, [("train.forward", "train.forward"),
                                       ("train.backward", "train.backward")])
