"""Stream milliseconds a train step of the program's ``train.optimizer``
span (``benchmark/spans.py``): Adam's update, the stream's idle waits
inside included. None off CUDA."""

from benchmark import spans

PATCHES = spans.PATCHES


def read(ctx):
    return spans.stream_ms(ctx.calls, [("train.optimizer", "train.optimizer")])
