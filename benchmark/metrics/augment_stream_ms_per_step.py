"""Stream milliseconds a train step from the start event of the
program's ``train.augment`` span to the end event of its ``train.mixup``
span (``benchmark/spans.py``): the device time of augmentation (K1, K3,
the label and mask copies) and MixUp, the stream's idle waits inside
included. None off CUDA."""

from benchmark import spans

PATCHES = spans.PATCHES


def read(ctx):
    return spans.stream_ms(ctx.calls, [("train.augment", "train.mixup")])
