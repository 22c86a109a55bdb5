"""Host milliseconds a train step of the program's ``loader.batch`` span
(``benchmark/spans.py``): one batch's index slice, gather, index upload
and padding, in the stretch traced with device activity alone."""

from benchmark import spans

PATCHES = spans.PATCHES


def read(ctx):
    return spans.host_ms(ctx.calls, (spans.LOADER,))
