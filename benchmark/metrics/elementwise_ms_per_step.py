"""Device milliseconds a train step of every kernel that is neither a
library convolution or GEMM, nor one of the port's own kernels, nor a
copy: the elementwise tail (activations, batch-norm passes, the
augmentation's arithmetic, the optimizer)."""

from benchmark.trace import category


def read(ctx):
    if ctx.unit != "step" or ctx.trace is None or not ctx.trace.device:
        return None
    return ctx.device_us(lambda e: category(e.name) == "elementwise") / 1e3 / ctx.units
