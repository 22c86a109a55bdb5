"""Device milliseconds of convolution and GEMM kernels a train step, by
kernel name, over the traced stretch."""

from benchmark.trace import category


def read(ctx):
    if ctx.unit != "step" or ctx.trace is None or not ctx.trace.device:
        return None
    return ctx.device_us(lambda e: category(e.name) == "convolution") / 1e3 / ctx.units
