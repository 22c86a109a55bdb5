"""Device milliseconds a train step of the window-attention kernels, forward
and backward, found by their names (``benchmark/attention.py``), over the
traced stretch. None where no such kernel ran."""

from benchmark import attention


def read(ctx):
    if ctx.unit != "step" or ctx.trace is None:
        return None
    us = ctx.device_us(lambda e: attention.is_kernel(e.name))
    return us / 1e3 / ctx.units if us > 0 else None
