"""The share of a train step's time in which no operation ran on the
device: 1 - (the union of device events' intervals a step, from the
stretch traced with device activity alone) / (the mean step time of the
untraced window). The traced stretch's own length is stretched by the
profiler's work on the host, so it is not the denominator."""


def read(ctx):
    if ctx.unit != "step" or ctx.trace is None or not ctx.trace.device or not ctx.unit_seconds:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us / 1e6 / ctx.units / ctx.unit_seconds)
