"""Device operations (kernels, copies and sets) in the traced stretch a
request."""


def read(ctx):
    if ctx.unit != "request" or ctx.trace is None or not ctx.trace.device:
        return None
    return len(ctx.trace.device) / ctx.units
