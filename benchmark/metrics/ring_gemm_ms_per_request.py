"""Device milliseconds a request of the kernels launched under
``aten::_int_mm``: the int8 limb GEMMs of the ring products (from the
stretch traced with the CPU ops, which attributes each kernel to the ops
open at its launch)."""


def read(ctx):
    if ctx.unit != "request" or ctx.attributed is None:
        return None
    us = sum(e.dur for e in ctx.attributed.device if "aten::_int_mm" in e.ops)
    return us / 1e3 / ctx.units if us > 0 else None
