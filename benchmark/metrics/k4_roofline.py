"""K4's share of its roofline: for each call the larger of its INT32-lane
operations (from the call's operands, counted after the traced stretch)
at the lanes' peak and its bytes at HBM's, summed, over K4's device time
in the traced stretch."""

from benchmark import counts


def note(calls, seeds, alpha, c, x, *a, **kw):
    calls.append((alpha, x))


PATCHES = [("primia_tpu_torch.mpc.compare", "dcf_sign", note)]


def read(ctx):
    if not ctx.calls or ctx.trace is None:
        return None
    us = ctx.device_us(lambda e: "dcf_sign" in e.name)
    if us <= 0:
        return None
    need = sum(counts.dcf_least_seconds(a.shape[0], counts.dcf_int32_ops(a, x))
               for a, x in ctx.calls)
    return 100.0 * need / (us / 1e6)
