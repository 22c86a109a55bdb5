"""K1's share of its roofline: the bytes its calls need (float32 planes
and field read once, planes written once, from each call's shapes) at
HBM's peak, over K1's device time in the traced stretch."""

from benchmark import counts


def note(calls, planes, coords, *a, **kw):
    calls.append((tuple(planes.shape), tuple(coords.shape)))


PATCHES = [("primia_tpu_torch.ops.image", "tent_rows", note)]


def read(ctx):
    if not ctx.calls or ctx.trace is None:
        return None
    us = ctx.device_us(lambda e: "tent_rows" in e.name)
    if us <= 0:
        return None
    need = sum(counts.k1_bytes(p, c) for p, c in ctx.calls) / counts.PEAK_HBM_BYTES_PER_S
    return 100.0 * need / (us / 1e6)
