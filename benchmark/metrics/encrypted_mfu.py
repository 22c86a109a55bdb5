"""The int8 tensor-core operations that the exact Z_2^64 linear layers of
an encrypted forward need (benchmark/counts.py: MACs x 6 Beaver ring
products x 36 limb products x 2) over the mean service time of a request
in the untraced window, as a share of the card's dense int8 peak."""

from benchmark import counts


def read(ctx):
    if ctx.unit != "request" or not ctx.unit_seconds:
        return None
    ops = counts.encrypted_int8_ops_per_image(ctx.cfg["architecture"]) * ctx.images_per_unit
    return 100.0 * ops / ctx.unit_seconds / counts.PEAK_INT8_OPS
