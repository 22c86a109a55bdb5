"""Model FLOPs of a train step (3 x 2 x the configuration's conv and
linear MACs at its batch) over the mean step time of the untraced window,
as a share of the card's dense bf16 peak."""

from benchmark import counts


def read(ctx):
    if ctx.unit != "step" or not ctx.unit_seconds:
        return None
    flops = counts.train_flops_per_image(ctx.cfg["architecture"]) * ctx.images_per_unit
    return 100.0 * flops / ctx.unit_seconds / counts.PEAK_BF16_FLOPS
