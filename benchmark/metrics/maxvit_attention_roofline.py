"""MaxViT-B's window attention's share of its roofline: for each call of the
port's ``nn/swin.py:window_attention`` noted in the traced stretch (a
MaxViT block's block attention and its grid attention each call it once),
the larger of its forward and backward FLOPs at the dense bf16 peak and its
least bytes at HBM's (``benchmark/attention.py``), summed, over the
attention kernels' device time. None unless the program's counter
``attention_calls`` shows two calls a block a step, 2 x sum(depths), and
each noted call launched one forward attention kernel (a call that another
backend took would leave its work out of the time)."""

from benchmark import attention, spans

PATCHES = [("primia_tpu_torch.nn.swin", "window_attention", attention.note_call),
           ("primia_tpu_torch.utils", "span_closed", spans.note)]


def read(ctx):
    if ctx.unit != "step" or ctx.trace is None:
        return None
    notes = [c[1:] for c in ctx.calls if c[0] == "call"]
    closes = [c for c in ctx.calls if c[0] != "call"]
    calls = 2 * sum(ctx.cfg["architecture"].get("depths", ()))
    if not notes or not calls or spans.counter_per_step(closes, "attention_calls") != calls:
        return None
    forward = sum(1 for e in ctx.trace.device if attention.FORWARD_TOKEN in e.name)
    us = ctx.device_us(lambda e: attention.is_kernel(e.name))
    if forward != len(notes) or us <= 0:
        return None
    return 100.0 * sum(attention.least_seconds(*n) for n in notes) / (us / 1e6)
