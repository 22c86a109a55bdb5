"""What the readers of the port's window attention (``nn/swin.py``) share:
the least work of a ``window_attention`` call, from the shapes its note
keeps, and the stream time a step of a span that closes once a block.

A call on ``Bw`` windows (the batch times the windows an image), ``h``
heads, ``L`` tokens a window and head dim ``d`` needs, forward and
backward, 12 Bw h L^2 d FLOPs: q k^T and its product with v forward (2
each), their four gradients' products backward. Its least traffic reads
or writes 12 tensors of Bw h L d elements once (q, k, v, o forward; q, k,
v, o, dO, dq, dk, dv backward), the bias and its gradient (h L^2 each) in
the same dtype, and, in a shifted block, the mask (nW L^2, one byte an
element). The least time is the larger of the FLOPs at the card's dense
bf16 peak and the bytes at HBM's (``benchmark/counts.py``).
"""

from __future__ import annotations

from statistics import fmean
from typing import Optional

from benchmark import counts, spans


# the attention kernels, by the token of their names: PyTorch's
# memory-efficient SDPA backend, CUTLASS's fused multi-head attention
# (forward fmha_cutlassF_..., backward fmha_cutlassB_...), which every call
# of the port launches on the H100 (PERF.md); a call that another backend
# took would launch none of them
KERNEL_TOKEN, FORWARD_TOKEN = "fmha_cutlass", "fmha_cutlassF"


def is_kernel(name: str) -> bool:
    return KERNEL_TOKEN in name


def note_call(calls, q, k, v, bias, mask=None, *a, **kw):
    """A ``PATCHES`` note of one call: (Bw, h, L, d, bytes an element,
    windows an image of a masked call or 0)."""
    B, nW, h, L, d = q.shape
    calls.append(("call", B * nW, h, L, d, q.element_size(), 0 if mask is None else nW))


def flops(bw: int, h: int, L: int, d: int) -> int:
    return 12 * bw * h * L * L * d


def least_bytes(bw: int, h: int, L: int, d: int, itemsize: int, masked_windows: int) -> int:
    return itemsize * (12 * bw * h * L * d + 2 * h * L * L) + masked_windows * L * L


def least_seconds(bw, h, L, d, itemsize, masked_windows) -> float:
    return max(flops(bw, h, L, d) / counts.PEAK_BF16_FLOPS,
               least_bytes(bw, h, L, d, itemsize, masked_windows) / counts.PEAK_HBM_BYTES_PER_S)


def stream_ms_per_step(calls, name: str) -> Optional[float]:
    """Mean stream milliseconds a step of the span ``name``, from each
    close's start event to its end event, summed over the closes between
    one ``train.step`` close and the next (``spans.steps`` keeps one close
    a name). None without such closes or off CUDA."""
    per, cur = [], []
    for c in calls:
        if c[0] == name:
            cur.append(c)
        elif c[0] == spans.STEP:
            per.append(cur)
            cur = []
    if not per or not all(per) or any(c[2] is None or c[3] is None for s in per for c in s):
        return None
    return fmean(sum(c[2].elapsed_time(c[3]) for c in s) for s in per)
