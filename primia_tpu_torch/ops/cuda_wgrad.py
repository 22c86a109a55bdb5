"""The weight gradient of a 3x3, stride-1, pad-1 convolution (K7), and the
convolution whose backward runs it.

Port of ``primia_tpu/ops/pallas_wgrad.py``. The CUDA kernel lives in
``primia_tpu_torch/csrc/wgrad.cu``; its header note names the TPU kernels
it replaces (``_wgrad_kernel`` and ``_wgrad_kernel_v2``) and states its
bound. This module holds its wrapper, its plain PyTorch version and
:func:`conv3x3_s1p1`, the ``torch.autograd.Function`` counterpart of the
JAX package's ``custom_vjp``.

Layout: the JAX package's x (B, H, W, ci) and g (B, H, W, co) are here
NCHW tensors in ``channels_last`` memory, the same bytes; dW is OIHW
(co, ci, 3, 3) instead of HWIO (3, 3, ci, co). Both operands are read as
bfloat16 and the sums run in float32.

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor
it launches the kernel (counted in ``_build.launches``) or raises;
``layout_copies`` counts the operands the wrapper had to copy into
bfloat16 ``channels_last`` first (the copy shows in a profile as
PyTorch's own copy kernel).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os

import torch
import torch.nn.functional as F

from primia_tpu_torch.ops._build import declare, launch, on_card, query, sm_count

_vp, _ci = ctypes.c_void_p, ctypes.c_int
declare("wgrad", {"conv3x3_wgrad": [_vp, _vp, _vp, _vp] + [_ci] * 10},
        queries={"conv3x3_wgrad_blocks_per_sm": [_ci]})
layout_copies = {"conv3x3_wgrad": 0}

# The kernel's geometry (csrc/wgrad.cu): boxes of 64 channels (one 128-byte
# swizzle row a pixel). A block's tile is 192 x 192 of (M, N): the three row
# taps of one x channel block, all read from one x box of hb + 2 rows, by
# three consumer warpgroups, against three g boxes; one producer warp. A g
# box's pixels are a multiple of wgmma's K of 16, and at most 112, so that
# three stages fit the 227 KB of shared memory a block can have.
_BOX_CHANNELS = 64
_N_BOXES = 3           # g boxes a stage, one a column tap
_K_STEP = 16
_MAX_BOX_PIXELS = 112
_ROW_BYTES = 128       # a box pixel's 64 bf16 channels
_MAX_STAGES = 8
_SMEM_LIMIT = 232448   # dynamic shared memory a block can have on sm_90
_SMEM_EXTRA = 1024 + 2 * _MAX_STAGES * 8  # 1024-byte alignment, the mbarriers
_TILE_BYTES = 3 * 64 * 195 * 4  # the epilogue's 192 x 192 tile at a pitch of 195 floats
_SMS = 132             # H100 SXM


def use_pallas_wgrad() -> bool:
    """``PRIMIA_PALLAS_WGRAD=1`` routes the train step's 3x3/s1/p1 convs
    with at least 128 channels in and out, computed in bfloat16, through
    :func:`conv3x3_s1p1` (``nn/core.py:Conv``). The JAX package honours the
    switch only on a TPU; the port honours it on every device: on CUDA the
    weight gradient launches K7, on the CPU it runs K7's plain version."""
    return os.environ.get("PRIMIA_PALLAS_WGRAD", "0") == "1"


def _check(x: torch.Tensor, g: torch.Tensor) -> None:
    if x.dim() != 4 or g.dim() != 4 or x.shape[0] != g.shape[0] or x.shape[2:] != g.shape[2:]:
        raise ValueError(f"expected x (B, ci, H, W) and g (B, co, H, W), got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")
    if not (x.is_floating_point() and g.is_floating_point()):
        raise ValueError(f"expected float operands, got {x.dtype} and {g.dtype}")
    if x.device != g.device:
        raise ValueError(f"x on {x.device}, g on {g.device}")


def _bf16_channels_last(t: torch.Tensor) -> torch.Tensor:
    """``t`` as bfloat16 in ``channels_last`` memory, copied (and counted)
    only if it is not already."""
    if t.dtype == torch.bfloat16 and t.is_contiguous(memory_format=torch.channels_last):
        return t
    layout_copies["conv3x3_wgrad"] += 1
    return t.to(dtype=torch.bfloat16, memory_format=torch.channels_last)


@dataclasses.dataclass(frozen=True)
class WgradPlan:
    """How one K7 launch cuts its work (see :func:`plan_wgrad`)."""
    wb: int          # a box's pixels along W
    hb: int          # and along H
    nwb: int         # boxes an image along W
    nhb: int         # and along H
    boxes: int       # B * nhb * nwb, the K axis in boxes
    tiles_m: int     # 192-row tiles of M: x's 64-channel blocks
    tiles_n: int     # 192-column tiles of N: g's 64-channel blocks
    splits: int      # blocks along K
    per_split: int   # boxes a split (the last may have fewer)
    stages: int      # the shared-memory ring's depth
    smem: int        # dynamic shared memory a block, bytes
    wave: int        # blocks the card holds at once

    @property
    def box_pixels(self) -> int:
        return self.wb * self.hb

    @property
    def blocks(self) -> int:
        return self.tiles_m * self.tiles_n * self.splits


@functools.lru_cache(maxsize=None)
def _box(H: int, W: int):
    """(wb, hb): the box of wb x hb pixels, a multiple of 16 and at most
    112, whose tiling of the image pads it the least; ties go to the larger
    box, then to one within the image, then to the wider one (longer
    contiguous rows). TMA fills a box's part outside the tensor with zeros."""
    best = None
    for wb in range(1, _MAX_BOX_PIXELS + 1):
        for hb in range(1, _MAX_BOX_PIXELS // wb + 1):
            if (wb * hb) % _K_STEP:
                continue
            padded = -(-W // wb) * wb * (-(-H // hb) * hb)
            key = (padded, -wb * hb, wb > W or hb > H, -wb)
            if best is None or key < best[0]:
                best = (key, wb, hb)
    return best[1], best[2]


def _x_box_bytes(wb: int, hb: int) -> int:
    """The x box (wb x (hb + 2) pixels) in shared memory, rounded up to the
    swizzle's 1024-byte period."""
    return -(-wb * (hb + 2) * _ROW_BYTES // 1024) * 1024


def plan_wgrad(B: int, ci: int, co: int, H: int, W: int, sms: int = _SMS,
               blocks_per_sm=lambda smem: 1) -> WgradPlan:
    """K7's launch plan for x (B, ci, H, W) and g (B, co, H, W): the box
    (:func:`_box`), the stages that fit beside it, the (M, N) tiles, and
    the split of the boxes along K: as many blocks as fill the card in one
    wave and no more (a second, part-filled wave would double the time),
    none empty. ``blocks_per_sm(smem)`` is the kernel's occupancy at that
    much dynamic shared memory (on the card, the CUDA occupancy API's
    answer from the kernel's registers, threads and shared memory)."""
    wb, hb = _box(H, W)
    stage = _x_box_bytes(wb, hb) + _N_BOXES * wb * hb * _ROW_BYTES
    stages = min(_MAX_STAGES, (_SMEM_LIMIT - _SMEM_EXTRA) // stage)
    smem = max(stages * stage, _TILE_BYTES) + _SMEM_EXTRA
    nwb, nhb = -(-W // wb), -(-H // hb)
    boxes = B * nhb * nwb
    tiles_m, tiles_n = -(-ci // _BOX_CHANNELS), -(-co // _BOX_CHANNELS)
    wave = sms * max(1, blocks_per_sm(smem))
    splits = max(1, min(wave // (tiles_m * tiles_n), boxes))
    per_split = -(-boxes // splits)
    return WgradPlan(wb=wb, hb=hb, nwb=nwb, nhb=nhb, boxes=boxes, tiles_m=tiles_m,
                     tiles_n=tiles_n, splits=-(-boxes // per_split), per_split=per_split,
                     stages=stages, smem=smem, wave=wave)


@functools.lru_cache(maxsize=None)
def _card_plan(index: int, B: int, ci: int, co: int, H: int, W: int) -> WgradPlan:
    device = torch.device("cuda", index)
    return plan_wgrad(B, ci, co, H, W, sm_count(device),
                      lambda smem: query("wgrad", "conv3x3_wgrad_blocks_per_sm", device, smem))


def card_plan(device: torch.device, B: int, ci: int, co: int, H: int, W: int) -> WgradPlan:
    """:func:`plan_wgrad` for the card ``device``: its SM count, and the
    kernel's occupancy from the CUDA occupancy API (planned once a shape)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _card_plan(index, B, ci, co, H, W)


def conv3x3_wgrad_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K7's function in plain PyTorch: the nine shifted products of the
    formula, each a float32 matrix product of g (co, B*H*W) and the
    shifted x (B*H*W, ci), from the operands rounded to bfloat16."""
    _check(x, g)
    B, ci, H, W = x.shape
    co = g.shape[1]
    xp = F.pad(x.to(torch.bfloat16).float(), (1, 1, 1, 1))
    g2 = g.to(torch.bfloat16).float().permute(1, 0, 2, 3).reshape(co, -1)
    dw = torch.empty((co, ci, 3, 3), dtype=torch.float32, device=x.device)
    for kh in range(3):
        for kw in range(3):
            xs = xp[:, :, kh:kh + H, kw:kw + W].permute(0, 2, 3, 1).reshape(-1, ci)
            dw[:, :, kh, kw] = g2 @ xs
    return dw


def conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K7: dW[o, c, kh, kw] = sum_{b,h,w} x[b, c, h+kh-1, w+kw-1] g[b, o, h, w]
    (zero outside the image), float32 (co, ci, 3, 3), for y = conv(x, w,
    stride 1, padding 1) and its cotangent g. The contract of the JAX
    package's ``conv3x3_wgrad_pallas`` in NCHW / OIHW. On CUDA, ci and co
    must be multiples of 8; the launch follows :func:`card_plan`."""
    _check(x, g)
    if not on_card(x, "K7"):
        return conv3x3_wgrad_plain(x, g)
    B, ci, H, W = x.shape
    co = g.shape[1]
    if ci % 8 or co % 8:
        raise ValueError(f"K7 takes channel counts that are multiples of 8, got {ci} and {co}")
    x, g = _bf16_channels_last(x), _bf16_channels_last(g)
    plan = card_plan(x.device, B, ci, co, H, W)
    ws = torch.empty((plan.splits, co, ci, 3, 3), dtype=torch.float32, device=x.device)
    dw = torch.empty((co, ci, 3, 3), dtype=torch.float32, device=x.device)
    launch("wgrad", "conv3x3_wgrad", x.device, x.data_ptr(), g.data_ptr(), ws.data_ptr(),
           dw.data_ptr(), B, H, W, ci, co, plan.wb, plan.hb, plan.splits, plan.per_split,
           plan.stages)
    return dw


def conv3x3_wgrad_v2(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The contract of ``conv3x3_wgrad_pallas_v2``. The TPU's two schedules
    differ only in where they build the halos; on Hopper both are
    :func:`conv3x3_wgrad`."""
    return conv3x3_wgrad(x, g)


def _wgrad_as(x: torch.Tensor, g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K7's weight gradient in w's dtype and memory format, as the
    library's gradient has them (bfloat16 on the train path, rounded from
    K7's float32 as the JAX package's ``.astype(w.dtype)``)."""
    return torch.empty_like(w).copy_(conv3x3_wgrad(x, g))


class _Wgrad(torch.autograd.Function):
    """:func:`_wgrad_as` with a ``vmap`` rule: under ``torch.func.vmap`` (the
    microbatched DP step's per-example gradients) it launches K7 once an
    example, on that example's views, and stacks the results, the
    function the JAX package's batched ``pallas_call`` computes."""

    @staticmethod
    def forward(x, g, w):
        return _wgrad_as(x, g, w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, x, g, w):
        def example(t, dim, i):
            return t if dim is None else t.select(dim, i)

        return torch.stack([_wgrad_as(*(example(t, d, i) for t, d in zip((x, g, w), in_dims)))
                            for i in range(info.batch_size)]), 0


class _Conv3x3S1P1(torch.autograd.Function):
    # vmap runs forward and backward batched; K7's launch has a rule of its own
    generate_vmap_rule = True

    @staticmethod
    def forward(x, w):
        return F.conv2d(x, w, padding=1)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad
        # K7 where the JAX package runs its kernel (pallas_wgrad.py:_bwd):
        # the C = 512 stage keeps the library's weight gradient
        on_k7 = need_w and max(x.shape[1], g.shape[1]) <= 256
        dx, dw, _ = torch.ops.aten.convolution_backward(
            g, x, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            [need_x, need_w and not on_k7, False])
        if on_k7:
            dw = _Wgrad.apply(x, g, w)
        return dx, dw


def conv3x3_s1p1(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A 3x3, stride-1, pad-1 convolution (NCHW, OIHW weights) whose weight
    gradient runs on K7 when max(ci, co) <= 256, as
    ``primia_tpu/ops/pallas_wgrad.py:conv3x3_s1p1``: the forward is
    ``F.conv2d`` and the data gradient the library's own, as the JAX
    package left both to XLA; where the weight gradient is K7's, it is
    cast to ``w``'s dtype (bfloat16 on the train path, rounded from K7's
    float32 as the JAX package's ``.astype(w.dtype)``). It runs under
    ``torch.func.vmap`` too: K7 then launches once an example."""
    return _Conv3x3S1P1.apply(x, w)
