"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device (a
hand-written kernel has no CPU mode). The file imports nothing of JAX,
so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from primia_tpu_torch.mpc import compare, ring_ops
from primia_tpu_torch.mpc import shares as S
from primia_tpu_torch.ops import cuda_clahe, cuda_dcf, cuda_tent
from primia_tpu_torch.ops.image import (_clahe_channels, clahe, rgb_to_lab_u8, warp_affine,
                                        warp_dense)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _planes(shape, device, seed=7):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(device)


def _low_entropy_planes(n, H, W, seed=12):
    """Planes whose histograms pile into few bins, as the flat regions of a
    chest X-ray do: all zero, 90% one value, a smooth ramp, in turn."""
    rng = np.random.default_rng(seed)
    kinds = [np.zeros((H, W), np.uint8),
             np.where(rng.random((H, W)) < 0.9, 200, rng.integers(0, 256, (H, W))),
             (np.add.outer(np.arange(H), np.arange(W)) * 255 // max(H + W - 2, 1))]
    return np.stack([kinds[i % 3].astype(np.uint8) for i in range(n)])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,tiles", [((16, 224, 224), 8), ((64, 224, 224), 8),
                                         ((3, 60, 60), 8), ((3, 37, 45), 3)])
def test_clahe_kernels_match_plain_versions(cuda_device, shape, tiles):
    """The kernel's output equals the plain composite bit for bit, and its
    LUTs equal the plain LUTs; one launch a call. 37 x 45 at 3 tiles takes
    the byte-wise band load, the pixel-wise apply and tile rows 15 px wide
    (T*tw = 45, so a band row's last word ends past it)."""
    p = _planes(shape, cuda_device)
    before = dict(cuda_clahe.launches)
    luts = torch.full((shape[0], tiles * tiles, 256), -1.0, device=cuda_device)
    out = cuda_clahe.clahe_planes(p, tiles=tiles, luts_out=luts)
    torch.testing.assert_close(luts, cuda_clahe.clahe_luts_plain(p, tiles=tiles), rtol=0, atol=0)
    torch.testing.assert_close(out, cuda_clahe.clahe_planes_plain(p, tiles=tiles), rtol=0, atol=0)
    assert cuda_clahe.launches["clahe"] == before["clahe"] + 1
    assert torch.equal(cuda_clahe.clahe_planes(p, tiles=tiles), out)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["zero", "mostly_one_value", "ramp", "batch_of_200"])
def test_clahe_kernel_on_low_entropy_planes(cuda_device, kind):
    """Histograms with one heavy bin (the atomics' worst case): bit-equal
    to the plain composite, LUTs equal."""
    if kind == "batch_of_200":
        p = torch.from_numpy(_low_entropy_planes(200, 224, 224)).to(cuda_device)
    else:
        i = ["zero", "mostly_one_value", "ramp"].index(kind)
        p = torch.from_numpy(_low_entropy_planes(3, 224, 224)[i:i + 1]).to(cuda_device)
    luts = torch.empty((p.shape[0], 64, 256), device=cuda_device)
    out = cuda_clahe.clahe_planes(p, luts_out=luts)
    torch.testing.assert_close(luts, cuda_clahe.clahe_luts_plain(p), rtol=0, atol=0)
    torch.testing.assert_close(out, cuda_clahe.clahe_planes_plain(p), rtol=0, atol=0)


@pytest.mark.cuda
def test_clahe_kernel_raises_past_the_cluster_limit(cuda_device):
    before = dict(cuda_clahe.launches)
    with pytest.raises(ValueError, match="at most 8"):
        cuda_clahe.clahe_planes(_planes((2, 72, 72), cuda_device), tiles=9)
    assert cuda_clahe.launches == before


@pytest.mark.cuda
def test_clahe_channels_on_the_card_equal_the_cpu(cuda_device):
    """Equal: the kernels are exact against the plain versions, and those
    divide as IEEE division on both devices."""
    rng = np.random.default_rng(9)
    L = torch.from_numpy(rng.integers(0, 256, (2, 1, 224, 224), dtype=np.uint8)) / 255.0
    got = _clahe_channels(L.to(cuda_device), channels_first=True).cpu()
    torch.testing.assert_close(got, _clahe_channels(L, channels_first=True), rtol=0, atol=0)


@pytest.mark.cuda
def test_lab_path_on_the_card_against_the_cpu(cuda_device):
    """The elementwise pow of the LAB conversion differs in its last bits
    between the devices: LAB within 1e-4. A few rounded L values then
    flip by one level, which moves their tiles' LUTs, so the whole path
    is held by the share of pixels more than 1 level apart: at most 1e-4."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.random((2, 3, 224, 224), dtype=np.float32))
    lab = rgb_to_lab_u8(x.to(cuda_device), axis=1).cpu()
    torch.testing.assert_close(lab, rgb_to_lab_u8(x, axis=1), rtol=0, atol=1e-4)
    d = (clahe(x.to(cuda_device), channels_first=True).cpu() - clahe(x, channels_first=True))
    assert float((d.abs() * 255.0 > 1.0 + 1e-3).float().mean()) <= 1e-4


@pytest.mark.cuda
def test_kernels_reject_non_cuda_devices_and_bad_shapes(cuda_device):
    p = _planes((2, 32, 32), cuda_device)
    with pytest.raises(ValueError):
        cuda_clahe.clahe_planes(p, luts_out=torch.zeros((2, 64, 256), device=cuda_device)[:, :63])
    with pytest.raises(ValueError):
        cuda_clahe.clahe_planes(p, luts_out=torch.zeros((2, 64, 256)))


# -------------------------------------------------- the warp kernels K1, K2

# (images, channels, H, W): the canonical train batch and a ragged one
TENT_SHAPES = [(200, 3, 224, 224), (3, 2, 60, 72)]


def _tent_operands(shape, device, seed=11, far=False):
    B, C, H, W = shape
    rng = np.random.default_rng(seed)
    planes = torch.from_numpy(rng.random((B * C, H, W), dtype=np.float32)).to(device)
    # positions spread past both edges, with some integers (exact taps)
    ys = rng.uniform(-3.0, H + 2.0, (B, H, W)).astype(np.float32)
    xs = rng.uniform(-3.0, W + 2.0, (B, H, W)).astype(np.float32)
    ys[:, ::7] = np.round(ys[:, ::7])
    xs[:, :, ::5] = np.round(xs[:, :, ::5])
    if far:  # every third position well outside the plane, on either side
        ys[:, :, ::3] = rng.uniform(-4.0 * H, 5.0 * H, ys[:, :, ::3].shape)
        xs[:, ::3] = rng.uniform(-4.0 * W, 5.0 * W, xs[:, ::3].shape)
    return planes, torch.from_numpy(ys).to(device), torch.from_numpy(xs).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TENT_SHAPES)
@pytest.mark.parametrize("axis", [1, 2])
def test_tent_rows_matches_plain(cuda_device, shape, axis):
    """Bit for bit: the kernel rounds every product and sum as the plain
    version does."""
    planes, ys, xs = _tent_operands(shape, cuda_device)
    q = ys if axis == 1 else xs
    before = cuda_tent.launches["tent_rows"]
    got = cuda_tent.tent_rows(planes, q, axis=axis)
    torch.testing.assert_close(got, cuda_tent.tent_rows_plain(planes, q, axis=axis),
                               rtol=0, atol=0)
    assert cuda_tent.launches["tent_rows"] == before + 1


# K1 and K2 also at one plane (C = 1), C above a thread's 4 planes, and
# H*W no multiple of a block's 512 pixels, with positions far outside
TENT_BILINEAR_SHAPES = TENT_SHAPES + [(2, 1, 37, 45), (3, 4, 60, 73), (2, 9, 33, 50)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TENT_BILINEAR_SHAPES[len(TENT_SHAPES):])
@pytest.mark.parametrize("axis", [1, 2])
def test_tent_rows_matches_plain_at_ragged_shapes(cuda_device, shape, axis):
    """Bit for bit, with positions up to 4 planes past either edge."""
    planes, ys, xs = _tent_operands(shape, cuda_device, far=True)
    q = ys if axis == 1 else xs
    torch.testing.assert_close(cuda_tent.tent_rows(planes, q, axis=axis),
                               cuda_tent.tent_rows_plain(planes, q, axis=axis), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TENT_BILINEAR_SHAPES)
def test_tent_bilinear_matches_plain(cuda_device, shape):
    """Bit for bit, as K1."""
    planes, ys, xs = _tent_operands(shape, cuda_device, far=shape not in TENT_SHAPES)
    before = cuda_tent.launches["tent_bilinear"]
    got = cuda_tent.tent_bilinear(planes, ys, xs, max_dy=4.0)
    torch.testing.assert_close(got, cuda_tent.tent_bilinear_plain(planes, ys, xs),
                               rtol=0, atol=0)
    assert cuda_tent.launches["tent_bilinear"] == before + 1


@pytest.mark.cuda
def test_warps_on_the_card_count_their_launches(cuda_device, monkeypatch):
    """Two K1 launches per two-pass warp, one K2 launch per gather warp."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.random((2, 3, 40, 40), dtype=np.float32)).to(cuda_device)
    mats = torch.tensor([[[1.0, 0.1, 0.5], [-0.1, 1.0, -0.5]]] * 2, device=cuda_device)
    d = torch.zeros((2, 40, 40), device=cuda_device)
    before = dict(cuda_tent.launches)
    warp_affine(x, mats, twopass=True, channels_first=True)
    warp_dense(x, d, d, channels_first=True)
    assert cuda_tent.launches["tent_rows"] == before["tent_rows"] + 4
    warp_affine(x, mats, twopass=False, channels_first=True)
    monkeypatch.setenv("PRIMIA_WARP_TWOPASS", "0")
    torch.testing.assert_close(warp_dense(x, d, d, channels_first=True), x, rtol=0, atol=0)
    assert cuda_tent.launches["tent_bilinear"] == before["tent_bilinear"] + 2


@pytest.mark.cuda
def test_tent_kernels_reject_bad_operands(cuda_device):
    planes, ys, xs = _tent_operands((2, 3, 16, 16), cuda_device)
    with pytest.raises(ValueError):
        cuda_tent.tent_rows(planes.double(), ys)
    with pytest.raises(ValueError):
        cuda_tent.tent_rows(planes, ys[:, :8])
    with pytest.raises(ValueError):
        cuda_tent.tent_rows(planes[:5], ys)
    with pytest.raises(ValueError):
        cuda_tent.tent_rows(planes, ys.cpu())
    with pytest.raises(ValueError):
        cuda_tent.tent_bilinear(planes, ys, xs[:1])
    with pytest.raises(ValueError):
        cuda_tent.tent_bilinear(planes, ys, xs.cpu())


# ------------------------------------------- the FSS sign kernel K4 and ring products

def _dcf_operands(n, device, seed=13):
    """int32 words, as the kernel takes them: seeds (2, n, 4), 31-bit
    alpha and x, c in {0, 1}."""
    rng = np.random.default_rng(seed)
    words = lambda shape, high: torch.from_numpy(  # noqa: E731
        rng.integers(0, high, shape, dtype=np.uint64).astype(np.uint32).view(np.int32))
    return tuple(t.to(device) for t in (words((2, n, 4), 1 << 32), words((n,), 1 << 31),
                                        words((n,), 2), words((n,), 1 << 31)))


# the ragged size, the largest call of a ResNet forward at batch 1 (the stem
# max-pool's first round at 224 px) and of a VGG-16 one (its first ReLU)
@pytest.mark.cuda
@pytest.mark.parametrize("n", [300, 802_816, 3_211_264])
def test_dcf_sign_matches_plain(cuda_device, n):
    seeds, alpha, c, x = _dcf_operands(n, cuda_device)
    before = cuda_dcf.launches["dcf_sign"]
    got = cuda_dcf.dcf_sign(seeds, alpha, c, x)
    assert cuda_dcf.launches["dcf_sign"] == before + 1
    torch.testing.assert_close(got, cuda_dcf.dcf_sign_plain(seeds, alpha, c, x), rtol=0, atol=0)
    a, xv = alpha.long(), x.long()
    want = torch.where(xv < a, 1 - 2 * c.long(), torch.zeros_like(a))
    torch.testing.assert_close(got.sum(0), want, rtol=0, atol=0)


@pytest.mark.cuda
def test_dcf_sign_boundary_points(cuda_device):
    """x == alpha (strict <), x = 0, alpha = 0, the domain's ends."""
    alpha = torch.tensor([5, 0, (1 << 31) - 1, 7, 7], dtype=torch.int32, device=cuda_device)
    x = torch.tensor([5, 0, 0, 6, 8], dtype=torch.int32, device=cuda_device)
    c = torch.tensor([0, 1, 0, 1, 0], dtype=torch.int32, device=cuda_device)
    seeds = _dcf_operands(5, cuda_device)[0]
    got = cuda_dcf.dcf_sign(seeds, alpha, c, x)
    torch.testing.assert_close(got, cuda_dcf.dcf_sign_plain(seeds, alpha, c, x), rtol=0, atol=0)
    assert got.sum(0).tolist() == [0, 0, 1, -1, 0]


@pytest.mark.cuda
def test_dcf_sign_rejects_bad_operands_on_the_card(cuda_device):
    seeds, alpha, c, x = _dcf_operands(8, cuda_device)
    with pytest.raises(ValueError):
        cuda_dcf.dcf_sign(seeds, alpha, c.cpu(), x)
    with pytest.raises(ValueError):
        cuda_dcf.dcf_sign(seeds.long(), alpha, c, x)


def _ring(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, shape, dtype=np.int64,
                                         endpoint=True))


# the stem conv at 224 px, batch 1, and a layer4 3x3 conv (512 -> 512 at 7x7)
@pytest.mark.cuda
@pytest.mark.parametrize("xs,ws,stride,pad", [((1, 3, 224, 224), (64, 3, 7, 7), 2, 3),
                                               ((1, 512, 7, 7), (512, 512, 3, 3), 1, 1)],
                         ids=["stem", "layer4"])
def test_limb_ring_conv2d_on_the_card_equals_cpu_int64(cuda_device, xs, ws, stride, pad):
    x, w = _ring(xs, 14), _ring(ws, 15)
    got = ring_ops.ring_conv2d(x.to(cuda_device), w.to(cuda_device), stride, pad).cpu()
    torch.testing.assert_close(got, ring_ops.ring_conv2d(x, w, stride, pad), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 512, 3), (3, 4608, 1536)], ids=["fc_batch1", "wide"])
def test_limb_ring_matmul_on_the_card_equals_cpu_int64(cuda_device, shape):
    M, K, N = shape
    a, b = _ring((M, K), 16), _ring((K, N), 17)
    got = ring_ops.ring_matmul(a.to(cuda_device), b.to(cuda_device)).cpu()
    torch.testing.assert_close(got, a @ b, rtol=0, atol=0)


@pytest.mark.cuda
def test_sign_shares_on_the_card(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(18)
    v = torch.randint(-(1 << 30), (1 << 30) + 1, (4, 64, 7, 7), device=cuda_device,
                      generator=gen)
    v.view(-1)[:4] = torch.tensor([0, -1, 1 << 30, -(1 << 30)], device=cuda_device)
    before = cuda_dcf.launches["dcf_sign"]
    sign = compare.sign_shares(gen, S.share(gen, v))
    assert cuda_dcf.launches["dcf_sign"] == before + 1
    torch.testing.assert_close(S.reconstruct(sign), (v < 0).long(), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_bits", [32, 64])
def test_securenn_on_the_card(cuda_device, n_bits):
    """SecureNN's plain ops on the card (int16 bit circuit, unsigned
    emulation in int64): the sign reveals 1{x < 0}; the Z_{2^64 - 1}
    arithmetic and the borrow equal the CPU's bit for bit; share
    conversion opens to the value. No kernel launches."""
    from primia_tpu_torch.mpc import securenn

    gen = torch.Generator(device=cuda_device).manual_seed(30)
    lim = 1 << (30 if n_bits == 32 else 61)
    v = torch.randint(-lim, lim, (4, 64, 56, 56), device=cuda_device, generator=gen)
    v.view(-1)[:4] = torch.tensor([0, -1, lim - 1, -lim], device=cuda_device)
    before = dict(cuda_dcf.launches)
    sign = securenn.sign_shares(gen, S.share(gen, v), n_bits=n_bits)
    torch.testing.assert_close(S.reconstruct(sign), (v < 0).long(), rtol=0, atol=0)
    assert cuda_dcf.launches == before
    keys = securenn.gen_sign(gen, 4096, n_bits)
    c = S.rand_ring(gen, (4096,)) & (securenn.MASK32 if n_bits == 32 else -1)
    bits = securenn._decompose(c, n_bits - 1)
    got = securenn._borrow(bits, keys.rbits_sh, keys.s)
    want = securenn._borrow(bits.cpu(), keys.rbits_sh.cpu(), keys.s.cpu())
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    a, b = S.rand_ring(gen, (4096,)), S.rand_ring(gen, (4096,))
    a[:3] = torch.tensor([0, -2, -(1 << 63)], device=cuda_device)
    b = torch.where(b == -1, torch.zeros_like(b), b)
    a = torch.where(a == -1, torch.zeros_like(a), a)
    for fn, args in ((securenn.add_mod_m, (a, b)), (securenn.neg_mod_m, (a,))):
        torch.testing.assert_close(fn(*args).cpu(), fn(*(t.cpu() for t in args)), rtol=0, atol=0)
    x = torch.randint(0, 1 << 62, (4096,), device=cuda_device, generator=gen)
    conv = securenn.share_convert(gen, S.share(gen, x))
    torch.testing.assert_close(securenn.reconstruct_mod_m(conv), x, rtol=0, atol=0)


@pytest.mark.cuda
def test_private_group_norm_on_the_card(cuda_device):
    """The engine's private group norm at the 224 px stem's 1 x 64 x 112 x
    112 in 32 groups (n = 25,088), on the card: within 2e-3 of the plain
    group norm."""
    from primia_tpu_torch.mpc import fixed
    from primia_tpu_torch.mpc.engine import MpcContext, MpcEngine, reveal_and_decode
    from primia_tpu_torch.nn.core import group_norm

    gen = torch.Generator(device=cuda_device).manual_seed(31)
    x = torch.randn((1, 64, 112, 112), device=cuda_device, generator=gen) * 1.5 + 0.5
    gamma = torch.randn(64, device=cuda_device, generator=gen) * 0.2 + 1.0
    beta = torch.randn(64, device=cuda_device, generator=gen) * 0.2
    E = MpcEngine(MpcContext(gen))
    got = reveal_and_decode(E.group_norm(*(S.share(gen, fixed.encode(t)) for t in
                                           (x, gamma, beta)), groups=32))
    torch.testing.assert_close(got.float(), group_norm(x, gamma, beta), rtol=0, atol=2e-3)


# ------------------------- the train step's opt-in kernels K7, K8 and K5

def _bf16_cl(shape, device, seed, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    t = torch.from_numpy((rng.standard_normal(shape) * scale + shift).astype(np.float32))
    return t.to(device=device, dtype=torch.bfloat16).contiguous(memory_format=torch.channels_last)


# (B, ci, co, H, W): layer2's and layer3's train shapes, VGG-16's largest map
# and its 512-channel stage at batch 64, and ragged ones (H not a multiple of
# the box's rows, W not of 16, channels not multiples of 64 or under a box's
# 64, an M tile with one block)
WGRAD_SHAPES = [(200, 128, 128, 28, 28), (200, 256, 256, 14, 14), (64, 128, 128, 112, 112),
                (64, 512, 512, 14, 14), (3, 64, 512, 9, 11),
                (2, 512, 64, 5, 7), (1, 8, 16, 3, 3), (2, 72, 136, 13, 28),
                (4, 128, 128, 7, 14)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", WGRAD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_conv3x3_wgrad_matches_plain(cuda_device, shape):
    """Within 1e-3 of max |dW|: the same bf16 products summed in float32
    in other orders."""
    from primia_tpu_torch.ops import cuda_wgrad

    torch.backends.cuda.matmul.allow_tf32 = False
    B, ci, co, H, W = shape
    x, g = _bf16_cl((B, ci, H, W), cuda_device, 20), _bf16_cl((B, co, H, W), cuda_device, 21)
    before = cuda_wgrad.launches["conv3x3_wgrad"]
    got = cuda_wgrad.conv3x3_wgrad(x, g)
    assert cuda_wgrad.launches["conv3x3_wgrad"] == before + 1
    want = cuda_wgrad.conv3x3_wgrad_plain(x, g)
    assert got.shape == (co, ci, 3, 3) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3 * float(want.abs().max()))
    # the contract is the same for a contiguous NCHW operand (copied, counted)
    copies = cuda_wgrad.layout_copies["conv3x3_wgrad"]
    torch.testing.assert_close(cuda_wgrad.conv3x3_wgrad(x.contiguous(), g), got, rtol=0, atol=0)
    assert cuda_wgrad.layout_copies["conv3x3_wgrad"] == copies + (0 if x.is_contiguous() else 1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(200, 128, 128, 28, 28), (2, 72, 136, 13, 28)],
                         ids=lambda s: "x".join(map(str, s)))
def test_conv3x3_wgrad_is_deterministic(cuda_device, shape):
    """Two calls on the same operands give the same bits: the splits are
    summed in a fixed order, with no atomics."""
    from primia_tpu_torch.ops import cuda_wgrad

    B, ci, co, H, W = shape
    x, g = _bf16_cl((B, ci, H, W), cuda_device, 23), _bf16_cl((B, co, H, W), cuda_device, 24)
    first = cuda_wgrad.conv3x3_wgrad(x, g)
    assert torch.equal(cuda_wgrad.conv3x3_wgrad(x, g), first)


@pytest.mark.cuda
def test_conv3x3_s1p1_on_the_card_matches_the_library_conv(cuda_device):
    """The autograd Function against the library conv's own gradients in
    bf16: y equal, dx equal, dW within 1e-2 of its max (both round a
    float32 sum to bf16)."""
    from primia_tpu_torch.ops import cuda_wgrad

    x = _bf16_cl((8, 128, 14, 14), cuda_device, 22)
    w = (torch.randn((128, 128, 3, 3), device=cuda_device) * 0.05).to(torch.bfloat16)
    grads = []
    for fn in (cuda_wgrad.conv3x3_s1p1, lambda a, b: torch.nn.functional.conv2d(a, b, padding=1)):
        xi, wi = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = fn(xi, wi)
        grads.append((y, *torch.autograd.grad(torch.sin(y.float()).sum(), (xi, wi))))
    (y, dx, dw), (y_ref, dx_ref, dw_ref) = grads
    torch.testing.assert_close(y, y_ref, rtol=0, atol=0)
    torch.testing.assert_close(dx, dx_ref, rtol=0, atol=0)
    torch.testing.assert_close(dw.float(), dw_ref.float(), rtol=0,
                               atol=1e-2 * float(dw_ref.float().abs().max()))


@pytest.mark.cuda
def test_conv3x3_s1p1_under_vmap_launches_k7_once_an_example(cuda_device):
    """Per-example gradients as the microbatched DP step takes them
    (``vmap(grad(...))`` over examples of K = 4 views, bf16): the weight
    gradients equal those of per-example calls outside vmap bit for bit
    (the same K7 launch on the same operands), one launch an example; the
    data gradients equal too."""
    from torch.func import grad, vmap

    from primia_tpu_torch.ops import cuda_wgrad

    n, K = 3, 4
    x = torch.stack([_bf16_cl((K, 128, 14, 14), cuda_device, 40 + i) for i in range(n)])
    t = torch.stack([_bf16_cl((K, 128, 14, 14), cuda_device, 50 + i) for i in range(n)])
    w = (torch.randn((128, 128, 3, 3), device=cuda_device) * 0.05).to(torch.bfloat16)

    def loss(w, x, t):
        return (cuda_wgrad.conv3x3_s1p1(x, w).float() * t.float()).sum()

    before = cuda_wgrad.launches["conv3x3_wgrad"]
    dw = vmap(grad(loss), in_dims=(None, 0, 0))(w, x, t)
    assert cuda_wgrad.launches["conv3x3_wgrad"] == before + n
    dx = vmap(grad(loss, argnums=1), in_dims=(None, 0, 0))(w, x, t)
    for i in range(n):
        torch.testing.assert_close(dw[i], grad(loss)(w, x[i], t[i]), rtol=0, atol=0)
        torch.testing.assert_close(dx[i], grad(loss, argnums=1)(w, x[i], t[i]), rtol=0, atol=0)


# the stem and layer4 at batch 200, SimpleConv@224's first and last batch
# norms at batch 4 (C = 8 on an odd 111^2 map: one 16-byte row a pixel), and
# ragged shapes (C = 24, 64, 128, 512)
BN_SHAPES = [(200, 64, 112, 112), (200, 512, 7, 7), (4, 8, 111, 111), (4, 128, 12, 12),
             (3, 24, 5, 7), (4, 64, 9, 11),
             (5, 128, 3, 3), (1, 512, 1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bn_sums_match_plain(cuda_device, shape):
    """Each sum within 1e-5 of the same sum of absolute values (float32
    sums of the same bf16 values in other orders)."""
    from primia_tpu_torch.ops import cuda_bn

    x, g = _bf16_cl(shape, cuda_device, 23, 1.0, 0.5), _bf16_cl(shape, cuda_device, 24, 0.1, 0.05)
    before = dict(cuda_bn.launches)
    got = cuda_bn.channel_sums(x) + cuda_bn.grad_channel_sums(g, x)
    sums = ("bn_sums", "bn_grad_sums")
    assert cuda_bn.launches == {k: v + (k in sums) for k, v in before.items()}
    want = cuda_bn.channel_sums_plain(x) + cuda_bn.grad_channel_sums_plain(g, x)
    scale = cuda_bn.channel_sums_plain(x.abs()) + cuda_bn.grad_channel_sums_plain(g.abs(),
                                                                                x.abs())
    for a, b, m in zip(got, want, scale):
        assert a.shape == (shape[1],) and a.dtype == torch.float32
        assert bool(((a - b).abs() <= 1e-5 * m + 1e-6).all())


def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 values at each |t| (8 significant bits)."""
    e = torch.floor(torch.log2(t.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def _bn_operands(shape, device):
    C = shape[1]
    g = torch.Generator(device="cpu").manual_seed(sum(shape))
    vec = lambda lo, hi: (torch.rand(C, generator=g) * (hi - lo) + lo).to(device)  # noqa: E731
    return (_bf16_cl(shape, device, 29, 1.0, 0.5), _bf16_cl(shape, device, 30, 0.1, 0.05),
            vec(0.5, 1.5), vec(-0.2, 0.2), vec(-0.1, 0.1), vec(0.5, 1.5))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bn_launches_match_plain(cuda_device, shape):
    """Each of the BN's six launches against its plain version on the same
    inputs: the finalizes' sums within 1e-6 of the sums of the partials'
    absolute values (another order), every statistic and coefficient
    within 1e-6 of its largest |value| (the same roundings; rsqrt may
    differ in its last bit), the running statistics likewise, and y and
    dx within one bfloat16 ulp. Each launch counts once."""
    from primia_tpu_torch.ops import cuda_bn

    x, gy, gamma, beta, rm, rv = _bn_operands(shape, cuda_device)
    n = x.numel() // shape[1]
    before = dict(cuda_bn.launches)
    rm_k, rv_k, rm_p, rv_p = rm.clone(), rv.clone(), rm.clone(), rv.clone()
    part = cuda_bn.channel_partials(x)
    stats = cuda_bn.bn_finalize(part, gamma, beta, n, 1e-5, rm_k, rv_k, 0.1)
    _, _, mean, var, r, inv, off = stats.unbind(0)
    y = cuda_bn.bn_apply(x, inv, off)
    gpart = cuda_bn.grad_channel_partials(gy, x)
    coef = cuda_bn.bn_grad_finalize(gpart, gamma, mean, r, n)
    dx = cuda_bn.bn_dx(gy, x, *coef[3:])
    assert cuda_bn.launches == {k: v + 1 for k, v in before.items()}

    for got, p in ((stats, part), (coef, gpart)):
        torch.testing.assert_close(got[:2], p.sum(0), rtol=0,
                                   atol=1e-6 * float(p.abs().sum(0).max()))
    want = cuda_bn.bn_finalize_plain(stats[:2], gamma, beta, n, 1e-5, rm_p, rv_p, 0.1)
    want_g = cuda_bn.bn_grad_finalize_plain(coef[:2], gamma, mean, r, n)
    for got, ref in ((stats[2:], want[2:]), (coef[2:], want_g[2:]), (rm_k, rm_p), (rv_k, rv_p)):
        for a, b in zip(got.reshape(-1, shape[1]), ref.reshape(-1, shape[1])):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * float(b.abs().max()))
    for got, ref in ((y, cuda_bn.bn_apply_plain(x, inv, off)),
                     (dx, cuda_bn.bn_dx_plain(gy, x, *coef[3:]))):
        assert got.dtype == torch.bfloat16 and got.is_contiguous(memory_format=torch.channels_last)
        assert bool(((got.float() - ref.float()).abs() <= _bf16_ulp(ref)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(200, 64, 112, 112), (200, 512, 7, 7)], ids=["stem", "layer4"])
def test_bn_launches_are_deterministic(cuda_device, shape):
    """Two calls on the same operands give the same bits: the finalizes
    sum the partials in a fixed order."""
    from primia_tpu_torch.ops import cuda_bn

    x, gy, gamma, beta, _, _ = _bn_operands(shape, cuda_device)
    n = x.numel() // shape[1]

    def run():
        stats = cuda_bn.bn_finalize(cuda_bn.channel_partials(x), gamma, beta, n, 1e-5)
        coef = cuda_bn.bn_grad_finalize(cuda_bn.grad_channel_partials(gy, x), gamma, stats[2],
                                        stats[4], n)
        return stats, coef, cuda_bn.bn_apply(x, stats[5], stats[6]), cuda_bn.bn_dx(gy, x,
                                                                               *coef[3:])

    for a, b in zip(run(), run()):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_bn_train_runs_three_kernels_a_direction(cuda_device):
    """``bn_train`` forward and backward, with the running statistics:
    the profiler sees exactly the three BN kernels in each direction and
    no other device work."""
    from torch.profiler import ProfilerActivity, profile

    from primia_tpu_torch.ops import cuda_bn

    x, gy, gamma, beta, rm, rv = _bn_operands((8, 64, 10, 10), cuda_device)
    x.requires_grad_(True)
    gamma.requires_grad_(True)
    beta.requires_grad_(True)
    cuda_bn.bn_train(x, gamma, beta, 1e-5, rm, rv, 0.1)  # builds the library
    for direction in ("forward", "backward"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            if direction == "forward":
                y, _, _ = cuda_bn.bn_train(x, gamma, beta, 1e-5, rm, rv, 0.1)
            else:
                torch.autograd.grad(y, (x, gamma, beta), gy)
            torch.cuda.synchronize()
        names = sorted(e.key for e in prof.key_averages() if e.device_time_total > 0)
        kinds = (("bn_sums_kernel", "bn_finalize_kernel", "bn_apply_kernel")
                 if direction == "forward" else
                 ("bn_grad_sums_kernel", "bn_grad_finalize_kernel", "bn_dx_kernel"))
        assert len(names) == 3 and all(any(k in n for n in names) for k in kinds), names


@pytest.mark.cuda
def test_bn_train_on_the_card_matches_f_batch_norm(cuda_device):
    """Against ``F.batch_norm`` in train mode on the same bf16 input: y
    within 1 bf16 ulp of max |y| (both round a float32 value once), mean
    and biased variance within 1e-5, and the gradients of x, gamma and beta
    within 1e-2 of their max (bf16 gradients, other sums)."""
    from primia_tpu_torch.ops import cuda_bn

    x = _bf16_cl((16, 64, 20, 20), cuda_device, 25, 1.5, 0.3)
    gy = _bf16_cl((16, 64, 20, 20), cuda_device, 26)
    gamma = torch.rand(64, device=cuda_device) + 0.5
    beta = torch.randn(64, device=cuda_device) * 0.1
    outs = []
    for port in (True, False):
        xi, gi, bi = (t.clone().requires_grad_(True) for t in (x, gamma, beta))
        if port:
            y, mean, var = cuda_bn.bn_train(xi, gi, bi)
        else:
            y = torch.nn.functional.batch_norm(xi, None, None, gi, bi, training=True)
            xf = x.float()
            mean, var = xf.mean((0, 2, 3)), xf.var((0, 2, 3), unbiased=False)
        outs.append((y, mean, var, *torch.autograd.grad(y, (xi, gi, bi), gy)))
    limits = {"y": 2.0 ** -7, "mean": None, "var": None, "dx": 1e-2, "dgamma": 1e-2,
              "dbeta": 1e-2}
    for (name, rel), got, want in zip(limits.items(), *outs):
        got, want = got.detach().float(), want.detach().float()
        atol = 1e-5 if rel is None else rel * float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=atol, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [((200, 3, 224, 224), torch.float32),
                                         ((3, 1000), torch.float32),
                                         ((5, 7, 13), torch.bfloat16),
                                         ((7, 3, 37, 45), torch.float32)],
                         ids=["train", "rows", "bf16", "unaligned"])
def test_gaussian_noise_matches_plain(cuda_device, shape, dtype):
    """The uniforms bit for bit; the output within 1e-5 (float32) or one
    bf16 ulp: the two differ at most in the last bits of log, sin, cos and
    sqrt. 7 x 3 x 37 x 45 has rows of 4,995 elements: most rows start off
    the 16-byte grid and every row ends in a group of 3 (the scalar path)."""
    from primia_tpu_torch.ops import cuda_kernels

    x = torch.rand(shape, device=cuda_device).to(dtype)
    before = cuda_kernels.launches["gaussian_noise"]
    out = cuda_kernels.add_gaussian_noise(x, 77, 0.1)
    assert cuda_kernels.launches["gaussian_noise"] == before + 1
    assert out.shape == x.shape and out.dtype == dtype
    B, n = shape[0], x.numel() // shape[0]
    u = cuda_kernels.noise_uniforms(x, 77)
    for a, b in zip(u, cuda_kernels.noise_uniforms_plain(B, n, 77, cuda_device)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    want = cuda_kernels.add_gaussian_noise_plain(x, 77, 0.1).float()
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7 * float(want.abs().max())
    torch.testing.assert_close(out.float(), want, rtol=0, atol=tol)
    assert not torch.equal(out[0], out[1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [((16, 3, 64, 64), torch.float32),
                                         ((7, 3, 37, 45), torch.float32),
                                         ((5, 7, 13), torch.bfloat16)],
                         ids=["aligned", "unaligned", "bf16"])
def test_gaussian_noise_gives_the_same_bits_twice(cuda_device, shape, dtype):
    """Two calls with one seed give the same bits (the stream is a function
    of (seed, row, element), whatever thread takes an element); another
    seed does not."""
    from primia_tpu_torch.ops import cuda_kernels

    x = torch.rand(shape, device=cuda_device).to(dtype)
    a = cuda_kernels.add_gaussian_noise(x, 123, 0.1)
    assert torch.equal(a, cuda_kernels.add_gaussian_noise(x, 123, 0.1))
    assert not torch.equal(a, cuda_kernels.add_gaussian_noise(x, 124, 0.1))
    plan = cuda_kernels.card_plan(cuda_device, shape[0], x.numel() // shape[0])
    props = torch.cuda.get_device_properties(cuda_device)
    assert plan.grid <= props.multi_processor_count * 2048 // cuda_kernels.NOISE_THREADS


@pytest.mark.cuda
def test_opt_in_kernels_reject_bad_operands(cuda_device):
    from primia_tpu_torch.ops import cuda_bn, cuda_kernels, cuda_wgrad

    x = _bf16_cl((2, 12, 5, 5), cuda_device, 27)
    with pytest.raises(ValueError):
        cuda_wgrad.conv3x3_wgrad(x, x)  # 12 channels: not a multiple of 8
    with pytest.raises(ValueError):
        cuda_bn.channel_sums(x)
    with pytest.raises(ValueError):
        cuda_bn.channel_sums(_bf16_cl((2, 16, 5, 5), cuda_device, 28).float())
    x16 = _bf16_cl((2, 16, 5, 5), cuda_device, 28)
    v = torch.ones(16, device=cuda_device)
    with pytest.raises(ValueError):  # a vector off the 16-byte grid
        cuda_bn.bn_apply(x16, torch.ones(17, device=cuda_device)[1:], v)
    with pytest.raises(ValueError):  # one running statistic of two
        cuda_bn.bn_finalize(cuda_bn.channel_partials(x16), v, v, 50, 1e-5, v.clone(), None)
    with pytest.raises(RuntimeError):
        cuda_bn.bn_dx(x16, x16, v.cpu(), v, v)
    with pytest.raises(ValueError):
        cuda_kernels.add_gaussian_noise(torch.zeros(70000, 2, device=cuda_device), 1, 0.1)
    with pytest.raises(ValueError):
        cuda_kernels.add_gaussian_noise(torch.zeros(2, 2, device=cuda_device).double(), 1, 0.1)
