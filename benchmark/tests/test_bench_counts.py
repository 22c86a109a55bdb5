"""The benchmark's frozen counts against published totals and plain
arithmetic."""

import pytest
import torch

from benchmark import common, counts


def arch(name):
    return common.load_json(common.BENCH_DIR / "configs" / f"{name}.json")["architecture"]


def test_resnet18_macs_match_the_published_total():
    conv, fc = counts.layer_macs(arch("resnet18"), num_classes=1000)
    # He et al. 2015, table 1: 1.8 x 10^9 FLOPs (multiply-adds) at 224 px
    assert conv + fc == pytest.approx(1.82e9, rel=0.01)
    assert fc == 512 * 1000


def test_vgg16_conv_macs_match_the_published_total():
    conv, _ = counts.layer_macs(arch("vgg16"))
    # the 13 convolutions of configuration D at 224 px: 15.3-15.5 G MACs
    assert conv == pytest.approx(15.35e9, rel=0.01)


@pytest.mark.parametrize("name", ["resnet18", "vgg16"])
def test_counts_take_the_configurations_own_head(name):
    a = arch(name)
    conv, lin = counts.layer_macs(a)
    conv1000, lin1000 = counts.layer_macs(a, num_classes=1000)
    assert conv == conv1000 and lin < lin1000
    assert counts.train_flops_per_image(a) == 6 * (conv + lin)
    assert counts.encrypted_int8_ops_per_image(a) == (conv + lin) * 6 * 36 * 2


def test_limb_products_are_the_pairs_below_eight_bytes():
    assert counts.LIMB_PRODUCTS == sum(1 for i in range(8) for j in range(8) if i + j < 8)


def test_k1_bytes_read_and_write_each_byte_once():
    assert counts.k1_bytes((600, 224, 224), (200, 224, 224)) == 4 * (2 * 600 + 200) * 224 * 224


def test_k4_operations_follow_the_bit_length_of_alpha_xor_x():
    alpha = torch.tensor([5, 0, (1 << 31) - 1, 7, 7], dtype=torch.int32)
    x = torch.tensor([5, 0, 0, 6, 8], dtype=torch.int32)
    past = sum(max((a ^ b).bit_length() - 1, 0) for a, b in zip(alpha.tolist(), x.tolist()))
    want = 5 * counts.DCF_LEVELS * counts.DCF_KEY_OPS_PER_LEVEL \
        + past * counts.DCF_EVAL_OPS_PER_LEVEL
    assert counts.dcf_int32_ops(alpha, x) == want


def test_k4_least_time_is_the_larger_bound():
    n = 802_816
    ops = n * counts.DCF_LEVELS * counts.DCF_KEY_OPS_PER_LEVEL
    assert counts.dcf_least_seconds(n, ops) == ops / counts.PEAK_INT32_OPS
    assert counts.dcf_least_seconds(n, 0) == n * 60 / counts.PEAK_HBM_BYTES_PER_S


def test_peaks_are_the_data_sheets():
    assert counts.PEAK_INT32_OPS == 132 * 64 * 1.98e9
    assert (counts.PEAK_BF16_FLOPS, counts.PEAK_INT8_OPS) == (989e12, 1979e12)
