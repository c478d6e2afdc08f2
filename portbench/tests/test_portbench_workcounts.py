"""The benchmark's work counts against figures worked out by hand."""

import pytest

from portbench import harness, workcounts
from portbench.reference import resnet

CFG = {name: harness.load_json(harness.HERE / "configs" / f"{name}.json")
       for name in ("resnet18_cifar10", "resnet50_imagenet")}


def test_parameter_counts_are_the_published_ones():
    # kuangliu's ResNet18() with 10 classes; torchvision's resnet50().
    assert resnet.parameter_count(CFG["resnet18_cifar10"]) == CFG["resnet18_cifar10"]["parameters"] == 11_173_962
    assert resnet.parameter_count(CFG["resnet50_imagenet"]) == CFG["resnet50_imagenet"]["parameters"] == 25_557_032


def test_multiply_adds():
    # ResNet-18-CIFAR: about 0.56 GMAC; ResNet-50 @224: about 4.1 GMAC.
    assert workcounts.model_macs(CFG["resnet18_cifar10"]) == pytest.approx(0.556e9, rel=0.01)
    assert workcounts.model_macs(CFG["resnet50_imagenet"]) == pytest.approx(4.09e9, rel=0.01)
    assert workcounts.model_flops(CFG["resnet50_imagenet"]) == 2 * workcounts.model_macs(CFG["resnet50_imagenet"])


def test_stem_by_hand():
    layers = resnet.layer_shapes(CFG["resnet50_imagenet"])
    assert layers[0] == dict(name="conv_init", cin=3, cout=64, k=7, h=112, w=112)
    assert layers[-1] == dict(name="head", cin=2048, cout=1000, k=1, h=1, w=1)
    assert resnet.tap_shape(CFG["resnet50_imagenet"]) == (7, 7, 2048)
    assert resnet.tap_shape(CFG["resnet18_cifar10"]) == (4, 4, 512)
    for name, cfg in CFG.items():
        assert tuple(cfg["larex"]["tap_shape"]) == resnet.tap_shape(cfg), name


def test_entropy_stage_bound():
    # RN18 at batch 512: bf16 tap 512*16*512*2, keep-weights 512*16*16*4,
    # entropies 512*512*4 bytes; 2*512*16*16*512 operations.
    bound = workcounts.entropy_stage(CFG["resnet18_cifar10"], 512)
    assert bound["bytes"] == 512 * 16 * 512 * 2 + 512 * 16 * 16 * 4 + 512 * 512 * 4
    assert bound["flops"] == 2 * 512 * 16 * 16 * 512
    assert bound["bound_by"] == "bytes"
    assert bound["bound_s"] == pytest.approx(bound["bytes"] / 3.35e12)


def test_kde_and_peaks():
    assert workcounts.kde_flops(50_000, 256, 512) == 2 * 512 * 50_000 * 256 + 512 * 50_000
    assert (workcounts.PEAK_BF16_FLOPS, workcounts.PEAK_F32_FLOPS, workcounts.PEAK_HBM_BYTES) == (989e12, 67e12,
                                                                                                 3.35e12)
    assert workcounts.roofline_s(0.0, 67e12, workcounts.PEAK_F32_FLOPS)["bound_s"] == pytest.approx(1.0)
