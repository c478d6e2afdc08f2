"""The port's torchvision converter (models/torch_convert.py::
convert_torch_resnet) against an eval-mode torch ResNet and against the JAX
package's converter on the same state_dict.

torchvision is not installed, so the reference nets are written here in
plain torch with torchvision's module layout (``conv1``, ``bn1``,
``layer{i}.{j}.conv{k}`` / ``bn{k}`` / ``downsample``, ``fc``), as
tests/test_torch_convert.py (the JAX converter's own test) builds its
ResNet-18. Batch-norm running statistics are moved off (0, 1) by three
training passes. Tolerances: logits against torch atol 2e-4, rtol 1e-3 (the
JAX test's bar); against the JAX converter's flax model 1e-4 of the largest
logit (both f32, convolutions summed in other orders).
"""

import numpy as np
import pytest
import torch
import torch.nn as tnn

import jax.numpy as jnp

from runia_core_tpu.models import convert_torch_resnet as jax_convert_torch_resnet
from runia_core_tpu_torch.models import build_tapped_forward, convert_torch_resnet, stem_to_s2d
from runia_core_tpu_torch.models.resnet import BottleneckResNetBlock, ResNet

torch.set_num_threads(1)


class BasicBlock(tnn.Module):
    expansion = 1

    def __init__(self, cin, width, stride=1):
        super().__init__()
        self.conv1 = tnn.Conv2d(cin, width, 3, stride, 1, bias=False)
        self.bn1 = tnn.BatchNorm2d(width)
        self.conv2 = tnn.Conv2d(width, width, 3, 1, 1, bias=False)
        self.bn2 = tnn.BatchNorm2d(width)
        self.downsample = None
        if stride != 1 or cin != width:
            self.downsample = tnn.Sequential(tnn.Conv2d(cin, width, 1, stride, bias=False), tnn.BatchNorm2d(width))

    def forward(self, x):
        out = self.bn2(self.conv2(torch.relu(self.bn1(self.conv1(x)))))
        return torch.relu(out + (x if self.downsample is None else self.downsample(x)))


class Bottleneck(tnn.Module):
    expansion = 4

    def __init__(self, cin, width, stride=1):
        super().__init__()
        self.conv1 = tnn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = tnn.BatchNorm2d(width)
        self.conv2 = tnn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = tnn.BatchNorm2d(width)
        self.conv3 = tnn.Conv2d(width, 4 * width, 1, bias=False)
        self.bn3 = tnn.BatchNorm2d(4 * width)
        self.downsample = None
        if stride != 1 or cin != 4 * width:
            self.downsample = tnn.Sequential(tnn.Conv2d(cin, 4 * width, 1, stride, bias=False),
                                             tnn.BatchNorm2d(4 * width))

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return torch.relu(out + (x if self.downsample is None else self.downsample(x)))


class TorchResNet(tnn.Module):
    def __init__(self, block, stage_sizes, num_classes=10, width=16):
        super().__init__()
        self.conv1 = tnn.Conv2d(3, width, 7, 2, 3, bias=False)
        self.bn1 = tnn.BatchNorm2d(width)
        self.maxpool = tnn.MaxPool2d(3, 2, 1)
        cin = width
        for i, size in enumerate(stage_sizes):
            blocks = []
            for j in range(size):
                blocks.append(block(cin, width * 2**i, 2 if i > 0 and j == 0 else 1))
                cin = width * 2**i * block.expansion
            setattr(self, f"layer{i + 1}", tnn.Sequential(*blocks))
        self.fc = tnn.Linear(cin, num_classes)

    def forward(self, x):
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        for i in range(4):
            x = getattr(self, f"layer{i + 1}")(x)
        return self.fc(x.mean(dim=(2, 3)))


NETS = {"resnet18": (BasicBlock, (2, 2, 2, 2), 16), "resnet34": (BasicBlock, (3, 4, 6, 3), 8),
        "resnet50": (Bottleneck, (3, 4, 6, 3), 8)}


@pytest.fixture(scope="module")
def nets():
    out = {}
    for arch, (block, sizes, width) in NETS.items():
        torch.manual_seed(0)
        net = TorchResNet(block, sizes, width=width)
        with torch.no_grad():
            net.train()
            for _ in range(3):
                net(torch.randn(4, 3, 64, 64))
        out[arch] = net.eval()
    return out


def _images(seed, n=2):
    return np.random.RandomState(seed).rand(n, 64, 64, 3).astype(np.float32)


def _torch_logits(net, x):
    with torch.no_grad():
        return net(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_logits_match_torch_and_the_jax_converter(nets, arch):
    sd = nets[arch].state_dict()
    model = convert_torch_resnet(sd, device="cpu")
    assert isinstance(model, ResNet) and model.torch_padding and not model.training
    assert (model.block_cls is BottleneckResNetBlock) == (arch == "resnet50")
    x = _images(0)
    logits, taps = build_tapped_forward(model, ("pre_pool", "penultimate"))(torch.from_numpy(x))
    np.testing.assert_allclose(logits.numpy(), _torch_logits(nets[arch], x), atol=2e-4, rtol=1e-3)
    jax_model, variables = jax_convert_torch_resnet(sd)
    want_logits, want_taps = jax_model.apply(variables, jnp.asarray(x), train=False)
    for got, want in ((logits, want_logits), (taps["pre_pool"], want_taps["pre_pool"])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("arch", sorted(NETS))
def test_arch_is_inferred_from_the_keys(nets, arch):
    model = convert_torch_resnet(nets[arch].state_dict(), device="cpu")
    assert model.stage_sizes == NETS[arch][1]
    assert model.head.weight.shape[0] == 10 and model.conv_init.weight.shape[0] == NETS[arch][2]


def test_module_prefix_is_stripped(nets):
    sd = {f"module.{k}": v for k, v in nets["resnet18"].state_dict().items()}
    x = _images(1, 1)
    logits, _ = convert_torch_resnet(sd, arch="resnet18", device="cpu")(torch.from_numpy(x))
    np.testing.assert_allclose(logits.detach().numpy(), _torch_logits(nets["resnet18"], x), atol=2e-4, rtol=1e-3)


def test_numpy_state_dict_and_bf16_compute(nets):
    sd = {k: v.numpy() for k, v in nets["resnet18"].state_dict().items()}
    model = convert_torch_resnet(sd, dtype=torch.bfloat16, device="cpu")
    assert model.conv_init.weight.dtype == torch.float32 and model.dtype == torch.bfloat16
    logits, _ = build_tapped_forward(model)(torch.from_numpy(_images(2)))
    assert logits.dtype == torch.bfloat16 and bool(torch.isfinite(logits).all())


def test_unknown_arch_is_refused(nets):
    with pytest.raises(ValueError, match="unknown arch"):
        convert_torch_resnet(nets["resnet18"].state_dict(), arch="resnet99", device="cpu")


def test_s2d_stem_on_a_converted_checkpoint_matches_torch(nets):
    model = convert_torch_resnet(nets["resnet18"].state_dict(), device="cpu")
    s2d = ResNet(model.stage_sizes, model.block_cls, 10, num_filters=16, torch_padding=True, s2d_stem=True,
                 device="cpu")
    s2d.load_state_dict(stem_to_s2d(model.state_dict()))
    x = _images(3)
    logits, _ = build_tapped_forward(s2d)(torch.from_numpy(x))
    np.testing.assert_allclose(logits.numpy(), _torch_logits(nets["resnet18"], x), atol=2e-4, rtol=1e-3)
