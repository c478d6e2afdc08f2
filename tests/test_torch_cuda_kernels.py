"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA Hopper GPU and skip elsewhere. They import no JAX,
so on a machine without it they run with the repository's conftest left out:

    python -m pytest --noconftest -m requires_cuda tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from runia_core_tpu_torch.ops.entropy_cuda import marginal_entropy_cuda, marginal_entropy_plain
from runia_core_tpu_torch.ops.mc_entropy_cuda import (
    fused_mc_entropy,
    fused_mc_entropy_plain,
    mc_dropblock_weights,
)

pytestmark = pytest.mark.requires_cuda

# Kernel 1 selects the same f32 differences as the sorted-window plain
# version; only the order of the final sum differs.
ENTROPY_ATOL = 1e-5


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("b,n,d,k", [
    (512, 16, 512, 5), (3, 4, 300, 3), (1, 16, 1, 5), (7, 64, 130, 15), (5, 2, 129, 1), (9, 32, 64, 8),
])
def test_marginal_entropy_kernel_matches_plain(gen, b, n, d, k):
    clouds = torch.randn((b, n, d), generator=gen, device="cuda")
    clouds[:, : n // 2, : d // 2] = 0.0  # exact duplicates, as DropBlock makes
    before = marginal_entropy_cuda.launches
    got = marginal_entropy_cuda(clouds, k)
    torch.cuda.synchronize()
    assert marginal_entropy_cuda.launches == before + 1
    torch.testing.assert_close(got, marginal_entropy_plain(clouds, k), rtol=0, atol=ENTROPY_ATOL)


def test_marginal_entropy_kernel_integer_ties(gen):
    clouds = torch.randint(-2, 3, (64, 16, 256), generator=gen, device="cuda").float()
    torch.testing.assert_close(
        marginal_entropy_cuda(clouds, 5), marginal_entropy_plain(clouds, 5), rtol=0, atol=ENTROPY_ATOL
    )


@pytest.mark.parametrize("b,h,w,c,s,bs,p", [
    (512, 4, 4, 512, 16, 3, 0.5), (8, 7, 7, 2048, 16, 3, 0.5), (3, 8, 8, 130, 8, 2, 0.3),
    (2, 14, 14, 64, 64, 5, 0.5),  # 64 x 196 keep-weights: above 48 KB of shared memory
])
def test_fused_kernel_matches_plain(gen, b, h, w, c, s, bs, p):
    fmap = torch.rand((b, h, w, c), generator=gen, device="cuda")
    weights = mc_dropblock_weights(b, h, w, s, bs, p, gen, "cuda")
    before = fused_mc_entropy.launches
    got = fused_mc_entropy(weights, fmap)
    torch.cuda.synchronize()
    assert fused_mc_entropy.launches == before + 1
    # The bound of tests/test_mc_entropy_fused.py: the products sum in another order.
    torch.testing.assert_close(got, fused_mc_entropy_plain(weights, fmap), rtol=1e-4, atol=1e-5)


def test_wrappers_raise_on_inputs_the_kernels_do_not_take(gen):
    clouds = torch.randn((4, 16, 32), generator=gen, device="cuda")
    for bad, k in ((clouds.transpose(1, 2), 5), (clouds.double(), 5), (clouds, 16), (clouds, 0)):
        with pytest.raises(ValueError):
            marginal_entropy_cuda(bad, k)
    fmap = torch.rand((4, 4, 4, 32), generator=gen, device="cuda")
    weights = mc_dropblock_weights(4, 4, 4, 16, 3, 0.5, gen, "cuda")
    with pytest.raises(ValueError):
        fused_mc_entropy(weights[:, :, :8].contiguous(), fmap)
    with pytest.raises(ValueError):
        fused_mc_entropy(weights, fmap.permute(0, 2, 1, 3))
