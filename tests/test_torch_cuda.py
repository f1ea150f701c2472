"""The port's CUDA kernels against their plain PyTorch versions on the
card, at edge shapes the AlexNet path does not reach (ragged tiles,
channel counts off the kernels' granules, nsize > C, every beta form,
bf16 LRN).

Marked ``cuda``: they skip without a CUDA device. This file imports
neither jax nor cxxnet_tpu, so it runs where the JAX package is not
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from cxxnet_tpu_torch.ops import conv as conv_ops
from cxxnet_tpu_torch.ops import lrn as lrn_ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape,nsize,beta,dtype", [
    ((2, 96, 27, 27), 5, 0.75, torch.float32),
    ((2, 70, 33, 31), 5, 0.75, torch.float32),    # C across 3 chunks
    ((3, 3, 4, 4), 5, 0.75, torch.float32),       # nsize > C
    ((2, 9, 7, 7), 4, 0.75, torch.float32),       # even window
    ((2, 9, 7, 7), 3, 0.5, torch.float32),
    ((2, 9, 7, 7), 3, 1.0, torch.float32),
    ((2, 9, 7, 7), 3, 1.5, torch.float32),
    ((2, 9, 7, 7), 3, 1.75, torch.float32),
    ((2, 9, 7, 7), 3, 2.0, torch.float32),
    ((2, 9, 7, 7), 5, 1.3, torch.float32),        # generic pow
    ((2, 40, 13, 13), 5, 0.75, torch.bfloat16),
])
def test_lrn_kernel_matches_plain(dev, shape, nsize, beta, dtype):
    g = torch.Generator(device=dev).manual_seed(1)
    x = (torch.randn(shape, generator=g, device=dev) * 4.0).to(dtype)
    before = lrn_ops.lrn.launches
    got = lrn_ops.lrn(x, nsize, 0.01, beta, 1.0)
    ref = lrn_ops.lrn_plain(x, nsize, 0.01, beta, 1.0)
    torch.cuda.synchronize()
    assert lrn_ops.lrn.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    # f32: rsqrt/pow ulps; bf16: one bf16 ulp at the final rounding
    rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    err = (got.float() - ref.float()).abs()
    assert bool((err <= rtol * ref.float().abs() + 1e-6).all()), \
        float(err.max())


def test_lrn_kernel_rejects_what_it_does_not_take(dev):
    x = torch.randn(2, 8, 5, 5, device=dev)
    with pytest.raises(ValueError):
        lrn_ops.lrn(x.transpose(2, 3), 5, 0.01, 0.75, 1.0)
    with pytest.raises(ValueError):
        lrn_ops.lrn(x.half(), 5, 0.01, 0.75, 1.0)
    with pytest.raises(ValueError):
        lrn_ops.lrn(x, lrn_ops.MAX_NSIZE + 1, 0.01, 0.75, 1.0)


@pytest.mark.parametrize("n,ci,h,w,co,k,pad,groups", [
    (2, 48, 57, 57, 96, 3, 0, 1),     # AlexNet conv1 (s2d packed)
    (2, 96, 27, 27, 256, 5, 2, 2),    # AlexNet conv2
    (1, 6, 9, 13, 10, 3, 1, 2),       # ci/g = 3, co/g = 5: padded to 8
    (3, 16, 5, 7, 200, 3, 1, 1),      # co over 4 channel tiles, ragged
    (1, 20, 11, 11, 8, 5, 0, 1),      # K = 25*24 not a multiple of 32
    (5, 8, 3, 3, 16, 3, 2, 1),        # M = 5*5*5 ragged, wide pad
])
def test_conv_kernel_matches_plain(dev, n, ci, h, w, co, k, pad, groups):
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(n, ci, h, w, generator=g, device=dev).to(torch.bfloat16)
    wt = (torch.randn(co, ci // groups, k, k, generator=g, device=dev)
          * 0.1).to(torch.bfloat16)
    before = conv_ops.conv.launches
    got = conv_ops.conv(x, wt, 1, (pad, pad), groups)
    ref = conv_ops.conv_plain(x, wt, 1, (pad, pad), groups)
    torch.cuda.synchronize()
    assert conv_ops.conv.launches == before + 1
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    # the same f32 sums in another order, each rounded once to bf16
    rf = ref.float()
    err = (got.float() - rf).abs()
    tol = 2.0 ** -7 * rf.abs() + 2.0 ** -10 * rf.abs().max()
    assert bool((err <= tol).all()), float(err.max())


def test_conv_kernel_rejects_what_it_does_not_take(dev):
    x = torch.randn(1, 4, 6, 6, device=dev)
    w = torch.randn(8, 4, 3, 3, device=dev)
    with pytest.raises(ValueError):
        conv_ops.conv(x, w)          # float32 operands
    with pytest.raises(ValueError):
        conv_ops.conv(x.bfloat16(), w.bfloat16(), stride=2)
