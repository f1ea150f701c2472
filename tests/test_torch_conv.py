"""The port's conv (cxxnet_tpu_torch/ops/conv.py) against the JAX
package's Pallas row-im2col conv (cxxnet_tpu/ops/conv_pallas.py) run in
interpret mode on the CPU.

On the CPU the port's wrapper runs the kernel's plain PyTorch version;
tests/test_torch_cuda.py holds the CUDA kernel against it on the card.
What the kernel adds around that arithmetic — the operand layouts the
wrapper packs and the kernel's address arithmetic — is emulated here
step for step and held against the plain version too.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cxxnet_tpu.ops.conv_pallas import conv_pallas
from cxxnet_tpu_torch import layers as TL
from cxxnet_tpu_torch.ops import conv as conv_ops

CASES = [
    # n, ci, h, w, co, k, pad, groups, dtype
    (2, 8, 9, 9, 16, 3, 0, 1, torch.bfloat16),
    (2, 8, 9, 11, 16, 3, 1, 1, torch.bfloat16),     # ragged OW = 11
    (2, 8, 7, 7, 16, 5, 2, 2, torch.bfloat16),      # AlexNet conv2 form
    (1, 12, 6, 13, 8, 3, 1, 2, torch.bfloat16),     # ci/g = 6, ragged
    (2, 4, 9, 9, 8, 5, 0, 1, torch.float32),
    (1, 6, 8, 8, 6, 3, 2, 3, torch.float32),        # pad 2 < k 3
]


def _operands(n, ci, h, w, co, k, groups, dtype, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0.0, 1.0, (n, ci, h, w)).astype(
        np.float32)).to(dtype)
    wt = torch.from_numpy(rng.normal(0.0, 0.2, (co, ci // groups, k, k))
                          .astype(np.float32)).to(dtype)
    return x, wt


def _close(got: torch.Tensor, ref: np.ndarray, dtype) -> None:
    """bf16: the same f32 sums in another order, each rounded once to
    bf16 — one bf16 ulp, plus order noise near zero; f32: order noise."""
    g = got.float().numpy()
    if dtype == torch.bfloat16:
        tol = 2.0 ** -7 * np.abs(ref) + 2.0 ** -10 * np.abs(ref).max()
    else:
        tol = 1e-5 * np.abs(ref) + 1e-6 * np.abs(ref).max()
    assert (np.abs(g - ref) <= tol).all(), np.abs(g - ref).max()


@pytest.mark.parametrize("n,ci,h,w,co,k,pad,groups,dtype", CASES)
def test_conv_matches_pallas(n, ci, h, w, co, k, pad, groups, dtype):
    x, wt = _operands(n, ci, h, w, co, k, groups, dtype, seed=ci + co + k)
    got = conv_ops.conv(x, wt, 1, (pad, pad), groups)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = conv_pallas(jnp.asarray(x.float().numpy()).astype(jdt),
                      jnp.asarray(wt.float().numpy()).astype(jdt),
                      1, (pad, pad), groups, True)
    assert got.dtype == dtype
    assert tuple(got.shape) == tuple(ref.shape)
    _close(got, np.asarray(ref.astype(jnp.float32)), dtype)


def _emulate_kernel(x, wt, pad, groups):
    """csrc/conv.cu's GEMM on the CPU: the wrapper's packed operands,
    the kernel's (dy, dx, ci) reduction order and its linear addresses
    into the padded NHWC input and the NCHW output."""
    n, _, h, w = x.shape
    co, _, kh, kw = wt.shape
    xp, wb, cigp, cogp = conv_ops.pack_operands(x, wt, pad, groups)
    _, hp, wp, ctot = xp.shape
    oh, ow = hp - kh + 1, wp - kw + 1
    cog = co // groups
    m = torch.arange(n * oh * ow)
    nn, rem = m // (oh * ow), m % (oh * ow)
    yy, xx = rem // ow, rem % ow
    k = torch.arange(kh * kw * cigp)
    tap, ci = k // cigp, k % cigp
    dy, dx = tap // kw, tap % kw
    flat_x = xp.reshape(-1).float()
    out = torch.zeros(n * co * oh * ow)
    for g in range(groups):
        a_base = ((nn * hp + yy) * wp + xx) * ctot + g * cigp
        koff = (dy * wp + dx) * ctot + ci
        a = flat_x[a_base[:, None] + koff[None, :]]
        prod = (a @ wb[g].float())[:, :cog]
        co_idx = torch.arange(cog)
        addr = ((nn[:, None] * co + g * cog + co_idx[None, :]) * (oh * ow)
                + rem[:, None])
        out[addr.reshape(-1)] = prod.reshape(-1)
    return out.reshape(n, co, oh, ow).to(x.dtype)


@pytest.mark.parametrize("n,ci,h,w,co,k,pad,groups,dtype", CASES[:4])
def test_kernel_operand_layouts_and_addressing(n, ci, h, w, co, k, pad,
                                               groups, dtype):
    x, wt = _operands(n, ci, h, w, co, k, groups, dtype, seed=7)
    emulated = _emulate_kernel(x, wt, (pad, pad), groups)
    ref = conv_ops.conv_plain(x, wt, 1, (pad, pad), groups)
    _close(emulated, ref.float().numpy(), dtype)


def test_conv_rejects_what_pallas_rejects():
    x, wt = _operands(1, 4, 8, 8, 4, 3, 1, torch.bfloat16, seed=0)
    with pytest.raises(ValueError, match="stride 1"):
        conv_ops.conv(x, wt, stride=2)
    with pytest.raises(ValueError, match="pad < kernel"):
        conv_ops.conv(x, wt, pad=(3, 0))
    with pytest.raises(ValueError, match="groups"):
        conv_ops.conv(x, wt, groups=3)


def test_conv_cpu_tensor_runs_the_plain_version_and_counts_nothing():
    x, wt = _operands(1, 4, 6, 6, 4, 3, 1, torch.bfloat16, seed=1)
    before = conv_ops.conv.launches
    assert torch.equal(conv_ops.conv(x, wt, pad=(1, 1)),
                       conv_ops.conv_plain(x, wt, pad=(1, 1)))
    assert conv_ops.conv.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        conv_ops.conv(x.to("meta"), wt.to("meta"))


@pytest.mark.parametrize("impl", ["xla", "nhwc", "split"])
def test_conv_layer_xla_lowerings_are_not_ported(impl):
    with pytest.raises(NotImplementedError):
        TL.create_layer("conv", [("conv_impl", impl)])
