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


# ----------------------------------------------------------------------
# the backward: ConvFunction (dx through kernel #4 on the cotangent, dw
# through kernel #5 on the card; their plain versions here) against
# jax.vjp of conv_pallas's custom_vjp

@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("pad", [0, 1, 2])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv_vjp_matches_pallas(groups, pad, dtype):
    import jax
    n, ci, h, w, co, k = 2, 8, 7, 7, 12, 3
    x, wt = _operands(n, ci, h, w, co, k, groups, dtype,
                      seed=10 * groups + pad)
    oh = h + 2 * pad - k + 1
    g = torch.from_numpy(np.random.default_rng(pad).normal(
        0.0, 1.0, (n, co, oh, oh)).astype(np.float32)).to(dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def jconv(a, b):
        return conv_pallas(a, b, 1, (pad, pad), groups, True)
    _, vjp = jax.vjp(jconv, jnp.asarray(x.float().numpy()).astype(jdt),
                     jnp.asarray(wt.float().numpy()).astype(jdt))
    dx_j, dw_j = vjp(jnp.asarray(g.float().numpy()).astype(jdt))
    xr, wr = x.clone().requires_grad_(True), wt.clone().requires_grad_(True)
    out = conv_ops.ConvFunction.apply(xr, wr, (pad, pad), groups, False)
    dx, dw = torch.autograd.grad(out, (xr, wr), g)
    assert dx.dtype == dtype and dw.dtype == dtype
    _close(dx, np.asarray(dx_j.astype(jnp.float32)), dtype)
    _close(dw, np.asarray(dw_j.astype(jnp.float32)), dtype)


def test_conv_function_takes_no_dx_for_an_input_without_grad():
    x, wt = _operands(1, 4, 6, 6, 8, 3, 1, torch.float32, seed=3)
    w = wt.clone().requires_grad_(True)
    out = conv_ops.conv_layer(x, w, 1, (1, 1), 1)
    dw, = torch.autograd.grad(out.sum(), w)
    assert dw.shape == w.shape
    with torch.no_grad():
        assert conv_ops.conv_layer(x, w, 1, (1, 1), 1).grad_fn is None


def _emulate_wgrad(x, g, kh, kw, pad, groups):
    """csrc/conv_wgrad.cu on the CPU: the wrapper's packed input and
    cotangent, the kernel's linear addresses into them, its split of the
    M reduction summed in split order, and the wrapper's unpack."""
    n, c, h, w = x.shape
    co = g.shape[1]
    xp, cigp = conv_ops._pack_input(x, c // groups, pad, groups)
    gp, cogp = conv_ops.pack_cotangent(g, groups)
    _, hp, wp, ctot = xp.shape
    oh, ow = g.shape[2], g.shape[3]
    m_total, k_total = n * oh * ow, kh * kw * cigp
    splits = conv_ops.wgrad_splits(m_total, k_total, cogp, groups, 128, 64)
    per = -(-(-(-m_total // splits)) // 32) * 32
    m = torch.arange(m_total)
    nn, rem = m // (oh * ow), m % (oh * ow)
    yy, xx = rem // ow, rem % ow
    k = torch.arange(k_total)
    tap, ci = k // cigp, k % cigp
    dy, dx = tap // kw, tap % kw
    flat_x = xp.reshape(-1).float()
    dwp = torch.zeros(groups, k_total, cogp)
    for gi in range(groups):
        a = flat_x[(((nn * hp + yy) * wp + xx) * ctot)[:, None]
                   + ((dy * wp + dx) * ctot + gi * cigp + ci)[None, :]]
        gg = gp[:, gi * cogp:(gi + 1) * cogp].float()
        acc = None
        for s in range(splits):
            part = a[s * per:(s + 1) * per].t() @ gg[s * per:(s + 1) * per]
            acc = part if acc is None else acc + part
        dwp[gi] = acc
    return conv_ops.unpack_wgrad(dwp.to(x.dtype), co, c // groups, kh, kw,
                                 groups)


@pytest.mark.parametrize("n,ci,h,w,co,k,pad,groups,dtype", CASES[:4])
def test_wgrad_kernel_layouts_and_addressing(n, ci, h, w, co, k, pad,
                                             groups, dtype):
    x, _ = _operands(n, ci, h, w, co, k, groups, dtype, seed=11)
    oh, ow = h + 2 * pad - k + 1, w + 2 * pad - k + 1
    g = torch.from_numpy(np.random.default_rng(12).normal(
        0.0, 1.0, (n, co, oh, ow)).astype(np.float32)).to(dtype)
    emulated = _emulate_wgrad(x, g, k, k, (pad, pad), groups)
    ref = conv_ops.conv_wgrad_plain(x, g, k, k, (pad, pad), groups)
    _close(emulated, ref.float().numpy(), dtype)


@pytest.mark.parametrize("n,ci,h,w,co,k,pad,groups,dtype", CASES[:4])
def test_dgrad_kernel_operands_and_addressing(n, ci, h, w, co, k, pad,
                                              groups, dtype):
    """conv_dgrad packs the cotangent and the flipped kernel for kernel
    #4; its address arithmetic on those operands gives the plain dx."""
    _, wt = _operands(n, ci, h, w, co, k, groups, dtype, seed=13)
    oh, ow = h + 2 * pad - k + 1, w + 2 * pad - k + 1
    g = torch.from_numpy(np.random.default_rng(14).normal(
        0.0, 1.0, (n, co, oh, ow)).astype(np.float32)).to(dtype)
    wflip, p = conv_ops._dgrad_operands(wt, (pad, pad), groups)
    emulated = _emulate_kernel(g, wflip, p, groups)
    ref = conv_ops.conv_dgrad_plain(g, wt, (pad, pad), groups)
    assert emulated.shape == (n, ci, h, w)
    _close(emulated, ref.float().numpy(), dtype)
