"""Stride-1 grouped convolution forward: the CUDA kernel's wrapper and its
plain PyTorch version — the port's counterpart of
``cxxnet_tpu/ops/conv_pallas.py``.

Operand contract as ``conv_pallas``: NCHW input x OIHW kernel -> NCHW,
stride 1, pad < kernel, ``groups`` independent channel groups; operands
in the net's compute dtype, products accumulated in float32, the output
rounded once to the operand dtype (conv_pallas.py:143), which the conv
layer then casts to float32.

:func:`conv` launches ``csrc/conv.cu`` (bf16 operands only) on CUDA
tensors and runs :func:`conv_plain` on CPU tensors; nothing else decides
between them. The wrapper's only tensor prep is the plain NCHW -> padded
NHWC transpose of the input and the (g, kh*kw*ci, co) arrangement of the
kernel, each group's channel count padded to a multiple of 8 (the
kernel's 16-byte loads); the W-unfold and tile padding the TPU kernel
needed are gone. Only the inference forward is here; dx and dw come
with the training slice.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import build


# cxx_conv_fwd(xp, wb, out, n, hp, wp, ctot, cigp, oh, ow, kh, kw, cog,
#              cogp, groups, stream)
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 12 + [ctypes.c_void_p]


def _rup(x: int, m: int) -> int:
    return -(-x // m) * m


def _check(x: torch.Tensor, w: torch.Tensor, stride: int,
           pad: Tuple[int, int], groups: int) -> None:
    """The operand contract both versions enforce (conv_pallas.py:203-214
    plus the shape rules the layer guarantees)."""
    if stride != 1:
        raise ValueError(
            "conv_impl=pallas supports stride 1 only (every AlexNet mid "
            "conv; conv1 becomes stride 1 under space_to_depth)")
    kh, kw = w.shape[2], w.shape[3]
    if pad[0] >= kh or pad[1] >= kw:
        raise ValueError(
            "conv_impl=pallas needs pad < kernel_size (got pad %s for "
            "kernel %dx%d)" % (tuple(pad), kh, kw))
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError("conv takes NCHW x OIHW, got %s x %s"
                         % (tuple(x.shape), tuple(w.shape)))
    c, co = x.shape[1], w.shape[0]
    if c % groups or co % groups or w.shape[1] != c // groups:
        raise ValueError("conv: %d input / %d output channels do not split "
                         "into %d groups of kernel %s"
                         % (c, co, groups, tuple(w.shape)))


def conv_plain(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
               pad: Tuple[int, int] = (0, 0), groups: int = 1
               ) -> torch.Tensor:
    """The plain PyTorch version of the kernel, in the row-im2col form of
    conv_pallas: W-unfold the padded NHWC input per group, then one
    float32 matmul per kernel row ``dy`` accumulating in float32, then
    round to ``x.dtype``. Any device."""
    _check(x, w, stride, pad, groups)
    n, c, h, wd = x.shape
    co, cig, kh, kw = w.shape
    py, px = pad
    oh = h + 2 * py - kh + 1
    ow = wd + 2 * px - kw + 1
    cog = co // groups
    xt = F.pad(x.permute(0, 2, 3, 1), (0, 0, px, px, py, py))
    outs = []
    for gi in range(groups):
        xg = xt[..., gi * cig:(gi + 1) * cig]
        # xf[n, y, x, dx*cig + ci] = xt[n, y, x+dx, ci]
        xf = torch.cat([xg[:, :, dx:dx + ow, :] for dx in range(kw)], -1)
        wr = w[gi * cog:(gi + 1) * cog].permute(2, 3, 1, 0).reshape(
            kh, kw * cig, cog).float()
        acc = None
        for dy in range(kh):
            patch = xf[:, dy:dy + oh].reshape(n * oh * ow, kw * cig)
            part = torch.matmul(patch.float(), wr[dy])
            acc = part if acc is None else acc + part
        outs.append(acc.reshape(n, oh, ow, cog))
    out = outs[0] if groups == 1 else torch.cat(outs, -1)
    return out.to(x.dtype).permute(0, 3, 1, 2).contiguous()


def pack_operands(x: torch.Tensor, w: torch.Tensor,
                  pad: Tuple[int, int], groups: int):
    """The kernel's operand layouts: (xp, wb, cigp, cogp) with xp the
    zero-padded NHWC input (N, H+2py, W+2px, groups*cigp) and wb the
    kernel as (groups, kh*kw*cigp, cogp), k ordered (dy, dx, ci); each
    group's channels zero-padded to cigp/cogp, multiples of 8."""
    n, c, h, wd = x.shape
    co, cig, kh, kw = w.shape
    cog = co // groups
    cigp, cogp = _rup(cig, 8), _rup(cog, 8)
    xt = x.permute(0, 2, 3, 1)
    if cigp != cig:
        xt = F.pad(xt.reshape(n, h, wd, groups, cig),
                   (0, cigp - cig)).reshape(n, h, wd, groups * cigp)
    py, px = pad
    xp = F.pad(xt, (0, 0, px, px, py, py)).contiguous()
    wr = w.reshape(groups, cog, cig, kh, kw).permute(0, 3, 4, 2, 1)
    wb = F.pad(wr, (0, cogp - cog, 0, cigp - cig)).reshape(
        groups, kh * kw * cigp, cogp).contiguous()
    return xp, wb, cigp, cogp


def conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
         pad: Tuple[int, int] = (0, 0), groups: int = 1) -> torch.Tensor:
    """Grouped 2D convolution, NCHW x OIHW -> NCHW in ``x.dtype``, stride
    1 only. A CPU tensor runs :func:`conv_plain`; a CUDA tensor launches
    the kernel (bf16 operands; ``conv.launches`` counts the launches) or
    raises."""
    _check(x, w, stride, pad, groups)
    if x.device.type == "cpu":
        return conv_plain(x, w, stride, pad, groups)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError("conv: no kernel for devices %s x %s"
                         % (x.device, w.device))
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError("conv kernel takes bfloat16 operands (dtype = "
                         "bfloat16), got %s x %s" % (x.dtype, w.dtype))
    n, _, h, wd = x.shape
    co, _, kh, kw = w.shape
    oh = h + 2 * pad[0] - kh + 1
    ow = wd + 2 * pad[1] - kw + 1
    out = torch.empty((n, co, oh, ow), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    xp, wb, cigp, cogp = pack_operands(x, w, pad, groups)
    launch(xp, wb, out, kh, kw, cigp, cogp, groups)
    return out


def launch(xp: torch.Tensor, wb: torch.Tensor, out: torch.Tensor, kh: int,
           kw: int, cigp: int, cogp: int, groups: int) -> None:
    """Launch the kernel on operands from :func:`pack_operands` into the
    preallocated NCHW ``out``."""
    n, hp, wp, ctot = xp.shape
    _, co, oh, ow = out.shape
    fn = build.function("conv", "cxx_conv_fwd", _ARGTYPES)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = fn(xp.data_ptr(), wb.data_ptr(), out.data_ptr(), n, hp, wp,
                 ctot, cigp, oh, ow, kh, kw, co // groups, cogp, groups,
                 stream)
    build.check("conv", err, "conv_fwd")
    conv.launches += 1


conv.launches = 0
