"""Stride-1 grouped convolution, forward and backward: the CUDA kernels'
wrappers, their plain PyTorch versions and the autograd Function that
joins them — the port's counterpart of ``cxxnet_tpu/ops/conv_pallas.py``.

Operand contract as ``conv_pallas``: NCHW input x OIHW kernel -> NCHW,
stride 1, pad < kernel, ``groups`` independent channel groups; operands
in the net's compute dtype, products accumulated in float32, each result
rounded once to the operand dtype (conv_pallas.py:143, 257), which the
conv layer then casts to float32.

Three wrappers, each with its launch count, over two kernels:

* :func:`conv` — the forward, ``csrc/conv.cu`` (kernel #4);
* :func:`conv_dgrad` — the input gradient: the same kernel #4 on the
  cotangent with the spatially flipped, in/out-transposed kernel and pad
  ``k-1-p`` (``_conv_bwd``, conv_pallas.py:233-238);
* :func:`conv_wgrad` — the weight gradient, ``csrc/conv_wgrad.cu``
  (kernel #5).

Each launches its kernel (bf16 operands only) on CUDA tensors and runs
its plain version on CPU tensors; nothing else decides between them.
:class:`ConvFunction` is the ``jax.custom_vjp`` of ``conv_pallas``: its
backward runs :func:`conv_dgrad` only when the input needs a gradient
(not for a conv reading the data node) and :func:`conv_wgrad`.

The wrappers' only tensor prep is the plain NCHW -> padded NHWC
transpose of the input (and of the cotangent for dw) and the (g,
kh*kw*ci, co) arrangement of the kernel, each group's channel count
padded to a multiple of 8 (the kernels' 16-byte loads); the W-unfold and
tile padding the TPU kernels needed are gone.
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
# cxx_conv_wgrad(xp, gp, part, dw, n, hp, wp, ctot, cigp, oh, ow, kh, kw,
#                cogp, groups, splits, stream)
_WGRAD_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 12
                   + [ctypes.c_void_p])
# blocks the dw kernel aims for: eight per SM of an H100's 132, so the
# split reduction fills the card at every AlexNet shape
_WGRAD_BLOCKS = 8 * 132
_WGRAD_MIN_ROWS = 256   # the least rows of M one split reduces


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


def _check_cuda(name: str, *ts: torch.Tensor) -> None:
    """What the kernels take: bf16 operands on one CUDA device."""
    dev = ts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError("%s: no kernel for devices %s"
                         % (name, " x ".join(str(t.device) for t in ts)))
    if any(t.dtype != torch.bfloat16 for t in ts):
        raise ValueError("%s kernel takes bfloat16 operands (dtype = "
                         "bfloat16), got %s" % (
                             name, " x ".join(str(t.dtype) for t in ts)))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ----------------------------------------------------------------------
# plain versions

def conv_plain(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
               pad: Tuple[int, int] = (0, 0), groups: int = 1
               ) -> torch.Tensor:
    """The plain PyTorch version of kernel #4, in the row-im2col form of
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


def _dgrad_operands(w: torch.Tensor, pad: Tuple[int, int], groups: int):
    """The kernel and pad of the input gradient as a forward conv: per
    group the spatially flipped kernel with in/out channels swapped
    (OIHW (ci, co/g, kh, kw)), pad k-1-p (conv_pallas.py:235-238)."""
    co, cig, kh, kw = w.shape
    wt = w.reshape(groups, co // groups, cig, kh, kw).flip(3, 4)
    wt = wt.transpose(1, 2).reshape(groups * cig, co // groups, kh, kw)
    return wt, (kh - 1 - pad[0], kw - 1 - pad[1])


def conv_dgrad_plain(g: torch.Tensor, w: torch.Tensor,
                     pad: Tuple[int, int] = (0, 0), groups: int = 1
                     ) -> torch.Tensor:
    """The plain version of :func:`conv_dgrad`: :func:`conv_plain` of the
    cotangent with the flipped, transposed kernel. Any device."""
    wt, p = _dgrad_operands(w, pad, groups)
    return conv_plain(g, wt, 1, p, groups)


def conv_wgrad_plain(x: torch.Tensor, g: torch.Tensor, kh: int, kw: int,
                     pad: Tuple[int, int] = (0, 0), groups: int = 1
                     ) -> torch.Tensor:
    """The plain version of kernel #5, in the row form of
    ``_wgrad_kernel``: per group, one float32 matmul per kernel row ``dy``
    of the W-unfolded padded input's patch (transposed) with the
    cotangent, then one rounding to ``x.dtype``. Returns OIHW (co, ci/g,
    kh, kw). Any device."""
    n, c, h, wd = x.shape
    co, oh, ow = g.shape[1], g.shape[2], g.shape[3]
    cig, cog = c // groups, co // groups
    py, px = pad
    xt = F.pad(x.permute(0, 2, 3, 1), (0, 0, px, px, py, py))
    gt = g.permute(0, 2, 3, 1)
    dws = []
    for gi in range(groups):
        xg = xt[..., gi * cig:(gi + 1) * cig]
        xf = torch.cat([xg[:, :, dx:dx + ow, :] for dx in range(kw)], -1)
        g2 = gt[..., gi * cog:(gi + 1) * cog].reshape(n * oh * ow,
                                                       cog).float()
        rows = []
        for dy in range(kh):
            patch = xf[:, dy:dy + oh].reshape(n * oh * ow, kw * cig)
            rows.append(torch.matmul(patch.float().t(), g2))
        dwp = torch.stack(rows).reshape(kh, kw, cig, cog)
        dws.append(dwp.permute(3, 2, 0, 1))
    dw = dws[0] if groups == 1 else torch.cat(dws, 0)
    return dw.to(x.dtype).contiguous()


# ----------------------------------------------------------------------
# kernel wrappers

def _pack_input(x: torch.Tensor, cig: int, pad: Tuple[int, int],
                groups: int) -> Tuple[torch.Tensor, int]:
    """(xp, cigp): x as the zero-padded NHWC input (N, H+2py, W+2px,
    groups*cigp), each group's channels zero-padded to cigp, a multiple
    of 8."""
    n, _, h, wd = x.shape
    cigp = _rup(cig, 8)
    xt = x.permute(0, 2, 3, 1)
    if cigp != cig:
        xt = F.pad(xt.reshape(n, h, wd, groups, cig),
                   (0, cigp - cig)).reshape(n, h, wd, groups * cigp)
    py, px = pad
    return F.pad(xt, (0, 0, px, px, py, py)).contiguous(), cigp


def pack_operands(x: torch.Tensor, w: torch.Tensor,
                  pad: Tuple[int, int], groups: int):
    """The forward kernel's operand layouts: (xp, wb, cigp, cogp) with xp
    from :func:`_pack_input` and wb the kernel as (groups, kh*kw*cigp,
    cogp), k ordered (dy, dx, ci); each group's channels zero-padded to
    cigp/cogp, multiples of 8."""
    co, cig, kh, kw = w.shape
    cog = co // groups
    xp, cigp = _pack_input(x, cig, pad, groups)
    cogp = _rup(cog, 8)
    wr = w.reshape(groups, cog, cig, kh, kw).permute(0, 3, 4, 2, 1)
    wb = F.pad(wr, (0, cogp - cog, 0, cigp - cig)).reshape(
        groups, kh * kw * cigp, cogp).contiguous()
    return xp, wb, cigp, cogp


def _conv_out(x: torch.Tensor, w: torch.Tensor,
              pad: Tuple[int, int]) -> torch.Tensor:
    n, _, h, wd = x.shape
    co, _, kh, kw = w.shape
    oh = h + 2 * pad[0] - kh + 1
    ow = wd + 2 * pad[1] - kw + 1
    return torch.empty((n, co, oh, ow), dtype=x.dtype, device=x.device)


def conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
         pad: Tuple[int, int] = (0, 0), groups: int = 1) -> torch.Tensor:
    """Grouped 2D convolution, NCHW x OIHW -> NCHW in ``x.dtype``, stride
    1 only. A CPU tensor runs :func:`conv_plain`; a CUDA tensor launches
    kernel #4 (bf16 operands; ``conv.launches`` counts the launches) or
    raises."""
    _check(x, w, stride, pad, groups)
    if x.device.type == "cpu":
        return conv_plain(x, w, stride, pad, groups)
    _check_cuda("conv", x, w)
    out = _conv_out(x, w, pad)
    if out.numel() == 0:
        return out
    xp, wb, cigp, cogp = pack_operands(x, w, pad, groups)
    launch(xp, wb, out, w.shape[2], w.shape[3], cigp, cogp, groups)
    conv.launches += 1
    return out


def conv_dgrad(g: torch.Tensor, w: torch.Tensor,
               pad: Tuple[int, int] = (0, 0), groups: int = 1
               ) -> torch.Tensor:
    """The input gradient of the stride-1 conv of ``w`` with pad ``pad``
    from its cotangent ``g`` (NCHW, in ``g.dtype``). A CPU tensor runs
    :func:`conv_dgrad_plain`; a CUDA tensor launches kernel #4 on the
    flipped, transposed kernel (``conv_dgrad.launches``) or raises."""
    wt, p = _dgrad_operands(w, pad, groups)
    _check(g, wt, 1, p, groups)
    if g.device.type == "cpu":
        return conv_plain(g, wt, 1, p, groups)
    _check_cuda("conv_dgrad", g, wt)
    out = _conv_out(g, wt, p)
    if out.numel() == 0:
        return out
    xp, wb, cigp, cogp = pack_operands(g, wt, p, groups)
    launch(xp, wb, out, wt.shape[2], wt.shape[3], cigp, cogp, groups)
    conv_dgrad.launches += 1
    return out


def launch(xp: torch.Tensor, wb: torch.Tensor, out: torch.Tensor, kh: int,
           kw: int, cigp: int, cogp: int, groups: int) -> None:
    """Launch kernel #4 on operands from :func:`pack_operands` into the
    preallocated NCHW ``out`` (counts nothing)."""
    n, hp, wp, ctot = xp.shape
    _, co, oh, ow = out.shape
    fn = build.function("conv", "cxx_conv_fwd", _ARGTYPES)
    with torch.cuda.device(out.device):
        err = fn(xp.data_ptr(), wb.data_ptr(), out.data_ptr(), n, hp, wp,
                 ctot, cigp, oh, ow, kh, kw, co // groups, cogp, groups,
                 _stream(out))
    build.check("conv", err, "conv_fwd")


def _wgrad_tiles() -> Tuple[int, int]:
    """(k, co) tile of csrc/conv_wgrad.cu, which its scratch rounds to."""
    tk = build.function("conv_wgrad", "cxx_conv_wgrad_tile_k", [])()
    tc = build.function("conv_wgrad", "cxx_conv_wgrad_tile_co", [])()
    return tk, tc


def wgrad_splits(m: int, k: int, cogp: int, groups: int, tile_k: int,
                 tile_co: int) -> int:
    """How many ranges of the M = N*OH*OW reduction the dw kernel splits
    over blocks: enough for about ``_WGRAD_BLOCKS`` blocks, each range at
    least ``_WGRAD_MIN_ROWS`` rows."""
    tiles = -(-k // tile_k) * -(-cogp // tile_co) * groups
    want = -(-_WGRAD_BLOCKS // tiles)
    return max(1, min(want, m // _WGRAD_MIN_ROWS))


def pack_cotangent(g: torch.Tensor, groups: int) -> Tuple[torch.Tensor, int]:
    """(gp, cogp): the cotangent as (N*OH*OW, groups*cogp) NHWC rows,
    each group's channels zero-padded to cogp, a multiple of 8."""
    n, co, oh, ow = g.shape
    cog = co // groups
    cogp = _rup(cog, 8)
    gt = g.permute(0, 2, 3, 1)
    if cogp != cog:
        gt = F.pad(gt.reshape(n, oh, ow, groups, cog), (0, cogp - cog))
    return gt.reshape(n * oh * ow, groups * cogp).contiguous(), cogp


def conv_wgrad(x: torch.Tensor, g: torch.Tensor, kh: int, kw: int,
               pad: Tuple[int, int] = (0, 0), groups: int = 1
               ) -> torch.Tensor:
    """The weight gradient (OIHW (co, ci/g, kh, kw), in ``x.dtype``) of
    the stride-1 conv of ``x`` with pad ``pad`` from its cotangent ``g``.
    A CPU tensor runs :func:`conv_wgrad_plain`; a CUDA tensor launches
    kernel #5 (``conv_wgrad.launches``) or raises."""
    if x.device.type == "cpu":
        return conv_wgrad_plain(x, g, kh, kw, pad, groups)
    _check_cuda("conv_wgrad", x, g)
    n, c, h, wd = x.shape
    co = g.shape[1]
    cig, cog = c // groups, co // groups
    if (c % groups or co % groups or g.shape[0] != n
            or g.shape[2] != h + 2 * pad[0] - kh + 1
            or g.shape[3] != wd + 2 * pad[1] - kw + 1):
        raise ValueError("conv_wgrad: cotangent %s does not match input %s "
                         "for a %dx%d kernel, pad %s, %d groups"
                         % (tuple(g.shape), tuple(x.shape), kh, kw,
                            tuple(pad), groups))
    xp, cigp = _pack_input(x, cig, pad, groups)
    gp, cogp = pack_cotangent(g, groups)
    k = kh * kw * cigp
    dwp = torch.empty((groups, k, cogp), dtype=x.dtype, device=x.device)
    if dwp.numel() > 0:
        launch_wgrad(xp, gp, dwp, g.shape[2], g.shape[3], kh, kw, cigp,
                     cogp, groups)
        conv_wgrad.launches += 1
    return unpack_wgrad(dwp, co, cig, kh, kw, groups)


def unpack_wgrad(dwp: torch.Tensor, co: int, cig: int, kh: int, kw: int,
                 groups: int) -> torch.Tensor:
    """The dw kernel's packed (groups, kh*kw*cigp, cogp) output as OIHW
    (co, cig, kh, kw), the channel padding dropped."""
    cigp, cogp = dwp.shape[1] // (kh * kw), dwp.shape[2]
    dw = dwp.reshape(groups, kh, kw, cigp, cogp)[..., :cig, :co // groups]
    return dw.permute(0, 4, 3, 1, 2).reshape(co, cig, kh, kw).contiguous()


def launch_wgrad(xp: torch.Tensor, gp: torch.Tensor, dwp: torch.Tensor,
                 oh: int, ow: int, kh: int, kw: int, cigp: int, cogp: int,
                 groups: int) -> None:
    """Launch kernel #5 on operands from :func:`_pack_input` and
    :func:`pack_cotangent` into the packed (groups, kh*kw*cigp, cogp)
    ``dwp`` (counts nothing); allocates the f32 split scratch."""
    n, hp, wp, ctot = xp.shape
    if xp.data_ptr() % 16 or gp.data_ptr() % 16:
        raise ValueError("conv_wgrad: operands must be 16-byte aligned")
    tile_k, tile_co = _wgrad_tiles()
    k = kh * kw * cigp
    splits = wgrad_splits(n * oh * ow, k, cogp, groups, tile_k, tile_co)
    part = torch.empty((splits, groups, _rup(k, tile_k), _rup(cogp, tile_co)),
                       dtype=torch.float32, device=xp.device)
    fn = build.function("conv_wgrad", "cxx_conv_wgrad", _WGRAD_ARGTYPES)
    with torch.cuda.device(xp.device):
        err = fn(xp.data_ptr(), gp.data_ptr(), part.data_ptr(),
                 dwp.data_ptr(), n, hp, wp, ctot, cigp, oh, ow, kh, kw,
                 cogp, groups, splits, _stream(xp))
    build.check("conv_wgrad", err, "conv_wgrad")


conv.launches = 0
conv_dgrad.launches = 0
conv_wgrad.launches = 0


class ConvFunction(torch.autograd.Function):
    """The stride-1 conv with its hand-written backward (the
    ``jax.custom_vjp`` of conv_pallas.py:195-260): the cotangent is cast
    to the operand dtype, dx is :func:`conv_dgrad` (skipped when the
    input needs no gradient), dw is :func:`conv_wgrad`, each rounded once
    to the operand dtype. ``plain`` runs the plain versions on any device
    instead."""

    @staticmethod
    def forward(ctx, x, w, pad, groups, plain):
        out = (conv_plain if plain else conv)(x, w, 1, pad, groups)
        ctx.save_for_backward(x, w)
        ctx.args = (pad, groups, plain)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        pad, groups, plain = ctx.args
        g = g.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            fn = conv_dgrad_plain if plain else conv_dgrad
            dx = fn(g, w, pad, groups)
        if ctx.needs_input_grad[1]:
            fn = conv_wgrad_plain if plain else conv_wgrad
            dw = fn(x, g, w.shape[2], w.shape[3], pad, groups).to(w.dtype)
        return dx, dw, None, None, None


def conv_layer(x: torch.Tensor, w: torch.Tensor, stride: int,
               pad: Tuple[int, int], groups: int,
               plain: bool = False) -> torch.Tensor:
    """The conv as a layer applies it: :func:`conv` (or its plain
    version) when no gradient is taken, :class:`ConvFunction`
    otherwise."""
    if not (torch.is_grad_enabled() and (x.requires_grad
                                         or w.requires_grad)):
        return (conv_plain if plain else conv)(x, w, stride, pad, groups)
    _check(x, w, stride, pad, groups)
    return ConvFunction.apply(x, w, pad, groups, plain)
