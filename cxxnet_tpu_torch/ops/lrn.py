"""Fused cross-channel LRN, forward and backward: the CUDA kernels'
wrappers, their plain PyTorch versions and the autograd Function that
joins them.

The op (reference: src/layer/lrn_layer-inl.hpp:45-76), as
``cxxnet_tpu/ops/lrn.py`` computes it:

    s   = knorm + (alpha/nsize) * W(x^2)      # W: windowed channel sum
    out = x * s^-beta
    gx  = g * s^-beta - 2*(alpha/nsize)*beta * x * W'(g * x * s^(-beta-1))

with the window over channels [c-lo, c+hi], lo = nsize//2, hi =
nsize-1-lo, zero-padded, and W' its adjoint, rows [c-hi, c+lo].

Three kernels in ``csrc/lrn.cu``, one wrapper each, each with its launch
count: :func:`lrn` (the forward alone, #1), :func:`lrn_fwd_scale` (the
forward that also writes the f32 normalizer ``s``, #2) and
:func:`lrn_bwd` (#3). A wrapper launches its kernel on a CUDA tensor and
runs its plain version on a CPU tensor; nothing else decides between
them. :func:`lrn_layer` is the primal/VJP split of ``_lrn``
(lrn.py:111-188): with no gradient to take it runs #1, otherwise
:class:`LRNFunction`, whose forward runs #2 and saves ``(x, s)`` and whose
backward runs #3.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

MAX_NSIZE = 64   # the kernels keep 16+nsize-1 f32 rows a thread in smem


def _window(nsize: int) -> Tuple[int, int]:
    lo = nsize // 2
    return lo, nsize - 1 - lo


def _windowed_sum(t: torch.Tensor, n_above: int,
                  n_below: int) -> torch.Tensor:
    """acc[:, c] = sum_{d=0..n_above} t[:, c+d] + sum_{d=1..n_below}
    t[:, c-d] (zero-padded) over the channel axis of (N, C, ...) by
    shifted adds, in the order the Pallas kernel adds them; shifts of
    >= C rows contribute nothing and are skipped."""
    c = t.shape[1]
    acc = t
    for d in range(1, min(n_above, c - 1) + 1):
        acc = acc + torch.cat([t[:, d:], t.new_zeros(t[:, :d].shape)], 1)
    for d in range(1, min(n_below, c - 1) + 1):
        acc = acc + torch.cat([t.new_zeros(t[:, :d].shape), t[:, :c - d]], 1)
    return acc


def _neg_pow(s: torch.Tensor, beta: float) -> torch.Tensor:
    """s^-beta, with the cheap forms for the betas that occur (the
    kernels use the same forms)."""
    if beta == 0.75:
        return torch.rsqrt(s * torch.sqrt(s))
    if beta == 0.5:
        return torch.rsqrt(s)
    if beta == 1.0:
        return 1.0 / s
    if beta == 1.75:
        return torch.rsqrt(s * torch.sqrt(s)) / s
    if beta == 1.5:
        return torch.rsqrt(s) / s
    if beta == 2.0:
        return 1.0 / (s * s)
    return torch.pow(s, -beta)


def lrn_fwd_scale_plain(x: torch.Tensor, nsize: int, alpha: float,
                        beta: float, knorm: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of kernels #1 and #2: (out in ``x.dtype``, the
    f32 normalizer s), f32 math. Any device."""
    lo, hi = _window(nsize)
    xf = x.float()
    s = knorm + (alpha / nsize) * _windowed_sum(xf * xf, hi, lo)
    return (xf * _neg_pow(s, beta)).to(x.dtype), s


def lrn_plain(x: torch.Tensor, nsize: int, alpha: float, beta: float,
              knorm: float) -> torch.Tensor:
    """The plain version of kernel #1: the LRN output in ``x.dtype``."""
    return lrn_fwd_scale_plain(x, nsize, alpha, beta, knorm)[0]


def lrn_bwd_plain(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                  nsize: int, alpha: float, beta: float) -> torch.Tensor:
    """The plain version of kernel #3 (lrn.py:_bwd_kernel): gx in
    ``x.dtype`` from x, the f32 normalizer and the cotangent, f32 math in
    the Pallas kernel's order. Any device."""
    lo, hi = _window(nsize)
    salpha = alpha / nsize
    xf, gf = x.float(), g.float()
    inner = gf * xf * _neg_pow(scale, beta + 1.0)
    wsum = _windowed_sum(inner, lo, hi)   # the adjoint window
    gx = gf * _neg_pow(scale, beta) - 2.0 * salpha * beta * xf * wsum
    return gx.to(x.dtype)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# cxx_lrn_fwd(x, out, n, c, s, nsize, salpha, beta, knorm, dtype, stream)
_FWD_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
             + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p])
# cxx_lrn_fwd_scale(x, out, scale, n, c, s, nsize, salpha, beta, knorm,
#                   dtype, stream)
_FWD_SCALE_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p])
# cxx_lrn_bwd(x, scale, g, gx, n, c, s, nsize, beta, coef, dtype, stream)
_BWD_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
             + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])


def _check_cuda(name: str, x: torch.Tensor, nsize: int) -> None:
    """What the kernels take; anything else raises."""
    if x.device.type != "cuda":
        raise ValueError("%s: no kernel for device %s" % (name, x.device))
    if x.dim() != 4 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError("%s kernel takes a contiguous (N, C, H, W) "
                         "float32 or bfloat16 tensor, got %s %s%s"
                         % (name, tuple(x.shape), x.dtype,
                            "" if x.is_contiguous() else " (strided)"))
    if not 1 <= nsize <= MAX_NSIZE:
        raise ValueError("%s kernel takes 1 <= nsize <= %d, got %d"
                         % (name, MAX_NSIZE, nsize))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def lrn(x: torch.Tensor, nsize: int, alpha: float, beta: float,
        knorm: float) -> torch.Tensor:
    """LRN over a contiguous (N, C, H, W) f32 or bf16 tensor; the result
    has ``x.dtype``. A CPU tensor runs :func:`lrn_plain`; a CUDA tensor
    launches kernel #1 (``lrn.launches`` counts the launches) or
    raises."""
    if x.device.type == "cpu":
        return lrn_plain(x, nsize, alpha, beta, knorm)
    _check_cuda("lrn", x, nsize)
    out = torch.empty_like(x)
    if out.numel() > 0:
        launch(x, out, nsize, alpha, beta, knorm)
        lrn.launches += 1
    return out


def launch(x: torch.Tensor, out: torch.Tensor, nsize: int, alpha: float,
           beta: float, knorm: float) -> None:
    """Launch kernel #1 on a checked input into the preallocated ``out``
    of the same shape and dtype (counts nothing)."""
    n, c, h, w = x.shape
    fn = build.function("lrn", "cxx_lrn_fwd", _FWD_ARGS)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), n, c, h * w, nsize,
                 alpha / nsize, beta, knorm, _DTYPES[x.dtype], _stream(x))
    build.check("lrn", err, "lrn_fwd")


def lrn_fwd_scale(x: torch.Tensor, nsize: int, alpha: float, beta: float,
                  knorm: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, f32 normalizer s) of a contiguous (N, C, H, W) f32 or bf16
    tensor. A CPU tensor runs :func:`lrn_fwd_scale_plain`; a CUDA tensor
    launches kernel #2 (``lrn_fwd_scale.launches``) or raises."""
    if x.device.type == "cpu":
        return lrn_fwd_scale_plain(x, nsize, alpha, beta, knorm)
    _check_cuda("lrn_fwd_scale", x, nsize)
    out = torch.empty_like(x)
    scale = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if out.numel() > 0:
        n, c, h, w = x.shape
        fn = build.function("lrn", "cxx_lrn_fwd_scale", _FWD_SCALE_ARGS)
        with torch.cuda.device(x.device):
            err = fn(x.data_ptr(), out.data_ptr(), scale.data_ptr(), n, c,
                     h * w, nsize, alpha / nsize, beta, knorm,
                     _DTYPES[x.dtype], _stream(x))
        build.check("lrn", err, "lrn_fwd_scale")
        lrn_fwd_scale.launches += 1
    return out, scale


def lrn_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
            nsize: int, alpha: float, beta: float) -> torch.Tensor:
    """gx for the LRN of x, from its f32 normalizer and the cotangent g
    (cast to ``x.dtype``). A CPU tensor runs :func:`lrn_bwd_plain`; a
    CUDA tensor launches kernel #3 (``lrn_bwd.launches``) or raises."""
    g = g.to(x.dtype).contiguous()
    if x.device.type == "cpu":
        return lrn_bwd_plain(x, scale, g, nsize, alpha, beta)
    _check_cuda("lrn_bwd", x, nsize)
    if (scale.dtype != torch.float32 or scale.shape != x.shape
            or not scale.is_contiguous() or g.shape != x.shape
            or scale.device != x.device or g.device != x.device):
        raise ValueError("lrn_bwd kernel takes a contiguous f32 normalizer "
                         "and a cotangent of x's shape %s on %s"
                         % (tuple(x.shape), x.device))
    gx = torch.empty_like(x)
    if gx.numel() > 0:
        n, c, h, w = x.shape
        fn = build.function("lrn", "cxx_lrn_bwd", _BWD_ARGS)
        with torch.cuda.device(x.device):
            err = fn(x.data_ptr(), scale.data_ptr(), g.data_ptr(),
                     gx.data_ptr(), n, c, h * w, nsize, beta,
                     2.0 * (alpha / nsize) * beta, _DTYPES[x.dtype],
                     _stream(x))
        build.check("lrn", err, "lrn_bwd")
        lrn_bwd.launches += 1
    return gx


lrn.launches = 0
lrn_fwd_scale.launches = 0
lrn_bwd.launches = 0


class LRNFunction(torch.autograd.Function):
    """The LRN with its hand-derived backward (the ``jax.custom_vjp`` of
    lrn.py:111-188): forward runs #2 and saves ``(x, s)``, backward runs
    #3. ``plain`` runs the plain versions on any device instead."""

    @staticmethod
    def forward(ctx, x, nsize, alpha, beta, knorm, plain):
        x = x.contiguous()
        fwd = lrn_fwd_scale_plain if plain else lrn_fwd_scale
        out, scale = fwd(x, nsize, alpha, beta, knorm)
        ctx.save_for_backward(x, scale)
        ctx.args = (nsize, alpha, beta, plain)
        return out

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        nsize, alpha, beta, plain = ctx.args
        if plain:
            gx = lrn_bwd_plain(x, scale, g.to(x.dtype), nsize, alpha, beta)
        else:
            gx = lrn_bwd(x, scale, g, nsize, alpha, beta)
        return gx, None, None, None, None, None


def lrn_layer(x: torch.Tensor, nsize: int, alpha: float, beta: float,
              knorm: float, plain: bool = False) -> torch.Tensor:
    """The LRN as a layer applies it: kernel #1 (or its plain version)
    when no gradient is taken, :class:`LRNFunction` otherwise."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        fn = lrn_plain if plain else lrn
        return fn(x, nsize, alpha, beta, knorm)
    return LRNFunction.apply(x, nsize, alpha, beta, knorm, plain)
