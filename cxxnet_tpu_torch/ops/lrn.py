"""Fused cross-channel LRN forward: the CUDA kernel's wrapper and its
plain PyTorch version.

The op (reference: src/layer/lrn_layer-inl.hpp:45-56), as
``cxxnet_tpu/ops/lrn.py`` computes it:

    s   = knorm + (alpha/nsize) * W(x^2)      # W: windowed channel sum
    out = x * s^-beta

with the window over channels [c-lo, c+hi], lo = nsize//2, hi =
nsize-1-lo, zero-padded. :func:`lrn` launches ``csrc/lrn.cu`` on a CUDA
tensor and runs :func:`lrn_plain` on a CPU tensor; nothing else decides
between them. Only the inference forward is here; the VJP kernels come
with the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

MAX_NSIZE = 64   # the kernel keeps 16+nsize-1 f32 rows a thread in smem


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
    kernel uses the same forms)."""
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


def lrn_plain(x: torch.Tensor, nsize: int, alpha: float, beta: float,
              knorm: float) -> torch.Tensor:
    """The plain PyTorch version of the kernel: f32 math, result in
    ``x.dtype``. Any device."""
    lo = nsize // 2
    hi = nsize - 1 - lo
    xf = x.float()
    s = knorm + (alpha / nsize) * _windowed_sum(xf * xf, hi, lo)
    return (xf * _neg_pow(s, beta)).to(x.dtype)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# cxx_lrn_fwd(x, out, n, c, s, nsize, salpha, beta, knorm, dtype, stream)
_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
             + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p])


def lrn(x: torch.Tensor, nsize: int, alpha: float, beta: float,
        knorm: float) -> torch.Tensor:
    """LRN over a contiguous (N, C, H, W) f32 or bf16 tensor; the result
    has ``x.dtype``. A CPU tensor runs :func:`lrn_plain`; a CUDA tensor
    launches the kernel (``lrn.launches`` counts the launches) or
    raises."""
    if x.device.type == "cpu":
        return lrn_plain(x, nsize, alpha, beta, knorm)
    if x.device.type != "cuda":
        raise ValueError("lrn: no kernel for device %s" % x.device)
    if x.dim() != 4 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError("lrn kernel takes a contiguous (N, C, H, W) "
                         "float32 or bfloat16 tensor, got %s %s%s"
                         % (tuple(x.shape), x.dtype,
                            "" if x.is_contiguous() else " (strided)"))
    if not 1 <= nsize <= MAX_NSIZE:
        raise ValueError("lrn kernel takes 1 <= nsize <= %d, got %d"
                         % (MAX_NSIZE, nsize))
    out = torch.empty_like(x)
    if out.numel() > 0:
        launch(x, out, nsize, alpha, beta, knorm)
    return out


def launch(x: torch.Tensor, out: torch.Tensor, nsize: int, alpha: float,
           beta: float, knorm: float) -> None:
    """Launch the kernel on a checked input into the preallocated
    ``out`` of the same shape and dtype."""
    n, c, h, w = x.shape
    fn = build.function("lrn", "cxx_lrn_fwd", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), n, c, h * w, nsize,
                 alpha / nsize, beta, knorm, _DTYPES[x.dtype], stream)
    build.check("lrn", err, "lrn_fwd")
    lrn.launches += 1


lrn.launches = 0
