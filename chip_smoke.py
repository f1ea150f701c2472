#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cxxnet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py              # the check: kernels, train, serve
    python3 chip_smoke.py --profile    # also torch.profiler breakdowns

Phases, each of which fails the run (non-zero exit, no result line):

1. card: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, and the build of every kernel in cxxnet_tpu_torch/csrc with
   nvcc for sm_90a (its time and ptxas report);
2. kernels: each hand-written kernel at every shape its path gives it —
   the forward kernels at AlexNet's batch-32 serving shapes and at the
   batch-256 training step's, the training kernels (LRN forward with
   normalizer and backward, conv dx and dw) at the step's — against its
   plain PyTorch version on the same inputs on the card (tolerances
   below), with the time of the wrapper call the path makes (``ms``),
   of the kernel launch alone (``launch_ms``), of the plain version and
   of one PyTorch library call (CUDA events around runs of back-to-back
   calls after warm-up, median of three runs) and the card's bound for
   the work;
3. train: full-width AlexNet (the netconfig and globals of
   examples/imagenet/alexnet.conf, unchanged: batch 256, bf16, dropout
   0.5, SGD with momentum and expdecay) trained by the port's CLI task
   on the synthetic iterator at 3x227x227 for 2 rounds of 2 steps, each
   round's metric line checked; every kernel's launch count over the
   run must be > 0. Then one step from the same weights and dropout
   seed on the kernel path and on the plain path, held against each
   other, and the step time from a host batch and from a batch already
   on the card (``--profile``: the device time per step by kernel and
   the card's idle share of the host-batch step);
4. serve: the trained checkpoint loaded through ``model_in`` by the
   port's CLI task (conv_impl=pallas lrn_impl=pallas, batch 32), served
   by its engine and HTTP server in this process; /predict requests of
   1, 3, 8 and 32 rows, each answer held against the plain-path forward
   of the same rows on the card; every kernel's launch count over this
   phase must be > 0;
5. forward: batch-32 forward time, kernel path and plain path, from a
   host batch and from one already packed on the card; with
   ``--profile`` also the device time per forward by kernel and the
   card's idle share of the host-batch forward.

Then it prints the card line, one ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``. Without CUDA it exits 2 at once.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from cxxnet_tpu_torch.cli import LearnTask
from cxxnet_tpu_torch.ops import build
from cxxnet_tpu_torch.ops import conv as conv_ops
from cxxnet_tpu_torch.ops import lrn as lrn_ops

REPO = os.path.dirname(os.path.abspath(__file__))
CONF = os.path.join(REPO, "examples", "imagenet", "alexnet.conf")
BATCH = 32
TRAIN_BATCH = 256     # alexnet.conf's batch_size
SEED = 20261016
# H100 SXM published peaks (dense): HBM bytes/s, bf16 tensor-core flop/s,
# f32 CUDA-core flop/s
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

# (name, input shape) of each LRN and (name, packed input shape, OIHW
# kernel shape, pad, groups) of each conv in AlexNet's batch-32 forward;
# conv1 is the space-to-depth packed stride-1 form the kernel runs
LRN_SHAPES = [("lrn1", (BATCH, 96, 27, 27)), ("lrn2", (BATCH, 256, 13, 13))]
LRN_ARGS = (5, 0.001, 0.75, 1.0)   # local_size, alpha, beta, knorm
CONV_SHAPES = [
    ("conv1", (BATCH, 48, 57, 57), (96, 48, 3, 3), (0, 0), 1),
    ("conv2", (BATCH, 96, 27, 27), (256, 48, 5, 5), (2, 2), 2),
    ("conv3", (BATCH, 256, 13, 13), (384, 256, 3, 3), (1, 1), 1),
    ("conv4", (BATCH, 384, 13, 13), (384, 192, 3, 3), (1, 1), 2),
    ("conv5", (BATCH, 384, 13, 13), (256, 192, 3, 3), (1, 1), 2),
]
# kernel vs plain version: LRN f32 differs only by rsqrt/sqrt ulps;
# the conv rounds the same f32 sums (in another order) to bf16, so
# outputs may differ by one bf16 ulp, plus order noise near zero
LRN_RTOL, LRN_ATOL = 1e-5, 1e-6
CONV_RTOL, CONV_ATOL_OF_MAX = 2.0 ** -7, 2.0 ** -10
# served answer vs plain-path forward of the same rows (probabilities):
# the bf16 roundings of the two paths differ where the conv sums do
PROB_ATOL = 5e-3
REQUEST_ROWS = (1, 3, 8, 32)

# the batch-256 training step's shapes: (name, LRN input) and (name, conv
# input as the kernel sees it, OIHW kernel, pad, groups, needs dx); conv1
# takes the s2d-packed data node and no input gradient
TRAIN_LRN_SHAPES = [("lrn1", (TRAIN_BATCH, 96, 27, 27)),
                    ("lrn2", (TRAIN_BATCH, 256, 13, 13))]
TRAIN_CONV_SHAPES = [
    ("conv1", (TRAIN_BATCH, 48, 57, 57), (96, 48, 3, 3), (0, 0), 1, False),
    ("conv2", (TRAIN_BATCH, 96, 27, 27), (256, 48, 5, 5), (2, 2), 2, True),
    ("conv3", (TRAIN_BATCH, 256, 13, 13), (384, 256, 3, 3), (1, 1), 1,
     True),
    ("conv4", (TRAIN_BATCH, 384, 13, 13), (384, 192, 3, 3), (1, 1), 2,
     True),
    ("conv5", (TRAIN_BATCH, 384, 13, 13), (256, 192, 3, 3), (1, 1), 2,
     True),
]
# kernel path vs plain path, one training step from the same weights,
# optimizer slots and dropout masks: both round to bf16 at the same
# points and differ only in the order of f32 sums, so a rounding flips by
# one bf16 ulp (2^-8) here and there and the flips spread through the
# backward. The loss must agree within 1e-3 relative; each tensor's
# updated value w1 within 0.1 of the step (pairtest of w1 - w0,
# sum|k-p|/sum|p|, about 25 bf16 ulps; the worst measured on the H100 is
# 0.034, conv1's kernel, whose gradient sums 774k products): the two
# paths start from the same w0, so the updated values differ exactly as
# the updates do. (The weight pairtest itself, printed beside it, says
# little for a tensor that started at zero, such as a bias after a few
# steps.)
STEP_LOSS_RTOL = 1e-3
STEP_UPDATE_PAIRTEST = 0.1
# the synthetic data: AlexNet's input, 100 classes (the iterator's host
# projection is 155k x nclass floats: 62 MB at 100, 618 MB at 1000),
# two batches a round to train, one to evaluate
SYNTH_BLOCKS = """data = train
iter = synth
  shape = 3,227,227
  nclass = 100
  ninst = 512
iter = threadbuffer
iter = end

eval = val
iter = synth
  shape = 3,227,227
  nclass = 100
  ninst = 256
iter = end

"""
METRIC_LINE = re.compile(
    r"^\[(\d+)\]\ttrain-error:([0-9.e+-]+|nan)\ttrain-rec@5:([0-9.e+-]+|nan)"
    r"\tval-error:([0-9.e+-]+)\tval-rec@5:([0-9.e+-]+)$")

COUNTERS = {
    "lrn_fwd": lrn_ops.lrn, "lrn_fwd_scale": lrn_ops.lrn_fwd_scale,
    "lrn_bwd": lrn_ops.lrn_bwd, "conv_fwd": conv_ops.conv,
    "conv_dgrad": conv_ops.conv_dgrad, "conv_wgrad": conv_ops.conv_wgrad,
}


def reset_counts() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in COUNTERS.items()}


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, "nvidia-smi failed: %s" % out.stderr.strip())
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warm: int = 3, rounds: int = 3) -> float:
    """Device time of one ``fn()`` call: CUDA events around ``reps``
    back-to-back calls, over the count; the median of ``rounds``."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def kernel_phase(dev: torch.device, lrn_shapes, conv_shapes, seed: int):
    """The forward kernels #1 and #4 at the given AlexNet shapes against
    their plain versions."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lrn_rows, conv_rows = [], []
    nsize, alpha, beta, knorm = LRN_ARGS
    for name, shape in lrn_shapes:
        x = torch.randn(shape, generator=gen, device=dev) * 5.0
        got = lrn_ops.lrn(x, *LRN_ARGS)
        ref = lrn_ops.lrn_plain(x, *LRN_ARGS)
        lib = F.local_response_norm(x, nsize, alpha, beta, knorm)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        check(bool(torch.isfinite(got).all()), "%s: non-finite" % name)
        check(bool((err <= LRN_RTOL * ref.abs() + LRN_ATOL).all()),
              "%s: kernel vs plain max abs err %g" % (name, err.max()))
        nbytes = 2 * x.numel() * x.element_size()
        ops = x.numel() * (2 * nsize + 6)
        out = torch.empty_like(x)
        lrn_rows.append({
            "shape": list(shape), "dtype": "float32",
            "max_abs_err": float(err.max()),
            "max_rel_err": float((err / ref.abs().clamp_min(1e-30)).max()),
            "library_max_abs_err": float((lib - ref).abs().max()),
            "ms": time_ms(lambda: lrn_ops.lrn(x, *LRN_ARGS)),
            "launch_ms": time_ms(lambda: lrn_ops.launch(x, out, *LRN_ARGS)),
            "plain_ms": time_ms(lambda: lrn_ops.lrn_plain(x, *LRN_ARGS)),
            "library_ms": time_ms(lambda: F.local_response_norm(
                x, nsize, alpha, beta, knorm)),
            "bytes_bound_ms": nbytes / HBM_BPS * 1e3,
            "ops_bound_ms": ops / F32_FLOPS * 1e3,
            "name": name})
    for name, xs, ws, pad, groups in conv_shapes:
        x = torch.randn(xs, generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn(ws, generator=gen, device=dev) * 0.05).to(
            torch.bfloat16)
        got = conv_ops.conv(x, w, 1, pad, groups)
        ref = conv_ops.conv_plain(x, w, 1, pad, groups)
        lib = F.conv2d(x, w, padding=pad, groups=groups)
        torch.cuda.synchronize()
        check(got.shape == ref.shape, "%s: shape %s vs %s"
              % (name, tuple(got.shape), tuple(ref.shape)))
        gf, rf = got.float(), ref.float()
        err = (gf - rf).abs()
        check(bool(torch.isfinite(gf).all()), "%s: non-finite" % name)
        tol = CONV_RTOL * rf.abs() + CONV_ATOL_OF_MAX * rf.abs().max()
        check(bool((err <= tol).all()),
              "%s: kernel vs plain max abs err %g (max |ref| %g)"
              % (name, err.max(), rf.abs().max()))
        n, co, oh, ow = got.shape
        flops = 2.0 * n * oh * ow * co * ws[1] * ws[2] * ws[3]
        nbytes = (x.numel() + w.numel() + got.numel()) * 2
        xp, wb, cigp, cogp = conv_ops.pack_operands(x, w, pad, groups)
        out = torch.empty_like(got)
        conv_rows.append({
            "shape": {"x": list(xs), "w": list(ws), "pad": list(pad),
                      "groups": groups}, "dtype": "bfloat16",
            "max_abs_err": float(err.max()),
            "max_ref": float(rf.abs().max()),
            "library_max_abs_err": float((lib.float() - rf).abs().max()),
            "ms": time_ms(lambda: conv_ops.conv(x, w, 1, pad, groups)),
            "launch_ms": time_ms(lambda: conv_ops.launch(
                xp, wb, out, ws[2], ws[3], cigp, cogp, groups)),
            "plain_ms": time_ms(lambda: conv_ops.conv_plain(
                x, w, 1, pad, groups), reps=5),
            "library_ms": time_ms(lambda: F.conv2d(
                x, w, padding=pad, groups=groups)),
            "bytes_bound_ms": nbytes / HBM_BPS * 1e3,
            "ops_bound_ms": flops / BF16_FLOPS * 1e3,
            "tflops": flops / 1e12,
            "name": name})
    return lrn_rows, conv_rows


def _err_rows(got, ref):
    """(max abs err, within the bf16 tolerance) of kernel vs plain."""
    gf, rf = got.float(), ref.float()
    err = (gf - rf).abs()
    tol = CONV_RTOL * rf.abs() + CONV_ATOL_OF_MAX * rf.abs().max()
    return float(err.max()), bool((err <= tol).all()), float(rf.abs().max())


def train_kernel_phase(dev: torch.device):
    """The training kernels at every shape of the batch-256 AlexNet step
    against their plain versions."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    scale_rows, bwd_rows, dx_rows, dw_rows = [], [], [], []
    nsize, alpha, beta, knorm = LRN_ARGS
    for name, shape in TRAIN_LRN_SHAPES:
        x = torch.randn(shape, generator=gen, device=dev) * 5.0
        g = torch.randn(shape, generator=gen, device=dev) * 1e-3
        out, scale = lrn_ops.lrn_fwd_scale(x, *LRN_ARGS)
        ref_out, ref_scale = lrn_ops.lrn_fwd_scale_plain(x, *LRN_ARGS)
        gx = lrn_ops.lrn_bwd(x, ref_scale, g, nsize, alpha, beta)
        ref_gx = lrn_ops.lrn_bwd_plain(x, ref_scale, g, nsize, alpha, beta)
        torch.cuda.synchronize()
        for what, a, b in (("out", out, ref_out), ("scale", scale,
                                                   ref_scale),
                           ("gx", gx, ref_gx)):
            err = (a - b).abs()
            check(bool(torch.isfinite(a).all()), "%s %s: non-finite"
                  % (name, what))
            check(bool((err <= LRN_RTOL * b.abs()
                        + LRN_ATOL * max(1.0, float(b.abs().max()))).all()),
                  "%s %s: kernel vs plain max abs err %g"
                  % (name, what, err.max()))
        xl = x.detach().requires_grad_(True)
        lib = F.local_response_norm(xl, nsize, alpha, beta, knorm)
        numel = x.numel()
        scale_rows.append({
            "name": name, "shape": list(shape), "dtype": "float32",
            "max_abs_err": max(float((out - ref_out).abs().max()),
                               float((scale - ref_scale).abs().max())),
            "ms": time_ms(lambda: lrn_ops.lrn_fwd_scale(x, *LRN_ARGS)),
            "plain_ms": time_ms(lambda: lrn_ops.lrn_fwd_scale_plain(
                x, *LRN_ARGS)),
            "library_ms": time_ms(lambda: F.local_response_norm(
                x, nsize, alpha, beta, knorm)),
            "library_call": "F.local_response_norm (forward)",
            # x read, out and the f32 normalizer written
            "bytes_bound_ms": 3 * numel * 4 / HBM_BPS * 1e3,
            "ops_bound_ms": numel * (2 * nsize + 6) / F32_FLOPS * 1e3})
        bwd_rows.append({
            "name": name, "shape": list(shape), "dtype": "float32",
            "max_abs_err": float((gx - ref_gx).abs().max()),
            "max_ref": float(ref_gx.abs().max()),
            "ms": time_ms(lambda: lrn_ops.lrn_bwd(x, ref_scale, g, nsize,
                                                  alpha, beta)),
            "plain_ms": time_ms(lambda: lrn_ops.lrn_bwd_plain(
                x, ref_scale, g, nsize, alpha, beta)),
            "library_ms": time_ms(lambda: torch.autograd.grad(
                lib, xl, g, retain_graph=True)),
            "library_call": "F.local_response_norm (autograd backward)",
            # x, the normalizer and g read, gx written; ~nsize+14 flops
            # an element (the window sum, two powers, five products)
            "bytes_bound_ms": 4 * numel * 4 / HBM_BPS * 1e3,
            "ops_bound_ms": numel * (nsize + 14) / F32_FLOPS * 1e3})
    for name, xs, ws, pad, groups, need_dx in TRAIN_CONV_SHAPES:
        x = torch.randn(xs, generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn(ws, generator=gen, device=dev) * 0.05).to(
            torch.bfloat16)
        n, c, h, wd = xs
        co, cig, kh, kw = ws
        oh, ow = h + 2 * pad[0] - kh + 1, wd + 2 * pad[1] - kw + 1
        g = (torch.randn((n, co, oh, ow), generator=gen, device=dev)
             * 1e-3).to(torch.bfloat16)
        flops = 2.0 * n * oh * ow * co * cig * kh * kw
        dw = conv_ops.conv_wgrad(x, g, kh, kw, pad, groups)
        ref_dw = conv_ops.conv_wgrad_plain(x, g, kh, kw, pad, groups)
        torch.cuda.synchronize()
        err, ok, mx = _err_rows(dw, ref_dw)
        check(dw.shape == w.shape and bool(torch.isfinite(
            dw.float()).all()), "%s dw: shape or non-finite" % name)
        check(ok, "%s dw: kernel vs plain max abs err %g (max |ref| %g)"
              % (name, err, mx))
        xp, cigp = conv_ops._pack_input(x, cig, pad, groups)
        gp, cogp = conv_ops.pack_cotangent(g, groups)
        dwp = torch.empty((groups, kh * kw * cigp, cogp),
                          dtype=torch.bfloat16, device=dev)
        dw_rows.append({
            "name": name, "shape": {"x": list(xs), "w": list(ws),
                                    "pad": list(pad), "groups": groups},
            "dtype": "bfloat16", "max_abs_err": err, "max_ref": mx,
            "ms": time_ms(lambda: conv_ops.conv_wgrad(x, g, kh, kw, pad,
                                                      groups)),
            "launch_ms": time_ms(lambda: conv_ops.launch_wgrad(
                xp, gp, dwp, oh, ow, kh, kw, cigp, cogp, groups)),
            "plain_ms": time_ms(lambda: conv_ops.conv_wgrad_plain(
                x, g, kh, kw, pad, groups), reps=5),
            "library_ms": time_ms(lambda: torch.nn.grad.conv2d_weight(
                x, ws, g, padding=pad, groups=groups)),
            "library_call": "torch.nn.grad.conv2d_weight",
            "bytes_bound_ms": (x.numel() + g.numel() + w.numel()) * 2
            / HBM_BPS * 1e3,
            "ops_bound_ms": flops / BF16_FLOPS * 1e3, "tflops": flops / 1e12})
        del xp, gp, dwp
        if not need_dx:
            continue
        dx = conv_ops.conv_dgrad(g, w, pad, groups)
        ref_dx = conv_ops.conv_dgrad_plain(g, w, pad, groups)
        torch.cuda.synchronize()
        err, ok, mx = _err_rows(dx, ref_dx)
        check(dx.shape == x.shape and bool(torch.isfinite(
            dx.float()).all()), "%s dx: shape or non-finite" % name)
        check(ok, "%s dx: kernel vs plain max abs err %g (max |ref| %g)"
              % (name, err, mx))
        wt, p2 = conv_ops._dgrad_operands(w, pad, groups)
        gpk, wb, cigp2, cogp2 = conv_ops.pack_operands(g, wt, p2, groups)
        out = torch.empty_like(x)
        dx_rows.append({
            "name": name, "shape": {"g": [n, co, oh, ow], "w": list(ws),
                                    "pad": list(pad), "groups": groups},
            "dtype": "bfloat16", "max_abs_err": err, "max_ref": mx,
            "ms": time_ms(lambda: conv_ops.conv_dgrad(g, w, pad, groups)),
            "launch_ms": time_ms(lambda: conv_ops.launch(
                gpk, wb, out, kh, kw, cigp2, cogp2, groups)),
            "plain_ms": time_ms(lambda: conv_ops.conv_dgrad_plain(
                g, w, pad, groups), reps=5),
            "library_ms": time_ms(lambda: torch.nn.grad.conv2d_input(
                xs, w, g, padding=pad, groups=groups)),
            "library_call": "torch.nn.grad.conv2d_input",
            "bytes_bound_ms": (x.numel() + g.numel() + w.numel()) * 2
            / HBM_BPS * 1e3,
            "ops_bound_ms": flops / BF16_FLOPS * 1e3, "tflops": flops / 1e12})
        del gpk, wb, out
    return scale_rows, bwd_rows, dx_rows, dw_rows


def synth_config(tmp: str) -> str:
    """examples/imagenet/alexnet.conf with its data and eval blocks (the
    ImageNet packfiles, not in the repo) replaced by the synthetic
    iterator at AlexNet's input shape; the netconfig and the globals
    unchanged. Returns the written file's path."""
    with open(CONF) as f:
        text = f.read()
    start = text.index("netconfig=start")
    path = os.path.join(tmp, "alexnet_synth.conf")
    with open(path, "w") as f:
        f.write(SYNTH_BLOCKS + text[start:])
    return path


def _state(tr) -> tuple:
    """A copy of the trainer's weights, optimizer slots and counters."""
    return ([None if p is None else {t: w.detach().clone()
                                     for t, w in p.items()}
             for p in tr.params],
            [None if s is None else {t: {k: v.clone() for k, v in d.items()}
                                     for t, d in s.items()}
             for s in tr.opt_state],
            tr.epoch_counter, tr.sample_counter)


def _restore(tr, state) -> None:
    params, slots, epoch, sample = state
    with torch.no_grad():
        for p, q in zip(tr.params, params):
            for t in p or {}:
                p[t].copy_(q[t])
        for s, q in zip(tr.opt_state, slots):
            for t in s or {}:
                for k in s[t]:
                    s[t][k].copy_(q[t][k])
    tr.epoch_counter, tr.sample_counter = epoch, sample


def _pairtest(m: torch.Tensor, s: torch.Tensor) -> float:
    m, s = m.double(), s.double()
    return float((m - s).abs().sum() / m.abs().sum().clamp_min(1e-30))


def train_phase(tmp: str, profile: bool):
    """Full-width AlexNet trained through the port's CLI task on the
    card, then one step kernel path vs plain path, then step times."""
    conf = synth_config(tmp)
    model_dir = os.path.join(tmp, "models")
    task = LearnTask()
    task.configure([conf, "task=train", "num_round=2",
                    "model_dir=" + model_dir, "seed=%d" % SEED,
                    "print_step=1"])
    err = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        task.init()
        init_s = time.perf_counter() - t0
        task.task_train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = read_counts()
    lines = [ln for ln in err.getvalue().splitlines() if ln.startswith("[")]
    for ln in lines:
        print("train metric line: %s" % ln)
    check(all(v > 0 for v in launches.values()),
          "a kernel was not launched on the train path: %s" % launches)
    check(len(lines) == 2 and all(METRIC_LINE.match(ln) for ln in lines),
          "train: expected one metric line a round, got %r" % lines)
    tr = task.trainer
    check(tr.epoch_counter == 4, "train: %d steps, expected 4"
          % tr.epoch_counter)
    loss = float(tr.last_loss)
    check(np.isfinite(loss), "train: non-finite loss %g" % loss)
    ckpt = os.path.join(model_dir, "0002.model")
    check(os.path.exists(ckpt), "train: no checkpoint %s" % ckpt)

    # one step from the same weights and dropout seed: kernels vs plain
    task.itr_train.before_first()
    check(task.itr_train.next(), "train: no batch")
    batch = task.itr_train.value
    while task.itr_train.next():
        pass
    staged = tr.stage(batch)
    start = _state(tr)
    result = {}
    for plain in (False, True):
        _restore(tr, start)
        tr.generator.manual_seed(SEED + 4)
        tr.update(staged, plain=plain)
        result[plain] = (float(tr.last_loss),
                         [None if p is None else
                          {t: w.detach().clone() for t, w in p.items()}
                          for p in tr.params])
    _restore(tr, start)
    (lk, pk), (lp, pp) = result[False], result[True]
    check(abs(lk - lp) <= STEP_LOSS_RTOL * abs(lp),
          "step: loss kernel %g vs plain %g" % (lk, lp))
    pairtests = {}
    for li, (a, b, w0) in enumerate(zip(pk, pp, start[0])):
        for t in a or {}:
            pairtests["%d:%s" % (li, t)] = (_pairtest(b[t] - w0[t],
                                                      a[t] - w0[t]),
                                            _pairtest(b[t], a[t]))
    print("step pairtests (update, weight) %s" % json.dumps(pairtests))
    for key, (du, dw) in pairtests.items():
        check(du <= STEP_UPDATE_PAIRTEST,
              "step: layer %s update pairtest %g (weight %g)"
              % (key, du, dw))
    worst_update = max(du for du, _ in pairtests.values())
    worst_weight = max(dw for _, dw in pairtests.values())
    del result, pk, pp

    # step times (host clock around synchronised steps, median)
    def timed(fn, reps):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return float(np.median(times))
    pack_ms = []
    for _ in range(3):
        t = time.perf_counter()
        tr.host_data(batch)
        pack_ms.append((time.perf_counter() - t) * 1e3)
    timed(lambda: tr.update(staged), 2)      # warm
    host_ms = timed(lambda: tr.update(batch), 3)
    dev_ms = timed(lambda: tr.update(staged), 5)
    plain_ms = timed(lambda: tr.update(staged, plain=True), 2)
    torch.cuda.reset_peak_memory_stats()
    tr.update(staged)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    out = {
        "init_s": init_s, "train_s": train_s, "steps": 4,
        "final_loss": loss, "metric_lines": lines,
        "step_loss_kernel": lk, "step_loss_plain": lp,
        "step_worst_update_pairtest": worst_update,
        "step_worst_weight_pairtest": worst_weight,
        "host_batch_step_ms": host_ms,
        "host_batch_images_per_s": TRAIN_BATCH / host_ms * 1e3,
        "device_batch_step_ms": dev_ms,
        "device_batch_images_per_s": TRAIN_BATCH / dev_ms * 1e3,
        "plain_path_device_batch_step_ms": plain_ms,
        "host_s2d_pack_ms": float(np.median(pack_ms)),
        "peak_device_gb": peak_gb,
    }
    if profile:
        prof = profile_phase(lambda: tr.update(batch), reps=3)
        prof["idle_share"] = 1.0 - prof["device_busy_ms"] / host_ms
        out["profile_host_batch_step"] = prof
        prof = profile_phase(lambda: tr.update(staged), reps=3)
        prof["idle_share"] = 1.0 - prof["device_busy_ms"] / dev_ms
        out["profile_device_batch_step"] = prof
    task.trainer = None
    del tr, task, staged, start
    torch.cuda.empty_cache()
    return launches, ckpt, out


def post(url: str, body: dict) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(body).encode("utf-8"),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def serve_phase(ckpt: str):
    """The trained AlexNet served through the port's CLI task, engine
    and server."""
    overrides = ["conv_impl=pallas", "lrn_impl=pallas",
                 "batch_size=%d" % BATCH, "silent=1"]
    task = LearnTask()
    task.configure([CONF, "task=serve", "model_in=" + ckpt,
                    "serve_port=0"] + overrides)
    reset_counts()
    t0 = time.perf_counter()
    task.init()
    srv = task.start_serving()
    srv.start_background()
    try:
        url = "http://127.0.0.1:%d" % srv.server_address[1]
        check(get(url + "/healthz")["ok"], "healthz not ok")
        rng = np.random.default_rng(SEED)
        # whole pixel values keep the JSON bodies short (32 rows: ~35 MB)
        datas = [rng.integers(-128, 128, (n, 3, 227, 227)).astype(
            np.float32) for n in REQUEST_ROWS]
        answers = [None] * len(datas)
        client_ms = [None] * len(datas)

        def client(i):
            # client wall time: JSON encode, HTTP, the server's parse,
            # the engine, the answer's encode and decode
            t = time.perf_counter()
            answers[i] = post(url + "/predict",
                              {"data": datas[i].tolist()})
            client_ms[i] = (time.perf_counter() - t) * 1e3
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(datas))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        check(all(not t.is_alive() for t in threads), "request hung")
        serve_s = time.perf_counter() - t0
        launches = {k: v for k, v in read_counts().items()
                    if k in ("lrn_fwd", "conv_fwd")}
        metrics = get(url + "/metrics")
    finally:
        srv.shutdown()
        task.close()
    check(all(v > 0 for v in launches.values()),
          "a kernel was not launched on the serve path: %s" % launches)
    trainer = task.trainer
    rows = []
    for data, ans, wall in zip(datas, answers, client_ms):
        check(ans is not None, "a request got no answer")
        out = np.asarray(ans["output"], np.float32)
        n = data.shape[0]
        check(out.shape == (n, 1, 1, 1000), "output shape %s" % (out.shape,))
        check(bool(np.isfinite(out).all()), "non-finite probabilities")
        check(bool(np.allclose(out.reshape(n, -1).sum(1), 1.0, atol=1e-3)),
              "probabilities do not sum to 1")
        ref = trainer.forward_device(data, [trainer.net.out_node],
                                     plain=True)[0].cpu().numpy()
        diff = float(np.abs(out - ref).max())
        p = ref.reshape(n, -1)
        top2 = np.sort(p, axis=1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 2 * PROB_ATOL
        same = p.argmax(1) == np.asarray(ans["pred"])
        check(diff <= PROB_ATOL, "%d rows: max |p - p_plain| = %g > %g"
              % (n, diff, PROB_ATOL))
        check(bool(same[clear].all()),
              "%d rows: argmax differs from the plain path where the "
              "margin is clear" % n)
        # what the server's handler does with the body before the
        # engine sees it, alone on the host clock (no other thread)
        body = json.dumps({"data": data.tolist()}).encode("utf-8")
        t = time.perf_counter()
        np.asarray(json.loads(body)["data"], np.float32)
        parse_ms = (time.perf_counter() - t) * 1e3
        rows.append({"rows": n, "max_abs_prob_diff": diff,
                     "argmax_equal": int(same.sum()),
                     "clear_margin_rows": int(clear.sum()),
                     "engine_total_ms": ans["timing"]["total_ms"],
                     "client_ms": wall, "body_mb": len(body) / 1e6,
                     "body_parse_ms": parse_ms})
    return trainer, launches, rows, metrics, serve_s


def forward_phase(trainer):
    """Batch-32 forward (host batch in, probabilities on the card)."""
    data = np.random.default_rng(SEED + 1).normal(
        0.0, 50.0, (BATCH, 3, 227, 227)).astype(np.float32)
    node = [trainer.net.out_node]
    pack_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        packed = trainer.host_data(data)
        pack_ms.append((time.perf_counter() - t0) * 1e3)
    x = torch.from_numpy(packed).to(trainer.device)

    def device_forward():
        with torch.inference_mode():
            trainer.net.apply(trainer.params, x)[0]
    return {
        "kernel_path_ms": time_ms(
            lambda: trainer.forward_device(data, node), reps=10),
        "plain_path_ms": time_ms(
            lambda: trainer.forward_device(data, node, plain=True), reps=5),
        # the same forward from a batch already packed and on the card
        "device_forward_ms": time_ms(device_forward, reps=10),
        # host clock, median of 5 (the pack is numpy on the host)
        "host_s2d_pack_ms": float(np.median(pack_ms)),
        "h2d_copy_ms": time_ms(
            lambda: torch.from_numpy(packed).to(trainer.device), reps=5),
    }


def forward_profile(trainer) -> dict:
    """profile_phase over batch-32 forwards from a host batch."""
    data = np.random.default_rng(SEED + 2).normal(
        0.0, 50.0, (BATCH, 3, 227, 227)).astype(np.float32)
    node = [trainer.net.out_node]
    return profile_phase(lambda: trainer.forward_device(data, node))


def profile_phase(fn, reps: int = 5) -> dict:
    """torch.profiler over a few calls of ``fn``: the device time per
    call by kernel, and its sum (the device's busy time) beside the
    host-clock time of the profiled window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    events = prof.key_averages()
    print(events.table(sort_by="self_cuda_time_total", row_limit=30))

    def device_ms(e):
        us = getattr(e, "self_device_time_total", None)
        return (e.self_cuda_time_total if us is None else us) / 1e3 / reps
    # device-side rows only (kernels, copies): a host op's row repeats
    # the time of the kernels it launched; CUPTI's own buffer request
    # is the profiler's cost, not the forward's
    per_kernel = sorted(
        ((device_ms(e), e.key) for e in events
         if e.device_type != DeviceType.CPU and device_ms(e) > 0
         and e.key != "Activity Buffer Request"), reverse=True)
    busy = sum(ms for ms, _ in per_kernel)
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy,
            "top_device_ms": [[k[:60], ms] for ms, k in per_kernel[:12]]}


def main(argv) -> int:
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: torch sees no CUDA device\n")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print("card: %s | torch %s | CUDA %s | %s"
          % (card, torch.__version__, torch.version.cuda,
             torch.cuda.get_device_name(0)))
    build.build_all()
    print("kernels built in %.2fs (nvcc %s, %s)"
          % (build.build_seconds, " ".join(build.ARCH_FLAGS),
             build.nvcc_path()))
    for name, log in sorted(build.build_log.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print("  %s: %s" % (name, line.strip()))
    sys.stdout.flush()

    # the forward kernels at the serve path's batch-32 shapes and at the
    # training step's batch-256 ones, then the training kernels
    lrn_rows, conv_rows = kernel_phase(dev, LRN_SHAPES, CONV_SHAPES, SEED)
    lrn256_rows, conv256_rows = kernel_phase(
        dev, TRAIN_LRN_SHAPES, [s[:5] for s in TRAIN_CONV_SHAPES], SEED + 5)
    scale_rows, bwd_rows, dx_rows, dw_rows = train_kernel_phase(dev)
    for r in lrn_rows + conv_rows + lrn256_rows + conv256_rows \
            + scale_rows + bwd_rows + dx_rows + dw_rows:
        # the least time of one call: the larger of its bytes (inputs read
        # once, output written once) over the HBM rate and its operations
        # over the peak rate for their type
        r["bound_ms"] = max(r["bytes_bound_ms"], r["ops_bound_ms"])
        r["bound_by"] = ("bytes" if r["bytes_bound_ms"] >= r["ops_bound_ms"]
                         else "operations")
        print("kernel %s" % json.dumps(r))
    sys.stdout.flush()
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        train_launches, ckpt, train = train_phase(tmp, "--profile" in argv)
        print("train %s" % json.dumps(train))
        print("train phase launches %s" % json.dumps(train_launches))
        sys.stdout.flush()
        trainer, launches, rows, metrics, serve_s = serve_phase(ckpt)
    for r in rows:
        print("serve %s" % json.dumps(r))
    print("serve metrics %s" % json.dumps(
        {k: metrics[k] for k in ("requests", "rows", "dispatches",
                                 "batch_occupancy", "latency_ms")}))
    print("serve phase %.2fs (load + warmup + requests), launches %s"
          % (serve_s, json.dumps(launches)))
    fwd = forward_phase(trainer)
    print("forward %s" % json.dumps(fwd))
    if "--profile" in argv:
        prof = forward_profile(trainer)
        # the share of the unprofiled host-batch forward the card is idle
        prof["idle_share"] = 1.0 - prof["device_busy_ms"] / \
            fwd["kernel_path_ms"]
        print("profile %s" % json.dumps(prof))
    sys.stdout.flush()

    def summary(kname, source, replaces, rows_, per, serve_rows=None):
        """One kernel's entry: times and bounds summed over the shapes of
        one batch-256 training step (or its batch-256 eval forward), the
        worst error over every shape checked."""
        by_bytes = (sum(r["bytes_bound_ms"] for r in rows_)
                    >= sum(r["ops_bound_ms"] for r in rows_))
        checked = rows_ + (serve_rows or [])
        out = {
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces,
            # the main path's run: the training CLI (its eval forwards
            # launch the forward-only kernels); the serve path's apart
            "launches": train_launches[kname],
            "launches_by_path": {"train": train_launches[kname],
                                 "serve": launches.get(kname, 0)},
            "max_abs_err": max(r["max_abs_err"] for r in checked),
            "ms": sum(r["ms"] for r in rows_),
            "plain_ms": sum(r["plain_ms"] for r in rows_),
            "bound_ms": sum(r["bound_ms"] for r in rows_),
            "bound_by": "bytes" if by_bytes else "operations",
            "library_ms": sum(r["library_ms"] for r in rows_),
            per: [r["name"] for r in rows_],
            "shapes": rows_,
        }
        if all("launch_ms" in r for r in rows_):
            out["launch_ms"] = sum(r["launch_ms"] for r in rows_)
        if serve_rows:
            # the serve path's batch-32 forward, as the first slice gave it
            out["serve_batch32"] = {
                k: sum(r[k] for r in serve_rows)
                for k in ("ms", "launch_ms", "plain_ms", "bound_ms",
                          "library_ms")}
            out["serve_shapes"] = serve_rows
        return out
    kernels = [
        summary("lrn_fwd", "cxxnet_tpu_torch/csrc/lrn.cu",
                "cxxnet_tpu/ops/lrn.py:83", lrn256_rows,
                "per_batch256_forward_of", lrn_rows),
        summary("lrn_fwd_scale", "cxxnet_tpu_torch/csrc/lrn.cu",
                "cxxnet_tpu/ops/lrn.py:75", scale_rows,
                "per_batch256_step_of"),
        summary("lrn_bwd", "cxxnet_tpu_torch/csrc/lrn.cu",
                "cxxnet_tpu/ops/lrn.py:89", bwd_rows,
                "per_batch256_step_of"),
        summary("conv_fwd", "cxxnet_tpu_torch/csrc/conv.cu",
                "cxxnet_tpu/ops/conv_pallas.py:80", conv256_rows,
                "per_batch256_forward_of", conv_rows),
        summary("conv_dgrad", "cxxnet_tpu_torch/csrc/conv.cu",
                "cxxnet_tpu/ops/conv_pallas.py:238", dx_rows,
                "per_batch256_step_of"),
        summary("conv_wgrad", "cxxnet_tpu_torch/csrc/conv_wgrad.cu",
                "cxxnet_tpu/ops/conv_pallas.py:94", dw_rows,
                "per_batch256_step_of"),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except SmokeFailure as e:
        sys.stderr.write("chip_smoke FAILED: %s\n" % e)
        sys.exit(1)
