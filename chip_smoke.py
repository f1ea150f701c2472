#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cxxnet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py              # the check: kernels + serve phase
    python3 chip_smoke.py --profile    # also a torch.profiler breakdown

Phases, each of which fails the run (non-zero exit, no result line):

1. card: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, and the build of every kernel in cxxnet_tpu_torch/csrc with
   nvcc for sm_90a (its time and ptxas report);
2. kernels: each hand-written kernel at every shape AlexNet's serving
   forward gives it at batch 32, against its plain PyTorch version on
   the same inputs on the card (tolerances below), with the time of the
   wrapper call the path makes (``ms``), of the kernel launch alone
   (``launch_ms``), of the plain version and of one PyTorch library call
   (CUDA events around runs of back-to-back calls after warm-up, median
   of three runs) and the card's bound for the work;
3. serve: full-width AlexNet from examples/imagenet/alexnet.conf with
   conv_impl=pallas lrn_impl=pallas and dtype=bfloat16, weights drawn
   from a fixed seed and saved to a checkpoint, loaded through
   ``model_in`` by the port's CLI task, served by its engine and HTTP
   server in this process; /predict requests of 1, 3, 8 and 32 rows,
   each answer held against the plain-path forward of the same rows on
   the card; every kernel's launch count over this phase must be > 0;
4. forward: batch-32 forward time, kernel path and plain path, from a
   host batch and from one already packed on the card; with
   ``--profile`` also the device time per forward by kernel and the
   card's idle share of the host-batch forward.

Then it prints the card line, one ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``. Without CUDA it exits 2 at once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from cxxnet_tpu_torch import config
from cxxnet_tpu_torch.cli import LearnTask
from cxxnet_tpu_torch.ops import build
from cxxnet_tpu_torch.ops import conv as conv_ops
from cxxnet_tpu_torch.ops import lrn as lrn_ops
from cxxnet_tpu_torch.trainer import Trainer

REPO = os.path.dirname(os.path.abspath(__file__))
CONF = os.path.join(REPO, "examples", "imagenet", "alexnet.conf")
BATCH = 32
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


def kernel_phase(dev: torch.device):
    """Every kernel at every AlexNet shape against its plain version."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    lrn_rows, conv_rows = [], []
    nsize, alpha, beta, knorm = LRN_ARGS
    for name, shape in LRN_SHAPES:
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
    for name, xs, ws, pad, groups in CONV_SHAPES:
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


def post(url: str, body: dict) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(body).encode("utf-8"),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def serve_phase(tmp: str):
    """AlexNet served through the port's CLI task, engine and server."""
    overrides = ["conv_impl=pallas", "lrn_impl=pallas",
                 "batch_size=%d" % BATCH, "seed=%d" % SEED,
                 "random_type=kaiming", "silent=1"]
    tr = Trainer()
    for k, v in (config.parse_file(CONF)
                 + config.parse_cli_overrides(overrides)):
        tr.set_param(k, v)
    tr.init_model()
    ckpt = os.path.join(tmp, "alexnet.model")
    tr.save_model(ckpt)
    del tr
    torch.cuda.empty_cache()

    task = LearnTask()
    task.configure([CONF, "task=serve", "model_in=" + ckpt,
                    "serve_port=0"] + overrides)
    lrn_ops.lrn.launches = 0
    conv_ops.conv.launches = 0
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
        launches = {"lrn_fwd": lrn_ops.lrn.launches,
                    "conv_fwd": conv_ops.conv.launches}
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
            trainer.net.apply(trainer.params, x)
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


def profile_phase(trainer, reps: int = 5) -> dict:
    """torch.profiler over a few batch-32 forwards from a host batch:
    the device time per forward by kernel, and its sum (the device's
    busy time) beside the host-clock time of the profiled window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    data = np.random.default_rng(SEED + 2).normal(
        0.0, 50.0, (BATCH, 3, 227, 227)).astype(np.float32)
    node = [trainer.net.out_node]
    trainer.forward_device(data, node)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            trainer.forward_device(data, node)
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

    lrn_rows, conv_rows = kernel_phase(dev)
    for r in lrn_rows + conv_rows:
        # the least time of one call: the larger of its bytes (inputs read
        # once, output written once) over the HBM rate and its operations
        # over the peak rate for their type
        r["bound_ms"] = max(r["bytes_bound_ms"], r["ops_bound_ms"])
        r["bound_by"] = ("bytes" if r["bytes_bound_ms"] >= r["ops_bound_ms"]
                         else "operations")
        print("kernel %s" % json.dumps(r))
    sys.stdout.flush()

    with tempfile.TemporaryDirectory() as tmp:
        trainer, launches, rows, metrics, serve_s = serve_phase(tmp)
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
        prof = profile_phase(trainer)
        # the share of the unprofiled host-batch forward the card is idle
        prof["idle_share"] = 1.0 - prof["device_busy_ms"] / \
            fwd["kernel_path_ms"]
        print("profile %s" % json.dumps(prof))
    sys.stdout.flush()

    def summary(kname, source, replaces, rows_):
        by_bytes = (sum(r["bytes_bound_ms"] for r in rows_)
                    >= sum(r["ops_bound_ms"] for r in rows_))
        return {
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": max(r["max_abs_err"] for r in rows_),
            "ms": sum(r["ms"] for r in rows_),
            "launch_ms": sum(r["launch_ms"] for r in rows_),
            "plain_ms": sum(r["plain_ms"] for r in rows_),
            "bound_ms": sum(r["bound_ms"] for r in rows_),
            "bound_by": "bytes" if by_bytes else "operations",
            "library_ms": sum(r["library_ms"] for r in rows_),
            "per_forward_of": [r["name"] for r in rows_],
            "shapes": rows_,
        }
    kernels = [
        summary("lrn_fwd", "cxxnet_tpu_torch/csrc/lrn.cu",
                "cxxnet_tpu/ops/lrn.py:83", lrn_rows),
        summary("conv_fwd", "cxxnet_tpu_torch/csrc/conv.cu",
                "cxxnet_tpu/ops/conv_pallas.py:80", conv_rows),
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
