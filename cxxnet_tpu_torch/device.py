"""Device selection: the config's ``dev`` key mapped onto a torch.device.

``dev = tpu[:ids]`` and ``dev = gpu[:ids]`` (and ``cuda[:ids]``) all mean
CUDA device ``ids[0]`` (0 without ids), so the repo's configs run
unchanged; ``dev = cpu`` is the only way onto the CPU. Without CUDA any
other value raises: the port never carries on quietly on the CPU.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

import torch

ACCELERATORS = ("tpu", "gpu", "cuda")


def parse_device_config(val: str) -> Tuple[str, Optional[List[int]]]:
    """Parse ``dev = tpu`` / ``tpu:0-3`` / ``gpu:0,2`` / ``cpu`` into
    (platform, device ids or None) — reference: nnet_impl-inl.hpp:32-51
    (the same grammar as ``cxxnet_tpu.parallel.parse_device_config``)."""
    if ":" in val:
        plat, spec = val.split(":", 1)
        m = re.match(r"(\d+)-(\d+)$", spec)
        if m:
            ids = list(range(int(m.group(1)), int(m.group(2)) + 1))
        else:
            ids = [int(t) for t in spec.split(",")]
        return plat, ids
    return val, None


def select_device(dev: str) -> torch.device:
    plat, ids = parse_device_config(dev)
    if plat == "cpu":
        return torch.device("cpu")
    if plat not in ACCELERATORS:
        raise ValueError("dev=%s: unknown platform %r (tpu|gpu|cuda|cpu)"
                         % (dev, plat))
    if not torch.cuda.is_available():
        raise RuntimeError(
            "dev=%s needs a CUDA device and torch sees none; set dev=cpu "
            "to run on the CPU" % dev)
    idx = ids[0] if ids else 0
    if idx >= torch.cuda.device_count():
        raise ValueError("dev=%s requests CUDA device %d but only %d exist"
                         % (dev, idx, torch.cuda.device_count()))
    return torch.device("cuda", idx)
