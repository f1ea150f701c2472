"""Checkpoints: the single-file ``.model`` container of cxxnet_tpu.

The port's copy of the single-file half of ``cxxnet_tpu/checkpoint.py``:
one zip holding a JSON structure header plus npz weight arrays keyed
``L<layer>:<tag>`` (optimizer slots ``O<layer>:<tag>:<slot>``). The
format is numpy-only, so a file either package writes loads in the
other unchanged (same magic). Parameters here are the framework-neutral
tree — a per-layer list of ``{tag: numpy array}`` dicts or None —
that ``weights.from_jax_params`` turns into the port's tensors.

Sharded ``.model`` directories (``save_sharded = 1``) and binary models
of the original C++ framework load in the JAX package only, for now
(ROADMAP.md, CNN zoo and data slice).
"""

from __future__ import annotations

import io
import json
import os
import re
import zipfile
from typing import List, Optional, Tuple

import numpy as np

from .graph import NetConfig

MAGIC = "cxxnet_tpu.model.v1"


def save_model(path: str, net_cfg: NetConfig, epoch_counter: int,
               params, opt_state=None) -> None:
    """Write one .model file (structure + epoch + weights [+ optimizer
    slots ``O<layer>:<tag>:<slot>``]); array leaves are numpy arrays (or
    anything ``np.asarray`` takes)."""
    header = {
        "magic": MAGIC,
        "net_type": 0,
        "epoch_counter": int(epoch_counter),
        "structure": net_cfg.structure_state(),
        "has_opt_state": opt_state is not None,
    }
    arrays = {"L%d:%s" % (li, tag): np.asarray(v)
              for li, p in enumerate(params) if p
              for tag, v in p.items()}
    for li, p in enumerate(opt_state or []):
        for tag, slots in (p or {}).items():
            for slot, v in slots.items():
                arrays["O%d:%s:%s" % (li, tag, slot)] = np.asarray(v)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    tmp = path + ".tmp"
    with zipfile.ZipFile(tmp, "w") as z:
        z.writestr("header.json", json.dumps(header))
        z.writestr("arrays.npz", buf.getvalue())
    os.replace(tmp, path)


def _trees_from_arrays(arrays: dict, nlayers: int):
    """Flat {key: array} -> (params, opt_state) layer-indexed trees."""
    params: List[Optional[dict]] = [None] * nlayers
    opt_state: List[Optional[dict]] = [None] * nlayers
    for key, arr in arrays.items():
        m = re.match(r"L(\d+):([^:]+)$", key)
        if m:
            li = int(m.group(1))
            params[li] = params[li] or {}
            params[li][m.group(2)] = arr
            continue
        m = re.match(r"O(\d+):([^:]+):([^:]+)$", key)
        if m:
            li = int(m.group(1))
            opt_state[li] = opt_state[li] or {}
            opt_state[li].setdefault(m.group(2), {})[m.group(3)] = arr
    return params, opt_state


def load_model(path: str):
    """Read a single-file .model -> (net_cfg, epoch, params, opt_state,
    net_type); params/opt_state are per-layer lists of numpy dicts, None
    where a layer has none."""
    if os.path.isdir(path):
        raise NotImplementedError(
            "%s: sharded .model directories load in cxxnet_tpu only; the "
            "port's loader for them comes with the CNN zoo and data slice "
            "(ROADMAP.md)" % path)
    if not zipfile.is_zipfile(path):
        raise ValueError(
            "%s: not a cxxnet_tpu model container (binary models of the "
            "original C++ framework load in cxxnet_tpu only)" % path)
    with zipfile.ZipFile(path, "r") as z:
        header = json.loads(z.read("header.json"))
        if header.get("magic") != MAGIC:
            raise ValueError("%s: not a cxxnet_tpu model file" % path)
        npz = np.load(io.BytesIO(z.read("arrays.npz")))
        arrays = {k: npz[k] for k in npz.files}
    net_cfg = NetConfig.from_structure_state(header["structure"])
    params, opt_state = _trees_from_arrays(arrays, net_cfg.num_layers)
    if not header.get("has_opt_state"):
        opt_state = None
    return (net_cfg, header["epoch_counter"], params, opt_state,
            header.get("net_type", 0))


def model_path(model_dir: str, counter: int) -> str:
    return os.path.join(model_dir, "%04d.model" % counter)


def find_latest_model(model_dir: str, start_counter: int = 0
                      ) -> Optional[Tuple[str, int]]:
    """The newest ``model_dir/%04d.model`` at or above ``start_counter``
    (reference SyncLastestModel, cxxnet_main.cpp:135-157; a directory
    listing, as the JAX package scans it): (path, counter) or None."""
    counters = []
    if os.path.isdir(model_dir):
        for f in os.listdir(model_dir):
            m = re.match(r"(\d+)\.model$", f)
            if m and int(m.group(1)) >= start_counter:
                counters.append(int(m.group(1)))
    if not counters:
        return None
    c = max(counters)
    return model_path(model_dir, c), c
