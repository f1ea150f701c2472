"""Parameters across the two packages.

Both packages keep one parameter dict per layer (None for layers without
parameters or for shared layers) with the same tags and the same array
layouts — conv ``wmat`` as (g, co/g, ci/g*kh*kw), fullc ``wmat`` as
(nhidden, ninput) — so crossing over is a dtype-preserving copy of each
leaf. The JAX side's tree is what ``cxxnet_tpu.checkpoint.load_model``
returns, or ``Network.init_params`` converted with ``np.asarray``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch


def from_jax_params(params, device="cpu") -> List[Optional[dict]]:
    """The JAX package's parameter list (dicts of numpy arrays) -> the
    port's (dicts of tensors on ``device``)."""
    out: List[Optional[dict]] = []
    for p in params:
        if p is None:
            out.append(None)
            continue
        out.append({tag: torch.from_numpy(np.array(v, copy=True)).to(device)
                    for tag, v in p.items()})
    return out


def to_jax_params(params) -> List[Optional[dict]]:
    """The port's parameter list -> dicts of numpy arrays, the tree
    ``cxxnet_tpu`` (and either checkpoint module) takes; copies, which
    the in-place optimizer step leaves alone."""
    return [None if p is None else
            {tag: v.detach().to("cpu", copy=True).numpy()
             for tag, v in p.items()}
            for p in params]


def from_jax_opt_state(opt_state, params) -> List[Optional[dict]]:
    """Optimizer slots as either checkpoint module reads them (per layer
    ``{tag: {slot: numpy array}}``, None where a layer has none) -> the
    port's (tensors beside each weight, on the weight's device)."""
    out: List[Optional[dict]] = []
    for s, p in zip(opt_state, params):
        if s is None or p is None:
            out.append(None)
            continue
        out.append({tag: {slot: torch.from_numpy(np.array(v, copy=True)).to(
                                p[tag].device)
                          for slot, v in slots.items()}
                    for tag, slots in s.items()})
    return out


def to_jax_opt_state(opt_state) -> List[Optional[dict]]:
    """The port's optimizer slots -> per layer ``{tag: {slot: numpy
    array}}``, the tree either checkpoint module writes."""
    return [None if s is None else
            {tag: {slot: v.detach().to("cpu", copy=True).numpy()
                   for slot, v in slots.items()}
             for tag, slots in s.items()}
            for s in opt_state]
