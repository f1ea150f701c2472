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
    ``cxxnet_tpu`` (and either checkpoint module) takes."""
    return [None if p is None else
            {tag: v.detach().cpu().numpy() for tag, v in p.items()}
            for p in params]
