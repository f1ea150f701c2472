"""Updaters: sgd / nag / adam with the reference's LR + momentum schedules —
the port's copy of ``cxxnet_tpu/updater.py``.

The reference pairs each weight tensor with an IUpdater holding mutable
momentum buffers (reference: src/updater/updater.h:22-66,
sgd_updater-inl.hpp, nag_updater-inl.hpp, adam_updater-inl.hpp). Here,
as there, each tensor gets an updater object; its state is a dict of
tensors beside the weight, and one step updates the weight and the state
IN PLACE under ``torch.no_grad()`` (the JAX package's updaters are pure
functions XLA fuses; in place saves a copy of every weight and slot per
step). The arithmetic, its order and the slot names (``m``; ``m1``,
``m2``) are the JAX package's, so checkpoints carry the optimizer state
across. These are elementwise tensor ops, not kernels: the JAX package
has no Pallas kernel here either.

Hyper-parameter resolution preserves the reference's tag scoping
(reference: src/updater/param.h:100-131): plain keys (``eta``, ``wd``,
``momentum``) apply to every tensor; ``wmat:lr`` / ``bias:wd`` apply only
to tensors with that tag; later entries win. The gradient clip functor
also zeroes NaNs (sgd_updater-inl.hpp:15-22).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

ConfigEntry = Tuple[str, str]
_f32 = np.float32


@dataclass
class UpdaterHyperParams:
    """Mirrors UpdaterParam (reference: src/updater/param.h:13-132)."""
    tag: str = ""
    base_lr: float = 0.01
    wd: float = 0.0
    decoupled_wd: int = 0   # adam only: true AdamW decay (see AdamUpdater)
    momentum: float = 0.9
    lr_schedule: int = 0        # 0 const, 1 expdecay, 2 polydecay,
                                # 3 factor, 4 cosine
    warmup_epochs: int = 0      # linear LR warmup over the first N updates
    total_epochs: int = 0       # horizon for the cosine schedule
    momentum_schedule: int = 0
    lr_step: int = 1
    lr_gamma: float = 0.5
    lr_alpha: float = 0.5
    lr_factor: float = 0.1
    lr_minimum: float = 0.00001
    start_epoch: int = 0
    base_momentum: float = 0.5
    final_momentum: float = 0.90
    saturation_epoch: int = 0
    clip_gradient: float = 0.0
    # internal multiplier on every effective rate (the JAX package's
    # nan_guard=2 recovery compounds it; kept so its checkpoints' configs
    # mean the same here)
    recovery_lr_scale: float = 1.0
    silent: int = 0
    # adam extras (reference adam_updater-inl.hpp:21-22)
    beta1: float = 0.1
    beta2: float = 0.001

    def set_param(self, name: str, val: str) -> None:
        # tag scoping: "wmat:lr = ..." applies only when tag == "wmat"
        # (reference param.h:103-105)
        if self.tag and name.startswith(self.tag + ":"):
            name = name[len(self.tag) + 1:]
        if name in ("lr", "eta"):
            self.base_lr = float(val)
        elif name == "wd":
            self.wd = float(val)
        elif name == "decoupled_wd":
            self.decoupled_wd = int(val)
        elif name == "momentum":
            self.momentum = float(val)
        elif name == "silent":
            self.silent = int(val)
        elif name == "momentum_schedule":
            self.momentum_schedule = int(val)
        elif name == "clip_gradient":
            self.clip_gradient = float(val)
        elif name == "recovery_lr_scale":
            self.recovery_lr_scale = float(val)
        elif name == "final_momentum":
            self.final_momentum = float(val)
        elif name == "base_momentum":
            self.base_momentum = float(val)
        elif name == "saturation_epoch":
            self.saturation_epoch = int(val)
        elif name == "beta1":
            self.beta1 = float(val)
        elif name == "beta2":
            self.beta2 = float(val)
        elif name.startswith("lr:") or name.startswith("eta:"):
            sub = name.split(":", 1)[1]
            if sub == "schedule":
                self.lr_schedule = {"constant": 0, "expdecay": 1,
                                    "polydecay": 2, "factor": 3,
                                    "cosine": 4}.get(
                                        val, self.lr_schedule)
            elif sub == "warmup":
                self.warmup_epochs = int(val)
            elif sub == "total":
                self.total_epochs = int(val)
            elif sub == "gamma":
                self.lr_gamma = float(val)
            elif sub == "alpha":
                self.lr_alpha = float(val)
            elif sub == "step":
                self.lr_step = int(val)
            elif sub == "factor":
                self.lr_factor = float(val)
            elif sub == "minimum_lr":
                self.lr_minimum = float(val)
            elif sub == "start_epoch":
                self.start_epoch = int(val)

    # ------------------------------------------------------------------
    def schedule(self, epoch: int) -> Tuple[float, float]:
        """(learning_rate, momentum) at ``epoch`` updates — ScheduleEpoch
        (reference: param.h:76-94), in float32 arithmetic as the JAX
        package traces it (updater.py:151-200)."""
        e = _f32(epoch)
        base = _f32(self.base_lr)
        if self.lr_schedule == 0:
            lr = base
        elif self.lr_schedule == 1:
            lr = base * np.power(_f32(self.lr_gamma), e / _f32(self.lr_step))
        elif self.lr_schedule == 2:
            lr = base * np.power(
                _f32(1.0) + np.floor(e / _f32(self.lr_step))
                * _f32(self.lr_gamma), _f32(-self.lr_alpha))
        elif self.lr_schedule == 3:
            lr = base * np.power(_f32(self.lr_factor),
                                 np.floor(e / _f32(self.lr_step)))
        elif self.lr_schedule == 4:
            if self.total_epochs <= 0:
                raise ValueError("lr:schedule = cosine needs lr:total")
            if self.warmup_epochs >= self.total_epochs:
                raise ValueError(
                    "lr:warmup (%d) must be smaller than lr:total (%d) — "
                    "both count UPDATES, not rounds"
                    % (self.warmup_epochs, self.total_epochs))
            span = _f32(max(self.total_epochs - self.warmup_epochs, 1))
            frac = np.clip((e - _f32(self.warmup_epochs)) / span,
                           _f32(0.0), _f32(1.0))
            lr = _f32(self.lr_minimum) + (base - _f32(self.lr_minimum)) \
                * _f32(0.5) * (_f32(1.0) + np.cos(_f32(np.pi) * frac))
        else:
            raise ValueError("unknown schedule type")
        mom = _f32(self.momentum)
        if self.momentum_schedule and self.saturation_epoch:
            # reproduced as written in the reference (param.h:84-86)
            mom = mom + ((_f32(self.final_momentum)
                          - _f32(self.base_momentum))
                         / _f32(self.saturation_epoch) * e
                         + _f32(self.base_momentum))
        mom = min(mom, _f32(self.final_momentum))   # param.h:87
        lr = max(_f32(lr), _f32(self.lr_minimum))
        if self.start_epoch > 0 and e < self.start_epoch:
            lr = base
        if self.warmup_epochs > 0:
            lr = lr * np.clip((e + _f32(1.0)) / _f32(self.warmup_epochs),
                              _f32(0.0), _f32(1.0))
        if self.recovery_lr_scale != 1.0:
            lr = lr * _f32(self.recovery_lr_scale)
        return float(_f32(lr)), float(_f32(mom))


def _clip_nan_(g: torch.Tensor, bound: float) -> torch.Tensor:
    """clip functor: NaN -> 0, clamp to [-bound, bound]
    (reference: sgd_updater-inl.hpp:15-22)."""
    return torch.nan_to_num(g, nan=0.0, posinf=float("inf"),
                            neginf=float("-inf")).clamp_(-bound, bound)


class TensorUpdater:
    """The update rule of one weight tensor, in place."""

    def __init__(self, hp: UpdaterHyperParams) -> None:
        self.hp = hp

    def init_state(self, w: torch.Tensor) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def update_(self, state: Dict[str, torch.Tensor], w: torch.Tensor,
                grad: torch.Tensor, epoch: int) -> None:
        raise NotImplementedError


class SGDUpdater(TensorUpdater):
    """m = mom*m - lr*(clip(g) + wd*w); w += m
    (reference: src/updater/sgd_updater-inl.hpp:73-84)."""

    def init_state(self, w):
        return {"m": torch.zeros_like(w)}

    def update_(self, state, w, grad, epoch):
        lr, mom = self.hp.schedule(epoch)
        if self.hp.clip_gradient != 0.0:
            grad = _clip_nan_(grad, self.hp.clip_gradient)
        m = state["m"]
        m.mul_(mom).sub_((grad + self.hp.wd * w).mul_(lr))
        w.add_(m)


class NAGUpdater(TensorUpdater):
    """Nesterov via old/new momentum
    (reference: src/updater/nag_updater-inl.hpp:64-71)."""

    def init_state(self, w):
        return {"m": torch.zeros_like(w)}

    def update_(self, state, w, grad, epoch):
        lr, mom = self.hp.schedule(epoch)
        m = state["m"]
        old = m.clone()
        m.mul_(mom).sub_((grad + self.hp.wd * w).mul_(lr))
        w.add_((1 + mom) * m).sub_(mom * old)


class AdamUpdater(TensorUpdater):
    """Bias-corrected Adam exactly as the reference writes it
    (reference: src/updater/adam_updater-inl.hpp:66-81), including the
    ``grad -= wd*w`` pre-step; ``decoupled_wd = 1`` applies AdamW decay
    instead. A configured ``lr:schedule`` / ``lr:warmup`` scales the
    rate; with neither, the reference's constant rate (updater.py:251-283
    of the JAX package)."""

    def init_state(self, w):
        return {"m1": torch.zeros_like(w), "m2": torch.zeros_like(w)}

    def update_(self, state, w, grad, epoch):
        hp = self.hp
        if hp.wd > 0.0 and not hp.decoupled_wd:
            grad = grad - hp.wd * w
        e = _f32(epoch)
        fix1 = _f32(1.0) - np.power(_f32(1.0 - hp.beta1), e + _f32(1))
        fix2 = _f32(1.0) - np.power(_f32(1.0 - hp.beta2), e + _f32(1))
        if hp.lr_schedule or hp.warmup_epochs:
            base, _ = hp.schedule(epoch)
        else:
            base = hp.base_lr * hp.recovery_lr_scale
        lr_t = float(_f32(base) * np.sqrt(fix2) / fix1)
        m1, m2 = state["m1"], state["m2"]
        m1.add_((grad - m1).mul_(hp.beta1))
        m2.add_((grad * grad - m2).mul_(hp.beta2))
        w.sub_((m1 / (m2.sqrt() + 1e-8)).mul_(lr_t))
        if hp.wd > 0.0 and hp.decoupled_wd:
            w.sub_(base * hp.wd * w)


_UPDATERS = {"sgd": SGDUpdater, "nag": NAGUpdater, "adam": AdamUpdater}


def create_tensor_updater(kind: str, tag: str,
                          cfgs: Sequence[Sequence[ConfigEntry]]
                          ) -> TensorUpdater:
    """One tensor's updater; ``cfgs`` apply in order (globals first, then
    the layer's bucket — later wins), as CreateUpdater + SetParam streams
    (reference: updater_impl-inl.hpp:18-45, neural_net-inl.hpp:177-204)."""
    if kind not in _UPDATERS:
        raise ValueError("unknown updater type %s" % kind)
    hp = UpdaterHyperParams(tag=tag)
    for cfg in cfgs:
        for k, v in cfg:
            hp.set_param(k, v)
    return _UPDATERS[kind](hp)


class NetUpdater:
    """All per-(layer, tag) updaters of a network and one in-place step
    over them (the JAX NetUpdater, updater.py:305-405)."""

    def __init__(self, net) -> None:
        cfg = net.cfg
        kind = cfg.updater_type
        self.updaters: List[Optional[Dict[str, TensorUpdater]]] = []
        for li, info in enumerate(cfg.layers):
            mod = net.modules[li]
            if info.type == "share" or not mod.has_params:
                self.updaters.append(None)
                continue
            layer_cfgs = (cfg.defcfg, cfg.layercfg[li])
            tags = getattr(mod, "param_tags", ("wmat", "bias"))
            self.updaters.append({
                tag: create_tensor_updater(kind, tag, layer_cfgs)
                for tag in tags})
        # clip_global_norm: rescale the whole gradient to a maximum L2
        # norm before the per-tensor updates, on top of clip_gradient
        self.clip_global_norm = 0.0
        for k, v in cfg.defcfg:
            if k == "clip_global_norm":
                self.clip_global_norm = float(v)
        for li, bucket in enumerate(cfg.layercfg):
            if any(k == "clip_global_norm" for k, _ in bucket):
                raise ValueError(
                    "clip_global_norm is a GLOBAL key (it rescales the "
                    "whole gradient); move it out of layer %d's netconfig "
                    "bucket" % li)

    def init_state(self, params) -> List[Optional[dict]]:
        states: List[Optional[dict]] = []
        for li, p in enumerate(params):
            if p is None:
                states.append(None)
            else:
                states.append({
                    tag: (self.updaters[li][tag].init_state(w)
                          if tag in self.updaters[li] else {})
                    for tag, w in p.items()})
        return states

    @torch.no_grad()
    def apply_(self, params, grads, opt_state, epoch: int) -> None:
        """One optimizer step over the whole net, in place: ``grads``
        mirrors ``params`` (a per-layer dict of gradient tensors, None
        where a layer has none); tags without an updater are left
        alone."""
        if self.clip_global_norm > 0.0:
            sq = None
            for li, g in enumerate(grads):
                if not g or self.updaters[li] is None:
                    continue
                for tag, gv in g.items():
                    if tag in self.updaters[li]:
                        t = gv.float().square().sum()
                        sq = t if sq is None else sq + t
            if sq is not None:
                gnorm = sq.sqrt()
                scale = torch.clamp(self.clip_global_norm
                                    / gnorm.clamp_min(1e-12), max=1.0)
                # a non-finite norm leaves the grads to the per-element
                # clip rather than zeroing the whole step
                scale = torch.where(torch.isfinite(gnorm), scale,
                                    torch.ones_like(scale))
                grads = [({tag: gv * scale for tag, gv in g.items()}
                          if g else g) for g in grads]
        for li, p in enumerate(params):
            if p is None:
                continue
            for tag, w in p.items():
                upd = self.updaters[li].get(tag)
                if upd is None:
                    continue
                upd.update_(opt_state[li][tag], w, grads[li][tag], epoch)
