"""Trainer: the config-driven owner of a net, its parameters and its
optimizer state — the port of ``cxxnet_tpu/trainer.py`` for one device.

It consumes the same config keys (``batch_size``, ``dev``, ``dtype``,
``seed``, ``metric``, the updater keys, ...), builds the network on the
device ``dev`` names (device.py), initialises it from ``seed`` or loads a
``.model`` either package wrote (optimizer slots included), and runs:

* ``update(batch)`` — one SGD step: forward with dropout and the loss,
  ``loss.backward()`` through the hand-written backward kernels, then the
  in-place optimizer step (updater.py);
* ``evaluate(iter, name)`` — the round-end metric line: the train
  metric accumulated over the round's steps, then the eval set's;
* ``forward_nodes`` / ``forward_device`` — inference, answered on the
  host or left on the device (the serving engine).

Batches are packed space-to-depth on the host when the net asks for it
(trainer.py:850-856 of the JAX package). ``update_period > 1``,
``fuse_steps > 1`` and ``nan_guard`` come with a later slice and raise.
"""

from __future__ import annotations

import re
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import checkpoint, weights
from .device import select_device
from .graph import NetConfig
from .io import DataBatch, DataIterator
from .layers import s2d_pack, s2d_unpack
from .metrics import MetricSet
from .model import Network
from .updater import NetUpdater

ConfigEntry = Tuple[str, str]


class StagedBatch(NamedTuple):
    """A batch already on the device: the (packed) data, the label fields
    in label_range order, and the host batch its train metric reads."""
    data: torch.Tensor
    labels: List[torch.Tensor]
    host: DataBatch


class Trainer:
    def __init__(self) -> None:
        self.cfg: List[ConfigEntry] = []
        self.batch_size = 100
        self.update_period = 1
        self.fuse_steps = 1
        self.nan_guard = 0
        self.eval_train = 1
        self.seed = 0
        self.silent = 0
        self.dev = "tpu"
        self.compute_dtype = "float32"
        self.epoch_counter = 0
        self.sample_counter = 0
        self.round = 0
        self.metric = MetricSet()
        self.train_metric = MetricSet()
        self.eval_nodes: List[Tuple[str, int]] = []
        self.net_cfg: Optional[NetConfig] = None
        self.net: Optional[Network] = None
        self.params = None
        self.opt: Optional[NetUpdater] = None
        self.opt_state = None
        self.device: Optional[torch.device] = None
        # dropout's randomness, on the net's device
        self.generator: Optional[torch.Generator] = None
        # the last step's loss, on the device (not synchronised)
        self.last_loss: Optional[torch.Tensor] = None
        # the last step's train-metric scores on their way to the host
        self._pending = None

    def set_param(self, name: str, val: str) -> None:
        """Config broadcast (reference: nnet_impl-inl.hpp:31-69)."""
        if val == "default":
            return
        if name == "batch_size":
            self.batch_size = int(val)
        elif name == "update_period":
            self.update_period = int(val)
        elif name == "fuse_steps":
            self.fuse_steps = int(val)
        elif name == "nan_guard":
            self.nan_guard = int(val)
        elif name in ("eval_train", "train_eval"):
            self.eval_train = int(val)
        elif name == "seed":
            self.seed = int(val)
        elif name == "silent":
            self.silent = int(val)
        elif name == "dev":
            self.dev = val
        elif name == "dtype":
            self.compute_dtype = val
        if name.startswith("metric"):
            m = re.match(r"metric\[([^,\]]+),([^\]]+)\]", name)
            if m:
                self.metric.add_metric(val, m.group(1))
                self.train_metric.add_metric(val, m.group(1))
                self.eval_nodes.append((m.group(2), 0))
            else:
                m2 = re.match(r"metric\[([^,\]]+)\]", name)
                field = m2.group(1) if m2 else "label"
                self.metric.add_metric(val, field)
                self.train_metric.add_metric(val, field)
                self.eval_nodes.append(("", -1))
        self.cfg.append((name, val))

    # ------------------------------------------------------------------
    def _build_network(self) -> None:
        for key, val in (("update_period", self.update_period),
                         ("fuse_steps", self.fuse_steps)):
            if val > 1:
                raise NotImplementedError(
                    "%s = %d comes with the CNN zoo and data slice "
                    "(ROADMAP.md)" % (key, val))
        if self.nan_guard:
            raise NotImplementedError(
                "nan_guard comes with the CNN zoo and data slice "
                "(ROADMAP.md)")
        self.device = select_device(self.dev)
        self.net = Network(self.net_cfg, self.batch_size,
                           update_period=self.update_period,
                           compute_dtype=self.compute_dtype,
                           device=self.device)
        # eval node requests (reference nnet_impl-inl.hpp:363-374)
        self.eval_req: List[int] = []
        for name, kind in self.eval_nodes:
            if kind < 0:
                self.eval_req.append(self.net.out_node)
            elif name not in self.net_cfg.node_name_map:
                raise ValueError("Cannot find node name: %s" % name)
            else:
                self.eval_req.append(self.net_cfg.node_name_map[name])
        if not self.eval_req:
            self.eval_req = [self.net.out_node]
        self.generator = torch.Generator(device=self.device).manual_seed(
            self.seed * 2243 + 7)

    def _finish_init(self, loaded_opt_state=None) -> None:
        """Updaters, optimizer slots (fresh, then any loaded ones merged
        in) and the trainable parameters' ``requires_grad``."""
        self.opt = NetUpdater(self.net)
        self.opt_state = self.opt.init_state(self.params)
        for li, loaded in enumerate(loaded_opt_state or []):
            if not loaded or self.opt_state[li] is None:
                continue
            for tag, slots in loaded.items():
                if tag in self.opt_state[li] and slots:
                    self.opt_state[li][tag] = slots
        for li, p in enumerate(self.params):
            for tag, w in (p or {}).items():
                if tag in (self.opt.updaters[li] or {}):
                    w.requires_grad_(True)

    def init_model(self) -> None:
        """Parse the structure and draw fresh parameters from ``seed``."""
        self.net_cfg = NetConfig()
        self.net_cfg.configure(self.cfg)
        self._build_network()
        self.params = self.net.init_params(self.seed)
        self._finish_init()

    def load_model(self, path: str) -> None:
        """Restore structure + epoch + weights + optimizer slots from a
        ``.model`` file written by either package."""
        net_cfg, epoch, params, opt_state, _ = checkpoint.load_model(path)
        self.net_cfg = net_cfg
        # refresh the config buckets + verify the declared structure
        self.net_cfg.configure(self.cfg)
        self.epoch_counter = epoch
        self._build_network()
        self.params = weights.from_jax_params(params, self.device)
        self._finish_init(None if opt_state is None else
                          weights.from_jax_opt_state(opt_state, self.params))

    def save_model(self, path: str) -> None:
        checkpoint.save_model(path, self.net_cfg, self.epoch_counter,
                              weights.to_jax_params(self.params),
                              weights.to_jax_opt_state(self.opt_state))

    # ------------------------------------------------------------------
    def host_data(self, data) -> np.ndarray:
        """A batch (a DataBatch-like with ``.data``, or the array itself)
        as the float32 host array the net's input node takes, packed
        space-to-depth when a conv on the data node asks for it."""
        data = np.asarray(getattr(data, "data", data), np.float32)
        if self.net.input_s2d and data.ndim == 4 and \
                data.shape[1] == self.net_cfg.input_shape[0]:
            data = s2d_pack(data, self.net.input_s2d)
        return data

    def _label_fields(self, batch: DataBatch,
                      rows: int) -> Dict[str, np.ndarray]:
        """{field name: (rows, w) label columns} (reference
        GetLabelInfo, nnet_impl-inl.hpp:271-285)."""
        return {name: np.asarray(batch.label[:rows, a:b], np.float32)
                for name, idx in self.net_cfg.label_name_map.items()
                for a, b in [self.net_cfg.label_range[idx]]}

    def stage(self, batch: DataBatch) -> StagedBatch:
        """Pack a host batch and copy it and its label fields to the
        device; ``update`` takes the result in place of the batch."""
        data = torch.from_numpy(self.host_data(batch)).to(self.device)
        labels = [torch.from_numpy(np.ascontiguousarray(
                      batch.label[:, a:b], np.float32)).to(self.device)
                  for a, b in self.net_cfg.label_range]
        return StagedBatch(data, labels, batch)

    def start_round(self, round_: int) -> None:
        self.round = round_

    def update(self, batch, plain: bool = False) -> None:
        """One minibatch of training (reference: nnet_impl-inl.hpp:141-185;
        trainer.py:1016-1053 of the JAX package): a DataBatch or a
        StagedBatch from :meth:`stage`. ``plain`` runs every kernel's
        plain version instead (the reference the kernel path is held
        against on the card). Nothing here waits for the device."""
        staged = batch if isinstance(batch, StagedBatch) else \
            self.stage(batch)
        for p in self.params:
            for w in (p or {}).values():
                w.grad = None
        with torch.enable_grad():
            values, loss = self.net.apply(
                self.params, staged.data, labels=staged.labels, train=True,
                plain=plain, generator=self.generator)
            if self.eval_train and self.train_metric.evals:
                self._queue_train_metric(
                    [values[i].detach() for i in self.eval_req], staged.host)
            loss.backward()
        grads = [None if p is None else
                 {tag: w.grad for tag, w in p.items() if w.grad is not None}
                 for p in self.params]
        self.opt.apply_(self.params, grads, self.opt_state,
                        self.epoch_counter)
        self.last_loss = loss.detach()
        self.sample_counter += 1
        if self.sample_counter >= self.update_period:
            self.sample_counter = 0
            self.epoch_counter += 1

    def _queue_train_metric(self, preds: List[torch.Tensor],
                            host: DataBatch) -> None:
        """Start the copy of this step's scores to the host (pinned,
        asynchronous on a card) and fold the previous step's, whose copy
        has long landed, into the train metric: the host never waits on
        the step it just launched."""
        self._drain_train_metric()
        n = host.batch_size
        flat = [p.reshape(p.shape[0], -1) for p in preds]
        event = None
        if self.device.type == "cuda":
            flat = [p.to("cpu", non_blocking=True) for p in flat]
            event = torch.cuda.Event()
            event.record()
        self._pending = (flat, event, self._label_fields(host, n))

    def _drain_train_metric(self) -> None:
        if self._pending is None:
            return
        flat, event, labels = self._pending
        self._pending = None
        if event is not None:
            event.synchronize()
        self.train_metric.add_eval([p.numpy() for p in flat], labels)

    # ------------------------------------------------------------------
    def evaluate(self, iter_eval: Optional[DataIterator],
                 data_name: str) -> str:
        """Round-end metric report (reference: nnet_impl-inl.hpp:224-245):
        the train metric over the round's steps, then ``iter_eval``'s
        (padding rows excluded)."""
        ret = ""
        if self.eval_train and self.train_metric.evals:
            self._drain_train_metric()
            ret += self.train_metric.print("train")
            self.train_metric.clear()
        if iter_eval is None or not self.metric.evals:
            return ret
        self.metric.clear()
        iter_eval.before_first()
        while iter_eval.next():
            batch = iter_eval.value
            nvalid = batch.batch_size - batch.num_batch_padd
            outs = [v.cpu().numpy() for v in
                    self.forward_device(batch, self.eval_req)]
            self.metric.add_eval(
                [o.reshape(o.shape[0], -1)[:nvalid] for o in outs],
                self._label_fields(batch, nvalid))
        ret += self.metric.print(data_name)
        return ret

    def forward_device(self, data, node_ids: Sequence[int],
                       plain: bool = False) -> List[torch.Tensor]:
        """Forward one batch; returns the requested nodes' values on the
        device, not yet synchronised. Runs under ``torch.inference_mode``
        (entered here, on the calling thread: the mode is thread-local)."""
        x = torch.from_numpy(self.host_data(data)).to(self.device)
        with torch.inference_mode():
            values, _ = self.net.apply(self.params, x, plain=plain)
        return [values[i] for i in node_ids]

    def forward_nodes(self, batch, node_ids: Sequence[int]
                      ) -> List[np.ndarray]:
        """Forward one batch; returns the requested nodes' values on the
        host (trainer.py:1178). The data node comes back unpacked."""
        out = [v.cpu().numpy()
               for v in self.forward_device(batch, node_ids)]
        if self.net.input_s2d:
            _, h, w = self.net_cfg.input_shape
            out = [s2d_unpack(v, self.net.input_s2d, (h, w)) if ni == 0
                   else v for ni, v in zip(node_ids, out)]
        return out
