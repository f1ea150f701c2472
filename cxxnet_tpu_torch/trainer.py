"""Trainer: the config-driven owner of a net and its parameters — the
inference subset of ``cxxnet_tpu/trainer.py`` this slice serves with.

It consumes the same config keys (``batch_size``, ``dev``, ``dtype``,
``seed``, ...), builds the network on the device ``dev`` names
(device.py), initialises it from ``seed`` or loads a ``.model`` either
package wrote, and runs the forward: ``forward_nodes`` answers on the
host, ``forward_device`` leaves the answer on the device for a caller
that materialises it later (the serving engine's completion thread).
Batches are packed space-to-depth on the host when the net asks for it
(trainer.py:850-856). Training, eval metrics and the data iterators come
with the training slice.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import checkpoint, weights
from .device import select_device
from .graph import NetConfig
from .layers import s2d_pack, s2d_unpack
from .model import Network

ConfigEntry = Tuple[str, str]


class Trainer:
    def __init__(self) -> None:
        self.cfg: List[ConfigEntry] = []
        self.batch_size = 100
        self.seed = 0
        self.dev = "tpu"
        self.compute_dtype = "float32"
        self.epoch_counter = 0
        self.net_cfg: Optional[NetConfig] = None
        self.net: Optional[Network] = None
        self.params = None
        self.device: Optional[torch.device] = None

    def set_param(self, name: str, val: str) -> None:
        """Config broadcast (reference: nnet_impl-inl.hpp:31-69)."""
        if val == "default":
            return
        if name == "batch_size":
            self.batch_size = int(val)
        elif name == "seed":
            self.seed = int(val)
        elif name == "dev":
            self.dev = val
        elif name == "dtype":
            self.compute_dtype = val
        self.cfg.append((name, val))

    # ------------------------------------------------------------------
    def _build_network(self) -> None:
        self.device = select_device(self.dev)
        self.net = Network(self.net_cfg, self.batch_size,
                           compute_dtype=self.compute_dtype,
                           device=self.device)

    def init_model(self) -> None:
        """Parse the structure and draw fresh parameters from ``seed``."""
        self.net_cfg = NetConfig()
        self.net_cfg.configure(self.cfg)
        self._build_network()
        self.params = self.net.init_params(self.seed)

    def load_model(self, path: str) -> None:
        """Restore structure + epoch + weights from a ``.model`` file
        written by either package (optimizer state is not needed to
        serve and is not kept)."""
        net_cfg, epoch, params, _, _ = checkpoint.load_model(path)
        self.net_cfg = net_cfg
        # refresh the config buckets + verify the declared structure
        self.net_cfg.configure(self.cfg)
        self.epoch_counter = epoch
        self._build_network()
        self.params = weights.from_jax_params(params, self.device)

    def save_model(self, path: str) -> None:
        checkpoint.save_model(path, self.net_cfg, self.epoch_counter,
                              weights.to_jax_params(self.params))

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

    def forward_device(self, data, node_ids: Sequence[int],
                       plain: bool = False) -> List[torch.Tensor]:
        """Forward one batch; returns the requested nodes' values on the
        device, not yet synchronised. Runs under ``torch.inference_mode``
        (entered here, on the calling thread: the mode is thread-local)."""
        x = torch.from_numpy(self.host_data(data)).to(self.device)
        with torch.inference_mode():
            values = self.net.apply(self.params, x, plain=plain)
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
