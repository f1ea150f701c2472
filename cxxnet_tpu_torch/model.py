"""Network: the netconfig DAG interpreted into one forward function — the
port of ``cxxnet_tpu/model.py`` in eval mode.

Semantics preserved from the reference (and the JAX Network):
  * connection order = config order; a node's value is whatever the last
    connection wrote to it (self-loop layers update in place)
  * loss layers transform their node (softmax probs visible to predict)
  * shared layers reuse the primary connection's parameters
    (nnet_config.h:57-59, neural_net-inl.hpp:238-244)

Training (losses, gradients, the updaters) is a later slice: ``apply``
runs inference only.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import layers as L
from .graph import NetConfig, SHARED_LAYER



class Network:
    """Static model structure + init/apply over tensors on ``device``."""

    def __init__(self, net_cfg: NetConfig, batch_size: int,
                 compute_dtype: str = "float32",
                 device: torch.device = torch.device("cpu")) -> None:
        self.cfg = net_cfg
        self.batch_size = batch_size
        self.compute_dtype = getattr(torch, compute_dtype)
        if not isinstance(self.compute_dtype, torch.dtype):
            raise ValueError("dtype=%s is not a torch dtype" % compute_dtype)
        self.device = torch.device(device)
        self.modules: List[L.Layer] = []
        self.node_shapes: List[Optional[Tuple[int, ...]]] = (
            [None] * net_cfg.num_nodes)

        c, h, w = net_cfg.input_shape
        self.node_shapes[0] = (batch_size, c, h, w)
        for i in range(net_cfg.extra_data_num):
            ec, eh, ew = net_cfg.extra_shape[3 * i: 3 * i + 3]
            self.node_shapes[i + 1] = (batch_size, ec, eh, ew)

        for li, info in enumerate(net_cfg.layers):
            type_name = info.type
            if type_name == SHARED_LAYER:
                type_name = net_cfg.layers[info.primary_layer_index].type
            if type_name == "pairtest":
                raise NotImplementedError(
                    "pairtest layers come with the training slice "
                    "(ROADMAP.md)")
            mod = L.create_layer(type_name, net_cfg.effective_layer_cfg(li),
                                 net_cfg.label_name_map)
            in_shapes = []
            for ni in info.nindex_in:
                if self.node_shapes[ni] is None:
                    raise ValueError(
                        "node %s used before it is produced"
                        % net_cfg.node_names[ni])
                in_shapes.append(self.node_shapes[ni])
            out_shapes = mod.infer_shape(in_shapes)
            if len(out_shapes) != len(info.nindex_out):
                raise ValueError("layer %d produced %d outputs, expected %d"
                                 % (li, len(out_shapes), len(info.nindex_out)))
            for no, shp in zip(info.nindex_out, out_shapes):
                if self.node_shapes[no] is not None and \
                        self.node_shapes[no] != shp and no not in info.nindex_in:
                    raise ValueError(
                        "conflicting shapes for node %s: %s vs %s"
                        % (net_cfg.node_names[no], self.node_shapes[no], shp))
                self.node_shapes[no] = shp
            self.modules.append(mod)

        # space-to-depth input packing (model.py:111-132): the trainer
        # packs batches on the host for a conv on the data node, which
        # must then be the node's only consumer
        self.input_s2d = 0
        consumers = [li for li, info in enumerate(net_cfg.layers)
                     if 0 in info.nindex_in]
        for li, (info, mod) in enumerate(zip(net_cfg.layers, self.modules)):
            b = getattr(mod, "s2d", 0)
            if not b:
                continue
            if 0 not in info.nindex_in:
                raise ValueError(
                    "space_to_depth is only supported on a conv reading "
                    "the input node (layer %d reads nodes %s)"
                    % (li, info.nindex_in))
            if len(consumers) != 1:
                raise ValueError(
                    "space_to_depth conv must be the only consumer of the "
                    "input node (layers %s all read it)" % consumers)
            self.input_s2d = b

    # ------------------------------------------------------------------
    def init_params(self, seed: int = 0) -> List[Optional[dict]]:
        """Per-layer parameter dicts on the network's device, drawn from
        one CPU generator seeded with ``seed`` (the same weights on every
        device); shared layers hold None and read the primary's slot."""
        gen = torch.Generator().manual_seed(int(seed))
        params: List[Optional[dict]] = []
        for info, mod in zip(self.cfg.layers, self.modules):
            if info.type == SHARED_LAYER or not mod.has_params:
                params.append(None)
            else:
                params.append({k: v.to(self.device)
                               for k, v in mod.init_params(gen).items()})
        return params

    def _layer_params(self, params, li: int):
        info = self.cfg.layers[li]
        if info.type == SHARED_LAYER:
            return params[info.primary_layer_index]
        return params[li]

    # ------------------------------------------------------------------
    def apply(self, params, data: torch.Tensor,
              extra_data: Sequence[torch.Tensor] = (),
              train: bool = False, plain: bool = False
              ) -> Dict[int, torch.Tensor]:
        """Run the DAG; returns {node_index: value}. ``plain`` runs each
        kernel's plain PyTorch version instead of the kernel (the
        reference forward)."""
        if train:
            raise NotImplementedError(
                "training comes with the training slice (ROADMAP.md)")
        ctx = L.ApplyContext(train=False, compute_dtype=self.compute_dtype,
                             plain=plain)
        values: Dict[int, torch.Tensor] = {0: data}
        for i, x in enumerate(extra_data):
            values[i + 1] = x
        for li, (info, mod) in enumerate(zip(self.cfg.layers, self.modules)):
            inputs = [values[ni] for ni in info.nindex_in]
            outputs = mod.apply(self._layer_params(params, li), inputs, ctx)
            for no, v in zip(info.nindex_out, outputs):
                values[no] = v
        return values

    @property
    def out_node(self) -> int:
        """Default eval/predict node = last node (reference
        nnet_impl-inl.hpp:190 nodes.back())."""
        return self.cfg.num_nodes - 1
