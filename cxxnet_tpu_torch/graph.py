"""Network-structure configuration: the ``netconfig`` graph language.

Reimplements the semantics of the reference NetConfig
(reference: src/nnet/nnet_config.h:26-411): a flat ordered config stream is
interpreted into a DAG of named *nodes* (activation slots) connected by
*layers*, plus per-layer config buckets and global defaults.

This is the port's own copy of ``cxxnet_tpu/graph.py`` (the port imports
nothing of the JAX package); keep the two in step.

Grammar recap (reference file:line cites are into the original cxxnet):

  * ``netconfig = start`` ... ``netconfig = end`` brackets the net section
  * ``layer[src->dst] = type:name`` declares a layer between named nodes
    (comma lists allowed on either side); ``layer[+1] = type`` appends a new
    anonymous node after the current top node; ``layer[+1:tag] = type`` names
    it; ``layer[+0] = type`` is a self-loop layer mutating the top node
    (nnet_config.h:303-360)
  * keys following a ``layer[...]`` line route to that layer's bucket until
    the next layer line or ``netconfig=end`` (nnet_config.h:280-287)
  * ``share[tag]``-typed layers alias the params of a previously named
    primary layer (nnet_config.h:338-346)
  * ``label_vec[a,b) = name`` declares a label field slice of the label
    matrix (nnet_config.h:195-202); field "label" = [0,1) exists by default
  * ``extra_data_num`` / ``extra_data_shape[i]`` declare extra input nodes
    ``in_1..in_n`` (nnet_config.h:223-246)
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

ConfigEntry = Tuple[str, str]

# special type tag for shared layers (reference layer.h:284)
SHARED_LAYER = "share"

# layer type names understood by the reference factory
# (reference src/layer/layer.h:322-361). "softplus"/"maxout" have enum ids
# but no factory case in the reference; we implement softplus for real.
KNOWN_LAYER_TYPES = frozenset([
    "fullc", "fixconn", "bias", "softmax", "relu", "sigmoid", "tanh",
    "softplus", "flatten", "dropout", "conv", "relu_max_pooling",
    "max_pooling", "sum_pooling", "avg_pooling", "lrn", "concat", "xelu",
    "split", "insanity", "insanity_max_pooling", "l2_loss",
    "multi_logistic", "ch_concat", "prelu", "batch_norm",
    # TPU-native additions: forced-Pallas variants for differential testing,
    # the long-context attention layer (ring/ulysses under seq_parallel),
    # and mixture-of-experts fullc (expert parallelism over the model axis)
    # and pipelined transformer stacks (depth-stacked params, scanned on
    # one chip, pipelined over the pipe axis under pipeline_parallel)
    # elewise_add closes residual/skip connections (ResNet-family nets)
    "lrn_pallas", "lrn_band", "attention", "moe_fullc", "transformer_stack",
    "elewise_add", "embed",
])


def _known_layer_type(t: str) -> bool:
    """Config-time validation consults the LIVE layer registry so user
    code extending the framework via @layers.register (docs/extending.md
    — the reference's op.h/mshadow-expression extension point) can name
    its types in a netconfig like any built-in."""
    if t in KNOWN_LAYER_TYPES:
        return True
    from .layers import _REGISTRY
    return t in _REGISTRY

# self-loop loss layers (in == out node); see src/layer/loss/
LOSS_LAYER_TYPES = frozenset(["softmax", "l2_loss", "multi_logistic"])


class GraphConfigError(ValueError):
    pass


@dataclass
class LayerInfo:
    """Structure record for one layer (reference nnet_config.h:52-83)."""
    type: str                       # layer type name, or "share"
    name: str = ""                  # optional layer tag
    nindex_in: List[int] = field(default_factory=list)
    nindex_out: List[int] = field(default_factory=list)
    primary_layer_index: int = -1   # only for shared layers
    # pairtest encoding: (master, slave) type names when type == "pairtest"
    pair: Optional[Tuple[str, str]] = None

    def same_structure(self, other: "LayerInfo") -> bool:
        return (self.type == other.type
                and self.name == other.name
                and self.nindex_in == other.nindex_in
                and self.nindex_out == other.nindex_out
                and self.primary_layer_index == other.primary_layer_index)


def parse_layer_type(val: str) -> Tuple[str, str, Optional[Tuple[str, str]], str]:
    """Split a layer declaration value into (type, name, pair, share_tag).

    Mirrors GetLayerInfo value parsing + GetLayerType
    (reference nnet_config.h:331-358, layer.h:322-361).
    """
    share_tag = ""
    if ":" in val:
        ltype, lname = val.split(":", 1)
    else:
        ltype, lname = val, ""
    pair = None
    if ltype.startswith("pairtest-"):
        rest = ltype[len("pairtest-"):]
        m = re.match(r"([^-]+)-(.+)", rest)
        if not m:
            raise GraphConfigError("invalid pairtest spec: %s" % val)
        pair = (m.group(1), m.group(2))
        ltype = "pairtest"
    elif ltype.startswith(SHARED_LAYER):
        m = re.match(r"share\[([^\]]+)\]", ltype)
        if not m:
            raise GraphConfigError(
                "shared layer must specify tag of layer to share with")
        share_tag = m.group(1)
        ltype = SHARED_LAYER
    elif not _known_layer_type(ltype):
        raise GraphConfigError('unknown layer type: "%s"' % ltype)
    if pair is not None:
        for t in pair:
            if not _known_layer_type(t):
                raise GraphConfigError('unknown layer type: "%s"' % t)
    return ltype, lname, pair, share_tag


def _dedup_last(entries):
    """Collapse repeated keys keeping the last occurrence, order-preserving.

    ``label_vec[a,b)`` entries are keyed by (name, value): each declares a
    distinct named label *field*, not a later-wins assignment."""
    def key(name, val):
        return (name, val) if name.startswith("label_vec[") else name
    last = {key(k, v): i for i, (k, v) in enumerate(entries)}
    return [kv for i, kv in enumerate(entries)
            if last[key(kv[0], kv[1])] == i]


class NetConfig:
    """Parsed network structure + configuration buckets.

    Attributes mirror the reference NetConfig:
      * node_names / node_name_map — activation slot names
      * layers — list of LayerInfo
      * layercfg — per-layer config key/value bucket
      * defcfg — global (non-layer) config entries, in order
      * label_name_map / label_range — label field slicing
      * input_shape — (channel, height, width), no batch dim
      * extra_shape — flat list of 3 ints per extra input
    """

    def __init__(self) -> None:
        self.node_names: List[str] = []
        self.node_name_map: Dict[str, int] = {}
        self.layers: List[LayerInfo] = []
        self.layercfg: List[List[ConfigEntry]] = []
        self.defcfg: List[ConfigEntry] = []
        self.layer_name_map: Dict[str, int] = {}
        self.updater_type: str = "sgd"
        self.sync_type: str = "simple"
        self.label_name_map: Dict[str, int] = {"label": 0}
        self.label_range: List[Tuple[int, int]] = [(0, 1)]
        self.input_shape: Tuple[int, int, int] = (0, 0, 0)
        self.extra_data_num: int = 0
        self.extra_shape: List[int] = []
        self.init_end: bool = False

    # ------------------------------------------------------------------
    @property
    def num_nodes(self) -> int:
        return len(self.node_names)

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    def get_layer_index(self, name: str) -> int:
        if name not in self.layer_name_map:
            raise GraphConfigError("unknown layer name %s" % name)
        return self.layer_name_map[name]

    # ------------------------------------------------------------------
    def _get_node_index(self, name: str, alloc_unknown: bool) -> int:
        if name in self.node_name_map:
            return self.node_name_map[name]
        if not alloc_unknown:
            raise GraphConfigError(
                "undefined node name %s: input node of a layer must be the "
                "output of a layer declared before it" % name)
        idx = len(self.node_names)
        self.node_name_map[name] = idx
        self.node_names.append(name)
        return idx

    def _set_global_param(self, name: str, val: str) -> None:
        # reference nnet_config.h:192-203
        if name == "updater":
            self.updater_type = val
        if name == "sync":
            # parsed for config compatibility, intentionally inert: the
            # reference's sync= picks a PS update strategy (simple/bsp),
            # which GSPMD subsumes — one jitted SPMD step has exactly one
            # (synchronous all-reduce) semantics, so there is nothing to
            # select. Kept so reference confs load unchanged.
            self.sync_type = val
        m = re.match(r"label_vec\[(\d+),(\d+)\)", name)
        if m:
            a, b = int(m.group(1)), int(m.group(2))
            # idempotent so a checkpoint-restored base plus the same live
            # config entry yields one field (later wins on the range)
            idx = self.label_name_map.get(val)
            if idx is not None and idx > 0:
                self.label_range[idx] = (a, b)
            else:
                self.label_range.append((a, b))
                self.label_name_map[val] = len(self.label_range) - 1

    def _parse_layer_decl(self, name: str, val: str,
                          top_node: int, cfg_layer_index: int) -> LayerInfo:
        # reference nnet_config.h:303-360 (GetLayerInfo)
        info = LayerInfo(type="")
        m_inc = re.match(r"layer\[\+(\d+)(?::([^\]]+))?\]", name)
        m_arrow = re.match(r"layer\[([^\]>]+)->([^\]]+)\]", name)
        if m_inc:
            if top_node < 0:
                raise GraphConfigError(
                    "layer[+1] used but last layer has more than one output; "
                    "use layer[input->output] instead")
            inc = int(m_inc.group(1))
            # a tag is only honored on the literal "+1:" form — the reference
            # matches sscanf("layer[+1:%[^]]]") and otherwise falls through to
            # self-loop / auto-named node (nnet_config.h:309-324)
            tag = m_inc.group(2) if inc == 1 else None
            info.nindex_in.append(top_node)
            if tag is not None:
                info.nindex_out.append(self._get_node_index(tag, True))
            elif inc == 0:
                info.nindex_out.append(top_node)
            else:
                auto = "!node-after-%d" % top_node
                info.nindex_out.append(self._get_node_index(auto, True))
        elif m_arrow:
            for tok in m_arrow.group(1).split(","):
                info.nindex_in.append(self._get_node_index(tok, False))
            for tok in m_arrow.group(2).split(","):
                info.nindex_out.append(self._get_node_index(tok, True))
        else:
            raise GraphConfigError("invalid layer format %s" % name)

        ltype, lname, pair, share_tag = parse_layer_type(val)
        info.type = ltype
        info.pair = pair
        if ltype == SHARED_LAYER:
            if share_tag not in self.layer_name_map:
                raise GraphConfigError(
                    "shared layer tag %s is not defined before" % share_tag)
            info.primary_layer_index = self.layer_name_map[share_tag]
        elif lname:
            if lname in self.layer_name_map:
                if self.layer_name_map[lname] != cfg_layer_index:
                    raise GraphConfigError(
                        "layer name in configuration does not match the "
                        "name stored in model")
            else:
                self.layer_name_map[lname] = cfg_layer_index
            info.name = lname
        return info

    # ------------------------------------------------------------------
    def configure(self, cfg: List[ConfigEntry]) -> None:
        """Interpret an ordered config stream (reference nnet_config.h:207-289).

        May be called again after structure is fixed (e.g. when continuing
        training): layer declarations are then checked for consistency and
        only the config buckets are refreshed.
        """
        # buckets restored from a checkpoint are the base; entries from the
        # live config stream append after and win (later-wins semantics,
        # reference nnet_config.h:255-287)
        self.defcfg = []
        loaded = getattr(self, "_loaded_layercfg", None)
        if loaded and len(loaded) == len(self.layers):
            self.layercfg = [list(b) for b in loaded]
        else:
            self.layercfg = [[] for _ in self.layers]
        # label/extra declarations are re-interpreted from scratch on every
        # configure() call so re-configuring (continue training) does not
        # duplicate entries
        self.label_name_map = {"label": 0}
        self.label_range = [(0, 1)]
        self.extra_shape = []
        # a checkpoint-restored global config base (updater/sync/label_vec/
        # extra_data_*/hyperparams) is replayed through the same
        # interpretation loop as the live stream, which runs after and wins
        cfg = list(getattr(self, "_loaded_defcfg", []) or []) + list(cfg)
        if not self.node_names:
            self.node_names.append("in")
            self.node_name_map["in"] = 0
        self.node_name_map["0"] = 0

        netcfg_mode = 0
        cfg_top_node = 0
        cfg_layer_index = 0
        extra_by_bracket: Dict[int, List[int]] = {}
        for name, val in cfg:
            if name == "extra_data_num":
                num = int(val)
                for i in range(num):
                    nm = "in_%d" % (i + 1)
                    idx = self._get_node_index(nm, True)
                    if idx != i + 1:
                        raise GraphConfigError(
                            "extra_data_num must be declared before any "
                            "layer so that in_%d gets node index %d"
                            % (i + 1, i + 1))
                self.extra_data_num = num
            if name.startswith("extra_data_shape["):
                m = re.match(r"extra_data_shape\[(\d+)\]", name)
                if not m:
                    raise GraphConfigError("extra data shape config incorrect")
                xyz = [int(t) for t in val.split(",")]
                if len(xyz) != 3:
                    raise GraphConfigError("extra data shape config incorrect")
                # keyed by bracket number so a checkpoint-restored entry
                # replayed before the same live entry stays idempotent and
                # a changed live value wins; materialised in sorted-bracket
                # order below, which accepts 0-based and 1-based configs
                # alike (the reference ignores the number entirely and
                # appends in declaration order, nnet_config.h:236-245)
                extra_by_bracket[int(m.group(1))] = xyz
            if not self.init_end and name == "input_shape":
                dims = tuple(int(t) for t in val.split(","))
                if len(dims) != 3:
                    raise GraphConfigError(
                        "input_shape must be three integers, e.g. 1,1,200")
                self.input_shape = dims  # (channel, height, width)
            if netcfg_mode != 2:
                self._set_global_param(name, val)
            if name == "netconfig" and val == "start":
                netcfg_mode = 1
            if name == "netconfig" and val == "end":
                netcfg_mode = 0
            if name.startswith("layer["):
                info = self._parse_layer_decl(
                    name, val, cfg_top_node, cfg_layer_index)
                netcfg_mode = 2
                if not self.init_end:
                    if len(self.layers) != cfg_layer_index:
                        raise GraphConfigError("NetConfig inconsistent")
                    self.layers.append(info)
                    self.layercfg.append([])
                else:
                    if cfg_layer_index >= len(self.layers):
                        raise GraphConfigError("config layer index exceeds bound")
                    if not info.same_structure(self.layers[cfg_layer_index]):
                        raise GraphConfigError(
                            "config setting does not match existing "
                            "network structure")
                if len(info.nindex_out) == 1:
                    cfg_top_node = info.nindex_out[0]
                else:
                    cfg_top_node = -1
                cfg_layer_index += 1
                continue
            if netcfg_mode == 2:
                if self.layers[cfg_layer_index - 1].type == SHARED_LAYER:
                    raise GraphConfigError(
                        "do not set parameters on a shared layer; set them "
                        "on the primary layer")
                self.layercfg[cfg_layer_index - 1].append((name, val))
            else:
                self.defcfg.append((name, val))
        if extra_by_bracket:
            self.extra_shape = [
                x for k in sorted(extra_by_bracket)
                for x in extra_by_bracket[k]]
        if not self.init_end:
            self.init_end = True

    # ------------------------------------------------------------------
    def effective_layer_cfg(self, layer_index: int) -> List[ConfigEntry]:
        """Config entries seen by one layer: global defaults first, then the
        layer's own bucket — later entries win, matching the reference's
        SetParam ordering (reference neural_net-inl.hpp:252-264)."""
        info = self.layers[layer_index]
        if info.type == SHARED_LAYER:
            layer_index = info.primary_layer_index
        return list(self.defcfg) + list(self.layercfg[layer_index])

    def resolve_primary(self, layer_index: int) -> int:
        """Index of the layer owning the params (self unless shared)."""
        info = self.layers[layer_index]
        if info.type == SHARED_LAYER:
            return info.primary_layer_index
        return layer_index

    # ------------------------------------------------------------------
    # structure (de)serialization — see checkpoint.py for the container
    def structure_state(self) -> dict:
        return {
            "input_shape": list(self.input_shape),
            "extra_data_num": self.extra_data_num,
            "extra_shape": list(self.extra_shape),
            "node_names": list(self.node_names),
            "layers": [
                {
                    "type": l.type,
                    "name": l.name,
                    "nindex_in": list(l.nindex_in),
                    "nindex_out": list(l.nindex_out),
                    "primary_layer_index": l.primary_layer_index,
                    "pair": list(l.pair) if l.pair else None,
                }
                for l in self.layers
            ],
            # config buckets: the reference re-derives layer hyperparams
            # from loaded weight shapes (LoadNet ClearConfig,
            # nnet_config.h:171-191); the functional build needs them at
            # graph-build time, so they travel with the structure.
            # Deduped keep-last so repeated save/resume cycles do not grow
            # the buckets (set_param is assignment-based, later wins).
            "layercfg": [[list(kv) for kv in _dedup_last(b)]
                         for b in self.layercfg],
            "defcfg": [list(kv) for kv in _dedup_last(self.defcfg)],
        }

    @classmethod
    def from_structure_state(cls, state: dict) -> "NetConfig":
        net = cls()
        net.input_shape = tuple(state["input_shape"])
        net.extra_data_num = state["extra_data_num"]
        net.extra_shape = list(state["extra_shape"])
        net.node_names = list(state["node_names"])
        net.node_name_map = {n: i for i, n in enumerate(net.node_names)}
        buckets = state.get("layercfg") or [[] for _ in state["layers"]]
        for i, ls in enumerate(state["layers"]):
            info = LayerInfo(
                type=ls["type"], name=ls["name"],
                nindex_in=list(ls["nindex_in"]),
                nindex_out=list(ls["nindex_out"]),
                primary_layer_index=ls["primary_layer_index"],
                pair=tuple(ls["pair"]) if ls.get("pair") else None)
            net.layers.append(info)
            net.layercfg.append([tuple(kv) for kv in buckets[i]])
            if info.name and info.type != SHARED_LAYER:
                if info.name in net.layer_name_map:
                    raise GraphConfigError(
                        "duplicated layer name: %s" % info.name)
                net.layer_name_map[info.name] = i
        net.defcfg = [tuple(kv) for kv in state.get("defcfg", [])]
        net._loaded_layercfg = [list(b) for b in net.layercfg]
        net._loaded_defcfg = list(net.defcfg)
        net.init_end = True
        return net
