"""Layer library of the port: the cxxnet layers AlexNet serving runs, in
PyTorch, with the JAX package's names, knobs, shape rules and parameter
layouts (``cxxnet_tpu/layers.py``).

Each layer is configured with ``set_param``, infers its output shapes
with ``infer_shape`` and runs ``apply(params, inputs, ctx)`` on tensors.
This slice is inference only: ``apply`` under ``ctx.train`` raises, and
the layer types of later slices are registered (so netconfigs parse)
but raise ``NotImplementedError`` naming their ROADMAP.md slice when a
net is built with them.

Rounding points follow the JAX layers exactly, since whole-net parity
depends on them: activations between layers are float32; conv and fullc
run in the net's compute dtype and round their result to it once before
casting back to float32 (layers.py:1126, 347); LRN sees float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .ops import conv as conv_ops
from .ops import lrn as lrn_ops

Shape4 = Tuple[int, int, int, int]
Params = Dict[str, torch.Tensor]

_REGISTRY: Dict[str, Callable[[], "Layer"]] = {}


def register(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        cls.type_name = name
        return cls
    return deco


def create_layer(type_name: str, cfg: Sequence[Tuple[str, str]],
                 label_name_map: Optional[Dict[str, int]] = None) -> "Layer":
    """Factory mirroring CreateLayer_ (reference: src/layer/layer_impl-inl.hpp:37-79)."""
    if type_name not in _REGISTRY:
        raise ValueError('unknown layer type: "%s"' % type_name)
    layer = _REGISTRY[type_name]()
    layer.label_name_map = label_name_map or {"label": 0}
    for k, v in cfg:
        layer.set_param(k, v)
    return layer


# ----------------------------------------------------------------------
@dataclass
class LayerParam:
    """Common hyper-parameters (reference: src/layer/param.h:15-111)."""
    num_hidden: int = 0
    init_sigma: float = 0.01
    init_uniform: float = -1.0
    init_bias: float = 0.0
    num_channel: int = 0
    random_type: int = 0        # 0 gaussian, 1 uniform/xavier, 2 kaiming
    num_group: int = 1
    kernel_height: int = 0
    kernel_width: int = 0
    stride: int = 1
    pad_y: int = 0
    pad_x: int = 0
    no_bias: int = 0
    silent: int = 0
    num_input_channel: int = 0
    num_input_node: int = 0

    def set_param(self, name: str, val: str) -> None:
        """Keys no branch knows are ignored, as in the reference's
        broadcast (neural_net-inl.hpp:252-264)."""
        if name == "init_sigma":
            self.init_sigma = float(val)
        elif name == "init_uniform":
            self.init_uniform = float(val)
        elif name == "init_bias":
            self.init_bias = float(val)
        elif name == "random_type":
            if val == "gaussian":
                self.random_type = 0
            elif val in ("uniform", "xavier"):
                self.random_type = 1
            elif val == "kaiming":
                self.random_type = 2
            else:
                raise ValueError("invalid random_type %s" % val)
        elif name == "nhidden":
            self.num_hidden = int(val)
        elif name == "nchannel":
            self.num_channel = int(val)
        elif name == "ngroup":
            self.num_group = int(val)
        elif name == "kernel_size":
            self.kernel_height = self.kernel_width = int(val)
        elif name == "kernel_height":
            self.kernel_height = int(val)
        elif name == "kernel_width":
            self.kernel_width = int(val)
        elif name == "stride":
            self.stride = int(val)
        elif name == "pad":
            self.pad_y = self.pad_x = int(val)
        elif name == "pad_y":
            self.pad_y = int(val)
        elif name == "pad_x":
            self.pad_x = int(val)
        elif name == "no_bias":
            self.no_bias = int(val)
        elif name == "silent":
            self.silent = int(val)

    def rand_init_weight(self, gen: torch.Generator, shape, in_num: int,
                         out_num: int) -> torch.Tensor:
        """Weight init (reference: src/layer/param.h:113-138), drawn from
        ``gen`` on the CPU. The distributions are the JAX package's; the
        bits are not (torch and jax generators differ), so parity tests
        carry weights across instead."""
        if self.random_type == 0:
            return torch.randn(shape, generator=gen) * self.init_sigma
        if self.random_type == 1:
            a = math.sqrt(3.0 / (in_num + out_num))
            if self.init_uniform > 0:
                a = self.init_uniform
            return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * a
        if self.random_type == 2:
            if self.num_hidden > 0:
                sigma = math.sqrt(2.0 / self.num_hidden)
            else:
                sigma = math.sqrt(
                    2.0 / (self.num_channel * self.kernel_width
                           * self.kernel_height))
            return torch.randn(shape, generator=gen) * sigma
        raise ValueError("unsupported random_type %d" % self.random_type)


@dataclass
class ApplyContext:
    """Per-forward context threaded through layer application."""
    train: bool = False
    compute_dtype: torch.dtype = torch.float32
    # True runs each kernel's plain PyTorch version on any device: the
    # reference the served answers are held against on the card
    plain: bool = False


def _mat(x: torch.Tensor) -> torch.Tensor:
    """Flat 2D view of a node (reference: layer.h:48-50 FlatTo2D)."""
    return x.reshape(x.shape[0], -1)


def _is_mat(shape: Shape4) -> bool:
    return shape[1] == 1 and shape[2] == 1


class Layer:
    """Base class; one instance per connection, holding static config only."""
    type_name = "?"
    has_params = False
    is_loss = False

    def __init__(self) -> None:
        self.param = LayerParam()
        self.label_name_map: Dict[str, int] = {"label": 0}
        self.in_shapes: List[Shape4] = []
        self.out_shapes: List[Shape4] = []

    def set_param(self, name: str, val: str) -> None:
        self.param.set_param(name, val)

    def infer_shape(self, in_shapes: List[Shape4]) -> List[Shape4]:
        if len(in_shapes) != 1:
            raise ValueError("%s: layer only supports 1 input(s)"
                             % self.type_name)
        out = self._infer(in_shapes)
        self.in_shapes = list(in_shapes)
        self.out_shapes = out
        return out

    def _infer(self, in_shapes: List[Shape4]) -> List[Shape4]:
        return [in_shapes[0]]

    def init_params(self, gen: torch.Generator) -> Params:
        return {}

    def apply(self, params: Params, inputs: List[torch.Tensor],
              ctx: ApplyContext) -> List[torch.Tensor]:
        raise NotImplementedError


# ======================================================================
# dense / structural layers
# ======================================================================
@register("fullc")
class FullConnectLayer(Layer):
    """out = in . W^T + bias (reference: src/layer/fullc_layer-inl.hpp:100-117).

    Weight stored as (nhidden, ninput) exactly like the reference wmat_.
    A plain matrix product: the JAX package leaves it to XLA, the port to
    ``torch.matmul`` (bf16 operands, f32 accumulation, one rounding to
    the compute dtype)."""
    has_params = True

    def __init__(self):
        super().__init__()
        self.seq = 0

    def set_param(self, name, val):
        if name == "seq":
            self.seq = int(val)
        else:
            super().set_param(name, val)

    def _infer(self, in_shapes):
        (n, c, h, w) = in_shapes[0]
        if self.seq:
            if c != 1:
                raise ValueError("FullcLayer(seq): input must be "
                                 "(b,1,s,e)")
        elif not _is_mat(in_shapes[0]):
            raise ValueError("FullcLayer: input needs to be a matrix "
                             "(or set seq = 1 for position-wise use)")
        if self.param.num_hidden <= 0:
            raise ValueError("FullcLayer: must set nhidden correctly")
        if self.param.num_input_node == 0:
            self.param.num_input_node = w
        elif self.param.num_input_node != w:
            raise ValueError("FullcLayer: input hidden nodes inconsistent")
        return [(n, 1, h, self.param.num_hidden)]

    def init_params(self, gen) -> Params:
        nh, ni = self.param.num_hidden, self.param.num_input_node
        p = {"wmat": self.param.rand_init_weight(gen, (nh, ni), ni, nh)}
        if self.param.no_bias == 0:
            p["bias"] = torch.full((nh,), self.param.init_bias)
        return p

    def apply(self, params, inputs, ctx):
        n, _, s, e = inputs[0].shape
        x = inputs[0].reshape(n * s, e).to(ctx.compute_dtype)
        w = params["wmat"].to(ctx.compute_dtype)
        out = torch.matmul(x, w.t()).float()
        if self.param.no_bias == 0:
            out = out + params["bias"]
        return [out.reshape(n, 1, s, self.param.num_hidden)]


@register("flatten")
class FlattenLayer(Layer):
    """(b,c,h,w) -> (b,1,1,c*h*w) (reference: src/layer/flatten_layer-inl.hpp:14-29)."""

    def _infer(self, in_shapes):
        n, c, h, w = in_shapes[0]
        return [(n, 1, 1, c * h * w)]

    def apply(self, params, inputs, ctx):
        return [inputs[0].reshape(inputs[0].shape[0], 1, 1, -1)]


# ======================================================================
# activations
# ======================================================================
class _ActivationLayer(Layer):
    """Elementwise activation (reference: src/layer/activation_layer-inl.hpp:12-44)."""
    fn: Callable[[torch.Tensor], torch.Tensor] = staticmethod(lambda x: x)

    def apply(self, params, inputs, ctx):
        return [self.fn(inputs[0])]


@register("relu")
class ReluLayer(_ActivationLayer):
    fn = staticmethod(torch.relu)


@register("sigmoid")
class SigmoidLayer(_ActivationLayer):
    fn = staticmethod(torch.sigmoid)


@register("tanh")
class TanhLayer(_ActivationLayer):
    fn = staticmethod(torch.tanh)


@register("softplus")
class SoftplusLayer(_ActivationLayer):
    fn = staticmethod(F.softplus)


@register("dropout")
class DropoutLayer(Layer):
    """Self-loop dropout (reference: src/layer/dropout_layer-inl.hpp:12-70):
    the identity at inference, which is all this slice runs."""

    def __init__(self):
        super().__init__()
        self.threshold = 0.0

    def set_param(self, name, val):
        if name == "threshold":
            self.threshold = float(val)
        else:
            super().set_param(name, val)

    def _infer(self, in_shapes):
        if not (0.0 <= self.threshold < 1.0):
            raise ValueError("DropoutLayer: invalid threshold")
        return [in_shapes[0]]

    def apply(self, params, inputs, ctx):
        if ctx.train and self.threshold > 0.0:
            raise NotImplementedError(
                "dropout at train time comes with the training slice "
                "(ROADMAP.md)")
        return [inputs[0]]


# ======================================================================
# conv stack
# ======================================================================
@register("conv")
class ConvolutionLayer(Layer):
    """Grouped 2D convolution through the row-GEMM kernel (ops/conv.py).

    Weights are stored reference-style as ``(ngroup, nchannel/ngroup,
    cin/ngroup*kh*kw)`` and reshaped to OIHW at apply time, as the JAX
    layer does, so checkpoints interchange. Output shape
    (h + 2p - k)//s + 1 (convolution_layer-inl.hpp:174-177).

    ``space_to_depth = b`` (stride==b, pad==0 input convs — AlexNet
    conv1) takes input packed on the host into ``(N, cin*b*b, H/b, W/b)``
    and convolves it stride 1 with the equivalently packed kernel; the
    pack is exact (padded kernel taps are zero). An unpacked input keeps
    its stride and reaches the kernel's stride-1 check.

    ``conv_impl``: ``pallas`` (the JAX name, kept so configs and command
    lines run unchanged) and ``auto`` both select the port's kernel;
    the XLA lowerings (``xla``/``nhwc``/``split``) have no counterpart in
    the port yet.
    """
    has_params = True

    def __init__(self):
        super().__init__()
        self.s2d = 0
        self.impl = "auto"

    def set_param(self, name, val):
        if name == "space_to_depth":
            self.s2d = int(val)
        elif name == "conv_impl":
            if val not in ("auto", "xla", "nhwc", "pallas", "split"):
                raise ValueError(
                    "conv_impl must be auto|xla|nhwc|pallas|split")
            if val not in ("auto", "pallas"):
                raise NotImplementedError(
                    "conv_impl=%s: the port runs convs through its "
                    "row-GEMM kernel (conv_impl=pallas|auto); strided and "
                    "wide-pad convs come with the training slice "
                    "(ROADMAP.md)" % val)
            self.impl = val
        else:
            super().set_param(name, val)

    def _infer(self, in_shapes):
        p = self.param
        n, c, h, w = in_shapes[0]
        if c % p.num_group != 0:
            raise ValueError("input channels must divide group size")
        if p.num_channel % p.num_group != 0:
            raise ValueError("output channels must divide group size")
        if p.num_channel <= 0:
            raise ValueError("must set nchannel correctly")
        if p.kernel_height <= 0 or p.kernel_width <= 0:
            raise ValueError("must set kernel_size correctly")
        if p.kernel_width > w or p.kernel_height > h:
            raise ValueError("kernel size exceeds input")
        if p.num_input_channel == 0:
            p.num_input_channel = c
        elif p.num_input_channel != c:
            raise ValueError("Conv: number of input channels inconsistent")
        oh = (h + 2 * p.pad_y - p.kernel_height) // p.stride + 1
        ow = (w + 2 * p.pad_x - p.kernel_width) // p.stride + 1
        if self.s2d:
            b = self.s2d
            if p.stride != b or p.pad_y or p.pad_x:
                raise ValueError(
                    "space_to_depth=%d needs stride=%d and pad=0" % (b, b))
            for dim, k in ((h, p.kernel_height), (w, p.kernel_width)):
                if -(-dim // b) - (-(-k // b)) + 1 != (dim - k) // b + 1:
                    raise ValueError(
                        "space_to_depth=%d incompatible with input %d / "
                        "kernel %d" % (b, dim, k))
        return [(n, p.num_channel, oh, ow)]

    def init_params(self, gen) -> Params:
        p = self.param
        g = p.num_group
        kshape = (g, p.num_channel // g,
                  p.num_input_channel // g * p.kernel_height
                  * p.kernel_width)
        out = {"wmat": p.rand_init_weight(gen, kshape, kshape[2],
                                          kshape[1])}
        if p.no_bias == 0:
            out["bias"] = torch.full((p.num_channel,), p.init_bias)
        return out

    def apply(self, params, inputs, ctx):
        p = self.param
        x = inputs[0].to(ctx.compute_dtype)
        g = p.num_group
        co_g = p.num_channel // g
        ci_g = p.num_input_channel // g
        # (g, co/g, ci/g*kh*kw) -> OIHW (co, ci/g, kh, kw)
        kernel = params["wmat"].reshape(
            g * co_g, ci_g, p.kernel_height, p.kernel_width)
        b = self.s2d
        if b and x.shape[1] == p.num_input_channel * b * b:
            # host-packed input: the equivalently packed kernel, stride 1
            khp = -(-p.kernel_height // b) * b
            kwp = -(-p.kernel_width // b) * b
            kernel = F.pad(kernel, (0, kwp - p.kernel_width,
                                    0, khp - p.kernel_height))
            kernel = kernel.reshape(g * co_g, ci_g, khp // b, b,
                                    kwp // b, b)
            kernel = kernel.permute(0, 1, 3, 5, 2, 4).reshape(
                g * co_g, ci_g * b * b, khp // b, kwp // b)
            stride, pad = 1, (0, 0)
        else:
            stride, pad = p.stride, (p.pad_y, p.pad_x)
        fn = conv_ops.conv_plain if ctx.plain else conv_ops.conv
        out = fn(x, kernel.to(ctx.compute_dtype), stride=stride, pad=pad,
                 groups=g).float()
        if p.no_bias == 0:
            out = out + params["bias"].reshape(1, -1, 1, 1)
        return [out]


@register("conv_pallas")
class ConvPallasLayer(ConvolutionLayer):
    """Convolution pinned to the kernel (the JAX package's forced-Pallas
    type; in the port every conv runs the kernel)."""

    def set_param(self, name, val):
        if name == "conv_impl":
            return  # pinned: this type exists to force one impl
        super().set_param(name, val)


def s2d_pack(data: np.ndarray, block: int) -> np.ndarray:
    """Space-to-depth pack a host batch (N,C,H,W) -> (N, C*b*b, H', W')
    with H' = ceil(H/b); channel order ((c*b + di)*b + dj) matches the
    kernel pack in ConvolutionLayer.apply (layers.py:1175)."""
    n, c, h, w = data.shape
    hp, wp = -(-h // block) * block, -(-w // block) * block
    if (hp, wp) != (h, w):
        data = np.pad(data, ((0, 0), (0, 0), (0, hp - h), (0, wp - w)))
    out = data.reshape(n, c, hp // block, block, wp // block, block)
    out = out.transpose(0, 1, 3, 5, 2, 4)
    return np.ascontiguousarray(
        out.reshape(n, c * block * block, hp // block, wp // block))


def s2d_unpack(data: np.ndarray, block: int,
               orig_hw: Tuple[int, int]) -> np.ndarray:
    """Inverse of :func:`s2d_pack`, cropping the zero pad."""
    n, cbb, hp, wp = data.shape
    c = cbb // (block * block)
    out = data.reshape(n, c, block, block, hp, wp)
    out = out.transpose(0, 1, 4, 2, 5, 3)
    out = out.reshape(n, c, hp * block, wp * block)
    return np.ascontiguousarray(out[:, :, :orig_hw[0], :orig_hw[1]])


class _PoolingLayer(Layer):
    """Spatial pooling with the reference's edge semantics
    (reference: src/layer/pooling_layer-inl.hpp:17-118).

    The output size min(h-k+s-1, h-1)//s + 1 permits partial windows at
    the bottom/right edge — not PyTorch's ``ceil_mode`` — so the input is
    padded explicitly with the reducer's identity (-inf for max, 0 for
    sums) before an unpadded window op. avg pooling divides by k*k
    regardless of clipping, like the reference."""
    reducer = "max"
    pre_relu = False

    def set_param(self, name, val):
        if name == "pool_impl":
            # the JAX package's choice of XLA lowering; both lowerings
            # reduce the same windows, which is all the port computes
            if val not in ("auto", "window", "slice"):
                raise ValueError("pool_impl must be auto|window|slice")
        else:
            super().set_param(name, val)

    def _infer(self, in_shapes):
        p = self.param
        n, c, h, w = in_shapes[0]
        if p.kernel_height <= 0 or p.kernel_width <= 0:
            raise ValueError("must set kernel_size correctly")
        h2, w2 = h + 2 * p.pad_y, w + 2 * p.pad_x
        if p.kernel_width > w2 or p.kernel_height > h2:
            raise ValueError("kernel size exceeds input")
        oh = min(h2 - p.kernel_height + p.stride - 1, h2 - 1) // p.stride + 1
        ow = min(w2 - p.kernel_width + p.stride - 1, w2 - 1) // p.stride + 1
        self._pad = ((oh - 1) * p.stride + p.kernel_height - h2,
                     (ow - 1) * p.stride + p.kernel_width - w2)
        return [(n, c, oh, ow)]

    def apply(self, params, inputs, ctx):
        p = self.param
        x = inputs[0]
        if self.pre_relu:
            x = torch.relu(x)
        pad_h, pad_w = self._pad
        padding = (p.pad_x, pad_w + p.pad_x, p.pad_y, pad_h + p.pad_y)
        window = (p.kernel_height, p.kernel_width)
        if self.reducer == "max":
            xp = F.pad(x, padding, value=-math.inf)
            return [F.max_pool2d(xp, window, p.stride)]
        xp = F.pad(x, padding, value=0.0)
        out = F.avg_pool2d(xp, window, p.stride, divisor_override=1)
        if self.reducer == "avg":
            out = out * (1.0 / (p.kernel_height * p.kernel_width))
        return [out]


@register("max_pooling")
class MaxPoolingLayer(_PoolingLayer):
    reducer = "max"


@register("sum_pooling")
class SumPoolingLayer(_PoolingLayer):
    reducer = "sum"


@register("avg_pooling")
class AvgPoolingLayer(_PoolingLayer):
    reducer = "avg"


@register("relu_max_pooling")
class ReluMaxPoolingLayer(_PoolingLayer):
    """Fused relu + max pooling (reference: src/layer/layer_impl-inl.hpp:55-56)."""
    reducer = "max"
    pre_relu = True


@register("lrn")
class LRNLayer(Layer):
    """AlexNet-style cross-channel local response normalization
    (reference: src/layer/lrn_layer-inl.hpp:12-93) through the fused
    kernel (ops/lrn.py): out = in * (knorm + alpha/n * chpool_sum(in^2,
    n))^-beta, float32 in and out.

    ``lrn_impl``: ``pallas`` (the JAX name) and ``auto`` select the
    kernel; the XLA formulations (``window``/``band``) have no counterpart
    in the port. ``lrn_dtype`` is accepted and, as in the JAX Pallas
    path, ignored: the kernel computes in float32."""

    def __init__(self):
        super().__init__()
        self.nsize = 3
        self.alpha = 0.0
        self.beta = 0.0
        self.knorm = 1.0

    def set_param(self, name, val):
        if name == "local_size":
            self.nsize = int(val)
        elif name == "alpha":
            self.alpha = float(val)
        elif name == "beta":
            self.beta = float(val)
        elif name == "knorm":
            self.knorm = float(val)
        elif name in ("lrn_impl", "use_pallas"):
            impl = ({-1: "auto", 0: "window", 1: "pallas"}.get(int(val))
                    if name == "use_pallas" else val)
            if impl not in ("auto", "window", "band", "pallas"):
                raise ValueError("lrn_impl must be auto|window|band|pallas")
            if impl not in ("auto", "pallas"):
                raise NotImplementedError(
                    "lrn_impl=%s: the port runs LRN through its fused "
                    "kernel (lrn_impl=pallas|auto)" % impl)
        elif name == "lrn_dtype":
            if val not in ("f32", "compute"):
                raise ValueError("lrn_dtype must be f32|compute")
        else:
            super().set_param(name, val)

    def apply(self, params, inputs, ctx):
        fn = lrn_ops.lrn_plain if ctx.plain else lrn_ops.lrn
        return [fn(inputs[0], self.nsize, self.alpha, self.beta,
                   self.knorm)]


@register("lrn_pallas")
class LRNPallasLayer(LRNLayer):
    """LRN pinned to the kernel (the JAX package's forced-Pallas type)."""

    def set_param(self, name, val):
        if name in ("use_pallas", "lrn_impl"):
            return
        super().set_param(name, val)


# ======================================================================
# loss layers (self-loop); inference transforms only
# ======================================================================
class _LossLayer(Layer):
    """Self-loop loss (reference: src/layer/loss/loss_layer_base-inl.hpp:11-133).
    At inference it only transforms its node (softmax probabilities);
    the loss terms come with the training slice."""
    is_loss = True

    def __init__(self):
        super().__init__()
        self.target = "label"
        self.grad_scale = 1.0

    def set_param(self, name, val):
        if name == "target":
            self.target = val
        elif name == "grad_scale":
            self.grad_scale = float(val)
        else:
            super().set_param(name, val)

    def _infer(self, in_shapes):
        if self.target not in self.label_name_map:
            raise ValueError("LossLayer: unknown target=%s" % self.target)
        self.target_index = self.label_name_map[self.target]
        return [in_shapes[0]]


def _stable_logits(logits: torch.Tensor) -> torch.Tensor:
    """Pre-subtract the row max before softmax (layers.py:2164)."""
    return logits - logits.amax(dim=-1, keepdim=True)


@register("softmax")
class SoftmaxLayer(_LossLayer):
    """Softmax (reference: src/layer/loss/softmax_layer-inl.hpp:12-36): the
    node becomes per-instance probabilities, or per-position ones on a
    (b, 1, s, V) sequence node."""

    def apply(self, params, inputs, ctx):
        n, c, s, v = inputs[0].shape
        if c == 1 and s > 1:
            logits = inputs[0].reshape(n, s, v)
        else:
            logits = _mat(inputs[0])
        probs = torch.softmax(_stable_logits(logits), dim=-1)
        return [probs.reshape(inputs[0].shape)]


# ----------------------------------------------------------------------
# layer types of later slices: registered so netconfigs parse, raising
# when a net is built with them
_LATER = {
    "training slice": (
        "bias", "split", "elewise_add", "concat", "ch_concat", "xelu",
        "insanity", "prelu", "insanity_max_pooling", "lrn_band",
        "batch_norm", "fixconn", "l2_loss", "multi_logistic"),
    "transformer slice": (
        "embed", "im2seq", "seq_pool", "moe_fullc", "attention",
        "transformer_stack", "lm_head"),
}


def _not_ported(name: str, where: str):
    def make():
        raise NotImplementedError(
            'layer type "%s" is not ported yet: it comes with the %s '
            "(ROADMAP.md)" % (name, where))
    return make


for _where, _names in _LATER.items():
    for _name in _names:
        _REGISTRY[_name] = _not_ported(_name, _where)
