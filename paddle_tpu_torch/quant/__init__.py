"""paddle_tpu_torch.quant — int8 quantization: PTQ and QAT (the port's
counterpart of ``paddle_tpu/quant/__init__.py``).

Reference being replaced: the slim quantization stack —
``QuantizationTransformPass`` inserting fake_quantize/dequantize ops
(fluid/contrib/slim/quantization/quantization_pass.py),
``ImperativeQuantAware`` wrapping dygraph layers for QAT
(slim/quantization/imperative/qat.py), and post-training calibration
(slim/quantization/post_training_quantization.py) with absmax /
moving-average-absmax observers.

As in the JAX package, quantization is a LAYER SWAP plus a
straight-through-estimator primitive:

- :func:`fake_quant` — quantize→dequantize whose backward passes
  gradients straight through inside the clip range (an
  ``autograd.Function`` where the JAX package has a ``custom_vjp``);
- :class:`QuantizedLinear` / :class:`QuantizedConv2D` — weights stored
  int8 with per-output-channel absmax scales; weight-only layers
  dequantize in the forward, so ``jit.save`` artifacts carry int8
  params (4x smaller). With a calibrated activation scale the forward
  quantizes its input and sums int8 x int8 products into an EXACT int32
  accumulator, as the JAX package's ``preferred_element_type=int32``
  does: cuBLAS has no int32-output matmul and float32 is exact only to
  2^24 (a 3x3 conv over 512 channels sums 4608 products of up to
  127^2), so the products are summed in float64 — exact for any sum
  below 2^53 — and converted to int32;
- :func:`quantize_post_training`, :func:`prepare_qat` /
  :func:`convert` — PTQ and QAT as model transforms.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.xla_math import div as _div
from ..nn import functional as F
from ..nn.layer import Layer


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def absmax_scale(w, axis=None, bits: int = 8):
    """Symmetric absmax scale: ref fake_quantize_abs_max semantics."""
    qmax = float(2 ** (bits - 1) - 1)
    w = torch.as_tensor(w)
    if axis is None:
        amax = w.abs().amax()
    else:
        amax = w.abs().amax(dim=axis, keepdim=True)
    return _div(torch.clamp(amax, min=1e-8), qmax)


def quantize_weight(w, axis=None, bits: int = 8):
    """→ (int8 values, f32 scale); symmetric, optionally per-channel
    (axis = dims REDUCED for the scale, e.g. 0 for [in, out] weights →
    one scale per output channel, the reference's channel_wise_abs_max)."""
    w = torch.as_tensor(w).detach()
    scale = absmax_scale(w, axis=axis, bits=bits)
    qmax = 2 ** (bits - 1) - 1
    q = torch.clamp(torch.round(w / scale), -qmax - 1, qmax).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_weight(q, scale, dtype=torch.float32):
    return q.to(dtype) * scale.to(dtype)


class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bits):
        qmax = 2 ** (bits - 1) - 1
        ctx.save_for_backward(x.abs() <= (qmax + 0.5) * scale)
        q = torch.clamp(torch.round(x / scale), -qmax, qmax)
        return q * scale

    @staticmethod
    def backward(ctx, g):
        inside, = ctx.saved_tensors
        # straight-through inside the representable range, zero outside
        return torch.where(inside, g, torch.zeros_like(g)), None, None


def fake_quant(x, scale, bits: int = 8):
    """quantize→dequantize with a straight-through estimator. Clips
    symmetrically to [-qmax, qmax] like the reference's
    fake_quantize_abs_max, so the backward pass-through mask and the
    forward saturation boundary agree. No gradient reaches ``scale``."""
    scale = torch.as_tensor(scale, dtype=x.dtype, device=x.device)
    return _FakeQuant.apply(x, scale.detach(), bits)


def _quantize_act(x, act_scale, bits):
    qmax = 2 ** (bits - 1) - 1
    return torch.clamp(torch.round(x / act_scale), -qmax, qmax) \
        .to(torch.int8)


def _int8_matmul_i32(qx, qw):
    """Exact int32 ``qx @ qw`` of int8 operands (float64 sums: exact up
    to 2^53, far above int8 products' reach)."""
    return (qx.double() @ qw.double()).to(torch.int32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

class QuantizedLinear(Layer):
    """Weight-only (optionally activation) int8 linear.

    Weights live as an int8 buffer + per-output-channel f32 scales; the
    dequant happens inside the forward, so ``jit.save`` artifacts carry
    int8 params (4x smaller)."""

    def __init__(self, in_features: int, out_features: int, bits: int = 8):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.bits = bits
        self.register_buffer("qweight",
                             torch.zeros((in_features, out_features),
                                         dtype=torch.int8))
        self.register_buffer("wscale",
                             torch.ones((1, out_features)))
        self.register_buffer("bias", None)
        self.register_buffer("act_scale", None)  # set by calibration

    @classmethod
    def from_linear(cls, lin, bits: int = 8,
                    act_scale=None) -> "QuantizedLinear":
        qlin = cls(lin.in_features, lin.out_features, bits=bits)
        dev = lin.weight.device
        q, s = quantize_weight(lin.weight, axis=0, bits=bits)
        qlin.qweight = q
        qlin.wscale = s
        qlin.bias = None if lin.bias is None else lin.bias.detach().clone()
        if act_scale is not None:
            qlin.act_scale = torch.as_tensor(act_scale, dtype=torch.float32,
                                             device=dev)
        return qlin

    def forward(self, x):
        if self.act_scale is not None:
            # full int8 path: quantize activations with the calibrated
            # scale (symmetric, matching fake_quant's training-time
            # clip); int8 x int8 summed exactly into int32
            acc = _int8_matmul_i32(
                _quantize_act(x, self.act_scale, self.bits), self.qweight)
            y = acc.to(torch.float32) * self.act_scale * self.wscale
        else:
            w = dequantize_weight(self.qweight, self.wscale, x.dtype)
            y = x @ w
        if self.bias is not None:
            y = y + self.bias
        return y


class QATLinear(Layer):
    """Training-time fake-quant linear (ref: ImperativeQuantAware
    wrapping Linear with fake_quant on weight + input)."""

    def __init__(self, lin, bits: int = 8, quant_act: bool = True,
                 ema: float = 0.95):
        super().__init__()
        self.inner = lin
        self.bits = bits
        self.quant_act = quant_act
        self.ema = ema
        self.register_buffer("act_absmax",
                             torch.zeros((), device=lin.weight.device),
                             persistent=True)

    def forward(self, x):
        w = self.inner.weight
        wq = fake_quant(w, absmax_scale(w.detach(), axis=0,
                                        bits=self.bits), self.bits)
        if self.quant_act:
            amax = x.detach().abs().amax()
            if self.training:
                # moving-average absmax observer — training only, like
                # the reference's moving_average_abs_max_scale op in
                # is_test=False (eval must not pollute the range)
                cur = torch.where(self.act_absmax > 0,
                                  self.ema * self.act_absmax +
                                  (1 - self.ema) * amax, amax)
                self.act_absmax = cur
            else:
                # never-calibrated eval: fall back to the batch's own
                # range without recording it
                cur = torch.where(self.act_absmax > 0, self.act_absmax,
                                  amax)
            qmax = float(2 ** (self.bits - 1) - 1)
            x = fake_quant(x, _div(torch.clamp(cur, min=1e-8), qmax),
                           self.bits)
        return F.linear(x, wq, self.inner.bias)


class QuantizedConv2D(Layer):
    """Int8 conv (ref: the mkldnn int8 conv path,
    fluid/inference/api/mkldnn_quantizer.cc + TRT int8).

    Weights stored int8 OIHW with per-OUT-channel absmax scales
    [O,1,1,1]; with a calibrated ``act_scale`` the forward quantizes
    activations and runs an int8 x int8 conv summed exactly into int32,
    then rescales; without one it is weight-only."""

    def __init__(self, conv, bits: int = 8, act_scale=None):
        super().__init__()
        self.bits = bits
        self.stride = conv.stride
        self.padding = conv.padding
        self.dilation = conv.dilation
        self.groups = conv.groups
        self.data_format = conv.data_format
        q, s = quantize_weight(conv.weight, axis=(1, 2, 3), bits=bits)
        self.register_buffer("qweight", q)
        self.register_buffer("wscale", s)          # [O, 1, 1, 1]
        self.register_buffer("bias", None if conv.bias is None
                             else conv.bias.detach().clone())
        self.register_buffer(
            "act_scale",
            None if act_scale is None
            else torch.as_tensor(act_scale, dtype=torch.float32,
                                 device=conv.weight.device))

    def _out_scale(self, ndim_out: int):
        # [O,1,1,1] -> broadcast over NCHW/NHWC output layout
        s = self.wscale.reshape(-1)
        if self.data_format == "NHWC":
            return s
        return s.reshape((1, -1) + (1,) * (ndim_out - 2))

    def forward(self, x):
        if self.act_scale is not None:
            qx = _quantize_act(x, self.act_scale, self.bits)
            acc = F.conv_nd(qx, self.qweight, None, self.stride,
                            self.padding, self.dilation, self.groups,
                            self.data_format,
                            preferred_element_type=torch.int32)
            y = acc.to(torch.float32) * self.act_scale * \
                self._out_scale(acc.dim())
        else:
            w = dequantize_weight(self.qweight, self.wscale, x.dtype)
            y = F.conv_nd(x, w, None, self.stride, self.padding,
                          self.dilation, self.groups, self.data_format)
        if self.bias is not None:
            bias = self.bias if self.data_format == "NHWC" else \
                self.bias.reshape((1, -1) + (1,) * (y.dim() - 2))
            y = y + bias
        return y


def fold_conv_bn(net: Layer, example_inputs) -> int:
    """Fold inference-mode BatchNorm into the preceding conv (ref: the
    quant passes' conv-bn fuse, slim/quantization/quantization_pass.py
    _fuse_conv_bn). Pairing is discovered by running one eager forward —
    a BN whose input IS a conv's output object (nothing in between)
    folds — so any container structure works, and conv→relu→bn or
    shared convs are left alone. Returns #pairs folded.

    ASSUMPTION (the standard conv-bn idiom): a folded conv's output is
    consumed ONLY by its BN.

    Math: y = gamma*(conv(x)+b-mean)/sqrt(var+eps)+beta collapses to
    conv'(x)+b' with W' = W*s_o, b' = (b-mean)*s + beta,
    s = gamma/sqrt(var+eps) per out-channel. BNs are replaced by
    identity layers in place."""
    from ..nn.layer import Parameter
    from ..nn.layers.conv import Conv2D
    from ..nn.layers.norm import _BatchNormBase

    pairs = []
    # keep the output OBJECT alive alongside the owner: a bare id()
    # key could be reused by a later allocation after the conv output
    # is freed, falsely pairing a BN across an intervening op
    out_owner: Dict[int, tuple] = {}
    hooks = []
    fires: Dict[int, int] = {}

    def conv_post(layer, args, out):
        fires[id(layer)] = fires.get(id(layer), 0) + 1
        out_owner[id(out)] = (layer, out)

    def bn_pre(layer, args):
        ent = out_owner.get(id(args[0]))
        if ent is not None and ent[1] is args[0]:
            pairs.append((ent[0], layer))

    for sub in net.modules():
        if isinstance(sub, Conv2D):
            hooks.append(sub.register_forward_post_hook(conv_post))
        elif isinstance(sub, _BatchNormBase):
            hooks.append(sub.register_forward_pre_hook(bn_pre))
    was_training = net.training
    net.eval()
    try:
        ex = example_inputs if isinstance(example_inputs, (tuple, list)) \
            else (example_inputs,)
        with torch.no_grad():
            net(*ex)
    finally:
        for h in hooks:
            h.remove()
        if was_training:
            net.train()

    # one-to-one only: a conv feeding two BNs or a BN fed by two convs
    # cannot fold into a single weight rewrite; a conv INVOKED more than
    # once (weight tying) is also out
    from collections import Counter
    conv_uses = Counter(id(c) for c, _ in pairs)
    bn_uses = Counter(id(b) for _, b in pairs)
    folded_bns = {}
    with torch.no_grad():
        for conv, bn in pairs:
            if conv_uses[id(conv)] != 1 or bn_uses[id(bn)] != 1 or \
                    fires.get(id(conv), 0) != 1:
                continue
            s = (bn.weight if bn.weight is not None else 1.0) / \
                torch.sqrt(bn._variance + bn.epsilon)
            conv.weight.copy_(conv.weight * s.reshape(-1, 1, 1, 1))
            b0 = conv.bias if conv.bias is not None else 0.0
            beta = bn.bias if bn.bias is not None else 0.0
            new_bias = (b0 - bn._mean) * s + beta
            if conv.bias is not None:
                conv.bias.copy_(new_bias)
            else:
                conv.bias = Parameter(new_bias)
            folded_bns[id(bn)] = True

    from ..nn.layers.common import Identity
    return _swap_layers(net, lambda l: id(l) in folded_bns,
                        lambda l: Identity())


# ---------------------------------------------------------------------------
# model transforms
# ---------------------------------------------------------------------------

def _swap_layers(root: Layer, predicate, build) -> int:
    n = 0
    for parent in list(root.modules()):
        for name, child in list(parent._modules.items()):
            if child is not None and predicate(child):
                parent._modules[name] = build(child)
                n += 1
    return n


def quantize_post_training(net: Layer, calibration_batches=None,
                           bits: int = 8,
                           quant_act: Optional[bool] = None,
                           skip=lambda layer: False) -> int:
    """PTQ in place: swap every nn.Linear for QuantizedLinear and
    every nn.Conv2D for QuantizedConv2D (ref:
    PostTrainingQuantization.quantize). Passing ``calibration_batches``
    runs them through the net first, observing per-layer input absmax
    to set activation scales — int8 activations. Without batches the
    result is weight-only int8. Run :func:`fold_conv_bn` FIRST for conv
    nets. Returns #layers swapped."""
    from ..nn.layers.common import Linear
    from ..nn.layers.conv import Conv2D

    if quant_act is None:
        quant_act = calibration_batches is not None
    if quant_act and calibration_batches is None:
        raise ValueError(
            "quant_act=True needs calibration_batches to derive "
            "activation scales")

    act_scales: Dict[int, float] = {}
    if quant_act:
        qmax = float(2 ** (bits - 1) - 1)
        observed: Dict[int, float] = {}
        hooks = []
        for layer in net.modules():
            if isinstance(layer, (Linear, Conv2D)):
                def hook(l, args, _observed=observed):
                    m = float(args[0].detach().abs().amax())
                    key = id(l)
                    _observed[key] = max(_observed.get(key, 0.0), m)
                hooks.append(layer.register_forward_pre_hook(hook))
        net.eval()
        with torch.no_grad():
            for batch in calibration_batches:
                net(*batch) if isinstance(batch, (tuple, list)) \
                    else net(batch)
        for h in hooks:
            h.remove()
        act_scales = {k: max(v, 1e-8) / qmax for k, v in observed.items()}

    def build(layer):
        if isinstance(layer, Conv2D):
            return QuantizedConv2D(layer, bits=bits,
                                   act_scale=act_scales.get(id(layer)))
        return QuantizedLinear.from_linear(
            layer, bits=bits, act_scale=act_scales.get(id(layer)))

    return _swap_layers(
        net,
        lambda l: isinstance(l, (Linear, Conv2D)) and not skip(l),
        build)


def prepare_qat(net: Layer, bits: int = 8, quant_act: bool = True) -> int:
    """Swap Linears for fake-quant QAT wrappers (ref:
    ImperativeQuantAware.quantize). Returns #layers wrapped."""
    from ..nn.layers.common import Linear
    return _swap_layers(
        net, lambda l: isinstance(l, Linear),
        lambda l: QATLinear(l, bits=bits, quant_act=quant_act))


def convert(net: Layer, bits: Optional[int] = None) -> int:
    """QAT → deploy: replace QATLinear wrappers with real int8 layers
    using the observed activation scales (ref:
    ImperativeQuantAware.save_quantized_model)."""
    def build(qat: QATLinear):
        b = bits or qat.bits
        qmax = float(2 ** (b - 1) - 1)
        act_scale = None
        if qat.quant_act and float(qat.act_absmax) > 0:
            act_scale = max(float(qat.act_absmax), 1e-8) / qmax
        return QuantizedLinear.from_linear(qat.inner, bits=b,
                                           act_scale=act_scale)

    return _swap_layers(net, lambda l: isinstance(l, QATLinear), build)
