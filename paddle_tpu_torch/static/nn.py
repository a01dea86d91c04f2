"""``paddle.static.nn`` — static-graph layer functions + the public
control-flow and sequence-op surface (the port's counterpart of
``paddle_tpu/static/nn.py``).

Reference being replaced: python/paddle/static/nn/__init__.py (fc,
conv2d, batch_norm, ... — LayerHelper programs appending OpDescs),
paddle/fluid/operators/controlflow/ (cond/while/case/switch_case), and
paddle/fluid/operators/sequence_ops/ (the LoD sequence family).

The JAX package's decisions, kept:

- **Dual mode**: every function works EAGERLY on tensors and
  SYMBOLICALLY on ``static.Variable``s (building the closure DAG
  Executor.run evaluates).
- **Control flow** runs eagerly on a host predicate (a Python value or
  a concrete tensor read on the host). While ``torch.export`` traces
  (``jit.save``), a tensor predicate becomes ``torch.cond`` /
  ``while_loop``, so the exported program keeps the branch.
- **Sequence ops and LoD**: there is no LoDTensor. The carrier for
  ragged data is (padded [B, T, ...], lengths [B]); each sequence op
  takes an optional ``length=None`` argument where the reference read
  LoD (None = all rows full length).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .program import Variable, _device, _op, _tensor, create_parameter

__all__ = [
    "fc", "conv2d", "conv2d_transpose", "conv3d", "conv3d_transpose",
    "batch_norm", "layer_norm", "instance_norm", "group_norm",
    "data_norm", "embedding", "sparse_embedding", "prelu",
    "spectral_norm", "bilinear_tensor_product", "deform_conv2d", "nce",
    "multi_box_head", "crf_decoding", "row_conv", "py_func", "case",
    "cond", "switch_case", "while_loop", "StaticRNN",
    "sequence_concat", "sequence_conv", "sequence_enumerate",
    "sequence_expand", "sequence_expand_as", "sequence_first_step",
    "sequence_last_step", "sequence_pad", "sequence_pool",
    "sequence_reshape", "sequence_reverse", "sequence_scatter",
    "sequence_slice", "sequence_softmax", "sequence_unpad",
]


def _is_sym(*args) -> bool:
    return any(isinstance(a, Variable) for a in args)


def _lift(fn: Callable, *args, shape=None, dtype="float32"):
    """Apply eagerly, or emit a DAG node if any arg is symbolic."""
    if _is_sym(*args):
        return _op(fn, *args, shape=shape, dtype=dtype)
    return fn(*[_tensor(a) if not isinstance(a, (int, float, tuple,
                                                 list, type(None)))
                else a for a in args])


def _var(x, unbiased=False, dims=None, keepdim=True):
    return x.var(dim=dims, unbiased=unbiased, keepdim=keepdim)


# ---------------------------------------------------------------------------
# layer functions (ref: python/paddle/static/nn/common.py)
# ---------------------------------------------------------------------------

def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
       activation=None, name=None):
    """ref: static/nn/common.py fc."""
    in_dim = int(np.prod(x.shape[num_flatten_dims:]))
    w = create_parameter([in_dim, size], name=name and name + ".w_0")
    b = None if bias_attr is False else create_parameter(
        [size], name=name and name + ".b_0")
    act = {"relu": torch.relu, "tanh": torch.tanh,
           "sigmoid": torch.sigmoid, None: lambda v: v}[activation]

    def fn(xv, wv, *bv):
        flat = xv.reshape(tuple(xv.shape[:num_flatten_dims]) + (-1,))
        out = flat @ wv
        if bv:
            out = out + bv[0]
        return act(out)

    deps = (x, w) + (() if b is None else (b,))
    return _op(fn, *deps, shape=tuple(x.shape[:num_flatten_dims]) + (size,))


def _conv_nd(x, num_filters, filter_size, stride, padding, dilation,
             groups, nd, transposed=False, output_padding=0):
    from ..nn import functional as F
    k = (filter_size,) * nd if isinstance(filter_size, int) \
        else tuple(filter_size)
    cin = int(x.shape[1])
    if transposed:
        wshape = [cin, num_filters // (groups or 1)] + list(k)
    else:
        wshape = [num_filters, cin // (groups or 1)] + list(k)
    w = create_parameter(wshape)
    b = create_parameter([num_filters])
    fns = {(2, False): F.conv2d, (3, False): F.conv3d,
           (2, True): F.conv2d_transpose, (3, True): F.conv3d_transpose}
    conv = fns[(nd, transposed)]

    def fn(xv, wv, bv):
        kw = dict(stride=stride, padding=padding, dilation=dilation,
                  groups=groups or 1)
        if transposed:
            kw["output_padding"] = output_padding
        return conv(xv, wv, bv, **kw)

    return _op(fn, x, w, b)


def conv2d(input, num_filters, filter_size, stride=1, padding=0,
           dilation=1, groups=None, param_attr=None, bias_attr=None,
           act=None, name=None, data_format="NCHW"):
    return _conv_nd(input, num_filters, filter_size, stride, padding,
                    dilation, groups, 2)


def conv3d(input, num_filters, filter_size, stride=1, padding=0,
           dilation=1, groups=None, param_attr=None, bias_attr=None,
           act=None, name=None, data_format="NCDHW"):
    return _conv_nd(input, num_filters, filter_size, stride, padding,
                    dilation, groups, 3)


def conv2d_transpose(input, num_filters, output_size=None,
                     filter_size=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, act=None,
                     name=None, data_format="NCHW"):
    return _conv_nd(input, num_filters, filter_size, stride, padding,
                    dilation, groups, 2, True, output_padding)


def conv3d_transpose(input, num_filters, output_size=None,
                     filter_size=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, act=None,
                     name=None, data_format="NCDHW"):
    return _conv_nd(input, num_filters, filter_size, stride, padding,
                    dilation, groups, 3, True, output_padding)


def _norm_params(c):
    from .program import default_main_program
    g = create_parameter([c], default_initializer=None)
    prog = default_main_program()
    prog.state[g.name] = torch.ones((c,), device=_device())
    b = create_parameter([c])
    prog.state[b.name] = torch.zeros((c,), device=_device())
    return g, b


def batch_norm(input, act=None, is_test=False, momentum=0.9,
               epsilon=1e-5, param_attr=None, bias_attr=None,
               data_layout="NCHW", name=None, **_kw):
    """Batch statistics per step (ref: static/nn/common.py batch_norm;
    running-average serving stats belong to nn.BatchNorm layers)."""
    c = int(input.shape[1])
    g, b = _norm_params(c)

    def fn(xv, gv, bv):
        axes = (0,) + tuple(range(2, xv.dim()))
        mean = xv.mean(axes, keepdim=True)
        var = _var(xv, dims=axes)
        shape = (1, c) + (1,) * (xv.dim() - 2)
        out = (xv - mean) / torch.sqrt(var + epsilon)
        return out * gv.reshape(shape) + bv.reshape(shape)

    return _op(fn, input, g, b, shape=input.shape)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    d = int(np.prod(input.shape[begin_norm_axis:]))
    g, b = _norm_params(d)

    def fn(xv, gv, bv):
        shape = xv.shape
        flat = xv.reshape(tuple(shape[:begin_norm_axis]) + (-1,))
        mean = flat.mean(-1, keepdim=True)
        var = _var(flat, dims=-1)
        out = (flat - mean) / torch.sqrt(var + epsilon)
        return (out * gv + bv).reshape(shape)

    return _op(fn, input, g, b, shape=input.shape)


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None,
                  name=None):
    from ..nn import functional as F
    c = int(input.shape[1])
    g, b = _norm_params(c)
    return _op(lambda xv, gv, bv: F.instance_norm(xv, gv, bv, epsilon),
               input, g, b, shape=input.shape)


def group_norm(input, groups, epsilon=1e-5, param_attr=None,
               bias_attr=None, act=None, data_layout="NCHW", name=None):
    from ..nn import functional as F
    c = int(input.shape[1])
    g, b = _norm_params(c)
    return _op(lambda xv, gv, bv: F.group_norm(xv, groups, gv, bv,
                                               epsilon),
               input, g, b, shape=input.shape)


def data_norm(input, act=None, epsilon=1e-5, param_attr=None,
              data_layout="NCHW", in_place=False, name=None,
              moving_mean_name=None, moving_variance_name=None,
              do_model_average_for_mean_and_var=True, slot_dim=-1,
              sync_stats=False, summary_decay_rate=0.9999999,
              enable_scale_and_shift=False):
    """ref: static/nn/common.py data_norm (CTR normalization by
    accumulated batch summaries). As in the JAX package: normalize by
    the batch's own statistics (no cross-step mutable op state)."""
    def fn(xv):
        mean = xv.mean(0, keepdim=True)
        var = _var(xv, dims=0)
        return (xv - mean) / torch.sqrt(var + epsilon)

    return _op(fn, input, shape=input.shape)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    w = create_parameter(list(size), dtype=dtype)

    def fn(ids, wv):
        out = wv[ids.long()]
        if padding_idx is not None:
            pad = padding_idx if padding_idx >= 0 else size[0] + padding_idx
            out = out * (ids != pad)[..., None].to(out.dtype)
        return out

    return _op(fn, input, w,
               shape=tuple(input.shape or ()) + (size[1],))


def sparse_embedding(input, size, padding_idx=None, is_test=False,
                     entry=None, table_class="MemorySparseTable",
                     param_attr=None, dtype="float32", slot=None):
    """ref: contrib sparse_embedding (PS path). Tables beyond device
    memory go through nn.HostOffloadedEmbedding / ShardedHostEmbedding;
    the static-graph surface keeps a dense parameter."""
    return embedding(input, size, padding_idx=padding_idx, dtype=dtype)


def prelu(x, mode="all", param_attr=None, data_format="NCHW",
          name=None):
    n = {"all": 1, "channel": int(x.shape[1]),
         "element": int(np.prod(x.shape[1:]))}[mode]
    a = create_parameter([n])
    from .program import default_main_program
    default_main_program().state[a.name] = torch.full(
        (n,), 0.25, device=_device())

    def fn(xv, av):
        if mode == "channel":
            av = av.reshape((1, -1) + (1,) * (xv.dim() - 2))
        elif mode == "element":
            av = av.reshape((1,) + tuple(xv.shape[1:]))
        return torch.where(xv >= 0, xv, av * xv)

    return _op(fn, x, a, shape=x.shape)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    from ..nn.layers.fill_r4 import SpectralNorm
    sn = SpectralNorm([int(s) for s in weight.shape], dim=dim,
                      power_iters=power_iters, eps=eps).to(_device())
    return _lift(lambda w: sn(w), weight, shape=weight.shape)


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    dx, dy = int(x.shape[-1]), int(y.shape[-1])
    w = create_parameter([size, dx, dy])
    b = create_parameter([size])

    def fn(xv, yv, wv, bv):
        return torch.einsum("bi,oij,bj->bo", xv, wv, yv) + bv

    return _op(fn, x, y, w, b, shape=(x.shape[0], size))


def deform_conv2d(x, offset, mask, num_filters, filter_size, stride=1,
                  padding=0, dilation=1, groups=1, deformable_groups=1,
                  im2col_step=1, param_attr=None, bias_attr=None,
                  name=None):
    from ..vision.ops import deform_conv2d as _dc
    k = (filter_size,) * 2 if isinstance(filter_size, int) \
        else tuple(filter_size)
    w = create_parameter([num_filters, int(x.shape[1]) // groups, *k])
    b = create_parameter([num_filters])
    return _op(lambda xv, ov, mv, wv, bv: _dc(
        xv, ov, wv, bv, stride=stride, padding=padding,
        dilation=dilation, deformable_groups=deformable_groups,
        groups=groups, mask=mv), x, offset, mask, w, b)


def nce(input, label, num_total_classes, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples=None,
        name=None, sampler="uniform", custom_dist=None, seed=0,
        is_sparse=False):
    """Noise-contrastive estimation loss (ref: operators/nce_op.cc):
    logistic discrimination of the true class against k uniform noise
    samples, drawn from the global key stream as the JAX package does."""
    import torch.nn.functional as TF
    d = int(input.shape[-1])
    k = num_neg_samples or 5
    w = create_parameter([num_total_classes, d])
    b = create_parameter([num_total_classes])

    def fn(xv, yv, wv, bv):
        from ..core import rng as _rng
        from ..core import threefry
        y = yv.reshape(-1).long()
        pos_logit = (xv * wv[y]).sum(-1) + bv[y]
        neg = threefry.randint(_rng.next_key(), (xv.shape[0], k), 0,
                               num_total_classes,
                               device=xv.device).long()
        neg_logit = torch.einsum("bd,bkd->bk", xv, wv[neg]) + bv[neg]
        loss = -TF.logsigmoid(pos_logit) - TF.logsigmoid(-neg_logit).sum(-1)
        return loss.reshape(-1, 1)

    return _op(fn, input, label, w, b, shape=(input.shape[0], 1))


def _prior_boxes(feat_hw, image_size, min_size, max_size,
                 aspect_ratios, flip, clip, offset=0.5):
    """Prior-box generation (ref: operators/detection/prior_box_op.cc):
    per cell, one min-size square, one sqrt(min*max) square, and one
    box per aspect ratio (plus flipped)."""
    fh, fw = feat_hw
    ars = [1.0]
    for a in aspect_ratios:
        if a != 1.0:
            ars.append(a)
            if flip:
                ars.append(1.0 / a)
    whs = [(min_size * math.sqrt(a), min_size / math.sqrt(a))
           for a in ars]
    if max_size:
        s = math.sqrt(min_size * max_size)
        whs.insert(1, (s, s))
    sy, sx = image_size / fh, image_size / fw
    cy = (np.arange(fh) + offset) * sy
    cx = (np.arange(fw) + offset) * sx
    cyx = np.stack(np.meshgrid(cy, cx, indexing="ij"), -1)  # [H, W, 2]
    boxes = []
    for w, h in whs:
        b = np.concatenate([
            (cyx[..., 1] - w / 2)[..., None],
            (cyx[..., 0] - h / 2)[..., None],
            (cyx[..., 1] + w / 2)[..., None],
            (cyx[..., 0] + h / 2)[..., None]], -1) / image_size
        boxes.append(b)
    out = np.stack(boxes, 2).reshape(-1, 4).astype(np.float32)
    if clip:
        out = np.clip(out, 0.0, 1.0)
    return out


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, offset=0.5, flip=True,
                   clip=False, **_kw):
    """SSD prior-box head (ref: static/nn multi_box_head /
    operators/detection/prior_box_op): per-feature-map conv heads for
    loc/conf + generated prior boxes + variances."""
    locs, confs, boxes = [], [], []
    n_in = len(inputs)
    if min_sizes is None:
        # the reference's ratio interpolation
        min_sizes, max_sizes = [], []
        step = int(math.floor((max_ratio - min_ratio)
                              / max(n_in - 2, 1)))
        for r in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(base_size * r / 100.0)
            max_sizes.append(base_size * (r + step) / 100.0)
        min_sizes = [base_size * 0.1] + min_sizes[:n_in - 1]
        max_sizes = [base_size * 0.2] + max_sizes[:n_in - 1]
    for i, feat in enumerate(inputs):
        ar = list(aspect_ratios[i])
        extra = len([a for a in ar if a != 1.0]) * (2 if flip else 1)
        n_priors = 1 + (1 if max_sizes else 0) + extra
        locs.append(conv2d(feat, n_priors * 4, 3, padding=1))
        confs.append(conv2d(feat, n_priors * num_classes, 3, padding=1))
        boxes.append(_prior_boxes(
            tuple(int(s) for s in feat.shape[2:]), base_size,
            min_sizes[i], max_sizes[i] if max_sizes else None,
            ar, flip, clip, offset))
    all_boxes = _tensor(np.concatenate(boxes))
    variances = torch.tensor([0.1, 0.1, 0.2, 0.2],
                             device=all_boxes.device).tile(
        (all_boxes.shape[0], 1))
    return locs, confs, all_boxes, variances


def crf_decoding(input, param_attr=None, label=None, length=None):
    """Viterbi decode over CRF transitions (ref:
    operators/crf_decoding_op; the modern path is
    paddle.text.ViterbiDecoder)."""
    from ..text import viterbi_decode
    n = int(input.shape[-1])
    trans = create_parameter([n + 2, n])

    def fn(xv, tv):
        # reference layout: row 0 start, row 1 stop, rows 2.. transitions
        scores, path = viterbi_decode(
            xv[None] if xv.dim() == 2 else xv,
            tv[2:], include_bos_eos_tag=False,
            lengths=length)
        return path[0] if xv.dim() == 2 else path

    return _op(fn, input, trans)


def row_conv(input, future_context_size, param_attr=None, act=None):
    """Lookahead row convolution (ref: operators/row_conv_op — the
    DeepSpeech2 streaming op): y[t] = sum_{i<=k} w[i] * x[t+i]."""
    import torch.nn.functional as TF
    d = int(input.shape[-1])
    k = future_context_size + 1
    w = create_parameter([k, d])

    def fn(xv, wv):
        t_ax = xv.dim() - 2
        t = xv.shape[t_ax]
        # pad the time axis (second to last) at its end by k - 1
        xp = TF.pad(xv, (0, 0, 0, k - 1))
        out = sum(xp.narrow(t_ax, i, t) * wv[i] for i in range(k))
        return out

    return _op(fn, input, w, shape=input.shape)


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    from .program import py_func as _pf
    return _pf(func, x, out, backward_func, skip_vars_in_backward_input)


# ---------------------------------------------------------------------------
# public control flow (ref: operators/controlflow/; fluid/layers/
# control_flow.py cond/while_loop/case/switch_case)
# ---------------------------------------------------------------------------

def _tracing() -> bool:
    return torch.compiler.is_exporting() or torch.compiler.is_compiling()


def _pred(p):
    return torch.as_tensor(p).reshape(()).to(torch.bool)


def _cond(p, true_fn, false_fn):
    if _tracing() and isinstance(p, torch.Tensor):
        return torch.cond(_pred(p), lambda: true_fn(), lambda: false_fn(),
                          ())
    return true_fn() if bool(_pred(p)) else false_fn()


def cond(pred, true_fn=None, false_fn=None, name=None):
    """The reference's signature (zero-arg branches); see the module
    docstring for when it is ``torch.cond``."""
    if _is_sym(pred):
        return _op(lambda p: _cond(p, true_fn, false_fn), pred)
    return _cond(pred, true_fn, false_fn)


def while_loop(cond_fn, body, loop_vars, is_test=False, name=None):
    """The reference's list-of-loop-vars calling convention (cond/body
    take and return the var list); ``torch``'s ``while_loop`` while a
    program is exported."""
    vars_t = tuple(loop_vars)
    if _tracing():
        from torch._higher_order_ops.while_loop import while_loop as _wl
        return list(_wl(lambda *vs: _pred(cond_fn(*vs)),
                        lambda *vs: tuple(body(*vs)), vars_t))
    while bool(_pred(cond_fn(*vars_t))):
        vars_t = tuple(body(*vars_t))
    return list(vars_t)


def case(pred_fn_pairs, default=None, name=None):
    """First-true-wins chained cond (ref: control_flow.py case)."""
    def build(i):
        if i >= len(pred_fn_pairs):
            if default is None:
                raise ValueError("case: no predicate matched and no "
                                 "default branch")
            return default()
        pred, fn = pred_fn_pairs[i]
        return _cond(pred, fn, lambda: build(i + 1))

    return build(0)


def switch_case(branch_index, branch_fns, default=None, name=None):
    """Switch over an integer selector (ref: control_flow.py
    switch_case; branch_fns may be a dict {index: fn} or list). An index
    with no branch takes ``default``, else the nearest branch (the JAX
    package's clipped ``lax.switch``)."""
    if isinstance(branch_fns, dict):
        keys = sorted(branch_fns)
        fns = [branch_fns[k] for k in keys]
    else:
        fns = list(branch_fns)
        keys = list(range(len(fns)))
    if _tracing() and isinstance(branch_index, torch.Tensor):
        idx = branch_index.reshape(())
        out = default if default is not None else fns[-1]
        for k, f in reversed(list(zip(keys, fns))):
            out = (lambda k=k, f=f, rest=out:
                   torch.cond(idx == k, lambda: f(), lambda: rest(), ()))
        return out()
    i = int(torch.as_tensor(branch_index).reshape(()))
    if i in keys:
        return fns[keys.index(i)]()
    if default is not None:
        return default()
    pos = int(np.searchsorted(np.asarray(keys), i)) \
        if isinstance(branch_fns, dict) else i
    return fns[min(max(pos, 0), len(fns) - 1)]()


class StaticRNN:
    """Step-scanned RNN builder (ref: fluid/layers/control_flow
    StaticRNN: step-scope program region): record the step function,
    scan it over the time axis at output time."""

    def __init__(self, name=None):
        self._inputs: List = []
        self._memories: List = []
        self._step: Optional[Callable] = None

    def step(self):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def step_input(self, x):
        self._inputs.append(_tensor(x))
        return x

    def memory(self, init=None, shape=None, batch_ref=None,
               init_value=0.0):
        if init is None:
            b = (batch_ref.shape[1] if batch_ref is not None
                 else self._inputs[0].shape[1])
            init = torch.full((b,) + tuple(shape or ()), init_value,
                              device=_device())
        self._memories.append(_tensor(init))
        return init

    def set_step_fn(self, fn: Callable):
        """Explicit API: fn(x_t, *mems) -> (out_t, *new_mems)."""
        self._step = fn

    def update_memory(self, old, new):
        self._update = (old, new)

    def step_output(self, o):
        self._out = o

    def __call__(self):
        if self._step is None:
            raise ValueError("StaticRNN: call set_step_fn(fn) with "
                             "fn(x_t, *mems) -> (out_t, *mems)")
        mems = tuple(self._memories)
        ys = []
        for x_t in self._inputs[0]:
            out = self._step(x_t, *mems)
            mems = tuple(out[1:])
            ys.append(out[0])
        return torch.stack(ys)


# ---------------------------------------------------------------------------
# sequence ops over (padded, lengths) — ref: operators/sequence_ops/
# ---------------------------------------------------------------------------

def _len_mask(x, length, time_axis=1):
    t = x.shape[time_axis]
    if length is None:
        return torch.ones(tuple(x.shape[:2]) if time_axis == 1
                          else (x.shape[0], t), dtype=torch.bool,
                          device=x.device)
    length = _tensor(length).to(x.device).reshape(-1)
    return torch.arange(t, device=x.device)[None, :] < length[:, None]


def sequence_pad(x, pad_value, maxlen=None, length=None, name=None):
    """(list of [Ti, D] | padded) → (padded [B, T, D], lengths [B])
    (ref: sequence_pad_op)."""
    if isinstance(x, (list, tuple)):
        lens = np.asarray([len(s) for s in x])
        t = maxlen or int(lens.max())
        d = np.shape(x[0])[1:]
        out = np.full((len(x), t) + d, pad_value, np.float32)
        for i, s in enumerate(x):
            out[i, :len(s)] = np.asarray(s)
        return _tensor(out), _tensor(lens)
    x = _tensor(x)
    mask = _len_mask(x, length)
    shape = tuple(mask.shape) + (1,) * (x.dim() - 2)
    out = torch.where(mask.reshape(shape), x,
                      torch.as_tensor(pad_value, dtype=x.dtype,
                                      device=x.device))
    lens = (_tensor(length) if length is not None
            else torch.full((x.shape[0],), x.shape[1], device=x.device))
    return out, lens


def sequence_unpad(x, length, name=None):
    """padded [B, T, D] + lengths → list of [Ti, D] (host-side ragged;
    ref: sequence_unpad_op)."""
    from .program import _numpy
    xn = _numpy(x)
    ln = _numpy(length).reshape(-1)
    return [xn[i, :int(ln[i])] for i in range(xn.shape[0])]


def sequence_pool(input, pool_type, is_test=False, pad_value=0.0,
                  length=None):
    """sum/average/max/sqrt/first/last over the time axis under the
    length mask (ref: sequence_pool_op)."""
    def fn(x):
        mask = _len_mask(x, length)
        m = mask.reshape(tuple(mask.shape) + (1,) * (x.dim() - 2))
        pt = pool_type.lower()
        cnt = torch.clamp(m.sum(1), min=1)
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        if pt == "sum":
            return torch.where(m, x, zero).sum(1)
        if pt in ("average", "avg", "mean"):
            return torch.where(m, x, zero).sum(1) / cnt
        if pt == "sqrt":
            return torch.where(m, x, zero).sum(1) / torch.sqrt(cnt.to(
                x.dtype))
        if pt == "max":
            return torch.where(m, x, torch.full((), -math.inf,
                                                dtype=x.dtype,
                                                device=x.device)).amax(1)
        if pt == "first":
            return x[:, 0]
        if pt == "last":
            if length is None:
                return x[:, -1]
            idx = _tensor(length).to(x.device).reshape(-1).long() - 1
            return torch.take_along_dim(
                x, idx.reshape(-1, 1, *([1] * (x.dim() - 2))), dim=1
            )[:, 0]
        raise ValueError(f"unknown pool_type {pool_type}")

    return _lift(fn, input)


def sequence_first_step(input, length=None):
    return sequence_pool(input, "first", length=length)


def sequence_last_step(input, length=None):
    return sequence_pool(input, "last", length=length)


def sequence_softmax(input, use_cudnn=False, name=None, length=None):
    def fn(x):
        mask = _len_mask(x, length)
        m = mask.reshape(tuple(mask.shape) + (1,) * (x.dim() - 2))
        z = torch.where(m, x, torch.full((), -math.inf, dtype=x.dtype,
                                         device=x.device))
        return torch.where(m, torch.softmax(z, dim=1),
                           torch.zeros((), dtype=x.dtype, device=x.device))

    return _lift(fn, input)


def sequence_reverse(x, name=None, length=None):
    """Reverse each row WITHIN its length; padding stays in place
    (ref: sequence_reverse_op)."""
    def fn(xv):
        t = xv.shape[1]
        if length is None:
            return torch.flip(xv, dims=(1,))
        ln = _tensor(length).to(xv.device).reshape(-1, 1).long()
        idx = torch.arange(t, device=xv.device)[None, :]
        src = torch.where(idx < ln, ln - 1 - idx, idx)
        src = src.reshape(tuple(src.shape) + (1,) * (xv.dim() - 2))
        return torch.take_along_dim(xv, src, dim=1)

    return _lift(fn, x)


def sequence_concat(input: Sequence, name=None, lengths=None):
    """Concatenate rows time-wise, packing valid prefixes first (ref:
    sequence_concat_op)."""
    from .program import _numpy
    if lengths is None:
        return _lift(lambda *xs: torch.cat(xs, dim=1), *input)
    xs = [_numpy(x) for x in input]
    lns = [_numpy(l).reshape(-1) for l in lengths]
    b = xs[0].shape[0]
    total = sum(x.shape[1] for x in xs)
    d = xs[0].shape[2:]
    out = np.zeros((b, total) + d, xs[0].dtype)
    newlen = np.zeros((b,), np.int64)
    for i in range(b):
        pos = 0
        for x, ln in zip(xs, lns):
            li = int(ln[i])
            out[i, pos:pos + li] = x[i, :li]
            pos += li
        newlen[i] = pos
    return _tensor(out), _tensor(newlen)


def sequence_expand(x, y, ref_level=-1, name=None, y_lengths=None):
    """Repeat each row of x per the matching row-count of y (ref:
    sequence_expand_op; with padded carriers a repeat along batch)."""
    from .program import _numpy
    if y_lengths is not None:
        reps = _numpy(y_lengths).reshape(-1)
        return _tensor(np.repeat(_numpy(x), reps, axis=0))
    return _lift(lambda xv, yv: torch.repeat_interleave(
        xv, yv.shape[1], dim=0), x, y)


def sequence_expand_as(x, y, name=None):
    def fn(xv, yv):
        reps = yv.shape[0] // xv.shape[0]
        return torch.repeat_interleave(xv, reps, dim=0)

    return _lift(fn, x, y)


def sequence_reshape(input, new_dim, length=None):
    """Re-chunk the feature dim (ref: sequence_reshape_op): [B, T, D]
    → [B, T*D/new_dim, new_dim]."""
    return _lift(lambda x: x.reshape(x.shape[0], -1, new_dim), input)


def sequence_slice(input, offset, length, name=None):
    """Per-row [offset, offset+length) time slice (ref:
    sequence_slice_op); ragged via per-row gather."""
    def fn(x, off, ln):
        off = torch.as_tensor(off, device=x.device).reshape(-1).long()
        ln_ = torch.as_tensor(ln, device=x.device).reshape(-1)
        t_out = int(ln_.max())
        idx = off[:, None] + torch.arange(t_out, device=x.device)[None, :]
        idx = torch.clamp(idx, max=x.shape[1] - 1)
        out = torch.take_along_dim(
            x, idx.reshape(tuple(idx.shape) + (1,) * (x.dim() - 2)), dim=1)
        mask = torch.arange(t_out, device=x.device)[None, :] < ln_[:, None]
        return out * mask.reshape(tuple(mask.shape) +
                                  (1,) * (x.dim() - 2)).to(out.dtype)

    return _lift(fn, input, offset, length)


def sequence_scatter(input, index, updates, name=None):
    """Scatter updates at (row, time) positions (ref:
    sequence_scatter_op; index [N, 2] of (batch, t))."""
    def fn(x, idx, upd):
        idx = torch.as_tensor(idx, device=x.device).long()
        return x.index_put((idx[:, 0], idx[:, 1]), upd.to(x.dtype),
                           accumulate=True)

    return _lift(fn, input, index, updates)


def sequence_enumerate(input, win_size, pad_value=0, name=None):
    """Sliding windows of ids (ref: sequence_enumerate_op): [B, T] →
    [B, T, win_size], short windows padded."""
    import torch.nn.functional as TF

    def fn(x):
        t = x.shape[1]
        pads = [0, 0] * (x.dim() - 2) + [0, win_size - 1]
        xp = TF.pad(x, pads, value=pad_value)
        return torch.stack([xp[:, i:i + t] for i in range(win_size)],
                           dim=-1)

    return _lift(fn, input)


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=True, padding_start=None, bias_attr=None,
                  param_attr=None, act=None, name=None):
    """Context-window 1-D conv over time (ref: sequence_conv_op): each
    step sees [t+start, t+start+filter_size) rows flattened."""
    import torch.nn.functional as TF
    d = int(input.shape[-1])
    w = create_parameter([filter_size * d, num_filters])
    b = create_parameter([num_filters])
    start = padding_start if padding_start is not None \
        else -(filter_size // 2)

    def fn(x, wv, bv):
        t = x.shape[1]
        before, after = max(0, -start), max(0, start + filter_size - 1)
        pads = [0, 0] * (x.dim() - 2) + [before, after]
        xp = TF.pad(x, pads)
        ctx = torch.cat([xp[:, i:i + t] for i in range(filter_size)],
                        dim=-1)
        return ctx @ wv + bv

    return _op(fn, input, w, b,
               shape=tuple(input.shape[:2]) + (num_filters,))
