"""Dygraph nn modules.

Counterpart of paddle_tpu/dygraph/nn.py (reference: dygraph/nn.py:
Conv2D, Pool2D, FC/Linear, BatchNorm, Embedding, LayerNorm, GRUUnit,
Dropout ...). Forward math calls the SAME op kernels as graph mode
(``ops/*``) through ``run_op``, eagerly, so ``LayerNorm`` reaches the
LayerNorm kernels' autograd Function and the static layers dispatched
eagerly (``layers.fused_attention``, ``layers.fused_mlm_head_loss``)
reach the flash-attention and fused-head kernels. ``Linear``, ``FC``,
``PRelu`` and ``SequenceConv`` are plain torch expressions
(``apply_eager``), as the JAX package writes them in jnp outside any
Pallas kernel. Weights are drawn as the JAX package draws them (the
global numpy RNG or ``create_parameter``), and ``run_op`` draws its
context's seed from the global numpy RNG as the JAX package's does, so
a layer built after the same calls equals the JAX package's bit for bit.
"""
import numpy as np
import torch

from . import base
from .base import EagerVariable, apply_eager
from .layers import Layer
from ..ops.registry import get_op


class _EagerCtx(object):
    """What an op kernel sees as ``ctx`` in dygraph mode: the guard's
    device and, for a random op, a ``torch.Generator`` on that device.
    The seed is drawn from numpy's global RNG when the context is made
    (paddle_tpu's ``_EagerCtx``: a jax key seeded the same way); the n-th
    draw of the op seeds its generator from (seed, n), as the JAX package
    folds n into its key."""

    def __init__(self, device, seed=None):
        self.device = device
        self._seed = int(np.random.randint(0, 2**31)
                         if seed is None else seed)
        self._n = 0

    def generator(self, attrs=None, flagged=True):
        self._n += 1
        g = torch.Generator(device=self.device)
        g.manual_seed(self._seed * 1000003 + self._n)
        return g

    def constant(self, make):
        return make()


def run_op(op_type, ins, attrs=None, ctx=None, out_binding=None):
    """Eagerly run a registered kernel on EagerVariables/arrays, under
    autograd when it records (reference: imperative tracer TraceOp), so
    ``.backward()`` reaches through it. Differentiable slots follow the
    registry's ``nondiff`` metadata (an input there is detached), the same
    partition the static backward uses. out_binding: {slot:
    [EagerVariable]} — bind results onto existing placeholder variables
    (the LayerHelper eager path) instead of allocating fresh ones."""
    kernel = get_op(op_type)
    evs = {k: [v if isinstance(v, EagerVariable)
               else EagerVariable(v, stop_gradient=True) for v in vs]
           for k, vs in ins.items()}
    attrs = attrs or {}
    if ctx is None:
        # the guard's device; outside a guard, where the inputs are
        first = next((v._value for vs in evs.values() for v in vs), None)
        ctx = _EagerCtx(base._device[0] or (
            first.device if first is not None else base.current_device()))
    diff = [v for slot in sorted(evs) if slot not in kernel.nondiff
            for v in evs[slot]]
    record = kernel.differentiable and base._should_record(diff)
    tins = {k: [v._value.detach() if record and k in kernel.nondiff
                else v._value for v in vs] for k, vs in evs.items()}
    with torch.set_grad_enabled(record):
        outs = kernel.fn(ctx, tins, attrs)
    flat_in = [t for vs in tins.values() for t in vs]
    binding = out_binding or {}
    result = {}
    for k, v in outs.items():
        if v is None:
            continue
        listy = isinstance(v, (list, tuple))
        bound = binding.get(k) or []
        wrapped = []
        for i, t in enumerate(list(v) if listy else [v]):
            if record:
                t = base._unalias(t, flat_in)
            if i < len(bound):
                bound[i]._set_output(t, record)
                wrapped.append(bound[i])
            else:
                wrapped.append(EagerVariable._output(t, record))
        result[k] = wrapped if listy else wrapped[0]
    return result


def _write_into(buffer, new):
    """A layer's state (running statistics, power-iteration vectors)
    takes an op's new value in its own tensor, as the optimizers write a
    parameter: a TracedLayer's CUDA graph reads the buffer by address."""
    with torch.no_grad():
        buffer._value.copy_(new._value.detach())


def _act(out, act):
    return run_op(act, {"X": [out]})["Out"] if act else out


def _ntuple(v, n):
    return [v] * n if isinstance(v, int) else list(v)


class Linear(Layer):
    def __init__(self, input_dim, output_dim, param_attr=None,
                 bias_attr=None, act=None, dtype="float32"):
        super(Linear, self).__init__(dtype=dtype)
        self.weight = self.add_parameter(
            "weight", self.create_parameter([input_dim, output_dim],
                                            attr=param_attr))
        self.bias = self.add_parameter(
            "bias", self.create_parameter([output_dim], is_bias=True,
                                          attr=bias_attr))
        self._act = act

    def forward(self, input):
        out = apply_eager(lambda x, w, b: torch.matmul(x, w) + b,
                          input, self.weight, self.bias)
        return _act(out, self._act)


class Conv2D(Layer):
    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, param_attr=None,
                 bias_attr=None, act=None, dtype="float32"):
        super(Conv2D, self).__init__(dtype=dtype)
        fs = _ntuple(filter_size, 2)
        std = (2.0 / (fs[0] * fs[1] * num_channels)) ** 0.5
        w = np.random.normal(
            0, std, [num_filters, num_channels // groups] + fs
        ).astype(np.float32)
        self.weight = self.add_parameter("weight", EagerVariable(w))
        self.bias = self.add_parameter(
            "bias", self.create_parameter([num_filters], is_bias=True))
        self._attrs = {"strides": _ntuple(stride, 2),
                       "paddings": _ntuple(padding, 2),
                       "dilations": _ntuple(dilation, 2),
                       "groups": groups}
        self._act = act

    def forward(self, input):
        out = run_op("conv2d", {"Input": [input], "Filter": [self.weight]},
                     self._attrs)["Output"]
        out = apply_eager(lambda o, b: o + b.reshape(1, -1, 1, 1),
                          out, self.bias)
        return _act(out, self._act)


class Pool2D(Layer):
    def __init__(self, pool_size=-1, pool_type="max", pool_stride=1,
                 pool_padding=0, global_pooling=False, ceil_mode=False,
                 exclusive=True):
        super(Pool2D, self).__init__()
        self._attrs = {"ksize": _ntuple(pool_size, 2),
                       "pooling_type": pool_type,
                       "strides": _ntuple(pool_stride, 2),
                       "paddings": _ntuple(pool_padding, 2),
                       "global_pooling": global_pooling,
                       "exclusive": exclusive}

    def forward(self, input):
        return run_op("pool2d", {"X": [input]}, self._attrs)["Out"]


class BatchNorm(Layer):
    def __init__(self, num_channels, act=None, is_test=False, momentum=0.9,
                 epsilon=1e-5, param_attr=None, bias_attr=None,
                 dtype="float32", data_layout="NCHW",
                 use_global_stats=False):
        super(BatchNorm, self).__init__(dtype=dtype)
        c = num_channels
        self.weight = self.add_parameter(
            "weight", EagerVariable(np.ones(c, np.float32)))
        self.bias = self.add_parameter(
            "bias", EagerVariable(np.zeros(c, np.float32)))
        self._mean = EagerVariable(np.zeros(c, np.float32),
                                   stop_gradient=True)
        self._variance = EagerVariable(np.ones(c, np.float32),
                                       stop_gradient=True)
        self._attrs = {"momentum": momentum, "epsilon": epsilon,
                       "data_layout": data_layout,
                       "use_global_stats": use_global_stats}
        self._act = act

    def forward(self, input):
        attrs = dict(self._attrs)
        attrs["is_test"] = not self.training
        outs = run_op("batch_norm",
                      {"X": [input], "Scale": [self.weight],
                       "Bias": [self.bias], "Mean": [self._mean],
                       "Variance": [self._variance]}, attrs)
        if not (attrs["is_test"] or attrs["use_global_stats"]):
            _write_into(self._mean, outs["MeanOut"])
            _write_into(self._variance, outs["VarianceOut"])
        return _act(outs["Y"], self._act)


class Embedding(Layer):
    def __init__(self, size, is_sparse=False, padding_idx=None,
                 param_attr=None, dtype="float32"):
        super(Embedding, self).__init__(dtype=dtype)
        w = np.random.normal(0, 0.02, size).astype(np.float32)
        self.weight = self.add_parameter("weight", EagerVariable(w))
        self._padding_idx = -1 if padding_idx is None else padding_idx

    def forward(self, input):
        return run_op("lookup_table",
                      {"W": [self.weight], "Ids": [input]},
                      {"padding_idx": self._padding_idx})["Out"]


class LayerNorm(Layer):
    def __init__(self, normalized_shape, scale=True, shift=True,
                 epsilon=1e-5, param_attr=None, bias_attr=None,
                 act=None, dtype="float32"):
        super(LayerNorm, self).__init__(dtype=dtype)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        n = int(np.prod(normalized_shape))
        self.weight = self.add_parameter(
            "weight", EagerVariable(np.ones(n, np.float32)))
        self.bias = self.add_parameter(
            "bias", EagerVariable(np.zeros(n, np.float32)))
        self._epsilon = epsilon
        self._act = act

    def forward(self, input):
        out = run_op("layer_norm",
                     {"X": [input], "Scale": [self.weight],
                      "Bias": [self.bias]},
                     {"epsilon": self._epsilon,
                      "begin_norm_axis": len(input.shape) - 1})["Y"]
        return _act(out, self._act)


class Dropout(Layer):
    def __init__(self, p=0.5, mode="downgrade_in_infer"):
        super(Dropout, self).__init__()
        self._p = p
        self._mode = mode

    def forward(self, input):
        return run_op("dropout", {"X": [input]},
                      {"dropout_prob": self._p,
                       "is_test": not self.training,
                       "dropout_implementation": self._mode})["Out"]


class GRUUnit(Layer):
    def __init__(self, size, param_attr=None, bias_attr=None,
                 activation="tanh", gate_activation="sigmoid",
                 dtype="float32"):
        super(GRUUnit, self).__init__(dtype=dtype)
        h = size // 3
        self.weight = self.add_parameter(
            "weight", self.create_parameter([h, 3 * h]))
        self.bias = self.add_parameter(
            "bias", self.create_parameter([3 * h], is_bias=True))
        self._attrs = {"activation": activation,
                       "gate_activation": gate_activation}

    def forward(self, input, hidden):
        outs = run_op("gru_unit",
                      {"Input": [input], "HiddenPrev": [hidden],
                       "Weight": [self.weight], "Bias": [self.bias]},
                      self._attrs)
        return outs["Hidden"], outs["ResetHiddenPrev"], outs["Gate"]


class FC(Layer):
    """Multi-dim fc (ref dygraph/nn.py:960): flattens input from
    num_flatten_dims on, like the static fc."""

    def __init__(self, name_scope, size, num_flatten_dims=1,
                 param_attr=None, bias_attr=None, act=None,
                 dtype="float32"):
        super(FC, self).__init__(dtype=dtype)
        self._size = size
        self._nfd = num_flatten_dims
        self._param_attr = param_attr
        self._bias_attr = bias_attr
        self._act = act
        self._built = False

    def _build_once(self, shape):
        d = int(np.prod(shape[self._nfd:]))
        self.weight = self.add_parameter(
            "weight", self.create_parameter([d, self._size],
                                            attr=self._param_attr))
        self.bias = self.add_parameter(
            "bias", self.create_parameter([self._size], is_bias=True,
                                          attr=self._bias_attr))
        self._built = True

    def forward(self, input):
        if not self._built:
            self._build_once(tuple(input.shape))
        nfd = self._nfd

        def fc(x, w, b):
            flat = x.reshape(tuple(x.shape[:nfd]) + (-1,))
            return torch.matmul(flat, w) + b

        out = apply_eager(fc, input, self.weight, self.bias)
        return _act(out, self._act)


class _ConvNd(Layer):
    """Conv2DTranspose, Conv3D and Conv3DTranspose: an N(0, 0.02) filter
    from numpy's global RNG, a zero bias and the graph op of
    ``_op_type``."""
    _op_type, _nd, _transposed = None, 0, False

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, param_attr=None,
                 bias_attr=None, act=None, dtype="float32"):
        super(_ConvNd, self).__init__(dtype=dtype)
        fs = _ntuple(filter_size, self._nd)
        io = [num_channels, num_filters // groups] if self._transposed \
            else [num_filters, num_channels // groups]
        w = np.random.normal(0, 0.02, io + fs).astype(np.float32)
        self.weight = self.add_parameter("weight", EagerVariable(w))
        self.bias = self.add_parameter(
            "bias", self.create_parameter([num_filters], is_bias=True))
        self._attrs = {"strides": _ntuple(stride, self._nd),
                       "paddings": _ntuple(padding, self._nd),
                       "dilations": _ntuple(dilation, self._nd),
                       "groups": groups}
        self._act = act

    def forward(self, input):
        out = run_op(self._op_type,
                     {"Input": [input], "Filter": [self.weight]},
                     self._attrs)["Output"]
        bshape = (1, -1) + (1,) * self._nd
        out = apply_eager(lambda o, b: o + b.reshape(bshape), out,
                          self.bias)
        return _act(out, self._act)


class Conv2DTranspose(_ConvNd):
    """ref dygraph/nn.py:2282 — transposed conv via the graph kernel."""
    _op_type, _nd, _transposed = "conv2d_transpose", 2, True


class Conv3D(_ConvNd):
    """ref dygraph/nn.py:273."""
    _op_type, _nd, _transposed = "conv3d", 3, False


class Conv3DTranspose(_ConvNd):
    """ref dygraph/nn.py:475."""
    _op_type, _nd, _transposed = "conv3d_transpose", 3, True


class GroupNorm(Layer):
    """ref dygraph/nn.py:2672."""

    def __init__(self, channels, groups, epsilon=1e-5, param_attr=None,
                 bias_attr=None, act=None, dtype="float32"):
        super(GroupNorm, self).__init__(dtype=dtype)
        self.weight = self.add_parameter(
            "weight", EagerVariable(np.ones(channels, np.float32)))
        self.bias = self.add_parameter(
            "bias", EagerVariable(np.zeros(channels, np.float32)))
        self._attrs = {"groups": groups, "epsilon": epsilon}
        self._act = act

    def forward(self, input):
        out = run_op("group_norm",
                     {"X": [input], "Scale": [self.weight],
                      "Bias": [self.bias]}, self._attrs)["Y"]
        return _act(out, self._act)


class SpectralNorm(Layer):
    """ref dygraph/nn.py:2772 — power-iteration U/V kept as buffers."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32"):
        super(SpectralNorm, self).__init__(dtype=dtype)
        h = weight_shape[dim]
        w = int(np.prod(weight_shape)) // h
        self._u = EagerVariable(
            np.random.normal(0, 1, h).astype(np.float32))
        self._v = EagerVariable(
            np.random.normal(0, 1, w).astype(np.float32))
        self._attrs = {"dim": dim, "power_iters": power_iters, "eps": eps}

    def forward(self, weight):
        outs = run_op("spectral_norm",
                      {"Weight": [weight], "U": [self._u],
                       "V": [self._v]}, self._attrs)
        # persist the power-iteration state so sigma converges across
        # calls (the static path writes UOut/VOut back the same way)
        if self._attrs["power_iters"] > 0:
            _write_into(self._u, outs["UOut"])
            _write_into(self._v, outs["VOut"])
        return outs["Out"]


class PRelu(Layer):
    """ref dygraph/nn.py:2092 — mode in all/channel/element."""

    def __init__(self, mode, input_shape=None, param_attr=None,
                 dtype="float32"):
        super(PRelu, self).__init__(dtype=dtype)
        self._mode = mode
        if mode == "all":
            shape = [1]
        elif mode == "channel":
            if input_shape is None:
                raise ValueError("channel mode needs input_shape")
            shape = [input_shape[1] if len(input_shape) > 1
                     else input_shape[0]]
        elif mode == "element":
            if input_shape is None:
                raise ValueError("element mode needs input_shape")
            shape = list(input_shape[1:])
        else:
            raise ValueError("mode must be all/channel/element")
        self.weight = self.add_parameter(
            "weight",
            EagerVariable(np.full(shape, 0.25, np.float32)))
        self._shape = shape

    def forward(self, input):
        mode = self._mode

        def prelu(x, a):
            if mode == "channel":
                a = a.reshape((1, -1) + (1,) * (x.dim() - 2))
            elif mode == "element":
                a = a.reshape((1,) + tuple(a.shape))
            return torch.where(x > 0, x, a * x)

        return apply_eager(prelu, input, self.weight)


class NCE(Layer):
    """ref dygraph/nn.py:1858 — NCE loss head over (input, label)."""

    def __init__(self, num_total_classes, dim, sample_weight=None,
                 param_attr=None, bias_attr=None, num_neg_samples=10,
                 sampler="uniform", custom_dist=None, seed=0,
                 is_sparse=False, dtype="float32"):
        super(NCE, self).__init__(dtype=dtype)
        if custom_dist is not None or sampler == "custom_dist":
            raise NotImplementedError(
                "NCE custom_dist sampling is not implemented; supported "
                "samplers: uniform, log_uniform")
        if sample_weight is not None:
            raise NotImplementedError(
                "NCE sample_weight is not implemented")
        self.weight = self.add_parameter(
            "weight", self.create_parameter([num_total_classes, dim]))
        self.bias = self.add_parameter(
            "bias", self.create_parameter([num_total_classes],
                                          is_bias=True))
        self._attrs = {"num_total_classes": num_total_classes,
                       "num_neg_samples": num_neg_samples,
                       "sampler": sampler}

    def forward(self, input, label, sample_weight=None):
        if sample_weight is not None:
            raise NotImplementedError(
                "NCE sample_weight is not implemented")
        return run_op("nce",
                      {"Input": [input], "Label": [label],
                       "Weight": [self.weight], "Bias": [self.bias]},
                      self._attrs)["Cost"]


class BilinearTensorProduct(Layer):
    """ref dygraph/nn.py:2174: out_i = x W_i y^T."""

    def __init__(self, input1_dim, input2_dim, output_dim,
                 param_attr=None, bias_attr=None, act=None,
                 dtype="float32"):
        super(BilinearTensorProduct, self).__init__(dtype=dtype)
        self.weight = self.add_parameter(
            "weight", self.create_parameter(
                [output_dim, input1_dim, input2_dim]))
        self.bias = self.add_parameter(
            "bias", self.create_parameter([output_dim], is_bias=True))
        self._act = act

    def forward(self, x, y):
        out = run_op("bilinear_tensor_product",
                     {"X": [x], "Y": [y], "Weight": [self.weight],
                      "Bias": [self.bias]})["Out"]
        return _act(out, self._act)


class RowConv(Layer):
    """ref dygraph/nn.py:2593 — lookahead conv on (B, T, D)."""

    def __init__(self, name_scope, future_context_size, param_attr=None,
                 act=None, dtype="float32"):
        super(RowConv, self).__init__(dtype=dtype)
        self._k = future_context_size
        self._act = act
        self._built = False

    def _build_once(self, d):
        self.weight = self.add_parameter(
            "weight", self.create_parameter([self._k + 1, d]))
        self._built = True

    def forward(self, input):
        if not self._built:
            self._build_once(input.shape[-1])
        out = run_op("row_conv",
                     {"X": [input], "Filter": [self.weight]})["Out"]
        return _act(out, self._act)


class SequenceConv(Layer):
    """ref dygraph/nn.py:2499 — centered context-window conv over time:
    im2col the +-window then one matmul (dense (B, T, D) batches)."""

    def __init__(self, name_scope, num_filters, filter_size=3,
                 filter_stride=1, padding=True, bias_attr=None,
                 param_attr=None, act=None, dtype="float32"):
        super(SequenceConv, self).__init__(dtype=dtype)
        if filter_stride != 1:
            raise ValueError("SequenceConv takes filter_stride 1 only (the "
                             "reference enforces it)")
        self._num_filters = num_filters
        self._filter_size = filter_size
        self._act = act
        self._built = False

    def _build_once(self, d):
        self.weight = self.add_parameter(
            "weight",
            self.create_parameter([self._filter_size * d,
                                   self._num_filters]))
        self.bias = self.add_parameter(
            "bias", self.create_parameter([self._num_filters],
                                          is_bias=True))
        self._built = True

    def forward(self, input):
        if not self._built:
            self._build_once(input.shape[-1])
        fs = self._filter_size
        start = -((fs - 1) // 2)

        def seq_conv(x, w, b):
            bsz, t, d = x.shape
            cols = []
            for k in range(fs):
                off = start + k
                if off < 0:
                    sl = torch.cat([x.new_zeros((bsz, -off, d)),
                                    x[:, :t + off]], dim=1)
                elif off > 0:
                    sl = torch.cat([x[:, off:], x.new_zeros((bsz, off, d))],
                                   dim=1)
                else:
                    sl = x
                cols.append(sl)
            windows = torch.cat(cols, dim=2)   # (B, T, fs*D)
            return torch.matmul(windows, w) + b

        out = apply_eager(seq_conv, input, self.weight, self.bias)
        return _act(out, self._act)


class TreeConv(Layer):
    """ref dygraph/nn.py:2877 — TBCNN over (nodes, edge_set)."""

    def __init__(self, name_scope, output_size, num_filters=1,
                 max_depth=2, act="tanh", param_attr=None,
                 bias_attr=None, dtype="float32"):
        super(TreeConv, self).__init__(dtype=dtype)
        self._output_size = output_size
        self._num_filters = num_filters
        self._max_depth = max_depth
        self._act = act
        self._built = False

    def _build_once(self, f):
        self.weight = self.add_parameter(
            "weight", self.create_parameter(
                [f, 3, self._output_size, self._num_filters]))
        self._built = True

    def forward(self, nodes_vector, edge_set):
        if not self._built:
            self._build_once(nodes_vector.shape[-1])
        out = run_op("tree_conv",
                     {"NodesVector": [nodes_vector],
                      "EdgeSet": [edge_set],
                      "Filter": [self.weight]},
                     {"max_depth": self._max_depth})["Out"]
        return _act(out, self._act)
