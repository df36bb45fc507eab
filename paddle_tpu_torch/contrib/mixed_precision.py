"""Automatic mixed precision (counterpart of
paddle_tpu/contrib/mixed_precision.py; fluid.contrib.mixed_precision).

``decorate(optimizer, dtype=...)`` wraps an optimizer whose ``minimize``
first rewrites the already-built forward: the inputs of white-list ops
(``mul``, ``matmul``, the convolutions, ``scaled_dot_product_attention``,
the fused recurrences) are cast to the compute dtype, and black-list ops
(the losses, the norms, sums and means, ``softmax``, ``exp``/``log``...)
get f32 inputs back. Parameters stay f32 masters. bf16 (the default) has
f32's exponent range and takes the plain update; fp16, or any
``init_loss_scaling`` other than 1, scales the loss, checks every
gradient for Inf/NaN, unscales, zeroes the update on overflow and, with
``use_dynamic_loss_scaling``, grows or shrinks the scale: all of it ops of
the step (``isfinite``, ``logical_and``, ``where``, ``assign``), with no
host sync, so a decorated step is still captured whole into one CUDA
graph on the card.

The program it builds equals the JAX package's op for op (types, order,
cast names and dtypes), including where the reference is odd:
``decr_every_n_nan_or_inf`` is kept but never read, so the scale shrinks
by ``decr_ratio`` at every overflow; bf16 with ``init_loss_scaling`` 1
takes the plain path.
"""
from ..framework.program import Operator
from ..framework import unique_name
from .. import layers
from ..layers import tensor as _tensor

WHITE_LIST = {"mul", "matmul", "conv2d", "depthwise_conv2d",
              "conv2d_transpose", "conv3d", "scaled_dot_product_attention",
              "lstm_seq", "gru_seq"}
BLACK_LIST = {"softmax_with_cross_entropy", "cross_entropy", "layer_norm",
              "batch_norm", "group_norm", "instance_norm", "mean",
              "reduce_mean", "reduce_sum", "sum", "softmax", "log_softmax",
              "exp", "log", "square", "sqrt", "rsqrt",
              "sigmoid_cross_entropy_with_logits", "accuracy", "auc"}


class AutoMixedPrecisionLists(object):
    def __init__(self, custom_white_list=None, custom_black_list=None):
        self.white_list = set(WHITE_LIST) | set(custom_white_list or ())
        self.black_list = set(BLACK_LIST) | set(custom_black_list or ())


def _cast_program_io(block, loss_name, lists, dtype):
    """Insert casts so white-list ops run in ``dtype``, up to the loss's
    producer, rebuilding the op list in one pass; bumps the program's
    version so the compile cache and the verifier's memo miss."""
    last = -1
    for i, op in enumerate(block.ops):
        if loss_name in op.output_names():
            last = i
    low_version = {}   # (f32 var name, dtype) -> its cast's name
    new_ops = []

    def cast_to(name, target):
        var = block._find_var_recursive(name)
        if var is None or var.dtype != "float32":
            return name
        key = (name, target)
        if key in low_version:
            return low_version[key]
        out = unique_name.generate(name + ".cast_" + target)
        block.create_var(name=out, shape=var.shape, dtype=target,
                         stop_gradient=var.stop_gradient)
        new_ops.append(Operator(
            block, "cast", {"X": [name]}, {"Out": [out]},
            {"in_dtype": "float32", "out_dtype": target,
             "op_role": "amp"}))
        low_version[key] = out
        return out

    produced_low = set()
    for i, op in enumerate(block.ops):
        if i > last >= 0:
            new_ops.append(op)
            continue
        if op.type in lists.white_list:
            op.inputs = {slot: [cast_to(n, dtype) for n in names]
                         for slot, names in op.inputs.items()}
            for n in op.output_names():
                v = block._find_var_recursive(n)
                if v is not None and v.dtype == "float32":
                    v.dtype = dtype
                    produced_low.add(n)
        elif op.type in lists.black_list:
            op.inputs = {slot: [cast_to(n, "float32")
                                if n in produced_low else n
                                for n in names]
                         for slot, names in op.inputs.items()}
        new_ops.append(op)
    block.ops = new_ops
    block.program._version += 1


class OptimizerWithMixedPrecision(object):
    def __init__(self, optimizer, amp_lists, init_loss_scaling,
                 use_dynamic_loss_scaling, incr_every_n_steps,
                 decr_every_n_nan_or_inf, incr_ratio, decr_ratio, dtype):
        self._optimizer = optimizer
        self._amp_lists = amp_lists
        self._init_loss_scaling = init_loss_scaling
        self._dynamic = use_dynamic_loss_scaling
        self._incr_every = incr_every_n_steps
        # kept, never read: the reference shrinks at every overflow
        self._decr_every = decr_every_n_nan_or_inf
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._dtype = dtype
        self._loss_scaling = None
        self._good_steps = None

    def get_loss_scaling(self):
        return self._loss_scaling

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        _cast_program_io(loss.block, loss.name, self._amp_lists,
                         self._dtype)
        # bf16 has f32's exponent range: the plain path, no scaling
        if self._dtype != "float16" and self._init_loss_scaling == 1.0:
            return self._optimizer.minimize(loss, startup_program,
                                            parameter_list, no_grad_set)

        self._loss_scaling = layers.create_global_var(
            [1], self._init_loss_scaling, "float32", persistable=True,
            name=unique_name.generate("loss_scaling"))
        scaled_loss = layers.elementwise_mul(loss, self._loss_scaling)
        params_grads = self._optimizer.backward(
            scaled_loss, startup_program, parameter_list, no_grad_set)

        # every gradient finite? unscale; a zero update on overflow
        finite_flags = [layers.isfinite(g) for _, g in params_grads]
        all_finite = finite_flags[0]
        for f in finite_flags[1:]:
            all_finite = layers.logical_and(all_finite, f)
        inv_scale = layers.elementwise_div(
            layers.fill_constant([1], "float32", 1.0), self._loss_scaling)
        new_pgs = []
        layers.fill_constant([1], "float32", 0.0)   # unread, as the reference
        for p, g in params_grads:
            g32 = layers.cast(g, "float32") if g.dtype != "float32" else g
            unscaled = layers.elementwise_mul(g32, inv_scale)
            safe = layers.where(all_finite, unscaled,
                                layers.zeros_like(unscaled))
            new_pgs.append((p, safe))

        if self._dynamic:
            self._append_dynamic_scale_update(all_finite)
        self._optimizer.apply_gradients(new_pgs)
        return [], new_pgs

    def _append_dynamic_scale_update(self, all_finite):
        """The reference's update_loss_scaling: grow the scale by
        ``incr_ratio`` after ``incr_every_n_steps`` clean steps, shrink it
        by ``decr_ratio`` at an overflow; counters in the graph."""
        good = layers.create_global_var(
            [1], 0.0, "float32", persistable=True,
            name=unique_name.generate("good_steps"))
        self._good_steps = good
        one = layers.fill_constant([1], "float32", 1.0)
        good_next = layers.where(all_finite,
                                 layers.elementwise_add(good, one),
                                 layers.zeros_like(good))
        grow = layers.greater_equal(
            good_next, layers.fill_constant([1], "float32",
                                            float(self._incr_every)))
        scale_grown = layers.elementwise_mul(
            self._loss_scaling,
            layers.fill_constant([1], "float32", self._incr_ratio))
        scale_shrunk = layers.elementwise_mul(
            self._loss_scaling,
            layers.fill_constant([1], "float32", self._decr_ratio))
        new_scale = layers.where(
            all_finite,
            layers.where(grow, scale_grown, self._loss_scaling),
            scale_shrunk)
        good_final = layers.where(grow, layers.zeros_like(good_next),
                                  good_next)
        _tensor.assign(new_scale, self._loss_scaling)
        _tensor.assign(good_final, good)


def decorate(optimizer, amp_lists=None, init_loss_scaling=1.0,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.8,
             use_dynamic_loss_scaling=False, dtype="bfloat16"):
    """fluid.contrib.mixed_precision.decorate: ``dtype`` "bfloat16" (no
    scaling unless ``init_loss_scaling`` is set) or "float16" (scaled)."""
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists or AutoMixedPrecisionLists(),
        init_loss_scaling, use_dynamic_loss_scaling, incr_every_n_steps,
        decr_every_n_nan_or_inf, incr_ratio, decr_ratio, dtype)
