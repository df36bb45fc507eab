"""Quantization-aware training: the program pass and its freeze.

Counterpart of paddle_tpu/contrib/slim/qat.py (the reference's
QuantizationTransformPass / QuantizationFreezePass). ``quant_aware``
rewrites a Program in place: every input of a quantizable op (conv2d,
depthwise_conv2d, mul, matmul) is routed through a fake-quant op
(ops/quant_ops.py), per-channel abs-max for a weight, moving-average
abs-max for an activation, with a straight-through gradient, so training
sees int8 rounding while the matmuls and convolutions run in f32. An
activation's moving-average state (``<name>.quantized.act.state`` and
``.accum``) is a persistable the op writes under the names it reads, as
an optimizer writes its moments: the Executor's step writes it back, a
captured step advances it at every replay, and the numeric guard's
"skip" reverts it. ``quant_aware`` puts the state into the scope as f32
CPU tensors (the JAX package's ``jnp.ones((1,))``); the Executor moves
them to its device.

Each op inserted bumps the program's version (``Block._insert_op``), so
a step captured from the program before the pass never replays after
it; ``convert`` removes ops with ``Block._remove_op``, likewise.
"""
import numpy as np
import torch

from ...framework.program import Parameter
from ...framework.scope import global_scope, to_numpy

QUANTIZABLE = ("conv2d", "depthwise_conv2d", "mul", "matmul")

_W_SLOTS = {"conv2d": "Filter", "depthwise_conv2d": "Filter",
            "mul": "Y", "matmul": "Y"}


__all__ = ["quant_aware", "convert", "QUANTIZABLE"]


def quant_aware(program, weight_bits=8, activation_bits=8,
                quantizable_op_types=QUANTIZABLE, moving_rate=0.9,
                skip_pattern="skip_quant", scope=None):
    """Insert fake-quant ops before every quantizable op's inputs (an op
    whose ``op_namescope`` attr holds ``skip_pattern`` is left alone).
    Activation state goes into ``scope`` (default: the global scope)
    unless it is there. Returns the number of rewritten ops (mutates
    ``program``)."""
    scope = scope if scope is not None else global_scope()
    block = program.global_block()
    rewritten = 0
    qdq_cache = {}      # (var name, is_weight) -> quantized replacement
    i = 0
    while i < len(block.ops):
        op = block.ops[i]
        if op.type not in quantizable_op_types or \
                skip_pattern in str(op.attrs.get("op_namescope", "")):
            i += 1
            continue
        w_slot = _W_SLOTS.get(op.type)
        inserted = 0
        for slot, names in list(op.inputs.items()):
            new_names = []
            for name in names:
                var = block.var(name)
                is_weight = isinstance(var, Parameter) and slot == w_slot
                # one replacement per (var, mode): a tied parameter read
                # in a weight slot and an activation slot gets both
                key = (name, is_weight)
                if key in qdq_cache:
                    new_names.append(qdq_cache[key])
                    continue
                q_name = name + (".quantized" if is_weight
                                 else ".quantized.act")
                block.create_var(name=q_name, shape=var.shape,
                                 dtype=var.dtype)
                scale_var = block.create_var(
                    name=q_name + ".scale", stop_gradient=True)
                if is_weight:
                    # per output channel for a conv filter (axis 0 of
                    # OIHW), per input-feature column (axis 1) for a
                    # mul/matmul weight, as the JAX package does
                    axis = 0 if "conv" in op.type else 1
                    block._insert_op(
                        i, "fake_channel_wise_quantize_dequantize_abs_max",
                        inputs={"X": [name]},
                        outputs={"Out": [q_name],
                                 "OutScale": [scale_var.name]},
                        attrs={"bit_length": weight_bits,
                               "quant_axis": axis})
                else:
                    state = block.create_var(
                        name=q_name + ".state", shape=(1,),
                        persistable=True, stop_gradient=True)
                    accum = block.create_var(
                        name=q_name + ".accum", shape=(1,),
                        persistable=True, stop_gradient=True)
                    if scope.find_var(state.name) is None:
                        scope.set_var(state.name, torch.ones(1))
                        scope.set_var(accum.name, torch.zeros(1))
                    block._insert_op(
                        i,
                        "fake_quantize_dequantize_moving_average_abs_max",
                        inputs={"X": [name], "InState": [state.name],
                                "InAccum": [accum.name]},
                        outputs={"Out": [q_name],
                                 "OutScale": [scale_var.name],
                                 "OutState": [state.name],
                                 "OutAccum": [accum.name]},
                        attrs={"bit_length": activation_bits,
                               "moving_rate": moving_rate})
                qdq_cache[key] = q_name
                new_names.append(q_name)
                inserted += 1
                i += 1   # the target op shifted right
            op.inputs[slot] = new_names
        if inserted:
            rewritten += 1
        i += 1
    return rewritten


def convert(program, scope=None):
    """Freeze a quant-aware program for int8 export: the activation
    fake-quant ops are removed (their scales, accum / state, come back as
    metadata) and each consumer reads the unquantized activation; the
    weight fake-quant ops stay, so exported f32 weights carry the
    rounding (the JAX package's choice), and each weight's per-channel
    scale is computed as training simulated it.

    Returns {"weights": {param: per-channel scale array},
             "activations": {var: float scale}}."""
    scope = scope if scope is not None else global_scope()
    block = program.global_block()
    w_cfg = {}
    for op in block.ops:
        if op.type == "fake_channel_wise_quantize_dequantize_abs_max":
            w_cfg[op.inputs["X"][0]] = (int(op.attrs.get("quant_axis", 0)),
                                        int(op.attrs.get("bit_length", 8)))
    act_scales = {}
    idx = 0
    while idx < len(block.ops):
        op = block.ops[idx]
        if op.type == "fake_quantize_dequantize_moving_average_abs_max":
            src = op.inputs["X"][0]
            dst = op.outputs["Out"][0]
            accum = scope.find_var(op.inputs["InAccum"][0])
            state = scope.find_var(op.inputs["InState"][0])
            if accum is not None and state is not None:
                act_scales[src] = float(to_numpy(accum)[0] /
                                        max(float(to_numpy(state)[0]),
                                            1e-8))
            for later in block.ops[idx + 1:]:
                for slot, names in later.inputs.items():
                    later.inputs[slot] = [src if n == dst else n
                                          for n in names]
            block._remove_op(idx)
            continue
        idx += 1
    w_scales = {}
    for name, (axis, bits) in w_cfg.items():
        value = scope.find_var(name)
        if value is None:
            continue
        v = to_numpy(value)
        red = tuple(i for i in range(v.ndim) if i != axis)
        w_scales[name] = np.maximum(np.abs(v).max(axis=red), 1e-8)
    return {"weights": w_scales, "activations": act_scales}
