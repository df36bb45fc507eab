"""RNN layers (counterpart of paddle_tpu/layers/rnn.py): ``dynamic_lstm``,
``dynamic_gru`` and ``gru_unit`` on the batch-major dense (N, T, ...)
layout, each one op (ops/rnn_ops.py) with the JAX package's names,
attrs and parameters."""
from ..layer_helper import LayerHelper


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=False, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None):
    """input: (N, T, 4 * hidden) already projected (the reference's
    contract); size = 4 * hidden. Returns (hidden, cell), each
    (N, T, hidden)."""
    helper = LayerHelper("dynamic_lstm", param_attr=param_attr,
                         bias_attr=bias_attr, name=name, dtype=dtype)
    hidden = size // 4
    w = helper.create_parameter(helper.param_attr, shape=[hidden, 4 * hidden],
                                dtype=dtype)
    b = helper.create_parameter(helper.bias_attr, shape=[4 * hidden],
                                dtype=dtype, is_bias=True)
    n, t = input.shape[0], input.shape[1]
    hidden_out = helper.create_variable_for_type_inference(
        dtype, (n, t, hidden))
    cell_out = helper.create_variable_for_type_inference(dtype,
                                                         (n, t, hidden))
    last_h = helper.create_variable_for_type_inference(dtype, (n, hidden))
    last_c = helper.create_variable_for_type_inference(dtype, (n, hidden))
    inputs = {"Input": [input.name], "Weight": [w.name], "Bias": [b.name]}
    if h_0 is not None:
        inputs["H0"] = [h_0.name]
    if c_0 is not None:
        inputs["C0"] = [c_0.name]
    helper.append_op(
        "lstm_seq", inputs=inputs,
        outputs={"Hidden": [hidden_out.name], "Cell": [cell_out.name],
                 "LastH": [last_h.name], "LastC": [last_c.name]},
        attrs={"is_reverse": is_reverse, "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation})
    return hidden_out, cell_out


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, dtype="float32"):
    """input: (N, T, 3 * size) already projected; returns hidden
    (N, T, size)."""
    helper = LayerHelper("dynamic_gru", param_attr=param_attr,
                         bias_attr=bias_attr, dtype=dtype)
    w = helper.create_parameter(helper.param_attr, shape=[size, 3 * size],
                                dtype=dtype)
    b = helper.create_parameter(helper.bias_attr, shape=[3 * size],
                                dtype=dtype, is_bias=True)
    n, t = input.shape[0], input.shape[1]
    hidden_out = helper.create_variable_for_type_inference(dtype, (n, t, size))
    last_h = helper.create_variable_for_type_inference(dtype, (n, size))
    inputs = {"Input": [input.name], "Weight": [w.name], "Bias": [b.name]}
    if h_0 is not None:
        inputs["H0"] = [h_0.name]
    helper.append_op(
        "gru_seq", inputs=inputs,
        outputs={"Hidden": [hidden_out.name], "LastH": [last_h.name]},
        attrs={"is_reverse": is_reverse, "gate_activation": gate_activation,
               "activation": candidate_activation})
    return hidden_out


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid"):
    """One GRU step: input (N, size) already projected, size = 3 * hidden.
    Returns (hidden, reset hidden prev, gate)."""
    helper = LayerHelper("gru_unit", param_attr=param_attr,
                         bias_attr=bias_attr)
    hidden_dim = size // 3
    w = helper.create_parameter(helper.param_attr,
                                shape=[hidden_dim, 3 * hidden_dim],
                                dtype=input.dtype)
    b = helper.create_parameter(helper.bias_attr, shape=[3 * hidden_dim],
                                dtype=input.dtype, is_bias=True)
    n = input.shape[0]
    out_h = helper.create_variable_for_type_inference(input.dtype,
                                                      (n, hidden_dim))
    gate = helper.create_variable_for_type_inference(input.dtype)
    reset_h = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "gru_unit",
        inputs={"Input": [input.name], "HiddenPrev": [hidden.name],
                "Weight": [w.name], "Bias": [b.name]},
        outputs={"Hidden": [out_h.name], "Gate": [gate.name],
                 "ResetHiddenPrev": [reset_h.name]},
        attrs={"activation": activation, "gate_activation": gate_activation})
    return out_h, reset_h, gate


__all__ = ["dynamic_lstm", "dynamic_gru", "gru_unit"]
