"""The linear-chain CRF layers (counterparts in
paddle_tpu/layers/vision.py, where they sit beside the vision layers,
which the port has in layers/nn.py). Kernels: ops/crf_ops.py."""
from ..layer_helper import LayerHelper


def linear_chain_crf(input, label, param_attr=None, length=None):
    """Dense-batch CRF log-likelihood (N, 1): input (N, T, C) emissions,
    label (N, T) or (N, T, 1); the transition parameter is (C + 2, C),
    rows 0 and 1 the start and stop scores, as in the reference."""
    helper = LayerHelper("linear_chain_crf", param_attr=param_attr)
    size = input.shape[-1]
    transition = helper.create_parameter(
        helper.param_attr, shape=[size + 2, size], dtype=input.dtype)
    ll = helper.create_variable_for_type_inference(
        "float32", (input.shape[0], 1))
    alpha = helper.create_variable_for_type_inference("float32")
    em_exps = helper.create_variable_for_type_inference("float32")
    tr_exps = helper.create_variable_for_type_inference("float32")
    inputs = {"Emission": [input.name], "Transition": [transition.name],
              "Label": [label.name]}
    if length is not None:
        inputs["Length"] = [length.name]
    helper.append_op(
        "linear_chain_crf", inputs=inputs,
        outputs={"LogLikelihood": [ll.name], "Alpha": [alpha.name],
                 "EmissionExps": [em_exps.name],
                 "TransitionExps": [tr_exps.name]})
    return ll


def crf_decoding(input, param_attr, label=None, length=None):
    """Viterbi paths (N, T, 1) int64 with the transition parameter that
    linear_chain_crf learned (pass the same param_attr name). As in the
    JAX package, the parameter is created again under that name, and the
    second creation's attributes win (ROADMAP: the ``crfw`` learning
    rate)."""
    helper = LayerHelper("crf_decoding", param_attr=param_attr)
    size = input.shape[-1]
    transition = helper.create_parameter(
        helper.param_attr, shape=[size + 2, size], dtype=input.dtype)
    path = helper.create_variable_for_type_inference(
        "int64", tuple(input.shape[:-1]) + (1,))
    inputs = {"Emission": [input.name], "Transition": [transition.name]}
    if label is not None:
        inputs["Label"] = [label.name]
    if length is not None:
        inputs["Length"] = [length.name]
    helper.append_op("crf_decoding", inputs=inputs,
                     outputs={"ViterbiPath": [path.name]})
    path.stop_gradient = True
    return path


__all__ = ["linear_chain_crf", "crf_decoding"]
