"""Weight-decay regularizers.

Counterpart of paddle_tpu/regularizer.py: a regularizer appends
``grad + coeff * f(param)`` ops (``scale`` and ``sum``; L1 adds ``sign``)
in front of the update op, with the JAX package's op types and attrs.
``append_regularization_ops`` takes a parameter's own regularizer
(``ParamAttr(regularizer=...)``) before the optimizer's.
"""
from .layer_helper import LayerHelper


class WeightDecayRegularizer(object):
    def __call__(self, param, grad, block):
        raise NotImplementedError


def _add_decay(helper, block, param, grad, decay):
    new_grad = helper.create_variable_for_type_inference(param.dtype,
                                                         param.shape)
    block.append_op("sum", inputs={"X": [grad.name, decay.name]},
                    outputs={"Out": [new_grad.name]},
                    attrs={"op_role": "optimize"})
    return new_grad


def _scaled(helper, block, x, param, coeff):
    out = helper.create_variable_for_type_inference(param.dtype, param.shape)
    block.append_op("scale", inputs={"X": [x.name]},
                    outputs={"Out": [out.name]},
                    attrs={"scale": coeff, "op_role": "optimize"})
    return out


class L2DecayRegularizer(WeightDecayRegularizer):
    """grad + coeff * param."""

    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        helper = LayerHelper("l2_decay")
        decay = _scaled(helper, block, param, param, self._coeff)
        return _add_decay(helper, block, param, grad, decay)


class L1DecayRegularizer(WeightDecayRegularizer):
    """grad + coeff * sign(param)."""

    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        helper = LayerHelper("l1_decay")
        sign = helper.create_variable_for_type_inference(param.dtype,
                                                         param.shape)
        block.append_op("sign", inputs={"X": [param.name]},
                        outputs={"Out": [sign.name]},
                        attrs={"op_role": "optimize"})
        decay = _scaled(helper, block, sign, param, self._coeff)
        return _add_decay(helper, block, param, grad, decay)


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer


def append_regularization_ops(parameters_and_grads, regularization=None):
    out = []
    for param, grad in parameters_and_grads:
        regularizer = getattr(param, "regularizer", None) or regularization
        if grad is None or regularizer is None:
            out.append((param, grad))
            continue
        out.append((param, regularizer(param, grad, grad.block)))
    return out


__all__ = ["WeightDecayRegularizer", "L1DecayRegularizer",
           "L2DecayRegularizer", "L1Decay", "L2Decay",
           "append_regularization_ops"]
