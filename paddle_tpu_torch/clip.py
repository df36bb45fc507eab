"""Error and gradient clipping.

Counterpart of paddle_tpu/clip.py: ``ErrorClipByValue``,
``GradientClipByValue``, ``GradientClipByNorm``,
``GradientClipByGlobalNorm``, ``set_gradient_clip`` and
``append_gradient_clip_ops``, emitting the JAX package's ops. The global
norm is built from ops (``squared_l2_norm`` per gradient, ``sum``,
``sqrt``, ``elementwise_max``/``_div``/``_mul``), so it stays on the
device and no run waits on the host for it. As in the JAX package, the
norm of a bf16 gradient is a bf16 scalar and a clipped bf16 gradient
comes out f32 (the ``float32`` scale promotes it).
"""
from . import layers
from .layer_helper import LayerHelper


class BaseErrorClipAttr(object):
    def _append_clip_op(self, block, grad_name):
        raise NotImplementedError


class ErrorClipByValue(BaseErrorClipAttr):
    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def _append_clip_op(self, block, grad_name):
        block.append_op("clip", inputs={"X": [grad_name]},
                        outputs={"Out": [grad_name]},
                        attrs={"min": self.min, "max": self.max,
                               "op_role": "backward"})


class GradientClipBase(object):
    def _process(self, params_grads):
        raise NotImplementedError

    def _each(self, params_grads, fn):
        return [(p, g if g is None else fn(g)) for p, g in params_grads]


class GradientClipByValue(GradientClipBase):
    """Each gradient element clipped to [min, max]."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(-max if min is None else min)

    def _process(self, params_grads):
        return self._each(params_grads,
                          lambda g: layers.clip(g, self.min, self.max))


class GradientClipByNorm(GradientClipBase):
    """Each gradient scaled to an L2 norm of at most ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _process(self, params_grads):
        return self._each(params_grads,
                          lambda g: layers.clip_by_norm(g, self.clip_norm))


class GradientClipByGlobalNorm(GradientClipBase):
    """Every gradient times clip_norm / max(global norm, clip_norm), the
    global norm taken over all the gradients together."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)

    def _process(self, params_grads):
        helper = LayerHelper("global_norm_clip")
        sq_norms = []
        for p, g in params_grads:
            if g is None:
                continue
            sq = helper.create_variable_for_type_inference("float32", (1,))
            helper.append_op("squared_l2_norm", inputs={"X": [g.name]},
                             outputs={"Out": [sq.name]},
                             attrs={"op_role": "optimize"})
            sq_norms.append(sq)
        if not sq_norms:
            return params_grads
        total = layers.sums(sq_norms) if len(sq_norms) > 1 else sq_norms[0]
        global_norm = layers.sqrt(total)
        max_norm = layers.fill_constant([1], "float32", self.clip_norm)
        scale = layers.elementwise_div(
            max_norm, layers.elementwise_max(global_norm, max_norm))
        return self._each(params_grads,
                          lambda g: layers.elementwise_mul(g, scale))


_gradient_clip = None


def set_gradient_clip(clip, param_list=None, program=None):
    """The clip every later ``minimize`` applies when its optimizer has
    no ``grad_clip`` of its own; with ``param_list``, also each listed
    parameter's own clip. Process-wide, as in the JAX package:
    ``set_gradient_clip(None)`` clears it."""
    global _gradient_clip
    _gradient_clip = clip
    if param_list:
        for p in param_list:
            p.gradient_clip_attr = clip


def append_gradient_clip_ops(params_grads):
    """The global clip, or each parameter's own clip before it (a global
    norm clip, once set, takes every gradient)."""
    clip = _gradient_clip
    per_param = any(getattr(p, "gradient_clip_attr", None) is not None
                    for p, _ in params_grads)
    if clip is None and not per_param:
        return params_grads
    if per_param and not isinstance(clip, GradientClipByGlobalNorm):
        out = []
        for p, g in params_grads:
            c = getattr(p, "gradient_clip_attr", None) or clip
            if c is None or g is None:
                out.append((p, g))
            else:
                out.extend(c._process([(p, g)]))
        return out
    return clip._process(params_grads)


__all__ = ["ErrorClipByValue", "GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm", "set_gradient_clip",
           "append_gradient_clip_ops"]
