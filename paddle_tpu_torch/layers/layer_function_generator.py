"""Layer-function codegen utilities (counterpart of
paddle_tpu/layers/layer_function_generator.py; ref
python/paddle/fluid/layers/layer_function_generator.py).

The reference generates Python layer functions from C++ OpProto
metadata; here the registry (ops/registry.py) plays the proto role:
``generate_layer_fn(op_type)`` returns a layer that appends the op with
single X->Out slots (the shape the generated fluid layers take), and
``generate_activation_fn`` is its activation specialization.  The doc
decorators are kept as identity-with-annotation shims so fluid code
importing them keeps working.
"""
import functools
import warnings

from ..layer_helper import LayerHelper

__all__ = ["generate_layer_fn", "generate_activation_fn", "deprecated",
           "autodoc", "templatedoc"]


def generate_layer_fn(op_type):
    """Build a layers-style function for a registered elementwise-shaped
    op (ref :133): fn(x, name=None, **attrs) -> out var."""
    from ..ops.registry import get_op
    get_op(op_type)  # fail fast on unknown ops

    def layer_fn(x, name=None, **attrs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype, x.shape)
        helper.append_op(op_type, inputs={"X": [x.name]},
                         outputs={"Out": [out.name]}, attrs=attrs)
        return out

    layer_fn.__name__ = op_type
    layer_fn.__doc__ = "Auto-generated layer for the %r op." % op_type
    return layer_fn


def generate_activation_fn(op_type):
    """Activation specialization of generate_layer_fn (ref :242)."""
    return generate_layer_fn(op_type)


def deprecated(func_or_class):
    """Mark an API deprecated (ref :299): warns once per call site."""

    @functools.wraps(func_or_class)
    def wrapper(*args, **kwargs):
        warnings.warn(
            "API %r is deprecated" % func_or_class.__name__,
            DeprecationWarning, stacklevel=2)
        return func_or_class(*args, **kwargs)

    return wrapper


def autodoc(comment=""):
    """Docstring annotator (ref :321)."""

    def decorator(func):
        func.__doc__ = comment + (func.__doc__ or "")
        return func

    return decorator


def templatedoc(op_type=None):
    """Template-docstring annotator (ref :330) — the proto comments the
    reference substitutes do not exist here, so placeholders are left
    in place."""

    def decorator(func):
        return func

    return decorator
