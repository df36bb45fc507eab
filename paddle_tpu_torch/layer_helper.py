"""LayerHelper — shared machinery for layer functions.

Counterpart of paddle_tpu/layer_helper.py. Creates parameters in the
startup and main programs, temp variables, ops, biases and activations
with the same names and attrs as the JAX package. In dygraph mode
(paddle_tpu's :36-60, :144-147) a temp variable is an eager placeholder
and ``append_op`` runs the op at once on the eager values its input
names resolve to, binding the results onto the placeholders its outputs
name; a static layer that creates parameters (``fc``, ``conv2d``) finds
no eager value for them and raises ``KeyError`` (use the dygraph.nn
modules), as in the JAX package.
"""
import copy

from .framework import unique_name
from .framework.program import (default_main_program,
                                default_startup_program)
from .initializer import ConstantInitializer, XavierInitializer
from .param_attr import ParamAttr


class LayerHelper(object):
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        if self.kwargs.get("name", None) is None:
            self.kwargs["name"] = unique_name.generate(layer_type)

    @property
    def name(self):
        return self.kwargs["name"]

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    def append_op(self, *args, **kwargs):
        from .dygraph import base as _dy
        if _dy.enabled():
            return self._append_op_eager(*args, **kwargs)
        return self.main_program.current_block().append_op(*args, **kwargs)

    def _append_op_eager(self, type, inputs=None, outputs=None, attrs=None,
                         **_ignored):
        """Dygraph branch (reference layer_helper_base.py in_dygraph_mode):
        resolve input names to eager values, run the kernel now, bind the
        results onto the placeholder variables the layer already created."""
        from .dygraph import base as _dy
        from .dygraph.nn import run_op

        def _names(v):
            return [v] if not isinstance(v, (list, tuple)) else list(v)

        ins = {slot: [_dy.lookup_eager(getattr(n, "name", n))
                      for n in _names(names)]
               for slot, names in (inputs or {}).items()}
        binding = {slot: [_dy.lookup_eager(getattr(n, "name", n))
                          for n in _names(names)]
                   for slot, names in (outputs or {}).items()}
        return run_op(type, ins, attrs or {}, out_binding=binding)

    # ---- inputs ----------------------------------------------------------
    def multiple_input(self, input_param_name="input"):
        inputs = self.kwargs.get(input_param_name, [])
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        return list(inputs)

    @property
    def param_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("param_attr", None))

    @property
    def bias_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("bias_attr", None))

    def multiple_param_attr(self, length):
        param_attr = self.param_attr
        if isinstance(param_attr, ParamAttr):
            param_attr = [param_attr]
        if len(param_attr) != 1 and len(param_attr) != length:
            raise ValueError("parameter number mismatch")
        if len(param_attr) == 1 and length != 1:
            param_attr = [copy.deepcopy(param_attr[0]) for _ in range(length)]
        return param_attr

    def iter_inputs_and_params(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        return zip(inputs, self.multiple_param_attr(len(inputs)))

    def input_dtype(self, input_param_name="input"):
        dtype = None
        for each in self.multiple_input(input_param_name):
            if dtype is None:
                dtype = each.dtype
            elif dtype != each.dtype:
                raise ValueError("layer inputs have mixed dtypes: %s vs %s"
                                 % (dtype, each.dtype))
        return dtype

    # ---- parameter / var creation ---------------------------------------
    def create_parameter(self, attr, shape, dtype=None, is_bias=False,
                         default_initializer=None, stop_gradient=False):
        if attr is False:
            return None
        attr = attr if isinstance(attr, ParamAttr) else ParamAttr._to_attr(attr)
        if attr is False:
            return None
        if attr.name is None:
            attr.name = unique_name.generate(".".join(
                [self.name, "b_0" if is_bias else "w_0"]))
        init = attr.initializer or default_initializer
        if init is None:
            init = ConstantInitializer(0.0) if is_bias else XavierInitializer()
        dtype = dtype or self.kwargs.get("dtype", "float32")
        shape = [int(s) for s in shape]
        kwargs = attr._to_kwargs()
        kwargs.pop("name", None)
        param = self.main_program.global_block().create_parameter(
            name=attr.name, shape=shape, dtype=dtype, **kwargs)
        startup_block = self.startup_program.global_block()
        sparam = startup_block.create_parameter(
            name=attr.name, shape=shape, dtype=dtype, **kwargs)
        init(sparam, startup_block)
        return param

    def create_variable_for_type_inference(self, dtype, shape=None,
                                           stop_gradient=False):
        from .dygraph import base as _dy
        if _dy.enabled():
            return _dy.EagerVariable(None, stop_gradient=stop_gradient)
        return self.main_program.current_block().create_var(
            name=unique_name.generate(".".join([self.name, "tmp"])),
            dtype=dtype, shape=shape, persistable=False,
            stop_gradient=stop_gradient)

    def create_variable(self, *args, **kwargs):
        return self.main_program.current_block().create_var(*args, **kwargs)

    def create_global_variable(self, persistable=False, *args, **kwargs):
        return self.main_program.global_block().create_var(
            *args, persistable=persistable, stop_gradient=True, **kwargs)

    def create_or_get_global_variable(self, name, *args, **kwargs):
        blk = self.main_program.global_block()
        if blk.has_var(name):
            return blk.var(name)
        return self.create_global_variable(name=name, *args, **kwargs)

    def set_variable_initializer(self, var, initializer):
        sblock = self.startup_program.global_block()
        svar = sblock.create_var(name=var.name, shape=var.shape,
                                 dtype=var.dtype, persistable=True)
        initializer(svar, sblock)

    # ---- bias / activation ----------------------------------------------
    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        bias_attr = self.bias_attr
        if bias_attr is False or bias_attr is None and \
                self.kwargs.get("bias_attr") is False:
            return input_var
        size = list(input_var.shape[dim_start:dim_end])
        b = self.create_parameter(bias_attr, shape=size,
                                  dtype=input_var.dtype, is_bias=True)
        if b is None:
            return input_var
        tmp = self.create_variable_for_type_inference(input_var.dtype,
                                                      input_var.shape)
        self.append_op(
            "elementwise_add",
            inputs={"X": [input_var.name], "Y": [b.name]},
            outputs={"Out": [tmp.name]},
            attrs={"axis": dim_start})
        return tmp

    def append_activation(self, input_var):
        act = self.kwargs.get("act", None)
        if act is None:
            return input_var
        act = {"type": act} if isinstance(act, str) else dict(act)
        act_type = act.pop("type")
        tmp = self.create_variable_for_type_inference(input_var.dtype,
                                                      input_var.shape)
        self.append_op(act_type, inputs={"X": [input_var.name]},
                       outputs={"Out": [tmp.name]}, attrs=act)
        return tmp
