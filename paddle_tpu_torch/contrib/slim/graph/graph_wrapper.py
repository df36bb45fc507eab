"""GraphWrapper (counterpart of paddle_tpu/contrib/slim/graph/
graph_wrapper.py; reference contrib/slim/graph/graph_wrapper.py): the
slim passes inspect a Program through these wrappers."""
import numpy as np

from ....framework.program import Parameter, default_main_program

__all__ = ["GraphWrapper", "VarWrapper", "OpWrapper"]


class VarWrapper(object):
    def __init__(self, var, graph):
        self._var = var
        self._graph = graph

    def name(self):
        return self._var.name

    def shape(self):
        return self._var.shape

    def is_parameter(self):
        return isinstance(self._var, Parameter)

    def inputs(self):
        """The ops that write this var."""
        return [op for op in self._graph.ops()
                if self.name() in op._op.output_names()]

    def outputs(self):
        """The ops that read this var."""
        return [op for op in self._graph.ops()
                if self.name() in op._op.input_names()]


class OpWrapper(object):
    def __init__(self, op, graph):
        self._op = op
        self._graph = graph

    def type(self):
        return self._op.type

    def attr(self, name):
        return self._op.attr(name)

    def all_inputs(self):
        return [self._graph.var(n) for n in self._op.input_names()
                if self._graph.has_var(n)]

    def all_outputs(self):
        return [self._graph.var(n) for n in self._op.output_names()
                if self._graph.has_var(n)]


class GraphWrapper(object):
    def __init__(self, program=None, in_nodes=None, out_nodes=None):
        self.program = program or default_main_program()
        self.in_nodes = dict(in_nodes or {})
        self.out_nodes = dict(out_nodes or {})

    def has_var(self, name):
        return self.program.global_block()._find_var_recursive(name) \
            is not None

    def var(self, name):
        v = self.program.global_block()._find_var_recursive(name)
        if v is None:
            raise ValueError("variable %r not in graph" % name)
        return VarWrapper(v, self)

    def vars(self):
        return [VarWrapper(v, self) for v in self.program.list_vars()]

    def all_parameters(self):
        return [v for v in self.vars() if v.is_parameter()]

    def ops(self):
        """The ops of every block (a control-flow sub-block's too)."""
        return [OpWrapper(op, self)
                for blk in self.program.blocks for op in blk.ops]

    def numel_params(self):
        total = 0
        for p in self.all_parameters():
            shape = [d for d in (p.shape() or ()) if d not in (None, -1)]
            total += int(np.prod(shape)) if shape else 1
        return total
