"""Static-graph IR: Program / Block / Operator / Variable / Parameter.

Counterpart of paddle_tpu/framework/program.py. The IR is pure Python and
its JSON form (``to_dict``/``from_dict``) is the same as the JAX
package's, key for key, so a model directory written by either package
loads in the other. Ops carry a stable ``desc_id``: a ``grad_of`` op names
its forward op by it (framework/backward.py, framework/trace.py).
"""
import contextlib
import copy
import itertools
import json

import numpy as np

from . import unique_name
from .dtypes import normalize_dtype

_desc_id_counter = itertools.count()

PROGRAM_FORMAT = "paddle_tpu.program.v1"

GRAD_VAR_SUFFIX = "@GRAD"


def grad_var_name(name):
    return name + GRAD_VAR_SUFFIX


class Variable(object):
    """A symbolic tensor in a Block (fluid VarDesc)."""

    def __init__(self, block, name=None, shape=None, dtype="float32",
                 persistable=False, stop_gradient=False, lod_level=0,
                 is_data=False, initializer=None, **kwargs):
        self.block = block
        if name is None:
            name = unique_name.generate("_generated_var")
        self.name = name
        self.shape = tuple(int(s) for s in shape) if shape is not None else None
        self.dtype = normalize_dtype(dtype) if dtype is not None else None
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.lod_level = lod_level
        self.is_data = is_data
        # sharding spec kept as metadata so the JSON round-trips unchanged
        self.sharding = kwargs.get("sharding", None)

    @property
    def is_parameter(self):
        return isinstance(self, Parameter)

    def astype(self, dtype):
        from ..layers import tensor as _tensor_layers
        return _tensor_layers.cast(self, dtype)

    def to_dict(self):
        d = {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": self.dtype,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "lod_level": self.lod_level,
            "is_data": self.is_data,
            "sharding": list(self.sharding) if self.sharding else None,
        }
        if self.is_parameter:
            d["is_parameter"] = True
            d["trainable"] = self.trainable
        return d

    def __repr__(self):
        return "Variable(%s, shape=%s, dtype=%s%s)" % (
            self.name, self.shape, self.dtype,
            ", persistable" if self.persistable else "")

    __str__ = __repr__


class Parameter(Variable):
    """A trainable, persistable Variable (fluid Parameter)."""

    def __init__(self, block, shape, dtype, **kwargs):
        if shape is None or any(s <= 0 for s in shape):
            raise ValueError("parameter shape must be static and positive, "
                             "got %s" % (shape,))
        kwargs.setdefault("persistable", True)
        super(Parameter, self).__init__(block, shape=shape, dtype=dtype,
                                        **kwargs)
        self.trainable = kwargs.get("trainable", True)
        self.regularizer = kwargs.get("regularizer", None)
        self.gradient_clip_attr = kwargs.get("gradient_clip_attr", None)
        self.do_model_average = kwargs.get("do_model_average", None)
        self.optimize_attr = kwargs.get("optimize_attr", {"learning_rate": 1.0})


class Operator(object):
    """One op in a Block: slot -> [var names] maps plus JSON-able attrs."""

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None,
                 desc_id=None):
        self.block = block
        self.type = type
        self.inputs = {k: list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})
        self.desc_id = desc_id if desc_id is not None else next(_desc_id_counter)

    def input_names(self):
        return [n for vs in self.inputs.values() for n in vs]

    def output_names(self):
        return [n for vs in self.outputs.values() for n in vs]

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def to_dict(self):
        return {"type": self.type, "inputs": self.inputs,
                "outputs": self.outputs, "attrs": _json_safe(self.attrs),
                "desc_id": self.desc_id}

    def __repr__(self):
        return "Operator(%s, in=%s, out=%s)" % (
            self.type, self.inputs, self.outputs)


def _json_safe(obj):
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return {"__ndarray__": obj.tolist(), "dtype": str(obj.dtype)}
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    return obj


def _json_restore(obj):
    if isinstance(obj, dict):
        if "__ndarray__" in obj:
            return np.array(obj["__ndarray__"], dtype=obj["dtype"])
        return {k: _json_restore(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_json_restore(v) for v in obj]
    return obj


class Block(object):
    """An ordered list of ops plus a symbol table of vars."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = {}
        self.ops = []

    @property
    def parent_block(self):
        if self.parent_idx < 0:
            return None
        return self.program.blocks[self.parent_idx]

    def create_var(self, **kwargs):
        name = kwargs.get("name")
        if name is not None and name in self.vars:
            return self.vars[name]
        var = Variable(self, **kwargs)
        self.vars[var.name] = var
        return var

    def create_parameter(self, **kwargs):
        param = Parameter(self, kwargs.pop("shape"), kwargs.pop("dtype"),
                          **kwargs)
        self.vars[param.name] = param
        return param

    def var(self, name):
        v = self.vars.get(name)
        if v is None:
            raise ValueError("var %r is not in block %d" % (name, self.idx))
        return v

    def _find_var_recursive(self, name):
        blk = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = blk.parent_block
        return None

    def has_var(self, name):
        return name in self.vars

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        self.program._version += 1
        return op

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def to_dict(self):
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "vars": [v.to_dict() for v in self.vars.values()],
            "ops": [op.to_dict() for op in self.ops],
        }


class Program(object):
    """A whole computation: list of Blocks, block 0 is global; a
    sub-block (``recompute_segment``'s) holds ops an op of its parent
    runs."""

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self._version = 0
        self.random_seed = 0

    def global_block(self):
        return self.blocks[0]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def _create_block(self, parent_idx=None):
        """A new sub-block (child of the current block unless
        ``parent_idx`` is given), made current until ``_rollback``."""
        parent_idx = (self.current_block_idx
                      if parent_idx is None else parent_idx)
        blk = Block(self, len(self.blocks), parent_idx)
        self.blocks.append(blk)
        self.current_block_idx = blk.idx
        self._version += 1
        return blk

    def _rollback(self):
        self.current_block_idx = self.current_block().parent_idx

    def block(self, idx):
        return self.blocks[idx]

    @property
    def num_blocks(self):
        return len(self.blocks)

    def all_parameters(self):
        return [p for blk in self.blocks for p in blk.all_parameters()]

    def list_vars(self):
        for blk in self.blocks:
            for v in blk.vars.values():
                yield v

    def __str__(self):
        lines = []
        for blk in self.blocks:
            lines.append("-- block %d (parent %d) --"
                         % (blk.idx, blk.parent_idx))
            lines.extend("  " + repr(v) for v in blk.vars.values())
            lines.extend("  {%s} %s -> %s  attrs=%s"
                         % (op.type, op.inputs, op.outputs, op.attrs)
                         for op in blk.ops)
        return "\n".join(lines)

    def _empty_like(self):
        p = Program.__new__(Program)
        p.blocks = []
        p.current_block_idx = 0
        p._version = 0
        p.random_seed = self.random_seed
        return p

    def clone(self, for_test=False):
        """Deep copy. ``for_test=True`` drops backward/optimize/lr_sched
        ops and sets every ``is_test`` attr (fluid Program.clone)."""
        p = self._empty_like()
        for blk in self.blocks:
            nb = Block(p, blk.idx, blk.parent_idx)
            for v in blk.vars.values():
                nv = copy.copy(v)
                nv.block = nb
                nb.vars[nv.name] = nv
            for op in blk.ops:
                if for_test and op.attrs.get("op_role") in (
                        "backward", "optimize", "lr_sched"):
                    continue
                nop = Operator(nb, op.type, op.inputs, op.outputs,
                               copy.deepcopy(op.attrs), desc_id=op.desc_id)
                if for_test and "is_test" in nop.attrs:
                    nop.attrs["is_test"] = True
                nb.ops.append(nop)
            p.blocks.append(nb)
        return p

    def _prune(self, feeded_var_names, target_var_names):
        """A clone keeping only the ops needed to compute the targets from
        the feeds (fluid Program._prune_with_input)."""
        pruned = self.clone()
        blk = pruned.global_block()
        needed = set(target_var_names)
        kept = []
        for op in reversed(blk.ops):
            if any(o in needed for o in op.output_names()):
                kept.append(op)
                needed.update(i for i in op.input_names()
                              if i not in feeded_var_names)
        kept.reverse()
        blk.ops = kept
        used = set(feeded_var_names) | set(target_var_names)
        for op in kept:
            used.update(op.input_names())
            used.update(op.output_names())
        blk.vars = {n: v for n, v in blk.vars.items() if n in used}
        pruned._version += 1
        return pruned

    def to_dict(self):
        return {"format": PROGRAM_FORMAT,
                "random_seed": self.random_seed,
                "blocks": [b.to_dict() for b in self.blocks]}

    def to_json(self):
        return json.dumps(self.to_dict())

    @staticmethod
    def from_dict(d):
        if d.get("format") != PROGRAM_FORMAT:
            raise ValueError("not a paddle_tpu program: %r" % d.get("format"))
        p = Program.__new__(Program)
        p.blocks = []
        p.current_block_idx = 0
        p._version = 0
        p.random_seed = d.get("random_seed", 0)
        for bd in d["blocks"]:
            blk = Block(p, bd["idx"], bd["parent_idx"])
            for vd in bd["vars"]:
                vd = dict(vd)
                is_param = vd.pop("is_parameter", False)
                trainable = vd.pop("trainable", True)
                shape = vd.pop("shape")
                dtype = vd.pop("dtype")
                name = vd.pop("name")
                sharding = vd.pop("sharding", None)
                if is_param:
                    v = Parameter(blk, shape, dtype, name=name,
                                  trainable=trainable, **vd)
                else:
                    v = Variable(blk, name=name, shape=shape, dtype=dtype,
                                 **vd)
                v.sharding = tuple(sharding) if sharding else None
                blk.vars[v.name] = v
            for od in bd["ops"]:
                blk.ops.append(Operator(blk, od["type"], od["inputs"],
                                        od["outputs"],
                                        _json_restore(od["attrs"]),
                                        desc_id=od.get("desc_id")))
            p.blocks.append(blk)
        return p

    @staticmethod
    def from_json(s):
        return Program.from_dict(json.loads(s))


_main_program_ = Program()
_startup_program_ = Program()


def default_startup_program():
    return _startup_program_


def default_main_program():
    return _main_program_


def switch_main_program(program):
    global _main_program_
    old = _main_program_
    _main_program_ = program
    return old


def switch_startup_program(program):
    global _startup_program_
    old = _startup_program_
    _startup_program_ = program
    return old


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)
