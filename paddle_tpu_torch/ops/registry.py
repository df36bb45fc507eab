"""Operator registry: op type -> torch kernel.

Counterpart of paddle_tpu/ops/registry.py, with the same kernel contract::

    fn(ctx, ins, attrs) -> {out_slot: tensor or [tensor, ...]}

  - ``ins``: dict slot -> list of torch tensors (slot order = OpDesc order)
  - ``attrs``: the op's JSON-able attrs
  - ``ctx``: the executor's run context — ``ctx.device`` (torch.device)
    and ``ctx.generator(attrs)`` (a seeded torch.Generator for random ops)

``OpDef.nondiff`` names input slots that never get a gradient (the
backward and the Executor's grad pairing read it); ``differentiable=False``
ops get no ``grad_of`` at all. ``syncs_host=True`` marks an op that reads
a device value on the host (``cond``'s predicate, ``while_loop``'s,
``print``'s tensor): the Executor never captures a step that holds one
into a CUDA graph and runs it op by op (framework/executor.py).
``inplace`` names input slots the op may overwrite in place (the
fused-Adam kernel writes Param, Moment1 and Moment2 on the card); the
Executor keeps a copy of such an input for a gradient that still needs
its old value (``trace.overwritten_inputs``).
"""

import os

_REGISTRY = {}

# PADDLE_TPU_OP_COVERAGE=<path>: append the type of every op kernel that
# runs to <path>, once a type (tools/op_coverage.py reads it); nothing
# is wrapped when unset
_COVERAGE_PATH = os.environ.get("PADDLE_TPU_OP_COVERAGE")
_COVERAGE_SEEN = set()


def _track(op_type):
    if op_type not in _COVERAGE_SEEN:
        _COVERAGE_SEEN.add(op_type)
        with open(_COVERAGE_PATH, "a") as f:
            f.write(op_type + "\n")


class NotPortedError(NotImplementedError):
    """A path that exists in paddle_tpu but belongs to a later slice of the
    port; the message names the slice."""


class OpDef(object):
    __slots__ = ("type", "fn", "nondiff", "uses_rng", "differentiable",
                 "syncs_host", "inplace")

    def __init__(self, type, fn, nondiff=(), uses_rng=False,
                 differentiable=True, syncs_host=False, inplace=()):
        self.type = type
        self.fn = fn
        self.nondiff = tuple(nondiff)
        self.uses_rng = uses_rng
        self.differentiable = differentiable
        self.syncs_host = syncs_host
        self.inplace = tuple(inplace)


def register_op(type, nondiff=(), uses_rng=False, differentiable=True,
                syncs_host=False, inplace=()):
    def deco(fn):
        if type in _REGISTRY:
            raise ValueError("op %r already registered" % type)
        if _COVERAGE_PATH:
            import functools
            inner = fn

            @functools.wraps(inner)
            def fn(*a, **kw):
                _track(type)
                return inner(*a, **kw)
        _REGISTRY[type] = OpDef(type, fn, nondiff, uses_rng, differentiable,
                                syncs_host, inplace)
        return fn
    return deco


def get_op(type):
    op = _REGISTRY.get(type)
    if op is None:
        raise NotImplementedError(
            "op %r has no registered torch kernel in paddle_tpu_torch" % type)
    return op


def has_op(type):
    return type in _REGISTRY


def registered_ops():
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# static shape/dtype rules (framework/analysis.py's shape pass), as in
# paddle_tpu/ops/registry.py: a rule is the kernel's static twin,
# fn(op, ins, attrs) -> {out_slot: [TensorMeta, ...]} over abstract
# (shape, dtype) metadata, raising ops.shape_rules.ShapeError on a
# violation. An op without a rule infers unknown and never produces a
# diagnostic.
# ---------------------------------------------------------------------------

_SHAPE_RULES = {}


def register_shape_rule(*types):
    def deco(fn):
        for t in types:
            if t in _SHAPE_RULES:
                raise ValueError("shape rule for %r already registered" % t)
            _SHAPE_RULES[t] = fn
        return fn
    return deco


def get_shape_rule(type):
    """The op's static shape/dtype rule, or None (infer unknown)."""
    from . import shape_rules  # noqa: F401  (registers the rule set)
    return _SHAPE_RULES.get(type)
