"""Executor: run a Program op by op on torch tensors.

Counterpart of paddle_tpu/framework/executor.py + trace.py. ``run``
interprets the global block's ops in order: feeds and persistable scope
values go in, persistable outputs go back to the scope, fetches come out.
A training program (``minimize`` appended ``grad_of`` and optimizer ops)
runs the same way: each forward op that a ``grad_of`` names runs with
autograd on the inputs that op asks a gradient for, and the ``grad_of``
op computes them (framework/trace.py); every other op runs under
``torch.no_grad()``. The loop is ``run_block``, which also runs a
sub-block's ops for the op that owns it (``remat_block`` runs its segment
once in the forward and again in the backward). A var's value is dropped
after the last op that reads it, unless it is persistable or fetched.
Optimizer ops may update parameters and moments in place (the fused-Adam
kernel does). What a run derives from the program alone (the check that
every op is ported, the forward/grad pairing, each value's last reader)
is made once per program version and fetch list and reused.

Precision: f32 matmuls run in full f32 — TF32 is switched off where the
Executor is made (``torch.backends.cuda.matmul.allow_tf32 = False``) —
and bf16 matmuls sum in f32 (``set_precision``).
"""
import hashlib

import numpy as np
import torch

from ..ops.registry import NotPortedError, get_op, has_op
from . import trace
from .dtypes import to_torch_dtype
from .place import _current_expected_place
from .program import default_main_program
from .scope import global_scope, to_numpy
from .trace import EMPTY_VAR, GRAD_OP_TYPE

_SALT_VAR = "@EAGER_SALT@"


def set_precision():
    """Full-f32 math on the card: no TF32 in matmuls or convolutions, and
    bf16 matmuls sum in f32 to the end (no split-K partial sums rounded
    to bf16)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


class RunContext(object):
    """What an op kernel sees as ``ctx``: the device, the program (a
    block-running op finds its sub-block there), seeded generators for
    random ops and ``run_block`` for a sub-block's ops."""

    def __init__(self, device, program, salt):
        self.device = device
        self.program = program
        self._salt = salt
        self._op_pos = "0"

    def begin_op(self, block_idx, op_idx):
        # a global-block op keeps the key it had before sub-blocks ran
        self._op_pos = "%d" % op_idx if block_idx == 0 else \
            "%d.%d" % (block_idx, op_idx)

    def generator(self, attrs):
        """A torch.Generator on the run's device, seeded from the op's
        ``seed`` attr, else from (program.random_seed, run salt, the op's
        block and position in it): an op run again in the same run (a
        recomputed segment) draws what it drew the first time."""
        seed = attrs.get("seed", 0)
        if not seed:
            tag = "%d/%d/%s" % (self.program.random_seed, self._salt,
                                self._op_pos)
            seed = int.from_bytes(
                hashlib.sha256(tag.encode()).digest()[:8], "little") >> 1
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed))
        return g

    def run_block(self, block, env, keep=()):
        """Run a sub-block's ops on ``env`` (its inputs bound by name),
        freeing each value after its last reader unless it is an input or
        in ``keep``."""
        run_block(block, env, self,
                  drop=_last_uses(block.ops, set(env) | set(keep)))


def _check_runnable(program):
    """Refuse, before any op runs, a program holding an op the port has
    no kernel for, in any block."""
    for blk in program.blocks:
        for op in blk.ops:
            if op.type != GRAD_OP_TYPE and not has_op(op.type):
                raise NotPortedError(
                    "op %r (op_role=%r) is not ported to paddle_tpu_torch "
                    "yet; ROADMAP.md lists the slices to come"
                    % (op.type, op.attrs.get("op_role")))


def _last_uses(ops, keep):
    """{op index: [var names whose value no later op reads]}, sparing
    ``keep``."""
    last = {}
    for i, op in enumerate(ops):
        for n in op.input_names() + op.output_names():
            last[n] = i
    drop = {}
    for n, i in last.items():
        if n not in keep and n != EMPTY_VAR:
            drop.setdefault(i, []).append(n)
    return drop


def _fetch_names(fetch_list):
    return [f.name if hasattr(f, "name") else f for f in fetch_list]


class _RunPlan(object):
    """What ``run`` derives from the program alone: made once per
    (program, version, fetch names) and reused by later runs."""
    __slots__ = ("program", "persistable", "want", "last_grad", "drop")

    def __init__(self, program, fetch_names):
        _check_runnable(program)
        blk = program.global_block()
        self.program = program
        self.persistable = sorted({v.name for v in program.list_vars()
                                   if v.persistable})
        self.want, self.last_grad = trace.wanted_grads(blk)
        self.drop = _last_uses(blk.ops,
                               set(self.persistable) | set(fetch_names))


class Executor(object):
    """``Executor(place=None)``: place defaults to CUDAPlace(0) and raises
    NoCUDADeviceError without a CUDA device; pass CPUPlace() to run on the
    CPU."""

    def __init__(self, place=None):
        self.place = place if place is not None else _current_expected_place()
        self.device = self.place.torch_device()
        self._plans = {}
        set_precision()

    def _plan(self, program, fetch_names, use_program_cache):
        # the key holds the var count too: creating a var bumps no version
        key = (id(program), program._version,
               sum(len(b.vars) for b in program.blocks), tuple(fetch_names))
        plan = self._plans.get(key) if use_program_cache else None
        if plan is None or plan.program is not program:
            plan = _RunPlan(program, fetch_names)
            if use_program_cache:
                self._plans[key] = plan
        return plan

    def _convert_feed(self, program, feed):
        out = {}
        blk = program.global_block()
        for name, val in feed.items():
            var = blk._find_var_recursive(name)
            dtype = to_torch_dtype(var.dtype) if var is not None else None
            if isinstance(val, torch.Tensor):
                t = val
            else:
                t = torch.from_numpy(np.ascontiguousarray(np.asarray(val)))
            if var is not None and var.shape is not None:
                want, got = var.shape, tuple(t.shape)
                if len(want) != len(got):
                    raise ValueError(
                        "feed %r has rank %d (shape %s) but the program "
                        "declares rank %d (shape %s)"
                        % (name, len(got), got, len(want), tuple(want)))
                for w, g in zip(want, got):
                    if w not in (-1, g):
                        raise ValueError(
                            "feed %r shape %s incompatible with declared %s"
                            % (name, got, tuple(want)))
            out[name] = t.to(device=self.device, dtype=dtype)
        return out

    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name=None, fetch_var_name=None, scope=None,
            return_numpy=True, use_program_cache=True):
        program = program if program is not None else default_main_program()
        scope = scope if scope is not None else global_scope()
        fetch_names = _fetch_names(fetch_list or [])
        plan = self._plan(program, fetch_names, use_program_cache)
        env = {}
        for n in plan.persistable:
            v = scope.find_var(n)
            if v is not None:
                env[n] = v.to(self.device)
        env.update(self._convert_feed(program, dict(feed or {})))
        salt = scope.find_var(_SALT_VAR) or 0
        scope.set_var(_SALT_VAR, salt + 1)
        ctx = RunContext(self.device, program, salt)
        with torch.no_grad():
            run_block(program.global_block(), env, ctx, plan.want,
                      plan.last_grad, plan.drop)
        for n in plan.persistable:
            if n in env:
                scope.set_var(n, env[n])
        fetches = []
        for name in fetch_names:
            if name not in env:
                raise KeyError("fetch %r has no value after the run: it was "
                               "neither fed, in scope, nor produced by an op"
                               % name)
            fetches.append(env[name])
        if return_numpy:
            return [to_numpy(t) for t in fetches]
        return fetches


def run_block(block, env, ctx, want=None, last_grad=None, drop=None):
    """Run ``block``'s ops in order on ``env`` ({var name: tensor}).

    ``want``/``last_grad`` (``trace.wanted_grads``) pair each forward op
    a ``grad_of`` names with that ``grad_of``; ``drop`` ({op index: var
    names}) frees values after their last reader. Under ``no_grad`` (the
    Executor's step, a segment's forward) an output that carries an
    autograd graph is stored detached: the graph stays with its record.
    Under ``enable_grad`` (a recomputed segment) outputs keep theirs."""
    want = want or {}
    records = {}
    for i, op in enumerate(block.ops):
        ctx.begin_op(block.idx, i)
        if op.type == GRAD_OP_TYPE:
            outs = trace.run_grad_op(op, env, records, ctx,
                                     last_grad[op.attrs["fwd_id"]] == i)
        else:
            outs = _run_fwd_op(op, env, ctx, want, records)
        _bind(op, outs, env)
        for n in (drop or {}).get(i, ()):
            env.pop(n, None)


def _run_fwd_op(op, env, ctx, want, records):
    ins = {}
    for slot, names in op.inputs.items():
        vals = []
        for n in names:
            if n == EMPTY_VAR:
                continue
            if n not in env:
                raise KeyError(
                    "op {%s} needs input var %r which has no value; it "
                    "was neither fed, nor in scope, nor produced by an "
                    "earlier op" % (op.type, n))
            vals.append(env[n])
        ins[slot] = vals
    opdef = get_op(op.type)
    if op.desc_id in want and opdef.differentiable:
        outs, records[op.desc_id] = trace.run_recorded(
            opdef, ins, op.attrs, ctx, want[op.desc_id])
        return outs
    return opdef.fn(ctx, ins, op.attrs)


def _bind(op, outs, env):
    detach = not torch.is_grad_enabled()
    for slot, names in op.outputs.items():
        vals = outs.get(slot)
        if vals is None:
            continue
        if not isinstance(vals, (list, tuple)):
            vals = [vals]
        if len(vals) != len(names):
            raise RuntimeError("op {%s} slot %r produced %d values for "
                               "%d vars" % (op.type, slot, len(vals),
                                            len(names)))
        for name, val in zip(names, vals):
            if name != EMPTY_VAR:
                env[name] = val.detach() if detach and val.requires_grad \
                    else val


__all__ = ["Executor", "RunContext", "run_block", "set_precision"]
