"""Executor: run a forward Program op by op on torch tensors.

Stands in for paddle_tpu/framework/executor.py + trace.py for forward
programs (startup programs and inference programs). ``run`` interprets
the global block's ops in order under ``torch.inference_mode()``: feeds
and persistable scope values go in, persistable outputs go back to the
scope, fetches come out. A program holding ``grad_of`` or optimizer ops
raises ``NotPortedError``: training is a later slice.

Precision: f32 matmuls run in full f32 — TF32 is switched off where the
Executor is made (``torch.backends.cuda.matmul.allow_tf32 = False``).
"""
import hashlib

import numpy as np
import torch

from ..ops.registry import NotPortedError, get_op
from .dtypes import to_torch_dtype
from .place import _current_expected_place
from .program import default_main_program
from .scope import global_scope, to_numpy

EMPTY_VAR = "@EMPTY@"
GRAD_OP_TYPE = "grad_of"
_SALT_VAR = "@EAGER_SALT@"
_TRAINING_ROLES = ("backward", "optimize", "lr_sched")


def set_precision():
    """Full-f32 math on the card: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class RunContext(object):
    """What an op kernel sees as ``ctx``: the device and seeded
    generators for random ops."""

    def __init__(self, device, program, salt):
        self.device = device
        self._program = program
        self._salt = salt
        self._op_index = 0

    def begin_op(self, index):
        self._op_index = index

    def generator(self, attrs):
        """A torch.Generator on the run's device, seeded from the op's
        ``seed`` attr, else from (program.random_seed, run salt, op
        position)."""
        seed = attrs.get("seed", 0)
        if not seed:
            tag = "%d/%d/%d" % (self._program.random_seed, self._salt,
                                self._op_index)
            seed = int.from_bytes(
                hashlib.sha256(tag.encode()).digest()[:8], "little") >> 1
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed))
        return g


def _check_forward_only(program):
    for blk in program.blocks:
        for op in blk.ops:
            if op.type == GRAD_OP_TYPE or \
                    op.attrs.get("op_role") in _TRAINING_ROLES:
                raise NotPortedError(
                    "program holds %r (op_role=%r): backward and optimizer "
                    "ops arrive with the BERT training slice of "
                    "paddle_tpu_torch; this Executor runs forward programs "
                    "only" % (op.type, op.attrs.get("op_role")))


def _fetch_names(fetch_list):
    return [f.name if hasattr(f, "name") else f for f in fetch_list]


class Executor(object):
    """``Executor(place=None)``: place defaults to CUDAPlace(0) and raises
    NoCUDADeviceError without a CUDA device; pass CPUPlace() to run on the
    CPU."""

    def __init__(self, place=None):
        self.place = place if place is not None else _current_expected_place()
        self.device = self.place.torch_device()
        set_precision()

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
        _check_forward_only(program)
        blk = program.global_block()
        persistable = sorted({v.name for b in program.blocks
                              for v in b.vars.values() if v.persistable})
        env = {}
        for n in persistable:
            v = scope.find_var(n)
            if v is not None:
                env[n] = v.to(self.device)
        env.update(self._convert_feed(program, dict(feed or {})))
        salt = scope.find_var(_SALT_VAR) or 0
        scope.set_var(_SALT_VAR, salt + 1)
        ctx = RunContext(self.device, program, salt)
        with torch.inference_mode():
            for i, op in enumerate(blk.ops):
                ctx.begin_op(i)
                self._run_op(op, env, ctx)
        for n in persistable:
            if n in env:
                scope.set_var(n, env[n])
        fetches = []
        for name in _fetch_names(fetch_list or []):
            if name not in env:
                raise KeyError("fetch %r has no value after the run: it was "
                               "neither fed, in scope, nor produced by an op"
                               % name)
            fetches.append(env[name])
        if return_numpy:
            return [to_numpy(t) for t in fetches]
        return fetches

    @staticmethod
    def _run_op(op, env, ctx):
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
        outs = get_op(op.type).fn(ctx, ins, op.attrs)
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
                    env[name] = val


__all__ = ["Executor", "RunContext", "set_precision"]
