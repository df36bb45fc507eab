"""Scope: persistent name -> torch tensor storage.

Counterpart of paddle_tpu/framework/scope.py. Parameters live here between
Executor.run calls as tensors on the device of the Executor that wrote
them.
"""
import contextlib

import torch


def to_numpy(t):
    """Host copy of a tensor; bfloat16 (which numpy lacks) comes back as
    float32."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class Scope(object):
    def __init__(self):
        self._vars = {}

    def var(self, name):
        """Create-or-get slot (fluid Scope::Var)."""
        return self._vars.setdefault(name, None)

    def find_var(self, name):
        return self._vars.get(name, None)

    def has_var(self, name):
        return name in self._vars

    def set_var(self, name, value):
        self._vars[name] = value

    def erase(self, name):
        self._vars.pop(name, None)

    def keys(self):
        return self._vars.keys()

    def items(self):
        return self._vars.items()


_global_scope = Scope()


def global_scope():
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope):
    global _global_scope
    old = _global_scope
    _global_scope = scope
    try:
        yield
    finally:
        _global_scope = old
