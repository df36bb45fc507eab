"""fluid.default_scope_funcs parity (counterpart of
paddle_tpu/default_scope_funcs.py; ref
python/paddle/fluid/default_scope_funcs.py): thread-local stack of local
scopes over the global one."""
import threading

from .framework.scope import Scope, global_scope

__all__ = ["get_cur_scope", "enter_local_scope", "leave_local_scope",
           "var", "find_var", "scoped_function"]

_local = threading.local()


def _stack():
    if not hasattr(_local, "stack"):
        _local.stack = [global_scope()]
    return _local.stack


def get_cur_scope():
    return _stack()[-1]


def enter_local_scope():
    _stack().append(Scope())


def leave_local_scope():
    if len(_stack()) > 1:
        _stack().pop()


def var(name):
    return get_cur_scope().var(name)


def find_var(name):
    return get_cur_scope().find_var(name)


def scoped_function(func):
    enter_local_scope()
    try:
        func()
    finally:
        leave_local_scope()
