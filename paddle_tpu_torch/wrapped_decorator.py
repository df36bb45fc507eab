"""fluid.wrapped_decorator (counterpart of paddle_tpu/
wrapped_decorator.py; ref python/paddle/fluid/wrapped_decorator.py),
standard library only: functools.wraps keeps the signature."""
import contextlib
import functools

__all__ = ["wrap_decorator", "signature_safe_contextmanager"]


def wrap_decorator(decorator_func):
    @functools.wraps(decorator_func)
    def __impl__(func):
        wrapped = decorator_func(func)
        return functools.wraps(func)(wrapped)
    return __impl__


signature_safe_contextmanager = wrap_decorator(contextlib.contextmanager)
