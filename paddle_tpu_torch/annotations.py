"""fluid.annotations parity (counterpart of paddle_tpu/annotations.py;
ref python/paddle/fluid/annotations.py)."""
import functools
import sys
import warnings

__all__ = ["deprecated"]


def deprecated(since, instead, extra_message=""):
    def decorator(func):
        err_msg = "API {0} is deprecated since {1}. Please use {2} " \
            "instead.".format(func.__name__, since, instead)
        if extra_message:
            err_msg += "\n" + extra_message

        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            warnings.warn(err_msg, DeprecationWarning, stacklevel=2)
            print(err_msg, file=sys.stderr)
            return func(*args, **kwargs)
        return wrapper
    return decorator
