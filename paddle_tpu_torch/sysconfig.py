"""paddle.sysconfig (counterpart of paddle_tpu/sysconfig.py; ref
python/paddle/sysconfig.py)."""
import os

__all__ = ["get_include", "get_lib"]


def get_include():
    """The directory of the port's native sources (the C++ data plane,
    ``native/``); the reference points at its C++ headers."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "native")


def get_lib():
    """The directory the native data plane's library is built into (its
    build cache under the checkout's ``build/``), not the source tree."""
    from .native.build import library_path
    return os.path.dirname(library_path())
