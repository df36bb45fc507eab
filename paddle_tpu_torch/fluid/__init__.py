"""``paddle.fluid`` alias package (counterpart of paddle_tpu/fluid).

Reference scripts spell ``import paddle.fluid as fluid`` and
``fluid.CompiledProgram(...)``; the port's modules live at
``paddle_tpu_torch.X``. Attribute access on ``paddle_tpu_torch.fluid``
reads the top-level package, and every ``paddle_tpu_torch.fluid.X``
resolves to a proxy module whose attribute access reads the already
imported ``paddle_tpu_torch.X``: one copy of all module state, and a
ported fluid script rewrites only the root package name.
"""
import importlib
import importlib.abc
import importlib.util
import sys
import types

import paddle_tpu_torch as _ptt

_PREFIX = __name__ + "."


def __getattr__(name):
    return getattr(_ptt, name)


def __dir__():
    return sorted(set(dir(_ptt)) | set(globals()))


def _is_importable(name):
    if name in sys.modules:
        return True
    try:
        return importlib.util.find_spec(name) is not None
    except (ImportError, ValueError):
        return False


class _AliasLoader(importlib.abc.Loader):
    def __init__(self, real_name):
        self._real_name = real_name

    def create_module(self, spec):
        real = importlib.import_module(self._real_name)
        proxy = types.ModuleType(spec.name, real.__doc__)
        proxy.__getattr__ = lambda name, _r=real: getattr(_r, name)
        proxy.__dir__ = lambda _r=real: dir(_r)
        return proxy

    def exec_module(self, module):
        pass


class _AliasFinder(importlib.abc.MetaPathFinder):
    def find_spec(self, fullname, path=None, target=None):
        if not fullname.startswith(_PREFIX):
            return None
        real = "paddle_tpu_torch." + fullname[len(_PREFIX):]
        if not _is_importable(real):
            return None
        spec = importlib.util.spec_from_loader(fullname,
                                               _AliasLoader(real))
        # package-like with an empty search path: descendants come back
        # through this finder, never double-loading the real files
        spec.submodule_search_locations = []
        return spec


if not any(isinstance(f, _AliasFinder) for f in sys.meta_path):
    sys.meta_path.insert(0, _AliasFinder())
