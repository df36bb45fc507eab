"""Reference deep-module-path compatibility (counterpart of
paddle_tpu/_compat_submodules.py).

Several reference subsystems are PACKAGES of many small modules
(`contrib/mixed_precision/{fp16_lists,decorator,fp16_utils}.py`) whose
capability this framework implements in one flat module
(`contrib/mixed_precision.py`). Scripts importing the deep paths (`from
paddle.fluid.contrib.mixed_precision.decorator import decorate`) still
port by renaming the root package: each reference child path is
registered here as a VIRTUAL module re-exporting the flat
implementation's objects — one instance of the code, two import
spellings. Only the paths whose target the port has are registered; the
slim, quantize and parameter-server paths come with those slices
(ROADMAP.md, Queue 1 items 5.4 and 9).
"""
import importlib
import importlib.machinery
import sys
import types


def _virtual(fullname, doc, exports):
    parent_name, _, child = fullname.rpartition(".")
    parent = importlib.import_module(parent_name)
    if not hasattr(parent, "__path__"):
        # a flat module gaining virtual children must look like a
        # package, or `import parent.child` refuses before consulting
        # sys.modules/meta_path ("'parent' is not a package")
        parent.__path__ = []
    mod = types.ModuleType(fullname, doc)
    for k, v in exports.items():
        setattr(mod, k, v)
    mod.__all__ = sorted(exports)
    mod.__spec__ = importlib.machinery.ModuleSpec(fullname, None)
    sys.modules[fullname] = mod
    setattr(parent, child, mod)
    return mod


def install():
    from .contrib import mixed_precision as _mp
    from .contrib import reader as _crdr
    from .contrib import extend_optimizer as _eo

    V = _virtual
    V("paddle_tpu_torch.contrib.extend_optimizer."
      "extend_optimizer_with_weight_decay",
      "ref contrib/extend_optimizer/extend_optimizer_with_weight_decay"
      ".py — AdamW-style decoupled decay is optimizer.AdamW",
      {"GradientMergeOptimizer": _eo.GradientMergeOptimizer})
    V("paddle_tpu_torch.contrib.mixed_precision.fp16_lists",
      "ref contrib/mixed_precision/fp16_lists.py",
      {"AutoMixedPrecisionLists": _mp.AutoMixedPrecisionLists})
    V("paddle_tpu_torch.contrib.mixed_precision.decorator",
      "ref contrib/mixed_precision/decorator.py",
      {"decorate": _mp.decorate,
       "OptimizerWithMixedPrecision": _mp.OptimizerWithMixedPrecision})
    V("paddle_tpu_torch.contrib.mixed_precision.fp16_utils",
      "ref contrib/mixed_precision/fp16_utils.py — cast plumbing is "
      "internal to mixed_precision.py",
      {"AutoMixedPrecisionLists": _mp.AutoMixedPrecisionLists})
    V("paddle_tpu_torch.contrib.reader.distributed_reader",
      "ref contrib/reader/distributed_reader.py",
      {"distributed_batch_reader": _crdr.distributed_batch_reader})
