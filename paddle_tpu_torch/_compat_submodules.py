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
spellings. A path whose capability the port does not have (the MKL-DNN
quantization passes) is registered with a module whose every attribute
raises NotImplementedError with guidance, as are the ``pslib`` children
of the parameter-server path (the port has no pserver binary). The
``parameter_server.distribute_transpiler`` path comes with the collective
fleet of the torch.distributed slice (ROADMAP.md, Queue 1 item 7).
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


def _guided(fullname, doc, guidance):
    mod = _virtual(fullname, doc, {})

    def _getattr(name, _g=guidance):
        if name.startswith("__"):     # import-machinery dunder probes
            raise AttributeError(name)
        raise NotImplementedError(_g)

    mod.__getattr__ = _getattr
    return mod


def install():
    from .contrib.slim import prune as _prune
    from .contrib.slim import core as _score
    from .contrib.slim import distill as _distill
    from .contrib.slim import qat as _qat
    from .contrib.slim import distillation as _  # noqa: F401,F811
    from .contrib.slim import quantization as _  # noqa: F401,F811
    from .contrib import mixed_precision as _mp
    from .contrib import quantize as _cq
    from .contrib import reader as _crdr
    from .contrib import extend_optimizer as _eo

    V = _virtual
    V("paddle_tpu_torch.contrib.slim.prune.pruner",
      "ref slim/prune/pruner.py — pruners live in slim/prune.py",
      {"Pruner": _prune.Pruner, "MagnitudePruner": _prune.MagnitudePruner,
       "StructurePruner": _prune.StructurePruner})
    V("paddle_tpu_torch.contrib.slim.prune.prune_strategy",
      "ref slim/prune/prune_strategy.py — strategy machinery lives in "
      "slim/prune.py + slim/core.py",
      {"PruneHelper": _prune.PruneHelper, "sensitivity":
       _prune.sensitivity})
    V("paddle_tpu_torch.contrib.slim.prune.auto_prune_strategy",
      "ref slim/prune/auto_prune_strategy.py — the sensitivity sweep is "
      "slim.prune.sensitivity", {"sensitivity": _prune.sensitivity})
    V("paddle_tpu_torch.contrib.slim.core.compressor",
      "ref slim/core/compressor.py",
      {"Compressor": _score.Compressor, "Context": _score.Context})
    V("paddle_tpu_torch.contrib.slim.core.strategy",
      "ref slim/core/strategy.py — strategies are plain objects with "
      "hooks on Context here", {"Compressor": _score.Compressor})
    V("paddle_tpu_torch.contrib.slim.core.config",
      "ref slim/core/config.py — YAML config factory; the Compressor "
      "takes plain Python config", {"Compressor": _score.Compressor})
    V("paddle_tpu_torch.contrib.slim.distillation.distiller",
      "ref slim/distillation/distiller.py",
      {k: getattr(_distill, k) for k in _distill.__all__})
    V("paddle_tpu_torch.contrib.slim.distillation.distillation_strategy",
      "ref slim/distillation/distillation_strategy.py",
      {"merge": _distill.merge})
    for child in ("quantization_pass", "quantization_strategy",
                  "post_training_quantization"):
        V("paddle_tpu_torch.contrib.slim.quantization." + child,
          "ref slim/quantization/%s.py — QAT/PTQ passes live in "
          "slim/qat.py + contrib/quantize.py" % child,
          {"quant_aware": _qat.quant_aware, "convert": _qat.convert})
    for child in ("quantization_mkldnn_pass",
                  "mkldnn_post_training_strategy"):
        _guided("paddle_tpu_torch.contrib.slim.quantization." + child,
                "ref slim/quantization/%s.py" % child,
                "MKL-DNN passes target x86 inference; in paddle_tpu_torch "
                "use slim.qat.quant_aware/convert (the program runs its "
                "fake-quant ops on the card)")
    V("paddle_tpu_torch.contrib.quantize.quantize_transpiler",
      "ref contrib/quantize/quantize_transpiler.py — PTQ helpers live "
      "in contrib/quantize.py",
      {k: getattr(_cq, k) for k in _cq.__all__})
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
    for child in ("optimizer_factory", "ps_pb2", "node"):
        _guided("paddle_tpu_torch.incubate.fleet.parameter_server.pslib."
                + child,
                "ref incubate/fleet/parameter_server/pslib/%s.py" % child,
                "PSLib configures Baidu's pserver binary; in "
                "paddle_tpu_torch sparse tables are embeddings marked "
                "is_distributed=True, trained synchronously")
