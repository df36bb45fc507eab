"""Model pruning: mask-based magnitude and structured pruning, and the
sensitivity sweep.

Counterpart of paddle_tpu/contrib/slim/prune.py (the reference's
slim/prune/{pruner,prune_strategy}.py). The reference shrinks tensors by
graph surgery; here, as in the JAX package, shapes stay and pruning is a
0/1 mask a parameter is multiplied by in the scope, re-applied after
each optimizer step (``apply_masks``). Masks are computed in numpy from
host copies of the values, so they equal the JAX package's for equal
values, and each goes to its parameter's device and dtype (0 and 1 are
exact in any float dtype).

A masked value is a new tensor bound to the parameter's name: on the
card the Executor's captured step copies it into its static input
before the next replay (framework/compiled_step.py). ``sensitivity``
restores each probed parameter from a copy taken before its probes,
since a replay may have copied a pruned value into the tensor the scope
held.
"""
import numpy as np
import torch

from ...framework.scope import global_scope, to_numpy

__all__ = ["Pruner", "MagnitudePruner", "StructurePruner", "PruneHelper",
           "sensitivity"]


def _host(value):
    return to_numpy(value) if isinstance(value, torch.Tensor) else \
        np.asarray(value)


class Pruner(object):
    """Base pruner (reference slim/prune/pruner.py Pruner)."""

    def prune(self, param):
        raise NotImplementedError


class MagnitudePruner(Pruner):
    """Unstructured abs-magnitude pruning: zero the smallest ``ratio``
    fraction of weights."""

    def __init__(self, ratio):
        self.ratio = float(ratio)

    def mask(self, value):
        v = _host(value)
        k = int(v.size * self.ratio)
        if k <= 0:
            return np.ones_like(v, np.float32)
        # by rank: exactly k elements, however many values tie
        mask = np.ones(v.size, np.float32)
        mask[np.argsort(np.abs(v).ravel(), kind="stable")[:k]] = 0.0
        return mask.reshape(v.shape)


class StructurePruner(Pruner):
    """Whole-slice (channel or neuron) pruning along ``axis``, slices
    ranked by their L1 norm (reference StructurePruner l1_norm)."""

    def __init__(self, ratio, axis=0, criterion="l1_norm"):
        self.ratio = float(ratio)
        self.axis = int(axis)
        if criterion != "l1_norm":
            raise ValueError("unsupported criterion %r" % criterion)

    def mask(self, value):
        v = _host(value)
        red = tuple(i for i in range(v.ndim) if i != self.axis)
        norms = np.abs(v).sum(axis=red)
        n_prune = int(norms.size * self.ratio)
        keep = np.ones(norms.size, np.float32)
        if n_prune > 0:
            keep[np.argsort(norms)[:n_prune]] = 0.0
        shape = [1] * v.ndim
        shape[self.axis] = -1
        return np.broadcast_to(keep.reshape(shape), v.shape).astype(
            np.float32).copy()


def _on(mask, value):
    """A numpy mask as a tensor on ``value``'s device, in its dtype."""
    return torch.from_numpy(mask).to(device=value.device, dtype=value.dtype)


class PruneHelper(object):
    """Computes, applies and re-applies pruning masks over a scope's
    parameters."""

    def __init__(self, program, ratios, pruner_cls=MagnitudePruner,
                 scope=None, **pruner_kwargs):
        """ratios: {param_name: ratio} or one float for every
        parameter."""
        self.program = program
        self.scope = scope if scope is not None else global_scope()
        params = [p.name for p in program.all_parameters()]
        if not isinstance(ratios, dict):
            ratios = {name: ratios for name in params}
        self.pruners = {name: pruner_cls(ratio, **pruner_kwargs)
                        for name, ratio in ratios.items()}
        self.masks = {}

    def compute_masks(self):
        for name, pruner in self.pruners.items():
            value = self.scope.find_var(name)
            if value is None:
                raise KeyError("parameter %r not in scope" % name)
            self.masks[name] = _on(pruner.mask(value), value)
        return self.masks

    def apply_masks(self):
        """Zero the pruned weights (idempotent; call after optimizer
        steps)."""
        if not self.masks:
            self.compute_masks()
        for name, mask in self.masks.items():
            self.scope.set_var(name, self.scope.find_var(name) * mask)

    def sparsity(self):
        total = live = 0
        for mask in self.masks.values():
            m = to_numpy(mask)
            total += m.size
            live += int(m.sum())
        return 1.0 - live / max(total, 1)


def sensitivity(program, executor, feed, fetch_loss, param_names=None,
                ratios=(0.1, 0.3, 0.5, 0.7, 0.9), pruner_cls=MagnitudePruner,
                scope=None):
    """Per-parameter pruning sensitivity (reference
    slim/prune/auto_prune_strategy): for each parameter and ratio, prune
    only that parameter and measure the loss's change. Each parameter is
    restored after its probes. Returns (base loss, {param: {ratio:
    delta}})."""
    scope = scope if scope is not None else global_scope()
    if param_names is None:
        param_names = [p.name for p in program.all_parameters()]

    def loss():
        out = executor.run(program, feed=feed, fetch_list=[fetch_loss],
                           scope=scope)
        return float(np.asarray(out[0]).mean())
    base = loss()
    report = {}
    for name in param_names:
        orig = scope.find_var(name).clone()
        report[name] = {}
        for ratio in ratios:
            scope.set_var(name, orig * _on(pruner_cls(ratio).mask(orig),
                                           orig))
            report[name][ratio] = loss() - base
        scope.set_var(name, orig)
    return base, report
