"""Dygraph -> static capture: TracedLayer.

Counterpart of paddle_tpu/dygraph/jit.py (reference: dygraph/jit.py
TracedLayer + ProgramTranslator). There a trace is a ``jax.jit`` of the
layer's forward that reads the current parameter values at every call.
Here, on a CUDA card, the forward is captured once per input signature
(shapes and dtypes) into a CUDA graph (``torch.cuda.CUDAGraph``) and
replayed: a replay launches the same kernels on the same tensors as the
eager forward, so it equals it bit for bit. The graph reads each
parameter and buffer (running statistics, power-iteration vectors) by
address: the dygraph optimizers, ``set_dict`` at the same shape and the
layers' own state updates write into those tensors, so a replay after
``minimize`` reads the new values. Before a call the layer tree's tensors
are looked up again, and if one has moved (``set_dict`` at another
shape, a parameter assigned anew) every graph is dropped and the forward
captured again; a forward that itself rebinds a tensor of the tree
cannot be replayed and raises. On the CPU a call runs the forward under
``no_grad``. A call runs on the device the layer was traced on, inside a
guard or not.

The forward runs under ``no_grad`` either way (a trace is for
inference), in the layer's current mode: trace an ``eval()`` layer, as a
dropout that draws inside the capture would draw the same mask at every
replay. The capture's warm-up forward leaves the buffers as it found
them, so a traced call changes a layer's state as one eager call does.
``captures`` counts the graphs captured.
"""
import torch

from . import base
from .base import EagerVariable


def _outputs(outs):
    if isinstance(outs, (list, tuple)):
        return [o._value for o in outs], True
    return [outs._value], False


def _wrap(tensors, listy):
    outs = [EagerVariable(t, stop_gradient=True) for t in tensors]
    return outs if listy else outs[0]


def _tree_tensors(layer):
    """Every EagerVariable ``layer`` and its sublayers hold, parameters
    and buffers, once each."""
    layers = [layer] + (layer.sublayers()
                        if hasattr(layer, "sublayers") else [])
    seen, out = set(), []
    for l in layers:
        for v in list(getattr(l, "_parameters", {}).values()) + \
                list(vars(l).values()):
            if isinstance(v, EagerVariable) and v._value is not None \
                    and id(v) not in seen:
                seen.add(id(v))
                out.append(v)
    return out


class TracedLayer(object):
    def __init__(self, layer):
        self._layer = layer
        self._device = base.current_device()   # where the layer was traced
        self._graphs = {}
        self._addresses = None
        self.captures = 0

    def _signature(self):
        """Where each tensor of the layer tree lives, and its layout: what
        the captured graphs read."""
        return tuple((v._value.data_ptr(), tuple(v._value.shape),
                      v._value.dtype) for v in _tree_tensors(self._layer))

    @staticmethod
    def trace(layer, inputs):
        """(the forward's outputs on ``inputs``, a TracedLayer)."""
        traced = TracedLayer(layer)
        return traced(inputs), traced

    def _forward(self, tensors):
        with base.no_grad_ctx(), torch.no_grad():
            return _outputs(self._layer.forward(
                *[EagerVariable(t, stop_gradient=True) for t in tensors]))

    def _capture(self, tensors):
        static = [t.clone() for t in tensors]
        held = [(v, v._value) for v in _tree_tensors(self._layer)]
        buffers = [(t, t.clone()) for v, t in held
                   if not getattr(v, "_is_param", False)]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self._forward(static)     # warm: handles, workspaces, libraries
        torch.cuda.current_stream().wait_stream(side)
        self._check_held(held)
        with torch.no_grad():
            for t, before in buffers:         # undo the warm-up's updates
                t.copy_(before)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs, listy = self._forward(static)
        self._check_held(held)
        self.captures += 1
        return graph, static, outs, listy

    @staticmethod
    def _check_held(held):
        moved = [v.name or "a %s tensor" % (tuple(t.shape),)
                 for v, t in held if v._value is not t]
        if moved:
            raise RuntimeError(
                "TracedLayer: the forward rebinds %s; a CUDA graph reads a "
                "layer's tensors by address, so a traced forward must "
                "write its state into the tensors it has" % moved)

    def __call__(self, inputs):
        tensors = [base._as_tensor(x, self._device).detach()
                   for x in inputs]
        if tensors[0].device.type != "cuda":
            outs, listy = self._forward(tensors)
            return _wrap(outs, listy)
        addresses = self._signature()
        if addresses != self._addresses:      # a tensor the graphs read moved
            self._graphs.clear()
            self._addresses = addresses
        key = tuple((tuple(t.shape), t.dtype) for t in tensors)
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = self._capture(tensors)
        graph, static, outs, listy = entry
        for s, t in zip(static, tensors):
            s.copy_(t)
        graph.replay()
        return _wrap([o.clone() for o in outs], listy)

    def save_inference_model(self, dirname, feed=None, fetch=None):
        from .checkpoint import save_dygraph
        save_dygraph(self._layer.state_dict(), dirname + "/traced")


def dygraph_to_static_graph(fn):
    """Decorator mirroring @dygraph_to_static_graph: the function runs
    as written (TracedLayer is the capture)."""
    return fn
