"""Dygraph runtime: eager Variables over torch tensors.

Counterpart of paddle_tpu/dygraph/base.py (reference: dygraph/base.py +
imperative/tracer.cc). There, every eager op records a tape node holding
its ``jax.vjp`` and ``backward()`` walks the tape in reverse. Here the
tape is torch's own autograd graph: an op that records runs under
autograd on its inputs' tensors, and ``backward()`` is
``torch.autograd.backward`` from the root, seeded with ones (also for a
non-scalar root, as the reference does).

What the two keep alike, and where they part:

- **Recording** (``_should_record``, paddle_tpu's :88-95): an op records
  only under an active tape (inside ``guard``, outside ``no_grad`` and
  ``pause_tape``) and when one of its differentiable inputs wants a
  gradient (``stop_gradient`` False and a float tensor). Such an input
  whose tensor is a leaf is marked ``requires_grad`` at that moment, so a
  parameter or a ``to_variable`` input gets its gradient as in the JAX
  package; an op that does not record runs under ``torch.no_grad()``.
- **Which variables get ``_grad``.** The JAX walk gives one to every
  variable it reaches. torch fills ``.grad`` of leaves only; an output
  of a recorded op (a non-leaf) gets a ``register_hook`` holding the
  variable weakly, so a variable the user still holds gets its gradient
  and a dead one (every activation of a step, once its layer returned)
  keeps nothing. An op output that is one of its inputs (dropout at p =
  0) is a fresh view of it, so the two variables do not share a
  gradient slot.
- **Accumulation**: gradients add up until ``clear_gradient``;
  ``backward(retain_graph=True)`` keeps the graph for another backward.
- **In-place updates.** The dygraph optimizers and ``Layer.set_dict``
  write into a parameter's own tensor (the fused-Adam kernel on the card,
  a copy on the CPU; dygraph/optimizers.py) and bump its autograd
  version, so a graph kept by ``retain_graph=True`` that saved the old
  value refuses to run backward (``InplaceUpdateError``) instead of
  reading the new weights. The JAX package's tape closes over the old
  values and would give the old gradients.
- ``reset_tape()`` detaches every live recorded variable (guard's exit
  and ``disable_dygraph`` call it), which frees their graphs.

``guard(place=None)`` runs on ``CUDAPlace(0)`` unless the caller passes
``CPUPlace()``; without a CUDA device the default raises
``NoCUDADeviceError``. It applies the Executor's precision contract
(``framework/executor.py`` ``set_precision``: no TF32 in matmuls or
convolutions, deterministic cuDNN).
"""
import contextlib
import functools
import weakref

import numpy as np
import torch

from ..framework.dtypes import normalize_dtype, to_torch_dtype
from ..framework.place import CUDAPlace
from ..framework.scope import to_numpy

_in_dygraph = [False]
_place = [None]            # the active guard's place
_device = [None]           # and its torch.device
_no_grad_depth = [0]
_tape_paused = [0]
_forced = [0]              # Layer.loss_and_grad / DataParallel record always
# the live variables whose value a recorded op produced (their graphs are
# what reset_tape frees)
_tape = weakref.WeakSet()
# name -> EagerVariable, so static layer functions (which plumb var NAMES
# through LayerHelper.append_op) can resolve eager values in dygraph mode
_eager_registry = weakref.WeakValueDictionary()
_name_counter = [0]


class InplaceUpdateError(RuntimeError):
    """A kept graph (``backward(retain_graph=True)``) reads a parameter
    that an optimizer or ``set_dict`` has since updated in place."""


def lookup_eager(name):
    try:
        return _eager_registry[name]
    except KeyError:
        raise KeyError(
            "dygraph: no eager value named %r — if this is a parameter "
            "from a static layer (fc/conv2d...), use the dygraph.nn "
            "module equivalents under dygraph.guard" % (name,))


def current_place():
    """The active guard's place; outside a guard the default place."""
    return _place[0] if _place[0] is not None else CUDAPlace(0)


def current_device():
    """torch.device of ``current_place()`` (NoCUDADeviceError for a CUDA
    place without a card)."""
    if _device[0] is not None:
        return _device[0]
    return current_place().torch_device()


@contextlib.contextmanager
def pause_tape():
    """Disable tape recording."""
    _tape_paused[0] += 1
    try:
        yield
    finally:
        _tape_paused[0] -= 1


@contextlib.contextmanager
def force_record():
    """Record every op whose inputs want a gradient, whatever the tape's
    state (the functional gradients of Layer.loss_and_grad)."""
    _forced[0] += 1
    try:
        yield
    finally:
        _forced[0] -= 1


def tape_active():
    if _forced[0]:
        return True
    return (_in_dygraph[0] and not _tape_paused[0]
            and not _no_grad_depth[0])


def reset_tape():
    """Detach every live recorded variable: no backward reaches through
    what was recorded before."""
    for v in list(_tape):
        if v._value is not None and v._value.grad_fn is not None:
            v._value = v._value.detach()
    _tape.clear()


def _should_record(eager_inputs):
    if not tape_active():
        return False
    # every input is asked (no short cut), so each leaf that wants a
    # gradient is marked before the op runs
    wants = [v._wants_grad() for v in eager_inputs]
    return any(wants)


def _unalias(t, inputs):
    """A recorded output that is one of the op's input tensors becomes a
    view of it (its own autograd node and gradient slot)."""
    if t.requires_grad and any(t is x for x in inputs):
        return t.view_as(t)
    return t


def apply_eager(fn, *eager_inputs):
    """Run ``fn(*tensors)`` eagerly, under autograd when the op records.
    fn returns one tensor or a tuple; returns EagerVariable(s)
    correspondingly."""
    record = _should_record(eager_inputs)
    vals = [v._value for v in eager_inputs]
    with torch.set_grad_enabled(record):
        out = fn(*vals)
    if isinstance(out, tuple):
        return tuple(EagerVariable._output(_unalias(o, vals) if record
                                           else o, record) for o in out)
    return EagerVariable._output(_unalias(out, vals) if record else out,
                                 record)


def enabled():
    return _in_dygraph[0]


def _enter(place):
    from ..framework.executor import set_precision
    place = place if place is not None else CUDAPlace(0)
    device = place.torch_device()  # NoCUDADeviceError without a card
    set_precision()
    _in_dygraph[0], _place[0], _device[0] = True, place, device


def enable_dygraph(place=None):
    _enter(place)


def disable_dygraph():
    _in_dygraph[0], _place[0], _device[0] = False, None, None
    reset_tape()  # mirror guard()'s exit: drop recorded graphs


@contextlib.contextmanager
def guard(place=None):
    """Dygraph mode on ``place`` (default ``CUDAPlace(0)``)."""
    old = (_in_dygraph[0], _place[0], _device[0])
    _enter(place)
    try:
        yield
    finally:
        _in_dygraph[0], _place[0], _device[0] = old
        if not old[0]:
            reset_tape()


def _as_tensor(value, device=None):
    """A tensor on ``device``, by default the guard's device; outside a
    guard a tensor stays where it is and a host value goes to the default
    place's device. numpy float64 becomes float32, as ``jnp.asarray``
    gives it without x64; integer types keep their width (the port's ids
    are int64)."""
    if isinstance(value, EagerVariable):
        value = value._value
    dev = device if device is not None else _device[0]
    if isinstance(value, torch.Tensor):
        t = value
    else:
        a = np.asarray(value)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dev is None:
            dev = current_device()
    if t.dtype == torch.float64:
        t = t.float()
    return t if dev is None or t.device == dev else t.to(dev)


def _host_copy(t):
    """A numpy copy of ``t`` that a later in-place update of ``t`` (an
    optimizer step) leaves alone (a CPU tensor's ``numpy()`` shares its
    storage)."""
    a = to_numpy(t)
    return a.copy() if t.device.type == "cpu" else a


class EagerVariable(object):
    """Eager tensor: a thin wrapper over a torch tensor with fluid's
    dygraph Variable surface (numpy(), backward(), gradient())."""

    def __init__(self, value, name=None, stop_gradient=False):
        if value is not None:
            value = _as_tensor(value)
            if stop_gradient and value.requires_grad:
                value = value.detach()
        self._value = value
        if name is None:
            _name_counter[0] += 1
            name = "eager_var_%d" % _name_counter[0]
        elif name in _eager_registry:
            # user-supplied duplicate: uniquify so name-based op dispatch
            # (LayerHelper eager path) can never resolve to the wrong var
            base, n = name, 1
            while name in _eager_registry:
                n += 1
                name = "%s_%d" % (base, n)
        self.name = name
        self._stop_gradient = bool(stop_gradient)
        self._held_grad = None
        _eager_registry[name] = self

    @classmethod
    def _output(cls, t, record):
        v = cls(None)
        v._set_output(t, record)
        return v

    def _set_output(self, t, record):
        """Bind an op's output tensor; a recorded one gets the gradient
        hook (the module docstring)."""
        if self._stop_gradient and t.requires_grad:
            t = t.detach()
        self._value = t
        if record and t.requires_grad and not t.is_leaf:
            ref = weakref.ref(self)

            def hold(g, ref=ref):
                v = ref()
                if v is not None:
                    v._held_grad = g if v._held_grad is None \
                        else v._held_grad + g
            t.register_hook(hold)
            _tape.add(self)

    def _wants_grad(self):
        """Whether this input wants a gradient; a float leaf that does is
        marked requires_grad."""
        if self._stop_gradient:
            return False
        t = self._value
        if t.requires_grad:
            return True
        if t.is_floating_point():
            t.requires_grad_(True)
            return True
        return False

    # value plumbing -------------------------------------------------------
    @property
    def value(self):
        return self._value

    @property
    def shape(self):
        return tuple(self._value.shape)

    @property
    def dtype(self):
        return normalize_dtype(self._value.dtype)

    @property
    def stop_gradient(self):
        return self._stop_gradient

    @stop_gradient.setter
    def stop_gradient(self, flag):
        self._stop_gradient = bool(flag)
        t = self._value
        if flag and t is not None and t.requires_grad:
            if t.is_leaf:
                t.requires_grad_(False)
            else:
                self._value = t.detach()

    @property
    def _grad(self):
        if self._held_grad is not None:
            return self._held_grad
        t = self._value
        return t.grad if t is not None and t.is_leaf else None

    @_grad.setter
    def _grad(self, g):
        t = self._value
        if t is not None and t.is_leaf and t.requires_grad:
            t.grad = None if g is None else _as_tensor(g).to(t.dtype)
            self._held_grad = None
        else:
            self._held_grad = g

    def numpy(self):
        return _host_copy(self._value)

    def astype(self, dtype):
        return apply_eager(lambda x: x.to(to_torch_dtype(dtype)), self)

    def detach(self):
        return EagerVariable(self._value.detach(), stop_gradient=True)

    def gradient(self):
        g = self._grad
        return None if g is None else _host_copy(g)

    def backward(self, backward_strategy=None, retain_graph=False):
        """Backward from this variable (reference: imperative/tracer.cc
        Engine), seeded with ones: fills the gradient of every leaf that
        wants one and of every live variable the graph passes through."""
        t = self._value
        seed = torch.ones_like(t)
        if not t.requires_grad:
            # no recorded path: only the root is reached
            self._held_grad = seed if self._held_grad is None \
                else self._held_grad + seed
            return
        try:
            torch.autograd.backward(t, seed, retain_graph=retain_graph)
        except RuntimeError as e:
            if "modified by an inplace operation" not in str(e):
                raise
            raise InplaceUpdateError(
                "dygraph: this backward reads a parameter that an optimizer "
                "(minimize) or set_dict has updated in place since the "
                "graph was recorded (retain_graph=True); run the forward "
                "again") from e

    def clear_gradient(self):
        self._held_grad = None
        t = self._value
        if t is not None and t.is_leaf:
            t.grad = None

    # operator sugar -------------------------------------------------------
    def _b(self, other, fn):
        if isinstance(other, EagerVariable):
            return apply_eager(fn, self, other)
        return apply_eager(lambda a: fn(a, other), self)

    def __add__(self, o):
        return self._b(o, torch.add)
    __radd__ = __add__

    def __sub__(self, o):
        return self._b(o, torch.sub)

    def __rsub__(self, o):
        return self._b(o, lambda a, b: b - a)

    def __mul__(self, o):
        return self._b(o, torch.mul)
    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._b(o, torch.true_divide)

    def __matmul__(self, o):
        return self._b(o, torch.matmul)

    def __neg__(self):
        return apply_eager(torch.neg, self)

    def __getitem__(self, idx):
        return apply_eager(lambda x: x[idx], self)

    def __repr__(self):
        return "EagerVariable(%s, shape=%s)" % (self._value, self.shape)


def to_variable(value, name=None, zero_copy=None):
    if isinstance(value, EagerVariable):
        return value
    return EagerVariable(value, name=name)


@contextlib.contextmanager
def no_grad_ctx():
    _no_grad_depth[0] += 1
    try:
        yield
    finally:
        _no_grad_depth[0] -= 1


def no_grad(fn=None):
    if fn is None:
        return no_grad_ctx()

    @functools.wraps(fn)
    def wrapper(*a, **k):
        with no_grad_ctx():
            return fn(*a, **k)
    return wrapper
