"""The Executor's compiled step on a CUDA card: a warm run captured into
one CUDA graph and replayed.

Counterpart of paddle_tpu/framework/executor.py:292-347 and :742-771
(``_run_jitted``, ``_compile``), where a run is traced once per
(program, feed signature) into one ``jax.jit`` step with donated state.
Here the Executor's own op-by-op step is captured into a
``torch.cuda.CUDAGraph`` on the second run of a key and replayed from
then on. A replay launches exactly the kernels the op-by-op step
launches (the hand-written ones through their wrappers, cuBLAS for the
matmuls); nothing is compiled again and no op changes.

What the graph holds fixed, and how each run gets its own values in:

- feeds: one static device buffer each, filled before every replay by an
  asynchronous copy from a pinned host buffer (or from a device tensor);
- state: the scope's persistable tensors are the graph's static inputs,
  the counterpart of donation. The captured step ends by copying every
  persistable that an op rebound to a new tensor back into its static
  input, so after a replay the scope still points at the same tensors.
  A scope tensor that is no longer the static input
  (``set_params_from_numpy``, ``load_checkpoint``, a user's ``set_var``)
  is copied in before the replay; it has the static input's shape and
  dtype, since both are part of the step's key;
- random draws: the plan's Philox generators are registered with the
  graph and re-seeded for the run before each replay, which writes their
  seeds into the graph (``executor._Generators``), so replay k draws
  what op-by-op run k would;
- launch counts: the kernels' counters move while the step is captured,
  though nothing ran; that change is taken back and credited on every
  replay.

The outputs live in the graph's memory pool and the next replay
overwrites them: the Executor copies them out (to numpy, a clone, a slot
of ``run_steps``' stacked output) before it replays anything again. The
Executor's graphs share one pool and replay one after another on one
stream.
"""
import time

import torch

from ..ops import kernels


class GraphCaptureError(RuntimeError):
    """Capturing a step failed; the message names the op that was
    running."""


class StaticInputMismatchError(ValueError):
    """A scope tensor replaced between replays has another shape or dtype
    than the static input it would be copied into. The Executor keys a
    step on each state tensor's shape and dtype, so its runs never reach
    this."""


class CompiledStep(object):
    """One captured run of a (program, feeds, fetches, state, scope) key.

    ``state``: {name: device tensor}, the scope's persistables, which
    become the graph's static inputs; ``feeds``: {name: (shape, dtype)}.
    """

    def __init__(self, device, state, feeds):
        self.device = device
        self.state = state
        self.feeds = {n: torch.empty(shape, dtype=dtype, device=device)
                      for n, (shape, dtype) in feeds.items()}
        self.graph = None            # made by capture
        self.outputs = None
        self.launches = None
        self.capture_ms = None
        self.pool_bytes = None
        self._staging = {}
        self._staged = None

    def load(self, feeds, scope):
        """This run's feeds ({name: (tensor, dtype)}) into the static
        buffers, and a scope tensor that is no longer its static input
        into it. A host feed goes through a pinned buffer with an
        asynchronous copy; the host waits only for the previous run's copy
        out of that buffer."""
        if self._staged is not None:
            self._staged.synchronize()
            self._staged = None
        staged = False
        for name, (t, _) in feeds.items():
            dst = self.feeds[name]
            if t.device.type == "cpu":
                buf = self._staging.get(name)
                if buf is None:
                    buf = self._staging[name] = torch.empty(
                        dst.shape, dtype=dst.dtype, pin_memory=True)
                buf.copy_(t)
                dst.copy_(buf, non_blocking=True)
                staged = True
            else:
                dst.copy_(t)
        if staged:
            self._staged = torch.cuda.Event()
            self._staged.record()
        for name, static in self.state.items():
            val = scope.find_var(name)
            if val is not static:
                if val.shape != static.shape or val.dtype != static.dtype:
                    raise StaticInputMismatchError(
                        "persistable %r is %s %s in the scope but the "
                        "captured step holds it as %s %s; a new shape or "
                        "dtype is a new key of the Executor"
                        % (name, tuple(val.shape), val.dtype,
                           tuple(static.shape), static.dtype))
                static.copy_(val)
                scope.set_var(name, static)

    def capture(self, run, fetch, generators, pool):
        """Capture ``run(env)`` (the step's ops on {name: tensor}) on the
        current stream, which must not be the default one, then
        ``fetch(env)`` (the fetch tensors). Every generator the step
        draws from must be in ``generators``. Does not replay."""
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()     # the warm run's cached blocks
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        for g in generators:
            self.graph.register_generator_state(g)
        before = kernels.launch_counts()
        env = dict(self.state)
        env.update(self.feeds)
        # thread_local: a CUDA call of another thread (a pod host's
        # checkpoint copy) does not void this capture
        self.graph.capture_begin(pool=pool,
                                 capture_error_mode="thread_local")
        try:
            run(env)
            self._write_back(env)
            self.outputs = fetch(env)
        except BaseException:
            try:
                self.graph.capture_end()
            except Exception:        # the capture is void either way
                pass
            kernels.credit_launches(tuple(
                b - a for a, b in zip(kernels.launch_counts(), before)))
            raise
        self.graph.capture_end()
        self.launches = tuple(a - b for a, b in zip(kernels.launch_counts(),
                                                    before))
        kernels.credit_launches(tuple(-d for d in self.launches))
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved

    def replay(self):
        self.graph.replay()
        kernels.credit_launches(self.launches)

    def _write_back(self, env):
        """Captured: each persistable an op rebound, copied into its static
        input. A new value that shares memory with a static input (an op
        that handed one persistable on as another) is cloned first, so no
        copy reads what an earlier copy wrote."""
        pending = [(static, env[n]) for n, static in self.state.items()
                   if env.get(n) is not None and env[n] is not static]
        held = {s.untyped_storage().data_ptr() for s in self.state.values()}
        pending = [(s, v.clone() if v.untyped_storage().data_ptr() in held
                    else v) for s, v in pending]
        for static, val in pending:
            static.copy_(val)


__all__ = ["CompiledStep", "GraphCaptureError", "StaticInputMismatchError"]
