"""The numeric guard of a step (BuildStrategy check_numerics and
numeric_policy): the finite check and, under "skip", the revert.

Counterpart of paddle_tpu/framework/executor.py's per-var finite mask
(``_make_step``, :707-718) and ``_skip_guard`` (:101-114). The JAX
package reverts a poisoned step with one ``jnp.where`` over immutable
values. Here a step overwrites the scope's tensors in place (the
fused-Adam kernel writes the parameters and moments through raw
pointers, and a captured step's static state is the scope's own
tensors), so the guard keeps what it would revert to:

- which persistables a step writes is decided once per plan, from its
  blocks (``_RunPlan.writes``: every persistable some op outputs);
- under "skip", the step starts by copying those tensors into buffers
  that the step owns (one ``guarded_copy`` launch; a captured step's
  copies are made once, before its capture, and kept with its key's
  guard), and ends with one gated
  ``guarded_copy`` from them back, which reads the sticky flag on the
  device and does nothing on a clean step: no host branch;
- every step, op by op or captured, ends with one ``finite_flags``
  launch over its float fetches and float state (fetches first, then
  the state in name order: the JAX package's mask order), which names
  the first offender and sets the sticky flag.

The sticky flag is the last byte of ``flags``: the finite check sets it
and only the host clears it, before a ``run`` and at the start of a
``run_steps`` window, so once a step of a window is poisoned every later
step of that window is reverted too; the Executor then runs the
window's remaining batches again from the skipped step's run counter
(framework/executor.py ``_run_window``). A step run op by op restores on
the host (it reads the flag there anyway), rebinding each written name
to its copy.
"""
import torch

from ..ops.kernels import numeric_guard as ng


class StepGuard(object):
    """The guard of one key (a captured step) or of one plan's op-by-op
    runs: its flags, its tables and, under "skip", its copies."""

    def __init__(self, device, policy, writes):
        self.device = device
        self.policy = policy
        self.writes = tuple(writes)
        self.names = None             # the checked names, in mask order
        self.flags = None             # uint8: per name, any, sticky
        self._finite = ng.TensorTable(device)
        self._backup = ng.TensorTable(device)
        self._restore = ng.TensorTable(device)
        self._copies = None           # {name: buffer} of a captured step
        self.pool_bytes = 0           # bytes the copies hold

    @property
    def skip(self):
        return self.policy == "skip"

    def reset(self):
        """Clear the sticky flag (before a run, at a window's start)."""
        if self.flags is not None:
            self.flags[-1:].zero_()

    # -- op by op ------------------------------------------------------
    def save(self, env):
        """Under "skip": {name: a copy of its value} of the persistables
        the step writes, taken before its ops run."""
        if not self.skip:
            return None
        names = [n for n in self.writes if n in env]
        copies = {n: torch.empty(env[n].shape, dtype=env[n].dtype,
                                 device=env[n].device) for n in names}
        ng.guarded_copy([(env[n].contiguous(), copies[n]) for n in names],
                        self._backup)
        return copies

    def settle(self, named, env, saved):
        """After an op-by-op step's ops: check ``named`` (see check), and
        under "skip" rebind each written name of ``env`` to its copy when
        the sticky flag is set."""
        self.check(named)
        if saved is not None and self.sticky():
            env.update(saved)

    # -- captured ------------------------------------------------------
    def reserve(self, static):
        """Before a capture: the tables the captured kernels read and,
        under "skip", the copies, allocated outside it (see
        ``TensorTable``); the copies belong to this key's guard, which
        the Executor keeps with the graph."""
        names = [n for n in self.writes if n in static]
        for table in (self._backup, self._restore):
            table.reserve(len(names))
        self._finite.reserve(len(self.names or ()))
        if self.skip:
            self._copies = {n: torch.empty_like(static[n]) for n in names}
            self.pool_bytes = sum(t.numel() * t.element_size()
                                  for t in self._copies.values())

    def save_static(self, static):
        """Inside a capture, at the step's start: copy the static inputs
        the step writes into the copies."""
        if self.skip:
            ng.guarded_copy([(static[n], c) for n, c in self._copies.items()],
                            self._backup)

    def restore_static(self, static):
        """Inside a capture, at the step's end: copy the buffers back into
        the static inputs, gated on the sticky flag on the device."""
        if not self.skip:
            return
        ng.guarded_copy([(self._copies[n], static[n])
                         for n in self._copies], self._restore,
                        gate=self.flags[-1:])

    def flush(self):
        """After a capture: write the tables the captured kernels read."""
        for t in (self._finite, self._backup, self._restore):
            t.flush()

    # -- both ----------------------------------------------------------
    def check(self, named):
        """One finite check over ``named`` ([(name, tensor)], in mask
        order); non-float values are left out, as their mask entry is
        always true in the JAX package."""
        named = [(n, t) for n, t in named if ng.is_guarded_dtype(t.dtype)]
        names = [n for n, _ in named]
        if names != self.names or self.flags is None:
            if self.device.type == "cuda" and \
                    torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "the guarded step checks other vars than its warm run "
                    "did: %s" % names[:5])
            self.names = names
            self.flags = torch.zeros(len(names) + 2, dtype=torch.uint8,
                                     device=self.device)
        ng.finite_flags([t for _, t in named], self.flags, self._finite)
        return self.flags

    def sticky(self):
        """The sticky flag, read on the host (a sync on the card)."""
        return bool(self.flags[-1].item())

    def offender(self, row):
        """The first offending name of a flags row read on the host, or
        None."""
        for name, bad in zip(self.names, row[:len(self.names)]):
            if bad:
                return name
        return None


__all__ = ["StepGuard"]
