"""Step watchdog and straggler detection.

Counterpart of paddle_tpu/framework/watchdog.py. A hung collective, or a
card that stalls, shows up as a step whose outputs never become ready.
On the card the Executor records a CUDA event after each step it
dispatches; ``wait_with_timeout`` waits for that event on a helper
thread with a bounded join, so a silent hang becomes a
``CollectiveTimeoutError`` the trainer can recover from.
``StragglerDetector`` flags a slow step before it becomes a hang.
"""
import threading

import torch

__all__ = ["CollectiveTimeoutError", "wait_with_timeout", "bounded_call",
           "StragglerDetector", "enable_straggler_detection",
           "disable_straggler_detection", "straggler_detector",
           "observe_step_latency", "straggler_action_due"]


class CollectiveTimeoutError(RuntimeError):
    """A step (and therefore some collective in it) failed to complete
    within the configured timeout."""


class StragglerDetector(object):
    """Per-step latency EWMA: flag a slow host before it hangs.

    Each ``observe(seconds)`` updates ``ewma = alpha*x + (1-alpha)*ewma``
    and records a ``straggler`` resilience event when a step exceeds
    ``k × ewma`` (after ``warmup`` samples, and only past
    ``min_latency_s``). Straggler samples still update the EWMA, so a
    persistent slowdown recalibrates the baseline instead of flagging
    every step: the signal is the transition.

    ``action_k`` (>= k) arms a second, critical threshold: a step past
    ``action_k × ewma`` latches an action flag (``straggler_critical``
    event) that the training loop polls with
    :func:`straggler_action_due` to take a pre-emptive checkpoint
    (``straggler_ckpt`` event), so the hang costs at most one step of
    replay.
    """

    def __init__(self, alpha=0.2, k=3.0, warmup=5, min_latency_s=0.0,
                 action_k=None):
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        if k <= 1.0:
            raise ValueError("k must be > 1 (k*ewma is the flag line)")
        if action_k is not None and action_k < k:
            raise ValueError("action_k is the SECOND threshold — it must "
                             "be >= k (got action_k=%g < k=%g)"
                             % (action_k, k))
        self.alpha = float(alpha)
        self.k = float(k)
        self.warmup = int(warmup)
        self.min_latency_s = float(min_latency_s)
        self.action_k = None if action_k is None else float(action_k)
        self._action_due = False
        self._ewma = None
        self._n = 0
        self._lock = threading.Lock()

    @property
    def ewma_s(self):
        return self._ewma

    @property
    def count(self):
        return self._n

    def observe(self, seconds, what="step"):
        """Feed one step latency; True if it was flagged as a straggler."""
        seconds = float(seconds)
        with self._lock:
            # a zero baseline has no meaningful ratio
            flagged = (self._n >= self.warmup and self._ewma is not None
                       and self._ewma > 0.0
                       and seconds > self.k * self._ewma
                       and seconds > self.min_latency_s)
            critical = (flagged and self.action_k is not None
                        and seconds > self.action_k * self._ewma)
            if critical:
                self._action_due = True
            ewma = self._ewma
            self._ewma = seconds if self._ewma is None else (
                self.alpha * seconds + (1.0 - self.alpha) * self._ewma)
            self._n += 1
        if flagged:
            from . import resilience
            resilience.record_event("straggler", what=what,
                                    latency_s=seconds, ewma_s=ewma,
                                    ratio=seconds / ewma)
        if critical:
            from . import resilience
            resilience.record_event("straggler_critical", what=what,
                                    latency_s=seconds, ewma_s=ewma,
                                    ratio=seconds / ewma)
        return flagged

    def action_due(self):
        """Consume the latched critical flag: True once per critical
        straggler, then False until the next one."""
        with self._lock:
            due = self._action_due
            self._action_due = False
            return due


# opt-in process-global detector, fed by Executor.run/run_steps; None
# (the default) costs a run nothing
_detector = [None]


def enable_straggler_detection(alpha=0.2, k=3.0, warmup=5,
                               min_latency_s=0.0, action_k=None):
    """Install (and return) the process-global StragglerDetector fed by
    Executor.run and run_steps."""
    _detector[0] = StragglerDetector(alpha=alpha, k=k, warmup=warmup,
                                     min_latency_s=min_latency_s,
                                     action_k=action_k)
    return _detector[0]


def disable_straggler_detection():
    _detector[0] = None


def straggler_detector():
    return _detector[0]


def observe_step_latency(seconds, what="step"):
    """Feed the global detector (no-op when detection is disabled)."""
    det = _detector[0]
    if det is None:
        return False
    return det.observe(seconds, what=what)


def straggler_action_due():
    """Consume the global detector's critical-straggler flag (False when
    detection is disabled or no critical straggler was seen)."""
    det = _detector[0]
    if det is None:
        return False
    return det.action_due()


def bounded_call(fn, timeout_s, name="paddle_tpu_torch-bounded-call"):
    """Run ``fn()`` on a daemon helper thread with a bounded join.

    Returns ``(done, value, error)``; ``done`` False means the join timed
    out and the orphaned thread keeps running in the background. Shared
    by wait_with_timeout and resilience.run_with_deadline."""
    box = {}
    done = threading.Event()

    def _worker():
        try:
            box["value"] = fn()
        except BaseException as e:      # surface errors to the caller
            box["error"] = e
        finally:
            done.set()

    t = threading.Thread(target=_worker, daemon=True, name=name)
    t.start()
    if not done.wait(float(timeout_s)):
        return False, None, None
    return True, box.get("value"), box.get("error")


def _leaves(outputs):
    if isinstance(outputs, (list, tuple)):
        for o in outputs:
            yield from _leaves(o)
    elif isinstance(outputs, dict):
        for o in outputs.values():
            yield from _leaves(o)
    else:
        yield outputs


def wait_with_timeout(outputs, timeout_s, what="step"):
    """Wait until ``outputs`` are ready, or raise CollectiveTimeoutError
    after ``timeout_s`` seconds.

    ``outputs``: a ``torch.cuda.Event`` recorded after the step (what the
    Executor passes; any object with a ``synchronize()`` is waited on the
    same way), CUDA tensors (an event is recorded behind them on their
    device's current stream), or a nesting of these; a CPU tensor is
    ready when it exists. The wait runs on a helper thread; the work on
    the card cannot be cancelled, but the caller gets control back.
    Returns ``outputs``."""
    if timeout_s is None:
        return outputs
    events = []
    for leaf in _leaves(outputs):
        if isinstance(leaf, torch.Tensor):
            if leaf.device.type == "cuda":
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(leaf.device))
                events.append(ev)
        elif callable(getattr(leaf, "synchronize", None)):
            events.append(leaf)

    def _wait_all():
        for ev in events:
            ev.synchronize()

    done, _, err = bounded_call(_wait_all, timeout_s,
                                name="paddle_tpu_torch-step-watchdog")
    # an armed wait does not feed the straggler detector: Executor.run
    # and run_steps observe the whole dispatch already
    if not done:
        from . import resilience
        resilience.record_event("watchdog_timeout", what=what,
                                timeout_s=float(timeout_s))
        n_dev = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        raise CollectiveTimeoutError(
            "%s did not complete within %.1fs (%d visible CUDA device(s)) "
            "— likely a hung collective or a stalled card"
            % (what, float(timeout_s), n_dev))
    if err is not None:
        raise err
    return outputs
