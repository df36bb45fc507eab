"""The port's step watchdog (paddle_tpu_torch/framework/watchdog.py)
against the JAX package's (paddle_tpu/framework/watchdog.py): the
bounded call, the bounded wait, and the straggler detector's decisions
on the same latency stream. On the CPU nothing waits on a card: a CPU
tensor is ready when it exists, and a stuck step is an object whose
``synchronize()`` blocks."""
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu.framework import resilience as jres
from paddle_tpu.framework import watchdog as jwd
from paddle_tpu_torch.framework import resilience as tres
from paddle_tpu_torch.framework import watchdog as twd


@pytest.fixture(autouse=True)
def _clean():
    for mod in (jres, tres):
        mod.clear_events()
    for wd in (jwd, twd):
        wd.disable_straggler_detection()
    yield
    for mod in (jres, tres):
        mod.clear_events()
    for wd in (jwd, twd):
        wd.disable_straggler_detection()


def test_bounded_call_returns_value_error_or_times_out():
    assert twd.bounded_call(lambda: 41 + 1, 1.0) == (True, 42, None)

    def boom():
        raise ValueError("inner")
    done, value, err = twd.bounded_call(boom, 1.0)
    assert done and value is None and isinstance(err, ValueError)
    gate = threading.Event()
    t0 = time.perf_counter()
    assert twd.bounded_call(gate.wait, 0.02) == (False, None, None)
    assert time.perf_counter() - t0 < 1.0
    gate.set()                       # the orphaned helper finishes


class _Stuck(object):
    """A step that has not finished: ``synchronize`` blocks until
    released."""

    def __init__(self):
        self.released = threading.Event()

    def synchronize(self):
        self.released.wait()


def test_wait_with_timeout_cpu_tensors_are_ready():
    outs = [torch.ones(3), {"x": torch.zeros(2)}]
    assert twd.wait_with_timeout(outs, 0.01) is outs
    assert twd.wait_with_timeout(outs, None) is outs
    assert tres.events("watchdog_timeout") == []


def test_wait_with_timeout_raises_and_records_on_a_stuck_step():
    stuck = _Stuck()
    with pytest.raises(twd.CollectiveTimeoutError, match="stuck step"):
        twd.wait_with_timeout([torch.ones(1), stuck], 0.02,
                              what="stuck step")
    stuck.released.set()
    evs = tres.events("watchdog_timeout")
    assert len(evs) == 1 and evs[0]["what"] == "stuck step"
    assert evs[0]["timeout_s"] == 0.02
    # the same error type the trainer classifies as transient, in both
    assert tres.classify(twd.CollectiveTimeoutError()) == \
        jres.classify(jwd.CollectiveTimeoutError()) == "transient"
    # a finished step passes, and an error in the wait surfaces
    done = _Stuck()
    done.released.set()
    assert twd.wait_with_timeout(done, 0.5) is done


@pytest.mark.parametrize("kw", [
    dict(alpha=0.2, k=3.0, warmup=5),
    dict(alpha=0.5, k=2.0, warmup=2, min_latency_s=0.05),
    dict(alpha=0.3, k=2.0, warmup=3, action_k=4.0)])
def test_straggler_decisions_match_the_jax_package(kw):
    rng = np.random.RandomState(7)
    stream = list(0.01 + 0.002 * rng.rand(40))
    for i in (12, 13, 25, 33):        # stragglers, one critical
        stream[i] = 0.01 * (3.5 if i != 25 else 9.0)
    stream[30:] = [0.05] * 10         # a persistent slowdown recalibrates
    got = {}
    for name, wd, res in (("jax", jwd, jres), ("torch", twd, tres)):
        det = wd.enable_straggler_detection(**kw)
        flags = [wd.observe_step_latency(s, what="step") for s in stream]
        due = [wd.straggler_action_due() for _ in range(2)]
        got[name] = (flags, due, det.ewma_s, det.count,
                     [(e["kind"], e["latency_s"], e["ewma_s"])
                      for e in res.events()
                      if e["kind"].startswith("straggler")])
        wd.disable_straggler_detection()
    assert got["torch"] == got["jax"]
    assert any(got["torch"][0])


def test_straggler_detector_validates_like_the_jax_package():
    for kw in (dict(alpha=0.0), dict(k=1.0), dict(k=3.0, action_k=2.0)):
        with pytest.raises(ValueError) as je:
            jwd.StragglerDetector(**kw)
        with pytest.raises(ValueError) as te:
            twd.StragglerDetector(**kw)
        assert str(te.value) == str(je.value)
    assert twd.observe_step_latency(1.0) is False       # disabled: no-op
    assert twd.straggler_action_due() is False
