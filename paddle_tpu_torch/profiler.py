"""Profiler (counterpart of paddle_tpu/profiler.py; fluid's profiler.py).

On ``torch.profiler`` and the port's spans (``framework/obs.py``):
``profiler(state)`` / ``start_profiler`` + ``stop_profiler`` record the
host ("CPU") or host and card ("GPU", "All") and, at the stop, print the
reference's sorted table of events (kernels by their device time on the
card) and, given ``profile_path``, write a Chrome trace there;
``annotate(name)`` is a ``record_function`` range, an NVTX range on the
card and an obs span; ``profile_program`` times each op of a program run
op by op; ``cuda_profiler`` brackets a region with
``torch.cuda.profiler`` (cudaProfilerStart/Stop) for an outside CUDA
profiler.
"""
import contextlib
import time
from collections import defaultdict

import torch

from .framework import obs

__all__ = ["profiler", "start_profiler", "stop_profiler", "reset_profiler",
           "annotate", "profile_program", "cuda_profiler", "Profile"]

_STATES = ("CPU", "GPU", "All")
# fluid's sort keys -> the column of a row they sort by
_SORT = {None: 2, "default": 2, "total": 2, "calls": 1, "ave": 3}

_active = None


class Profile(object):
    """What a stopped profiler saw: ``rows`` of (event, calls, total ms,
    average ms) sorted as asked, ``table`` (their text)
    and ``events`` (torch.profiler's key_averages())."""

    def __init__(self):
        self.rows, self.table, self.events = [], "", None


def _activities(state):
    if state not in _STATES:
        raise ValueError("profiler state must be one of %s, got %r" %
                         (_STATES, state))
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if state != "CPU" and torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _device_us(e):
    """An event's device time (us): a kernel's own, or that of the
    kernels an operator launched."""
    return max(getattr(e, attr, 0) or 0 for attr in (
        "device_time_total", "self_device_time_total"))


def _rows(events, device, sorted_key):
    """(name, calls, total ms, ave ms) of each event: its device time
    where ``device`` (kernels and the ops that launched them), its host
    time otherwise; events with none left out."""
    rows = []
    for e in events:
        total = (_device_us(e) if device else e.cpu_time_total) / 1e3
        if total <= 0:
            continue
        n = max(int(e.count), 1)
        rows.append((e.key, n, total, total / n))
    col = _SORT[sorted_key]
    rows.sort(key=lambda r: -r[col])
    return rows


def _format(rows, top_k=None):
    lines = ["%-60s %8s %12s %12s" % ("Event", "Calls", "Total(ms)",
                                       "Avg(ms)")]
    for name, n, total, ave in rows[:top_k]:
        lines.append("%-60s %8d %12.4f %12.4f" % (name[:60], n, total, ave))
    return "\n".join(lines)


def start_profiler(state="All", tracer_option=None):
    """Start recording (``state``: "CPU", "GPU" or "All")."""
    global _active
    if _active is not None:
        raise RuntimeError("the profiler is already running")
    prof = torch.profiler.profile(activities=_activities(state))
    prof.__enter__()
    _active = (prof, state, obs.span("profiler.trace", state=state))
    _active[2].__enter__()


def stop_profiler(sorted_key=None, profile_path=None, print_table=True,
                  top_k=30):
    """Stop recording; returns the ``Profile`` (printed as a table, and
    written as a Chrome trace to ``profile_path`` when given)."""
    global _active
    if _active is None:
        raise RuntimeError("the profiler is not running")
    prof, state, span = _active
    _active = None
    if state != "CPU" and torch.cuda.is_available():
        torch.cuda.synchronize()
    span.__exit__(None, None, None)
    prof.__exit__(None, None, None)
    out = Profile()
    out.events = prof.key_averages()
    device = state != "CPU" and torch.cuda.is_available()
    out.rows = _rows(out.events, device, sorted_key)
    out.table = _format(out.rows, top_k)
    if print_table:
        print(out.table)
    if profile_path:
        prof.export_chrome_trace(profile_path)
    return out


def reset_profiler():
    """Drop what the running profiler recorded so far (a stop and a
    fresh start, as fluid's reset clears its event lists)."""
    if _active is None:
        return
    state = _active[1]
    stop_profiler(print_table=False)
    start_profiler(state)


@contextlib.contextmanager
def profiler(state="All", sorted_key=None, profile_path=None, top_k=30,
             print_table=True):
    """``with profiler("All") as p:`` ... ; on exit the table is printed
    and ``p`` (a ``Profile``) holds its rows."""
    result = Profile()
    start_profiler(state)
    try:
        yield result
    finally:
        done = stop_profiler(sorted_key, profile_path, print_table, top_k)
        result.rows, result.table, result.events = \
            done.rows, done.table, done.events


@contextlib.contextmanager
def annotate(name):
    """A named range: in torch.profiler's trace, as an NVTX range on the
    card, and as an obs span."""
    name = str(name)
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name), obs.span(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def profile_program(program, feed, scope=None, repeat=3, sorted_key="total",
                    top_k=30, print_table=True, place=None):
    """Per-op time attribution (the reference profiler's sorted op table):
    runs ``program`` op by op ``repeat`` times through an ``Executor`` on
    ``place`` (``CUDAPlace(0)`` unless given), each op of the global block
    timed on the host clock up to its completion (the card synchronised
    after it) and recorded as an obs span "op.<type>"; the first run is
    not counted. Returns rows of (op_type, calls, total_s, avg_s) sorted
    by ``sorted_key`` ("total" | "calls" | "ave"), a ``grad_of`` op under
    its own type, as the JAX package's. Times are of ops run one by one
    and synchronised: use them to see which ops dominate, and the
    graphed step for throughput."""
    from .framework import executor as executor_mod
    from .framework.executor import Executor
    from .framework.scope import global_scope

    scope = scope or global_scope()
    exe = Executor(place)
    cuda = exe.device.type == "cuda"
    totals, calls = defaultdict(float), defaultdict(int)
    depth = [0]
    counting = [False]

    def timed(inner):
        def call(op, *args):
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                with obs.span("op.%s" % op.type):
                    out = inner(op, *args)
                    if cuda:
                        torch.cuda.synchronize(exe.device)
            finally:
                depth[0] -= 1
            if depth[0] == 0 and counting[0]:
                totals[op.type] += time.perf_counter() - t0
                calls[op.type] += 1
            return out
        return call

    fwd, grad = executor_mod._run_fwd_op, executor_mod.trace.run_grad_op
    executor_mod._run_fwd_op = timed(fwd)
    executor_mod.trace.run_grad_op = timed(grad)
    try:
        for rep in range(repeat):
            counting[0] = rep > 0    # the first run warms up
            exe.run(program, feed=feed, scope=scope,
                    use_program_cache=False)
    finally:
        executor_mod._run_fwd_op, executor_mod.trace.run_grad_op = fwd, grad
    rows = [(t, calls[t], totals[t], totals[t] / max(calls[t], 1))
            for t in totals]
    key_idx = {"total": 2, "calls": 1, "ave": 3}[sorted_key]
    rows.sort(key=lambda r: -r[key_idx])
    rows = rows[:top_k]
    if print_table:
        print("%-28s %8s %12s %12s" % ("Op", "Calls", "Total(s)",
                                       "Avg(s)"))
        for t, c, tot, avg in rows:
            print("%-28s %8d %12.6f %12.6f" % (t, c, tot, avg))
    return rows


@contextlib.contextmanager
def cuda_profiler(output_file=None, output_mode=None, config=None):
    """fluid's cuda_profiler: ``torch.cuda.profiler`` start/stop around
    the region, for a CUDA profiler attached from outside (its output
    file and mode are that tool's settings; they are not read here)."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_profiler needs a CUDA device")
    with torch.cuda.profiler.profile():
        yield
