"""fluid.dygraph.profiler (counterpart of paddle_tpu/dygraph/profiler.py,
which aliases paddle_tpu/profiler.py's jax.profiler trace): the same
entry points over ``torch.profiler``, the CPU's activity and, on a card,
the device's, written as a Chrome trace to ``profile_path``."""
import contextlib

import torch

__all__ = ["profiler", "start_profiler", "stop_profiler", "reset_profiler"]

_DEFAULT_PATH = "paddle_tpu_torch_profile.json"
_active = []


def start_profiler(state="All", tracer_option=None,
                   profile_path=_DEFAULT_PATH):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    _active.append((prof, profile_path))


def stop_profiler(sorted_key=None, profile_path=None):
    prof, path = _active.pop()
    prof.stop()
    prof.export_chrome_trace(profile_path or path)
    return prof


def reset_profiler():
    pass


@contextlib.contextmanager
def profiler(state="All", sorted_key=None, profile_path=_DEFAULT_PATH):
    start_profiler(state, profile_path=profile_path)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)
