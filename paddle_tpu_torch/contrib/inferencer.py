"""High-level Inferencer API (counterpart of
paddle_tpu/contrib/inferencer.py; fluid's contrib/inferencer.py).

``Inferencer(infer_func, param_path, place=...).infer({name: array})``:
builds the inference program, loads the parameters a ``Trainer`` (or
``save_persistables``) saved, and runs it through ``Executor.run`` on
``CUDAPlace(0)`` unless ``place`` says otherwise; from the third request
of one shape a run replays its CUDA graph.
"""
import os

from ..framework.program import Program, program_guard
from ..framework.scope import Scope, scope_guard
from ..framework.executor import Executor
from .. import io as io_mod

__all__ = ['Inferencer']


class Inferencer(object):
    """infer_func() builds the inference graph and returns its output
    var(s); params load from ``param_path`` (a save_params /
    save_persistables directory) (ref :31)."""

    def __init__(self, infer_func, param_path, place=None, parallel=False):
        self.param_path = param_path
        self.scope = Scope()
        self.startup_program = Program()
        self.inference_program = Program()
        with program_guard(self.inference_program, self.startup_program):
            outs = infer_func()
            self.predict_vars = list(outs) if isinstance(
                outs, (list, tuple)) else [outs]
        self.exe = Executor(place)
        with scope_guard(self.scope):
            self.exe.run(self.startup_program)
            if param_path and os.path.isdir(param_path):
                io_mod.load_persistables(self.exe, param_path,
                                         self.inference_program)
            elif param_path:
                raise ValueError(
                    "param_path %s is not a directory of saved params" %
                    param_path)

    def infer(self, inputs, return_numpy=True):
        """inputs: {feed_name: ndarray} -> list of outputs (ref :80)."""
        if not isinstance(inputs, dict):
            raise ValueError(
                "inputs should be a map of {'input_name': input_var}")
        with scope_guard(self.scope):
            results = self.exe.run(self.inference_program, feed=inputs,
                                   fetch_list=self.predict_vars,
                                   return_numpy=return_numpy)
        return results
