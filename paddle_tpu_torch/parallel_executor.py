"""ParallelExecutor API shim (counterpart of paddle_tpu/
parallel_executor.py; ref python/paddle/fluid/parallel_executor.py).

A thin veneer over CompiledProgram and Executor, kept so fluid training
scripts run unchanged. ``use_cuda=True`` (the default) runs on
CUDAPlace(0) and raises NoCUDADeviceError without a card;
``use_cuda=False`` asks for the CPU. ``device_count`` counts the visible
CUDA devices.
"""
import torch

from .framework.compiler import CompiledProgram
from .framework.executor import Executor
from .framework.place import CPUPlace, CUDAPlace
from .framework.program import default_main_program


class ParallelExecutor(object):
    def __init__(self, use_cuda=True, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None,
                 build_strategy=None, num_trainers=1, trainer_id=0,
                 scope=None):
        self._program = main_program or default_main_program()
        self._compiled = CompiledProgram(
            self._program, build_strategy).with_data_parallel(
                loss_name=loss_name, exec_strategy=exec_strategy)
        self._exe = Executor(CUDAPlace(0) if use_cuda else CPUPlace())
        self._scope = scope

    def run(self, fetch_list, feed=None, feed_dict=None, return_numpy=True):
        feed = feed if feed is not None else feed_dict
        return self._exe.run(self._compiled, feed=feed,
                             fetch_list=fetch_list, scope=self._scope,
                             return_numpy=return_numpy)

    @property
    def device_count(self):
        return torch.cuda.device_count() if torch.cuda.is_available() \
            else 0


__all__ = ["ParallelExecutor"]
