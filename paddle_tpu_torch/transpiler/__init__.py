"""Transpiler package (counterpart of paddle_tpu/transpiler/; ref
python/paddle/fluid/transpiler/__init__.py).

On the reference, transpilers rewrite the Program: DistributeTranspiler
splits it into trainer and pserver halves wired with send/recv ops, and
memory_optimization_transpiler renames vars to reuse buffers. In the
port both jobs belong elsewhere: data parallelism is a mesh of devices
under ``CompiledProgram`` (one card: ``{"dp": 1}``; more: the
torch.distributed slice), and buffer reuse is the Executor's (each
value freed after its last reader, a captured step's memory pool). So
this package keeps the fluid API as a thin adapter, as the JAX package
does: DistributeTranspiler returns the same Program, memory_optimize
records the request and leaves the Program unchanged.
"""
from .distribute_transpiler import (DistributeTranspiler,
                                    DistributeTranspilerConfig)
from .memory_optimization_transpiler import memory_optimize, release_memory
from .ps_dispatcher import HashName, RoundRobin, PSDispatcher

__all__ = [
    "DistributeTranspiler", "DistributeTranspilerConfig",
    "memory_optimize", "release_memory",
    "HashName", "RoundRobin", "PSDispatcher",
]
