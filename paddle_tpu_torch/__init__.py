"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

The same fluid-compatible static-graph front end (Program/Block/Op IR,
``layers``, ``io``, ``inference``) over torch tensors, with the TPU's
Pallas kernels replaced by CUDA kernels written by hand for Hopper
(``ops/kernels/``). Entry points run on ``CUDAPlace(0)`` unless the
caller passes ``CPUPlace()``; without a CUDA device the default raises
``NoCUDADeviceError``.

Serving BERT-base: build with ``layers``, run the startup program,
``io.save_inference_model``, then
``inference.create_predictor(Config(dir)).run(requests)``. Training
BERT-base and GPT-base: ``optimizer.Adam(lr).minimize(loss)`` appends the
backward and update ops, and ``Executor.run(main, feed, fetch_list)``
takes one step (``models.bert.bert_pretrain_program``,
``models.gpt.gpt_pretrain_program``), in f32 or bf16, with or without
recompute (``layers.recompute_segment``). The other models are later
slices (see ROADMAP.md).
"""
from . import ops            # registers all op kernels
from .framework import (Program, Variable, Parameter, default_main_program,
                        default_startup_program, program_guard, CUDAPlace,
                        CPUPlace, NoCUDADeviceError, Scope, global_scope,
                        scope_guard, Executor, unique_name,
                        is_compiled_with_cuda)
from .ops.registry import NotPortedError
from .param_attr import ParamAttr
from . import initializer
from . import layers
from . import optimizer
from .framework.backward import append_backward, gradients
from . import io
from .io import (save_inference_model, load_inference_model,
                 set_params_from_numpy)
from . import inference

__version__ = "0.1.0"
