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
BERT-base and GPT-base: ``optimizer.Adam(lr).minimize(loss)`` (or AdamW,
Lamb, Momentum and the other optimizers, with a ``regularizer``, a
``clip`` and a ``layers`` learning-rate schedule) appends the backward
and update ops, and ``Executor.run(main, feed, fetch_list)`` takes one
step (``models.bert.bert_pretrain_program``,
``models.gpt.gpt_pretrain_program``), in f32 or bf16, with or without
recompute (``layers.recompute_segment``). The training state leaves
and comes back through ``io.save_checkpoint``/``io.load_checkpoint``
(the whole scope) or ``save_persistables``/``load_persistables``, and
``optimizer.ExponentialMovingAverage``, ``ModelAverage`` and
``LookaheadOptimizer`` wrap the update. The recurrent sequence models
train the same way (``models.sequence_labeling.bigru_crf_program``,
LAC's BiGRU-CRF with its Viterbi decode, and ``models.ocr.
crnn_ctc_program``, CRNN-CTC), on ``contrib.layers.basic_gru``.
Training is fed three more ways, as Paddle 1.6 scripts feed it: a
``dataset`` (``DatasetFactory().create_dataset("InMemoryDataset")`` over
record files or MultiSlot text, read by the C++ data plane in
``native``, with ``set_length_buckets``) through
``Executor.train_from_dataset``; a started ``layers.py_reader`` with
``Executor.run`` and no feed; or ``reader.DataLoader.from_generator``.
A fluid script's front door, ``CompiledProgram(main).with_data_parallel(
loss_name=..., build_strategy=BuildStrategy(...))`` (and
``ParallelExecutor``), runs on one card with the numeric guard
(``check_numerics``, ``numeric_policy`` raise / skip / rewind); training
survives faults through ``framework.resilience.ResilientTrainer``
(checkpoint, restore, replay) with the failpoint plane
(``framework.faultinject``) and the step watchdog
(``framework.watchdog``). ``paddle_tpu_torch.fluid`` aliases the
package. Dygraph (eager) mode is ``dygraph``: under ``dygraph.guard()``
(``CUDAPlace(0)`` unless ``CPUPlace()`` is passed) the ``dygraph.nn``
Layers and the static layer functions run at once, ``loss.backward()``
is torch's autograd and ``dygraph.optimizers`` update in place (fused
Adam on the card); ``dygraph.TracedLayer`` replays a forward from a CUDA
graph. The dense op library (reductions, gathers and scatters, the
losses, the sequence ops), the static layers over it and ``nets`` build
the Paddle Book's chapters, fed from ``dataset``'s corpora
(``uci_housing``, ``mnist``, ``cifar``, ``imikolov``, ``imdb``,
``movielens``, ``conll05``, ``wmt14``). An f32 program trains in bf16, or
in fp16 with dynamic loss scaling, through
``contrib.mixed_precision.decorate(optimizer, dtype=...)``; ``metrics``,
``evaluator``, ``average``, ``profiler``, ``contrib.Trainer`` /
``Inferencer`` and the ``contrib`` statistics (``summary``,
``memory_usage``, ``op_freq_statistic``) follow fluid's;
``contrib.slim`` (quant-aware training, pruning, distillation, the
Compressor, the NAS searcher) and ``contrib.quantize`` (int8 model files)
compress a program. The rest of
fluid's top-level surface is here too: ``core``, the place helpers
(``cuda_places`` lists torch's CUDA devices), ``lod_tensor``,
``debugger``, ``install_check.run_check``, the module-path aliases
(``backward``, ``executor``, ``unique_name``, ``op``, ``graphviz``,
``inferencer``) and ``utils``; ``tools.progcheck`` and
``tools.serving_probe`` vet a saved model and a serving artifact from
the command line. ``distributed`` holds the mesh's host bookkeeping
that the pod coordinators (``framework.coordination``) drive on one
card; ``transpiler`` (``DistributeTranspiler`` returns the same
Program, ``memory_optimize`` records the request) and the
parameter-server stubs keep the fluid scripts' calls working;
multi-device meshes, the fleet API and ``make_mesh`` are later slices
(see ROADMAP.md).
"""
from . import ops            # registers all op kernels
from .framework import (Program, Variable, Parameter, default_main_program,
                        default_startup_program, program_guard, name_scope,
                        CUDAPlace, CPUPlace, NoCUDADeviceError, Scope,
                        global_scope, scope_guard, Executor,
                        CompiledProgram, BuildStrategy, ExecutionStrategy,
                        unique_name, is_compiled_with_cuda)
from .ops.registry import NotPortedError
from .param_attr import ParamAttr, WeightNormParamAttr
from . import initializer
from . import layers
from . import nets
from . import contrib
from . import regularizer
from . import clip
from . import optimizer
from .framework.backward import append_backward, gradients
from . import io
from .io import (save_params, save_persistables, load_params,
                 load_persistables, save_inference_model,
                 load_inference_model, set_params_from_numpy)
from . import inference
from . import native
from . import reader
from .reader.decorator import batch  # paddle.batch
from .data_feeder import DataFeeder
from . import dataset
from .dataset import DatasetFactory
from . import incubate
from .data import data  # fluid.data: the full shape, None dims
from .data_feed_desc import DataFeedDesc
from .parallel_executor import ParallelExecutor
from . import transpiler
from .transpiler import (DistributeTranspiler, DistributeTranspilerConfig,
                         memory_optimize, release_memory)
from . import compiler
from . import distributed
from . import dygraph
from . import metrics
from . import evaluator
from . import average
from . import profiler
from . import utils
from . import debugger
from . import lod_tensor as lod_tensor_mod
from .lod_tensor import (LoDTensor, create_lod_tensor,  # noqa: F401
                         create_random_int_lodtensor)
from .input import one_hot, embedding  # noqa: F401
from . import core
from .core import CUDAPinnedPlace  # noqa: F401

# the JAX package's accelerator place; the port's accelerator is a CUDA
# card (tpu_places below lists the same places)
TPUPlace = CUDAPlace
from .install_check import run_check  # noqa: F401

__version__ = "0.1.0"


def cuda_places(device_ids=None):
    """ref framework.cuda_places: ``CUDAPlace(i)`` for each of torch's
    CUDA devices (or ``device_ids``); NoCUDADeviceError when torch sees
    none (pass ``cpu_places()`` for the CPU)."""
    n = core.get_cuda_device_count()
    if n == 0:
        raise NoCUDADeviceError(
            "cuda_places: torch sees no CUDA device; use cpu_places() to "
            "run on the CPU")
    ids = range(n) if device_ids is None else device_ids
    return [CUDAPlace(i) for i in ids]


def tpu_places(device_ids=None):
    """The JAX package's accelerator places; the port's accelerator is a
    CUDA card, so these are ``cuda_places``."""
    return cuda_places(device_ids)


def cpu_places(device_count=None):
    return [CPUPlace()]


def in_dygraph_mode():
    """ref framework.in_dygraph_mode."""
    return dygraph.enabled()


def cuda_pinned_places(device_count=None):
    """ref framework.cuda_pinned_places — host staging is plain host
    memory; returns CPU places."""
    return [CPUPlace()] * (device_count or 1)


def require_version(min_version, max_version=None):
    """ref framework.require_version, against paddle_tpu_torch's
    version."""
    def parse(v):
        return [int(x) for x in str(v).split(".") if x.isdigit()]
    cur = parse(__version__)
    if parse(min_version) > cur:
        raise Exception(
            "paddle_tpu_torch version %s is below required %s" %
            (__version__, min_version))
    if max_version is not None and parse(max_version) < cur:
        raise Exception(
            "paddle_tpu_torch version %s is above allowed %s" %
            (__version__, max_version))


def load_op_library(lib_path):
    """ref framework.load_op_library (a custom C++/CUDA op .so). A custom
    op here is a torch kernel: register it with
    paddle_tpu_torch.ops.registry.register_op instead."""
    raise NotImplementedError(
        "load_op_library loads a compiled op library; on paddle_tpu_torch "
        "register a torch kernel via paddle_tpu_torch.ops.registry."
        "register_op (see ops/registry.py's docstring)")


# `import paddle_tpu_torch; paddle_tpu_torch.fluid.layers...` — the
# reference's paddle.fluid spelling, aliased onto this package
from . import fluid  # noqa: E402,F401

# deep reference module paths registered as virtual re-export modules
from . import _compat_submodules  # noqa: E402
_compat_submodules.install()
