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
The other models are later slices (see ROADMAP.md).
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

__version__ = "0.1.0"
