"""The port stands alone: no jax, no paddle_tpu, no silent CPU.

paddle_tpu_torch and chip_smoke.py must import neither jax nor anything
of the JAX package (matched by exact module name: ``paddle_tpu_torch``
itself begins with the string ``paddle_tpu``), and the port's entry
points must run on CUDAPlace(0) unless the caller passes CPUPlace(),
raising a named error when there is no CUDA device.
"""
import ast
import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch import inference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "paddle_tpu")


def _forbidden(module):
    return module.split(".")[0] in FORBIDDEN


def _imports(path):
    """Absolute module names a file imports (import, from-import,
    __import__ / importlib.import_module with a literal name)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str) and \
                getattr(node.func, "id", getattr(node.func, "attr", None)) \
                in ("__import__", "import_module"):
            yield node.args[0].value


def _port_files():
    files = glob.glob(os.path.join(ROOT, "paddle_tpu_torch", "**", "*.py"),
                      recursive=True)
    return sorted(files) + [os.path.join(ROOT, "chip_smoke.py"),
                            os.path.join(ROOT, "tools", "port_kernel_ab.py")]


def test_exact_module_matching():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("paddle_tpu") and _forbidden("paddle_tpu.ops.registry")
    assert not _forbidden("paddle_tpu_torch")
    assert not _forbidden("paddle_tpu_torch.ops")
    assert not _forbidden("jaxlib_like_name") and not _forbidden("numpy")


def test_no_port_file_imports_jax_or_paddle_tpu():
    files = _port_files()
    assert len(files) > 20
    bad = [(os.path.relpath(p, ROOT), m) for p in files
           for m in _imports(p) if _forbidden(m)]
    assert bad == []


def test_importing_the_port_loads_neither_jax_nor_paddle_tpu():
    code = ("import sys\n"
            "import paddle_tpu_torch, paddle_tpu_torch.inference\n"
            "import paddle_tpu_torch.models.bert\n"
            "import paddle_tpu_torch.models.gpt\n"
            "import paddle_tpu_torch.models.resnet\n"
            "import paddle_tpu_torch.models.deepfm\n"
            "import paddle_tpu_torch.models.transformer\n"
            "import paddle_tpu_torch.ops.nn_ops\n"
            "import paddle_tpu_torch.ops.metric_ops\n"
            "import paddle_tpu_torch.layers.control_flow\n"
            "import paddle_tpu_torch.layers.learning_rate_scheduler\n"
            "import paddle_tpu_torch.regularizer, paddle_tpu_torch.clip\n"
            "import paddle_tpu_torch.optimizer\n"
            "import paddle_tpu_torch.ops.optimizer_ops\n"
            "import paddle_tpu_torch.ops.math_ops\n"
            "import paddle_tpu_torch.ops.tensor_ops\n"
            "import paddle_tpu_torch.ops.kernels.fused_adam\n"
            "import paddle_tpu_torch.ops.control_flow_ops\n"
            "import paddle_tpu_torch.ops.kernels.blockwise_ce\n"
            "import paddle_tpu_torch.ops.kernels.build\n"
            "import paddle_tpu_torch.ops.kernels\n"
            "import paddle_tpu_torch.framework.compiled_step\n"
            "import paddle_tpu_torch.framework.executor\n"
            "import paddle_tpu_torch.io\n"
            "import paddle_tpu_torch.ops.quant_ops\n"
            "import paddle_tpu_torch.ops.rnn_ops\n"
            "import paddle_tpu_torch.ops.crf_ops\n"
            "import paddle_tpu_torch.ops.sequence_ops\n"
            "import paddle_tpu_torch.layers.rnn\n"
            "import paddle_tpu_torch.layers.sequence_lod\n"
            "import paddle_tpu_torch.layers.vision\n"
            "import paddle_tpu_torch.contrib.layers.rnn_impl\n"
            "import paddle_tpu_torch.models.sequence_labeling\n"
            "import paddle_tpu_torch.models.ocr\n"
            "import paddle_tpu_torch.native, paddle_tpu_torch.native.build\n"
            "import paddle_tpu_torch.native.recordio\n"
            "import paddle_tpu_torch.native.multislot\n"
            "import paddle_tpu_torch.dataset, paddle_tpu_torch.dataset."
            "dataset_api\n"
            "import paddle_tpu_torch.reader, paddle_tpu_torch.reader."
            "decorator\n"
            "import paddle_tpu_torch.reader.dataloader\n"
            "import paddle_tpu_torch.incubate.data_generator\n"
            "import paddle_tpu_torch.trainer_factory\n"
            "import paddle_tpu_torch.trainer_desc\n"
            "import paddle_tpu_torch.device_worker\n"
            "import paddle_tpu_torch.data_feed_desc\n"
            "import paddle_tpu_torch.data_feeder\n"
            "import paddle_tpu_torch.batch, paddle_tpu_torch.data\n"
            "import paddle_tpu_torch.layers.io\n"
            "import paddle_tpu_torch.layers.rnn_api\n"
            "import paddle_tpu_torch.contrib.decoder\n"
            "import paddle_tpu_torch.contrib.decoder.beam_search_decoder\n"
            "import paddle_tpu_torch.ops.detection_ops\n"
            "import paddle_tpu_torch.ops.detection_train_ops\n"
            "import paddle_tpu_torch.contrib.layers.nn\n"
            "import paddle_tpu_torch.dataset.voc2012\n"
            "import paddle_tpu_torch.contrib.slim.qat\n"
            "import paddle_tpu_torch.contrib.slim.quantization\n"
            "import paddle_tpu_torch.contrib.slim.distillation\n"
            "import paddle_tpu_torch.contrib.slim.prune.pruner\n"
            "import paddle_tpu_torch.contrib.slim.graph\n"
            "import paddle_tpu_torch.contrib.slim.nas\n"
            "import paddle_tpu_torch.contrib.slim.searcher\n"
            "import paddle_tpu_torch.contrib.quantize\n"
            "import paddle_tpu_torch.contrib.utils\n"
            "import paddle_tpu_torch.layers.detection\n"
            "import paddle_tpu_torch.layers.loss\n"
            "import paddle_tpu_torch.models.simple\n"
            "import paddle_tpu_torch.models.vision\n"
            "import paddle_tpu_torch.models.dcgan\n"
            "import paddle_tpu_torch.models.yolov3\n"
            "import paddle_tpu_torch.framework.compiler\n"
            "import paddle_tpu_torch.framework.watchdog\n"
            "import paddle_tpu_torch.framework.faultinject\n"
            "import paddle_tpu_torch.framework.resilience\n"
            "import paddle_tpu_torch.framework.coordination\n"
            "import paddle_tpu_torch.framework.buddy\n"
            "import paddle_tpu_torch.distributed\n"
            "import paddle_tpu_torch.distributed.mesh\n"
            "import paddle_tpu_torch.tools.traceview\n"
            "import paddle_tpu_torch.tools.op_coverage\n"
            "import paddle_tpu_torch.tools.serving_probe\n"
            "import paddle_tpu_torch.framework.guard\n"
            "import paddle_tpu_torch.ops.kernels.numeric_guard\n"
            "import paddle_tpu_torch.compiler\n"
            "import paddle_tpu_torch.parallel_executor\n"
            "import paddle_tpu_torch.fluid, paddle_tpu_torch.fluid.compiler\n"
            "import paddle_tpu_torch.dygraph, paddle_tpu_torch.dygraph.base\n"
            "import paddle_tpu_torch.dygraph.layers\n"
            "import paddle_tpu_torch.dygraph.container\n"
            "import paddle_tpu_torch.dygraph.nn\n"
            "import paddle_tpu_torch.dygraph.optimizers\n"
            "import paddle_tpu_torch.dygraph.grad_clip\n"
            "import paddle_tpu_torch.dygraph.learning_rate_scheduler\n"
            "import paddle_tpu_torch.dygraph.checkpoint\n"
            "import paddle_tpu_torch.dygraph.jit\n"
            "import paddle_tpu_torch.dygraph.parallel\n"
            "import paddle_tpu_torch.dygraph.parallel_helper\n"
            "import paddle_tpu_torch.dygraph.backward_strategy\n"
            "import paddle_tpu_torch.dygraph.tracer\n"
            "import paddle_tpu_torch.dygraph.dygraph_utils\n"
            "import paddle_tpu_torch.dygraph.layer_object_helper\n"
            "import paddle_tpu_torch.dygraph.math_op_patch\n"
            "import paddle_tpu_torch.dygraph.varbase_patch_methods\n"
            "import paddle_tpu_torch.dygraph.profiler\n"
            "import paddle_tpu_torch.dygraph_grad_clip\n"
            "import paddle_tpu_torch.fluid.dygraph\n"
            "import paddle_tpu_torch.ops.vision_ops\n"
            "import paddle_tpu_torch.ops.misc_ops\n"
            "import paddle_tpu_torch.ops.loss_extra_ops\n"
            "import paddle_tpu_torch.ops.contrib_ops\n"
            "import paddle_tpu_torch.contrib.mixed_precision\n"
            "import paddle_tpu_torch.contrib.extend_optimizer\n"
            "import paddle_tpu_torch.contrib.layers.metric_op\n"
            "import paddle_tpu_torch.contrib.trainer\n"
            "import paddle_tpu_torch.contrib.inferencer\n"
            "import paddle_tpu_torch.contrib.reader\n"
            "import paddle_tpu_torch.contrib.model_stat\n"
            "import paddle_tpu_torch.contrib.memory_usage_calc\n"
            "import paddle_tpu_torch.contrib.op_frequence\n"
            "import paddle_tpu_torch.metrics, paddle_tpu_torch.evaluator\n"
            "import paddle_tpu_torch.average, paddle_tpu_torch.profiler\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'paddle_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    """A machine without a CUDA device, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_executor_defaults_to_cuda_and_raises_without_it(no_cuda):
    assert ptt.is_compiled_with_cuda()
    assert ptt.framework._current_expected_place() == ptt.CUDAPlace(0)
    with pytest.raises(ptt.NoCUDADeviceError, match="CPUPlace"):
        ptt.Executor()
    with pytest.raises(ptt.NoCUDADeviceError):
        ptt.Executor(ptt.CUDAPlace(0))
    assert ptt.Executor(ptt.CPUPlace()).device == torch.device("cpu")


def test_predictor_defaults_to_cuda_and_raises_without_it(no_cuda, tmp_path):
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = ptt.layers.data("x", [4])
        y = ptt.layers.fc(x, 3)
    with ptt.scope_guard(ptt.Scope()):
        exe = ptt.Executor(ptt.CPUPlace())
        exe.run(startup)
        ptt.save_inference_model(str(tmp_path), ["x"], [y], exe,
                                 main_program=main)
    config = inference.Config(str(tmp_path))
    assert config.place is None
    with pytest.raises(ptt.NoCUDADeviceError):
        inference.create_predictor(config)
    config.place = ptt.CPUPlace()
    out, = inference.create_predictor(config).run(
        {"x": torch.ones(3, 4).numpy()})
    assert out.shape == (3, 3)


def test_weights_default_to_cuda_and_raise_without_it(no_cuda):
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        ptt.layers.fc(ptt.layers.data("x", [4]), 3, bias_attr=False)
    w = main.all_parameters()[0]
    arrays = {w.name: torch.zeros(4, 3).numpy()}
    with pytest.raises(ptt.NoCUDADeviceError):
        ptt.set_params_from_numpy(arrays, main, ptt.Scope())


def test_recipe_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    """The optimizer slice's entry points only build ops; the program they
    build runs where its Executor runs: CUDAPlace(0) unless CPUPlace()
    is given."""
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = ptt.layers.data("x", [4])
        loss = ptt.layers.mean(ptt.layers.fc(x, 3))
        lr = ptt.layers.linear_lr_warmup(
            ptt.layers.polynomial_decay(0.1, 4), 2, 0.0, 0.1)
        ptt.optimizer.AdamW(lr, grad_clip=ptt.clip.GradientClipByGlobalNorm(
            1.0), regularization=ptt.regularizer.L2Decay(1e-4)).minimize(loss)
    with pytest.raises(ptt.NoCUDADeviceError):
        ptt.Executor().run(startup, scope=ptt.Scope())
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    out, = exe.run(main, feed={"x": torch.ones(2, 4).numpy()},
                   fetch_list=[lr], scope=scope)
    assert out.shape == (1,)


def test_control_flow_entry_points_default_to_cuda_and_raise_without_it(
        no_cuda):
    """The control-flow slice's layers only build ops: a program with a
    cond, a bounded while_loop and an rnn runs where its Executor runs,
    CUDAPlace(0) unless CPUPlace() is given."""
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        L = ptt.layers
        x = L.data("x", [2, 3, 4], append_batch_size=False)
        out, _ = L.rnn(L.GRUCell(4), x)
        s = L.reduce_sum(out)
        y = L.cond(L.greater_than(s, 0.0), lambda: L.scale(s, 2.0),
                   lambda: s)
        i0 = L.fill_constant([1], "float32", 0.0)
        _, z = L.while_loop(lambda i, v: L.less_than(i, 2.0),
                            lambda i, v: (L.scale(i, bias=1.0),
                                          L.scale(v, 0.5)),
                            [i0, y], maximum_trip_count=4)
    with pytest.raises(ptt.NoCUDADeviceError):
        ptt.Executor().run(startup, scope=ptt.Scope())
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    got, = exe.run(main, feed={"x": torch.ones(2, 3, 4).numpy()},
                   fetch_list=[z], scope=scope)
    assert got.shape == (1,)


@pytest.mark.parametrize("model", ["yolov3_infer", "dcgan", "vision", "mlp"])
def test_zoo_entry_points_default_to_cuda_and_raise_without_it(no_cuda,
                                                                model):
    """The zoo's builders only build programs: each runs where its
    Executor runs, CUDAPlace(0) unless CPUPlace() is given."""
    from paddle_tpu_torch.models import dcgan, simple, vision, yolov3
    if model == "yolov3_infer":
        main, startup, _, fetch = yolov3.yolov3_infer_program(
            class_num=2, image_size=32)
        feed = {"image": torch.ones(1, 3, 32, 32).numpy(),
                "im_size": torch.full((1, 2), 32, dtype=torch.int32).numpy()}
        fetch = [fetch["pred"]]
    elif model == "dcgan":
        cfg = dcgan.DCGANConfig(noise_dim=4, base_channels=2, image_size=4)
        main, startup, _, fetch = dcgan.dcgan_train_program(cfg)
        feed = dcgan.synthetic_batch(cfg, 2)
        fetch = [fetch["g_loss"]]
    elif model == "vision":
        main, startup, _, fetch = vision.classification_train_program(
            "mobilenet", class_dim=3, image_shape=(3, 32, 32))
        feed = vision.synthetic_image_batch(2, (3, 32, 32), 3)
        fetch = [fetch["loss"]]
    else:
        main, startup, _, fetch = simple.mlp_classifier_program(
            input_dim=4, hidden=(3,), classes=2)
        feed = {"x": torch.ones(2, 4).numpy(),
                "y": torch.zeros(2, 1, dtype=torch.int64).numpy()}
        fetch = [fetch["loss"]]
    with pytest.raises(ptt.NoCUDADeviceError):
        ptt.Executor().run(startup, scope=ptt.Scope())
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    got, = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    assert torch.isfinite(torch.from_numpy(got)).all()


def test_trainer_and_inferencer_default_to_cuda_and_raise_without_it(
        no_cuda, tmp_path):
    from paddle_tpu_torch.contrib import Inferencer, Trainer

    def predict():
        return ptt.layers.fc(ptt.layers.data("x", [4]), 1)

    def train_func():
        y = ptt.layers.data("y", [1])
        return [ptt.layers.mean(ptt.layers.square_error_cost(predict(), y))]
    with pytest.raises(ptt.NoCUDADeviceError):
        Trainer(train_func, lambda: ptt.optimizer.SGD(0.1))
    t = Trainer(train_func, lambda: ptt.optimizer.SGD(0.1),
                place=ptt.CPUPlace())
    assert t.exe.device == torch.device("cpu")
    t.save_params(str(tmp_path))
    with pytest.raises(ptt.NoCUDADeviceError):
        Inferencer(predict, str(tmp_path))
    inf = Inferencer(predict, str(tmp_path), place=ptt.CPUPlace())
    assert inf.exe.device == torch.device("cpu")


def test_a_decorated_program_defaults_to_cuda_and_raises_without_it(
        no_cuda):
    from paddle_tpu_torch.contrib import mixed_precision
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = ptt.layers.data("x", [4])
        loss = ptt.layers.mean(ptt.layers.fc(x, 3))
        mixed_precision.decorate(ptt.optimizer.SGD(0.1),
                                 dtype="float16").minimize(loss)
    with pytest.raises(ptt.NoCUDADeviceError):
        ptt.Executor().run(startup)
    with ptt.scope_guard(ptt.Scope()):
        exe = ptt.Executor(ptt.CPUPlace())
        exe.run(startup)
        out, = exe.run(main, feed={"x": np.ones((2, 4), np.float32)},
                       fetch_list=[loss])
    assert np.isfinite(out).all()
