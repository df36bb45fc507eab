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
