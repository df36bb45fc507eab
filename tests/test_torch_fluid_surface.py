"""The rest of fluid's top-level surface in the port against the JAX
package: ``core``, the place helpers, ``lod_tensor``, ``debugger``,
``compat``, ``annotations``, ``default_scope_funcs``, the module-path
aliases and ``_compat_submodules``, ``WeightNormParamAttr``,
``layers.{layer_function_generator,math_op_patch,device}``,
``install_check.run_check`` and ``utils``. Each entry point that touches
a device defaults to CUDAPlace(0) and raises NoCUDADeviceError without a
card (the ``no_cuda`` fixture, as tests/test_torch_isolation.py);
``CPUPlace()`` runs it here. Pure helpers give the JAX package's answers
on the same inputs.
"""
import io
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LATER_SLICES = {"transpiler", "DistributeTranspiler",
                "DistributeTranspilerConfig", "memory_optimize",
                "release_memory", "make_mesh"}
NEW_MODULES = (
    "core", "install_check", "lod_tensor", "debugger", "input",
    "annotations", "default_scope_funcs", "compat", "backward", "executor",
    "unique_name", "op", "graphviz", "inferencer", "_compat_submodules",
    "layers.device", "layers.math_op_patch",
    "layers.layer_function_generator", "layers.extras", "layers.vision",
    "ops.extras_ops", "ops.vision_ops", "utils", "utils.image_util",
    "utils.plot", "utils.plotcurve", "utils.preprocess_img",
    "utils.preprocess_util", "utils.show_pb", "utils.torch2paddle",
    "dataset.image", "dataset.flowers", "dataset.wmt16",
    "dataset.sentiment", "dataset.mq2007", "tools", "tools.progcheck",
    "tools.serving_probe")


@pytest.fixture
def no_cuda(monkeypatch):
    """A machine without a CUDA device, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture
def two_cards(monkeypatch):
    """torch reporting two CUDA devices (places only: nothing runs)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)


def test_the_new_modules_import_neither_jax_nor_paddle_tpu():
    code = ("import sys\n" +
            "".join("import paddle_tpu_torch.%s\n" % m for m in NEW_MODULES)
            + "import paddle_tpu_torch.contrib.mixed_precision.decorator\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'paddle_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _bound_by_init(path):
    """The public names a package's ``__init__.py`` binds (imports,
    definitions, assignments): what it exports, whatever other modules
    a process has imported since."""
    import ast
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}


def test_top_level_exports_match_but_the_later_slices():
    public = _bound_by_init(os.path.join(ROOT, "paddle_tpu", "__init__.py"))
    port = {n for n in dir(ptt) if not n.startswith("_")}
    assert public - port == LATER_SLICES
    assert not LATER_SLICES & port
    for name in ("debugger", "utils", "LoDTensor", "create_lod_tensor",
                 "create_random_int_lodtensor", "lod_tensor_mod",
                 "one_hot", "embedding", "CUDAPinnedPlace", "run_check",
                 "WeightNormParamAttr", "name_scope", "fluid"):
        assert hasattr(ptt, name), name
    assert ptt.__version__ == pt.__version__


# ---- core and places --------------------------------------------------------

def test_core(no_cuda):
    from paddle_tpu_torch import core
    assert core.CUDAPlace is ptt.CUDAPlace is ptt.framework.CUDAPlace
    assert core.CUDAPinnedPlace is ptt.CPUPlace is ptt.CUDAPinnedPlace
    # one answer for both spellings: the port is built for CUDA
    assert core.is_compiled_with_cuda is ptt.is_compiled_with_cuda
    assert core.is_compiled_with_cuda() is True
    assert core.get_cuda_device_count() == 0
    arr = core.LoDTensorArray()
    arr.append(core.LoDTensor(np.ones((2, 3))))
    assert len(arr) == 1 and isinstance(core.Scope(), ptt.Scope)
    with pytest.raises(ptt.NoCUDADeviceError):
        core.CUDAPlace(0).torch_device()


def test_place_helpers_default_to_cuda_and_raise_without_it(no_cuda):
    with pytest.raises(ptt.NoCUDADeviceError, match="cpu_places"):
        ptt.cuda_places()
    with pytest.raises(ptt.NoCUDADeviceError):
        ptt.tpu_places()
    assert ptt.cpu_places() == [ptt.CPUPlace()]
    assert len(pt.cpu_places()) == 1
    assert ptt.cuda_pinned_places(3) == [ptt.CPUPlace()] * 3
    assert not ptt.in_dygraph_mode()
    with ptt.dygraph.guard(ptt.CPUPlace()):
        assert ptt.in_dygraph_mode()


def test_cuda_places_list_torchs_devices(two_cards):
    assert ptt.cuda_places() == [ptt.CUDAPlace(0), ptt.CUDAPlace(1)]
    assert ptt.cuda_places([1]) == [ptt.CUDAPlace(1)]
    assert ptt.tpu_places() == ptt.cuda_places()
    from paddle_tpu_torch import core
    assert core.get_cuda_device_count() == 2
    from paddle_tpu_torch.layers import device
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert device.get_places() == ptt.cuda_places()
        assert device.get_places(1) == [ptt.CUDAPlace(0)]


def test_get_places_without_a_card(no_cuda, capsys):
    from paddle_tpu_torch.layers import device
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(ptt.NoCUDADeviceError):
            device.get_places()
        assert device.get_places(device_type="cpu") == [ptt.CPUPlace()]
    assert "deprecated" in capsys.readouterr().err


def test_require_version_and_load_op_library():
    ptt.require_version("0.0.1")
    ptt.require_version("0.1", "0.2")
    for bad in (("0.2",), ("0.0.1", "0.0.9")):
        with pytest.raises(Exception, match="version"):
            ptt.require_version(*bad)
        with pytest.raises(Exception, match="version"):
            pt.require_version(*bad)
    with pytest.raises(NotImplementedError, match="register_op"):
        ptt.load_op_library("custom.so")


def test_run_check_defaults_to_cuda_and_raises_without_it(no_cuda, capsys):
    with pytest.raises(ptt.NoCUDADeviceError):
        ptt.run_check()
    assert ptt.run_check(place=ptt.CPUPlace()) is True
    assert "works well on cpu" in capsys.readouterr().out


# ---- lod_tensor, debugger, compat, annotations, scopes ----------------------

def test_lod_tensor_matches_the_jax_package():
    rows = [np.arange(3), np.arange(5) + 10, np.arange(2) + 20]
    for mod in (ptt, pt):
        t = mod.create_lod_tensor(rows, [[3, 5, 2]])
        assert t.recursive_sequence_lengths() == [[3, 5, 2]]
        assert t.lod() == [[0, 3, 8, 10]]
    t = ptt.create_lod_tensor(rows, [[3, 5, 2]])
    j = pt.create_lod_tensor(rows, [[3, 5, 2]])
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
    flat = np.arange(20, dtype=np.float32).reshape(10, 2)
    np.testing.assert_array_equal(
        np.asarray(ptt.create_lod_tensor(flat, [[2, 3], [4, 1, 2, 2, 1]])),
        np.asarray(pt.create_lod_tensor(flat, [[2, 3], [4, 1, 2, 2, 1]])))
    np.random.seed(3)
    a = ptt.create_random_int_lodtensor([[2, 4]], [3], low=0, high=5)
    np.random.seed(3)
    b = pt.create_random_int_lodtensor([[2, 4]], [3], low=0, high=5)
    np.testing.assert_array_equal(a.data, b.data)
    e = ptt.LoDTensor().set(np.ones((2, 4)), ptt.CPUPlace())
    assert e.recursive_sequence_lengths() == [[4, 4]]
    e.set_lod([[0, 1, 4]])
    assert e.recursive_sequence_lengths() == [[1, 3]]


def _mlp(pkg):
    main, start = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, start):
        x = pkg.layers.data("x", [4])
        pkg.layers.fc(pkg.layers.fc(x, 3, act="relu"), 2)
    return main


def test_debugger_draws_the_jax_packages_graph(tmp_path, capsys):
    from paddle_tpu import debugger as jdbg
    from paddle_tpu_torch import debugger, graphviz
    tmain, jmain = _mlp(ptt), _mlp(pt)
    path = str(tmp_path / "g.dot")
    text = debugger.draw_program(tmain, path=path, highlights=["x"])
    assert text == jdbg.draw_program(jmain, highlights=["x"])
    with open(path) as f:
        assert f.read() == text
    assert text.startswith("digraph G {") and "mul" in text
    assert graphviz.draw_block_graphviz(tmain.global_block()) == \
        jdbg.draw_block_graphviz(jmain.global_block())
    debugger.pprint_program(tmain)
    assert "{mul}" in capsys.readouterr().out


def test_compat_matches_the_jax_package():
    from paddle_tpu import compat as jc
    from paddle_tpu_torch import compat as tc
    cases = [b"abc", "abc", 7, None, [b"a", 1], {b"k": b"v"}, {b"x"}]
    for c in cases:
        assert tc.to_text(c) == jc.to_text(c)
        assert tc.to_bytes(c) == jc.to_bytes(c)
    lst = [b"a", b"b"]
    assert tc.to_text(lst, inplace=True) is lst and lst == ["a", "b"]
    for x, d in ((2.5, 0), (-2.5, 0), (1.25, 1), (0.0, 0), (-0.35, 1)):
        assert tc.round(x, d) == jc.round(x, d)
    assert tc.floor_division(7, 2) == 3 and tc.long_type is int
    assert tc.get_exception_message(ValueError("e")) == "e"


def test_annotations_deprecated(capsys):
    from paddle_tpu_torch.annotations import deprecated

    @deprecated("1.0", "new_fn", "see docs")
    def old_fn(a):
        return a + 1

    with pytest.warns(DeprecationWarning, match="new_fn"):
        assert old_fn(1) == 2
    assert "see docs" in capsys.readouterr().err


def test_default_scope_funcs():
    from paddle_tpu_torch import default_scope_funcs as d
    assert d.get_cur_scope() is ptt.global_scope()
    d.enter_local_scope()
    local = d.get_cur_scope()
    assert local is not ptt.global_scope()
    d.var("t")
    assert local.has_var("t") and d.find_var("t") is None
    d.leave_local_scope()
    assert d.get_cur_scope() is ptt.global_scope()
    seen = []
    d.scoped_function(lambda: seen.append(d.get_cur_scope()))
    assert seen[0] is not ptt.global_scope()
    d.leave_local_scope()                   # never pops the global one
    assert d.get_cur_scope() is ptt.global_scope()


# ---- aliases, deep paths, param attrs, layer helpers ------------------------

def test_module_path_aliases():
    from paddle_tpu_torch import (backward, executor, graphviz, inferencer,
                                  op, unique_name)
    from paddle_tpu_torch.framework import backward as fb
    assert backward.append_backward is fb.append_backward
    assert backward.gradients is fb.gradients
    assert executor.Executor is ptt.Executor
    assert executor.scope_guard is ptt.scope_guard
    assert unique_name.generate is ptt.framework.unique_name.generate
    assert op.Operator is ptt.framework.Operator
    assert graphviz.draw_program is ptt.debugger.draw_program
    from paddle_tpu_torch.contrib.inferencer import Inferencer
    assert inferencer.Inferencer is Inferencer
    assert ptt.input.one_hot is ptt.layers.one_hot


def test_compat_submodules():
    from paddle_tpu_torch.contrib import extend_optimizer as eo
    from paddle_tpu_torch.contrib import mixed_precision as mp
    from paddle_tpu_torch.contrib.mixed_precision.decorator import (
        OptimizerWithMixedPrecision, decorate)
    from paddle_tpu_torch.contrib.mixed_precision.fp16_lists import (
        AutoMixedPrecisionLists)
    from paddle_tpu_torch.contrib.mixed_precision.fp16_utils import (
        AutoMixedPrecisionLists as L2)
    from paddle_tpu_torch.contrib.reader.distributed_reader import (
        distributed_batch_reader)
    from paddle_tpu_torch.contrib.extend_optimizer import (
        extend_optimizer_with_weight_decay as ew)
    assert decorate is mp.decorate and L2 is AutoMixedPrecisionLists
    assert OptimizerWithMixedPrecision is mp.OptimizerWithMixedPrecision
    assert ew.GradientMergeOptimizer is eo.GradientMergeOptimizer
    assert distributed_batch_reader is ptt.contrib.reader \
        .distributed_batch_reader
    import paddle_tpu_torch.fluid.contrib.mixed_precision.decorator as fd
    assert fd.decorate is mp.decorate
    # the slim and quantize deep paths resolve to the flat modules
    from paddle_tpu_torch.contrib import quantize as cq
    from paddle_tpu_torch.contrib import slim
    from paddle_tpu_torch.contrib.slim.prune.pruner import Pruner
    from paddle_tpu_torch.contrib.slim.prune.prune_strategy import (
        PruneHelper)
    from paddle_tpu_torch.contrib.slim.prune.auto_prune_strategy import (
        sensitivity)
    from paddle_tpu_torch.contrib.slim.core.compressor import (
        Compressor, Context)
    from paddle_tpu_torch.contrib.slim.core import strategy, config
    from paddle_tpu_torch.contrib.slim.distillation.distiller import (
        soft_label_loss)
    from paddle_tpu_torch.contrib.slim.distillation.distillation_strategy \
        import merge
    from paddle_tpu_torch.contrib.quantize.quantize_transpiler import (
        save_quantized_inference_model)
    assert Pruner is slim.prune.Pruner and PruneHelper is slim.PruneHelper
    assert sensitivity is slim.sensitivity and merge is slim.merge
    assert Compressor is slim.Compressor and Context is slim.core.Context
    assert strategy.Compressor is config.Compressor is Compressor
    assert soft_label_loss is slim.soft_label_loss
    assert save_quantized_inference_model is \
        cq.save_quantized_inference_model
    for child in ("quantization_pass", "quantization_strategy",
                  "post_training_quantization"):
        mod = __import__("paddle_tpu_torch.contrib.slim.quantization."
                         + child, fromlist=["quant_aware"])
        assert mod.quant_aware is slim.quant_aware
        assert mod.convert is slim.convert
    for child in ("quantization_mkldnn_pass",
                  "mkldnn_post_training_strategy"):
        mod = __import__("paddle_tpu_torch.contrib.slim.quantization."
                         + child, fromlist=["x"])
        with pytest.raises(NotImplementedError, match="quant_aware"):
            mod.QuantInt8MkldnnPass
    import paddle_tpu_torch.fluid.contrib.slim.prune.pruner as fpr
    assert fpr.Pruner is Pruner
    # the parameter-server deep paths come with the torch.distributed
    # slice
    with pytest.raises(ImportError):
        __import__("paddle_tpu_torch.incubate.fleet.parameter_server."
                   "distribute_transpiler")


def test_weight_norm_param_attr():
    attr = ptt.WeightNormParamAttr(name="w", learning_rate=0.5)
    assert isinstance(attr, ptt.ParamAttr) and attr.name == "w"
    assert pt.WeightNormParamAttr is pt.ParamAttr
    assert ptt.param_attr.WeightNormParamAttr is ptt.ParamAttr


def test_layer_function_generator_runs_as_the_jax_package():
    from test_torch_resnet import run_pair
    from paddle_tpu.layers import layer_function_generator as jg
    from paddle_tpu_torch.layers import layer_function_generator as tg

    def build(p):
        g = jg if p is pt else tg
        x = p.layers.data("x", [3, 4], append_batch_size=False)
        return [g.generate_layer_fn("softsign")(x),
                g.generate_activation_fn("relu")(x),
                g.generate_layer_fn("scale")(x, scale=2.0, bias=1.0)]
    run_pair(build, [{"x": np.random.RandomState(0).randn(3, 4).astype(
        np.float32)}])
    with pytest.raises(NotImplementedError):
        tg.generate_layer_fn("no_such_op")

    @tg.autodoc("doc. ")
    @tg.templatedoc()
    def f():
        """body"""
    assert f.__doc__ == "doc. body"
    with pytest.warns(DeprecationWarning):
        tg.deprecated(lambda: 1)()


def test_math_op_patch():
    from paddle_tpu_torch.layers import math_op_patch
    math_op_patch.monkey_patch_variable()


# ---- utils ------------------------------------------------------------------

def test_utils_image_util_matches_the_jax_package():
    from paddle_tpu.utils import image_util as ju
    from paddle_tpu_torch.utils import image_util as tu
    im = np.random.RandomState(1).randint(0, 256, (20, 14, 3)).astype(
        np.uint8)
    np.testing.assert_array_equal(tu.resize_image(im, 10),
                                  ju.resize_image(im, 10))
    np.testing.assert_array_equal(tu.flip(im), ju.flip(im))
    np.testing.assert_array_equal(tu.oversample([im], (8, 6)),
                                  ju.oversample([im], (8, 6)))
    for train in (False, True):
        np.random.seed(2)
        a = tu.preprocess_img(im, [1.0, 2.0, 3.0], 8, train)
        np.random.seed(2)
        b = ju.preprocess_img(im, [1.0, 2.0, 3.0], 8, train)
        np.testing.assert_array_equal(a, b)
    for mod in (tu, ju):
        t = mod.ImageTransformer(transpose=(2, 0, 1), channel_swap=[2, 1, 0],
                                 mean=[1.0, 2.0, 3.0])
        if mod is tu:
            got = t.transformer(im)
        else:
            np.testing.assert_array_equal(got, t.transformer(im))


def test_utils_plot_and_plotcurve(tmp_path, capsys):
    from paddle_tpu.utils import plotcurve as jpc
    from paddle_tpu_torch.utils import plotcurve, plot
    p = plot.Ploter("train", "test")
    p.append("train", 1, 0.5)
    p.append("test", 1, 0.7)
    assert p.data["train"].value == [0.5]
    p.plot(str(tmp_path / "curve.png"))     # matplotlib when there is one
    p.reset()
    assert p.data["test"].step == []
    lines = ["step 1: loss=[0.5] acc=0.1", "loss = 0.25", "other=3"]
    assert plotcurve.extract_curve(["loss", "acc"], lines) == \
        jpc.extract_curve(["loss", "acc"], lines)
    assert "train - step 1: 0.5" in capsys.readouterr().out


def test_utils_preprocess_util(tmp_path):
    from paddle_tpu_torch.utils import preprocess_util as pu
    for split in ("train", "test"):
        for cls in ("b_cls", "a_cls"):
            d = tmp_path / split / cls
            d.mkdir(parents=True)
            (d / "x.png").write_bytes(b"")
            (d / ".hidden.png").write_bytes(b"")
    assert pu.get_label_set_from_dir(str(tmp_path / "train")) == \
        {"a_cls": 0, "b_cls": 1}
    assert pu.list_images(str(tmp_path / "train" / "a_cls")) == ["x.png"]

    class Creater(pu.DatasetCreater):
        def create_dataset_from_dir(self, path, label_set=None):
            return pu.Dataset([(cls, label_set[cls])
                               for cls in pu.list_dirs(path)],
                              ["image", "label"])
    out = Creater(str(tmp_path)).create_batches()
    assert sorted(os.listdir(out)) == ["labels.pkl", "test.list",
                                       "test_batch_000", "train.list",
                                       "train_batch_000"]
    ds = pu.Dataset([(1, 0), (2, 1)], ["x", "label"])
    assert ds.check_valid() and len(ds.permute(seed=1)) == 2


def test_utils_show_pb_prints_a_saved_model(tmp_path):
    from paddle_tpu.utils import show_pb as jshow
    from paddle_tpu_torch.utils import show_pb
    d = str(tmp_path / "m")
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    main2, start2 = ptt.Program(), ptt.Program()
    with ptt.unique_name.guard(), ptt.program_guard(main2, start2):
        y = ptt.layers.fc(ptt.layers.data("x", [4]), 2)
    exe.run(start2, scope=scope)
    with ptt.scope_guard(scope):
        ptt.save_inference_model(d, ["x"], [y], exe, main_program=main2)
    got, want = io.StringIO(), io.StringIO()
    show_pb.show(d, out=got)
    jshow.show(d, out=want)
    assert got.getvalue() == want.getvalue()
    assert "Inference artifact" in got.getvalue()
    with pytest.raises(NotImplementedError, match="JSON"):
        show_pb.read_proto("x")


def test_torch2paddle_maps_a_state_dict_as_the_jax_package(tmp_path):
    from paddle_tpu.utils import torch2paddle as jt2p
    from paddle_tpu_torch.utils import torch2paddle as t2p
    lin = torch.nn.Linear(4, 3)
    sq = torch.nn.Linear(3, 3)
    sd = {"l.weight": lin.weight, "l.bias": lin.bias, "s.weight": sq.weight}
    name_map = {"l.weight": "fc_w", "l.bias": "fc_b", "s.weight": "sq_w"}
    shapes = {"fc_w": (4, 3), "fc_b": (3,), "sq_w": (3, 3)}
    tscope, jscope = ptt.Scope(), pt.Scope()
    for n, s in shapes.items():
        tscope.set_var(n, torch.zeros(s))
        jscope.set_var(n, np.zeros(s, np.float32))
    for mod, scope in ((t2p, tscope), (jt2p, jscope)):
        with pytest.raises(ValueError, match="ambiguous"):
            mod.load_torch_parameters(scope, sd, name_map)
        assert mod.load_torch_parameters(
            scope, sd, name_map, transpose_names=["s.weight"]) == \
            ["fc_w", "fc_b", "sq_w"]
    for n in shapes:
        np.testing.assert_array_equal(tscope.find_var(n).numpy(),
                                      np.asarray(jscope.find_var(n)))
    np.testing.assert_array_equal(tscope.find_var("fc_w").numpy(),
                                  lin.weight.detach().numpy().T)
    with pytest.raises(KeyError):
        t2p.load_torch_parameters(tscope, sd, {"nope": "fc_w"})
    main, start = ptt.Program(), ptt.Program()
    with ptt.unique_name.guard(), ptt.program_guard(main, start):
        ptt.layers.fc(ptt.layers.data("x", [4]), 3)
    w, b = [v.name for v in main.all_parameters()]
    d = str(tmp_path / "params")
    assert t2p.save_net_parameters(sd, {"l.weight": w, "l.bias": b}, d,
                                   transpose_names=["l.weight"]) == \
        sorted([w, b])
    with ptt.scope_guard(ptt.Scope()):
        exe = ptt.Executor(ptt.CPUPlace())
        exe.run(start)
        ptt.load_params(exe, d, main_program=main)
        np.testing.assert_array_equal(
            ptt.global_scope().find_var(w).numpy(),
            lin.weight.detach().numpy().T)
