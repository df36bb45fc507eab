"""The rest of the model zoo, narrow, trained for three steps through both
packages from the same persistables: the port's startup (run on the CPU,
~1 s, where the JAX package's startup compiles each init op and takes
~20 s for tiny YOLOv3), copied into the JAX scope:
MobileNet v1 at scale 0.25 cut after three blocks, VGG-11, one
SE-ResNeXt bottleneck (the whole MobileNet, VGG-16 and SE-ResNeXt-50
programs compared op for op), tiny YOLOv3 at 64 x 64 (trained, then
served through the Predictor), the book's MLP and word2vec.

The classifiers train with Momentum(0.01, 0.9) on 32 x 32 images (SE:
16 x 16), the book models with Adam(1e-4) (at 1e-3 an element whose
gradient is near 0 moves by up to 2 * lr a step on a last-bit
difference, as Adam normalises it). VGG's dropout runs with
``is_test=True`` (the JAX package draws threefry masks, the port Philox
ones); batch norm trains as usual.

Tolerances: f32 on both sides; three steps through a few dozen
convolutions, batch norms and matmuls: losses rtol 1e-5, atol 1e-6;
final parameters, velocities, Adam moments and moving statistics rtol
1e-4, atol 1e-5 times the tensor's largest magnitude, at least 1
(batch norm divides by a batch standard deviation, so a 1e-7 difference
of a small variance grows, and a velocity sums gradients of thousands of
cells whose cancellation leaves small elements beside large ones). The served
YOLOv3: the pre-NMS boxes and scores rtol 1e-4, atol 1e-5 times the
largest magnitude (a box is exp of a raw logit times an anchor, in
pixels, some hundreds wide from random weights); the NMS output must
equal the JAX package's NMS run on the port's own pre-NMS tensors
exactly (a threshold decision is discontinuous, so two NMS runs of
inputs that differ by ulps are never compared).
"""
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.models import simple as jsimple
from paddle_tpu.models import vision as jvision
from paddle_tpu.models import yolov3 as jyolo
from paddle_tpu_torch.framework.scope import to_numpy
from paddle_tpu_torch.inference import Config, create_predictor
from paddle_tpu_torch.models import simple as tsimple
from paddle_tpu_torch.models import vision as tvision
from paddle_tpu_torch.models import yolov3 as tyolo

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
STATE_RTOL, STATE_ATOL = 1e-4, 1e-5
STEPS = 3


def _momentum(p):
    return lambda loss: p.optimizer.Momentum(0.01, 0.9).minimize(loss)


def _adam(p):
    return lambda loss: p.optimizer.Adam(1e-4).minimize(loss)


def _classifier(net, image=(3, 32, 32), classes=10):
    """(build, feeds) of a classifier ``net(pkg_vision, img, classes)``
    trained on cross_entropy of its softmax with Momentum."""
    def build(p, mod):
        main, startup = p.Program(), p.Program()
        with p.program_guard(main, startup):
            img = p.layers.data("image", list(image), "float32")
            label = p.layers.data("label", [1], "int64")
            prob = net(mod, img, classes)
            loss = p.layers.reduce_mean(p.layers.cross_entropy(prob, label))
            _momentum(p)(loss)
        return main, startup, [loss]
    feeds = [tvision.synthetic_image_batch(4, image, classes, seed=s)
             for s in range(STEPS)]
    return build, feeds


def _train_pair(build, feeds, jmod, tmod):
    """Train ``build(pkg, module)`` in both packages from the port's
    startup, its persistables copied into the JAX scope: every step's
    fetches and every final persistable compared. Returns the port's
    (main, scope) and the JAX scope."""
    with pt.unique_name.guard():
        jmain, _, jfetch = build(pt, jmod)
    with ptt.unique_name.guard():
        tmain, tstart, tfetch = build(ptt, tmod)
    assert [op.type for op in jmain.global_block().ops] == \
        [op.type for op in tmain.global_block().ops]
    names = sorted(v.name for v in jmain.list_vars() if v.persistable)
    assert names == sorted(v.name for v in tmain.list_vars()
                           if v.persistable)
    tscope, texe = ptt.Scope(), ptt.Executor(ptt.CPUPlace())
    texe.run(tstart, scope=tscope)
    jscope, jexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    for n in names:
        jscope.set_var(n, jnp.asarray(to_numpy(tscope.find_var(n))))
    for feed in feeds:
        with pt.scope_guard(jscope):
            jout = jexe.run(jmain, feed=feed, fetch_list=jfetch)
        tout = texe.run(tmain, feed=feed, fetch_list=tfetch, scope=tscope)
        for j, t in zip(jout, tout):
            assert np.isfinite(t).all()
            np.testing.assert_allclose(t, np.asarray(j), **LOSS_TOL)
    for n in names:
        want = np.asarray(jscope.find_var(n))
        np.testing.assert_allclose(
            to_numpy(tscope.find_var(n)), want, err_msg=n, rtol=STATE_RTOL,
            atol=STATE_ATOL * max(1.0, float(np.abs(want).max())))
    return (tmain, tscope), jscope


@pytest.mark.parametrize("arch", ["mobilenet_blocks", "vgg11",
                                  "se_bottleneck"])
def test_classifier_trains_like_the_jax_package(arch):
    """Three Momentum steps: losses, then every persistable."""
    nets = {
        "mobilenet_blocks": _mobilenet_head,
        "vgg11": lambda m, img, k: m.vgg_net(img, class_dim=k, layers_cfg=11,
                                             is_test=True),
        "se_bottleneck": lambda m, img, k: _se_head(m, img, k),
    }
    image = (3, 16, 16) if arch == "se_bottleneck" else (3, 32, 32)
    build, feeds = _classifier(nets[arch], image)
    _train_pair(build, feeds, jvision, tvision)


def _mobilenet_head(m, img, k):
    """MobileNet v1 at scale 0.25 cut after its third depthwise-separable
    block (a stride-2 one among them), then pooled into the softmax. The
    whole net at this batch is ill-conditioned for a three-step
    comparison: its batch-norm scale gradients are sums that cancel to
    ~1e-3 of their terms, so the packages' first gradients differ by up
    to 5e-3 of their largest there, and by the second Momentum step the
    losses part by 8e-4 (6% by the third); the blocks kept here agree
    to the stated tolerance."""
    y = m._conv_bn(img, 8, 3, stride=2)
    for ch_in, ch_out, stride in [(32, 64, 1), (64, 128, 2), (128, 128, 1)]:
        y = m._depthwise_separable(y, ch_in, ch_out, stride, 0.25)
    pool = m.layers.pool2d(y, pool_type="avg", global_pooling=True)
    return m.layers.fc(pool, size=k, act="softmax")


def _se_head(m, img, k):
    """One SE-ResNeXt bottleneck (32 groups, the squeeze-excitation and a
    projection shortcut) between a 3x3 stem and the pooled softmax."""
    y = m._conv_bn(img, 16, 3)
    y = m._se_bottleneck(y, 16, 64, stride=2, cardinality=32)
    pool = m.layers.pool2d(y, pool_type="avg", global_pooling=True)
    return m.layers.fc(pool, size=k, act="softmax")


@pytest.mark.parametrize("arch", ["se_resnext50", "vgg16", "mobilenet"])
def test_full_classifier_programs_match_op_for_op(arch):
    """The full-width programs (224 x 224, 1000 classes, Momentum) hold the
    same ops in the same order, with the same parameter names and
    shapes, as the JAX package's."""
    def build(p, mod):
        return mod.classification_train_program(
            arch, optimizer_fn=_momentum(p))[0]
    with pt.unique_name.guard():
        jmain = build(pt, jvision)
    with ptt.unique_name.guard():
        tmain = build(ptt, tvision)
    assert [(op.type, sorted(op.input_names()))
            for op in jmain.global_block().ops] == \
        [(op.type, sorted(op.input_names()))
         for op in tmain.global_block().ops]
    assert [(p.name, tuple(p.shape)) for p in jmain.all_parameters()] == \
        [(p.name, tuple(p.shape)) for p in tmain.all_parameters()]


@pytest.mark.parametrize("model", ["mlp", "word2vec"])
def test_book_models_train_like_the_jax_package(model):
    """The MLP (784-200-200-10) and CBOW word2vec (vocabulary 200, width
    16, window 2), three Adam(1e-4) steps each."""
    rng = np.random.RandomState(0)
    if model == "mlp":
        def build(p, mod):
            main, startup, _, fetch = mod.mlp_classifier_program(
                optimizer_fn=_adam(p))
            return main, startup, [fetch["loss"], fetch["acc"]]
        feeds = [{"x": rng.rand(8, 784).astype(np.float32),
                  "y": rng.randint(0, 10, (8, 1)).astype(np.int64)}
                 for _ in range(STEPS)]
    else:
        def build(p, mod):
            main, startup, _, fetch = mod.word2vec_program(
                vocab_size=200, emb_size=16, window=2,
                optimizer_fn=_adam(p))
            return main, startup, [fetch["loss"]]
        feeds = [{n: rng.randint(0, 200, (8, 1)).astype(np.int64)
                  for n in ["ctx_0", "ctx_1", "ctx_2", "ctx_3", "target"]}
                 for _ in range(STEPS)]
    _train_pair(build, feeds, jsimple, tsimple)


YOLO = dict(class_num=4, image_size=64, tiny=True)


def _yolo_train(p, mod):
    main, startup, _, fetch = mod.yolov3_train_program(
        max_box=6, optimizer_fn=lambda loss: p.optimizer.Momentum(
            0.001, 0.9, regularization=p.regularizer.L2Decay(5e-4)
        ).minimize(loss), **YOLO)
    return main, startup, [fetch["loss"]]


def test_tiny_yolov3_trains_and_serves_like_the_jax_package(tmp_path):
    """Three Momentum steps (L2 decay) of the summed three-scale loss,
    then the inference program with the trained weights, saved with
    save_inference_model and served through the Predictor on the CPU
    (batch 3 in bucket 4): the pre-NMS boxes and scores against the JAX
    package's, and the NMS output against the JAX package's NMS of the
    port's own pre-NMS tensors."""
    feeds = [tyolo.synthetic_detection_batch(2, 64, 6, 4, seed=s)
             for s in range(STEPS)]
    (_, tscope), jscope = _train_pair(_yolo_train, feeds, jyolo, tyolo)

    def infer(p, mod):
        with p.unique_name.guard():
            main, startup, _, fetch = mod.yolov3_infer_program(**YOLO)
        nms = [op for op in main.global_block().ops
               if op.type == "multiclass_nms"][0]
        pre = [nms.input("BBoxes")[0], nms.input("Scores")[0]]
        return main, [fetch["pred"].name] + pre, nms.attrs
    tmain, tnames, attrs = infer(ptt, tyolo)
    jmain, jnames, _ = infer(pt, jyolo)
    rng = np.random.RandomState(9)
    feed = {"image": rng.rand(3, 3, 64, 64).astype(np.float32),
            "im_size": np.array([[64, 64], [48, 64], [64, 40]], np.int32)}
    exe = ptt.Executor(ptt.CPUPlace())
    with ptt.scope_guard(tscope):
        ptt.save_inference_model(
            str(tmp_path), ["image", "im_size"],
            [tmain.global_block().var(n) for n in tnames], exe,
            main_program=tmain)
    config = Config(str(tmp_path))
    config.place = ptt.CPUPlace()
    pred, boxes, scores = create_predictor(config).run(feed)
    with pt.scope_guard(jscope):
        jout = pt.Executor(pt.CPUPlace()).run(jmain, feed=feed,
                                              fetch_list=jnames)
    for got, want in ((boxes, jout[1]), (scores, jout[2])):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=STATE_RTOL,
                                   atol=STATE_ATOL * np.abs(want).max())
    assert pred.shape == (3, 50, 6) and (pred[..., 1] > 0).any()

    def nms(p):
        b = p.layers.data("b", list(boxes.shape), append_batch_size=False)
        s = p.layers.data("s", list(scores.shape), append_batch_size=False)
        return [p.layers.multiclass_nms(
            b, s, score_threshold=attrs["score_threshold"],
            nms_top_k=attrs["nms_top_k"], keep_top_k=attrs["keep_top_k"],
            nms_threshold=attrs["nms_threshold"],
            background_label=attrs["background_label"])]
    jnms_main, jnms_start = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(jnms_main, jnms_start):
        jfetch = nms(pt)
    with pt.scope_guard(pt.Scope()):
        want, = pt.Executor(pt.CPUPlace()).run(
            jnms_main, feed={"b": boxes, "s": scores}, fetch_list=jfetch)
    np.testing.assert_array_equal(pred, np.asarray(want))
