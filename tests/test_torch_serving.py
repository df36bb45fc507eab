"""The port's serving artifact (paddle_tpu_torch/serving.py) against the
JAX package's (paddle_tpu/serving.py).

Models: an fc net 6 -> 8 -> 3 (softmax), a weight-dominated fc net
64 -> 256 -> 8 for the q8 codec, and a BERT encoder at 2 layers, hidden
64, T = 16 (and a 1-layer pretraining program for the batch-factor
feeds). Both packages build the same Program; the JAX startup's weights
go into the port with ``io.set_params_from_numpy``.

Tolerances: f32 through the same ops on the CPU, summed in other
orders: answers within rtol/atol 1e-5 of the JAX artifact, of the port's
Executor and of the port's Predictor (the port's artifact and its own
Executor run the same kernels: equal here). The q8 artifact is held
against the codec's numpy oracle (``quant_ops.np_block_dequantize`` of
the payload the port wrote, fed to the port's plain artifact): equal,
since both run the same graph on the same weight values; it is not held
against the red ``tests/test_serving.py::
test_q8_export_shrinks_and_roundtrips`` path. The JAX package runs int64
feeds as int32 (no x64) and the port widens them: the meta's feed dtypes
are compared after that widening.

Robustness: the same scripted ``fire("serve")`` slowness (each
``slow_s`` 0.2 s or less) drives both predictors through a deadline
miss, a degraded serve from a warm bucket, load shedding at
``max_in_flight`` and an injected error; the events and the ``health()``
counters must agree.
"""
import json
import os
import threading
import time

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import serving as jserving
from paddle_tpu.framework import resilience as jres
from paddle_tpu.ops import quant_ops as jquant
from paddle_tpu_torch import serving
from paddle_tpu_torch.framework import resilience as tres
from paddle_tpu_torch.inference import Config, create_predictor

TOL = dict(rtol=1e-5, atol=1e-5)
JAX_KEYS = ("format_version", "feed_var_names", "fetch_var_names",
            "dynamic_batch", "feed_batch_factor", "fetch_batch_factor",
            "buckets")


@pytest.fixture(autouse=True)
def _clean():
    for res in (jres, tres):
        res.install(None)
        res.clear_events()
    yield
    for res in (jres, tres):
        res.install(None)
        res.clear_events()


def _fc_net(pkg, features=6, hidden=8, classes=3, seed=5):
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = seed
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", [features], dtype="float32")
        h = pkg.layers.fc(x, hidden, act="relu")
        y = pkg.layers.softmax(pkg.layers.fc(h, classes))
    return main, startup, y


def _pair(tmp_path, build=_fc_net, batch_sizes=(1, 8), feeds=("x",),
          **kw):
    """Export ``build``'s program from both packages (the port's scope a
    copy of the JAX startup's); returns (jax dir, port dir, port scope,
    port program, port fetches)."""
    jmain, jstart, jy = build(pt)
    tmain, _, ty = build(ptt)
    jy, ty = list(np.atleast_1d(jy)), list(np.atleast_1d(ty))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jscope = pt.Scope()
    with pt.scope_guard(jscope):
        jexe = pt.Executor(pt.CPUPlace())
        jexe.run(jstart)
        pt.save_inference_model(jdir, list(feeds), jy, jexe,
                                main_program=jmain, format="stablehlo",
                                batch_sizes=batch_sizes, **kw)
        arrays = {v.name: np.asarray(jscope.find_var(v.name))
                  for v in jmain.list_vars() if v.persistable}
    tscope = ptt.Scope()
    ptt.set_params_from_numpy(arrays, tmain, tscope, ptt.CPUPlace())
    with ptt.scope_guard(tscope):
        ptt.save_inference_model(tdir, list(feeds), ty,
                                 ptt.Executor(ptt.CPUPlace()),
                                 main_program=tmain, format="stablehlo",
                                 batch_sizes=batch_sizes, **kw)
    return jdir, tdir, tscope, tmain, ty


def _load(dirname, **kw):
    return serving.load_serving_artifact(dirname, place=ptt.CPUPlace(),
                                         **kw)


def _meta(dirname):
    with open(os.path.join(dirname, "serving", "meta.json")) as f:
        return json.load(f)


def _widened(meta):
    """The JAX meta's keys, int32 feeds widened to int64 as the port
    declares them."""
    out = {k: meta[k] for k in JAX_KEYS}
    out["buckets"] = {
        b: {"feeds": [dict(f, dtype="int64" if f["dtype"] == "int32"
                           else f["dtype"]) for f in spec["feeds"]]}
        for b, spec in meta["buckets"].items()}
    return out


def test_export_roundtrip_matches_jax_executor_and_predictor(tmp_path):
    jdir, tdir, tscope, tmain, ty = _pair(tmp_path)
    assert _widened(_meta(jdir)) == _widened(_meta(tdir))
    meta = _meta(tdir)
    assert meta["runtime"]["library"] == "paddle_tpu_torch"
    assert meta["device"] == "cpu" and meta["format_version"] == 2
    sdir = os.path.join(tdir, "serving")
    for b in (1, 8):
        assert os.path.exists(os.path.join(sdir, "export_b%d.pt2" % b))
        assert "graph" in open(os.path.join(sdir, "module_b%d.txt"
                                            % b)).read()
    xv = np.random.RandomState(0).rand(5, 6).astype(np.float32)
    pred = _load(tdir)
    assert pred.get_input_names() == ["x"]
    out, = pred.run({"x": xv})            # batch 5 -> bucket 8, sliced
    assert out.shape == (5, 3)
    want, = jserving.load_serving_artifact(jdir).run({"x": xv})
    np.testing.assert_allclose(out, want, **TOL)
    ref, = ptt.Executor(ptt.CPUPlace()).run(tmain, feed={"x": xv},
                                            fetch_list=ty, scope=tscope)
    np.testing.assert_allclose(out, ref, **TOL)
    config = Config(tdir)
    config.place = ptt.CPUPlace()
    inproc, = create_predictor(config).run({"x": xv})
    np.testing.assert_allclose(out, inproc, **TOL)
    with pytest.raises(ValueError, match="largest exported bucket"):
        pred.run({"x": np.zeros((9, 6), np.float32)})


def test_export_weights_are_frozen(tmp_path):
    main, startup = ptt.Program(), ptt.Program()
    with ptt.unique_name.guard(), ptt.program_guard(main, startup):
        x = ptt.layers.data("x", [4], dtype="float32")
        y = ptt.layers.fc(x, 2)
        test_prog = main.clone(for_test=True)
        lbl = ptt.layers.data("lbl", [2], dtype="float32")
        loss = ptt.layers.reduce_mean(
            ptt.layers.square_error_cost(y, lbl))
        ptt.optimizer.SGD(0.5).minimize(loss)
    xv = np.random.RandomState(1).rand(2, 4).astype(np.float32)
    with ptt.scope_guard(ptt.Scope()):
        exe = ptt.Executor(ptt.CPUPlace())
        exe.run(startup)
        ptt.save_inference_model(str(tmp_path), ["x"], [y], exe,
                                 main_program=test_prog,
                                 format="stablehlo", batch_sizes=(2,))
        pred = _load(str(tmp_path))
        before, = pred.run({"x": xv})
        ref, = exe.run(test_prog, feed={"x": xv}, fetch_list=[y])
        np.testing.assert_allclose(before, ref, **TOL)
        for _ in range(3):
            exe.run(main, feed={"x": xv, "lbl": np.ones((2, 2),
                                                        np.float32)},
                    fetch_list=[loss])
        live, = exe.run(test_prog, feed={"x": xv}, fetch_list=[y])
    assert not np.allclose(live, ref)
    again, = pred.run({"x": xv})
    np.testing.assert_array_equal(again, before)


def _bert_pretrain(pkg):
    from paddle_tpu.models import bert as jbert
    from paddle_tpu_torch.models import bert as tbert
    bert = jbert if pkg is pt else tbert
    cfg = bert.BertConfig(vocab_size=128, hidden_size=32, num_layers=1,
                          num_heads=2, ff_size=64, max_position=32)
    with pkg.unique_name.guard():
        main, startup, feeds, fetch = bert.bert_pretrain_program(
            cfg, 4, 16, 4, optimizer_fn=None, is_test=True)
    startup.random_seed = 3
    return main, startup, fetch["loss"]


def test_batch_factor_feeds_match_the_jax_package(tmp_path):
    from paddle_tpu_torch.models import bert
    cfg = bert.BertConfig(vocab_size=128, hidden_size=32, num_layers=1,
                          num_heads=2, ff_size=64, max_position=32)
    feed = bert.synthetic_batch(cfg, 4, 16, 4)
    jdir, tdir, tscope, tmain, ty = _pair(
        tmp_path, _bert_pretrain, batch_sizes=(4,), feeds=list(feed),
        example_feed=feed)
    assert _widened(_meta(jdir)) == _widened(_meta(tdir))
    pred = _load(tdir)
    factors = pred.feed_batch_factors()
    assert factors["mask_pos"] == 4 and factors["src_ids"] == 1
    out, = pred.run(feed)
    want, = jserving.load_serving_artifact(jdir).run(
        {k: v.astype(np.int32) if v.dtype == np.int64 else v
         for k, v in feed.items()})
    np.testing.assert_allclose(out, want, **TOL)
    ref, = ptt.Executor(ptt.CPUPlace()).run(tmain, feed=feed,
                                            fetch_list=ty, scope=tscope)
    np.testing.assert_allclose(out, ref, **TOL)
    jpred = jserving.load_serving_artifact(jdir)
    assert pred.feed_inner_shapes() == jpred.feed_inner_shapes()
    assert pred.fetch_batch_factors() == jpred.fetch_batch_factors()
    widen = {"int32": "int64"}
    assert pred.feed_dtypes() == {k: widen.get(v, v) for k, v in
                                  jpred.feed_dtypes().items()}
    assert (pred.max_bucket, pred.dynamic_batch) == \
        (jpred.max_bucket, jpred.dynamic_batch)


def _wide(pkg):
    return _fc_net(pkg, features=64, hidden=256, classes=8)


def test_q8_artifact_equals_the_codec_oracle_and_shrinks(tmp_path):
    jdir, plain, tscope, tmain, ty = _pair(tmp_path, _wide,
                                              batch_sizes=(8,))
    q8 = str(tmp_path / "q8")
    with ptt.scope_guard(tscope):
        ptt.save_inference_model(q8, ["x"], ty,
                                 ptt.Executor(ptt.CPUPlace()),
                                 main_program=tmain, format="stablehlo",
                                 batch_sizes=(8,), weight_compress="q8")
    meta = _meta(q8)
    assert meta["format_version"] == serving.SERVING_FORMAT_VERSION == 3
    assert meta["weight_compress"] == "q8"
    assert meta["weight_names"] == sorted(meta["weight_names"])
    sdir = os.path.join(q8, "serving")
    wq8 = os.path.getsize(os.path.join(sdir, serving.WEIGHTS_Q8_FILE))
    wfp = os.path.getsize(os.path.join(plain, "serving",
                                       serving.WEIGHTS_FILE))
    assert wq8 * 3 < wfp                    # ~4x on the big weight
    # a bucket's program holds the graph, not the weights
    assert 2 * os.path.getsize(os.path.join(sdir, "export_b8.pt2")) < wfp
    assert not os.path.exists(os.path.join(sdir, serving.WEIGHTS_FILE))
    xv = np.random.RandomState(0).rand(5, 64).astype(np.float32)
    q8_pred = _load(q8)
    assert q8_pred.weight_compress == "q8"
    out, = q8_pred.run({"x": xv})
    # the oracle: the payload dequantized by the codec's numpy function,
    # in place of the plain artifact's weights
    with np.load(os.path.join(sdir, serving.WEIGHTS_Q8_FILE)) as z:
        oracle = {}
        for n in meta["weight_names"]:
            if n + "##q8s" in z.files:
                oracle[n] = jquant.np_block_dequantize(
                    z[n], z[n + "##q8s"],
                    tuple(int(d) for d in z[n + "##q8n"]), np.float32)
            else:
                oracle[n] = z[n]
    assert any(n + "##q8s" in z.files for n in meta["weight_names"])
    np.savez(os.path.join(plain, "serving", serving.WEIGHTS_FILE),
             **oracle)
    want, = _load(plain).run({"x": xv})
    np.testing.assert_array_equal(out, want)
    exact, = jserving.load_serving_artifact(jdir).run({"x": xv})
    np.testing.assert_allclose(out, exact, atol=2e-2)


def test_format_fences(tmp_path):
    jdir, tdir, tscope, tmain, ty = _pair(tmp_path, batch_sizes=(8,))
    meta = _meta(tdir)
    assert meta["format_version"] == 2 and "weight_compress" not in meta
    exe = ptt.Executor(ptt.CPUPlace())
    with ptt.scope_guard(tscope):
        with pytest.raises(ValueError, match="weight_compress"):
            ptt.save_inference_model(str(tmp_path / "bad"), ["x"], ty, exe,
                                     main_program=tmain,
                                     format="stablehlo", batch_sizes=(8,),
                                     weight_compress="zstd")
        with pytest.raises(ValueError, match="format must be"):
            ptt.save_inference_model(str(tmp_path / "bad2"), ["x"], ty,
                                     exe, main_program=tmain,
                                     format="onnx")
    assert not os.path.exists(str(tmp_path / "bad2"))
    # the JAX package's artifact: no runtime stamp, export_b*.bin
    with pytest.raises(ValueError, match="export_b\\*.bin"):
        _load(jdir)
    mpath = os.path.join(tdir, "serving", "meta.json")

    def edited(**kw):
        m = dict(meta, **kw)
        with open(mpath, "w") as f:
            json.dump(m, f)
    for kw, match in (({"device": "cuda"}, "exported for the cuda"),
                      ({"format_version": 4}, "newer than"),
                      ({"weight_compress": "zstd9"}, "weight_compress")):
        edited(**kw)
        with pytest.raises(ValueError, match=match):
            _load(tdir)
    edited()
    assert _load(tdir).run({"x": np.ones((2, 6), np.float32)})[0].shape \
        == (2, 3)


def test_export_refuses_an_op_that_reads_the_device_on_the_host(tmp_path):
    main, startup = ptt.Program(), ptt.Program()
    with ptt.unique_name.guard(), ptt.program_guard(main, startup):
        x = ptt.layers.data("x", [4], dtype="float32")
        y = ptt.layers.Print(ptt.layers.scale(x, 2.0))
    with ptt.scope_guard(ptt.Scope()):
        exe = ptt.Executor(ptt.CPUPlace())
        exe.run(startup)
        with pytest.raises(ValueError, match="print"):
            ptt.save_inference_model(str(tmp_path), ["x"], [y], exe,
                                     main_program=main,
                                     format="stablehlo",
                                     batch_sizes=(2,))
    assert not os.path.exists(os.path.join(str(tmp_path), "serving"))


def test_q8_artifact_still_verified_at_load(tmp_path):
    _, tdir, tscope, tmain, ty = _pair(tmp_path, batch_sizes=(8,))
    q8 = str(tmp_path / "q8")
    with ptt.scope_guard(tscope):
        ptt.save_inference_model(q8, ["x"], ty,
                                 ptt.Executor(ptt.CPUPlace()),
                                 main_program=tmain, format="stablehlo",
                                 batch_sizes=(8,), weight_compress="q8")
    for d in (tdir, q8):
        _load(d)                               # clean: loads
        path = os.path.join(d, "__model__.json")
        meta = json.load(open(path))
        ops = meta["program"]["blocks"][0]["ops"]
        ops[0]["inputs"] = {k: ["gone_var"] for k in ops[0]["inputs"]}
        with open(path, "w") as f:
            json.dump(meta, f)
        with pytest.raises(ValueError, match="program verification"):
            _load(d)
        meta["program"]["blocks"][0]["ops"][0].pop("type")
        with open(path, "w") as f:
            json.dump(meta, f)
        with pytest.raises(ValueError, match="corrupt program IR"):
            _load(d)


T = 16
BERT_FEEDS = ["src_ids", "pos_ids", "sent_ids", "input_mask"]


def _bert_encoder(pkg):
    from paddle_tpu.models import bert as jbert
    from paddle_tpu_torch.models import bert as tbert
    bert = jbert if pkg is pt else tbert
    cfg = bert.BertConfig(vocab_size=100, hidden_size=64, num_layers=2,
                          num_heads=4, ff_size=128, max_position=64)
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 3
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        feeds = [pkg.layers.data(n, [T, 1], dtype=dt) for n, dt in zip(
            BERT_FEEDS, ["int64", "int64", "int64", "float32"])]
        seq, pooled = bert.bert_encoder(*feeds, cfg, is_test=True)
    return main, startup, [seq, pooled]


def _bert_request(n, seed):
    rng = np.random.RandomState(seed)
    mask = np.ones((n, T, 1), np.float32)
    for row in range(1, n):
        mask[row, rng.randint(2, T):] = 0.0
    return {"src_ids": rng.randint(0, 100, (n, T, 1)).astype(np.int64),
            "pos_ids": np.tile(np.arange(T).reshape(1, T, 1),
                               (n, 1, 1)).astype(np.int64),
            "sent_ids": (np.arange(T).reshape(1, T, 1) >= T // 2).repeat(
                n, 0).astype(np.int64),
            "input_mask": mask}


def test_bert_graph_holds_the_kernels_custom_ops(tmp_path):
    """The exported encoder holds the two custom ops (2 attention, 5
    LayerNorm calls) and no plain attention; its answers are the JAX
    artifact's, the port Executor's and the Predictor's."""
    jdir, tdir, tscope, tmain, ty = _pair(
        tmp_path, _bert_encoder, batch_sizes=(1, 8), feeds=BERT_FEEDS)
    assert _widened(_meta(jdir)) == _widened(_meta(tdir))
    import torch
    program = torch.export.load(os.path.join(tdir, "serving",
                                             "export_b8.pt2"))
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets.count("paddle_tpu_torch.flash_attention_fwd.default") \
        == 2
    assert targets.count("paddle_tpu_torch.layer_norm_fwd.default") == 5
    assert not [t for t in targets if "softmax" in t or "logsumexp" in t]
    pred, jpred = _load(tdir), jserving.load_serving_artifact(jdir)
    for n, seed in ((1, 0), (3, 1), (8, 2)):
        feed = _bert_request(n, seed)
        got = pred.run(feed)
        want = jpred.run({k: v.astype(np.int32) if v.dtype == np.int64
                          else v for k, v in feed.items()})
        ref = ptt.Executor(ptt.CPUPlace()).run(tmain, feed=feed,
                                               fetch_list=ty,
                                               scope=tscope)
        for g, w, r in zip(got, want, ref):
            np.testing.assert_allclose(g, w, **TOL)
            np.testing.assert_allclose(g, r, **TOL)


# ---------------------------------------------------------------------------
# deadlines, shedding, degraded mode and health, in both packages
# ---------------------------------------------------------------------------

def _events(res):
    return [{k: v for k, v in e.items() if k != "time"}
            for e in res.events()]


def _wait(cond, what, timeout_s=20.0):
    end = time.monotonic() + timeout_s
    while time.monotonic() < end:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError("timed out waiting for %s" % what)


def _scenario(name, pred, res, xv):
    """Drive one predictor through a scripted case; returns what the
    case observed."""
    seen = {}
    if name == "deadline":
        pred.warmup()
        with res.inject("serve:slow=0.2@1"):
            with pytest.raises(res.DeadlineExceededError):
                pred.run({"x": xv[:1]}, deadline_s=0.05)
            _wait(lambda: pred.in_flight == 0, "the orphaned worker")
    elif name == "degraded":
        pred.warmup([8])
        with res.inject("serve:slow=0.2@1"):
            out, = pred.run({"x": xv[:1]}, deadline_s=0.1)
            seen["shape"] = out.shape
            _wait(lambda: pred.in_flight == 0, "the orphaned worker")
        seen["warm_after"] = pred.health()["warm_buckets"]
    elif name == "shed":
        pred.warmup()
        box = []
        with res.inject("serve:slow=0.2@1,serve:slow=0.2@2"):
            threads = [threading.Thread(
                target=lambda: box.append(pred.run({"x": xv[:2]})))
                for _ in range(2)]
            for t in threads:
                t.start()
            _wait(lambda: pred.in_flight == 2, "two requests in flight")
            seen["saturated"] = pred.health()["status"]
            with pytest.raises(res.ServerOverloadedError):
                pred.run({"x": xv[:2]})
            for t in threads:
                t.join(20.0)
        seen["served"] = len(box)
    elif name == "error":
        pred.warmup()
        with res.inject("serve:error@1"):
            with pytest.raises(RuntimeError, match="injected serving"):
                pred.run({"x": xv[:3]})
        seen["after"] = pred.run({"x": xv[:3]})[0].shape
    seen["health"] = pred.health()
    return seen


@pytest.mark.parametrize("name", ["deadline", "degraded", "shed",
                                  "error"])
def test_robustness_matches_the_jax_predictor(tmp_path, name):
    jdir, tdir, _, _, _ = _pair(tmp_path)
    xv = np.random.RandomState(2).rand(8, 6).astype(np.float32)
    got = []
    for res, load in ((jres, lambda: jserving.load_serving_artifact(
            jdir, max_in_flight=2)),
            (tres, lambda: _load(tdir, max_in_flight=2))):
        pred = load()
        res.clear_events()
        seen = _scenario(name, pred, res, xv)
        got.append((seen, _events(res)))
    assert got[1] == got[0]
    health = got[1][0]["health"]
    want = {"deadline": dict(deadline_misses=1, status="degraded"),
            "degraded": dict(deadline_misses=1, degraded_serves=1,
                             status="degraded"),
            "shed": dict(sheds=1, requests=3, status="ok"),
            "error": dict(errors=1, requests=2, status="degraded")}[name]
    assert {k: health[k] for k in want} == want
    if name == "degraded":
        kinds = [e["kind"] for e in got[1][1]]
        assert "degraded" in kinds


def test_health_reports_cold_then_ready(tmp_path):
    _, tdir, _, _, _ = _pair(tmp_path)
    pred = _load(tdir, max_in_flight=1)
    h = pred.health()
    assert (h["ready"], h["status"], h["cold_buckets"]) == \
        (False, "cold", [1, 8])
    pred.warmup()
    h = pred.health()
    assert (h["ready"], h["status"], h["warm_buckets"]) == \
        (True, "ok", [1, 8])
    assert pred.max_bucket == 8 and pred.dynamic_batch
