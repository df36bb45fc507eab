"""contrib/slim, contrib/quantize and contrib/utils: the port against the
JAX package.

Each program is built with both packages (same calls, same unique
names), the port starting from the JAX scope's persistables (weights,
optimizer state, the quant-aware moving-average state) copied by
``set_params_from_numpy``; the JAX Executor runs its step jitted, the
port's runs op by op on the CPU.

Tolerances. The fake-quant ops are bit-equal to the JAX ops
(tests/test_torch_quant_ops.py), but an op's input is not: a sum in
another order moves an activation by an ulp, and where that activation
sits on a level's boundary the ulp moves it by a whole quantization
step (1/127 of the tensor's abs max). So quant-aware losses are held to
1e-4 relative over 5 steps (the fc net and a narrow BERT: 2 layers,
hidden 64), not bit for bit. Masks, scales' dicts, programs and search
trajectories are exact; distillation losses rtol 1e-5 (one f32 op
chain).
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.contrib import quantize as jquant
from paddle_tpu.contrib import slim as jslim
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.contrib import quantize as tquant
from paddle_tpu_torch.contrib import slim as tslim
from paddle_tpu_torch.framework.scope import to_numpy
from paddle_tpu_torch.models import bert as tbert
from test_torch_bert_training import _normalized

QAT_RTOL = 1e-4
TOL = dict(rtol=1e-5, atol=1e-6)
SLIM = {pt: jslim, ptt: tslim}
BERT = {pt: jbert, ptt: tbert}


def _persistables(main, scope):
    return {v.name: np.asarray(scope.find_var(v.name))
            for v in main.list_vars() if v.persistable
            and scope.find_var(v.name) is not None}


def _fc_net(p, n_in=8, hidden=16):
    x = p.layers.data("x", [n_in], "float32")
    h = p.layers.fc(x, size=hidden, act="relu")
    y = p.layers.fc(h, size=1)
    lbl = p.layers.data("y", [1], "float32")
    return p.layers.reduce_mean(p.layers.square_error_cost(y, lbl)), y


def _fc_feed(seed=4, n=32, n_in=8):
    rng = np.random.RandomState(seed)
    xv = rng.rand(n, n_in).astype(np.float32)
    return {"x": xv, "y": (xv.sum(1, keepdims=True) * 0.1).astype(
        np.float32)}


def _build(p, build, qat=None, opt=None):
    """(main, startup, scope, loss, other fetch): ``build(p)`` -> (loss,
    other); ``qat``: quant_aware's kwargs (the state goes into the
    returned scope); ``opt(p)``: the optimizer minimizing the loss."""
    main, startup, scope = p.Program(), p.Program(), p.Scope()
    with p.unique_name.guard(), p.program_guard(main, startup):
        loss, other = build(p)
        if qat is not None:
            SLIM[p].quant_aware(main, scope=scope, **qat)
        if opt is not None:
            opt(p).minimize(loss)
    return main, startup, scope, loss, other


def _started_pair(build, qat=None, opt=None):
    """Both packages' programs, the JAX one started, its persistables in
    the port's scope: ((jmain, jscope, jfetch), (tmain, tscope,
    tfetch))."""
    jmain, jstart, jscope, jloss, jother = _build(pt, build, qat, opt)
    tmain, _, tscope, tloss, tother = _build(ptt, build, qat, opt)
    with pt.scope_guard(jscope):
        pt.Executor(pt.CPUPlace()).run(jstart)
    ptt.set_params_from_numpy(_persistables(jmain, jscope), tmain, tscope,
                              ptt.CPUPlace())
    return (jmain, jscope, [jloss, jother]), (tmain, tscope, [tloss, tother])


def _train_both(pair, feeds):
    (jmain, jscope, jfetch), (tmain, tscope, tfetch) = pair
    jexe, texe = pt.Executor(pt.CPUPlace()), ptt.Executor(ptt.CPUPlace())
    jl, tl = [], []
    for feed in feeds:
        with pt.scope_guard(jscope):
            jl.append(float(np.asarray(jexe.run(
                jmain, feed=feed, fetch_list=jfetch[:1])[0]).reshape(())))
        with ptt.scope_guard(tscope):
            tl.append(float(np.asarray(texe.run(
                tmain, feed=feed, fetch_list=tfetch[:1])[0]).reshape(())))
    return jl, tl


def _sgd(p):
    return p.optimizer.SGD(0.1)


# ------------------------------------------------------------------- qat

def test_quant_aware_rewrites_the_program_as_the_jax_package():
    """Types, slots, names, attributes and order of the rewritten fc net
    and tiny BERT, with their backward and optimizer ops."""
    for build in (lambda p: _fc_net(p), _tiny_bert_loss):
        jmain = _build(pt, build, qat={}, opt=_sgd)[0]
        tmain = _build(ptt, build, qat={}, opt=_sgd)[0]
        assert _normalized(tmain) == _normalized(jmain)
    types = [op.type for op in tmain.global_block().ops]
    assert "fake_quantize_dequantize_moving_average_abs_max" in types
    assert "fake_channel_wise_quantize_dequantize_abs_max" in types


def test_quant_aware_returns_the_count_and_fills_the_scope():
    counts = {}
    for p in (pt, ptt):
        main, startup, scope = p.Program(), p.Program(), p.Scope()
        with p.unique_name.guard(), p.program_guard(main, startup):
            _fc_net(p)
        counts[p] = SLIM[p].quant_aware(main, weight_bits=4,
                                        activation_bits=6, scope=scope)
        state = [n for n in scope.keys() if n.endswith(".state")]
        assert len(state) == 2
    assert counts[pt] == counts[ptt] == 2
    t = scope.find_var(state[0])
    assert t.dtype == torch.float32 and t.device.type == "cpu"
    assert torch.equal(t, torch.ones(1))


def _tied_net(p):
    """A parameter read as a mul's weight and as another mul's
    activation: it gets both fake-quant variants."""
    x = p.layers.data("x", [4, 4], "float32", append_batch_size=False)
    w = p.layers.create_parameter([4, 4], "float32", name="tied_w")
    a = p.layers.mul(x, w)
    b = p.layers.mul(w, a)
    return p.layers.reduce_mean(b), b


def test_tied_parameter_gets_both_variants():
    jmain = _build(pt, _tied_net, qat={}, opt=_sgd)[0]
    tmain = _build(ptt, _tied_net, qat={}, opt=_sgd)[0]
    assert _normalized(tmain) == _normalized(jmain)
    names = {n for op in tmain.global_block().ops for n in op.output_names()}
    assert {"tied_w.quantized", "tied_w.quantized.act"} <= names
    pair = _started_pair(_tied_net, qat={}, opt=_sgd)
    feed = {"x": np.random.RandomState(0).randn(4, 4).astype(np.float32)}
    jl, tl = _train_both(pair, [feed] * 3)
    np.testing.assert_allclose(tl, jl, rtol=QAT_RTOL)


def test_quant_aware_fc_trains_like_jax():
    """Five SGD steps from the same weights; then the moving-average
    state equal (to the losses' tolerance), the weights close."""
    pair = _started_pair(lambda p: _fc_net(p), qat={}, opt=_sgd)
    jl, tl = _train_both(pair, [_fc_feed(seed=s) for s in range(5)])
    np.testing.assert_allclose(tl, jl, rtol=QAT_RTOL)
    assert tl[-1] < tl[0]
    (jmain, jscope, _), (tmain, tscope, _) = pair
    for name, want in _persistables(jmain, jscope).items():
        np.testing.assert_allclose(to_numpy(tscope.find_var(name)), want,
                                   rtol=QAT_RTOL, atol=1e-5, err_msg=name)


def _tiny_cfg(bert):
    return bert.BertConfig(vocab_size=128, hidden_size=64, num_layers=2,
                           num_heads=4, ff_size=128, max_position=32,
                           hidden_dropout=0.0, attn_dropout=0.0)


def _tiny_bert_loss(p):
    bert = BERT[p]
    cfg = _tiny_cfg(bert)
    feeds = [p.layers.data(n, [2, 16, 1], dtype=d, append_batch_size=False)
             for n, d in (("src_ids", "int64"), ("pos_ids", "int64"),
                          ("sent_ids", "int64"),
                          ("input_mask", "float32"))]
    seq, pooled = bert.bert_encoder(*feeds, cfg)
    logits = p.layers.fc(pooled, size=2)
    label = p.layers.data("label", [2, 1], "int64", append_batch_size=False)
    loss = p.layers.mean(p.layers.softmax_with_cross_entropy(logits, label))
    return loss, logits


def _bert_feed(seed):
    rng = np.random.RandomState(seed)
    return {"src_ids": rng.randint(0, 128, (2, 16, 1)).astype(np.int64),
            "pos_ids": np.tile(np.arange(16).reshape(1, 16, 1), (2, 1, 1)),
            "sent_ids": np.zeros((2, 16, 1), np.int64),
            "input_mask": np.ones((2, 16, 1), np.float32),
            "label": rng.randint(0, 2, (2, 1)).astype(np.int64)}


def test_quant_aware_narrow_bert_pretraining_trains_like_jax():
    """bert_pretrain_program (2 layers, hidden 64) made quant-aware in
    its optimizer_fn, five Adam steps from the JAX startup's state."""
    def build(p):
        bert, scope = BERT[p], p.Scope()

        def opt_fn(loss):
            SLIM[p].quant_aware(loss.block.program, scope=scope)
            p.optimizer.Adam(1e-3).minimize(loss)
        with p.unique_name.guard():
            main, start, _, fetch = bert.bert_pretrain_program(
                _tiny_cfg(bert), 2, 16, 4, optimizer_fn=opt_fn)
        return main, start, scope, fetch["loss"]
    jmain, jstart, jscope, jloss = build(pt)
    tmain, _, tscope, tloss = build(ptt)
    assert _normalized(tmain) == _normalized(jmain)
    with pt.scope_guard(jscope):
        pt.Executor(pt.CPUPlace()).run(jstart)
    ptt.set_params_from_numpy(_persistables(jmain, jscope), tmain, tscope,
                              ptt.CPUPlace())
    feeds = [tbert.synthetic_batch(_tiny_cfg(tbert), 2, 16, 4, seed=s)
             for s in range(5)]
    jl, tl = _train_both(((jmain, jscope, [jloss]),
                          (tmain, tscope, [tloss])), feeds)
    np.testing.assert_allclose(tl, jl, rtol=QAT_RTOL)
    assert all(np.isfinite(tl))


def test_convert_scales_equal_the_jax_package():
    pair = _started_pair(lambda p: _fc_net(p), qat={}, opt=_sgd)
    _train_both(pair, [_fc_feed(seed=s) for s in range(3)])
    (jmain, jscope, _), (tmain, tscope, _) = pair
    # the port's weights and state as the JAX package's, then convert
    ptt.set_params_from_numpy(_persistables(jmain, jscope), tmain, tscope,
                              ptt.CPUPlace())
    jinfer, tinfer = jmain.clone(for_test=True), tmain.clone(for_test=True)
    with pt.scope_guard(jscope):
        want = jslim.convert(jinfer)
    got = tslim.convert(tinfer, scope=tscope)
    assert sorted(got["weights"]) == sorted(want["weights"])
    for name, s in want["weights"].items():
        np.testing.assert_array_equal(got["weights"][name], s)
        assert got["weights"][name].dtype == np.asarray(s).dtype
    assert got["activations"] == want["activations"]
    assert _normalized(tinfer) == _normalized(jinfer)
    assert "fake_quantize_dequantize_moving_average_abs_max" not in [
        op.type for op in tinfer.global_block().ops]
    feed = _fc_feed(seed=9)
    with pt.scope_guard(jscope):
        jout = pt.Executor(pt.CPUPlace()).run(jinfer, feed=feed,
                                              fetch_list=[pair[0][2][1]])
    with ptt.scope_guard(tscope):
        tout = ptt.Executor(ptt.CPUPlace()).run(
            tinfer, feed=feed, fetch_list=[pair[1][2][1]])
    np.testing.assert_allclose(tout[0], jout[0], **TOL)


def test_insert_and_remove_op_bump_the_version_and_the_plan_key():
    from paddle_tpu_torch.framework.executor import _plan_key
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = ptt.layers.data("x", [3], "float32")
        y = ptt.layers.scale(x, scale=2.0)
    blk = main.global_block()
    keys = [_plan_key(main, [y.name])]
    op = blk._insert_op(0, "scale", inputs={"X": [x.name]},
                        outputs={"Out": [x.name]}, attrs={"scale": 3.0})
    assert blk.ops[0] is op
    keys.append(_plan_key(main, [y.name]))
    blk._remove_op(0)
    keys.append(_plan_key(main, [y.name]))
    assert len(set(keys)) == 3
    exe = ptt.Executor(ptt.CPUPlace())
    feed = {"x": np.ones((2, 3), np.float32)}
    before = exe.run(main, feed=feed, fetch_list=[y])[0]
    blk._insert_op(1, "scale", inputs={"X": [y.name]},
                   outputs={"Out": [y.name]}, attrs={"scale": 5.0})
    after = exe.run(main, feed=feed, fetch_list=[y])[0]
    np.testing.assert_array_equal(after, before * 5)


def test_quant_aware_after_a_run_runs_the_rewritten_program():
    main, startup = ptt.Program(), ptt.Program()
    scope = ptt.Scope()
    with ptt.unique_name.guard(), ptt.program_guard(main, startup):
        loss, y = _fc_net(ptt)
    exe = ptt.Executor(ptt.CPUPlace())
    with ptt.scope_guard(scope):
        exe.run(startup)
        feed = _fc_feed()
        plain = exe.run(main, feed=feed, fetch_list=[y])[0]
        tslim.quant_aware(main, weight_bits=2, activation_bits=2,
                          scope=scope)
        quant = exe.run(main, feed=feed, fetch_list=[y])[0]
    assert not np.array_equal(plain, quant)
    assert float(to_numpy(scope.find_var(
        "x.quantized.act.state"))[0]) == np.float32(1.9)


# ---------------------------------------------------------------- quantize

def _served_fc(p):
    """The fc net of ``p`` to serve: (main, startup, its output, a
    feed)."""
    main, startup = p.Program(), p.Program()
    with p.unique_name.guard(), p.program_guard(main, startup):
        _, y = _fc_net(p, n_in=4, hidden=8)
    startup.random_seed = 3
    feed = {"x": _fc_feed(n_in=4)["x"]}
    return main, startup, y, feed


def test_jax_quantized_directory_serves_in_the_port(tmp_path):
    main, startup, y, feed = _served_fc(pt)
    jscope = pt.Scope()
    with pt.scope_guard(jscope):
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup)
        jquant.save_quantized_inference_model(str(tmp_path), ["x"], [y],
                                              exe, main_program=main)
    with pt.scope_guard(pt.Scope()):
        prog, feeds, fetches = jquant.load_quantized_inference_model(
            str(tmp_path), exe)
        want = exe.run(prog, feed=feed, fetch_list=fetches)[0]
    with ptt.scope_guard(ptt.Scope()):
        texe = ptt.Executor(ptt.CPUPlace())
        tprog, tfeeds, tfetches = tquant.load_quantized_inference_model(
            str(tmp_path), texe)
        got = texe.run(tprog, feed=feed, fetch_list=tfetches)[0]
    assert (tfeeds, tfetches) == (feeds, fetches)
    np.testing.assert_allclose(got, want, **TOL)


def test_port_quantized_directory_as_the_jax_package(tmp_path):
    """The port's save writes the JAX package's members (every Parameter
    as .int8, every other persistable as stored) and scales; the JAX
    package loads it; each dequantized weight is within scale / 2."""
    pair = _started_pair(lambda p: _fc_net(p, n_in=4, hidden=8),
                         opt=lambda p: p.optimizer.Adam(1e-2))
    _train_both(pair, [dict(_fc_feed(n_in=4), x=_fc_feed(n_in=4)["x"])])
    (jmain, jscope, jf), (tmain, tscope, tf) = pair
    ptt.set_params_from_numpy(_persistables(jmain, jscope), tmain, tscope,
                              ptt.CPUPlace())
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    with pt.scope_guard(jscope):
        jexe = pt.Executor(pt.CPUPlace())
        jquant.save_quantized_inference_model(jdir, ["x"], [jf[1]], jexe,
                                              main_program=jmain)
    with ptt.scope_guard(tscope):
        texe = ptt.Executor(ptt.CPUPlace())
        tquant.save_quantized_inference_model(tdir, ["x"], [tf[1]], texe,
                                              main_program=tmain)
    jz, tz = np.load(os.path.join(jdir, "params.npz")), \
        np.load(os.path.join(tdir, "params.npz"))
    assert sorted(jz.files) == sorted(tz.files)
    params = [p.name for p in tmain.all_parameters()]
    assert {n + ".int8" for n in params} <= set(tz.files)
    assert any("moment1" in n for n in tz.files)
    for n in tz.files:
        np.testing.assert_array_equal(tz[n], jz[n], err_msg=n)
    with open(os.path.join(tdir, "quant_scales.json")) as f:
        scales = json.load(f)
    with open(os.path.join(jdir, "quant_scales.json")) as f:
        assert json.load(f) == scales
    feed = {"x": _fc_feed(n_in=4)["x"]}
    with pt.scope_guard(pt.Scope()):
        prog, _, fetches = jquant.load_quantized_inference_model(tdir, jexe)
        want = jexe.run(prog, feed=feed, fetch_list=fetches)[0]
    loaded = ptt.Scope()
    with ptt.scope_guard(loaded):
        prog, _, fetches = tquant.load_quantized_inference_model(tdir, texe)
        got = texe.run(prog, feed=feed, fetch_list=fetches)[0]
    np.testing.assert_allclose(got, want, **TOL)
    for n in params:
        err = np.abs(to_numpy(loaded.find_var(n)) -
                     to_numpy(tscope.find_var(n))).max()
        assert err <= scales[n] / 2 * (1 + 1e-6), n


def test_quantize_weights_of_a_bfloat16_parameter_by_value():
    arr = np.array([0.5, -1.0, 0.25], np.float32)
    q, s = tquant.quantize_weights_abs_max({"w": arr})
    jq, js = jquant.quantize_weights_abs_max({"w": arr})
    np.testing.assert_array_equal(q["w"], jq["w"])
    assert s == js
    bf = torch.tensor(arr).to(torch.bfloat16)
    q2, s2 = tquant.quantize_weights_abs_max({"w": to_numpy(bf)})
    np.testing.assert_array_equal(q2["w"], q["w"])


# ------------------------------------------------------------------- prune

@pytest.mark.parametrize("pruner,kw", [
    ("MagnitudePruner", {}), ("StructurePruner", {"axis": 0}),
    ("StructurePruner", {"axis": 1})])
def test_prune_masks_equal_and_sparsity_survives_training(pruner, kw):
    pair = _started_pair(lambda p: _fc_net(p), opt=_sgd)
    (jmain, jscope, _), (tmain, tscope, _) = pair
    helpers = {}
    # a structure pruner's axis 1 needs a matrix: the weights only
    ratios = 0.5 if not kw else {
        v.name: 0.5 for v in tmain.all_parameters() if len(v.shape) == 2}
    for p, main, scope in ((pt, jmain, jscope), (ptt, tmain, tscope)):
        with p.scope_guard(scope):
            helpers[p] = SLIM[p].PruneHelper(
                main, ratios, pruner_cls=getattr(SLIM[p], pruner), **kw)
            helpers[p].compute_masks()
            helpers[p].apply_masks()
    for name, mask in helpers[pt].masks.items():
        tmask = helpers[ptt].masks[name]
        np.testing.assert_array_equal(to_numpy(tmask), np.asarray(mask))
        assert tmask.dtype == tscope.find_var(name).dtype
    assert helpers[ptt].sparsity() == helpers[pt].sparsity()
    texe, jexe = ptt.Executor(ptt.CPUPlace()), pt.Executor(pt.CPUPlace())
    for s in range(4):
        feed = _fc_feed(seed=s)
        with pt.scope_guard(jscope):
            jl = jexe.run(jmain, feed=feed, fetch_list=pair[0][2][:1])
            helpers[pt].apply_masks()
        with ptt.scope_guard(tscope):
            tl = texe.run(tmain, feed=feed, fetch_list=pair[1][2][:1])
            helpers[ptt].apply_masks()
        np.testing.assert_allclose(tl[0], np.asarray(jl[0]), **TOL)
    for name, mask in helpers[ptt].masks.items():
        w = to_numpy(tscope.find_var(name))
        assert not w[to_numpy(mask) == 0].any()


def test_sensitivity_as_the_jax_package_and_weights_restored():
    def build(p):
        x = p.layers.data("x", [4], "float32")
        y = p.layers.fc(x, size=2)
        return p.layers.reduce_mean(p.layers.square(y)), y
    (jmain, jscope, jf), (tmain, tscope, tf) = _started_pair(build)
    feed = {"x": np.random.RandomState(1).rand(8, 4).astype(np.float32)}
    before = {n: tscope.find_var(n).clone() for n in
              [p.name for p in tmain.all_parameters()]}
    with pt.scope_guard(jscope):
        jb, jr = jslim.sensitivity(jmain, pt.Executor(pt.CPUPlace()), feed,
                                   jf[0], ratios=(0.5, 0.9))
    tb, tr = tslim.sensitivity(tmain, ptt.Executor(ptt.CPUPlace()), feed,
                               tf[0], ratios=(0.5, 0.9), scope=tscope)
    np.testing.assert_allclose(tb, jb, **TOL)
    assert sorted(tr) == sorted(jr)
    for name in jr:
        np.testing.assert_allclose([tr[name][r] for r in (0.5, 0.9)],
                                   [jr[name][r] for r in (0.5, 0.9)],
                                   rtol=1e-4, atol=1e-6)
    for n, t in before.items():
        assert torch.equal(tscope.find_var(n), t)


# ----------------------------------------------------------------- distill

@pytest.mark.parametrize("which", ["soft_label", "l2", "fsp", "fsp_loss"])
def test_distill_losses_as_the_jax_package(which):
    rng = np.random.RandomState(2)
    feed = {"s": rng.randn(3, 5).astype(np.float32),
            "t": rng.randn(3, 5).astype(np.float32),
            "a": rng.rand(2, 3, 4, 4).astype(np.float32),
            "b": rng.rand(2, 5, 4, 4).astype(np.float32),
            "c": rng.rand(2, 3, 4, 4).astype(np.float32),
            "d": rng.rand(2, 5, 4, 4).astype(np.float32)}

    def build(p):
        L = p.layers
        s, t = L.data("s", [5], "float32"), L.data("t", [5], "float32")
        a, b = L.data("a", (3, 4, 4), "float32"), \
            L.data("b", (5, 4, 4), "float32")
        c, d = L.data("c", (3, 4, 4), "float32"), \
            L.data("d", (5, 4, 4), "float32")
        sl = SLIM[p]
        out = {"soft_label": lambda: sl.soft_label_loss(s, t, 2.0, 3.0),
               "l2": lambda: sl.l2_distill_loss(s, t),
               "fsp": lambda: sl.fsp_matrix(a, b),
               "fsp_loss": lambda: sl.fsp_loss(a, b, c, d)}[which]()
        return out, out
    (jmain, jscope, jf), (tmain, tscope, tf) = _started_pair(build)
    assert _normalized(tmain) == _normalized(jmain)
    with pt.scope_guard(jscope):
        want = pt.Executor(pt.CPUPlace()).run(jmain, feed=feed,
                                              fetch_list=jf[:1])[0]
    with ptt.scope_guard(tscope):
        got = ptt.Executor(ptt.CPUPlace()).run(tmain, feed=feed,
                                               fetch_list=tf[:1])[0]
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    if which == "fsp":
        np.testing.assert_allclose(
            got, np.einsum("nchw,ndhw->ncd", feed["a"], feed["b"]) / 16.0,
            rtol=1e-5)


def _distill_programs(p, scope):
    """A teacher fc net (its weight from a seed, put in ``scope``) merged
    into a student's program with soft-label and L2 losses and Adam:
    (main, startup, loss, var_map)."""
    w = np.random.RandomState(3).randn(4, 3).astype(np.float32)
    teacher, t_start = p.Program(), p.Program()
    with p.unique_name.guard(), p.program_guard(teacher, t_start):
        x = p.layers.data("x", [4], "float32")
        t_logits = p.layers.fc(x, size=3, bias_attr=False,
                               param_attr=p.ParamAttr(name="t_w"))
    scope.set_var("t_w", torch.from_numpy(w) if p is ptt else
                  jnp.asarray(w))
    main, startup = p.Program(), p.Program()
    with p.unique_name.guard("s_"), p.program_guard(main, startup):
        x = p.layers.data("x", [4], "float32")
        s_logits = p.layers.fc(x, size=3, param_attr=p.ParamAttr(
            name="s_w"))
        var_map = SLIM[p].merge(teacher, main, scope=scope)
        t_out = var_map[t_logits.name]
        loss = p.layers.elementwise_add(
            SLIM[p].soft_label_loss(s_logits, t_out, 2.0, 2.0),
            SLIM[p].l2_distill_loss(s_logits, t_out))
        p.optimizer.Adam(0.05).minimize(loss)
    return main, startup, loss, var_map


def test_merge_program_and_parameter_copies():
    jscope, tscope = pt.Scope(), ptt.Scope()
    jmain, jstart, jloss, jmap = _distill_programs(pt, jscope)
    tmain, tstart, tloss, tmap = _distill_programs(ptt, tscope)
    assert _normalized(tmain) == _normalized(jmain)
    assert sorted(tmap) == sorted(jmap)
    assert tmain.global_block().var("teacher_t_w").trainable is False
    copy, orig = tscope.find_var("teacher_t_w"), tscope.find_var("t_w")
    assert torch.equal(copy, orig)
    assert copy.untyped_storage().data_ptr() != \
        orig.untyped_storage().data_ptr()
    with pt.scope_guard(jscope):
        pt.Executor(pt.CPUPlace()).run(jstart)
    ptt.set_params_from_numpy(_persistables(jmain, jscope), tmain, tscope,
                              ptt.CPUPlace())
    feeds = [{"x": np.random.RandomState(s).rand(16, 4).astype(np.float32)}
             for s in range(6)]
    jl, tl = _train_both(((jmain, jscope, [jloss]),
                          (tmain, tscope, [tloss])), feeds)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    np.testing.assert_array_equal(to_numpy(tscope.find_var("teacher_t_w")),
                                  np.asarray(jscope.find_var("t_w")))


# -------------------------------------------------------------- compressor

def test_compressor_loop_and_checkpoint(tmp_path):
    """Hooks in order, the eval history equal to the JAX package's (from
    the same weights, the same readers), a checkpoint an epoch that the
    JAX package restores."""
    histories, events = {}, {}
    for p in (pt, ptt):
        main, startup = p.Program(), p.Program()
        with p.unique_name.guard(), p.program_guard(main, startup):
            x = p.layers.data("x", [4], "float32")
            y = p.layers.data("y", [1], "float32")
            loss = p.layers.reduce_mean(p.layers.square_error_cost(
                p.layers.fc(x, size=1), y))
            p.optimizer.SGD(0.05).minimize(loss)
        scope = p.Scope()
        if p is pt:
            with p.scope_guard(scope):
                p.Executor(p.CPUPlace()).run(startup)
            state = _persistables(main, scope)
        else:
            ptt.set_params_from_numpy(state, main, scope, ptt.CPUPlace())
        seen = events[p] = []

        class Rec(object):
            def on_compression_begin(self, ctx, seen=seen):
                seen.append("begin")

            def on_epoch_begin(self, ctx, seen=seen):
                seen.append("eb%d" % ctx.epoch_id)

            def on_epoch_end(self, ctx, seen=seen):
                seen.append("ee%d" % ctx.epoch_id)

            def on_compression_end(self, ctx, seen=seen):
                seen.append("end")

        def reader():
            rng = np.random.RandomState(0)
            w = rng.randn(4, 1).astype(np.float32)
            for _ in range(3):
                xs = rng.randn(8, 4).astype(np.float32)
                yield list(zip(xs, (xs @ w).astype(np.float32)))
        blk = main.global_block()
        ck = str(tmp_path / ("ck_" + p.__name__))
        c = SLIM[p].Compressor(
            p.CPUPlace(), scope, main, train_reader=reader,
            train_feed_list=[blk.var("x"), blk.var("y")],
            eval_reader=reader, eval_feed_list=[blk.var("x"), blk.var("y")],
            eval_fetch_list=[loss], epoch=2, strategies=[Rec()],
            checkpoint_path=ck)
        ctx = c.run()
        histories[p] = list(ctx.eval_results.values())[0]
        assert os.path.exists(os.path.join(ck, "latest"))
    assert events[ptt] == events[pt] == ["begin", "eb0", "ee0", "eb1",
                                         "ee1", "end"]
    np.testing.assert_allclose(histories[ptt], histories[pt], rtol=1e-5)
    assert histories[ptt][-1] < histories[ptt][0]
    restored = pt.Scope()
    with pt.scope_guard(restored):
        pt.io.load_checkpoint(pt.Executor(pt.CPUPlace()),
                              str(tmp_path / "ck_paddle_tpu_torch"), main)
    w = [p.name for p in main.all_parameters()][0]
    np.testing.assert_array_equal(np.asarray(restored.find_var(w)),
                                  to_numpy(scope.find_var(w)))


def test_compressor_needs_a_card_by_default():
    main = ptt.Program()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(ptt.NoCUDADeviceError):
        tslim.Compressor(None, ptt.Scope(), main)


# -------------------------------------------------------------- search

def _sa_trajectory(mod, seed, constrained):
    c = mod.SAController(seed=seed)
    target = [3, 1, 4, 1, 5]
    c.reset([8, 1, 8, 8, 8], [0, 0, 0, 0, 0],
            constrain_func=(lambda t: sum(t) <= 14) if constrained else None)
    tokens, out = [0, 0, 0, 0, 0], []
    c.update(tokens, -sum((a - b) ** 2 for a, b in zip(tokens, target)))
    for _ in range(150):
        tokens = c.next_tokens()
        c.update(tokens, -sum((a - b) ** 2 for a, b in zip(tokens, target)))
        out.append(list(tokens))
    return out, c.best_tokens, c.max_reward


@pytest.mark.parametrize("constrained", [False, True])
def test_sa_controller_trajectory_equals_the_jax_package(constrained):
    from paddle_tpu.contrib.slim import searcher as js
    from paddle_tpu_torch.contrib.slim import searcher as ts
    for seed in (0, 7):
        assert _sa_trajectory(ts, seed, constrained) == \
            _sa_trajectory(js, seed, constrained)


def test_light_nas_strategy_equals_the_jax_package():
    from paddle_tpu.contrib.slim import nas as jn
    from paddle_tpu_torch.contrib.slim import nas as tn
    out = {}
    for mod in (jn, tn):
        class Space(mod.SearchSpace):
            def init_tokens(self):
                return [0, 0, 0]

            def range_table(self):
                return [6, 6, 6]
        seen = []

        def reward(t, seen=seen):
            seen.append(list(t))
            return -abs(t[0] - 5) - abs(t[1] - 2) - abs(t[2] - 3)
        best = mod.LightNASStrategy(Space(), search_steps=120,
                                    seed=1).search(reward)
        out[mod] = (best, seen)
    assert out[tn] == out[jn]
    with pytest.raises(NotImplementedError):
        tn.SearchSpace().create_net()


def test_controller_server_handle_without_a_socket():
    """The server's protocol on an SAController, no port bound: the
    tokens an in-process controller of the same seed gives."""
    from paddle_tpu_torch.contrib.slim.nas import ControllerServer
    from paddle_tpu_torch.contrib.slim.searcher import SAController
    served, local = SAController(seed=5), SAController(seed=5)
    for c in (served, local):
        c.reset([4, 4, 4], [0, 0, 0])
    server = ControllerServer(served, address=("127.0.0.1", 0))
    assert server._sock is None
    for step in range(20):
        got = server._handle({"cmd": "next_tokens"})["tokens"]
        want = local.next_tokens()
        assert got == want
        reward = float(sum(got) - step)
        assert server._handle({"cmd": "update", "tokens": got,
                               "reward": reward}) == {"ok": True}
        local.update(want, reward)
    assert server._handle({"cmd": "nope"})["error"].startswith("unknown")
    assert served.best_tokens == local.best_tokens


def test_lock_round_trip(tmp_path):
    from paddle_tpu_torch.contrib.slim.nas import lock
    with open(str(tmp_path / "f"), "w") as f:
        lock.lock(f)
        lock.unlock(f)


# ------------------------------------------------------------------ graph

def test_graph_wrapper_as_the_jax_package():
    from paddle_tpu.contrib.slim.graph import GraphWrapper as JG
    from paddle_tpu_torch.contrib.slim.graph import GraphWrapper as TG
    seen = {}
    for p, G in ((pt, JG), (ptt, TG)):
        main, startup = p.Program(), p.Program()
        with p.unique_name.guard(), p.program_guard(main, startup):
            x = p.layers.data("gw_x", [4], dtype="float32")
            h = p.layers.fc(x, 8, param_attr=p.ParamAttr(name="gw_w"))
            p.layers.reduce_mean(h)
        g = G(main, in_nodes={"x": "gw_x"}, out_nodes={"h": h.name})
        w = g.var("gw_w")
        seen[p] = ([v.name() for v in g.all_parameters()],
                   g.numel_params(), [op.type() for op in g.ops()],
                   [op.type() for op in w.outputs()],
                   [op.type() for op in g.var(h.name).inputs()],
                   [[v.name() for v in op.all_inputs()] for op in g.ops()],
                   w.shape(), g.has_var("nope"))
    assert seen[ptt] == seen[pt]
    with pytest.raises(ValueError):
        g.var("nope")
    from paddle_tpu_torch.contrib.slim.graph import SlimGraphExecutor
    feed = {"gw_x": np.ones((2, 4), np.float32)}
    scope = ptt.Scope()
    with ptt.scope_guard(scope):
        ptt.Executor(ptt.CPUPlace()).run(startup)
    got = SlimGraphExecutor(ptt.CPUPlace()).run(g, scope=scope, data=feed)
    assert got[0].shape == (2, 8)


# ------------------------------------------------------------------ utils

def test_contrib_utils_point_at_the_port():
    from paddle_tpu_torch.contrib.utils import (HDFSClient, hdfs_utils,
                                                lookup_table_utils)
    for call in (HDFSClient, hdfs_utils.multi_download,
                 hdfs_utils.multi_upload):
        with pytest.raises(NotImplementedError) as e:
            call()
        assert "POSIX" in str(e.value) and "TPU" not in str(e.value)
    prog = ptt.Program()
    assert lookup_table_utils.convert_dist_to_sparse_program(prog) is prog
    assert "TPU" not in lookup_table_utils.__doc__
