"""The BERT training slice as a whole: the port against the JAX package.

``bert_pretrain_program`` with ``optimizer.Adam`` is built by both
packages and must serialize the same. A tiny BERT (2 layers, hidden 64,
4 heads, vocab 512, T=16, 4 masked positions, batch 2, dropout 0) then
trains ten Adam steps in both, the port starting from the JAX scope's
weights and optimizer state (``set_params_from_numpy``). The JAX side
runs twice: with its default Executor (XLA lowering) and through
``CompiledProgram`` with ``use_pallas={"layer_norm", "adam"}`` and
``attn_impl="flash"``, where all four of this slice's Pallas kernels
(flash-attention dK/dV and dQ, LayerNorm backward, fused Adam) and both
forward kernels run in interpret mode.

Tolerances (f32 on both sides; only the order of sums differs): the
first step's gradients agree to rtol 1e-4 with atol 1e-6 (the largest
are of order 1, and some parameters' gradients are ~1e-7, where only
the absolute bound means anything); per-step losses to rtol 1e-5. Final
parameters to atol 1e-5: Adam scales each step to about lr = 1e-3 per
element whatever the gradient's size, so a gradient near zero could move
an element by up to 2e-3 if its sign differed; none does here (measured
1.4e-6), and the bound holds that.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework.compiler import BuildStrategy, CompiledProgram
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.models import bert as tbert

BATCH, T, PREDS, STEPS, LR = 2, 16, 4, 10, 1e-3


def _cfg(bert, **kw):
    base = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                ff_size=128, max_position=64, hidden_dropout=0.0,
                attn_dropout=0.0)
    return bert.BertConfig(**dict(base, **kw))


def _build(pkg, bert, opt, cfg, batch=BATCH):
    with pkg.unique_name.guard():
        return bert.bert_pretrain_program(
            cfg, batch, T, PREDS,
            optimizer_fn=lambda loss: opt.Adam(LR).minimize(loss))


def _normalized(program):
    """The program's JSON with desc_ids renumbered by position (both
    packages count ops with a process-wide counter) and grad_of's fwd_id
    mapped the same way."""
    d = program.to_dict()
    ids = {}
    for blk in d["blocks"]:
        for op in blk["ops"]:
            ids[op.pop("desc_id")] = len(ids)
    for blk in d["blocks"]:
        for op in blk["ops"]:
            if "fwd_id" in op["attrs"]:
                op["attrs"]["fwd_id"] = ids[op["attrs"]["fwd_id"]]
    return d


@pytest.mark.parametrize("size", ["tiny", "base"])
def test_pretrain_programs_serialize_equal(size):
    """Same op types, attrs, var and parameter names (Adam accumulators
    included) as the JAX package, at a tiny config and at BERT-base's
    published widths; BERT-base has the op counts the chip run checks."""
    kw = {} if size == "tiny" else dict(
        vocab_size=30522, hidden_size=768, num_layers=12, num_heads=12,
        ff_size=3072, max_position=512, hidden_dropout=0.1,
        attn_dropout=0.1)
    jmain, jstart, jfeeds, jfetch = _build(pt, jbert, jopt, _cfg(jbert, **kw))
    tmain, tstart, tfeeds, tfetch = _build(ptt, tbert, ptt.optimizer,
                                           _cfg(tbert, **kw))
    assert _normalized(tmain) == _normalized(jmain)
    assert _normalized(tstart) == _normalized(jstart)
    assert tfeeds == jfeeds
    assert {k: v.name for k, v in tfetch.items()} == \
        {k: v.name for k, v in jfetch.items()}
    if size == "base":
        types = [op.type for op in tmain.global_block().ops]
        assert len(types) == 984
        assert [types.count(t) for t in (
            "adam", "layer_norm", "scaled_dot_product_attention",
            "dropout")] == [206, 26, 12, 37]


def test_synthetic_batch_matches_jax():
    for seed in (0, 3):
        j = jbert.synthetic_batch(_cfg(jbert), 3, T, PREDS, seed=seed)
        t = tbert.synthetic_batch(_cfg(tbert), 3, T, PREDS, seed=seed)
        assert sorted(j) == sorted(t)
        for k in j:
            np.testing.assert_array_equal(t[k], j[k])


def _spy_pallas(monkeypatch):
    """Record the kernel function of every pallas_call traced."""
    import jax.experimental.pallas as jpl
    seen, orig = set(), jpl.pallas_call

    def spy(kernel, *args, **kwargs):
        seen.add(getattr(getattr(kernel, "func", kernel), "__name__", ""))
        return orig(kernel, *args, **kwargs)
    monkeypatch.setattr(jpl, "pallas_call", spy)
    return seen


@pytest.mark.parametrize("route", ["xla", "pallas_interpret"])
def test_tiny_bert_trains_like_jax(route, monkeypatch):
    impl = "flash" if route == "pallas_interpret" else "auto"
    jmain, jstart, _, jfetch = _build(pt, jbert, jopt,
                                      _cfg(jbert, attn_impl=impl))
    tmain, _, _, tfetch = _build(ptt, tbert, ptt.optimizer,
                                 _cfg(tbert, attn_impl=impl))
    params = [p.name for p in jmain.all_parameters()]
    grads = [p + "@GRAD" for p in params]
    feed = jbert.synthetic_batch(_cfg(jbert), BATCH, T, PREDS, seed=0)
    seen = _spy_pallas(monkeypatch)

    jscope = pt.Scope()
    with pt.scope_guard(jscope):
        exe = pt.Executor(pt.CPUPlace())
        exe.run(jstart)
        init = {v.name: np.asarray(jscope.find_var(v.name))
                for v in jmain.list_vars() if v.persistable}
        prog = jmain
        if route == "pallas_interpret":
            bs = BuildStrategy()
            bs.mesh_axes = {"dp": 1}
            bs.use_pallas = frozenset({"layer_norm", "adam"})
            bs.kernel_policy = "pallas"
            prog = CompiledProgram(jmain, bs)
        jrun = [exe.run(prog, feed=feed,
                        fetch_list=[jfetch["loss"]] + (grads if s == 0
                                                       else []))
                for s in range(STEPS)]
        jfinal = {p: np.asarray(jscope.find_var(p)) for p in params}
    if route == "pallas_interpret":
        assert {"_fwd_kernel", "_bwd_dkv_kernel", "_bwd_dq_kernel",
                "_ln_fwd_kernel", "_ln_bwd_kernel", "_adam_kernel"} <= seen
    else:
        assert not seen

    tscope = ptt.Scope()
    ptt.set_params_from_numpy(init, tmain, tscope, ptt.CPUPlace())
    with ptt.scope_guard(tscope):
        exe = ptt.Executor(ptt.CPUPlace())
        trun = [exe.run(tmain, feed=feed,
                        fetch_list=[tfetch["loss"]] + (grads if s == 0
                                                       else []))
                for s in range(STEPS)]
        tfinal = {p: tscope.find_var(p).numpy() for p in params}

    for name, j, t in zip(grads, jrun[0][1:], trun[0][1:]):
        np.testing.assert_allclose(t, np.asarray(j), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    jloss = [float(np.asarray(r[0]).reshape(())) for r in jrun]
    tloss = [float(r[0].reshape(())) for r in trun]
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    assert tloss[-1] < tloss[0] - 1.0          # it trained
    for p in params:
        np.testing.assert_allclose(tfinal[p], jfinal[p], rtol=0, atol=1e-5,
                                   err_msg=p)


def test_training_step_frees_its_autograd_records():
    """After a step the Executor holds no graph: the scope's tensors are
    plain leaves, and a second run of the same program repeats the first
    step's loss from the same state."""
    tmain, tstart, _, tfetch = _build(ptt, tbert, ptt.optimizer, _cfg(tbert))
    feed = tbert.synthetic_batch(_cfg(tbert), BATCH, T, PREDS, seed=0)
    losses = []
    for _ in range(2):
        scope = ptt.Scope()
        tstart.random_seed = 5
        exe = ptt.Executor(ptt.CPUPlace())
        exe.run(tstart, scope=scope)
        out, = exe.run(tmain, feed=feed, fetch_list=[tfetch["loss"]],
                       scope=scope)
        losses.append(float(out.reshape(())))
        for name in scope.keys():
            val = scope.find_var(name)
            if hasattr(val, "requires_grad"):
                assert not val.requires_grad and val.grad_fn is None, name
    assert losses[0] == losses[1]


def test_recompute_waits_for_a_later_slice():
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        feeds = [ptt.layers.data(n, [T, 1], dtype=d) for n, d in (
            ("src_ids", "int64"), ("pos_ids", "int64"),
            ("sent_ids", "int64"), ("input_mask", "float32"))]
        with pytest.raises(ptt.NotPortedError, match="later slice"):
            tbert.bert_encoder(*feeds, _cfg(tbert, recompute=True))
