"""ERNIE 2.0 multi-task pretraining: the port against the JAX package.

``ernie2_multitask_program`` (static and dynamic task weights, with
``optimizer.Adam``) and ERNIE 2.0-large's program serialize the same in
both packages; ``ernie2_task_schedule`` and ``ernie2_synthetic_batch``
draw the same numbers from the same seed. A tiny ERNIE 2.0 (1 layer,
hidden 32, 4 heads, vocab 512, T=16, 4 masked positions, batch 2,
dropout 0) then takes three Adam steps in both packages with the
schedule's task weights fed each step, the port starting from the JAX
scope's weights and optimizer state. Tolerances (f32 on both sides, only
the order of sums differs), those of tests/test_torch_bert_training.py:
the total and per-task losses rtol 1e-5, final parameters atol 1e-5
(Adam moves an element by about lr = 1e-3 a step whatever its gradient's
size; a task weighted 0 gives its head a gradient of exactly 0, which
moves nothing in either package).
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import optimizer as jopt
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.models import bert as tbert
from test_torch_gpt import _normalized

BATCH, T, PREDS, STEPS, LR = 2, 16, 4, 3, 1e-3
FETCHES = ("loss", "mlm_loss", "reorder_loss", "ir_loss")


def _cfg(bert, **kw):
    base = dict(vocab_size=512, hidden_size=32, num_layers=1, num_heads=4,
                ff_size=64, max_position=32, hidden_dropout=0.0,
                attn_dropout=0.0)
    return bert.BertConfig(**dict(base, **kw))


def _build(pkg, bert, cfg, dynamic=True, batch=BATCH, seq=T):
    opt = jopt if pkg is pt else ptt.optimizer
    with pkg.unique_name.guard():
        return bert.ernie2_multitask_program(
            cfg, batch, seq, PREDS, task_weights=(1.0, 0.5, 2.0),
            dynamic_task_weights=dynamic,
            optimizer_fn=lambda loss: opt.Adam(LR).minimize(loss))


@pytest.mark.parametrize("dynamic", [False, True])
def test_programs_serialize_equal(dynamic):
    j = _build(pt, jbert, _cfg(jbert), dynamic)
    t = _build(ptt, tbert, _cfg(tbert), dynamic)
    assert _normalized(t[0]) == _normalized(j[0])
    assert _normalized(t[1]) == _normalized(j[1])
    assert t[2] == j[2] and ("task_weight" in t[2]) == dynamic
    assert {k: v.name for k, v in t[3].items()} == \
        {k: v.name for k, v in j[3].items()}


def test_ernie2_large_builds_like_jax():
    """BERT-large geometry with the task embedding and the tensor-parallel
    annotations (kept as program metadata), inference program."""
    progs = []
    for pkg, bert in ((pt, jbert), (ptt, tbert)):
        cfg = bert.ernie2_large(vocab_size=1000)
        assert (cfg.hidden_size, cfg.num_layers, cfg.num_heads,
                cfg.ff_size, cfg.tp) == (1024, 24, 16, 4096, True)
        with pkg.unique_name.guard():
            progs.append(bert.ernie2_multitask_program(cfg, 2, 16, PREDS,
                                                       is_test=True))
    (j, _, jfeeds, _), (t, _, tfeeds, _) = progs
    assert _normalized(t) == _normalized(j) and tfeeds == jfeeds
    assert t.global_block().var("word_embedding").sharding == ("mp", None)


def test_task_schedule_and_batch_match_jax():
    for seed in (0, 5):
        j = list(jbert.ernie2_task_schedule(12, (1.0, 2.0, 0.5), seed=seed))
        t = list(tbert.ernie2_task_schedule(12, (1.0, 2.0, 0.5), seed=seed))
        np.testing.assert_array_equal(np.stack(t), np.stack(j))
        assert np.stack(t).dtype == np.float32
        jb = jbert.ernie2_synthetic_batch(_cfg(jbert), 3, T, PREDS, seed)
        tb = tbert.ernie2_synthetic_batch(_cfg(tbert), 3, T, PREDS, seed)
        assert sorted(jb) == sorted(tb) and "labels" not in tb
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k])


def test_dynamic_task_weights_train_like_jax():
    j = _build(pt, jbert, _cfg(jbert))
    t = _build(ptt, tbert, _cfg(tbert))
    feed = jbert.ernie2_synthetic_batch(_cfg(jbert), BATCH, T, PREDS, 0)
    schedule = list(jbert.ernie2_task_schedule(STEPS, seed=1))
    assert len({int(np.argmax(w)) for w in schedule}) > 1
    jscope, jexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    with pt.scope_guard(jscope):
        jexe.run(j[1])
    init = {v.name: np.asarray(jscope.find_var(v.name))
            for v in j[0].list_vars() if v.persistable}
    tscope, texe = ptt.Scope(), ptt.Executor(ptt.CPUPlace())
    ptt.set_params_from_numpy(init, t[0], tscope, ptt.CPUPlace())
    losses = []
    for w in schedule:
        step = dict(feed, task_weight=w)
        with pt.scope_guard(jscope):
            jout = jexe.run(j[0], feed=step,
                            fetch_list=[j[3][k] for k in FETCHES])
        tout = texe.run(t[0], feed=step,
                        fetch_list=[t[3][k] for k in FETCHES], scope=tscope)
        for k, a, b in zip(FETCHES, jout, tout):
            np.testing.assert_allclose(b, np.asarray(a), rtol=1e-5,
                                       err_msg=k)
        # the fed weights pick the trained task's loss
        np.testing.assert_allclose(tout[0], np.dot(w, tout[1:]), rtol=1e-6)
        losses.append(tout)
    for p in t[0].all_parameters():
        np.testing.assert_allclose(tscope.find_var(p.name).numpy(),
                                   np.asarray(jscope.find_var(p.name)),
                                   rtol=0, atol=1e-5, err_msg=p.name)
