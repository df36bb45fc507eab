"""The optimizer slice as a whole: BERT trained with the pretraining
recipe in both packages.

A tiny BERT (2 layers, hidden 64, 4 heads, vocab 512, T = 16, 4 masked
positions, batch 2, dropout 0) trains three steps with the recipe
BERT-base pretraining uses, built in each package through its public
API: AdamW (weight decay 0.01) or Lamb (weight decay 0.01, none on
LayerNorm parameters and biases), a linear warmup over a polynomial
decay, a global-norm clip at 1.0 and ``L2Decay(1e-4)`` on the FFN
weights. The port starts from the JAX scope's weights and optimizer
state (``set_params_from_numpy``); both programs must serialize alike.

Tolerances. f32: per-step losses rtol 1e-5 and the fetched rates rtol
1e-6 (the same f32 ops; the rates against the closed form in
test_torch_lr_schedulers.py), final parameters atol 1e-5 (each step moves
an element by up to about the rate, 1e-3 here, and only the order of
sums differs). bf16: the comparison of test_torch_bf16_training.py
(losses rtol 2e-4; each parameter within 2 * steps * LR plus one bf16
ulp of its tensor's largest value; each tensor's summed change within
0.25 of the JAX package's where its gradient is more than noise).
A tensor whose first-step gradient is rounding noise (at most 1e-6: an
attention key bias, whose gradient is zero in exact arithmetic) steps in
a direction the noise sets in either package: Adam by up to LR an
element a step, LAMB, whose trust ratio scales the direction to the
parameter's norm, by up to LR * ||p||. Such a tensor is held to
2 * steps * LR * max(1, ||p||) only.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.framework.scope import to_numpy
from paddle_tpu_torch.models import bert as tbert
from test_torch_bert_training import _normalized

STEPS, LR, PREDS, BATCH, T = 3, 1e-3, 4, 2, 16
BF16_ULP, CHANGE_RTOL, GRAD_NOISE = 2.0 ** -8, 0.25, 1e-6


def _no_decay(param):
    return param.name.endswith("_ln_s") or param.name.endswith("_ln_b") \
        or param.name.endswith(".b_0")


def _recipe(pkg, kind, fetch):
    """optimizer_fn of the recipe; the schedule's rate lands in
    ``fetch["lr"]``."""
    def fn(loss):
        layers = pkg.layers
        lr = layers.linear_lr_warmup(
            layers.polynomial_decay(LR, decay_steps=6,
                                    end_learning_rate=0.0),
            warmup_steps=2, start_lr=0.0, end_lr=LR)
        fetch["lr"] = lr
        for p in loss.block.program.all_parameters():
            if "_ffn_fc_" in p.name and p.name.endswith(".w_0"):
                p.regularizer = pkg.regularizer.L2Decay(1e-4)
        clip = pkg.clip.GradientClipByGlobalNorm(1.0)
        if kind == "adamw":
            opt = pkg.optimizer.AdamW(learning_rate=lr, weight_decay=0.01,
                                      grad_clip=clip)
        else:
            opt = pkg.optimizer.Lamb(learning_rate=lr, lamb_weight_decay=0.01,
                                     exclude_from_weight_decay_fn=_no_decay,
                                     grad_clip=clip)
        return opt.minimize(loss)
    return fn


def _program(pkg, bert, kind, dtype):
    cfg = bert.BertConfig(vocab_size=512, hidden_size=64, num_layers=2,
                          num_heads=4, ff_size=128, max_position=64,
                          hidden_dropout=0.0, attn_dropout=0.0, dtype=dtype)
    fetch = {}
    with pkg.unique_name.guard():
        main, startup, _, out = bert.bert_pretrain_program(
            cfg, BATCH, T, PREDS, optimizer_fn=_recipe(pkg, kind, fetch))
    return main, startup, [out["loss"], fetch["lr"]], cfg


@pytest.mark.parametrize("kind", ["adamw", "lamb"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bert_recipe_trains_like_jax(kind, dtype):
    jmain, jstart, jfetch, jcfg = _program(pt, jbert, kind, dtype)
    tmain, tstart, tfetch, _ = _program(ptt, tbert, kind, dtype)
    assert _normalized(tmain) == _normalized(jmain)
    assert _normalized(tstart) == _normalized(jstart)
    types = [op.type for op in tmain.global_block().ops]
    n_params = len(tmain.all_parameters())
    assert types.count(kind) == n_params
    assert types.count("squared_l2_norm") == n_params
    assert types.count("increment") == 2
    params = [p.name for p in jmain.all_parameters()]
    grads = [p + "@GRAD" for p in params]
    feed = jbert.synthetic_batch(jcfg, BATCH, T, PREDS, seed=0)

    jscope = pt.Scope()
    with pt.scope_guard(jscope):
        exe = pt.Executor(pt.CPUPlace())
        exe.run(jstart)
        init = {v.name: np.asarray(jscope.find_var(v.name))
                for v in jmain.list_vars() if v.persistable}
        jrun = [exe.run(jmain, feed=feed, fetch_list=jfetch + grads)
                for _ in range(STEPS)]
        jfinal = {p: np.asarray(jscope.find_var(p)).astype(np.float32)
                  for p in params}
    tscope = ptt.Scope()
    ptt.set_params_from_numpy(init, tmain, tscope, ptt.CPUPlace())
    with ptt.scope_guard(tscope):
        exe = ptt.Executor(ptt.CPUPlace())
        trun = [exe.run(tmain, feed=feed, fetch_list=tfetch)
                for _ in range(STEPS)]
        tfinal = {p: to_numpy(tscope.find_var(p)).astype(np.float32)
                  for p in params}

    def col(run, i):
        return [float(np.asarray(r[i]).reshape(())) for r in run]
    np.testing.assert_allclose(col(trun, 1), col(jrun, 1), rtol=1e-6)
    np.testing.assert_allclose(col(trun, 1), [5e-4, LR * 4 / 6, LR * 2 / 6],
                               rtol=1e-6)
    tloss, jloss = col(trun, 0), col(jrun, 0)
    assert tloss[-1] < tloss[0]                  # it trained
    np.testing.assert_allclose(tloss, jloss,
                               rtol=1e-5 if dtype == "float32" else 2e-4)
    noise = {p for p, g in zip(params, jrun[0][2:])
             if np.abs(np.asarray(g).astype(np.float32)).max() <= GRAD_NOISE}
    assert all(p.endswith("_key_fc.b_0") for p in noise), noise
    for p in params:
        want = jfinal[p]
        err = np.abs(tfinal[p] - want).max()
        if p in noise:
            bound = 2 * STEPS * LR * max(1.0, float(np.linalg.norm(want)))
            assert err <= bound, (p, err, bound)
            continue
        if dtype == "float32":
            np.testing.assert_allclose(tfinal[p], want, rtol=0, atol=1e-5,
                                       err_msg=p)
            continue
        bound = 2 * STEPS * LR + BF16_ULP * np.abs(want).max()
        assert err <= bound, (p, err, bound)
        start = np.asarray(init[p]).astype(np.float32)
        change = np.abs(tfinal[p] - want).sum() / np.abs(want - start).sum()
        assert change <= CHANGE_RTOL, (p, change)
