"""A 2-layer narrow GPT in dygraph mode: the port against the JAX
package's dygraph and against the port's static ``gpt_pretrain_program``.

The model is built the way ``models/gpt.py`` builds a block (pre-LN,
the fused causal attention, the tied-embedding fused head, dropout 0),
from ``dygraph.Embedding``, ``LayerNorm`` and ``Linear`` with the static
layer functions run eagerly; the JAX package has no dygraph model
module, so the model comes from chip_smoke.py's ``_dygraph_gpt`` (the
one the card trains at GPT-base width), loaded from the file and given
either package. Its parameter names map onto the static program's
(``_dygraph_static_names``).

- Against the JAX package's dygraph (vocab 256, hidden 64, 2 layers, 4
  heads, ff 128, batch 4 x 16, Adam 1e-3): fresh weights bit for bit,
  the first loss rtol 1e-5, first-step gradients rtol 1e-4 / atol 1e-6,
  three steps' losses rtol 1e-5 and parameters atol 1e-5 (Adam moves an
  element by about lr a step whatever its gradient's size). The tests
  run in order in one process and share the JAX package's compiled ops.
- Against the port's static program at 4 x 32 tokens (the fused-head
  autograd Function's path) with the same weights: three Adam steps,
  losses and parameters bit for bit (the same ops in the same order on
  the CPU).
- TracedLayer's CPU path over the trained model equals its eager
  forward bit for bit.
"""
import importlib.util
import os

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch.models import gpt as tgpt


def _load_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_smoke = _load_smoke()
_gpt, _static_names = _smoke._dygraph_gpt, _smoke._dygraph_static_names
_inputs = _smoke._dygraph_inputs

CFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
           ff_size=128, max_position=64, dropout=0.0)
FEEDS = _smoke._GPT_FEEDS
LR, STEPS = 1e-3, 3


def _guard(pkg):
    return pt.dygraph.guard() if pkg is pt else \
        ptt.dygraph.guard(ptt.CPUPlace())



def _scalar(v):
    return float(np.asarray(v.numpy()).reshape(()))


def _run(pkg, feed, steps, state=None, grads_at_first=False):
    """(fresh state dict, losses, first-step gradients or None, final
    state dict) of ``steps`` Adam steps from numpy's RNG seeded to 0
    (or from ``state``); ``steps`` 0: one backward, no update."""
    cfg = tgpt.GPTConfig(**CFG)
    np.random.seed(0)
    with _guard(pkg):
        model = _gpt(pkg, cfg)
        fresh = model.state_dict()
        if state is not None:
            model.set_dict(state)
        opt = pkg.dygraph.optimizers.Adam(LR,
                                          parameter_list=model.parameters())
        ins = _inputs(pkg, feed)
        losses, grads = [], None
        for step in range(max(steps, 1)):
            loss, _ = model(*ins)
            loss.backward()
            if step == 0 and grads_at_first:
                grads = {n: p.gradient() for n, p in model.named_parameters()}
            if not steps:
                break
            opt.minimize(loss)
            model.clear_gradients()
            losses.append(_scalar(loss))
        return fresh, losses, grads, model.state_dict()


def _feed(batch, seq):
    return tgpt.synthetic_batch(tgpt.GPTConfig(**CFG), batch, seq, seed=0)


def test_fresh_weights_are_the_jax_packages_bit_for_bit():
    with pt.dygraph.guard():
        np.random.seed(0)
        want = _gpt(pt, tgpt.GPTConfig(**CFG)).state_dict()
    with ptt.dygraph.guard(ptt.CPUPlace()):
        np.random.seed(0)
        got = _gpt(ptt, tgpt.GPTConfig(**CFG)).state_dict()
    assert sorted(got) == sorted(want) == sorted(_static_names(2))
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_loss_matches_the_jax_package():
    feed = _feed(4, 16)
    for pkg in (pt, ptt):
        np.random.seed(0)
        with _guard(pkg):
            loss, ce = _gpt(pkg, tgpt.GPTConfig(**CFG))(*_inputs(pkg, feed))
            if pkg is pt:
                want = (_scalar(loss), np.asarray(ce.numpy()))
            else:
                got = (_scalar(loss), ce.numpy())
    assert got[1].shape == (64, 1)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)


def test_gradients_match_the_jax_package():
    feed = _feed(4, 16)
    _, _, want, _ = _run(pt, feed, 0, grads_at_first=True)
    _, _, got, _ = _run(ptt, feed, 0, grads_at_first=True)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_three_adam_steps_match_the_jax_package():
    feed = _feed(4, 16)
    _, want_l, _, want = _run(pt, feed, STEPS)
    _, got_l, _, got = _run(ptt, feed, STEPS)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    assert got_l[-1] < got_l[0]
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("batch,seq", [(4, 16), (4, 32)],
                         ids=["plain_head", "fused_head"])
def test_matches_the_static_program(batch, seq):
    """The static gpt_pretrain_program's startup weights copied in name
    for name, three Adam steps: the dygraph model gives the static
    program's losses and parameters bit for bit (at 4 x 32 tokens both
    take the fused-head autograd Function)."""
    from paddle_tpu_torch.framework.scope import to_numpy
    cfg = tgpt.GPTConfig(**CFG)
    feed = _feed(batch, seq)
    with ptt.unique_name.guard():
        main, startup, _, fetch = tgpt.gpt_pretrain_program(
            cfg, batch, seq,
            optimizer_fn=lambda l: ptt.optimizer.Adam(LR).minimize(l))
    scope, exe = ptt.Scope(), ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    names = _static_names(cfg.num_layers)
    start = {k: to_numpy(scope.find_var(v)) for k, v in names.items()}
    want_l = [float(np.asarray(exe.run(main, feed=feed,
                                       fetch_list=[fetch["loss"]],
                                       scope=scope)[0]).reshape(()))
              for _ in range(STEPS)]
    _, got_l, _, got = _run(ptt, feed, STEPS, state=start)
    assert got_l == want_l
    for k, v in names.items():
        np.testing.assert_array_equal(got[k], to_numpy(scope.find_var(v)),
                                      err_msg=k)


def test_traced_forward_equals_eager():
    feed = _feed(4, 32)
    cfg = tgpt.GPTConfig(**CFG)
    np.random.seed(0)
    with ptt.dygraph.guard(ptt.CPUPlace()):
        model = _gpt(ptt, cfg)
        opt = ptt.dygraph.optimizers.Adam(LR,
                                          parameter_list=model.parameters())
        ins = _inputs(ptt, feed)
        loss, _ = model(*ins)
        loss.backward()
        opt.minimize(loss)
        model.eval()
        one = [ptt.dygraph.to_variable(feed[k][:1]) for k in FEEDS]
        outs, traced = ptt.dygraph.TracedLayer.trace(model, one)
        with ptt.dygraph.no_grad():
            want = model(*one)
        again = traced(one)
    assert traced.captures == 0          # the CPU runs the forward
    for o, a, w in zip(outs, again, want):
        np.testing.assert_array_equal(o.numpy(), w.numpy())
        np.testing.assert_array_equal(a.numpy(), w.numpy())
        assert not o.value.requires_grad
