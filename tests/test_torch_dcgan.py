"""DCGAN's one-program, two-optimizer step: the port against the JAX
package, and the in-place rule it needs.

DCGAN minimizes the discriminator's loss (Adam over ``disc_*``), then
the generator's (Adam over ``gen_*``), whose backward runs back through
the discriminator after the discriminator's Adam ops. The JAX package's
values are immutable, so that backward reads the discriminator's weights
from before the update. On the card the fused-Adam kernel updates a
parameter in place, so the port's records keep a copy of such an input
(``trace.overwritten_inputs``); on the CPU the plain Adam is out of
place, so the tests swap in an in-place plain Adam that writes as the
kernel does (through storage autograd does not track) to show the rule
at work, and that without it the generator's gradients go wrong.

Both packages run the same small DCGAN (noise 8, 4 base channels, 8 x 8
images, batch 4) from the JAX startup's persistables on the same seeded
feeds. Tolerances: a step is a few f32 convolutions and matmuls, so
losses and gradients differ only in the order of sums: rtol 1e-5, atol
1e-6. After three Adam steps (lr 2e-4, so a parameter moves at most
6e-4) parameters and moments agree to rtol 1e-4, atol 1e-6.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.models import dcgan as jdcgan
from paddle_tpu_torch.framework import trace
from paddle_tpu_torch.models import dcgan as tdcgan
from paddle_tpu_torch.models import simple as tsimple
from paddle_tpu_torch.ops import optimizer_ops
from paddle_tpu_torch.ops.kernels import fused_adam

CFG = dict(noise_dim=8, base_channels=4, image_size=8, image_channels=1)
BATCH = 4
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
STATE_TOL = dict(rtol=1e-4, atol=1e-6)


def _programs(pkg, mod):
    with pkg.unique_name.guard():
        main, startup, feeds, fetch = mod.dcgan_train_program(
            mod.DCGANConfig(**CFG))
    return main, startup, [fetch["d_loss"], fetch["g_loss"]]


def _grad_names(main, prefix):
    return sorted(p.name + "@GRAD" for p in main.all_parameters()
                  if p.name.startswith(prefix))


def _feed(step):
    return tdcgan.synthetic_batch(tdcgan.DCGANConfig(**CFG), BATCH,
                                  seed=step)


def _train_both(steps, extra_fetch=()):
    """``steps`` steps in both packages from the JAX startup: the fetches
    (losses and ``extra_fetch``) of every step and the final persistables,
    (jax, port) each."""
    jmain, jstart, jfetch = _programs(pt, jdcgan)
    tmain, _, tfetch = _programs(ptt, tdcgan)
    jscope, jexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    with pt.scope_guard(jscope):
        jexe.run(jstart)
    names = sorted(v.name for v in jmain.list_vars() if v.persistable)
    tscope = ptt.Scope()
    ptt.set_params_from_numpy(
        {n: np.asarray(jscope.find_var(n)) for n in names}, tmain, tscope,
        ptt.CPUPlace())
    texe = ptt.Executor(ptt.CPUPlace())
    jouts, touts = [], []
    for step in range(steps):
        with pt.scope_guard(jscope):
            jouts.append(jexe.run(jmain, feed=_feed(step),
                                  fetch_list=jfetch + list(extra_fetch)))
        touts.append(texe.run(tmain, feed=_feed(step),
                              fetch_list=tfetch + list(extra_fetch),
                              scope=tscope))
    jstate = {n: np.asarray(jscope.find_var(n)) for n in names}
    tstate = {n: ptt.framework.scope.to_numpy(tscope.find_var(n))
              for n in names}
    return (jouts, jstate), (touts, tstate)


def _in_place_adam(p, g, m1, m2, *args, **kw):
    """The plain Adam writing p, m1 and m2 in place through ``.data``, as
    the kernel writes through raw pointers: no autograd version bump."""
    p_new, m1_new, m2_new = fused_adam.fused_adam_plain(p, g, m1, m2, *args,
                                                        **kw)
    for t, new in ((p, p_new), (m1, m1_new), (m2, m2_new)):
        t.data.copy_(new)
    return p, m1, m2


def test_two_optimizers_scope_their_parameters():
    """The discriminator's six Adam ops update ``disc_*`` only and come
    first; the generator's ten update ``gen_*`` only; the op order and
    each Adam's parameter equal the JAX package's."""
    jmain, _, _ = _programs(pt, jdcgan)
    tmain, _, _ = _programs(ptt, tdcgan)

    def adams(main):
        return [op.input("Param")[0] for op in main.global_block().ops
                if op.type == "adam"]
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    got = adams(tmain)
    assert got == adams(jmain)
    assert len(got) == 16
    assert all(n.startswith("disc_") for n in got[:6])
    assert all(n.startswith("gen_") for n in got[6:])


def test_shared_discriminator_gradients_are_summed():
    """Each discriminator parameter's gradient is a ``sum`` of its real
    and fake branches' contributions, equal to the JAX package's."""
    tmain, _, _ = _programs(ptt, tdcgan)
    sums = {op.output("Out")[0]: op.input("X")
            for op in tmain.global_block().ops if op.type == "sum"}
    disc = _grad_names(tmain, "disc_")
    assert sorted(sums) == disc
    assert all(len(ins) == 2 for ins in sums.values())
    (jouts, _), (touts, _) = _train_both(1, disc)
    for j, t in zip(jouts[0], touts[0]):
        np.testing.assert_allclose(t, np.asarray(j), **GRAD_TOL)


def test_dcgan_trains_like_the_jax_package():
    """Three steps: losses, the generator's gradients of each step and the
    final parameters, moments and moving statistics."""
    tmain, _, _ = _programs(ptt, tdcgan)
    (jouts, jstate), (touts, tstate) = _train_both(
        3, _grad_names(tmain, "gen_"))
    for jo, to in zip(jouts, touts):
        for j, t in zip(jo, to):
            np.testing.assert_allclose(t, np.asarray(j), **GRAD_TOL)
    for n in jstate:
        np.testing.assert_allclose(tstate[n], jstate[n], err_msg=n,
                                   **STATE_TOL)


def test_the_in_place_rule_keeps_the_generators_gradients(monkeypatch):
    """With Adam updating in place, as the kernel does on the card, the
    generator's gradients still equal the JAX package's: the records of
    the discriminator's fake-branch ops keep copies of its six
    parameters. Without the rule the same run's generator gradients read
    the updated weights and differ."""
    tmain, _, _ = _programs(ptt, tdcgan)
    gen = _grad_names(tmain, "gen_")
    kept = trace.overwritten_inputs(tmain.global_block(),
                                    trace.wanted_grads(
                                        tmain.global_block())[1])
    blk = tmain.global_block()
    copied = sorted(op.input(slot)[i] for op in blk.ops
                    if op.desc_id in kept
                    for slot, idx in kept[op.desc_id].items() for i in idx)
    assert copied == sorted(p.name for p in tmain.all_parameters()
                            if p.name.startswith("disc_"))
    monkeypatch.setattr(optimizer_ops._adam_kernel, "fused_adam",
                        _in_place_adam)
    (jouts, _), (touts, _) = _train_both(2, gen)
    for jo, to in zip(jouts, touts):
        for j, t in zip(jo, to):
            np.testing.assert_allclose(t, np.asarray(j), **GRAD_TOL)
    monkeypatch.setattr(trace, "overwritten_inputs", lambda *a: {})
    (jouts, _), (touts, _) = _train_both(1, gen)
    far = [not np.allclose(t, np.asarray(j), **GRAD_TOL)
           for j, t in zip(jouts[0][2:], touts[0][2:])]
    assert any(far)


@pytest.mark.parametrize("program", ["mlp", "word2vec"])
def test_a_program_that_updates_after_its_gradients_copies_nothing(
        program):
    """Every gradient of a single ``minimize`` runs before its optimizer
    ops: the rule keeps nothing, so such a plan runs as before."""
    with ptt.unique_name.guard():
        build = tsimple.mlp_classifier_program if program == "mlp" else \
            tsimple.word2vec_program
        main = build(optimizer_fn=lambda loss: ptt.optimizer.Adam(
            1e-3).minimize(loss))[0]
    blk = main.global_block()
    assert trace.overwritten_inputs(blk, trace.wanted_grads(blk)[1]) == {}
