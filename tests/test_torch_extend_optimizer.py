"""GradientMergeOptimizer and PipelineOptimizer
(paddle_tpu_torch/contrib/extend_optimizer.py) against the JAX package's.

- The JAX test's SGD case (tests/test_contrib.py): a parameter whose
  gradient is 1 every run, k_steps 4, averaged: the values after each of
  eight runs are [0, 0, 0, -1, -1, -1, -1, -2] in both packages.
- The program: the same op list (types, order, names) and persistables
  (the ``*.grad_acc_*`` buffers, ``@GRAD_MERGE_STEP@``).
- Tiny BERT (dropout 0) under GradientMerge over Adam, eight runs (two
  windows) from the JAX startup's persistables: losses within rtol 2e-5
  (f32 on both sides, another summation order; measured ~1e-7), every
  parameter, moment and accumulator within 1e-5 absolute (three Adam
  applies move an element by ~3e-3), and the reference's rule pinned in
  the port: a run that does not apply hands Adam a zero gradient, so its
  moments decay by beta1 / beta2 bit for bit and, in the first window
  (moments still 0), the parameters stay bit-equal; an apply run zeroes
  the accumulators.
- A resume in the middle of a window (after run K + 1 of K + 2) through
  ``io.save_checkpoint`` / ``io.load_checkpoint`` (run counter, step
  counter and accumulators included) equals the uninterrupted run bit
  for bit in the port, and in the JAX package too.
- PipelineOptimizer annotates ``pipeline_stage`` as the JAX package does
  and trains through its inner optimizer.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.contrib import extend_optimizer as jext
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.contrib import extend_optimizer as text
from paddle_tpu_torch.framework.scope import to_numpy
from paddle_tpu_torch.models import bert as tbert

EXT = {pt: jext, ptt: text}
BERT = {pt: jbert, ptt: tbert}
TINY_BERT = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                 ff_size=128, max_position=64, hidden_dropout=0.0,
                 attn_dropout=0.0)
K, RUNS, LR = 4, 8, 1e-3


def _sgd_case(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        w = pkg.layers.create_parameter(
            [1], "float32", name="w_gm",
            default_initializer=pkg.initializer.Constant(0.0))
        loss = pkg.layers.reduce_sum(w)       # gradient 1 every run
        EXT[pkg].GradientMergeOptimizer(pkg.optimizer.SGD(1.0), k_steps=K,
                                        avg=True).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("pkg", [pt, ptt], ids=["jax", "torch"])
def test_sgd_updates_land_on_apply_steps(pkg):
    main, startup, loss = _sgd_case(pkg)
    scope = pkg.Scope()
    vals = []
    with pkg.scope_guard(scope):
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup)
        for _ in range(RUNS):
            exe.run(main, feed={}, fetch_list=[loss])
            v = scope.find_var("w_gm")
            vals.append(float(np.asarray(
                to_numpy(v) if pkg is ptt else v).reshape(-1)[0]))
    np.testing.assert_allclose(vals, [0, 0, 0, -1, -1, -1, -1, -2],
                               atol=1e-6)


def _bert(pkg, inner="adam"):
    cfg = BERT[pkg].BertConfig(**TINY_BERT)

    def opt_fn(loss):
        opt = pkg.optimizer.Adam(LR)
        if inner == "pipeline":
            return EXT[pkg].PipelineOptimizer(opt, num_stages=2).minimize(
                loss)
        return EXT[pkg].GradientMergeOptimizer(opt, k_steps=K).minimize(
            loss)
    with pkg.unique_name.guard():
        main, startup, _, fetch = BERT[pkg].bert_pretrain_program(
            cfg, 2, 16, 4, optimizer_fn=opt_fn)
    return main, startup, fetch["loss"]


def test_gradient_merge_program_is_the_jax_program():
    a, b = _bert(pt)[0], _bert(ptt)[0]
    assert [(op.type, op.inputs, op.outputs) for op in
            b.global_block().ops] == \
        [(op.type, op.inputs, op.outputs) for op in a.global_block().ops]
    pa = sorted(v.name for v in a.list_vars() if v.persistable)
    pb = sorted(v.name for v in b.list_vars() if v.persistable)
    assert pb == pa
    assert "@GRAD_MERGE_STEP@" in pb
    assert len([n for n in pb if ".grad_acc" in n]) == \
        len(b.all_parameters())


def _feed():
    return jbert.synthetic_batch(jbert.BertConfig(**TINY_BERT), 2, 16, 4,
                                 seed=0)


def _jax_runs(runs, feed):
    main, startup, loss = _bert(pt)
    scope = pt.Scope()
    persist = [v.name for v in main.list_vars() if v.persistable]
    with pt.scope_guard(scope):
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup)
        init = {n: np.asarray(scope.find_var(n)) for n in persist}
        losses = [float(np.asarray(exe.run(main, feed=feed,
                                           fetch_list=[loss])[0]).reshape(()))
                  for _ in range(runs)]
        final = {n: np.asarray(scope.find_var(n)) for n in persist}
    return init, losses, final


def test_gradient_merge_over_adam_trains_like_jax():
    feed = _feed()
    init, jlosses, jfinal = _jax_runs(RUNS, feed)
    main, _, loss = _bert(ptt)
    params = [p.name for p in main.all_parameters()]
    moments = {p: ("%s_moment1_0" % p, "%s_moment2_0" % p) for p in params}
    accs = [v.name for v in main.list_vars() if ".grad_acc" in v.name]
    scope = ptt.Scope()
    ptt.set_params_from_numpy(init, main, scope, ptt.CPUPlace())

    def state(names):
        return {n: to_numpy(scope.find_var(n)).copy() for n in names}
    losses = []
    with ptt.scope_guard(scope):
        exe = ptt.Executor(ptt.CPUPlace())
        for run in range(1, RUNS + 1):
            before = state(params + [m for ms in moments.values()
                                     for m in ms])
            losses.append(float(exe.run(main, feed=feed,
                                        fetch_list=[loss])[0].reshape(())))
            after = state(params + [m for ms in moments.values()
                                    for m in ms])
            if run % K == 0:
                for a in accs:
                    assert not to_numpy(scope.find_var(a)).any(), (run, a)
                continue
            for p, (m1, m2) in moments.items():
                np.testing.assert_array_equal(
                    after[m1], np.float32(0.9) * before[m1])
                np.testing.assert_array_equal(
                    after[m2], np.float32(0.999) * before[m2])
                if run < K:
                    np.testing.assert_array_equal(after[p], before[p])
        final = {n: to_numpy(scope.find_var(n)) for n in jfinal}
    np.testing.assert_allclose(losses, jlosses, rtol=2e-5)
    for n, want in jfinal.items():
        np.testing.assert_allclose(final[n], want, rtol=0, atol=1e-5,
                                   err_msg=n)


def _resumed(pkg, feed, tmp, split, runs=K + 2):
    """``split`` runs, a checkpoint, a fresh Executor and scope restored
    from it, ``runs`` - split more runs: (losses, final persistables)."""
    main, startup, loss = _bert(pkg)
    persist = [v.name for v in main.list_vars() if v.persistable]
    get = (lambda s, n: to_numpy(s.find_var(n))) if pkg is ptt else \
        (lambda s, n: np.asarray(s.find_var(n)))
    losses = []
    scope = pkg.Scope()
    with pkg.scope_guard(scope):
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup)
        for _ in range(runs if split is None else split):
            losses.append(np.asarray(exe.run(main, feed=feed,
                                             fetch_list=[loss])[0]))
        if split is None:
            return losses, {n: get(scope, n) for n in persist}
        pkg.io.save_checkpoint(exe, str(tmp), main, step=split)
    scope = pkg.Scope()
    with pkg.scope_guard(scope):
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup)
        pkg.io.load_checkpoint(exe, str(tmp), main)
        for _ in range(runs - split):
            losses.append(np.asarray(exe.run(main, feed=feed,
                                             fetch_list=[loss])[0]))
        return losses, {n: get(scope, n) for n in persist}


@pytest.mark.parametrize("pkg", [pt, ptt], ids=["jax", "torch"])
def test_resume_mid_window_equals_the_uninterrupted_run(pkg, tmp_path):
    feed = _feed()
    want_losses, want = _resumed(pkg, feed, tmp_path, None)
    got_losses, got = _resumed(pkg, feed, tmp_path, K + 1)
    for a, b in zip(got_losses, want_losses):
        np.testing.assert_array_equal(a, b)
    for n, v in want.items():
        np.testing.assert_array_equal(got[n], v, err_msg=n)


def test_pipeline_optimizer_annotates_stages_as_jax():
    stages = []
    for pkg in (pt, ptt):
        main = _bert(pkg, inner="pipeline")[0]
        stages.append([(p.name, p.pipeline_stage)
                       for p in main.all_parameters()])
    assert stages[1] == stages[0]
    assert {s for _, s in stages[1]} == {0, 1}
    main, startup, loss = _bert(ptt, inner="pipeline")
    with ptt.scope_guard(ptt.Scope()):
        exe = ptt.Executor(ptt.CPUPlace())
        exe.run(startup)
        feed = _feed()
        first = float(exe.run(main, feed=feed, fetch_list=[loss])[0][0])
        for _ in range(3):
            last = float(exe.run(main, feed=feed, fetch_list=[loss])[0][0])
    assert last < first
