"""The port's Executor.run_steps and what its compiled step relies on.

``run_steps`` (the counterpart of paddle_tpu's ``Executor.run_steps``,
which scans N steps as one device program) runs a window of steps from
stacked feeds. On the CPU it is N op-by-op steps; on a CUDA card each
step is a replay of the key's captured graph (chip_smoke.py checks that
path on the card). These tests hold it against the JAX package's
``run_steps`` from copied weights (a tiny BERT: 2 layers, hidden 64,
dropout 0; stacked losses to rtol 1e-5, final parameters to atol 1e-5,
the tolerances of tests/test_torch_bert_training.py, for the same
reason: f32 on both sides, only the order of sums differs) and against
N sequential port runs bit for bit, with and without dropout. They also
pin the stacking errors, the random stream across ``run`` and
``run_steps`` and a recomputed segment's mask, that a CPU Executor
never captures, and the two ops made capture-safe (``accuracy``,
``assign_value``), whose values must not change. The graph key holds
each state tensor's shape, and a captured step refuses to copy a value
of another shape into its static input.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework.compiler import BuildStrategy, CompiledProgram
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.models import bert as tbert

BATCH, T, PREDS, STEPS, LR = 2, 16, 4, 4, 1e-3


def _cfg(bert, drop=0.0, **kw):
    return bert.BertConfig(**dict(
        dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
             ff_size=128, max_position=64, hidden_dropout=drop,
             attn_dropout=drop), **kw))


def _build(pkg, bert, opt, cfg):
    with pkg.unique_name.guard():
        return bert.bert_pretrain_program(
            cfg, BATCH, T, PREDS,
            optimizer_fn=lambda loss: opt.Adam(LR).minimize(loss))


def _window(bert, cfg, n=STEPS):
    """n batches (seeds 0..n-1) and the same stacked on a steps axis."""
    batches = [bert.synthetic_batch(cfg, BATCH, T, PREDS, seed=s)
               for s in range(n)]
    return batches, {k: np.stack([b[k] for b in batches])
                     for k in batches[0]}


@pytest.mark.parametrize("route", [
    "xla", pytest.param("pallas_interpret", marks=pytest.mark.slow)])
def test_run_steps_matches_the_jax_package(route):
    """Through the JAX package's XLA route, and (``slow``: ~17 s on a CPU)
    through ``CompiledProgram`` with its Pallas kernels in interpret
    mode, as tests/test_torch_bert_training.py runs them."""
    impl = "flash" if route == "pallas_interpret" else "auto"
    jmain, jstart, _, jfetch = _build(pt, jbert, jopt,
                                      _cfg(jbert, attn_impl=impl))
    tmain, _, _, tfetch = _build(ptt, tbert, ptt.optimizer,
                                 _cfg(tbert, attn_impl=impl))
    params = [p.name for p in jmain.all_parameters()]
    _, window = _window(jbert, _cfg(jbert))

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
        jloss, = exe.run_steps(prog, feed=window,
                               fetch_list=[jfetch["loss"]])
        jfinal = {p: np.asarray(jscope.find_var(p)) for p in params}

    tscope = ptt.Scope()
    ptt.set_params_from_numpy(init, tmain, tscope, ptt.CPUPlace())
    exe = ptt.Executor(ptt.CPUPlace())
    tloss, = exe.run_steps(tmain, feed=window, fetch_list=[tfetch["loss"]],
                           scope=tscope)
    assert tloss.shape[0] == STEPS
    np.testing.assert_allclose(tloss.reshape(-1),
                               np.asarray(jloss).reshape(-1), rtol=1e-5)
    for p in params:
        np.testing.assert_allclose(tscope.find_var(p).numpy(), jfinal[p],
                                   rtol=0, atol=1e-5, err_msg=p)


def _trained(drop, stacked, recompute=False):
    """STEPS steps of the tiny BERT from one seeded startup, as one
    run_steps window (``stacked``) or as STEPS runs: (losses as tensors,
    the final persistables)."""
    cfg = _cfg(tbert, drop, recompute=recompute)
    main, startup, _, fetch = _build(ptt, tbert, ptt.optimizer, cfg)
    startup.random_seed = 7
    batches, window = _window(tbert, cfg)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    fetch_list = [fetch["loss"], fetch["mlm_loss"]]
    if stacked:
        losses = exe.run_steps(main, feed=window, fetch_list=fetch_list,
                               scope=scope, return_numpy=False)
    else:
        runs = [exe.run(main, feed=b, fetch_list=fetch_list, scope=scope,
                        return_numpy=False) for b in batches]
        losses = [torch.stack(col) for col in zip(*runs)]
    state = {v.name: scope.find_var(v.name) for v in main.list_vars()
             if v.persistable}
    return losses, state


@pytest.mark.parametrize("drop", [0.0, 0.1])
def test_run_steps_equals_sequential_runs_bit_for_bit(drop):
    """The counterpart of tests/test_executor_scan.py:37, held to equal
    bits: stacked fetches and every persistable afterwards (parameters,
    moments, beta powers)."""
    (w_losses, w_state), (s_losses, s_state) = (
        _trained(drop, True), _trained(drop, False))
    for a, b in zip(w_losses, s_losses):
        assert a.shape == (STEPS,) + tuple(b.shape[1:])
        assert torch.equal(a, b)
    assert sorted(w_state) == sorted(s_state)
    for name, t in w_state.items():
        assert torch.equal(t, s_state[name]), name
    assert float(w_losses[0][-1].reshape(())) < \
        float(w_losses[0][0].reshape(()))


def _mlp():
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = ptt.layers.data("x", [8, 4], "float32", append_batch_size=False)
        y = ptt.layers.data("y", [8, 1], "float32", append_batch_size=False)
        h = ptt.layers.dropout(ptt.layers.fc(x, 16, act="tanh"), 0.3)
        out = ptt.layers.fc(h, 1)
        loss = ptt.layers.mean(ptt.layers.square(
            ptt.layers.elementwise_sub(out, y)))
        ptt.optimizer.Adam(1e-2).minimize(loss)
    return main, startup, loss


def _xy(n, seed=0):
    rng = np.random.RandomState(seed)
    xs = rng.randn(n, 8, 4).astype(np.float32)
    return xs, (xs.sum(axis=2, keepdims=True) > 0).astype(np.float32)


def test_run_steps_validates_stacking():
    """The JAX package's ValueErrors (tests/test_executor_scan.py:74,101),
    under the same conditions."""
    main, startup, loss = _mlp()
    xs, ys = _xy(3)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    salt = scope.find_var("@EAGER_SALT@")
    with pytest.raises(ValueError, match="leading steps axis"):
        exe.run_steps(main, feed={"x": xs, "y": ys[:2]}, fetch_list=[loss],
                      scope=scope)
    with pytest.raises(ValueError, match="leading steps axis"):
        exe.run_steps(main, feed={"x": xs, "y": np.float32(1.0)},
                      fetch_list=[loss], scope=scope)
    with pytest.raises(ValueError, match="rank"):
        exe.run_steps(main, feed={"x": xs[:, 0], "y": ys},
                      fetch_list=[loss], scope=scope)
    with pytest.raises(ValueError, match="at least one step"):
        exe.run_steps(main, feed={"x": xs[:0], "y": ys[:0]},
                      fetch_list=[loss], scope=scope)
    with pytest.raises(ValueError, match="fetch_list"):
        exe.run_steps(main, feed={"x": xs, "y": ys}, scope=scope)
    with pytest.raises(ValueError, match="stacked feeds"):
        exe.run_steps(main, feed={}, fetch_list=[loss], scope=scope)
    # nothing ran: the run counter did not move
    assert scope.find_var("@EAGER_SALT@") == salt


def test_random_stream_carries_on_across_run_and_run_steps():
    """The counterpart of tests/test_executor_scan.py:232: a run after a
    run_steps window draws what the same run after as many runs draws; a
    fresh Executor on the same scope carries the stream on; consecutive
    steps draw other masks."""
    n = 3
    xs, ys = _xy(n + 2, seed=7)
    main, startup, loss = _mlp()

    def start():
        scope = ptt.Scope()
        ptt.Executor(ptt.CPUPlace()).run(startup, scope=scope)
        return scope

    s1 = start()
    exe = ptt.Executor(ptt.CPUPlace())
    seq = [float(exe.run(main, feed={"x": xs[i], "y": ys[i]},
                         fetch_list=[loss], scope=s1)[0])
           for i in range(n + 2)]
    s2 = start()
    exe = ptt.Executor(ptt.CPUPlace())
    first = float(exe.run(main, feed={"x": xs[0], "y": ys[0]},
                          fetch_list=[loss], scope=s2)[0])
    window, = exe.run_steps(main, feed={"x": xs[1:n], "y": ys[1:n]},
                            fetch_list=[loss], scope=s2)
    after = [float(ptt.Executor(ptt.CPUPlace()).run(
        main, feed={"x": xs[i], "y": ys[i]}, fetch_list=[loss],
        scope=s2)[0]) for i in (n, n + 1)]
    assert [first] + [float(v) for v in window.reshape(-1)] + after == seq


def test_a_recomputed_segment_draws_its_forward_mask_in_every_step():
    """A seedless dropout inside a recompute segment, through a run_steps
    window: each step's gradient of sum(c * dropout(2 w)) is 4 c where
    that step's forward kept an element and 0 where it dropped it, the
    masks differ between steps, and the window equals as many runs."""
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        w = ptt.layers.create_parameter(
            [64, 32], "float32", name="w",
            default_initializer=ptt.initializer.ConstantInitializer(1.0))
        c = ptt.layers.data("c", [64, 32], append_batch_size=False)
        h = ptt.layers.recompute_segment(
            lambda a: ptt.layers.dropout(
                ptt.layers.scale(a, scale=2.0), 0.5,
                dropout_implementation="upscale_in_train"), [w])
        loss = ptt.layers.reduce_sum(ptt.layers.elementwise_mul(h, c))
        (_, gw), = ptt.append_backward(loss)
    c_val = np.random.RandomState(0).rand(3, 64, 32).astype(np.float32) + 1
    outs = []
    for stacked in (True, False):
        scope = ptt.Scope()
        exe = ptt.Executor(ptt.CPUPlace())
        exe.run(startup, scope=scope)
        if stacked:
            outs.append(exe.run_steps(main, feed={"c": c_val},
                                      fetch_list=[h, gw], scope=scope))
        else:
            runs = [exe.run(main, feed={"c": cv}, fetch_list=[h, gw],
                            scope=scope) for cv in c_val]
            outs.append([np.stack(col) for col in zip(*runs)])
    (hv, g), (hs, gs) = outs
    np.testing.assert_array_equal(hv, hs)
    np.testing.assert_array_equal(g, gs)
    kept = hv != 0
    np.testing.assert_array_equal(hv, np.where(kept, 4.0, 0.0))
    np.testing.assert_array_equal(g, np.where(kept, 4.0 * c_val, 0.0))
    assert (kept[0] != kept[1]).any() and (kept[1] != kept[2]).any()


def test_a_cpu_executor_never_captures():
    main, startup, loss = _mlp()
    xs, ys = _xy(4)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    for i in range(3):
        exe.run(main, feed={"x": xs[i], "y": ys[i]}, fetch_list=[loss],
                scope=scope)
    exe.run_steps(main, feed={"x": xs, "y": ys}, fetch_list=[loss],
                  scope=scope)
    assert exe.capture_log == [] and exe._graphs == {} and \
        exe._stream is None and exe._pool is None
    exe.close()
    assert exe._plans == {}
    # the scope keeps its tensors, and a closed Executor runs again
    exe.run(main, feed={"x": xs[0], "y": ys[0]}, fetch_list=[loss],
            scope=scope)


def test_accuracy_and_assign_value_keep_their_values():
    """The two ops now made on the device (accuracy's Total as a fill,
    assign_value's values once per plan): the JAX package's values, in
    two runs of one plan (the second copies the cached constant)."""
    rng = np.random.RandomState(3)
    scores = rng.rand(12, 5).astype(np.float32)
    label = rng.randint(0, 5, (12, 1)).astype(np.int64)
    values = rng.randn(2, 3).astype(np.float32)
    results = {}
    for pkg in (pt, ptt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            x = pkg.layers.data("x", [12, 5], append_batch_size=False)
            lbl = pkg.layers.data("lbl", [12, 1], dtype="int64",
                                  append_batch_size=False)
            acc = pkg.layers.accuracy(x, lbl, k=2)
            const = pkg.layers.assign(values)
        total = [op for op in main.global_block().ops
                 if op.type == "accuracy"][0].output("Total")[0]
        exe = pkg.Executor(pkg.CPUPlace())
        results[pkg] = [exe.run(main, feed={"x": scores, "lbl": label},
                                fetch_list=[acc, total, const],
                                scope=pkg.Scope()) for _ in range(2)]
    for (j_acc, j_total, j_const), (t_acc, t_total, t_const) in zip(
            results[pt], results[ptt]):
        np.testing.assert_array_equal(t_acc, np.asarray(j_acc))
        assert t_total.dtype == np.int32
        np.testing.assert_array_equal(t_total, [12])
        np.testing.assert_array_equal(t_total, np.asarray(j_total))
        np.testing.assert_array_equal(t_const, values)
        np.testing.assert_array_equal(t_const, np.asarray(j_const))


def test_launch_counters_are_read_and_credited_together():
    """The Executor credits a replay with what its capture counted: the
    sixteen counters (the eleven kernels', the numeric guard's two and
    the flash kernels' fp16 launches) in one fixed order, read and moved
    as one."""
    from paddle_tpu_torch.ops import kernels
    assert len(kernels.LAUNCH_COUNTERS) == 16
    assert len({(m.__name__, a) for m, a in kernels.LAUNCH_COUNTERS}) == 16
    before = kernels.launch_counts()
    delta = tuple(range(1, 17))
    kernels.credit_launches(delta)
    try:
        assert kernels.launch_counts() == tuple(
            b + d for b, d in zip(before, delta))
    finally:
        kernels.credit_launches(tuple(-d for d in delta))
    assert kernels.launch_counts() == before


def test_the_graph_key_holds_each_state_tensors_shape():
    """A persistable of a new shape is a new key, as ``jax.jit`` traces
    again on a new shape; the same shapes under new tensors are the same
    key. (The CPU path never captures: the key is checked directly.)"""
    from paddle_tpu_torch.framework.executor import _graph_key
    main, startup, loss = _mlp()
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    plan = exe._plan(main, [loss.name], True)
    feeds = exe._feed_tensors(main, dict(zip("xy", (a[0] for a in _xy(1)))),
                              plan)

    def key():
        state = [(n, scope.find_var(n)) for n in plan.persistable]
        return _graph_key(plan, feeds, state, scope)
    k = key()
    assert key() == k
    bias = next(p.name for p in main.all_parameters() if len(p.shape) == 1)
    old = scope.find_var(bias)
    scope.set_var(bias, old.clone() + 1.0)          # a new tensor, same shape
    assert key() == k
    scope.set_var(bias, torch.zeros(1))             # a new shape
    assert key() != k
    scope.set_var(bias, old.double())               # a new dtype
    assert key() != k
    scope.set_var(bias, old)
    assert key() == k
    other = ptt.Scope()
    for n in plan.persistable:
        other.set_var(n, scope.find_var(n))
    state = [(n, other.find_var(n)) for n in plan.persistable]
    assert _graph_key(plan, feeds, state, other) != k


def test_a_captured_step_refuses_a_state_tensor_of_another_shape():
    from paddle_tpu_torch.framework.compiled_step import (
        CompiledStep, StaticInputMismatchError)
    static = torch.arange(4.0)
    step = CompiledStep(torch.device("cpu"), {"w": static}, {})
    scope = ptt.Scope()
    scope.set_var("w", torch.full((4,), 7.0))
    step.load({}, scope)                       # copied into the static input
    assert scope.find_var("w") is static and static.tolist() == [7.0] * 4
    for bad in (torch.ones(1), torch.ones(4, dtype=torch.float64)):
        scope.set_var("w", bad)
        with pytest.raises(StaticInputMismatchError, match="new key"):
            step.load({}, scope)
        assert static.tolist() == [7.0] * 4
