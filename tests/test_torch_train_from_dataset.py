"""Executor.train_from_dataset / infer_from_dataset: the port against the
JAX package.

A small DeepFM (5000 features, embedding 8) fed from record files
through an InMemoryDataset, and bench.py's bucketed model (embedding,
GELU layers, a masked sum, softmax CE; small widths) fed from MultiSlot
text written by the data generator through a QueueDataset with length
buckets, each trained in both packages from the JAX startup's weights.
Tolerances are tests/test_torch_deepfm.py's: losses rtol 1e-5;
parameters and Adam moments rtol 1e-4, atol 1e-6 (Adam divides by
sqrt(m2) + eps, which magnifies a last-bit difference of a small second
moment); AUC histograms equal. Within the port, a windowed pass
(``steps_per_dispatch``) equals the per-step pass bit for bit.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.dataset import dataset_api as jds
from paddle_tpu.models import deepfm as jdeepfm
from paddle_tpu_torch.dataset import dataset_api as tds
from paddle_tpu_torch.framework import executor as texecutor
from paddle_tpu_torch.framework.scope import to_numpy
from paddle_tpu_torch.incubate.data_generator import MultiSlotDataGenerator
from paddle_tpu_torch.models import deepfm as tdeepfm
from paddle_tpu_torch.native import recordio

LOSS_RTOL = 1e-5
STATE_TOL = dict(rtol=1e-4, atol=1e-6)
DEEPFM = dict(feature_dim=5000, embedding_size=8)
DEEPFM_BATCH, DEEPFM_BATCHES = 16, 5
BUCKETED = dict(vocab=64, hidden=16, n_layers=2, max_len=16)
BUCKETS = (4, 8, 16)
BUCKETED_BATCH, BUCKETED_SAMPLES = 4, 22


def _deepfm(pkg, mod, is_test=False):
    with pkg.unique_name.guard():
        main, startup, feeds, fetch = mod.deepfm_train_program(
            optimizer_fn=None if is_test else (
                lambda loss: pkg.optimizer.Adam(1e-3).minimize(loss)),
            is_test=is_test, **DEEPFM)
    blk = main.global_block()
    return main, startup, [blk.var(n) for n in feeds], \
        [fetch["loss"], fetch["auc"]]


def _deepfm_files(tmp_path):
    """DEEPFM_BATCHES synthetic_batch batches written a sample a record,
    over two files."""
    paths = [str(tmp_path / "ctr0.ptrec"), str(tmp_path / "ctr1.ptrec")]
    samples = []
    for b in range(DEEPFM_BATCHES):
        batch = tdeepfm.synthetic_batch(DEEPFM_BATCH, seed=b, **{
            "feature_dim": DEEPFM["feature_dim"]})
        samples += [tuple(batch[n][i] for n in ("dense_input",
                                                "sparse_input", "label"))
                    for i in range(DEEPFM_BATCH)]
    half = len(samples) // 2
    recordio.write_records(paths[0], samples[:half])
    recordio.write_records(paths[1], samples[half:])
    return paths


def _in_memory(mod, paths, use):
    ds = mod.InMemoryDataset()
    ds.set_filelist(paths)
    ds.set_batch_size(DEEPFM_BATCH)
    ds.set_thread(1)
    ds.set_use_var(use)
    ds.load_into_memory()
    ds.global_shuffle()
    return ds


def _bucketed(pkg):
    """bench.py's bench_bucketed_training model at BUCKETED widths."""
    layers = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        ids = layers.data("ids", [-1], dtype="int64")
        label = layers.data("label", [1], dtype="int64")
        emb = layers.embedding(ids, size=[BUCKETED["vocab"],
                                          BUCKETED["hidden"]])
        mask = layers.cast(
            layers.not_equal(ids, layers.zeros_like(ids)), "float32")
        h = emb
        for _ in range(BUCKETED["n_layers"]):
            h = layers.fc(h, BUCKETED["hidden"], num_flatten_dims=2,
                          act="gelu")
        pooled = layers.reduce_sum(h * layers.unsqueeze(mask, [2]), dim=1)
        logits = layers.fc(pooled, size=2)
        loss = layers.reduce_mean(
            layers.softmax_with_cross_entropy(logits, label))
        pkg.optimizer.Adam(1e-3).minimize(loss)
    return main, startup, [ids, label], [loss]


def _bucketed_text(tmp_path):
    """Skewed lengths as bench.py draws them, written as MultiSlot text
    by the port's data generator."""
    rng = np.random.RandomState(0)
    max_len = BUCKETED["max_len"]

    class Gen(MultiSlotDataGenerator):
        def generate_sample(self, line):
            def it():
                for _ in range(BUCKETED_SAMPLES):
                    ln = int(np.clip(rng.geometric(1.0 / (max_len // 8)),
                                     4, max_len))
                    yield [("ids", [int(v) for v in rng.randint(
                        1, BUCKETED["vocab"], ln)]),
                           ("label", [int(rng.randint(0, 2))])]
            return it
    chunks = []
    Gen().run_from_memory(write=chunks.append)
    path = tmp_path / "bucketed.txt"
    path.write_text("".join(chunks))
    return [str(path)]


def _queue(mod, paths, use, buckets):
    ds = mod.QueueDataset()
    ds.set_filelist(paths)
    ds.set_batch_size(BUCKETED_BATCH)
    ds.set_use_var(use)
    ds.set_length_buckets(buckets, by="ids")
    return ds


def _recording(exe):
    """Record every fetched loss the trainer's per-step runs return."""
    losses = []
    run = exe.run

    def recorded(*args, **kwargs):
        out = run(*args, **kwargs)
        if out:
            losses.append(float(np.asarray(out[0]).reshape(())))
        return out
    exe.run = recorded
    return losses


def _train_both(build, make_dataset, method="train_from_dataset"):
    """Both packages from the JAX startup's persistables, each through
    ``method``: (losses, last fetches, the two programs and scopes) per
    package."""
    jmain, jstart, juse, jfetch = build(pt)
    tmain, tstart, tuse, tfetch = build(ptt)
    jscope, tscope = pt.Scope(), ptt.Scope()
    jexe, texe = pt.Executor(pt.CPUPlace()), ptt.Executor(ptt.CPUPlace())
    with pt.scope_guard(jscope):
        jexe.run(jstart)
    persist = sorted(v.name for v in jmain.list_vars() if v.persistable)
    ptt.set_params_from_numpy(
        {n: np.asarray(jscope.find_var(n)) for n in persist}, tmain,
        tscope, ptt.CPUPlace())
    jlosses, tlosses = _recording(jexe), _recording(texe)
    with pt.scope_guard(jscope):
        jsteps, jlast = getattr(jexe, method)(
            jmain, make_dataset(jds, juse), fetch_list=jfetch)
    tsteps, tlast = getattr(texe, method)(
        tmain, make_dataset(tds, tuse), scope=tscope, fetch_list=tfetch)
    assert tsteps == jsteps
    return (jlosses, tlosses), (jlast, tlast), persist, (jscope, tscope)


def _compare_state(persist, jscope, tscope):
    for n in persist:
        got, want = to_numpy(tscope.find_var(n)), np.asarray(
            jscope.find_var(n))
        if "_stat_" in n:
            np.testing.assert_array_equal(got, want, err_msg=n)
        else:
            np.testing.assert_allclose(got, want, err_msg=n, **STATE_TOL)


def test_deepfm_trains_from_an_in_memory_dataset_like_jax(tmp_path):
    paths = _deepfm_files(tmp_path)
    (jl, tl), (jlast, tlast), persist, scopes = _train_both(
        lambda pkg: _deepfm(pkg, jdeepfm if pkg is pt else tdeepfm),
        lambda mod, use: _in_memory(mod, paths, use))
    assert len(tl) == len(jl) == DEEPFM_BATCHES
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tlast[0], np.asarray(jlast[0]),
                               rtol=LOSS_RTOL)
    assert isinstance(tlast[0], np.ndarray)
    _compare_state(persist, *scopes)


def test_bucketed_model_trains_from_multislot_text_like_jax(tmp_path):
    """bench.py's bucketed model: ragged ids from MultiSlot text, the
    C++ parse, buckets (4, 8, 16); each batch carries ``ids__lens``,
    which the program does not read."""
    paths = _bucketed_text(tmp_path)
    (jl, tl), _, persist, scopes = _train_both(
        _bucketed, lambda mod, use: _queue(mod, paths, use, BUCKETS))
    widths = {b["ids"].shape[1] for b in _queue(
        tds, paths, [ptt.layers.data("ids", [-1], dtype="int64"),
                     ptt.layers.data("label", [1], dtype="int64")],
        BUCKETS)}
    assert len(widths) > 1
    assert len(tl) == len(jl) >= 6
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _compare_state(persist, *scopes)


def _port_pass(build, dataset, window, start=None):
    main, startup, use, fetch = build(ptt)
    scope, exe = ptt.Scope(), ptt.Executor(ptt.CPUPlace())
    if start is None:
        exe.run(startup, scope=scope)
    else:
        ptt.set_params_from_numpy(start, main, scope, ptt.CPUPlace())
    steps, last = exe.train_from_dataset(main, dataset(use), scope=scope,
                                         fetch_list=fetch,
                                         steps_per_dispatch=window)
    state = {v.name: to_numpy(scope.find_var(v.name))
             for v in main.list_vars() if v.persistable}
    return steps, last, state


@pytest.mark.parametrize("model", ["deepfm", "bucketed"])
def test_windowed_pass_equals_per_step_bit_for_bit(tmp_path, model):
    """steps_per_dispatch=2 from the same start: DeepFM's five uniform
    batches make two run_steps windows and a per-step tail; the bucketed
    batches' windows of unlike widths run step by step. Fetches and
    every persistable equal bit for bit."""
    if model == "deepfm":
        paths = _deepfm_files(tmp_path)

        def build(pkg):
            return _deepfm(pkg, tdeepfm)

        def dataset(use):
            return _in_memory(tds, paths, use)
    else:
        paths = _bucketed_text(tmp_path)
        build = _bucketed

        def dataset(use):
            return _queue(tds, paths, use, BUCKETS)
    main, startup, _, _ = build(ptt)
    scope = ptt.Scope()
    ptt.Executor(ptt.CPUPlace()).run(startup, scope=scope)
    start = {v.name: to_numpy(scope.find_var(v.name))
             for v in main.list_vars() if v.persistable}
    windows = []
    run_steps = ptt.Executor.run_steps

    def counted(self, *args, **kwargs):
        windows.append(1)
        return run_steps(self, *args, **kwargs)
    ptt.Executor.run_steps = counted
    try:
        one = _port_pass(build, dataset, 1, start)
        two = _port_pass(build, dataset, 2, start)
    finally:
        ptt.Executor.run_steps = run_steps
    assert one[0] == two[0]
    if model == "deepfm":
        assert len(windows) == 2
    for a, b in zip(one[1], two[1]):
        np.testing.assert_array_equal(a, b)
    assert sorted(one[2]) == sorted(two[2])
    for n in one[2]:
        np.testing.assert_array_equal(one[2][n], two[2][n], err_msg=n)


def test_infer_from_dataset_refuses_a_training_program(tmp_path):
    """The JAX package's message, word for word; the is_test program
    runs and fetches what the JAX package fetches."""
    paths = _deepfm_files(tmp_path)
    messages = []
    for pkg, mod, dmod in ((pt, jdeepfm, jds), (ptt, tdeepfm, tds)):
        main, startup, use, fetch = _deepfm(pkg, mod)
        exe = pkg.Executor(pkg.CPUPlace())
        with pytest.raises(ValueError) as e:
            exe.infer_from_dataset(main, _in_memory(dmod, paths, use),
                                   fetch_list=fetch)
        messages.append(str(e.value))
    assert messages[0] == messages[1]
    assert "parameter-update ops ['adam'" in messages[0]
    (jl, tl), (jlast, tlast), persist, scopes = _train_both(
        lambda pkg: _deepfm(pkg, jdeepfm if pkg is pt else tdeepfm,
                            is_test=True),
        lambda mod, use: _in_memory(mod, paths, use),
        method="infer_from_dataset")
    assert len(tl) == DEEPFM_BATCHES
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tlast[1], np.asarray(jlast[1]), rtol=1e-6)
    _compare_state(persist, *scopes)


def test_an_unread_feed_is_dropped_at_the_feed_boundary():
    """``ids__lens``, which the program neither declares nor reads, is no
    part of the step's feeds, so it neither splits a graph key nor gets a
    static buffer; a declared one stays."""
    main, startup, use, fetch = _bucketed(ptt)
    exe = ptt.Executor(ptt.CPUPlace())
    plan = exe._plan(main, [f.name for f in fetch], True)
    batch = {"ids": np.ones((4, 8), np.int64),
             "label": np.zeros((4, 1), np.int64)}
    with_lens = dict(batch, ids__lens=np.full(4, 8, np.int64))
    fed = exe._feed_tensors(main, with_lens, plan)
    assert sorted(fed) == ["ids", "label"]
    key = texecutor._graph_key(plan, fed, [], None)
    assert key == texecutor._graph_key(
        plan, exe._feed_tensors(main, batch, plan), [], None)
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    a = exe.run(main, feed=with_lens, fetch_list=fetch, scope=scope)
    assert np.isfinite(a[0]).all()
    with ptt.program_guard(main, startup):
        ptt.layers.data("ids__lens", [], dtype="int64")
    plan = exe._plan(main, [f.name for f in fetch], True)
    assert "ids__lens" in exe._feed_tensors(main, with_lens, plan)


def test_dist_multi_trainer_waits_for_its_slice():
    main, startup, use, fetch = _deepfm(ptt, tdeepfm)
    main._fleet_opt = {"trainer": "DistMultiTrainer"}
    with pytest.raises(ptt.NotPortedError, match="torch.distributed"):
        ptt.Executor(ptt.CPUPlace()).train_from_dataset(
            main, [], fetch_list=fetch)
