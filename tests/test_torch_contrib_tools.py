"""The Book's Trainer and Inferencer, distributed_batch_reader, the program
statistics and the profiler of the port (paddle_tpu_torch/contrib/,
paddle_tpu_torch/profiler.py) against the JAX package's.

- ``Trainer`` trains fit_a_line (uci_housing, batch 20, SGD 0.01) two
  epochs in both packages, the port from the JAX trainer's initial
  weights: the same events, every step's loss within rtol 1e-5 (f32, a
  13-wide dot in another order; measured ~1e-7) and the final weights
  within 1e-5; ``test()`` as well. ``Inferencer`` serves the saved
  parameters: its answers equal the trainer's weights applied to the
  rows (1e-5). A ``CheckpointConfig`` trainer writes checkpoints and a
  new trainer on the same directory resumes from the newest.
- ``distributed_batch_reader`` gives trainer i of n every n-th batch,
  as the JAX package's.
- ``summary``, ``memory_usage`` and ``op_freq_statistic`` of the same
  programs (an MLP, tiny ResNet-18, tiny BERT) equal the JAX package's
  exactly.
- ``profile_program``'s table names the JAX package's op types; the
  profiler's start/stop and ``profiler()`` give a table of what ran;
  ``annotate`` is a range in it.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import profiler as jprofiler
from paddle_tpu.contrib import inferencer as jinf
from paddle_tpu.contrib import memory_usage_calc as jmem
from paddle_tpu.contrib import model_stat as jstat
from paddle_tpu.contrib import op_frequence as jfreq
from paddle_tpu.contrib import reader as jreader
from paddle_tpu.contrib import trainer as jtrainer
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import resnet as jresnet
from paddle_tpu_torch import profiler as tprofiler
from paddle_tpu_torch.contrib import inferencer as tinf
from paddle_tpu_torch.contrib import memory_usage_calc as tmem
from paddle_tpu_torch.contrib import model_stat as tstat
from paddle_tpu_torch.contrib import op_frequence as tfreq
from paddle_tpu_torch.contrib import reader as treader
from paddle_tpu_torch.contrib import trainer as ttrainer
from paddle_tpu_torch.dataset import uci_housing
from paddle_tpu_torch.framework.scope import to_numpy
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import resnet as tresnet

TRAINER = {pt: jtrainer, ptt: ttrainer}
INFERENCER = {pt: jinf, ptt: tinf}


def _predict(pkg):
    x = pkg.layers.data("x", [13], dtype="float32")
    return pkg.layers.fc(x, 1, param_attr=pkg.ParamAttr(name="fit_w"),
                         bias_attr=pkg.ParamAttr(name="fit_b"))


def _train_func(pkg):
    def fn():
        y = pkg.layers.data("y", [1], dtype="float32")
        return [pkg.layers.mean(pkg.layers.square_error_cost(
            _predict(pkg), y))]
    return fn


def _trainer(pkg, checkpoint=None, init=None):
    t = TRAINER[pkg].Trainer(
        _train_func(pkg), lambda: pkg.optimizer.SGD(learning_rate=0.01),
        place=pkg.CPUPlace(), checkpoint_config=checkpoint)
    for n, v in (init or {}).items():
        t.scope.find_var(n).copy_(torch.from_numpy(v))
    return t


def _weights(pkg, t):
    get = (lambda n: to_numpy(t.scope.find_var(n))) if pkg is ptt else \
        (lambda n: np.asarray(t.scope.find_var(n)))
    return {n: get(n).copy() for n in ("fit_w", "fit_b")}


def _fit(pkg, t, epochs=2):
    events, losses = [], []

    def handler(e):
        events.append(type(e).__name__)
        if type(e).__name__ == "EndStepEvent":
            losses.append(float(np.asarray(e.metrics[0]).reshape(-1)[0]))
    reader = pkg.batch(uci_housing.train(), batch_size=20, drop_last=True)
    t.train(epochs, handler, reader=reader, feed_order=["x", "y"])
    return events, losses


def test_trainer_trains_like_jax():
    jt = _trainer(pt)
    init = _weights(pt, jt)
    tt = _trainer(ptt, init=init)
    jev, jl = _fit(pt, jt)
    tev, tl = _fit(ptt, tt)
    assert tev == jev
    assert tev.count("EndEpochEvent") == 2 and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for n, w in _weights(pt, jt).items():
        np.testing.assert_allclose(_weights(ptt, tt)[n], w, atol=1e-5)
    test_reader = pt.batch(uci_housing.test(), batch_size=20)
    np.testing.assert_allclose(
        tt.test(test_reader, ["x", "y"]), jt.test(test_reader, ["x", "y"]),
        rtol=1e-5)


def test_trainer_stop_and_inferencer_from_saved_params(tmp_path):
    t = _trainer(ptt)
    seen = []

    def handler(e):
        seen.append(type(e).__name__)
        if type(e).__name__ == "EndStepEvent" and e.step == 2:
            t.stop()
    t.train(3, handler, reader=ptt.batch(uci_housing.train(), 20),
            feed_order=["x", "y"])
    assert seen.count("EndStepEvent") == 3
    t.save_params(str(tmp_path / "params"))
    rows = np.stack([s[0] for s, _ in zip(uci_housing.test()(), range(5))])
    w = _weights(ptt, t)
    want = rows @ w["fit_w"] + w["fit_b"]
    got = []
    for pkg in (pt, ptt):
        inf = INFERENCER[pkg].Inferencer(lambda pkg=pkg: _predict(pkg),
                                         str(tmp_path / "params"),
                                         place=pkg.CPUPlace())
        got.append(np.asarray(inf.infer({"x": rows.astype(np.float32)})[0]))
    for g in got:
        np.testing.assert_allclose(g, want, atol=1e-5)
    with pytest.raises(ValueError):
        tinf.Inferencer(lambda: _predict(ptt), str(tmp_path / "nothing"),
                        place=ptt.CPUPlace())


def test_trainer_checkpoints_and_resumes(tmp_path):
    cfg = ttrainer.CheckpointConfig(str(tmp_path), step_interval=5)
    t = _trainer(ptt, checkpoint=cfg)
    _fit(ptt, t, epochs=1)
    assert (tmp_path / "latest").exists()
    w = _weights(ptt, t)
    again = _trainer(ptt, checkpoint=ttrainer.CheckpointConfig(
        str(tmp_path)))
    assert again._checkpoint_cfg.load_serial is not None
    for n, v in _weights(ptt, again).items():
        np.testing.assert_array_equal(v, w[n])


def test_distributed_batch_reader_equals_jax(monkeypatch):
    def batches():
        for i in range(7):
            yield [i]
    for n, i in ((1, 0), (3, 1), (2, 1)):
        monkeypatch.setenv("PADDLE_TRAINERS_NUM", str(n))
        monkeypatch.setenv("PADDLE_TRAINER_ID", str(i))
        got = list(treader.distributed_batch_reader(batches)())
        assert got == list(jreader.distributed_batch_reader(batches)())
        assert got == [[b] for b in range(i, 7, n)]


def _mlp(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", [8], dtype="float32")
        y = pkg.layers.data("y", [1], dtype="int64")
        h = pkg.layers.fc(x, 16, act="relu")
        loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(
            pkg.layers.fc(h, 4), y))
        pkg.optimizer.Adam(1e-2).minimize(loss)
    return main, startup, loss


def _programs(pkg):
    mods = (jresnet, jbert) if pkg is pt else (tresnet, tbert)
    with pkg.unique_name.guard():
        resnet = mods[0].resnet_train_program(18, 10, (3, 32, 32))[0]
    cfg = mods[1].BertConfig(vocab_size=512, hidden_size=64, num_layers=2,
                             num_heads=4, ff_size=128, max_position=64)
    with pkg.unique_name.guard():
        bert = mods[1].bert_pretrain_program(cfg, 2, 16, 4)[0]
    return {"mlp": _mlp(pkg)[0], "resnet18": resnet, "bert": bert}


@pytest.mark.parametrize("name", ["mlp", "resnet18", "bert"])
def test_program_statistics_equal_jax(name, capsys):
    a, b = _programs(pt)[name], _programs(ptt)[name]
    ja, tb = jstat.summary(a), tstat.summary(b)
    assert [dict(r) for r in tb[0]] == [dict(r) for r in ja[0]]
    assert tb[1] == ja[1] and tb[1][0] > 0
    assert "Total PARAMs" in capsys.readouterr().out
    assert tmem.memory_usage(b, 8) == jmem.memory_usage(a, 8)
    assert tfreq.op_freq_statistic(b) == jfreq.op_freq_statistic(a)
    with pytest.raises(TypeError):
        tfreq.op_freq_statistic(None)
    with pytest.raises(ValueError):
        tmem.memory_usage(b, 0)


def test_profile_program_names_the_jax_op_types():
    feed = {"x": np.random.RandomState(0).rand(8, 8).astype(np.float32),
            "y": np.random.RandomState(1).randint(0, 4, (8, 1))}
    keys = []
    for pkg, prof in ((pt, jprofiler), (ptt, tprofiler)):
        main, startup, _ = _mlp(pkg)
        scope = pkg.Scope()
        with pkg.scope_guard(scope):
            pkg.Executor(pkg.CPUPlace()).run(startup)
        kw = {"place": ptt.CPUPlace()} if pkg is ptt else {}
        rows = prof.profile_program(main, feed, scope=scope, repeat=2,
                                    print_table=False, **kw)
        keys.append(sorted(r[0] for r in rows))
        assert all(r[1] >= 1 and r[2] >= 0 for r in rows)
    assert keys[1] == keys[0]


def test_profiler_tables_what_ran():
    with tprofiler.profiler("CPU", "total", print_table=False) as p:
        with tprofiler.annotate("my_range"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    names = [r[0] for r in p.rows]
    assert "my_range" in names and p.table.startswith("Event")
    tprofiler.start_profiler("CPU")
    with pytest.raises(RuntimeError):
        tprofiler.start_profiler("CPU")
    torch.ones(8).sum()
    tprofiler.reset_profiler()
    out = tprofiler.stop_profiler("calls", print_table=False)
    assert out.rows == sorted(out.rows, key=lambda r: -r[1])
    with pytest.raises(RuntimeError):
        tprofiler.stop_profiler()
    with pytest.raises(ValueError):
        tprofiler.start_profiler("TPU")
