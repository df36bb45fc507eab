"""py_reader, DataLoader, the reader decorators, DataFeeder, fluid.data,
paddle.batch and fill_zeros_like: the port against the JAX package.

The py_reader loop (``start``; ``exe.run`` with no feed until
``EOFException``; ``reset``) must see exactly the batches it was given,
in order, in every epoch, and a mid-epoch ``reset`` must leave no stale
batch; a sibling reader's EOF pushes the batch already taken back. A
small fc model trained three epochs through py_reader in both packages
from the JAX startup's weights: losses rtol 1e-5, parameters and
moments rtol 1e-4, atol 1e-6 (tests/test_torch_deepfm.py's tolerances).
Readers, feeders and fill_zeros_like move data only: exact.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu.reader as jreader
import paddle_tpu_torch as ptt
import paddle_tpu_torch.reader as treader
from paddle_tpu_torch.framework.scope import to_numpy
from test_torch_resnet import run_pair

N_BATCHES, BATCH = 5, 3


def _batches(n=N_BATCHES, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.rand(BATCH, 4).astype(np.float32),
             rng.randint(0, 2, (BATCH, 1)).astype(np.int64))
            for _ in range(n)]


def _echo_program(pkg, capacity=2):
    """A py_reader over x and y and a fetch of x's values: what each run
    read."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", [4])
        y = pkg.layers.data("y", [1], dtype="int64")
        reader = pkg.layers.create_py_reader_by_data(capacity, [x, y])
        out = pkg.layers.scale(x, scale=1.0)
    return main, startup, reader, out


def _epoch(exe, main, out, limit=None):
    got = []
    while limit is None or len(got) < limit:
        try:
            got.append(exe.run(main, fetch_list=[out])[0])
        except ptt.layers.EOFException:
            return got, True
    return got, False


def test_eof_after_exactly_the_batches_given_and_no_stale_batch():
    batches = _batches()
    main, startup, reader, out = _echo_program(ptt)
    reader.decorate_tensor_provider(lambda: iter(batches))
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup)
    for epoch in range(2):
        reader.start()
        got, eof = _epoch(exe, main, out)
        assert eof and len(got) == N_BATCHES
        for g, (x, _) in zip(got, batches):
            np.testing.assert_array_equal(g, x)
        reader.reset()
    # a reset mid-epoch: the next epoch starts from the first batch
    reader.start()
    got, eof = _epoch(exe, main, out, limit=2)
    assert not eof
    reader.reset()
    reader.start()
    got, eof = _epoch(exe, main, out)
    assert eof and len(got) == N_BATCHES
    np.testing.assert_array_equal(got[0], batches[0][0])
    reader.reset()
    with pytest.raises(RuntimeError, match="start"):
        reader._next_feed()


def test_start_and_reset_under_thread_switches_leave_no_stale_batch():
    """Forty start / read k batches / reset cycles with the interpreter
    switching threads every microsecond, a queue of two: every epoch
    begins at the first batch and reads the batches in order, and each
    reset leaves no filler thread behind."""
    import sys
    batches = _batches(6)
    main, startup, reader, out = _echo_program(ptt, capacity=2)
    reader.decorate_tensor_provider(lambda: iter(batches))
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup)
    rng = np.random.RandomState(0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(40):
            reader.start()
            thread = reader._thread
            k = int(rng.randint(0, 8))
            got, eof = _epoch(exe, main, out, limit=k)
            assert eof == (k > 6) and len(got) == min(k, 6)
            for g, (x, _) in zip(got, batches):
                np.testing.assert_array_equal(g, x)
            reader.reset()
            thread.join(timeout=5)
            assert not thread.is_alive() and reader._queue.empty()
    finally:
        sys.setswitchinterval(interval)


def test_a_fed_name_is_not_pulled_and_run_steps_refuses_a_started_reader():
    batches = _batches()
    main, startup, reader, out = _echo_program(ptt)
    reader.decorate_batch_generator(lambda: iter(batches))
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup)
    reader.start()
    mine = np.full((BATCH, 4), 7.0, np.float32)
    got = exe.run(main, feed={"x": mine, "y": batches[0][1]},
                  fetch_list=[out])[0]
    np.testing.assert_array_equal(got, mine)
    np.testing.assert_array_equal(exe.run(main, fetch_list=[out])[0],
                                  batches[0][0])       # nothing was taken
    with pytest.raises(ValueError, match="started py_readers"):
        exe.run_steps(main, feed={"x": np.stack([mine] * 2),
                                  "y": np.zeros((2, BATCH, 1), np.int64)},
                      fetch_list=[out])
    reader.reset()


def test_a_siblings_eof_pushes_the_taken_batch_back():
    """Two readers in one program, the second with one batch fewer: at
    its EOF the first reader's batch goes back, and after the second
    reader restarts, the next run reads that same batch."""
    long_, short = _batches(3, seed=1), _batches(2, seed=2)
    for pkg in (ptt, pt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            a = pkg.layers.py_reader(2, [[-1, 4], [-1, 1]],
                                     ["float32", "int64"], name="a")
            b = pkg.layers.py_reader(2, [[-1, 4], [-1, 1]],
                                     ["float32", "int64"], name="b")
            xa, _ = pkg.layers.read_file(a)
            xb, _ = pkg.layers.read_file(pkg.layers.double_buffer(b))
            out = pkg.layers.elementwise_add(xa, xb)
        a.decorate_tensor_provider(lambda: iter(long_))
        b.decorate_tensor_provider(lambda: iter(short))
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup)
        a.start()
        b.start()
        for i in range(2):
            np.testing.assert_allclose(
                np.asarray(exe.run(main, fetch_list=[out])[0]),
                long_[i][0] + short[i][0], rtol=1e-6)
        with pytest.raises(pkg.layers.EOFException):
            exe.run(main, fetch_list=[out])
        b.reset()
        b.start()
        np.testing.assert_allclose(
            np.asarray(exe.run(main, fetch_list=[out])[0]),
            long_[2][0] + short[0][0], rtol=1e-6)
        a.reset()
        b.reset()


def test_a_generator_error_reaches_the_run():
    def broken():
        yield _batches(1)[0]
        raise KeyError("bad sample")
    main, startup, reader, out = _echo_program(ptt)
    reader.decorate_tensor_provider(broken)
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup)
    reader.start()
    exe.run(main, fetch_list=[out])
    with pytest.raises(KeyError, match="bad sample"):
        exe.run(main, fetch_list=[out])
    reader.reset()


def _fc_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", [4])
        y = pkg.layers.data("y", [1], dtype="int64")
        reader = pkg.layers.create_py_reader_by_data(4, [x, y])
        loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(
            pkg.layers.fc(pkg.layers.fc(x, 8, act="relu"), 2), y))
        pkg.optimizer.Adam(1e-2).minimize(loss)
    return main, startup, reader, loss


def test_py_reader_training_matches_jax():
    """Three epochs of five batches, each reader decorated with a
    sample-list reader (paddle.batch over single samples)."""
    samples = [(x[i], y[i]) for x, y in _batches() for i in range(BATCH)]
    (jmain, jstart, jr, jloss), (tmain, tstart, tr, tloss) = \
        _fc_program(pt), _fc_program(ptt)
    jr.decorate_sample_list_generator(
        pt.batch(lambda: iter(samples), BATCH))
    tr.decorate_paddle_reader(ptt.batch(lambda: iter(samples), BATCH))
    jscope, tscope = pt.Scope(), ptt.Scope()
    jexe, texe = pt.Executor(pt.CPUPlace()), ptt.Executor(ptt.CPUPlace())
    with pt.scope_guard(jscope):
        jexe.run(jstart)
    persist = sorted(v.name for v in jmain.list_vars() if v.persistable)
    ptt.set_params_from_numpy(
        {n: np.asarray(jscope.find_var(n)) for n in persist}, tmain,
        tscope, ptt.CPUPlace())
    losses = {"jax": [], "port": []}
    for _ in range(3):
        for key, pkg, exe, rdr, main, loss, scope in (
                ("jax", pt, jexe, jr, jmain, jloss, jscope),
                ("port", ptt, texe, tr, tmain, tloss, tscope)):
            rdr.start()
            with pkg.scope_guard(scope):
                while True:
                    try:
                        out = exe.run(main, fetch_list=[loss])
                    except pkg.layers.EOFException:
                        break
                    losses[key].append(float(np.asarray(out[0])
                                             .reshape(())))
            rdr.reset()
    assert len(losses["port"]) == 3 * N_BATCHES
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-5)
    for n in persist:
        np.testing.assert_allclose(to_numpy(tscope.find_var(n)),
                                   np.asarray(jscope.find_var(n)),
                                   rtol=1e-4, atol=1e-6, err_msg=n)


@pytest.mark.parametrize("how", ["batch", "sample_list", "sample",
                                 "no_double_buffer"])
def test_data_loader_gives_the_jax_packages_feeds(how):
    batches = _batches()
    samples = [(x[i], y[i]) for x, y in batches for i in range(BATCH)]
    feeds = []
    for pkg, rdr in ((ptt, treader), (pt, jreader)):
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            fl = [pkg.layers.data("x", [4]),
                  pkg.layers.data("y", [1], dtype="int64")]
        loader = rdr.DataLoader.from_generator(
            feed_list=fl, capacity=2,
            use_double_buffer=how != "no_double_buffer")
        if how in ("batch", "no_double_buffer"):
            loader.set_batch_generator(lambda: iter(batches))
        elif how == "sample_list" or pkg is pt:
            # paddle_tpu's set_sample_generator batches one-sample lists
            # and fails to stack them: its sample-list path is the
            # reference for the port's
            loader.set_sample_list_generator(
                pkg.batch(lambda: iter(samples), BATCH))
        else:
            loader.set_sample_generator(lambda: iter(samples), BATCH)
        feeds.append([{k: np.asarray(v) for k, v in f.items()}
                      for f in loader()])
    assert len(feeds[0]) == len(feeds[1]) == N_BATCHES
    for t, j in zip(*feeds):
        assert sorted(t) == sorted(j) == ["x", "y"]
        for k in t:
            assert isinstance(t[k], np.ndarray)
            np.testing.assert_array_equal(t[k], j[k])


def test_data_loader_feeds_a_run_and_surfaces_errors():
    batches = _batches()
    main, startup, _, out = _echo_program(ptt)
    loader = treader.DataLoader.from_generator(
        feed_list=[main.global_block().var("x"),
                   main.global_block().var("y")], capacity=2)
    loader.set_batch_generator(lambda: iter(batches))
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup)
    for feed, (x, _) in zip(loader(), batches):
        np.testing.assert_array_equal(
            exe.run(main, feed=feed, fetch_list=[out])[0], x)
    it = iter(loader)            # abandoned early: its thread stops
    next(it)
    it.close()

    def broken():
        yield batches[0]
        raise KeyError("bad batch")
    loader.set_batch_generator(broken)
    with pytest.raises(KeyError, match="bad batch"):
        list(loader())


def test_decorators_equal_the_jax_packages():
    def r():
        return iter(range(10))

    def both(make):
        return list(make(treader)()), list(make(jreader)())
    for make in (lambda m: m.batch(r, 3),
                 lambda m: m.batch(r, 3, drop_last=True),
                 lambda m: m.shuffle(r, 4, seed=5),
                 lambda m: m.buffered(r, 2),
                 lambda m: m.chain(r, r),
                 lambda m: m.compose(r, r),
                 lambda m: m.firstn(r, 4),
                 lambda m: m.map_readers(lambda a, b: a * b, r, r),
                 lambda m: m.xmap_readers(lambda a: a + 1, r, 3, 4,
                                          order=True),
                 lambda m: m.cache(r)):
        got, want = both(make)
        assert got == want
    shuffled = treader.shuffle(r, 4, seed=5)
    assert list(shuffled()) != list(shuffled())       # each epoch anew
    assert sorted(treader.xmap_readers(lambda a: a, r, 3, 4)()) == \
        list(range(10))
    with pytest.raises(treader.ComposeNotAligned):
        list(treader.compose(r, lambda: iter(range(3)))())
    with pytest.raises(ptt.NotPortedError, match="worker processes"):
        treader.multiprocess_reader([r])


def test_data_feeder_fluid_data_and_paddle_batch():
    feeds = []
    rows = [(np.arange(4) + i, [i % 2]) for i in range(3)]
    for pkg in (ptt, pt):
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            x = pkg.data("x", [None, 4], dtype="float32")
            y = pkg.data("y", [None, 1], dtype="int64")
        assert tuple(x.shape) == (-1, 4)
        feeds.append(pkg.DataFeeder([x, y]).feed(rows))
    for k in ("x", "y"):
        assert feeds[0][k].dtype == np.asarray(feeds[1][k]).dtype
        np.testing.assert_array_equal(feeds[0][k], feeds[1][k])
    import paddle_tpu_torch.batch as batch_module
    assert list(batch_module(lambda: iter(range(5)), 2)()) == \
        [[0, 1], [2, 3], [4]]


def test_fill_zeros_like():
    def build(p):
        x = p.layers.data("x", [2, 3], append_batch_size=False)
        ids = p.layers.data("ids", [2, 3], dtype="int64",
                            append_batch_size=False)
        return [p.layers.zeros_like(x), p.layers.zeros_like(ids)]
    out, (jmain, tmain), _ = run_pair(
        build, [{"x": np.ones((2, 3), np.float32),
                 "ids": np.ones((2, 3), np.int64)}], exact=True)
    assert [op.type for op in tmain.global_block().ops] == \
        ["fill_zeros_like"] * 2
    assert out[0].dtype == np.float32 and out[1].dtype == np.int64
    assert not out[0].any() and not out[1].any()
