"""Dygraph (eager mode): the port against the JAX package.

Every case of tests/test_dygraph.py runs in both packages, the port under
``dygraph.guard(CPUPlace())`` (its kernels' plain versions), from the
same inputs made from a seed with numpy. Both packages draw a fresh
layer's weights the same way (numpy's global RNG, or
``create_parameter``'s ``RandomState``) and ``run_op`` draws its seed
from the global RNG in both, so numpy's RNG seeded alike gives both the
same weights bit for bit (checked where a test builds layers). Values
are f32 on both sides and only the order of sums differs: outputs and
gradients within rtol 1e-5 / atol 1e-6; 60 SGD steps at lr 0.5 within
rtol 1e-4 (the loss curve) and atol 1e-5 (the weights).

Then what the port adds or does differently: ``guard()`` defaults to the
card and raises ``NoCUDADeviceError`` without one; a live intermediate
variable gets its gradient and a dead one is not kept; an optimizer
writes the parameter in place, so a graph kept by ``retain_graph=True``
refuses its backward after ``minimize``; ``DataParallel`` on one card
against the JAX package's 8-device pmap.
"""
import contextlib
import gc
import weakref

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt

RTOL, ATOL = 1e-5, 1e-6


@contextlib.contextmanager
def _guard(pkg):
    if pkg is pt:
        with pt.dygraph.guard():
            yield
    else:
        with ptt.dygraph.guard(ptt.CPUPlace()):
            yield


def _both(fn, seed=0):
    """fn(pkg) under each package's guard, numpy's global RNG seeded to
    ``seed`` first: (the JAX package's result, the port's)."""
    out = []
    for pkg in (pt, ptt):
        np.random.seed(seed)
        with _guard(pkg):
            out.append(fn(pkg))
    return out


def _close(got, want, rtol=RTOL, atol=ATOL):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], rtol, atol)
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, rtol, atol)
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _mean_loss(pkg):
    from_nn = pkg.dygraph.nn.run_op
    return lambda out: from_nn("reduce_mean", {"X": [out]},
                               {"reduce_all": True})["Out"]


def test_eager_math():
    def run(pkg):
        a = pkg.dygraph.to_variable(np.array([1.0, 2.0], np.float32))
        b = pkg.dygraph.to_variable(np.array([3.0, 4.0], np.float32))
        m = pkg.dygraph.to_variable(np.arange(6, dtype=np.float32)
                                    .reshape(2, 3))
        outs = [a * b + 2.0, a - b, 3.0 - a, a / b, -a, a[1:], 2.0 * a,
                a @ m, a.astype("float32") + 1]
        return [o.numpy() for o in outs]
    want, got = _both(run)
    np.testing.assert_allclose(got[0], [5.0, 10.0])
    _close(got, want)


def test_linear_forward_and_grad():
    x = np.random.RandomState(0).rand(3, 4).astype(np.float32)

    def run(pkg):
        layer = pkg.dygraph.Linear(4, 2)
        loss, grads = layer.loss_and_grad(_mean_loss(pkg), x)
        assert len(grads) == 2
        return (loss.numpy(), layer.weight.gradient(),
                layer.bias.gradient(), layer.weight.numpy())
    want, got = _both(run)
    np.testing.assert_array_equal(got[3], want[3])   # fresh: bit for bit
    expect = np.tile(x.mean(0, keepdims=True).T / 2, (1, 2))
    np.testing.assert_allclose(got[1], expect, rtol=1e-5)
    _close(got, want)


def test_sequential_conv_bn():
    x = np.random.RandomState(0).rand(2, 3, 8, 8).astype(np.float32)

    def run(pkg):
        dy = pkg.dygraph
        model = dy.Sequential(dy.Conv2D(3, 8, 3, padding=1),
                              dy.BatchNorm(8, act="relu"))
        xv = dy.to_variable(x)
        out = model(xv)
        assert out.shape == (2, 8, 8, 8)
        bn = model[1]
        stats = (bn._mean.numpy(), bn._variance.numpy())
        model.eval()
        out2 = model(xv)
        assert out2.shape == (2, 8, 8, 8)
        return [out.numpy(), out2.numpy(), stats, model.state_dict()]
    want, got = _both(run)
    _close(got, want, atol=1e-5)


def test_embedding_layernorm():
    def run(pkg):
        emb = pkg.dygraph.Embedding([50, 16])
        ln = pkg.dygraph.LayerNorm(16)
        ids = pkg.dygraph.to_variable(np.array([[1], [4]], np.int64))
        out = ln(emb(ids))
        assert out.shape == (2, 16)
        return out.numpy(), emb.weight.numpy()
    want, got = _both(run)
    np.testing.assert_allclose(got[0].mean(-1), 0.0, atol=1e-5)
    np.testing.assert_array_equal(got[1], want[1])
    _close(got[0], want[0])


@pytest.mark.parametrize("src,dst", [("port", "port"), ("port", "jax"),
                                     ("jax", "port")])
def test_state_dict_roundtrip(tmp_path, src, dst):
    """save_dygraph in one package, load_dygraph + set_dict in the other:
    the same .pdparams.npz file, the weights bit for bit."""
    pkgs = {"jax": pt, "port": ptt}
    path = str(tmp_path / "model")
    np.random.seed(1)
    with _guard(pkgs[src]):
        l1 = pkgs[src].dygraph.Linear(4, 2)
        sd = l1.state_dict()
        pkgs[src].dygraph.save_dygraph(sd, path)
    np.random.seed(2)
    with _guard(pkgs[dst]):
        loaded, extra = pkgs[dst].dygraph.load_dygraph(path)
        assert extra is None and sorted(loaded) == ["bias", "weight"]
        l2 = pkgs[dst].dygraph.Linear(4, 2)
        l2.set_dict({"weight": np.zeros((4, 2), np.float32)})
        l2.set_dict(loaded)
        np.testing.assert_array_equal(l2.weight.numpy(), sd["weight"])
        np.testing.assert_array_equal(l2.bias.numpy(), sd["bias"])


def test_traced_layer_jit():
    """TracedLayer's CPU path: the forward under no_grad, equal to the
    eager forward bit for bit and to the JAX package's jitted trace; it
    reads the weights at every call (after set_dict too)."""
    x = np.random.RandomState(0).rand(3, 4).astype(np.float32)

    def run(pkg):
        layer = pkg.dygraph.Linear(4, 2)
        eager = layer(pkg.dygraph.to_variable(x)).numpy()
        out, traced = pkg.dygraph.TracedLayer.trace(layer, [x])
        again = traced([x]).numpy()
        layer.set_dict({"weight": np.ones((4, 2), np.float32)})
        moved = traced([x]).numpy()
        return eager, out.numpy(), again, moved
    want, got = _both(run)
    np.testing.assert_array_equal(got[1], got[0])
    np.testing.assert_array_equal(got[2], got[0])
    np.testing.assert_allclose(got[3], x.sum(1, keepdims=True)
                               .repeat(2, 1), rtol=1e-6)
    _close(got, want)


def test_data_parallel_step():
    """DataParallel.train_step on the guard's one card against the JAX
    package's pmap over 8 devices: the mean of the shards' mean
    gradients is the whole batch's, so losses and weights agree."""
    import jax
    assert jax.device_count() == 8
    rng = np.random.RandomState(0)
    x = rng.rand(32, 4).astype(np.float32)

    def run(pkg):
        layer = pkg.dygraph.Linear(4, 1)
        dp = pkg.dygraph.DataParallel(layer)
        opt = pkg.dygraph.optimizers.SGD(0.2)
        run_op = pkg.dygraph.nn.run_op

        def loss_fn(out):
            sq = run_op("square", {"X": [out]})["Out"]
            return run_op("reduce_mean", {"X": [sq]},
                          {"reduce_all": True})["Out"]
        losses = [float(np.asarray(dp.train_step(loss_fn, opt, x).numpy())
                        .reshape(())) for _ in range(11)]
        assert losses[-1] < losses[0]
        return losses, dp.state_dict()
    want, got = _both(run)
    _close(got, want, atol=1e-6)


def test_tape_backward_fluid_idiom():
    """loss.backward(); opt.minimize(loss); layer.clear_gradients() runs
    unmodified (reference tests/unittests/test_imperative_mnist.py)."""
    rng = np.random.RandomState(0)
    x = rng.rand(16, 8).astype(np.float32)
    y = rng.randint(0, 4, (16, 1)).astype(np.int64)

    def run(pkg):
        net = pkg.dygraph.Linear(8, 4, act="softmax")
        sgd = pkg.dygraph.optimizers.SGDOptimizer(
            learning_rate=0.5, parameter_list=net.parameters())
        losses = []
        for _ in range(60):
            cost = net(pkg.dygraph.to_variable(x))
            loss = pkg.layers.cross_entropy(cost, pkg.dygraph.to_variable(y))
            avg_loss = pkg.layers.mean(loss)
            avg_loss.backward()
            sgd.minimize(avg_loss)
            net.clear_gradients()
            assert net.weight.gradient() is None
            losses.append(float(np.asarray(avg_loss.numpy()).reshape(())))
        return losses, net.state_dict()
    want, got = _both(run)
    assert got[0][-1] < got[0][0] * 0.7
    _close(got[0], want[0], rtol=1e-4)
    _close(got[1], want[1], rtol=1e-4, atol=1e-5)


def test_tape_grads_match_functional():
    """Tape .backward() gradients equal Layer.loss_and_grad's over the
    same forward, and the JAX package's."""
    x = np.random.RandomState(1).rand(4, 6).astype(np.float32)

    def run(pkg):
        net = pkg.dygraph.Linear(6, 3)
        sq_mean = lambda o: pkg.layers.mean(pkg.layers.square(o))
        _, fgrads = net.loss_and_grad(sq_mean, x)
        fg = [np.asarray(fgrads[id(p)]) for p in net.parameters()]
        net.clear_gradients()
        loss = sq_mean(net(pkg.dygraph.to_variable(x)))
        loss.backward()
        return fg, [p.gradient() for p in net.parameters()]
    want, got = _both(run)
    _close(got[1], got[0])
    _close(got, want)


def test_tape_backward_conv_bn_chain():
    """backward() reaches through run_op kernels (conv/bn/pool) and the
    eager-dispatched static layers; stop_gradient inputs get no grad."""
    x = np.random.RandomState(2).rand(2, 3, 8, 8).astype(np.float32)

    def run(pkg):
        dy = pkg.dygraph
        conv = dy.Conv2D(3, 4, 3, padding=1)
        bn = dy.BatchNorm(4)
        pool = dy.Pool2D(pool_size=2, pool_stride=2, pool_type="avg")
        xin = dy.to_variable(x)
        xin.stop_gradient = True
        loss = pkg.layers.mean(pkg.layers.square(pool(bn(conv(xin)))))
        loss.backward()
        assert xin.gradient() is None
        assert float(np.abs(conv.weight.gradient()).sum()) > 0
        return [conv.weight.gradient(), conv.bias.gradient(),
                bn.weight.gradient(), bn.bias.gradient()]
    want, got = _both(run)
    _close(got, want, atol=1e-6)


def test_tape_accumulates_until_clear():
    """Two backward() calls accumulate grads (reference semantics); the
    graph kept by retain_graph=True serves the second; the root's own
    gradient is the seed, summed."""
    def run(pkg):
        net = pkg.dygraph.Linear(3, 2)
        x = pkg.dygraph.to_variable(np.ones((2, 3), np.float32))
        loss = pkg.layers.mean(net(x))
        loss.backward(retain_graph=True)
        g1 = net.weight.gradient().copy()
        loss.backward()
        g2 = net.weight.gradient()
        np.testing.assert_allclose(g2, 2 * g1, rtol=1e-6)
        seeds = loss.gradient()
        net.clear_gradients()
        assert net.weight.gradient() is None
        return g1, g2, seeds, x.gradient()
    want, got = _both(run)
    np.testing.assert_array_equal(got[2], [2.0])
    _close(got, want)


def test_dygraph_grad_clip_by_value_and_norm():
    """Each strategy clips (param, grad) pairs as the JAX package's does;
    no guard needed."""
    class P:
        pass
    g = np.array([3.0, -4.0], np.float32)
    g2 = np.array([0.0, 0.0], np.float32)
    results = {}
    for name, mod in (("jax", pt.dygraph.grad_clip),
                      ("port", ptt.dygraph.grad_clip)):
        results[name] = [
            np.asarray(mod.GradClipByValue(1.0)([(P(), g)])[0][1]),
            np.asarray(mod.GradClipByValue(-2.0, 1.0)([(P(), g)])[0][1]),
            np.asarray(mod.GradClipByNorm(2.5)([(P(), g)])[0][1]),
            np.asarray(mod.GradClipByNorm(9.0)([(P(), g)])[0][1]),
            np.asarray(mod.GradClipByGlobalNorm(2.5)(
                [(P(), g), (P(), g2), (P(), None)])[0][1]),
            np.asarray(mod.GradClipByGlobalNorm(100.0)([(P(), g)])[0][1])]
        assert mod.GradClipByGlobalNorm(2.5)([(P(), None)])[0][1] is None
    got = results["port"]
    np.testing.assert_allclose(got[0], [1.0, -1.0])
    np.testing.assert_allclose(got[2], [1.5, -2.0], rtol=1e-6)
    np.testing.assert_allclose(got[4], [1.5, -2.0], rtol=1e-6)
    np.testing.assert_allclose(got[5], g)
    _close(got, results["jax"])
    import paddle_tpu.dygraph_grad_clip as jclip
    import paddle_tpu_torch.dygraph_grad_clip as tclip
    assert tclip.__all__ == jclip.__all__
    assert str(tclip.GradClipByNorm(2.5)) == str(jclip.GradClipByNorm(2.5))


def test_dygraph_minimize_grad_clip_and_legacy_grads_typeerror():
    x = np.ones((4, 2), np.float32)

    def run(pkg):
        clip = pkg.dygraph.grad_clip.GradClipByGlobalNorm(1e-8)
        layer = pkg.dygraph.Linear(2, 1)
        layer.loss_and_grad(_mean_loss(pkg), x)
        w_before = layer.weight.numpy()
        opt = pkg.dygraph.optimizers.SGD(learning_rate=1.0)
        opt.minimize(layer, grad_clip=clip)
        # clipped to ~zero global norm: weights essentially unchanged
        np.testing.assert_allclose(layer.weight.numpy(), w_before,
                                   atol=1e-6)
        with pytest.raises(TypeError):
            opt.minimize(layer, {"some": "grads"})
        with pytest.raises(ValueError):
            opt.minimize(None)
        # minimize(params, grads=): the given gradients, not p._grad
        grads = {id(p): np.full(p.shape, 0.5, np.float32)
                 for p in layer.parameters()}
        opt.minimize(layer.parameters(), grads=grads)
        return layer.state_dict()
    want, got = _both(run)
    _close(got, want)


_DECAYS = [
    ("PiecewiseDecay", ([3, 6], [1.0, 0.5, 0.1], 0), {}),
    ("NaturalExpDecay", (1.0, 3, 0.5), {"staircase": True}),
    ("ExponentialDecay", (1.0, 2, 0.5), {}),
    ("InverseTimeDecay", (0.5, 2, 0.3), {"staircase": True}),
    ("PolynomialDecay", (1.0, 5), {"end_learning_rate": 0.1, "power": 2.0,
                                   "cycle": True}),
    ("CosineDecay", (1.0, 2, 4), {}),
    ("NoamDecay", (64, 10), {}),
    ("LinearLrWarmup", (0.8, 4, 0.0, 0.8), {"begin": 0}),
]


@pytest.mark.parametrize("name,args,kw", _DECAYS,
                         ids=[d[0] for d in _DECAYS])
def test_dygraph_lr_scheduler_values(name, args, kw):
    """Twelve calls of each of the eight decays give the JAX package's
    rates (pure Python on both sides: exactly)."""
    got = getattr(ptt.dygraph, name)(*args, **kw)
    want = getattr(pt.dygraph, name)(*args, **kw)
    vals = [got() for _ in range(12)]
    assert vals == [want() for _ in range(12)]
    assert got.step_num == want.step_num


def test_dygraph_lr_schedulers():
    pw = ptt.dygraph.PiecewiseDecay([3, 6], [1.0, 0.5, 0.1], begin=0)
    vals = [pw() for _ in range(8)]
    assert vals[:3] == [1.0] * 3 and vals[3:6] == [0.5] * 3
    assert vals[6:] == [0.1] * 2
    nd = ptt.dygraph.NoamDecay(d_model=64, warmup_steps=10)
    warm = [nd() for _ in range(20)]
    assert warm.index(max(warm)) in (9, 10)  # peak at warmup end
    lw = ptt.dygraph.LinearLrWarmup(
        ptt.dygraph.ExponentialDecay(1.0, 1, 0.5), warmup_steps=4,
        start_lr=0.0, end_lr=0.8, begin=0)
    ws = [lw() for _ in range(6)]
    assert abs(ws[0]) < 1e-9 and abs(ws[2] - 0.4) < 1e-9
    assert ws[5] == 0.5 ** 5   # the wrapped decay advanced every call

    # drives a dygraph optimizer end to end; the schedule is called once
    # per parameter updated, as in the JAX package
    def run(pkg):
        lin = pkg.dygraph.Linear(4, 2)
        sched = pkg.dygraph.ExponentialDecay(0.1, decay_steps=1,
                                             decay_rate=0.5)
        opt = pkg.dygraph.optimizers.SGDOptimizer(
            learning_rate=sched, parameter_list=lin.parameters())
        x = pkg.dygraph.to_variable(np.ones((2, 4), np.float32))
        before = lin.weight.numpy()
        for _ in range(3):
            lin(x).backward()
            opt.minimize(lin)
            lin.clear_gradients()
        assert not np.allclose(before, lin.weight.numpy())
        return sched.step_num, lin.state_dict()
    want, got = _both(run)
    assert got[0] == want[0] == 6
    _close(got[1], want[1])


def test_guard_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ptt.NoCUDADeviceError, match="CPUPlace"):
        with ptt.dygraph.guard():
            pass
    with pytest.raises(ptt.NoCUDADeviceError):
        ptt.dygraph.enable_dygraph()
    assert not ptt.in_dygraph_mode()
    with pytest.raises(ptt.NoCUDADeviceError):
        ptt.dygraph.to_variable(np.ones(2, np.float32))
    with ptt.dygraph.guard(ptt.CPUPlace()):
        assert ptt.in_dygraph_mode()
        v = ptt.dygraph.to_variable(np.ones(2))
        assert v.value.device.type == "cpu" and v.dtype == "float32"
    assert not ptt.in_dygraph_mode()


def test_guard_applies_the_executors_precision(monkeypatch):
    """guard() sets the Executor's precision contract: no TF32 in
    matmuls or convolutions (torch's own default lets cuDNN use TF32)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with ptt.dygraph.guard(ptt.CPUPlace()):
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.deterministic


def test_live_intermediate_gets_its_gradient_and_a_dead_one_is_dropped():
    """A variable the user holds gets the gradient the JAX package's walk
    gives it (held through a weak hook); one the user dropped is freed."""
    x = np.random.RandomState(3).rand(4, 5).astype(np.float32)

    def run(pkg):
        l1, l2 = pkg.dygraph.Linear(5, 6), pkg.dygraph.Linear(6, 2)
        h = l1(pkg.dygraph.to_variable(x))
        dead = pkg.layers.square(h)
        ref = weakref.ref(dead)
        del dead
        gc.collect()
        if pkg is ptt:
            assert ref() is None
        loss = pkg.layers.mean(l2(h))
        loss.backward()
        return h.gradient(), loss.gradient(), l1.weight.gradient()
    want, got = _both(run)
    assert got[0] is not None and got[0].shape == (4, 6)
    _close(got, want)


def test_retain_graph_then_minimize_refuses_loudly():
    """The optimizer writes the parameter in place (its version bumped),
    so a graph kept by retain_graph=True whose backward would read the
    old weight raises instead of reading the new one silently."""
    x = np.random.RandomState(4).rand(3, 4).astype(np.float32)
    with ptt.dygraph.guard(ptt.CPUPlace()):
        net = ptt.dygraph.Linear(4, 2)
        w = net.weight.value
        for opt in (ptt.dygraph.optimizers.SGD(0.1),
                    ptt.dygraph.optimizers.Momentum(0.1),
                    ptt.dygraph.optimizers.Adam(0.1)):
            loss = ptt.layers.mean(ptt.layers.square(
                net(ptt.dygraph.to_variable(x))))
            loss.backward(retain_graph=True)
            opt.minimize(net)
            assert net.weight.value is w      # the same tensor, updated
            with pytest.raises(ptt.dygraph.base.InplaceUpdateError,
                               match="retain_graph"):
                loss.backward()
        # a fresh forward reads the new weights and runs
        loss = ptt.layers.mean(net(ptt.dygraph.to_variable(x)))
        loss.backward()
        assert net.weight.gradient() is not None


def test_set_dict_writes_in_place():
    with ptt.dygraph.guard(ptt.CPUPlace()):
        net = ptt.dygraph.Linear(3, 2)
        w = net.weight.value
        net.set_dict({"weight": np.full((3, 2), 2.0, np.float32),
                      "bias": np.ones(2)})
        assert net.weight.value is w and float(w.sum()) == 12.0
        assert net.bias.value.dtype == torch.float32
        net.set_dict({"weight": np.ones((5, 2), np.float32)})
        assert net.weight.shape == (5, 2)


@pytest.mark.parametrize("name", ["BatchNorm", "SpectralNorm"])
def test_layer_state_is_updated_in_its_own_tensor(name):
    """BatchNorm's moving statistics and SpectralNorm's U/V take each new
    value in the tensor they had (a TracedLayer's CUDA graph reads them by
    address), through a backward and in eval mode too."""
    rng = np.random.RandomState(0)
    with ptt.dygraph.guard(ptt.CPUPlace()):
        if name == "BatchNorm":
            layer, bufs = ptt.dygraph.BatchNorm(3), ("_mean", "_variance")
            x = ptt.dygraph.to_variable(
                rng.standard_normal((4, 3, 2, 2)).astype(np.float32) + 2)
        else:
            layer, bufs = ptt.dygraph.SpectralNorm([5, 4]), ("_u", "_v")
            x = ptt.dygraph.to_variable(
                rng.standard_normal((5, 4)).astype(np.float32))
        held = [getattr(layer, b).value for b in bufs]
        start = [t.clone() for t in held]
        ptt.layers.reduce_sum(layer(x)).backward()
        layer.eval()
        layer(x)
        for b, t, s in zip(bufs, held, start):
            assert getattr(layer, b).value is t, b
            assert not torch.equal(t, s), b


def test_traced_layer_recaptures_only_when_a_tensor_moves():
    """What the CUDA graphs read (each parameter's and buffer's address and
    layout) stays put through training steps, the layers' own state
    updates and set_dict at the same shape; set_dict at another shape
    moves it, and a traced call then captures anew."""
    rng = np.random.RandomState(0)
    x = rng.standard_normal((4, 3, 6, 6)).astype(np.float32)
    with ptt.dygraph.guard(ptt.CPUPlace()):
        net = ptt.dygraph.Sequential(
            ptt.dygraph.Conv2D(3, 4, 3, padding=1),
            ptt.dygraph.BatchNorm(4, act="relu"))
        opt = ptt.dygraph.optimizers.Adam(
            1e-2, parameter_list=net.parameters())
        traced = ptt.dygraph.TracedLayer(net)
        sig = traced._signature()
        assert len(sig) == 6                 # 4 parameters, 2 buffers
        loss = ptt.layers.reduce_mean(net(ptt.dygraph.to_variable(x)))
        loss.backward()
        opt.minimize(loss)
        net.set_dict(net.state_dict())
        assert traced._signature() == sig
        conv = list(net.sublayers())[0]
        conv.set_dict({"weight": np.zeros((4, 3, 1, 1), np.float32)})
        assert traced._signature() != sig


def test_no_grad_and_reset_tape():
    x = np.ones((2, 3), np.float32)
    with ptt.dygraph.guard(ptt.CPUPlace()):
        net = ptt.dygraph.Linear(3, 2)
        with ptt.dygraph.no_grad():
            out = net(ptt.dygraph.to_variable(x))
        assert not out.value.requires_grad
        out2 = net(ptt.dygraph.to_variable(x))
        assert out2.value.grad_fn is not None
        ptt.dygraph.reset_tape()
        assert out2.value.grad_fn is None
        decorated = ptt.dygraph.no_grad(lambda: net(
            ptt.dygraph.to_variable(x)))
        assert not decorated().value.requires_grad
        with ptt.dygraph.pause_tape():
            assert not net(ptt.dygraph.to_variable(x)).value.requires_grad


def test_static_layer_creating_parameters_raises():
    """A static layer that creates parameters (fc) finds no eager value
    for them: the JAX package's KeyError, in both."""
    for pkg in (pt, ptt):
        with _guard(pkg):
            x = pkg.dygraph.to_variable(np.ones((2, 3), np.float32))
            with pytest.raises(KeyError, match="no eager value"):
                pkg.layers.fc(x, 4)


def test_in_dygraph_mode_and_fluid_aliases():
    import paddle_tpu_torch.fluid as fluid
    import paddle_tpu_torch.fluid.dygraph as fdy
    import paddle_tpu_torch.fluid.dygraph_grad_clip as fclip
    assert not ptt.in_dygraph_mode()
    with fdy.guard(fluid.CPUPlace()):
        assert fluid.in_dygraph_mode() and ptt.dygraph.enabled()
        assert isinstance(fdy.Linear(2, 2), ptt.dygraph.Layer)
    assert fclip.GradClipByValue is ptt.dygraph.GradClipByValue
    import types
    for name, obj in vars(pt.dygraph).items():
        if not name.startswith("_") and not isinstance(obj,
                                                       types.ModuleType):
            assert hasattr(ptt.dygraph, name), name


def test_data_parallel_refuses_more_than_one_rank(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    with ptt.dygraph.guard(ptt.CPUPlace()):
        with pytest.raises(ptt.NotPortedError, match="torch.distributed"):
            ptt.dygraph.prepare_context()
        with pytest.raises(ptt.NotPortedError):
            ptt.dygraph.DataParallel(ptt.dygraph.Linear(2, 2))
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "1")
    assert ptt.dygraph.ParallelEnv().nranks == 1


def test_small_modules(tmp_path):
    from paddle_tpu_torch.dygraph import (backward_strategy, dygraph_utils,
                                          layer_object_helper, math_op_patch,
                                          profiler, tracer,
                                          varbase_patch_methods)
    assert backward_strategy.BackwardStrategy().sort_sum_gradient is False
    math_op_patch.monkey_patch_math_varbase()
    varbase_patch_methods.monkey_patch_varbase()
    assert layer_object_helper.LayerObjectHelper is ptt.layer_helper\
        .LayerHelper
    path = str(tmp_path / "trace.json")
    with ptt.dygraph.guard(ptt.CPUPlace()):
        x = ptt.dygraph.to_variable(np.ones((2, 3), np.float32))
        with profiler.profiler(profile_path=path):
            y = dygraph_utils._append_activation_in_dygraph(x, "relu")
        assert dygraph_utils._append_activation_in_dygraph(x) is x
        assert tracer.Tracer().tape == [y]
        out = ptt.dygraph.Linear(3, 2)(y)
        assert out in tracer.Tracer().tape
        ptt.dygraph.reset_tape()
        assert tracer.Tracer().tape == []
    assert (tmp_path / "trace.json").exists()


def test_create_parameter_with_an_initializer():
    """An initializer given through ``attr`` runs as a startup program
    through the port's Executor on the guard's place (the JAX package's
    ``_materialize_init``): a constant gives the JAX package's values."""
    def run(pkg):
        attr = pkg.ParamAttr(initializer=pkg.initializer.ConstantInitializer(
            0.5))
        layer = pkg.dygraph.Linear(4, 3, param_attr=attr)
        return layer.state_dict()
    want, got = _both(run)
    np.testing.assert_array_equal(got["weight"], np.full((4, 3), 0.5))
    _close(got, want)
