"""The eight op types the dygraph layers brought to the port: the port
against the JAX package, forward and gradient.

conv3d and group_norm (ops/nn_ops.py), conv3d_transpose and row_conv
(ops/vision_ops.py), bilinear_tensor_product and spectral_norm
(ops/misc_ops.py), nce (ops/loss_extra_ops.py) and tree_conv
(ops/contrib_ops.py): each registry kernel is called on the same inputs,
made from a seed with numpy, in both packages; the gradients of the
differentiable slots come from ``jax.vjp`` and ``torch.autograd.grad``
against the same random cotangent. f32 on both sides, only the order of
sums differs: outputs and gradients within rtol 1e-5 and an atol of 1e-5
times the JAX array's largest magnitude (at least 1e-5; a filter
gradient of magnitude ~15 sums hundreds of products). nce samples its noise classes from a generator (a
jax key in the JAX package, a torch.Generator here, different streams):
its cost is compared given the JAX package's own samples, and the port's
sampler by its statistics against the JAX package's q(class).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import loss_extra_ops as jlx
from paddle_tpu.ops.registry import get_op as jget
from paddle_tpu_torch.ops import loss_extra_ops as tlx
from paddle_tpu_torch.ops.registry import get_op as tget

RTOL, ATOL = 1e-5, 1e-5


class _TorchCtx(object):
    device = torch.device("cpu")

    def __init__(self, seed=0):
        self._seed = seed

    def generator(self, attrs=None):
        g = torch.Generator()
        g.manual_seed(self._seed)
        return g


def _jax_run(op, ins, attrs, diff, out, cot, ctx=None):
    fn = jget(op).fn
    jins = {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()}

    def f(*vals):
        cur = {k: list(v) for k, v in jins.items()}
        for (slot, i), v in zip(diff, vals):
            cur[slot][i] = v
        return fn(ctx, cur, attrs)[out]

    val, vjp = jax.vjp(f, *[jins[s][i] for s, i in diff])
    return np.asarray(val), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def _torch_run(op, ins, attrs, diff, out, cot, ctx=None):
    fn = tget(op).fn
    tins = {k: [torch.from_numpy(np.array(v)) for v in vs]
            for k, vs in ins.items()}
    leaves = []
    for slot, i in diff:
        tins[slot][i] = tins[slot][i].clone().requires_grad_()
        leaves.append(tins[slot][i])
    val = fn(ctx or _TorchCtx(), tins, attrs)[out]
    grads = torch.autograd.grad(val, leaves, torch.from_numpy(cot),
                                allow_unused=True)
    # an input the output does not read: zeros, as jax.vjp gives
    return val.detach().numpy(), [
        (torch.zeros_like(t) if g is None else g).numpy()
        for t, g in zip(leaves, grads)]


def _compare(op, ins, attrs, diff, out="Out", seed=0):
    cot = _cot(op, ins, attrs, out, seed)
    want, wgrads = _jax_run(op, ins, attrs, diff, out, cot)
    got, tgrads = _torch_run(op, ins, attrs, diff, out, cot)
    assert got.shape == want.shape
    _close(got, want)
    for (slot, i), g, w in zip(diff, tgrads, wgrads):
        _close(g, w, "d%s[%d]" % (slot, i))


def _compare_outputs(op, ins, attrs, outs):
    """Forward only: the op's outputs ``outs`` in both packages."""
    want = jget(op).fn(None, {k: [jnp.asarray(v) for v in vs]
                              for k, vs in ins.items()}, attrs)
    got = tget(op).fn(None, {k: [torch.from_numpy(v) for v in vs]
                             for k, vs in ins.items()}, attrs)
    for out in outs:
        _close(got[out].numpy(), np.asarray(want[out]), out)


def _close(got, want, what=""):
    atol = ATOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol,
                               err_msg=what)


def _cot(op, ins, attrs, out, seed):
    """A random cotangent shaped like the op's output ``out``."""
    fn = jget(op).fn
    shape = np.asarray(fn(None, {k: [jnp.asarray(v) for v in vs]
                                 for k, vs in ins.items()},
                          attrs)[out]).shape
    return np.random.RandomState(seed + 7).standard_normal(shape).astype(
        np.float32)


def _f(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("attrs", [
    {"strides": [1, 1, 1], "paddings": [1, 1, 1]},
    {"strides": [2, 1, 2], "paddings": [0, 1, 1], "dilations": [1, 2, 1]},
    {"strides": [1, 1, 1], "paddings": [0, 0, 0], "groups": 3},
], ids=["same", "strided_dilated", "groups"])
def test_conv3d(attrs):
    rng = np.random.RandomState(0)
    g = attrs.get("groups", 1)
    ins = {"Input": [_f(rng, 2, 3, 5, 7, 6)],
           "Filter": [_f(rng, 6, 3 // g, 3, 3, 3)]}
    _compare("conv3d", ins, attrs, [("Input", 0), ("Filter", 0)],
             out="Output")


@pytest.mark.parametrize("attrs", [
    {"strides": [2, 2, 2]},
    {"strides": [1, 2, 1], "paddings": [1, 0, 1], "dilations": [2, 1, 1]},
    {"strides": [2, 2, 2], "output_size": [9, 13, 13]},
], ids=["stride2", "padded_dilated", "output_size"])
def test_conv3d_transpose(attrs):
    rng = np.random.RandomState(1)
    ins = {"Input": [_f(rng, 2, 3, 4, 6, 6)],
           "Filter": [_f(rng, 3, 4, 3, 3, 3)]}
    _compare("conv3d_transpose", ins, attrs,
             [("Input", 0), ("Filter", 0)], out="Output")


@pytest.mark.parametrize("shape,groups", [((2, 8, 5, 5), 4),
                                          ((3, 6, 2, 3, 4), 3)])
def test_group_norm(shape, groups):
    rng = np.random.RandomState(2)
    c = shape[1]
    ins = {"X": [_f(rng, *shape) * 3 + 1], "Scale": [_f(rng, c)],
           "Bias": [_f(rng, c)]}
    attrs = {"groups": groups, "epsilon": 1e-5}
    _compare("group_norm", ins, attrs, [("X", 0), ("Scale", 0), ("Bias", 0)],
             out="Y")
    _compare_outputs("group_norm", ins, attrs, ("Mean", "Variance"))


@pytest.mark.parametrize("k", [1, 3])
def test_row_conv(k):
    rng = np.random.RandomState(3)
    ins = {"X": [_f(rng, 2, 7, 5)], "Filter": [_f(rng, k, 5)]}
    _compare("row_conv", ins, {}, [("X", 0), ("Filter", 0)])


@pytest.mark.parametrize("bias_shape", [(6,), (1, 6), None])
def test_bilinear_tensor_product(bias_shape):
    rng = np.random.RandomState(4)
    ins = {"X": [_f(rng, 3, 4)], "Y": [_f(rng, 3, 5)],
           "Weight": [_f(rng, 6, 4, 5)]}
    diff = [("X", 0), ("Y", 0), ("Weight", 0)]
    if bias_shape is not None:
        ins["Bias"] = [_f(rng, *bias_shape)]
        diff.append(("Bias", 0))
    _compare("bilinear_tensor_product", ins, {}, diff)


@pytest.mark.parametrize("shape,dim,iters", [((6, 4), 0, 1),
                                             ((4, 3, 2), 1, 3)])
def test_spectral_norm(shape, dim, iters):
    rng = np.random.RandomState(5)
    h = shape[dim]
    w = int(np.prod(shape)) // h
    ins = {"Weight": [_f(rng, *shape)], "U": [_f(rng, h)],
           "V": [_f(rng, w)]}
    attrs = {"dim": dim, "power_iters": iters, "eps": 1e-12}
    _compare("spectral_norm", ins, attrs, [("Weight", 0)])
    _compare_outputs("spectral_norm", ins, attrs, ("UOut", "VOut"))


@pytest.mark.parametrize("max_depth", [2, 3])
def test_tree_conv(max_depth):
    rng = np.random.RandomState(6)
    edges = np.array([[[0, 1], [0, 2], [1, 3], [1, 4], [-1, -1]],
                      [[0, 1], [1, 2], [2, 3], [-1, -1], [-1, -1]]],
                     np.int64)
    ins = {"NodesVector": [_f(rng, 2, 6, 4)], "EdgeSet": [edges],
           "Filter": [_f(rng, 4, 3, 5, 2)]}
    _compare("tree_conv", ins, {"max_depth": max_depth},
             [("NodesVector", 0), ("Filter", 0)])


class _KeyCtx(object):
    def __init__(self, key):
        self._key = key

    def rng(self):
        return self._key


@pytest.mark.parametrize("sampler", ["uniform", "log_uniform"])
def test_nce_cost_given_the_same_samples(sampler):
    """The port's cost (``nce_cost``) on the noise classes the JAX op drew
    from its key, against the JAX op's cost and gradients."""
    rng = np.random.RandomState(7)
    c, d, n, k = 30, 8, 5, 6
    x, w, b = _f(rng, n, d), _f(rng, c, d), _f(rng, c)
    label = rng.randint(0, c, (n, 1)).astype(np.int64)
    key = jax.random.PRNGKey(11)
    attrs = {"num_total_classes": c, "num_neg_samples": k,
             "sampler": sampler}
    ins = {"Input": [x], "Label": [label], "Weight": [w], "Bias": [b]}
    neg = np.asarray(jlx._sample_classes(key, c, k, sampler))
    cot = np.random.RandomState(8).standard_normal((n, 1)).astype(
        np.float32)
    want, wgrads = _jax_run("nce", ins, attrs,
                            [("Input", 0), ("Weight", 0), ("Bias", 0)],
                            "Cost", cot, ctx=_KeyCtx(key))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    got = tlx.nce_cost(tx, torch.from_numpy(label.reshape(-1)), tw, tb,
                       torch.from_numpy(neg.astype(np.int64)), c, sampler)
    grads = torch.autograd.grad(got, [tx, tw, tb], torch.from_numpy(cot))
    _close(got.detach().numpy(), want)
    for g, wg in zip(grads, wgrads):
        _close(g.numpy(), wg)


@pytest.mark.parametrize("sampler", ["uniform", "log_uniform"])
def test_nce_sampler_statistics(sampler):
    """The port's noise classes: counts over 2^16 draws within 5
    standard errors of the JAX package's q(class) (``_sampler_prob``),
    and the op's draws follow its generator's seed."""
    c, n = 25, 1 << 16
    g = torch.Generator()
    g.manual_seed(3)
    drawn = tlx.sample_classes(g, c, n, sampler, torch.device("cpu"))
    assert drawn.dtype == torch.int64
    counts = np.bincount(drawn.numpy(), minlength=c)
    assert counts.size == c and counts.sum() == n
    q = np.asarray(jlx._sampler_prob(jnp.arange(c), c, sampler))
    se = np.sqrt(n * q * (1 - q))
    assert np.all(np.abs(counts - n * q) <= 5 * se)
    rng = np.random.RandomState(9)
    ins = {"Input": [torch.from_numpy(_f(rng, 4, 8))],
           "Label": [torch.from_numpy(rng.randint(0, c, (4, 1)))],
           "Weight": [torch.from_numpy(_f(rng, c, 8))],
           "Bias": [torch.from_numpy(_f(rng, c))]}
    attrs = {"num_total_classes": c, "num_neg_samples": 5,
             "sampler": sampler}
    op = tget("nce")
    assert op.uses_rng and op.nondiff == ("Label",)
    a = op.fn(_TorchCtx(1), ins, attrs)["Cost"]
    b = op.fn(_TorchCtx(1), ins, attrs)["Cost"]
    other = op.fn(_TorchCtx(2), ins, attrs)["Cost"]
    assert a.shape == (4, 1) and torch.isfinite(a).all()
    assert torch.equal(a, b) and not torch.equal(a, other)


def test_registry_metadata_matches_the_jax_package():
    """The eight op types carry the JAX package's nondiff and rng flags
    (the backward and the Executor read them)."""
    for op in ("conv3d", "group_norm", "conv3d_transpose", "row_conv",
               "bilinear_tensor_product", "spectral_norm", "nce",
               "tree_conv"):
        j, t = jget(op), tget(op)
        assert tuple(j.nondiff) == t.nondiff, op
        assert bool(j.uses_rng) == t.uses_rng, op
        assert bool(getattr(j, "differentiable", True)) == \
            t.differentiable, op
