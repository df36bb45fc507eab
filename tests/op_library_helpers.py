"""Shared helpers of the op-library tests (tests/test_torch_op_library_*.py):
one registry kernel of each package called on the same numpy inputs.

``compare`` runs the JAX package's kernel (under ``jax.vjp`` where a
gradient is asked for) and the port's (under ``torch.autograd.grad``),
and holds every output and every input gradient of the port to the JAX
package's: f32 within rtol 1e-5 and atol 1e-5 unless a case states a
looser bound beside its reason; integer, bool and index outputs, and
what an op only moves or chooses, exactly (``exact``). The gradient is
that of sum_i <out_i, cot_i> over the outputs ``grad_outs``, the
cotangents random from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from paddle_tpu.ops.registry import get_op as jget
from paddle_tpu_torch.ops.registry import get_op as tget

TOL = dict(rtol=1e-5, atol=1e-5)


class TorchCtx(object):
    """The port's run context for a kernel called alone, on the CPU."""
    device = torch.device("cpu")

    def __init__(self, seed=0):
        self._seed = seed

    def generator(self, attrs=None, flagged=True):
        g = torch.Generator()
        g.manual_seed(self._seed)
        return g

    def constant(self, make):
        return make()


def f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _as_list(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


def _jax_ins(ins):
    return {k: [jnp.asarray(v) for v in vs] for k, vs in ins.items()}


def _torch_ins(ins):
    return {k: [torch.from_numpy(np.array(v)) for v in vs]
            for k, vs in ins.items()}


def _flat(outs, names):
    vals = []
    for n in names:
        vals.extend(_as_list(outs[n]))
    return vals


def check(got, want, exact=False, what="", tol=TOL):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, err_msg=what, **tol)


def compare(op, ins, attrs, diff=(), outs=None, exact=(), grad_outs=None,
            seed=0, tol=TOL, grad_tol=None, jit=False, jax_ctx=None):
    """The two kernels of ``op`` on ``ins`` ({slot: [numpy arrays]});
    ``diff``: the (slot, index) inputs whose gradients are compared.
    ``jit`` runs the JAX kernel (and its vjp) under ``jax.jit``: one
    compile instead of one per eager op, for kernels of many small ops;
    ``jax_ctx`` is the JAX kernel's ``ctx``. Returns (the port's outputs,
    the JAX package's outputs) as numpy."""
    raw, tfn = jget(op).fn, tget(op).fn
    if jit:
        jfn = _jitted(raw, jax_ctx, attrs)
    else:
        def jfn(_ctx, cur, at):
            return raw(jax_ctx, cur, at)
    jout = jfn(None, _jax_ins(ins), attrs)
    names = list(outs or jout)
    tins = _torch_ins(ins)
    leaves = []
    for slot, i in diff:
        tins[slot][i] = tins[slot][i].clone().requires_grad_()
        leaves.append(tins[slot][i])
    with torch.enable_grad():
        tout = tfn(TorchCtx(), tins, attrs)
    for n in names:
        js, ts = _as_list(jout[n]), _as_list(tout[n])
        assert len(js) == len(ts), n
        for k, (j, t) in enumerate(zip(js, ts)):
            check(t.detach().numpy(), np.asarray(j), n in exact,
                  "%s %s[%d]" % (op, n, k), tol)
    if diff:
        gnames = grad_outs or [names[0]]
        jvals = [np.asarray(v) for v in _flat(jout, gnames)]
        rng = np.random.RandomState(seed + 7)
        cots = [rng.standard_normal(v.shape).astype(np.float32)
                for v in jvals]
        jins = _jax_ins(ins)

        def f(*vals):
            cur = {k: list(v) for k, v in jins.items()}
            for (slot, i), v in zip(diff, vals):
                cur[slot][i] = v
            return tuple(_flat(jfn(None, cur, attrs), gnames))

        _, vjp = jax.vjp(f, *[jins[s][i] for s, i in diff])
        wgrads = vjp(tuple(jnp.asarray(c, v.dtype)
                           for c, v in zip(cots, jvals)))
        tvals = _flat(tout, gnames)
        tgrads = torch.autograd.grad(
            tvals, leaves, [torch.from_numpy(c).to(t.dtype)
                            for c, t in zip(cots, tvals)],
            allow_unused=True)
        for (slot, i), leaf, g, w in zip(diff, leaves, tgrads, wgrads):
            g = torch.zeros_like(leaf) if g is None else g
            check(g.numpy(), np.asarray(w), False,
                  "%s d%s[%d]" % (op, slot, i), grad_tol or tol)
    return ({n: [t.detach().numpy() for t in _as_list(tout[n])]
             for n in names},
            {n: [np.asarray(j) for j in _as_list(jout[n])] for n in names})


def _jitted(raw, ctx, attrs):
    """``raw(ctx, ins, attrs)`` under ``jax.jit`` over ``ins``."""
    fn = jax.jit(lambda cur: raw(ctx, cur, attrs))
    return lambda _ctx, cur, _attrs: fn(cur)


def registry_flags_match(ops):
    """Each op's nondiff, uses_rng and differentiable flags equal the JAX
    package's (the backward and the Executor read them)."""
    for op in ops:
        j, t = jget(op), tget(op)
        assert tuple(j.nondiff) == t.nondiff, op
        assert bool(j.uses_rng) == t.uses_rng, op
        assert bool(j.differentiable) == t.differentiable, op
