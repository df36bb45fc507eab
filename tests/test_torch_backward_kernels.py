"""The port's backward and optimizer kernel modules against the JAX
package's Pallas kernels.

paddle_tpu_torch/ops/kernels/{flash_attention,layer_norm,fused_adam}.py
hold the flash-attention dK/dV and dQ kernels, the LayerNorm backward
kernel and the fused-Adam kernel, each beside its plain PyTorch version.
The CUDA kernels run only on the card (chip_smoke.py holds them against
the plain versions there); here the plain versions are held against the
Pallas kernels they replace, run in interpret mode on the CPU, on the
same numpy inputs.

Tolerances: f32 on both sides (the Pallas kernels use HIGHEST-precision
dots for f32), so only the order of sums differs. Attention gradients of
order 1-5, summed over up to 48 keys or queries: rtol 2e-4, atol 2e-5
(tests/test_flash_attention.py's bounds). LayerNorm dx of order 1: 1e-5;
dscale/dbias are sums over the rows: rtol 1e-5, atol 1e-4. Adam: an
elementwise f32 update, the same operations in the same order: 1e-6 on
parameters of order 1, 1e-9 on the moments.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import optimizer_ops as jopt_ops
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas import layer_norm as jln
from paddle_tpu_torch.ops import nn_ops as tnn
from paddle_tpu_torch.ops.kernels import flash_attention as tfa
from paddle_tpu_torch.ops.kernels import fused_adam as tadam
from paddle_tpu_torch.ops.kernels import layer_norm as tln

# the pallas package re-exports its fused_adam function under the
# module's name
jadam = importlib.import_module("paddle_tpu.ops.pallas.fused_adam")

ATTN_TOL = dict(rtol=2e-4, atol=2e-5)


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _mask(mode, b, tq, tk, seed):
    if mode is None:
        return None
    if mode == "k":      # BERT's key-padding bias: 0 / -1e4
        m = np.zeros((b, 1, 1, tk), np.float32)
        for i in range(b):
            m[i, :, :, tk - 5 * (i + 1):] = -1e4
        return m
    return _rand((b, 1, tq, tk), seed)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _inputs(b, h, tq, tk, d, mode):
    q, k, v = _rand((b, h, tq, d), 0), _rand((b, h, tk, d), 1), \
        _rand((b, h, tk, d), 2)
    return q, k, v, _rand((b, h, tq, d), 4), _mask(mode, b, tq, tk, 3)


def _port_bwd(q, k, v, do, mask, scale, causal):
    """The port's plain forward, then its plain backward."""
    out, lse = tfa.flash_attention_plain(_t(q), _t(k), _t(v), _t(mask),
                                         scale, causal)
    return tfa.flash_attention_bwd(_t(q), _t(k), _t(v), _t(mask), out, lse,
                                   _t(do), scale, causal)


@pytest.mark.parametrize("mode,causal,tq,tk,d,block", [
    ("k", False, 32, 32, 16, 16),       # BERT's key mask
    ("qk", False, 32, 48, 16, 16),      # a (B,1,Tq,Tk) mask
    (None, True, 32, 32, 16, 16),       # causal Tq = Tk
    ("k", True, 32, 32, 16, 8),         # causal with a key mask
    ("k", False, 24, 40, 32, 8),        # ragged tiles, another head dim
])
def test_plain_flash_backward_matches_pallas_backward(mode, causal, tq, tk,
                                                      d, block):
    b, h = 2, 2
    q, k, v, do, mask = _inputs(b, h, tq, tk, d, mode)
    scale = d ** -0.5
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    jmask = None if mask is None else jnp.asarray(mask)
    out, lse = jfa._pallas_forward(jq, jk, jv, jmask, scale, causal, block,
                                   block, True)
    want = jfa._pallas_backward(jq, jk, jv, jmask, out, lse, jnp.asarray(do),
                                scale, causal, block, block, True)
    # the port's backward on the JAX forward's residuals, and end to end
    delta = torch.from_numpy(np.array(
        jnp.sum(jnp.asarray(do) * out, axis=-1)))
    on_jax_lse = tfa.flash_attention_bwd_plain(
        _t(q), _t(k), _t(v), _t(mask), _t(lse), delta, _t(do), scale, causal)
    end_to_end = _port_bwd(q, k, v, do, mask, scale, causal)
    for got in (on_jax_lse, end_to_end):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **ATTN_TOL)


@pytest.mark.parametrize("mode", [None, "k"])
def test_plain_flash_backward_rows_that_see_no_key(mode):
    """Causal with Tq > Tk: rows i < Tq - Tk see no key. The JAX entry
    differentiates its XLA reference there, which gives those rows
    dq = 0, no dk and dv += dO / Tk; the plain backward (and the CUDA
    kernels, which share its recipe) must give the same."""
    b, h, tq, tk, d = 2, 2, 24, 16, 16
    q, k, v, do, mask = _inputs(b, h, tq, tk, d, mode)
    scale = 0.3
    fn = lambda q_, k_, v_: jfa.flash_attention(  # noqa: E731
        q_, k_, v_, mask=None if mask is None else jnp.asarray(mask),
        scale=scale, causal=True, interpret=True)
    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    got = _port_bwd(q, k, v, do, mask, scale, True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **ATTN_TOL)
    no_key = tq - tk
    assert np.all(got[0].numpy()[:, :, :no_key] == 0)


@pytest.mark.parametrize("mode,causal,tq,tk", [
    ("k", False, 20, 20), ("qk", False, 12, 20), (None, True, 20, 20),
    ("k", True, 20, 12)])
def test_plain_flash_backward_matches_torch_autograd(mode, causal, tq, tk):
    """The kernels' recipe (p recomputed from lse, ds from delta) against
    autograd of the plain forward, including rows that see no key."""
    b, h, d = 2, 3, 16
    q, k, v, do, mask = _inputs(b, h, tq, tk, d, mode)
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    out, _ = tfa.flash_attention_plain(*leaves, _t(mask), 0.25, causal)
    want = torch.autograd.grad(out, leaves, _t(do))
    got = _port_bwd(q, k, v, do, mask, 0.25, causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **ATTN_TOL)


@pytest.mark.parametrize("mask_shape", [(2, 1, 1, 12), (2, 1, 10, 12),
                                        (1, 1, 10, 12)])
def test_flash_function_mask_gradient_only_when_asked(mask_shape):
    """FlashAttention gives the mask a cotangent (the JAX package's
    _xla_dmask formula, summed over the broadcast axes) only when autograd
    asks for one; a padding mask from the data gets none."""
    q, k, v = (_t(_rand((2, 3, t, 16), s)) for s, t in
               ((0, 10), (1, 12), (2, 12)))
    mask = _t(_rand(mask_shape, 5))
    do = _t(_rand((2, 3, 10, 16), 6))
    leaves = [t.clone().requires_grad_() for t in (q, k, v, mask)]
    out = tfa.FlashAttention.apply(*leaves, 0.25, False)
    got = torch.autograd.grad(out, leaves, do)
    ref = [t.clone().requires_grad_() for t in (q, k, v, mask)]
    ref_out, _ = tfa.flash_attention_plain(*ref, 0.25, False)
    want = torch.autograd.grad(ref_out, ref, do)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), **ATTN_TOL)
    no_mask_grad = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tfa.FlashAttention.apply(*no_mask_grad, mask, 0.25, False)
    out.backward(do)
    assert mask.grad is None


def test_flash_backward_takes_a_strided_dout():
    """flash_attention_bwd gives a strided dout (a transpose's view, as the
    ops hand it over) the same gradients as its contiguous copy."""
    q, k, v, do, mask = _inputs(2, 3, 10, 12, 16, "k")
    args = (_t(q), _t(k), _t(v), _t(mask))
    out, lse = tfa.flash_attention_plain(*args, 0.25, True)
    strided = _t(do).transpose(1, 2).contiguous().transpose(1, 2)
    assert not strided.is_contiguous()
    want = tfa.flash_attention_bwd(*args, out, lse, _t(do), 0.25, True)
    got = tfa.flash_attention_bwd(*args, out, lse, strided, 0.25, True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_flash_backward_makes_dense_operands_once(monkeypatch):
    """Off the CPU, flash_attention_bwd makes the kernels' dense operands
    (a strided dout's copy among them) once and hands them to both
    kernels. Meta tensors stand in for the card's, the launches are
    stubbed."""
    calls, seen = [], []
    monkeypatch.setattr(tfa, "_bwd_operands",
                        lambda *a: calls.append(a) or "operands")

    def launch(name, result):
        def fn(operands, scale, causal):
            seen.append((name, operands, scale, causal))
            return result
        return fn
    monkeypatch.setattr(tfa, "_launch_dkv", launch("dkv", ("dk", "dv")))
    monkeypatch.setattr(tfa, "_launch_dq", launch("dq", "dq"))
    q, k, v, out, do = (torch.empty(2, 3, 10, 16, device="meta")
                        for _ in range(5))
    lse = torch.empty(2, 3, 10, device="meta")
    got = tfa.flash_attention_bwd(q, k, v, None, out, lse,
                                  do.transpose(1, 2).transpose(1, 2), 0.25,
                                  True)
    assert got == ("dq", "dk", "dv")
    assert len(calls) == 1
    assert seen == [("dkv", "operands", 0.25, True),
                    ("dq", "operands", 0.25, True)]


@pytest.mark.parametrize("rows,cols,block_rows", [(37, 64, 16), (8, 300, 8)])
def test_plain_layer_norm_backward_matches_pallas(rows, cols, block_rows):
    x = _rand((rows, cols), 0, scale=3.0) + 1.0
    scale, bias = _rand((cols,), 1) + 1.0, _rand((cols,), 2)
    g = _rand((rows, cols), 3)
    fn = lambda x_, s_, b_: jln.fused_layer_norm(  # noqa: E731
        x_, s_, b_, 1e-5, block_rows=block_rows, interpret=True)
    _, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(scale),
                     jnp.asarray(bias))
    want = vjp(jnp.asarray(g))
    _, mean, rstd = tln.layer_norm_plain(_t(x), _t(scale), _t(bias), 1e-5)
    got = tln.layer_norm_bwd(_t(x), _t(g), _t(scale), mean, rstd)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)
    for gs, ws in zip(got[1:], want[1:]):
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5,
                                   atol=1e-4)


def test_layer_norm_function_matches_autograd_of_plain_forward():
    """LayerNorm.apply's backward (the kernel's recipe) against autograd
    of the plain forward; mean and rstd carry no gradient."""
    x = _t(_rand((12, 40), 0, 2.0) + 1.0)
    scale, bias = _t(_rand((40,), 1) + 1.0), _t(_rand((40,), 2))
    g = _t(_rand((12, 40), 3))
    leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
    y, mean, rstd = tln.LayerNorm.apply(*leaves, 1e-5)
    assert not mean.requires_grad and not rstd.requires_grad
    got = torch.autograd.grad(y, leaves, g)
    ref = [t.clone().requires_grad_() for t in (x, scale, bias)]
    want = torch.autograd.grad(tln.layer_norm_plain(*ref, 1e-5)[0], ref, g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)


def _adam_state(n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(n).astype(np.float32),
            (rng.randn(n) * 1e-2).astype(np.float32),
            (rng.randn(n) * 1e-3).astype(np.float32),
            (rng.rand(n) * 1e-5).astype(np.float32))


def _port_adam(p, g, m1, m2, t, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8):
    return tadam.fused_adam(
        _t(p), _t(g), _t(m1), _t(m2), torch.tensor([lr]),
        torch.tensor([b1 ** t], dtype=torch.float32),
        torch.tensor([b2 ** t], dtype=torch.float32), b1, b2, eps)


@pytest.mark.parametrize("n", [1024, 3000, 8192])
def test_plain_adam_matches_pallas_fused_adam(n):
    p, g, m1, m2 = _adam_state(n, 0)
    t, lr = 3, 1e-3
    lr_t = lr * np.sqrt(1 - np.float32(0.999 ** t)) / \
        (1 - np.float32(0.9 ** t))
    want = jadam.fused_adam(jnp.asarray(p), jnp.asarray(g), jnp.asarray(m1),
                            jnp.asarray(m2), jnp.float32(lr_t),
                            interpret=True)
    assert want is not None
    got = _port_adam(p, g, m1, m2, t, lr)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-6)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-9)


@pytest.mark.parametrize("n", [1, 7, 768])
def test_plain_adam_matches_jax_adam_chain_below_a_tile(n):
    """Below one (8, 128) tile the JAX package keeps its XLA chain (the
    TPU kernel's floor); the port's kernel takes every size, and its
    plain version must match that chain."""
    p, g, m1, m2 = _adam_state(n, 1)
    t = 2
    f32 = np.float32
    ins = {"Param": [jnp.asarray(p)], "Grad": [jnp.asarray(g)],
           "Moment1": [jnp.asarray(m1)], "Moment2": [jnp.asarray(m2)],
           "Beta1Pow": [jnp.asarray([f32(0.9 ** t)])],
           "Beta2Pow": [jnp.asarray([f32(0.999 ** t)])],
           "LearningRate": [jnp.asarray([f32(1e-3)])]}
    want = jopt_ops._adam(None, ins, {})
    got = _port_adam(p, g, m1, m2, t)
    for a, key in zip(got, ("ParamOut", "Moment1Out", "Moment2Out")):
        np.testing.assert_allclose(a.numpy(), np.asarray(want[key]),
                                   rtol=1e-6, atol=1e-9)


def test_wrappers_take_the_plain_path_on_cpu_tensors():
    """On a CPU tensor each new wrapper returns its plain version's answer
    and launches nothing."""
    tfa.dkv_launches = tfa.dq_launches = tln.bwd_launches = 0
    tadam.launches = 0
    q, k, v, do, mask = (_t(a) for a in _inputs(1, 2, 8, 8, 16, "k"))
    out, lse = tfa.flash_attention_plain(q, k, v, mask, 0.25, False)
    delta = (do * out).sum(-1)
    args = (q, k, v, mask, lse, delta, do, 0.25, False)
    want = tfa.flash_attention_bwd_plain(*args)
    dk, dv = tfa.flash_attention_bwd_dkv(*args)
    dq = tfa.flash_attention_bwd_dq(*args)
    for g, w in zip((dq, dk, dv), want):
        assert torch.equal(g, w)
    x, g = _t(_rand((4, 32), 0)), _t(_rand((4, 32), 1))
    _, mean, rstd = tln.layer_norm_plain(x, None, None, 1e-5)
    for a, b in zip(tln.layer_norm_bwd(x, g, None, mean, rstd),
                    tln.layer_norm_bwd_plain(x, g, None, mean, rstd)):
        assert torch.equal(a, b)
    state = _adam_state(100, 2)
    for a, b in zip(_port_adam(*state, 1),
                    tadam.fused_adam_plain(
                        *(_t(s) for s in state), torch.tensor([1e-3]),
                        torch.tensor([0.9]), torch.tensor([0.999]))):
        assert torch.equal(a, b)
    assert (tfa.dkv_launches, tfa.dq_launches, tln.bwd_launches,
            tadam.launches) == (0, 0, 0, 0)


def test_wrappers_raise_on_other_devices():
    """No wrapper falls back to its plain version off the CPU."""
    meta = torch.empty(1, 2, 8, 64, device="meta")
    lse = torch.empty(1, 2, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd_dkv(meta, meta, meta, None, lse, lse, meta)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd_dq(meta, meta, meta, None, lse, lse, meta)
    x = torch.empty(4, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tln.layer_norm_bwd(x, x, None, x[:, 0], x[:, 0])
    with pytest.raises(ValueError, match="CUDA"):
        tadam.fused_adam(x, x, x, x, x[0, :1], x[0, :1], x[0, :1])


@pytest.mark.parametrize("t,v,tiles", [(640, 30522, False), (32, 2, False),
                                       (640, 32000, True), (64, 512, False),
                                       (256, 1024, True)])
def test_head_and_ce_guard_matches_the_jax_tiling_rule(t, v, tiles):
    """The ops refuse a CUDA tensor exactly where the JAX package's
    compiled blockwise kernel would tile: its own fit_blocks says so
    (BERT-base's vocab 30522 and NSP's 2 classes never tile; GPT's 32000
    does)."""
    from paddle_tpu.ops.pallas.costmodel import fit_blocks
    assert (fit_blocks(t, v, 128, 512, False) is not None) == tiles
    assert tnn.fit_blocks(t, v, 128, 512) == \
        fit_blocks(t, v, 128, 512, False)
    assert tnn.blockwise_kernel_would_tile(t, v) == tiles
    assert tnn.blockwise_kernel_would_tile(t, v, d=768) == tiles
    assert not tnn.blockwise_kernel_would_tile(t, v, d=100)
