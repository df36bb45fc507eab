"""The port's blockwise cross-entropy and fused-head kernel module against
the JAX package's Pallas kernels.

paddle_tpu_torch/ops/kernels/blockwise_ce.py holds the CE forward and
backward kernels and the fused head's forward, dhidden and dweight kernels,
each beside its plain PyTorch version. The CUDA kernels run only on the
card (chip_smoke.py holds them against the plain versions there); here the
plain versions are held against the Pallas kernels they replace
(paddle_tpu/ops/pallas/blockwise_ce.py), run in interpret mode on the CPU
on the same numpy inputs: forwards directly, backwards through
``jax.vjp`` of the Pallas entries (their custom_vjp runs the Pallas
backward kernels). The weight goes to JAX transposed, (D, V), as the JAX
op hands it to its kernel.

Tolerances: f32 on both sides, the Pallas dots at HIGHEST precision, so
only the order of sums differs: rtol 2e-5, atol 1e-5. bf16 operands: both
widen them to f32 and sum in f32, but dhidden and dweight come back
rounded to bf16 (8 significant bits): 1e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import blockwise_ce as jce
from paddle_tpu_torch.ops import nn_ops as tnn
from paddle_tpu_torch.ops.kernels import blockwise_ce as tce

F32_TOL = dict(rtol=2e-5, atol=1e-5)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
IGNORE = -100


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _labels(t, v, seed, ignore_every=0):
    lab = np.random.RandomState(seed).randint(0, v, (t,)).astype(np.int64)
    if ignore_every:
        lab[::ignore_every] = IGNORE
    return lab


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,v,block", [(64, 256, 16), (40, 96, 8)])
@pytest.mark.parametrize("with_bias", [True, False])
def test_plain_head_matches_pallas_head(with_bias, t, v, block, dtype):
    d = 32
    h, w = _rand((t, d), 0), _rand((v, d), 1, 0.3)
    b = _rand((v,), 2, 0.5) if with_bias else None
    lab = _labels(t, v, 3, ignore_every=9)
    dl = np.random.RandomState(4).rand(t).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jh, jw = jnp.asarray(h, jdt), jnp.asarray(w.T, jdt)
    jb = None if b is None else jnp.asarray(b)

    def head(h_, w_, b_):
        return jce.fused_mlm_head_loss(h_, w_, jnp.asarray(lab, jnp.int32),
                                       bias=b_, block_t=block, block_v=block,
                                       interpret=True)
    if jb is None:
        want_loss, vjp = jax.vjp(lambda h_, w_: head(h_, w_, None), jh, jw)
    else:
        want_loss, vjp = jax.vjp(head, jh, jw, jb)
    want_grads = vjp(jnp.asarray(dl))

    th, tw = torch.from_numpy(h).to(tdt), torch.from_numpy(w).to(tdt)
    tb = None if b is None else torch.from_numpy(b)
    loss, lse = tce.fused_head_loss(th, tw, torch.from_numpy(lab), tb)
    dh, dw, db = tce.fused_head_bwd(th, tw, torch.from_numpy(lab), tb, lse,
                                    torch.from_numpy(dl))
    assert loss.dtype == torch.float32 and dh.dtype == tdt and \
        dw.dtype == tdt and db.dtype == torch.float32
    np.testing.assert_allclose(loss.numpy(), _np(want_loss), **F32_TOL)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(dh.float().numpy(), _np(want_grads[0]), **tol)
    np.testing.assert_allclose(dw.float().numpy(), _np(want_grads[1]).T,
                               **tol)
    if b is not None:
        np.testing.assert_allclose(db.numpy(), _np(want_grads[2]), **F32_TOL)


def test_head_labels_outside_the_vocab_hit_nothing():
    """A label outside [0, V) (an ignore_index of -100, or V itself): the
    loss is the lse and ds has no -1 in that row."""
    t, d, v = 6, 8, 10
    h, w = torch.from_numpy(_rand((t, d), 0)), torch.from_numpy(
        _rand((v, d), 1))
    lab = torch.tensor([IGNORE, 3, v, 0, IGNORE, 9])
    loss, lse = tce.fused_head_loss(h, w, lab)
    out = torch.tensor([0, 2, 4])
    np.testing.assert_allclose(loss[out].numpy(), lse[out].numpy(),
                               rtol=1e-6)
    logits = h @ w.t()
    dh, dw, _ = tce.fused_head_bwd(h, w, lab, None, lse, torch.ones(t))
    p = torch.softmax(logits, -1)
    np.testing.assert_allclose(dh[out].numpy(), (p @ w)[out].numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,v,bt,bv", [(64, 256, 16, 64), (40, 96, 8, 32)])
def test_plain_ce_matches_pallas_ce(t, v, bt, bv, dtype):
    x = _rand((t, v), 0, 3.0)
    lab = _labels(t, v, 1, ignore_every=7)
    dl = np.random.RandomState(2).rand(t).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jx = jnp.asarray(x, jdt)
    want_loss, vjp = jax.vjp(
        lambda x_: jce.blockwise_softmax_cross_entropy(
            x_, jnp.asarray(lab, jnp.int32), block_t=bt, block_v=bv,
            interpret=True), jx)
    want_dx, = vjp(jnp.asarray(dl))

    tx = torch.from_numpy(x).to(tdt)
    loss, lse = tce.softmax_ce(tx, torch.from_numpy(lab))
    dx = tce.softmax_ce_bwd(tx, torch.from_numpy(lab), lse,
                            torch.from_numpy(dl))
    assert dx.dtype == tdt
    np.testing.assert_allclose(loss.numpy(), _np(want_loss), **F32_TOL)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(dx.float().numpy(), _np(want_dx), **tol)


def test_autograd_functions_run_the_plain_versions_on_cpu():
    """FusedHeadLoss and BlockwiseCE give autograd's own gradients of
    the plain math (bias and the lse's softmax term included), and
    launch nothing on a CPU tensor."""
    t, d, v = 12, 16, 40
    h = torch.from_numpy(_rand((t, d), 0)).requires_grad_()
    w = torch.from_numpy(_rand((v, d), 1, 0.3)).requires_grad_()
    b = torch.from_numpy(_rand((v,), 2)).requires_grad_()
    lab = torch.from_numpy(_labels(t, v, 3))
    cot = torch.from_numpy(_rand((t,), 4))
    counts = [tce.head_launches, tce.head_dh_launches, tce.head_dw_launches,
              tce.ce_launches, tce.ce_bwd_launches]
    got = torch.autograd.grad(
        (tce.FusedHeadLoss.apply(h, w, b, lab) * cot).sum(), (h, w, b))
    ref = torch.nn.functional.cross_entropy(h @ w.t() + b, lab,
                                            reduction="none")
    want = torch.autograd.grad((ref * cot).sum(), (h, w, b))
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-5,
                                   atol=1e-6)

    x = torch.from_numpy(_rand((t, v), 5, 2.0)).requires_grad_()
    soft_cot = torch.from_numpy(_rand((t, v), 6))
    loss, lse = tce.BlockwiseCE.apply(x, lab)
    soft = torch.exp(x - lse[:, None])
    got, = torch.autograd.grad((loss * cot).sum() + (soft * soft_cot).sum(),
                               (x,))
    ref = torch.nn.functional.cross_entropy(x, lab, reduction="none")
    want, = torch.autograd.grad(
        (ref * cot).sum() + (torch.softmax(x, -1) * soft_cot).sum(), (x,))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert counts == [tce.head_launches, tce.head_dh_launches,
                      tce.head_dw_launches, tce.ce_launches,
                      tce.ce_bwd_launches]


@pytest.mark.parametrize("t,v,d,tiles", [
    (8192, 32000, 768, True),        # GPT-base's head
    (640, 30522, 768, False),        # BERT-base's MLM head
    (256, 1024, 100, False),         # hidden width not a multiple of 8
])
def test_routing_follows_the_jax_tiling_rule(t, v, d, tiles):
    """The ops take the kernels exactly where the JAX package's compiled
    blockwise kernels would run."""
    from paddle_tpu.ops.pallas.costmodel import fit_blocks
    jax_tiles = fit_blocks(t, v, 128, 512, False) is not None and d % 8 == 0
    assert tnn.blockwise_kernel_would_tile(t, v, d) == jax_tiles == tiles


def test_kernel_wrappers_refuse_other_devices():
    meta = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tce.fused_head_loss(meta, torch.empty(16, 8, device="meta"),
                            torch.zeros(4, dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        tce.softmax_ce(meta, torch.zeros(4, dtype=torch.int64,
                                         device="meta"))
