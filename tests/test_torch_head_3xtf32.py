"""The numeric scheme of the fused-head backward kernels, emulated on the
CPU.

paddle_tpu_torch/ops/kernels/csrc/fused_head_bwd.cu computes both of its
products (the scores s = h W^T and dhidden = ds W / dweight = ds^T h) on
the tensor cores. f32 operands go through 3xTF32: each value x is split
into hi = tf32(x) and lo = tf32(x - hi) by integer rounding, and a product
is lo*hi + hi*lo + hi*hi summed in f32; ds is split the same way. The sums
are cut into short chains joined by ordinary f32 adds: a score is the sum
of eight partial scores, one per eighth of D; dhidden adds one partial per
16-row tile of the vocabulary, dweight one per 16-token tile. bf16
operands multiply exactly into f32 sums; ds enters the second product as
a bf16 pair, hi = bf16(ds) and lo = bf16(ds - hi), and dbias is summed
from the f32 ds. The kernels run only on the card; here a torch emulation of
that arithmetic is held against the JAX package's Pallas head backward
(interpret mode) and an f64 reference.

Tolerances are chip_smoke.py's (HEAD_TOL): f32 gradients within 5e-5 of
the largest magnitude, bf16 within 2^-7 of it. A parametrised case pins
why three passes are needed: one tf32 pass misses 5e-5, three meet it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import blockwise_ce as jce
from paddle_tpu_torch.ops.kernels import blockwise_ce as tce
from test_torch_flash_3xtf32 import mm_1xtf32, mm_3xtf32

F32_REL_TOL = 5e-5
BF16_REL_TOL = 2.0 ** -7
IGNORE = -100
WARPS = 8                # the kernels' eight slices of D
F32_TILE, BF16_TILE = 16, 32   # streamed rows a tile


def _chunks(n, size):
    return [slice(i, min(i + size, n)) for i in range(0, n, size)]


def _d_slices(d):
    """The eight warps' column slices: D padded to 8 x a multiple of 32
    columns (the kernels' NT in {4, 8, 12, 16} tiles of 8)."""
    width = 32 * -(-d // (32 * WARPS))
    return [c for c in _chunks(d, width)]


def head_bwd_emulated(h, w, lab, b, lse, dl, mm=mm_3xtf32):
    """(dhidden, dweight, dbias) by the kernels' arithmetic. f32 operands:
    every product through ``mm``; bf16 operands: exact products, ds as a
    bf16 hi/lo pair."""
    bf16 = h.dtype == torch.bfloat16
    if bf16:
        mm = torch.matmul
    hf, wf = h.float(), w.float()
    t, v = h.shape[0], w.shape[0]
    s = torch.zeros(t, v)
    for c in _d_slices(h.shape[1]):          # eight chains, f32 adds
        s = s + mm(hf[:, c], wf[:, c].t())
    if b is not None:
        s = s + b[None, :]
    hit = torch.arange(v)[None, :] == lab[:, None]
    ds = (torch.exp(s - lse[:, None]) - hit.float()) * dl[:, None]
    db = ds.sum(0)
    if bf16:
        hi = ds.bfloat16().float()
        ds = hi + (ds - hi).bfloat16().float()
    tile = BF16_TILE if bf16 else F32_TILE
    dh = torch.zeros_like(hf)
    for rows in _chunks(v, tile):            # one partial per vocab tile
        dh = dh + mm(ds[:, rows], wf[rows])
    dw = torch.zeros_like(wf)
    for rows in _chunks(t, tile):            # one partial per token tile
        dw = dw + mm(ds[rows].t(), hf[rows])
    return dh.to(h.dtype), dw.to(w.dtype), db


def _inputs(t, d, v, seed, with_bias):
    rng = np.random.RandomState(seed)
    h = rng.randn(t, d).astype(np.float32)
    w = (rng.randn(v, d) * 0.3).astype(np.float32)
    b = (rng.randn(v) * 0.5).astype(np.float32) if with_bias else None
    lab = rng.randint(0, v, (t,)).astype(np.int64)
    lab[0], lab[5] = IGNORE, v               # outside [0, V): hit nothing
    dl = rng.rand(t).astype(np.float32)
    return h, w, b, lab, dl


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _rel(got, want):
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def _f64_reference(h, w, b, lab, dl):
    """(dh, dw, db, lse) in f64 from the f32 (or bf16) operands."""
    hd, wd = _t(h).double(), _t(w).double()
    s = hd @ wd.t()
    if b is not None:
        s = s + _t(b).double()
    lse = torch.logsumexp(s, -1)
    hit = torch.arange(w.shape[0])[None, :] == _t(lab)[:, None]
    ds = (torch.exp(s - lse[:, None]) - hit.double()) * \
        _t(dl).double()[:, None]
    return ds @ wd, ds.t() @ hd, ds.sum(0), lse


@pytest.mark.parametrize("t,d,v,block", [(64, 32, 256, 16), (40, 72, 96, 8)])
@pytest.mark.parametrize("with_bias", [True, False])
def test_3xtf32_head_backward_matches_pallas_head_backward(with_bias, t, d, v,
                                                           block):
    h, w, b, lab, dl = _inputs(t, d, v, seed=t + v, with_bias=with_bias)
    jlab = jnp.asarray(lab, jnp.int32)

    def head(h_, w_, b_):
        return jce.fused_mlm_head_loss(h_, w_, jlab, bias=b_, block_t=block,
                                       block_v=block, interpret=True)
    if b is None:
        _, vjp = jax.vjp(lambda h_, w_: head(h_, w_, None), jnp.asarray(h),
                         jnp.asarray(w.T))
    else:
        _, vjp = jax.vjp(head, jnp.asarray(h), jnp.asarray(w.T),
                         jnp.asarray(b))
    want = vjp(jnp.asarray(dl))
    _, lse = tce.fused_head_loss(_t(h), _t(w), _t(lab), _t(b))
    dh, dw, db = head_bwd_emulated(_t(h), _t(w), _t(lab), _t(b), lse, _t(dl))
    assert dh.dtype == dw.dtype == db.dtype == torch.float32
    assert _rel(dh, _t(want[0])) <= F32_REL_TOL
    assert _rel(dw, _t(np.asarray(want[1]).T)) <= F32_REL_TOL
    if b is not None:
        assert _rel(db, _t(want[2])) <= F32_REL_TOL


@pytest.mark.parametrize("t,d,v,with_bias", [(256, 768, 1000, False),
                                             (130, 200, 515, True)])
def test_3xtf32_head_backward_matches_f64_reference(t, d, v, with_bias):
    h, w, b, lab, dl = _inputs(t, d, v, seed=7, with_bias=with_bias)
    want_dh, want_dw, want_db, lse = _f64_reference(h, w, b, lab, dl)
    dh, dw, db = head_bwd_emulated(_t(h), _t(w), _t(lab), _t(b), lse.float(),
                                   _t(dl))
    assert _rel(dh, want_dh) <= F32_REL_TOL
    assert _rel(dw, want_dw) <= F32_REL_TOL
    assert _rel(db, want_db) <= F32_REL_TOL


@pytest.mark.parametrize("scheme,low,high", [
    ("1xtf32", F32_REL_TOL, 1e-2),   # one pass: misses the tolerance
    ("3xtf32", 0.0, 5e-6),           # three passes: ~1e-6
])
def test_three_passes_are_needed(scheme, low, high):
    """Relative error (max |got - want| over max |want|) of dhidden and
    dweight against the f64 reference at D = 768."""
    mm = {"1xtf32": mm_1xtf32, "3xtf32": mm_3xtf32}[scheme]
    h, w, b, lab, dl = _inputs(256, 768, 1000, seed=11, with_bias=False)
    want_dh, want_dw, _, lse = _f64_reference(h, w, b, lab, dl)
    dh, dw, _ = head_bwd_emulated(_t(h), _t(w), _t(lab), None, lse.float(),
                                  _t(dl), mm)
    rel = max(_rel(dh, want_dh), _rel(dw, want_dw))
    assert low < rel or low == 0.0
    assert rel <= high, rel


@pytest.mark.parametrize("t,d,v,with_bias", [(256, 768, 1000, False),
                                             (130, 200, 515, True)])
def test_bf16_head_backward_with_ds_as_a_bf16_pair(t, d, v, with_bias):
    """bf16 operands, ds as a bf16 hi/lo pair in the second product:
    within one bf16 ulp of the largest gradient of the f64 reference on
    the same bf16 values, and dbias (from the f32 ds) to f32 accuracy."""
    h, w, b, lab, dl = _inputs(t, d, v, seed=13, with_bias=with_bias)
    hb, wb = _t(h).bfloat16(), _t(w).bfloat16()
    want_dh, want_dw, want_db, lse = _f64_reference(
        hb.float().numpy(), wb.float().numpy(), b, lab, dl)
    dh, dw, db = head_bwd_emulated(hb, wb, _t(lab), _t(b), lse.float(),
                                   _t(dl))
    assert dh.dtype == dw.dtype == torch.bfloat16
    assert _rel(dh, want_dh) <= BF16_REL_TOL
    assert _rel(dw, want_dw) <= BF16_REL_TOL
    assert _rel(db, want_db) <= F32_REL_TOL
    # and against the package's plain backward, which keeps ds in f32
    plain = tce.fused_head_bwd_plain(hb, wb, _t(lab), _t(b), lse.float(),
                                     _t(dl))
    assert _rel(dh, plain[0]) <= BF16_REL_TOL
    assert _rel(dw, plain[1]) <= BF16_REL_TOL


def test_emulation_with_exact_products_is_the_plain_backward():
    """head_bwd_emulated with exact f32 products differs from
    fused_head_bwd_plain only by the order of the f32 sums."""
    h, w, b, lab, dl = _inputs(48, 40, 130, seed=3, with_bias=True)
    _, lse = tce.fused_head_loss(_t(h), _t(w), _t(lab), _t(b))
    args = (_t(h), _t(w), _t(lab), _t(b), lse, _t(dl))
    want = tce.fused_head_bwd_plain(*args)
    got = head_bwd_emulated(*args, mm=torch.matmul)
    for g, x in zip(got, want):
        assert _rel(g, x) <= 2e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_bias", [True, False])
def test_backward_wrappers_share_operands_and_count_nothing_on_cpu(
        with_bias, dtype):
    """fused_head_bwd, the single-kernel wrappers and FusedHeadLoss give
    the plain backward's results on the CPU and launch nothing; the
    ``need_*`` switches drop the gradient that is not asked for."""
    h, w, b, lab, dl = _inputs(24, 16, 50, seed=5, with_bias=with_bias)
    th, tw = _t(h).to(dtype), _t(w).to(dtype)
    _, lse = tce.fused_head_loss(th, tw, _t(lab), _t(b))
    args = (th, tw, _t(lab), _t(b), lse, _t(dl))
    before = (tce.head_dh_launches, tce.head_dw_launches)
    want = tce.fused_head_bwd_plain(*args)
    got = tce.fused_head_bwd(*args)
    single = (tce.fused_head_dhidden(*args),) + tce.fused_head_dweight(*args)
    for g, s, x in zip(got, single, want):
        assert torch.equal(g, x) and torch.equal(s, x)
    only_dh = tce.fused_head_bwd(*args, need_dw=False)
    only_dw = tce.fused_head_bwd(*args, need_dh=False)
    assert torch.equal(only_dh[0], want[0]) and only_dh[1:] == (None, None)
    assert only_dw[0] is None and torch.equal(only_dw[1], want[1]) and \
        torch.equal(only_dw[2], want[2])

    lh, lw = th.clone().requires_grad_(), tw.clone().requires_grad_()
    lb = None if b is None else _t(b).requires_grad_()
    loss = tce.FusedHeadLoss.apply(lh, lw, lb, _t(lab))
    loss.backward(_t(dl))
    assert torch.equal(lh.grad, want[0]) and torch.equal(lw.grad, want[1])
    if lb is not None:
        assert torch.equal(lb.grad, want[2])
    only_h = th.clone().requires_grad_()
    tce.FusedHeadLoss.apply(only_h, tw, _t(b), _t(lab)).backward(_t(dl))
    assert torch.equal(only_h.grad, want[0])
    assert (tce.head_dh_launches, tce.head_dw_launches) == before


# ---------------------------------------------------------------------------
# the forward kernel (csrc/fused_head_fwd.cu)
# ---------------------------------------------------------------------------
#
# The scores s = h W^T are formed on wgmma: f32 by 3xTF32, a score being the
# sum of partial scores over 128-column chunks of D, each a fresh chain
# joined by an f32 add; bf16 products exactly into f32 sums, chunked the
# same way. Loss and lse are then the f32 logsumexp of the scores (the
# kernel's vocabulary splits are merged in a fixed order: a change of
# summation order only). chip_smoke.py holds loss and lse to 1e-4.

LOSS_TOL = 1e-4
FWD_CHUNK = 128


def head_fwd_emulated(h, w, lab, b, mm=mm_3xtf32):
    """(loss, lse) by the forward kernel's arithmetic."""
    if h.dtype == torch.bfloat16:
        mm = torch.matmul
    hf, wf = h.float(), w.float()
    s = torch.zeros(h.shape[0], w.shape[0])
    for c in _chunks(h.shape[1], FWD_CHUNK):
        s = s + mm(hf[:, c], wf[:, c].t())
    if b is not None:
        s = s + b[None, :]
    return tce._loss_from_logits(s, lab)


def _f64_loss(h, w, b, lab):
    """(loss, lse) in f64 from the f32 (or bf16) operands."""
    s = _t(h).double() @ _t(w).double().t()
    if b is not None:
        s = s + _t(b).double()
    lse = torch.logsumexp(s, -1)
    lab = _t(lab)
    ok = (lab >= 0) & (lab < s.shape[1])
    picked = s.gather(1, lab.clamp(0, s.shape[1] - 1)[:, None])[:, 0]
    return lse - torch.where(ok, picked, torch.zeros_like(picked)), lse


@pytest.mark.parametrize("t,d,v,block", [(64, 32, 256, 16),
                                         (48, 200, 96, 16)])
@pytest.mark.parametrize("with_bias", [True, False])
def test_3xtf32_head_forward_matches_pallas_head_forward(with_bias, t, d, v,
                                                         block):
    h, w, b, lab, _ = _inputs(t, d, v, seed=t * 3 + v, with_bias=with_bias)
    jb = jnp.zeros((v,), jnp.float32) if b is None else jnp.asarray(b)
    want_loss, want_lse = jce._head_call_fwd(
        jnp.asarray(h), jnp.asarray(w.T), jb, jnp.asarray(lab, jnp.int32),
        block, block, True)
    loss, lse = head_fwd_emulated(_t(h), _t(w), _t(lab), _t(b))
    assert loss.dtype == lse.dtype == torch.float32
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss), rtol=0,
                               atol=LOSS_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=0,
                               atol=LOSS_TOL)


@pytest.mark.parametrize("t,d,v,with_bias", [(256, 768, 1000, False),
                                             (130, 200, 515, True),
                                             (97, 99, 300, True),
                                             (40, 1000, 257, False)])
def test_3xtf32_head_forward_matches_f64_reference(t, d, v, with_bias):
    """Ragged D (99, 200, 1000: the kernel pads D with zeros) and labels
    outside [0, V) (rows 0 and 5: -100 and V) included."""
    h, w, b, lab, _ = _inputs(t, d, v, seed=19, with_bias=with_bias)
    want_loss, want_lse = _f64_loss(h, w, b, lab)
    loss, lse = head_fwd_emulated(_t(h), _t(w), _t(lab), _t(b))
    assert float((loss.double() - want_loss).abs().max()) <= LOSS_TOL
    assert float((lse.double() - want_lse).abs().max()) <= LOSS_TOL
    assert torch.equal(loss[[0, 5]], lse[[0, 5]])   # no label logit


@pytest.mark.parametrize("scheme,low,high", [
    ("1xtf32", LOSS_TOL, 1e-1),      # one pass: misses the tolerance
    ("3xtf32", 0.0, 2e-5),           # three passes
])
def test_three_passes_are_needed_forward(scheme, low, high):
    """Largest |loss - f64 loss| at D = 768, scores of order 10."""
    mm = {"1xtf32": mm_1xtf32, "3xtf32": mm_3xtf32}[scheme]
    h, w, b, lab, _ = _inputs(256, 768, 1000, seed=31, with_bias=False)
    want_loss, _ = _f64_loss(h, w, b, lab)
    loss, _ = head_fwd_emulated(_t(h), _t(w), _t(lab), None, mm)
    err = float((loss.double() - want_loss).abs().max())
    assert low < err or low == 0.0, err
    assert err <= high, err


@pytest.mark.parametrize("t,d,v,with_bias", [(256, 768, 1000, False),
                                             (97, 99, 300, True)])
def test_bf16_head_forward(t, d, v, with_bias):
    """bf16 operands multiply exactly into f32 sums: loss and lse within
    LOSS_TOL of the f64 reference on the same bf16 values and of the
    package's plain forward."""
    h, w, b, lab, _ = _inputs(t, d, v, seed=37, with_bias=with_bias)
    hb, wb = _t(h).bfloat16(), _t(w).bfloat16()
    want_loss, want_lse = _f64_loss(hb.float().numpy(), wb.float().numpy(),
                                    b, lab)
    loss, lse = head_fwd_emulated(hb, wb, _t(lab), _t(b))
    assert float((loss.double() - want_loss).abs().max()) <= LOSS_TOL
    assert float((lse.double() - want_lse).abs().max()) <= LOSS_TOL
    plain = tce.fused_head_loss_plain(hb, wb, _t(lab), _t(b))
    assert float((loss - plain[0]).abs().max()) <= LOSS_TOL
