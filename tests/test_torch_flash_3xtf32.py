"""The numeric scheme of the flash-attention backward kernels, emulated on
the CPU.

paddle_tpu_torch/ops/kernels/csrc/flash_attention_bwd.cu computes its f32
products on the tensor cores by 3xTF32: each operand x is split into
hi = tf32(x) and lo = tf32(x - hi), rounded to nearest with ties away
from zero on the low 13 mantissa bits, and a product is lo*hi + hi*lo +
hi*hi, each term summed in f32. The kernel runs only on the card; here a
torch emulation of that arithmetic runs the backward recipe of
``flash_attention_bwd_plain`` (p = exp(s - lse), ds = p * (dO v^T -
delta), rows that see no key p = 1/Tk, ds = 0) with every product in
emulated 3xTF32, and is held against the JAX package's Pallas backward
(interpret mode, small shapes) and an f64 reference.

Tolerance: 1e-4 absolute, the f32 tolerance chip_smoke.py holds the
kernels to (BWD_TOL). A parametrised case pins why three passes are
needed: one tf32 pass misses the f64 reference by ~1e-3 relative, three
stay within ~1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.ops.kernels import flash_attention as tfa

BWD_TOL = 1e-4


def tf32(x):
    """f32 x rounded to tf32 (10 mantissa bits), to nearest, ties away
    from zero: add half of the dropped 13 bits' range, clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm_3xtf32(a, b):
    """a @ b in f32 from three tf32 products (tf32 x tf32 is exact in f32),
    the small cross terms first."""
    (ah, al), (bh, bl) = split(a.float()), split(b.float())
    return (al @ bh + ah @ bl) + ah @ bh


def mm_1xtf32(a, b):
    return tf32(a.float()) @ tf32(b.float())


def bwd_recipe(q, k, v, mask, lse, delta, dout, scale, causal, mm):
    """flash_attention_bwd_plain's recipe, every product through ``mm``,
    in the inputs' dtype."""
    tq, tk = q.shape[-2], k.shape[-2]
    s = mm(q, k.transpose(-1, -2)) * scale
    if mask is not None:
        s = s + mask.to(s.dtype)
    if causal:
        keep = torch.ones(tq, tk, dtype=torch.bool).tril(tk - tq)
        s = s.masked_fill(~keep, tfa.NEG_INF)
    p = torch.exp(s - lse[..., None].to(s.dtype))
    ds = p * (mm(dout, v.transpose(-1, -2)) - delta[..., None].to(s.dtype))
    if causal and tq > tk:
        no_key = torch.arange(tq) + (tk - tq) < 0
        p = p.masked_fill(no_key[:, None], 1.0 / tk)
        ds = ds.masked_fill(no_key[:, None], 0.0)
    dv = mm(p.transpose(-1, -2), dout)
    dk = mm(ds.transpose(-1, -2), q) * scale
    dq = mm(ds, k) * scale
    return dq, dk, dv


def _inputs(b, h, tq, tk, d, mode, seed):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(b, h, t, d).astype(np.float32)
                   for t in (tq, tk, tk, tq))
    mask = None
    if mode == "k":      # BERT's key-padding bias: 0 / -1e4
        mask = np.zeros((b, 1, 1, tk), np.float32)
        for i in range(b):
            mask[i, :, :, tk - 5 * (i + 1):] = -1e4
    elif mode == "qk":
        mask = rng.randn(b, 1, tq, tk).astype(np.float32)
    return q, k, v, do, mask


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _f64_reference(q, k, v, do, mask, scale, causal):
    """(dq, dk, dv, lse, delta) in f64: the forward's lse and delta, then
    the recipe with exact products."""
    q, k, v, do = (_t(a).double() for a in (q, k, v, do))
    m = None if mask is None else _t(mask).double()
    tq, tk = q.shape[-2], k.shape[-2]
    s = q @ k.transpose(-1, -2) * scale
    if m is not None:
        s = s + m
    if causal:
        keep = torch.ones(tq, tk, dtype=torch.bool).tril(tk - tq)
        s = s.masked_fill(~keep, tfa.NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    out = torch.softmax(s, dim=-1) @ v
    delta = (do * out).sum(-1)
    grads = bwd_recipe(q, k, v, m, lse, delta, do, scale, causal,
                       torch.matmul)
    return grads, lse, delta


CASES = [  # (mask, causal, Tq, Tk)
    ("k", False, 64, 64),
    ("qk", False, 32, 48),
    (None, True, 64, 64),
    (None, True, 48, 32),        # causal Tq > Tk: rows that see no key
]


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    half_ulp = 2.0 ** -11       # tf32 keeps 10 mantissa bits
    x = torch.tensor([one + half_ulp, -(one + half_ulp),
                      one + half_ulp - 2.0 ** -23, one + 3 * half_ulp,
                      2.0 - half_ulp, 0.0], dtype=torch.float32)
    want = torch.tensor([one + 2 * half_ulp, -(one + 2 * half_ulp), one,
                         one + 4 * half_ulp, 2.0, 0.0], dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    # hi + lo reproduces x to ~2^-22 of it, hi alone only to 2^-11
    y = torch.from_numpy(np.random.RandomState(0).randn(10000).astype(
        np.float32))
    hi, lo = split(y)
    assert float(((hi + lo - y).abs() / y.abs()).max()) <= 2.0 ** -21
    assert float(((hi - y).abs() / y.abs()).max()) > 2.0 ** -13


@pytest.mark.parametrize("mode,causal,tq,tk", CASES)
def test_3xtf32_backward_matches_pallas_backward(mode, causal, tq, tk):
    b, h, d, block = 2, 2, 16, 16
    q, k, v, do, mask = _inputs(b, h, tq, tk, d, mode, seed=tq + tk)
    scale = d ** -0.5
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    jmask = None if mask is None else jnp.asarray(mask)
    if causal and tq > tk:
        # rows that see no key: the JAX entry differentiates its XLA
        # reference there (dq = 0, no dk, dv += dO / Tk); lse and delta from
        # the port's plain forward
        fn = lambda q_, k_, v_: jfa.flash_attention(  # noqa: E731
            q_, k_, v_, mask=jmask, scale=scale, causal=True,
            interpret=True)
        want = jax.vjp(fn, jq, jk, jv)[1](jnp.asarray(do))
        out, lse = tfa.flash_attention_plain(_t(q), _t(k), _t(v), _t(mask),
                                             scale, causal)
        delta = (_t(do) * out).sum(-1)
    else:
        out, lse = jfa._pallas_forward(jq, jk, jv, jmask, scale, causal,
                                       block, block, True)
        want = jfa._pallas_backward(jq, jk, jv, jmask, out, lse,
                                    jnp.asarray(do), scale, causal, block,
                                    block, True)
        delta = _t(jnp.sum(jnp.asarray(do) * out, axis=-1))
        lse = _t(lse)
    got = bwd_recipe(_t(q), _t(k), _t(v), _t(mask), lse, delta, _t(do),
                     scale, causal, mm_3xtf32)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=BWD_TOL)


@pytest.mark.parametrize("mode,causal,tq,tk", [
    ("k", False, 256, 256), ("qk", False, 256, 256), (None, True, 256, 256),
    (None, True, 256, 192)])
def test_3xtf32_backward_matches_f64_reference(mode, causal, tq, tk):
    b, h, d = 1, 2, 64
    q, k, v, do, mask = _inputs(b, h, tq, tk, d, mode, seed=7)
    scale = d ** -0.5
    want, lse, delta = _f64_reference(q, k, v, do, mask, scale, causal)
    got = bwd_recipe(_t(q), _t(k), _t(v), _t(mask), lse.float(),
                     delta.float(), _t(do), scale, causal, mm_3xtf32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.double().numpy(), w.numpy(), rtol=0,
                                   atol=BWD_TOL)


@pytest.mark.parametrize("scheme,low,high", [
    ("1xtf32", 2e-4, 1e-2),      # one pass: ~1e-3 of the largest value
    ("3xtf32", 0.0, 1e-5),       # three passes: ~1e-6
])
def test_three_passes_are_needed(scheme, low, high):
    """Relative error (max |got - want| over max |want|) of dq, dk and dv
    against the f64 reference at T = 256, causal."""
    mm = {"1xtf32": mm_1xtf32, "3xtf32": mm_3xtf32}[scheme]
    q, k, v, do, mask = _inputs(2, 2, 256, 256, 64, None, seed=11)
    scale = 64 ** -0.5
    want, lse, delta = _f64_reference(q, k, v, do, mask, scale, True)
    got = bwd_recipe(_t(q), _t(k), _t(v), None, lse.float(), delta.float(),
                     _t(do), scale, True, mm)
    rel = max(float((g.double() - w).abs().max() / w.abs().max())
              for g, w in zip(got, want))
    assert low <= rel <= high, rel


def test_recipe_is_the_plain_backward():
    """bwd_recipe with exact f32 products is flash_attention_bwd_plain, so
    the emulation above runs the package's recipe."""
    q, k, v, do, mask = _inputs(2, 2, 40, 24, 16, "k", seed=3)
    args = (_t(q), _t(k), _t(v), _t(mask))
    out, lse = tfa.flash_attention_plain(*args, 0.25, True)
    delta = (_t(do) * out).sum(-1)
    want = tfa.flash_attention_bwd_plain(*args, lse, delta, _t(do), 0.25,
                                         True)
    got = bwd_recipe(*args, lse, delta, _t(do), 0.25, True, torch.matmul)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the forward kernel (csrc/flash_attention_fwd.cu)
# ---------------------------------------------------------------------------
#
# S = q k^T and each key tile's P v run by 3xTF32 for f32 (P split like any
# operand), exactly for bf16 with P as a bf16 pair (hi = bf16(p), lo =
# bf16(p - hi)); the online softmax is f32; a tile's P v starts from zero
# and joins the running output as o * corr + tile. Key tiles are 64 keys,
# 32 for f32 at D = 128.

FWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}   # chip_smoke.py's TOL
LSE_TOL = 1e-4


def _tile_keys(dtype, d):
    return 32 if dtype == torch.float32 and d == 128 else 64


def _bf16(x):
    return x.bfloat16().float()


def fwd_emulated(q, k, v, mask, scale, causal, mm=mm_3xtf32, p_pair=True):
    """(out like q, lse) by the forward kernel's arithmetic; bf16 inputs
    take P as a bf16 pair, or as one bf16 (``p_pair=False``, the
    reference's DEFAULT precision)."""
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        mm = torch.matmul
    qf, kf, vf = q.float(), k.float(), v.float()
    tq, tk = q.shape[-2], k.shape[-2]
    bn = _tile_keys(q.dtype, q.shape[-1])
    keep = torch.ones(tq, tk, dtype=torch.bool).tril(tk - tq)
    m = torch.full(q.shape[:-1], tfa.NEG_INF)
    l = torch.zeros(q.shape[:-1])
    o = torch.zeros(qf.shape)
    for k0 in range(0, tk, bn):
        cols = slice(k0, min(k0 + bn, tk))
        s = mm(qf, kf[..., cols, :].transpose(-1, -2)) * scale
        if mask is not None:
            s = s + mask.float()[..., cols]
        if causal:
            s = s.masked_fill(~keep[:, cols], tfa.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        m = m_new
        if bf16:     # the pair's sum is exact in f32
            p = _bf16(p) + (_bf16(p - _bf16(p)) if p_pair else 0.0)
        o = o * corr[..., None] + mm(p, vf[..., cols, :])
    l = l.clamp_min(1e-30)
    return (o / l[..., None]).to(q.dtype), m + torch.log(l)


def _f64_forward(q, k, v, mask, scale, causal):
    q, k, v = (_t(a).double() for a in (q, k, v))
    tq, tk = q.shape[-2], k.shape[-2]
    s = q @ k.transpose(-1, -2) * scale
    if mask is not None:
        s = s + _t(mask).double()
    if causal:
        keep = torch.ones(tq, tk, dtype=torch.bool).tril(tk - tq)
        s = s.masked_fill(~keep, tfa.NEG_INF)
    return torch.softmax(s, -1) @ v, torch.logsumexp(s, -1)


@pytest.mark.parametrize("mode,causal,tq,tk", CASES)
def test_3xtf32_forward_matches_pallas_forward(mode, causal, tq, tk):
    b, h, d, block = 2, 2, 64, 16
    q, k, v, _, mask = _inputs(b, h, tq, tk, d, mode, seed=tq * 3 + tk)
    scale = d ** -0.5
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    jmask = None if mask is None else jnp.asarray(mask)
    if causal and tq > tk:
        # rows that see no key: the JAX entry takes its XLA reference there
        want, want_lse = jfa.flash_attention(
            jq, jk, jv, mask=jmask, scale=scale, causal=True,
            interpret=True), None
    else:
        want, want_lse = jfa._pallas_forward(jq, jk, jv, jmask, scale,
                                             causal, block, block, True)
    got, lse = fwd_emulated(_t(q), _t(k), _t(v), _t(mask), scale, causal)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FWD_TOL[torch.float32])
    if want_lse is not None:
        np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                                   rtol=0, atol=LSE_TOL)


def _assert_lse(lse, want_lse):
    """lse within LSE_TOL of the f64 lse; a row that sees no key has lse
    -1e30 + log(Tk), which is -1e30 in f32."""
    sees = want_lse > tfa.NEG_INF / 2
    np.testing.assert_allclose(lse[sees].double().numpy(),
                               want_lse[sees].numpy(), rtol=0, atol=LSE_TOL)
    assert bool((lse[~sees] == np.float32(tfa.NEG_INF)).all())


@pytest.mark.parametrize("mode,causal,tq,tk,d", [
    ("k", False, 256, 256, 64), ("qk", False, 200, 333, 64),
    (None, True, 256, 256, 64), (None, True, 300, 200, 64),
    ("k", False, 200, 333, 128), (None, True, 256, 256, 128)])
def test_3xtf32_forward_matches_f64_reference(mode, causal, tq, tk, d):
    q, k, v, _, mask = _inputs(1, 2, tq, tk, d, mode, seed=5)
    scale = d ** -0.5
    want, want_lse = _f64_forward(q, k, v, mask, scale, causal)
    got, lse = fwd_emulated(_t(q), _t(k), _t(v), _t(mask), scale, causal)
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=0,
                               atol=FWD_TOL[torch.float32])
    _assert_lse(lse, want_lse)


@pytest.mark.parametrize("scheme,low,high", [
    ("1xtf32", FWD_TOL[torch.float32], 1e-2),   # one pass misses TOL
    ("3xtf32", 0.0, 2e-6),                      # three passes: ~1e-7
])
def test_three_passes_are_needed_forward(scheme, low, high):
    """Largest |out - f64 out| of the forward at T = 256, causal, D = 64,
    by one tf32 pass or three."""
    mm = {"1xtf32": mm_1xtf32, "3xtf32": mm_3xtf32}[scheme]
    q, k, v, _, _ = _inputs(2, 2, 256, 256, 64, None, seed=17)
    scale = 64 ** -0.5
    want, _ = _f64_forward(q, k, v, None, scale, True)
    got, _ = fwd_emulated(_t(q), _t(k), _t(v), None, scale, True, mm)
    err = float((got.double() - want).abs().max())
    assert low < err or low == 0.0, err
    assert err <= high, err


@pytest.mark.parametrize("mode,causal,tq,tk,d", [
    ("k", False, 128, 128, 64), (None, True, 200, 150, 128)])
def test_bf16_forward_with_p_as_a_bf16_pair(mode, causal, tq, tk, d):
    """bf16 inputs: exact products, P as a bf16 pair for P v: within the
    chip's bf16 tolerance of the f64 reference on the same bf16 values and
    of the package's plain forward, lse to f32 accuracy."""
    q, k, v, _, mask = _inputs(2, 2, tq, tk, d, mode, seed=23)
    qb, kb, vb = (_t(a).bfloat16() for a in (q, k, v))
    scale = d ** -0.5
    want, want_lse = _f64_forward(qb.float().numpy(), kb.float().numpy(),
                                  vb.float().numpy(), mask, scale, causal)
    got, lse = fwd_emulated(qb, kb, vb, _t(mask), scale, causal)
    assert got.dtype == torch.bfloat16
    tol = FWD_TOL[torch.bfloat16]
    assert float((got.double() - want).abs().max()) <= tol
    _assert_lse(lse, want_lse)
    plain, _ = tfa.flash_attention_plain(qb, kb, vb, _t(mask), scale, causal)
    assert float((got.float() - plain.float()).abs().max()) <= tol


@pytest.mark.parametrize("p_pair,low,high", [
    (False, FWD_TOL[torch.bfloat16], 0.1),   # one bf16 P: a 2^-6 ulp off
    (True, 0.0, FWD_TOL[torch.bfloat16]),     # the pair: within it
])
def test_bf16_p_needs_a_pair_on_causal_rows_with_few_keys(p_pair, low, high):
    """Causal rows that see a few keys average a few values: |out| reaches
    2-4, where one bf16 ulp is 2^-6, above the 1e-2 tolerance. P rounded to
    one bf16 (~2^-9 of each weight) moves such outputs across a bf16
    rounding boundary against the plain version's f32 P; the pair
    (~2^-17) does not, on these inputs."""
    q, k, v, _, _ = _inputs(2, 12, 256, 256, 64, None, seed=1)
    qb, kb, vb = (_t(a).bfloat16() for a in (q, k, v))
    got, _ = fwd_emulated(qb, kb, vb, None, 0.125, True, p_pair=p_pair)
    want, _ = tfa.flash_attention_plain(qb, kb, vb, None, 0.125, True)
    err = float((got.float() - want.float()).abs().max())
    assert low < err or low == 0.0, err
    assert err <= high, err


def test_forward_emulation_with_exact_products_is_the_plain_forward():
    """fwd_emulated with exact f32 products differs from
    flash_attention_plain only by the order of its f32 sums."""
    q, k, v, _, mask = _inputs(2, 2, 70, 130, 64, "qk", seed=29)
    args = (_t(q), _t(k), _t(v), _t(mask), 0.125, True)
    got, lse = fwd_emulated(*args, mm=torch.matmul)
    want, want_lse = tfa.flash_attention_plain(*args)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-6)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=2e-6)
