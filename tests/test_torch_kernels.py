"""The port's kernel modules against the JAX package's Pallas kernels.

paddle_tpu_torch/ops/kernels/{flash_attention,layer_norm}.py each hold a
CUDA kernel's wrapper and its plain PyTorch version. The CUDA kernels run
only on the card (chip_smoke.py holds them against the plain versions
there); here the plain versions are held against the Pallas kernels they
replace, run in interpret mode on the CPU, on the same numpy inputs.

Tolerances: f32 on both sides (the Pallas kernels use HIGHEST-precision
dots for f32), so only the summation order differs — the flash-attention
tests use the bounds of tests/test_flash_attention.py (rtol 2e-4,
atol 2e-5); LayerNorm outputs of order 1 agree to 1e-5. bf16 outputs
may differ by one bf16 rounding (2^-8 relative), so 1e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas import layer_norm as jln
from paddle_tpu_torch.ops.kernels import flash_attention as tfa
from paddle_tpu_torch.ops.kernels import layer_norm as tln


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


@pytest.mark.parametrize("tq,tk", [(32, 32), (32, 48), (48, 32)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mode", [None, "k", "qk"])
def test_plain_flash_matches_pallas_forward(mode, causal, tq, tk):
    b, h, d = 2, 2, 16
    q, k, v = _rand((b, h, tq, d), 0), _rand((b, h, tk, d), 1), \
        _rand((b, h, tk, d), 2)
    mask = _mask(mode, b, tq, tk, 3)
    scale = d ** -0.5
    got, got_lse = tfa.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if mask is None else torch.from_numpy(mask), scale, causal)
    jmask = None if mask is None else jnp.asarray(mask)
    if causal and tq > tk:
        # rows i < tq - tk see no key: the JAX entry defines them through
        # its XLA reference (uniform over the keys) and has no lse there
        want = jfa.flash_attention(q, k, v, mask=mask, scale=scale,
                                   causal=True, interpret=True)
        want_lse = None
    else:
        want, want_lse = jfa._pallas_forward(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmask, scale,
            causal, 16, 16, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-5)
    if want_lse is not None:
        np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                                   rtol=2e-4, atol=2e-5)


def test_plain_flash_bf16_matches_pallas_forward():
    b, h, t, d = 2, 2, 32, 16
    q, k, v = (_rand((b, h, t, d), s).astype(jnp.bfloat16) for s in (4, 5, 6))
    mask = _mask("k", b, t, t, 7)
    got, _ = tfa.flash_attention_plain(
        *(torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
          for a in (q, k, v)), torch.from_numpy(mask), d ** -0.5, False)
    want, _ = jfa._pallas_forward(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(mask),
                                  d ** -0.5, False, 16, 16, True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("rows,cols,block_rows", [(37, 64, 16), (8, 300, 8)])
def test_plain_layer_norm_matches_pallas_forward(rows, cols, block_rows):
    x = _rand((rows, cols), 0, scale=3.0) + 1.0
    scale = _rand((cols,), 1) + 1.0
    bias = _rand((cols,), 2)
    got = tln.layer_norm_plain(torch.from_numpy(x), torch.from_numpy(scale),
                               torch.from_numpy(bias), 1e-5)
    want = jln._ln_call_fwd(jnp.asarray(x), jnp.asarray(scale),
                            jnp.asarray(bias), 1e-5, block_rows, True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_plain_layer_norm_without_scale_and_bias():
    """Scale and bias are optional in the port (null pointers in the
    kernel); the Pallas kernel always takes them, as ones and zeros."""
    rows, cols = 16, 48
    x = _rand((rows, cols), 3)
    y, mean, rstd = tln.layer_norm_plain(torch.from_numpy(x), None, None,
                                         1e-5)
    want = jln._ln_call_fwd(jnp.asarray(x), jnp.ones(cols), jnp.zeros(cols),
                            1e-5, 8, True)
    for g, w in zip((y, mean, rstd), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_plain_layer_norm_bf16_matches_pallas_forward():
    x = _rand((16, 64), 4).astype(jnp.bfloat16)
    scale, bias = _rand((64,), 5) + 1.0, _rand((64,), 6)
    got = tln.layer_norm_plain(
        torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16),
        torch.from_numpy(scale), torch.from_numpy(bias), 1e-5)
    want = jln._ln_call_fwd(jnp.asarray(x), jnp.asarray(scale),
                            jnp.asarray(bias), 1e-5, 8, True)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.asarray(want[0]).astype(np.float32),
                               rtol=1e-2, atol=1e-2)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_wrappers_take_the_plain_path_on_cpu_tensors():
    """On a CPU tensor a wrapper returns its plain version's answer and
    launches nothing: the CUDA launch counters stay at 0."""
    tfa.launches = tln.launches = 0
    q, k, v = (torch.from_numpy(_rand((1, 2, 8, 16), s)) for s in (0, 1, 2))
    mask = torch.from_numpy(_mask("k", 1, 8, 8, 3))
    out, lse = tfa.flash_attention(q, k, v, mask, 0.25, True)
    want, want_lse = tfa.flash_attention_plain(q, k, v, mask, 0.25, True)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    x = torch.from_numpy(_rand((4, 32), 4))
    for g, w in zip(tln.layer_norm(x, None, None, 1e-5),
                    tln.layer_norm_plain(x, None, None, 1e-5)):
        assert torch.equal(g, w)
    assert tfa.launches == 0 and tln.launches == 0


def test_wrappers_raise_on_other_devices():
    """Neither wrapper falls back to its plain version off the CPU: a
    tensor on any device other than the CPU or a CUDA card is refused."""
    q = torch.empty(1, 2, 8, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        tln.layer_norm(torch.empty(4, 64, device="meta"))


@pytest.mark.parametrize("shape", [(3, 1, 1, 10), (1, 1, 7, 10),
                                   (3, 1, 7, 10), (1, 1, 1, 10)])
def test_mask_operand_indexes_like_the_broadcast(shape):
    """The kernel reads mask[b*stride_b + i*stride_q + j]: with the
    strides the wrapper hands it, that is the mask broadcast to
    (B, 1, Tq, Tk), as the Pallas kernel's _mask_spec reads it."""
    b, tq, tk = 3, 7, 10
    mask = torch.from_numpy(_rand(shape, 0))
    flat, sb, sq = tfa._mask_operand(mask, b, tq, tk)
    full = mask.expand(b, 1, tq, tk)
    flat = flat.reshape(-1)
    for bi in range(b):
        for i in range(tq):
            assert torch.equal(flat[bi * sb + i * sq: bi * sb + i * sq + tk],
                               full[bi, 0, i])


@pytest.mark.parametrize("shape", [(3, 2, 1, 10), (3, 1, 1, 9),
                                   (2, 1, 1, 10), (3, 1, 10)])
def test_mask_operand_refuses_other_shapes(shape):
    with pytest.raises(ValueError, match="mask"):
        tfa._mask_operand(torch.zeros(shape), 3, 7, 10)
