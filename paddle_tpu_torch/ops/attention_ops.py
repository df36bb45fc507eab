"""The fused attention op (counterpart of
paddle_tpu/ops/attention_ops.py::_sdpa).

impl "auto" and "flash" run the flash-attention kernels' autograd
Function at every length: on a CUDA tensor that is the hand-written
forward kernel, and the two hand-written backward kernels when a
gradient is taken; on a CPU tensor their plain versions. The JAX
package's rule that sends short sequences to XLA was set on a TPU and
does not carry over. "xla" runs the plain forward (and autograd through
it); "ring"/"ulysses" belong to the multi-GPU slice.
"""
from .kernels import flash_attention as _fa
from .registry import NotPortedError, register_op


@register_op("scaled_dot_product_attention")
def _sdpa(ctx, ins, attrs):
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    mask = ins["Mask"][0] if ins.get("Mask") else None
    scale = attrs.get("scale", None)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    causal = attrs.get("causal", False)
    impl = attrs.get("impl", "auto")
    if impl in ("auto", "flash"):
        out = _fa.FlashAttention.apply(q, k, v, mask, scale, causal)
    elif impl == "xla":
        out, _ = _fa.flash_attention_plain(q, k, v, mask, scale, causal)
    elif impl in ("ring", "ulysses"):
        raise NotPortedError(
            "fused_attention(impl=%r) is sequence-parallel attention over "
            "several cards; it arrives with the multi-GPU slice of "
            "paddle_tpu_torch" % (impl,))
    else:
        raise ValueError("unknown attention impl %r" % (impl,))
    return {"Out": out}
