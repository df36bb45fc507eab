"""Vision op kernels the dygraph layers run: conv3d_transpose and
row_conv (counterparts in paddle_tpu/ops/vision_ops.py; the rest of that
module, the 3-D pools, sampling grids, deformable conv and the ROI ops,
waits for the op library).

Neither has a Pallas kernel in the JAX package (``lax`` convolutions and
jnp), so they lower to torch calls, as conv2d does (cuDNN on the card).
"""
import torch.nn.functional as F

from .nn_ops import conv_transpose
from .registry import register_op


@register_op("conv3d_transpose")
def _conv3d_transpose(ctx, ins, attrs):
    """The input gradient of the forward conv3d (paddle_tpu's :29 builds
    it as that vjp): nn_ops.conv_transpose in three dimensions."""
    return conv_transpose(ins, attrs, 3)


@register_op("row_conv")
def _row_conv(ctx, ins, attrs):
    """Lookahead convolution on a dense (B, T, D) batch (paddle_tpu's
    :227, ref row_conv_op.cc): out[b, t, d] = sum_{i=0..k} x[b, t+i, d] *
    w[i, d], zeros past the end."""
    x, w = ins["X"][0], ins["Filter"][0]
    ctx_len = w.shape[0]
    t = x.shape[1]
    pad = F.pad(x, (0, 0, 0, ctx_len - 1))
    out = x.new_zeros(x.shape)
    for i in range(ctx_len):               # static, small
        out = out + pad[:, i:i + t, :] * w[i][None, None, :]
    return {"Out": out}
