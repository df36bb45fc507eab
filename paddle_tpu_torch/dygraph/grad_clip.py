"""Dygraph gradient clipping strategies.

Counterpart of paddle_tpu/dygraph/grad_clip.py (reference:
python/paddle/fluid/dygraph_grad_clip.py, GradClipByValue:46,
GradClipByNorm:120, GradClipByGlobalNorm:191). Each strategy is a
callable over [(param, grad), ...] pairs returning the clipped pairs;
optimizers apply it via ``minimize(..., grad_clip=clip)``. The math is
plain torch on the gradients' device (a numpy gradient is taken as a CPU
tensor); no value is read back to the host.
"""
import torch

__all__ = ["GradClipBase", "GradClipByValue", "GradClipByNorm",
           "GradClipByGlobalNorm"]


def _t(g):
    return g if isinstance(g, torch.Tensor) else torch.as_tensor(g)


def _scaled(norm, limit):
    """limit / norm where norm exceeds limit, else 1."""
    return torch.where(norm > limit, limit / torch.clamp(norm, min=1e-12),
                       torch.ones_like(norm))


class GradClipBase(object):
    def _clip(self, para_and_grad):
        raise NotImplementedError

    def __call__(self, para_and_grad):
        return self._clip(para_and_grad)


class GradClipByValue(GradClipBase):
    """Clamp every gradient element to [min_value, max_value]."""

    def __init__(self, min_value, max_value=None):
        if max_value is None:
            min_value, max_value = -abs(min_value), abs(min_value)
        self.min_value = float(min_value)
        self.max_value = float(max_value)

    def __str__(self):
        return "ClipByValue, min=%f, max=%f" % (self.min_value,
                                                self.max_value)

    def _clip(self, para_and_grad):
        return [(p, g if g is None else
                 torch.clamp(_t(g), self.min_value, self.max_value))
                for p, g in para_and_grad]


class GradClipByNorm(GradClipBase):
    """Rescale each gradient whose own L2 norm exceeds clip_norm."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __str__(self):
        return "ClipByNorm, clip_norm=%f" % self.clip_norm

    def _clip(self, para_and_grad):
        out = []
        for p, g in para_and_grad:
            if g is None:
                out.append((p, g))
                continue
            g = _t(g)
            norm = torch.sqrt(torch.sum(torch.square(g)))
            out.append((p, g * _scaled(norm, self.clip_norm).to(g.dtype)))
        return out


class GradClipByGlobalNorm(GradClipBase):
    """Rescale ALL gradients jointly so their global L2 norm is at most
    max_global_norm."""

    def __init__(self, max_global_norm, dtype="float32"):
        self.max_global_norm = float(max_global_norm)
        self.dtype = dtype

    def __str__(self):
        return "ClipByGlobalNorm, max_global_norm=%f" % self.max_global_norm

    def _clip(self, para_and_grad):
        from ..framework.dtypes import to_torch_dtype
        grads = [_t(g) for _, g in para_and_grad if g is not None]
        if not grads:
            return list(para_and_grad)
        dt = to_torch_dtype(self.dtype)
        global_sq = sum(torch.sum(torch.square(g.to(dt))) for g in grads)
        scale = _scaled(torch.sqrt(global_sq), self.max_global_norm)
        return [(p, g if g is None else _t(g) * scale.to(_t(g).dtype))
                for p, g in para_and_grad]
