"""Legacy v1 image helpers (counterpart of paddle_tpu/utils/image_util.py;
ref python/paddle/utils/image_util.py).

Pure numpy/PIL re-implementations of the v1-era preprocessing calls —
the modern equivalents live in paddle_tpu_torch.dataset.image; these exist so
old scripts keep running.  Images are HWC uint8/float arrays.
"""
import numpy as np

from ..dataset import image as _img

__all__ = ["resize_image", "flip", "crop_img", "preprocess_img",
           "load_image", "oversample", "ImageTransformer"]


def resize_image(img, target_size):
    """Resize the SHORT edge to target_size (ref image_util.py:20)."""
    return _img.resize_short(np.asarray(img), target_size)


def flip(im):
    """Horizontal mirror (ref image_util.py:33)."""
    im = np.asarray(im)
    if im.ndim == 3:
        return im[:, ::-1, :]
    return im[:, ::-1]


def crop_img(im, inner_size, color=True, test=True):
    """Center crop in test mode, random crop (+ random flip) in train
    mode (ref image_util.py:45)."""
    im = np.asarray(im)
    if test:
        return _img.center_crop(im, inner_size, is_color=color)
    out = _img.random_crop(im, inner_size, is_color=color)
    if np.random.randint(2):
        out = flip(out)
    return out


def preprocess_img(im, img_mean, crop_size, is_train, color=True):
    """crop -> CHW float -> mean subtract (ref image_util.py:96)."""
    im = crop_img(im, crop_size, color=color, test=not is_train)
    im = _img.to_chw(im).astype("float32") if im.ndim == 3 \
        else im.astype("float32")
    if img_mean is not None:
        mean = np.asarray(img_mean, np.float32)
        if im.ndim == 3:
            im = im - mean.reshape(im.shape[0], 1, 1)
        else:
            # grayscale HxW: only a scalar mean is meaningful
            im = im - np.float32(mean.reshape(-1)[0])
    return im.flatten()


def load_image(img_path, is_color=True):
    return _img.load_image(img_path, is_color)


def oversample(img, crop_dims):
    """10-crop oversampling: 4 corners + center, mirrored
    (ref image_util.py:144).  img: list/array of HWC images."""
    imgs = [np.asarray(i) for i in (img if isinstance(img, (list, tuple))
                                    else [img])]
    ch, cw = crop_dims
    out = []
    for im in imgs:
        h, w = im.shape[:2]
        anchors = [(0, 0), (0, w - cw), (h - ch, 0), (h - ch, w - cw),
                   ((h - ch) // 2, (w - cw) // 2)]
        for (y, x) in anchors:
            c = im[y:y + ch, x:x + cw]
            out.append(c)
            out.append(c[:, ::-1])
    return np.stack(out)


class ImageTransformer(object):
    """Stateful channel-order/mean transformer (ref image_util.py:183)."""

    def __init__(self, transpose=None, channel_swap=None, mean=None,
                 is_color=True):
        self.transpose = transpose
        self.channel_swap = channel_swap
        self.mean = None if mean is None else np.array(mean,
                                                       np.float32)
        self.is_color = is_color

    def set_transpose(self, order):
        self.transpose = order

    def set_channel_swap(self, order):
        self.channel_swap = order

    def set_mean(self, mean):
        self.mean = None if mean is None else np.array(mean, np.float32)

    def transformer(self, data):
        data = np.asarray(data, np.float32)
        if self.transpose is not None:
            data = data.transpose(self.transpose)
        if self.channel_swap is not None:
            data = data[np.asarray(self.channel_swap)]
        if self.mean is not None:
            mean = self.mean
            if mean.ndim == 1 and data.ndim == 3:
                mean = mean[:, None, None]
            data = data - mean
        return data
