"""Image preprocessing utilities (counterpart of
paddle_tpu/dataset/image.py; ref python/paddle/dataset/image.py).

The reference wraps OpenCV; this one is numpy, with PIL where it is
installed (decoding raises RuntimeError without it; ``resize_short``
falls back to a numpy nearest-neighbour resize), with the same function
contracts: images are HWC uint8
(or float) arrays in RGB order unless stated; ``to_chw`` converts for
the conv stack's NCHW layout.
"""
import numpy as np

try:
    from PIL import Image as _PILImage
except Exception:  # pragma: no cover
    _PILImage = None

__all__ = [
    "load_image_bytes", "load_image", "resize_short", "to_chw",
    "center_crop", "random_crop", "left_right_flip", "simple_transform",
    "load_and_transform", "batch_images_from_tar"
]


def _require_pil():
    if _PILImage is None:
        raise RuntimeError("PIL is unavailable; image decoding disabled")


def batch_images_from_tar(data_file, dataset_name, img2label,
                          num_per_batch=1024):
    """Pack a tarball of images into pickled (data, label) batch files
    (ref image.py:80).  Retained for API parity; operates on a local
    tarball only (no download)."""
    import os
    import pickle
    import tarfile

    batch_dir = data_file + "_batch"
    out_path = "%s/%s_%s" % (batch_dir, dataset_name, "batch")
    meta_file = "%s/%s_%s.txt" % (batch_dir, dataset_name, "batch")
    if os.path.exists(out_path):
        return meta_file
    os.makedirs(out_path, exist_ok=True)
    tf = tarfile.open(data_file)
    mems = tf.getmembers()
    data, labels, file_id = [], [], 0
    for mem in mems:
        if mem.name in img2label:
            data.append(tf.extractfile(mem).read())
            labels.append(img2label[mem.name])
            if len(data) == num_per_batch:
                output = {'label': labels, 'data': data}
                with open("%s/batch_%d" % (out_path, file_id), "wb") as f:
                    pickle.dump(output, f, protocol=2)
                file_id += 1
                data, labels = [], []
    if data:
        output = {'label': labels, 'data': data}
        with open("%s/batch_%d" % (out_path, file_id), "wb") as f:
            pickle.dump(output, f, protocol=2)
    with open(meta_file, 'a') as meta:
        for file in os.listdir(out_path):
            meta.write(os.path.abspath("%s/%s" % (out_path, file)) + "\n")
    return meta_file


def load_image_bytes(bytes_, is_color=True):
    """Decode an encoded image buffer to an HWC (or HW) uint8 array
    (ref image.py:141)."""
    _require_pil()
    import io
    img = _PILImage.open(io.BytesIO(bytes_))
    img = img.convert("RGB" if is_color else "L")
    return np.asarray(img)


def load_image(file, is_color=True):
    """Decode an image file (ref image.py:167)."""
    _require_pil()
    img = _PILImage.open(file)
    img = img.convert("RGB" if is_color else "L")
    return np.asarray(img)


def resize_short(im, size):
    """Scale so the SHORT edge becomes ``size``, keeping aspect ratio
    (ref image.py:197)."""
    h, w = im.shape[:2]
    if h > w:
        h_new, w_new = size * h // w, size
    else:
        h_new, w_new = size, size * w // h
    if _PILImage is not None:
        mode = "RGB" if im.ndim == 3 else "L"
        pimg = _PILImage.fromarray(im.astype(np.uint8), mode=mode)
        return np.asarray(pimg.resize((w_new, h_new),
                                      _PILImage.Resampling.BILINEAR))
    # numpy nearest fallback
    ys = (np.arange(h_new) * h / h_new).astype(int)
    xs = (np.arange(w_new) * w / w_new).astype(int)
    return im[ys][:, xs]


def to_chw(im, order=(2, 0, 1)):
    """HWC -> CHW (ref image.py:225)."""
    assert len(im.shape) == len(order)
    return im.transpose(order)


def center_crop(im, size, is_color=True):
    """Crop the centered size x size window (ref image.py:249)."""
    h, w = im.shape[:2]
    h_start = (h - size) // 2
    w_start = (w - size) // 2
    h_end, w_end = h_start + size, w_start + size
    if is_color:
        return im[h_start:h_end, w_start:w_end, :]
    return im[h_start:h_end, w_start:w_end]


def random_crop(im, size, is_color=True):
    """Crop a uniformly random size x size window (ref image.py:277)."""
    h, w = im.shape[:2]
    h_start = np.random.randint(0, h - size + 1)
    w_start = np.random.randint(0, w - size + 1)
    h_end, w_end = h_start + size, w_start + size
    if is_color:
        return im[h_start:h_end, w_start:w_end, :]
    return im[h_start:h_end, w_start:w_end]


def left_right_flip(im, is_color=True):
    """Horizontal mirror (ref image.py:305)."""
    if len(im.shape) == 3 and is_color:
        return im[:, ::-1, :]
    return im[:, ::-1]


def simple_transform(im, resize_size, crop_size, is_train, is_color=True,
                     mean=None):
    """resize_short -> (random|center) crop -> maybe flip -> CHW float
    -> maybe mean-subtract (ref image.py:327)."""
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, is_color=is_color)
        if np.random.randint(2) == 0:
            im = left_right_flip(im, is_color)
    else:
        im = center_crop(im, crop_size, is_color=is_color)
    if len(im.shape) == 3:
        im = to_chw(im)
    im = im.astype('float32')
    if mean is not None:
        mean = np.array(mean, dtype=np.float32)
        if mean.ndim == 1 and is_color:
            mean = mean[:, np.newaxis, np.newaxis]
        im -= mean
    return im


def load_and_transform(filename, resize_size, crop_size, is_train,
                       is_color=True, mean=None):
    """load_image + simple_transform (ref image.py:383)."""
    im = load_image(filename, is_color)
    return simple_transform(im, resize_size, crop_size, is_train, is_color,
                            mean)
