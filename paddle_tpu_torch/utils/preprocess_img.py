"""Image-classification corpus builder.

Counterpart of paddle_tpu/utils/preprocess_img.py. Reference parity:
python/paddle/utils/preprocess_img.py — resize images,
walk a class-per-directory corpus, and emit the block files
preprocess_util's DataBatcher defines.
"""
import os

import numpy as np

from . import preprocess_util
from .image_util import resize_image as _resize_short_np
from .preprocess_util import Dataset, list_images

__all__ = ["resize_image", "DiskImage", "ImageClassificationDatasetCreater"]


def resize_image(img, target_size):
    """Resize a PIL image so its SHORT side equals target_size (aspect
    preserved). One implementation package-wide: delegates to
    image_util.resize_image / dataset.image.resize_short — note this
    uses that path's floor-division long-side rounding and BILINEAR
    filter (not PIL's round()/BICUBIC), so regenerated corpora may
    differ from pre-consolidation ones by one pixel on the long side."""
    from PIL import Image
    return Image.fromarray(_resize_short_np(img, target_size))


class DiskImage(object):
    """A lazily-loaded image file + its label."""

    def __init__(self, path, target_size):
        self.path = path
        self.target_size = target_size

    def read_image(self):
        from PIL import Image
        with Image.open(self.path) as img:
            img = img.convert("RGB")
            return np.asarray(_resize_short_np(img, self.target_size),
                              np.uint8)


class ImageClassificationDatasetCreater(preprocess_util.DatasetCreater):
    """Build block files from train/ and test/ class-per-subdir trees of
    images (each sample = (HWC uint8 array, int label))."""

    def __init__(self, data_path, target_size=32, color=True):
        super(ImageClassificationDatasetCreater, self).__init__(data_path)
        self.target_size = target_size
        self.color = color
        self.keys = ["image", "label"]

    def create_dataset_from_dir(self, path, label_set=None):
        # label_set comes from the TRAIN split (DatasetCreater.
        # create_batches) so test labels can't silently renumber when a
        # class is missing from test/
        labels = (label_set if label_set is not None
                  else preprocess_util.get_label_set_from_dir(path))
        data = []
        for cls in preprocess_util.list_dirs(path):
            if cls not in labels:
                raise ValueError(
                    "class directory %r in %s is absent from the train "
                    "label set %r" % (cls, path, sorted(labels)))
            cls_dir = os.path.join(path, cls)
            for fname in list_images(cls_dir):
                img = DiskImage(os.path.join(cls_dir, fname),
                                self.target_size).read_image()
                if not self.color:
                    img = img.mean(axis=2).astype(np.uint8)
                data.append((img, labels[cls]))
        return Dataset(data, self.keys)
