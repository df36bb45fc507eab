"""Utility helpers (counterpart of paddle_tpu/utils; ref
python/paddle/utils/__init__.py): training-curve plotting + legacy v1
image preprocessing + torch weight import. matplotlib and PIL are
imported only inside the functions that draw or decode."""
from . import plot
from . import image_util
from . import plotcurve
from . import preprocess_util
from . import preprocess_img
from . import show_pb
from . import torch2paddle
from .plot import Ploter, PlotData

__all__ = ["plot", "image_util", "plotcurve", "preprocess_util",
           "preprocess_img", "show_pb", "torch2paddle", "Ploter",
           "PlotData"]
