"""Dygraph checkpoint save/load (counterpart of
paddle_tpu/dygraph/checkpoint.py; reference: dygraph/checkpoint.py).

The same file as the JAX package's: one ``<model_path>.pdparams.npz``
of numpy arrays, so a state dict saved by either package loads in the
other."""
import os

import numpy as np
import torch

from ..framework.scope import to_numpy


def save_dygraph(state_dict, model_path):
    os.makedirs(os.path.dirname(model_path) or ".", exist_ok=True)
    arrays = {k: to_numpy(v) if isinstance(v, torch.Tensor)
              else np.asarray(v) for k, v in state_dict.items()}
    np.savez(model_path + ".pdparams.npz", **arrays)


def load_dygraph(model_path):
    path = model_path + ".pdparams.npz"
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}, None
