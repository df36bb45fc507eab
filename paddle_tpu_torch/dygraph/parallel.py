"""Dygraph data parallelism on one card.

Counterpart of paddle_tpu/dygraph/parallel.py (reference:
dygraph/parallel.py, DataParallel + Env). The JAX package ``pmap``s
``train_step`` over ``jax.device_count()`` devices: the batch split
evenly, each shard's gradient of its own mean loss, ``pmean`` over the
shards. The mean of equal shards' mean gradients is the whole batch's,
so on the guard's one card the port computes the whole batch's loss and
gradient in one ``Layer.loss_and_grad`` and gets the same result for a
loss that is a mean over the batch. More than one rank
(``PADDLE_TRAINERS_NUM`` > 1, the reference's launcher variable) belongs
to the multi-GPU slice over ``torch.distributed`` and raises
``NotPortedError``.
"""
import os

from .base import EagerVariable
from .layers import Layer
from ..ops.registry import NotPortedError


class ParallelEnv(object):
    """The launcher's environment (the reference's ParallelEnv reads the
    same variables)."""

    @property
    def nranks(self):
        return int(os.getenv("PADDLE_TRAINERS_NUM", "1"))

    @property
    def local_rank(self):
        return int(os.getenv("PADDLE_TRAINER_ID", "0"))

    @property
    def dev_id(self):
        return int(os.getenv("FLAGS_selected_gpus", "0").split(",")[0])


def _one_rank():
    env = ParallelEnv()
    if env.nranks > 1:
        raise NotPortedError(
            "dygraph data parallelism over %d ranks runs over "
            "torch.distributed; it arrives with the multi-GPU slice of "
            "paddle_tpu_torch" % env.nranks)
    return env


def prepare_context(strategy=None):
    return _one_rank()


class DataParallel(Layer):
    """Wraps a Layer; train_step(loss_fn, optimizer, *batch) runs one
    data-parallel step (one card: the whole batch) and applies the
    optimizer."""

    def __init__(self, layer, strategy=None):
        super(DataParallel, self).__init__()
        _one_rank()
        self._layers = layer

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def scale_loss(self, loss):
        return loss  # one rank: nothing to scale

    def apply_collective_grads(self):
        pass  # one rank: nothing to reduce

    def train_step(self, loss_fn, optimizer, *batch):
        """One step: the batch's mean loss and its gradients, then
        ``optimizer`` (a dygraph optimizer) on them. Returns the loss."""
        loss, _ = self._layers.loss_and_grad(loss_fn, *batch)
        optimizer.minimize(self._layers)
        return EagerVariable(loss._value)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_dict(self, *a, **k):
        return self._layers.set_dict(*a, **k)
