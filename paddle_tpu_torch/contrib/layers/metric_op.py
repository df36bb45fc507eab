"""Contrib metric ops (counterpart of paddle_tpu/contrib/layers/metric_op.py;
fluid's contrib/layers/metric_op.py).

``ctr_metric_bundle`` emits the six CTR monitoring aggregates the
reference computes with specialized ops, as ordinary ops of the step.
"""
from ... import layers

__all__ = ['ctr_metric_bundle']


def ctr_metric_bundle(input, label):
    """For click-probability ``input`` and 0/1 ``label`` (both (N, 1)):
    returns (squared_error_sum, abs_error_sum, prob_sum, q_sum(=prob_sum
    of positive calibration), pos_count, total_count) — the running
    numerators a CTR dashboard aggregates across batches
    (ref metric_op.py:30)."""
    diff = layers.elementwise_sub(input, layers.cast(label, input.dtype))
    sqrerr = layers.reduce_sum(layers.square(diff))
    abserr = layers.reduce_sum(layers.abs(diff))
    prob = layers.reduce_sum(input)
    q = layers.reduce_sum(layers.elementwise_mul(input, input))
    pos = layers.reduce_sum(layers.cast(label, input.dtype))
    # runtime row count — static shape may be -1 (dynamic batch) and the
    # final partial batch differs from the graph-time shape anyway
    total = layers.reduce_sum(layers.fill_constant_batch_size_like(
        input, shape=[-1, 1], dtype=input.dtype, value=1.0))
    return sqrerr, abserr, prob, q, pos, total
