"""fluid.dygraph.BackwardStrategy (counterpart of
paddle_tpu/dygraph/backward_strategy.py; ref dygraph/backward_strategy
via core.BackwardStrategy): a config holder. torch's autograd engine sums
a gradient's contributions in its own fixed order, so
``sort_sum_gradient`` is recorded and moot."""
__all__ = ["BackwardStrategy"]


class BackwardStrategy(object):
    def __init__(self):
        self.sort_sum_gradient = False
