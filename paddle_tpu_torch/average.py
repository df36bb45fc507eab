"""WeightedAverage (counterpart of paddle_tpu/average.py; fluid's
average.py), on the host in numpy."""
import numpy as np


def _is_number_or_matrix(var):
    return isinstance(var, (int, float, complex, np.ndarray)) or \
        np.isscalar(var)


class WeightedAverage(object):
    def __init__(self):
        self.reset()

    def reset(self):
        self.numerator = None
        self.denominator = None

    def add(self, value, weight):
        if not _is_number_or_matrix(value):
            raise ValueError("add() expects a number or ndarray")
        value = np.mean(np.asarray(value, dtype=np.float64))
        if self.numerator is None:
            self.numerator = value * weight
            self.denominator = float(weight)
        else:
            self.numerator += value * weight
            self.denominator += weight

    def eval(self):
        if self.numerator is None or self.denominator == 0:
            raise ValueError("WeightedAverage.eval() before any add()")
        return self.numerator / self.denominator
