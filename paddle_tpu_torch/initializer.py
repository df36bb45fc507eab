"""Parameter initializers.

Counterpart of paddle_tpu/initializer.py. Each initializer appends an init
op to the STARTUP program with the same type and attrs as the JAX
package's; the Executor runs the startup program once and the parameters
stay in the Scope.
"""
import math


class Initializer(object):
    def __call__(self, param, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self.value = value

    def __call__(self, param, block):
        block.append_op(
            "fill_constant", outputs={"Out": [param.name]},
            attrs={"shape": list(param.shape), "dtype": param.dtype,
                   "value": float(self.value), "op_role": "init"})


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, param, block):
        block.append_op(
            "uniform_random", outputs={"Out": [param.name]},
            attrs={"shape": list(param.shape), "dtype": param.dtype,
                   "min": self.low, "max": self.high, "seed": self.seed,
                   "op_role": "init"})


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, param, block):
        block.append_op(
            "gaussian_random", outputs={"Out": [param.name]},
            attrs={"shape": list(param.shape), "dtype": param.dtype,
                   "mean": self.loc, "std": self.scale, "seed": self.seed,
                   "op_role": "init"})


class TruncatedNormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, param, block):
        block.append_op(
            "truncated_gaussian_random", outputs={"Out": [param.name]},
            attrs={"shape": list(param.shape), "dtype": param.dtype,
                   "mean": self.loc, "std": self.scale, "seed": self.seed,
                   "op_role": "init"})


def _fans(shape):
    if len(shape) == 2:
        return shape[0], shape[1]
    if len(shape) > 2:
        rf = math.prod(shape[2:])
        return shape[1] * rf, shape[0] * rf
    n = math.prod(shape)
    return n, n


class XavierInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = \
            uniform, fan_in, fan_out, seed

    def __call__(self, param, block):
        fi, fo = _fans(param.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            UniformInitializer(-limit, limit, self.seed)(param, block)
        else:
            std = math.sqrt(2.0 / (fi + fo))
            NormalInitializer(0.0, std, self.seed)(param, block)


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
