"""ParamAttr — parameter configuration.

Counterpart of paddle_tpu/param_attr.py. ``sharding`` is kept as
metadata so a Program's JSON matches the JAX package's.
"""
from . import initializer as init_mod


class ParamAttr(object):
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, gradient_clip=None,
                 do_model_average=False, sharding=None):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        self.do_model_average = do_model_average
        self.sharding = tuple(sharding) if sharding is not None else None

    @staticmethod
    def _to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, (list, tuple)):
            return [ParamAttr._to_attr(a) for a in arg]
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, init_mod.Initializer):
            return ParamAttr(initializer=arg)
        if isinstance(arg, bool):
            return ParamAttr() if arg else False
        if isinstance(arg, (int, float)):
            return ParamAttr(learning_rate=float(arg))
        raise TypeError("cannot make ParamAttr from %r" % (arg,))

    def _to_kwargs(self, with_initializer=False):
        kwargs = {
            "name": self.name,
            "optimize_attr": {"learning_rate": self.learning_rate},
            "regularizer": self.regularizer,
            "trainable": self.trainable,
            "gradient_clip_attr": self.gradient_clip,
            "do_model_average": self.do_model_average,
            "sharding": self.sharding,
        }
        if with_initializer:
            kwargs["initializer"] = self.initializer
        return kwargs


# the weight-norm reparameterisation is not applied: the JAX package's
# WeightNormParamAttr is this same alias (paddle_tpu/param_attr.py:56)
WeightNormParamAttr = ParamAttr
