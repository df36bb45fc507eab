"""fluid.transpiler.geo_sgd_transpiler (counterpart of paddle_tpu/
transpiler/geo_sgd_transpiler.py): GEO async-SGD hides slow networks
between pservers and trainers; the port syncs synchronously inside the
step. Raises with guidance."""

__all__ = ["GeoSgdTranspiler"]


class GeoSgdTranspiler(object):
    def __init__(self, config=None):
        raise NotImplementedError(
            "GEO async-SGD has no counterpart in paddle_tpu_torch: "
            "synchronous data parallelism (CompiledProgram over a device "
            "mesh) replaces it")
