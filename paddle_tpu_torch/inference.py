"""Inference engine: load a model directory, serve requests.

Counterpart of paddle_tpu/inference.py (the AnalysisPredictor
work-alike). ``create_predictor(Config(model_dir))`` loads
``save_inference_model``'s directory onto ``config.place`` (default
CUDAPlace(0)) and ``run`` pads each request's batch up to a bucket, runs
the program with the port's Executor and slices the batch back.
"""
import math

import numpy as np

from .framework.executor import Executor
from .framework.place import _current_expected_place
from .framework.scope import Scope, scope_guard
from .io import load_inference_model
from .serving import infer_batch_factors


class Config(object):
    """AnalysisConfig work-alike. ``place`` None means CUDAPlace(0)."""

    def __init__(self, model_dir):
        self.model_dir = model_dir
        self.batch_buckets = (1, 2, 4, 8, 16, 32, 64)
        self.place = None
        # {feed_name: batch_factor} — needed only when NO dynamic feed
        # carries dim0 == batch (see infer_batch_factors)
        self.feed_batch_factors = None


class Predictor(object):
    def __init__(self, config):
        self._scope = Scope()
        self._exe = Executor(config.place or _current_expected_place())
        with scope_guard(self._scope):
            self._program, self._feed_names, self._fetch_names = \
                load_inference_model(config.model_dir, self._exe)
        self._buckets = sorted(config.batch_buckets)
        self._factor_overrides = dict(config.feed_batch_factors or {})
        blk = self._program.global_block()

        def _dyn(name):
            # declared batch-dynamic: leading -1, or 0, which a reshape
            # records for "copy the input's dim" (BERT's pooled output);
            # the JAX package's Predictor reads only -1 and returns such a
            # fetch with the bucket's padding rows
            var = blk._find_var_recursive(name)
            shape = list(var.shape) if var is not None and \
                var.shape is not None else [-1]
            return bool(shape) and shape[0] in (-1, 0)

        self._dyn_feeds = {n: _dyn(n) for n in self._feed_names}
        self._dyn_fetches = [_dyn(n) for n in self._fetch_names]

    def get_input_names(self):
        return list(self._feed_names)

    def get_output_names(self):
        return list(self._fetch_names)

    def _bucket(self, n):
        for b in self._buckets:
            if n <= b:
                return b
        return int(2 ** math.ceil(math.log2(max(n, 1))))

    def run(self, inputs):
        """inputs: dict name -> np array (or a list aligned with the feed
        names). Returns np arrays aligned with the fetch names. The batch
        is padded up to its bucket and the results sliced back; a feed
        whose leading dim is a multiple of the batch pads to bucket *
        factor."""
        if isinstance(inputs, (list, tuple)):
            inputs = dict(zip(self._feed_names, inputs))
        dyn_dims = [(name, np.asarray(inputs[name]).shape[0])
                    for name in self._feed_names if self._dyn_feeds[name]]
        factors, n = infer_batch_factors(dyn_dims, self._factor_overrides)
        if n is None:   # fully static program: run as-is
            with scope_guard(self._scope):
                return self._exe.run(self._program, feed=dict(inputs),
                                     fetch_list=self._fetch_names)
        b = self._bucket(max(n, 1))
        feed = {}
        for name, arr in inputs.items():
            arr = np.asarray(arr)
            f = factors.get(name, 0)
            if f and arr.shape[0] != b * f:
                arr = np.pad(arr, [(0, b * f - arr.shape[0])] +
                             [(0, 0)] * (arr.ndim - 1))
            feed[name] = arr
        with scope_guard(self._scope):
            outs = self._exe.run(self._program, feed=feed,
                                 fetch_list=self._fetch_names)
        # slice only fetches declared batch-dynamic: a static output dim
        # that happens to equal bucket*factor is never truncated
        out_factors = sorted({f for f in factors.values() if f},
                             reverse=True)
        sliced = []
        for o, dyn in zip(outs, self._dyn_fetches):
            if dyn and np.ndim(o) > 0:
                for f in out_factors:
                    if o.shape[0] == b * f:
                        o = o[:n * f]
                        break
            sliced.append(o)
        return sliced


def create_predictor(config):
    return Predictor(config)


__all__ = ["Config", "Predictor", "create_predictor", "infer_batch_factors"]
