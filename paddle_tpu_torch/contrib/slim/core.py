"""The compression run loop (counterpart of paddle_tpu/contrib/slim/
core.py; reference python/paddle/fluid/contrib/slim/core/compressor.py).

The reference Compressor reads a YAML config and drives pruning,
distillation and quantization strategies across training epochs with
periodic evaluation and checkpoints. Here, as in the JAX package, the
run loop's contract is kept programmatically: a strategy is an object
with any of ``on_compression_begin``, ``on_epoch_begin``,
``on_epoch_end`` and ``on_compression_end(context)``; the Context
carries the Executor, the train and eval programs and the eval history
(``eval_converged`` reads it). The strategies' tools are prune.py,
distill.py and qat.py.
"""
import numpy as np

__all__ = ["Context", "Compressor"]


class Context(object):
    """The run loop's state, handed to every strategy hook."""

    def __init__(self, place=None, scope=None, train_graph=None,
                 eval_graph=None, executor=None):
        self.place = place
        self.scope = scope
        self.train_graph = train_graph
        self.eval_graph = eval_graph
        self.executor = executor
        self.epoch_id = 0
        self.eval_results = {}

    def eval_converged(self, metric_name, delta=0.001):
        """True when the last two evals of ``metric_name`` moved by less
        than ``delta``."""
        hist = self.eval_results.get(metric_name, [])
        if len(hist) < 2:
            return False
        return abs(hist[-1] - hist[-2]) < delta


class Compressor(object):
    """Train and eval epochs through a list of strategies.

    ``place``: the Executor's (None: CUDAPlace(0), which raises
    NoCUDADeviceError without a card; pass CPUPlace() for the CPU).
    ``train_fn(exe)`` runs one training epoch and ``eval_fn(exe)`` returns
    {metric name: value}; without them the readers drive the programs.
    Both run under ``scope``. With ``checkpoint_path`` each epoch ends
    with ``io.save_checkpoint`` of the train program (step = the epoch).
    """

    def __init__(self, place, scope, train_program, train_reader=None,
                 train_feed_list=None, train_fetch_list=None,
                 eval_program=None, eval_reader=None, eval_feed_list=None,
                 eval_fetch_list=None, epoch=1, strategies=None,
                 train_fn=None, eval_fn=None, checkpoint_path=None):
        from ...framework.executor import Executor
        self.place = place
        self.scope = scope
        self.train_program = train_program
        self.eval_program = eval_program or train_program
        self.epoch = int(epoch)
        self.strategies = list(strategies or [])
        self.checkpoint_path = checkpoint_path
        self._exe = Executor(place)
        self._train_reader = train_reader
        self._train_feeds = train_feed_list or []
        self._train_fetch = train_fetch_list or []
        self._eval_reader = eval_reader
        self._eval_feeds = eval_feed_list or []
        self._eval_fetch = eval_fetch_list or []
        self._train_fn = train_fn
        self._eval_fn = eval_fn

    def _dispatch(self, hook, context):
        for s in self.strategies:
            fn = getattr(s, hook, None)
            if fn is not None:
                fn(context)

    @staticmethod
    def _feed(feeds, data):
        return dict(zip([getattr(v, "name", v) for v in feeds],
                        map(np.asarray, zip(*data)))) if feeds else data

    def _default_train_epoch(self):
        for data in self._train_reader():
            self._exe.run(self.train_program,
                          feed=self._feed(self._train_feeds, data),
                          fetch_list=self._train_fetch)

    def _default_eval(self):
        totals, count = None, 0
        for data in self._eval_reader():
            outs = self._exe.run(self.eval_program,
                                 feed=self._feed(self._eval_feeds, data),
                                 fetch_list=self._eval_fetch)
            vals = [float(np.asarray(o).reshape(-1)[0]) for o in outs]
            totals = vals if totals is None else \
                [t + v for t, v in zip(totals, vals)]
            count += 1
        names = [getattr(v, "name", str(i))
                 for i, v in enumerate(self._eval_fetch)]
        return {n: t / max(count, 1)
                for n, t in zip(names, totals or [])}

    def run(self):
        """compression_begin, then per epoch (epoch_begin, train, eval,
        epoch_end, checkpoint), then compression_end; returns the
        context."""
        from ...framework.scope import scope_guard
        context = Context(place=self.place, scope=self.scope,
                          train_graph=self.train_program,
                          eval_graph=self.eval_program,
                          executor=self._exe)
        with scope_guard(self.scope):
            self._dispatch("on_compression_begin", context)
            for epoch_id in range(self.epoch):
                context.epoch_id = epoch_id
                self._dispatch("on_epoch_begin", context)
                if self._train_fn is not None:
                    self._train_fn(self._exe)
                elif self._train_reader is not None:
                    self._default_train_epoch()
                results = self._eval_fn(self._exe) \
                    if self._eval_fn is not None else (
                    self._default_eval()
                    if self._eval_reader is not None else {})
                for k, v in (results or {}).items():
                    context.eval_results.setdefault(k, []).append(v)
                self._dispatch("on_epoch_end", context)
                if self.checkpoint_path:
                    from ... import io as io_mod
                    io_mod.save_checkpoint(
                        self._exe, self.checkpoint_path,
                        self.train_program, step=epoch_id)
            self._dispatch("on_compression_end", context)
        return context
