"""High-level Trainer API (counterpart of paddle_tpu/contrib/trainer.py;
fluid's contrib/trainer.py).

The Paddle Book's trainer: ``Trainer(train_func, optimizer_func, place=
...)`` builds the program (train_func returns [loss, *metrics]), appends
the optimizer, runs the startup and, in ``train``, the epoch/step event
loop with its events and periodic checkpoints (``CheckpointConfig``,
``io.save_checkpoint``; a directory with a checkpoint resumes from it).
It runs on ``CUDAPlace(0)`` unless ``place`` says otherwise, and every
step goes through ``Executor.run``, so from a key's third run a step
replays its CUDA graph.
"""
import os

import numpy as np

from ..framework.program import Program, program_guard
from ..framework.scope import Scope, scope_guard
from ..framework.executor import Executor
from .. import io as io_mod
from ..data_feeder import DataFeeder

__all__ = ['BeginEpochEvent', 'EndEpochEvent', 'BeginStepEvent',
           'EndStepEvent', 'CheckpointConfig', 'Trainer']


class BeginEpochEvent(object):
    """Fires at each epoch start (ref :40)."""

    def __init__(self, epoch_id):
        self.epoch = epoch_id


class EndEpochEvent(object):
    """Fires at each epoch end (ref :52)."""

    def __init__(self, epoch_id):
        self.epoch = epoch_id


class BeginStepEvent(object):
    """Fires before each step (ref :64); set fetch_metrics=False to
    skip metric fetching for speed."""

    def __init__(self, epoch_id, step_id):
        self.epoch = epoch_id
        self.step = step_id
        self.fetch_metrics = True


class EndStepEvent(object):
    """Fires after each step with the fetched metrics (ref :83)."""

    def __init__(self, epoch_id, step_id, metrics):
        self.epoch = epoch_id
        self.step = step_id
        self.metrics = metrics


class CheckpointConfig(object):
    """Periodic checkpoint policy (ref :100)."""

    def __init__(self, checkpoint_dir=None, max_num_checkpoints=3,
                 epoch_interval=1, step_interval=10):
        self.checkpoint_dir = checkpoint_dir or os.path.join(
            ".", "checkpoints")
        self.max_num_checkpoints = max_num_checkpoints
        self.epoch_interval = max(int(epoch_interval), 1)
        self.step_interval = max(int(step_interval), 1)
        self.epoch_id = 0
        self.step_id = 0
        self.load_serial = None


class Trainer(object):
    """Build-and-train loop (ref :169).

    train_func() must return [loss] (or [loss, *metrics]);
    optimizer_func() returns an Optimizer.  Feeds come from a fluid
    reader (batches of per-slot tuples) through DataFeeder using
    ``feed_order`` names.
    """

    def __init__(self, train_func, optimizer_func, param_path=None,
                 place=None, parallel=False, checkpoint_config=None):
        self._place = place
        self._parallel = parallel
        self._checkpoint_cfg = checkpoint_config
        self.scope = Scope()
        self.startup_program = Program()
        self.train_program = Program()
        with program_guard(self.train_program, self.startup_program):
            outs = train_func()
            if not isinstance(outs, (list, tuple)):
                outs = [outs]
            self.train_func_outputs = list(outs)
            self.loss = outs[0]
            optimizer = optimizer_func()
            optimizer.minimize(self.loss)
        # evaluation must not run the appended optimizer update ops:
        # test() uses the pruned inference clone of the same graph
        self.test_program = self.train_program.clone(for_test=True)
        self.exe = Executor(place)
        with scope_guard(self.scope):
            self.exe.run(self.startup_program)
            if param_path and os.path.isdir(param_path):
                io_mod.load_persistables(self.exe, param_path,
                                         self.train_program)
            cfg = self._checkpoint_cfg
            if cfg and os.path.exists(os.path.join(cfg.checkpoint_dir,
                                                   "latest")):
                # crash-resume: restore the newest checkpoint's state
                cfg.load_serial = io_mod.load_checkpoint(
                    self.exe, cfg.checkpoint_dir, self.train_program)

    def stop(self):
        self.__stop = True

    def train(self, num_epochs, event_handler, reader=None,
              feed_order=None):
        """The reference event loop (ref :379): BeginEpoch ->
        (BeginStep -> run -> EndStep)* -> EndEpoch, checkpointing per
        CheckpointConfig; event_handler may call trainer.stop()."""
        self.__stop = False
        feeder = self._make_feeder(feed_order)
        with scope_guard(self.scope):
            for epoch_id in range(num_epochs):
                event_handler(BeginEpochEvent(epoch_id))
                for step_id, data in enumerate(reader()):
                    if self.__stop:
                        return
                    begin_event = BeginStepEvent(epoch_id, step_id)
                    event_handler(begin_event)
                    fetch = self.train_func_outputs \
                        if begin_event.fetch_metrics else []
                    metrics = self.exe.run(
                        self.train_program,
                        feed=feeder.feed(data) if feeder else data,
                        fetch_list=fetch)
                    event_handler(EndStepEvent(epoch_id, step_id,
                                               metrics))
                    if self._checkpoint_cfg and \
                            (step_id + 1) % \
                            self._checkpoint_cfg.step_interval == 0:
                        self._save_checkpoint(epoch_id, step_id)
                event_handler(EndEpochEvent(epoch_id))
                if self._checkpoint_cfg and \
                        (epoch_id + 1) % \
                        self._checkpoint_cfg.epoch_interval == 0:
                    self._save_checkpoint(epoch_id, -1)

    def _make_feeder(self, feed_order):
        if not feed_order:
            return None
        blk = self.train_program.global_block()
        feed_vars = [blk.var(n) if isinstance(n, str) else n
                     for n in feed_order]
        return DataFeeder(feed_list=feed_vars, program=self.train_program)

    def test(self, reader, feed_order):
        """Mean metrics over a test reader (ref :407), on the for_test
        clone, so no optimizer update ops run on test data."""
        feeder = self._make_feeder(feed_order)
        totals = None
        count = 0
        with scope_guard(self.scope):
            for data in reader():
                outs = self.exe.run(self.test_program,
                                    feed=feeder.feed(data),
                                    fetch_list=self.train_func_outputs)
                vals = [float(np.asarray(o).reshape(-1)[0]) for o in outs]
                totals = vals if totals is None else \
                    [t + v for t, v in zip(totals, vals)]
                count += 1
        return [t / max(count, 1) for t in (totals or [])]

    def save_params(self, param_path):
        with scope_guard(self.scope):
            io_mod.save_persistables(self.exe, param_path,
                                     self.train_program)

    def save_inference_model(self, param_path, feeded_var_names,
                             target_var_indexes):
        with scope_guard(self.scope):
            io_mod.save_inference_model(
                param_path, feeded_var_names,
                [self.train_func_outputs[i] for i in target_var_indexes],
                self.exe, main_program=self.train_program)

    def _save_checkpoint(self, epoch_id, step_id):
        cfg = self._checkpoint_cfg
        io_mod.save_checkpoint(
            self.exe, cfg.checkpoint_dir, self.train_program,
            step=epoch_id * 1000000 + max(step_id, 0),
            keep_last=cfg.max_num_checkpoints)
