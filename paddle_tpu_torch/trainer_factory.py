"""Trainer and device-worker equivalents (counterpart of
paddle_tpu/trainer_factory.py; ref python/paddle/fluid/trainer_factory.py
and device_worker.py).

The reference runs C++ worker threads, each running the op list over a
data queue. Here one Python thread runs the Executor's step (on a CUDA
card a replay of the step's graph from its key's third run) while a
background thread, the DataFeed queue's counterpart, iterates the dataset
and collates the next batches on the host. That thread makes numpy
arrays only and never touches CUDA: a CUDA graph is captured in the
global capture mode, which a CUDA call from another thread during the
capture would void. The Executor copies each batch to the card on the
consuming thread (through its pinned staging buffers on a replay).
"""
import queue
import threading

import numpy as np

from .ops.registry import NotPortedError

_STOP = object()


def _uniform_shapes(batches):
    """True when every batch has the same keys and per-key shapes (a
    window of ``Executor.run_steps`` stacks them on one steps axis)."""
    first = batches[0]
    keys = set(first)
    return all(set(b) == keys for b in batches[1:]) and all(
        np.shape(b[k]) == np.shape(first[k])
        for b in batches[1:] for k in keys)


class PrefetchIterator(object):
    """Background-thread batch pump: the device_worker's data queue.
    Wraps any iterable of feed dicts; keeps up to ``capacity`` batches
    ready ahead of the consumer. close() (or abandoning the iterator
    after an error) unblocks and retires the pump thread."""

    def __init__(self, iterable, capacity=4):
        self._q = queue.Queue(maxsize=capacity)
        self._err = None
        self._stop = threading.Event()

        def put(item):
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def pump():
            try:
                for item in iterable:
                    if not put(item):
                        return
            except Exception as e:   # surfaced on the consumer side
                self._err = e
            finally:
                put(_STOP)

        self._thread = threading.Thread(target=pump, daemon=True)
        self._thread.start()

    def close(self):
        """Stop the pump thread (safe to call any time)."""
        self._stop.set()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is _STOP:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


class DeviceWorker(object):
    """Base device worker (reference device_worker.py DeviceWorker)."""

    def __init__(self):
        self._program = None

    def _set_program(self, program):
        self._program = program


class Hogwild(DeviceWorker):
    """Hogwild worker: the plain step loop; one thread issues the steps
    and the card's stream orders them."""


class DownpourSGD(DeviceWorker):
    """Pserver-style sparse push/pull worker; the step loop is the same
    (the sharded tables it stands for wait for the torch.distributed
    slice)."""


class Section(DeviceWorker):
    """Pipeline section worker (pipelines wait for the multi-GPU
    slice)."""


class TrainerDesc(object):
    def __init__(self):
        self._worker = Hogwild()
        self._fetch_vars = []
        self._fetch_info = []
        self._print_period = 100


class MultiTrainer(object):
    """Runs the Executor's step over a prefetched dataset (the reference
    MultiTrainer's thread pool becomes one prefetch thread)."""

    def __init__(self, executor, program, worker=None):
        self._exe = executor
        self._program = program
        self._worker = worker or Hogwild()
        self._worker._set_program(program)

    def run(self, dataset, fetch_list=None, fetch_info=None,
            print_period=100, debug=False, scope=None,
            steps_per_dispatch=1):
        """Every batch of ``dataset`` through the step: (steps run, the
        last step's fetches as numpy arrays)."""
        fetch_list = list(fetch_list or [])
        fetch_info = list(fetch_info or
                          [getattr(f, "name", str(f)) for f in fetch_list])
        step = 0
        last = []
        # steps_per_dispatch > 1: gather W batches and run them as one
        # Executor.run_steps window (one copy of the window to the card,
        # a replay a step, one host sync at its end). Needs fetches (the
        # window's stacked outputs) and no started py_reader; a window
        # of unlike shapes and the short tail run step by step.
        window = max(int(steps_per_dispatch), 1)
        if window > 1 and not self._can_window(fetch_list):
            window = 1
        buf = []

        def emit(vals, every_multiple=False):
            due = (step % print_period == 0 if every_multiple
                   else step % print_period < window)
            if debug and fetch_list and due:
                print("step %d: %s" % (step, ", ".join(
                    "%s=%s" % (info, np.asarray(v).ravel()[:4])
                    for info, v in zip(fetch_info, vals))))

        def run_one(batch):
            nonlocal step, last
            # return_numpy copies a replay's fetches out of the graph's
            # pool, which the next replay overwrites
            last = self._exe.run(self._program, feed=batch,
                                 fetch_list=fetch_list, scope=scope)
            step += 1
            emit(last, every_multiple=True)

        it = PrefetchIterator(iter(dataset))
        try:
            for batch in it:
                if window == 1:
                    run_one(batch)
                    continue
                buf.append(batch)
                if len(buf) < window:
                    continue
                if not _uniform_shapes(buf):
                    # bucketed lengths, a remainder batch: one window
                    # needs one shape, so these run step by step
                    for b in buf:
                        run_one(b)
                    buf = []
                    continue
                stacked = {k: np.stack([np.asarray(b[k]) for b in buf])
                           for k in buf[0]}
                buf = []
                outs = self._exe.run_steps(
                    self._program, feed=stacked,
                    fetch_list=fetch_list, scope=scope)
                step += window
                last = [o[-1] for o in outs]
                emit(last)
            for batch in buf:      # tail shorter than the window
                run_one(batch)
        finally:
            it.close()
        return step, last

    def _can_window(self, fetch_list):
        """run_steps' preconditions; without them the loop runs step by
        step instead of failing mid-epoch."""
        return bool(fetch_list) and not any(
            r._started for r in getattr(self._program, "_py_readers", ()))


class DistMultiTrainer(MultiTrainer):
    """The distributed trainer waits for the torch.distributed slice."""

    def __init__(self, executor, program, worker=None):
        raise NotPortedError(
            "DistMultiTrainer (train_from_dataset over a fleet program) "
            "arrives with the torch.distributed slice of paddle_tpu_torch")


class TrainerFactory(object):
    def _create_trainer(self, opt_info=None):
        if opt_info and opt_info.get("trainer") == "DistMultiTrainer":
            return DistMultiTrainer
        return MultiTrainer
