"""Input layers (counterpart of paddle_tpu/layers/io.py): ``data`` and
the in-graph reader, ``py_reader``.

A started ``PyReader`` feeds its variables to ``Executor.run`` when the
caller does not: the run-without-feed training loop of fluid scripts
(``reader.start()``; ``exe.run(main, fetch_list=...)`` until
``EOFException``; ``reader.reset()``). Its thread runs the decorated
generator on the host and queues numpy batches; it never touches CUDA (a
CUDA graph is captured in the global capture mode, which a CUDA call
from another thread would void), and the Executor copies each batch to
the card on the thread that runs the step.
"""
import queue
import threading

import numpy as np

from ..framework import unique_name
from ..framework.program import default_main_program
from ..ops.registry import NotPortedError


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         stop_gradient=True):
    """Declare a feed variable. append_batch_size=True prepends -1 (batch),
    as fluid.layers.data does."""
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    return default_main_program().global_block().create_var(
        name=name, shape=tuple(shape), dtype=dtype, is_data=True,
        stop_gradient=stop_gradient, lod_level=lod_level)


class EOFException(Exception):
    """Raised by Executor.run when a started py_reader runs dry
    (reference fluid.core.EOFException); catch it and reader.reset()."""


class PyReader(object):
    """In-graph reader queue (reference layers/io.py py_reader +
    operators/reader/create_py_reader_op): a host thread puts decorated
    batches into a bounded queue; Executor.run takes the next one for
    this reader's variables when the caller does not feed them."""

    def __init__(self, capacity, shapes=None, dtypes=None, lod_levels=None,
                 name=None, use_double_buffer=True, feed_list=None):
        if feed_list is not None:       # wrap EXISTING data Variables
            self._vars = list(feed_list)
            self._names = [v.name for v in self._vars]
        else:
            base = name or unique_name.generate("py_reader")
            self._names = ["%s_slot_%d" % (base, i)
                           for i in range(len(shapes))]
            self._vars = [data(n, list(s), dtype=d,
                               append_batch_size=False)
                          for n, s, d in zip(self._names, shapes, dtypes)]
        # use_double_buffer in the reference adds a device staging slot;
        # here the Executor's pinned staging buffers are that slot
        self._capacity = max(2, int(capacity))
        self._queue = queue.Queue(self._capacity)
        self._pushback = []
        self._generator = None
        self._thread = None
        self._error = None
        self._started = False
        self._stop = False
        prog = default_main_program()
        if not hasattr(prog, "_py_readers"):
            prog._py_readers = []
        prog._py_readers.append(self)

    # ---- decoration (reference decorate_* methods) -------------------
    def decorate_paddle_reader(self, reader):
        """reader() yields batches as lists of per-sample tuples."""
        def gen():
            for samples in reader():
                cols = list(zip(*samples))
                yield tuple(np.stack([np.asarray(c) for c in col])
                            for col in cols)
        self._generator = gen
        return self

    decorate_sample_list_generator = decorate_paddle_reader

    def decorate_tensor_provider(self, reader):
        """reader() yields ready batch tuples of arrays."""
        self._generator = reader
        return self

    decorate_batch_generator = decorate_tensor_provider

    # ---- queue control ----------------------------------------------
    def start(self):
        if self._generator is None:
            raise RuntimeError("py_reader.start(): decorate a reader first")
        if self._started:
            return
        self._started = True
        self._stop = False
        self._error = None

        def _fill():
            try:
                for batch in self._generator():
                    if self._stop:
                        return
                    self._queue.put(tuple(batch))
            except Exception as e:   # raised by the run that reads it
                self._error = e
            finally:
                self._queue.put(None)   # EOF sentinel

        self._thread = threading.Thread(target=_fill, daemon=True)
        self._thread.start()

    def _drain(self):
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass

    def reset(self):
        self._stop = True
        if self._thread is not None:
            # drain WHILE joining so a filler blocked on a full queue can
            # finish its pending put (the EOF sentinel included) before
            # the final drain; otherwise a stale batch or None survives
            # into the next epoch
            while self._thread.is_alive():
                self._drain()
                self._thread.join(timeout=0.1)
            self._thread = None
        self._drain()
        self._pushback = []
        self._started = False

    def _push_back(self, feed_dict):
        """Return an already-dequeued batch (used when a sibling reader
        hits EOF in the same run, so no data is lost)."""
        self._pushback.append(feed_dict)

    def _next_feed(self):
        if not self._started:
            raise RuntimeError("py_reader: call start() before exe.run")
        if self._pushback:
            return self._pushback.pop()
        batch = self._queue.get()
        if batch is None:
            self._started = False
            if self._error is not None:
                raise self._error
            raise EOFException("py_reader %s exhausted" % self._names[0])
        if len(batch) != len(self._names):
            raise ValueError("py_reader got %d arrays for %d slots"
                             % (len(batch), len(self._names)))
        return dict(zip(self._names, batch))


def py_reader(capacity, shapes, dtypes, lod_levels=None, name=None,
              use_double_buffer=True):
    return PyReader(capacity, shapes, dtypes, lod_levels, name,
                    use_double_buffer)


def read_file(reader):
    """Unpack a py_reader into its data Variables (reference read_file)."""
    if len(reader._vars) == 1:
        return reader._vars[0]
    return list(reader._vars)


def double_buffer(reader, place=None, name=None):
    """The reader itself: its bounded queue is the host side of the
    double buffer, and the Executor's pinned staging buffers the device
    side."""
    return reader


def create_py_reader_by_data(capacity, feed_list, name=None,
                             use_double_buffer=True):
    """PyReader wired to EXISTING data Variables (ref layers/io.py
    create_py_reader_by_data): batches from the decorated reader feed
    those variables by name."""
    return PyReader(capacity, name=name, use_double_buffer=use_double_buffer,
                    feed_list=feed_list)


def load(out, file_path, load_as_fp16=False):
    """layers.load appends a ``load_tensor`` op, which the port's op
    library does not have yet."""
    raise NotPortedError(
        "layers.load (the load_tensor op) is not ported to "
        "paddle_tpu_torch yet; ROADMAP.md lists it")
