"""DataLoader: batches from a generator, prefetched on a host thread.

Counterpart of paddle_tpu/reader/dataloader.py (ref fluid.io.DataLoader,
python/paddle/fluid/reader.py). With ``use_double_buffer`` a background
thread runs the generator and turns each batch into a feed dict of numpy
arrays, up to ``capacity`` ahead of the consumer. Where the JAX package's
thread also stages each batch on the device, this thread stays on the
host: a CUDA graph is captured in the global capture mode, which an
allocation, a pinned buffer or a synchronisation from another thread
would void. The Executor copies each feed to the card on the consuming
thread, on a replay through pinned buffers made before the capture.
"""
import queue
import threading

import numpy as np


class DataLoader(object):
    @staticmethod
    def from_generator(feed_list=None, capacity=4, use_double_buffer=True,
                       iterable=True, return_list=False,
                       use_multiprocess=False):
        return _GeneratorLoader(feed_list, capacity, use_double_buffer)


class _GeneratorLoader(object):
    def __init__(self, feed_list, capacity, use_double_buffer):
        self._feed_list = feed_list or []
        self._capacity = capacity
        self._double_buffer = use_double_buffer
        self._batch_reader = None
        self._places = None

    def set_batch_generator(self, reader, places=None):
        """reader() yields ready batches: tuples in feed_list order, or
        dicts."""
        self._batch_reader = reader
        self._places = places
        return self

    def set_sample_list_generator(self, reader, places=None):
        """reader() yields lists of samples, each a tuple in feed_list
        order; each list is stacked into a batch."""
        names = [v.name for v in self._feed_list]

        def batched():
            for samples in reader():
                cols = list(zip(*samples))
                yield {n: np.stack([np.asarray(c) for c in col])
                       for n, col in zip(names, cols)}
        self._batch_reader = batched
        self._places = places
        return self

    def set_sample_generator(self, reader, batch_size, drop_last=True,
                             places=None):
        """reader() yields single samples, batched ``batch_size`` at a
        time. (paddle_tpu wraps each sample in a list first, so its
        batches hold one-sample lists and fail to stack.)"""
        from .decorator import batch as batch_dec
        return self.set_sample_list_generator(
            batch_dec(reader, batch_size, drop_last=drop_last), places)

    def __call__(self):
        return iter(self)

    def __iter__(self):
        names = [v.name for v in self._feed_list]

        def to_feed(item):
            if isinstance(item, dict):
                return item
            if isinstance(item, (list, tuple)):
                return {n: np.asarray(v) for n, v in zip(names, item)}
            raise TypeError("batch generator must yield dict or tuple")

        if not self._double_buffer:
            for item in self._batch_reader():
                yield to_feed(item)
            return

        q = queue.Queue(maxsize=self._capacity)
        end = object()
        stop = threading.Event()
        err = []

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for item in self._batch_reader():
                    if not put(to_feed(item)):
                        return
            except Exception as e:   # raised on the consumer side
                err.append(e)
            finally:
                put(end)

        threading.Thread(target=producer, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is end:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            stop.set()
