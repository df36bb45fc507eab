"""Reader decorators (counterpart of paddle_tpu/reader/decorator.py).

Reference parity: python/paddle/reader/decorator.py, identical semantics
(a "reader" is a zero-arg callable returning an iterable of samples).
The threads of ``buffered`` and ``xmap_readers`` run the user's reader
and mapper on the host; they must not touch CUDA (the Executor copies
feeds to the card).
"""
import itertools
import random
import queue
import threading


from ..ops.registry import NotPortedError


def batch(reader, batch_size, drop_last=False):
    def batch_reader():
        b = []
        for sample in reader():
            b.append(sample)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b
    return batch_reader


def shuffle(reader, buf_size, seed=None):
    """Buffered shuffle. ``seed=None`` keeps the legacy behavior (the
    global ``random`` module — nondeterministic under concurrency).
    With a seed, each epoch (= each call of the returned reader) uses a
    fresh local ``random.Random`` derived from ``(seed, epoch)``:
    different epochs shuffle differently, but a rewind-and-replay that
    rebuilds the pipeline reproduces the exact sample order. The string
    seeding goes through hashlib, so the order is stable across
    processes (no PYTHONHASHSEED exposure)."""
    epoch_box = [0]

    def shuffle_reader():
        if seed is None:
            rng = random
        else:
            e = epoch_box[0]
            epoch_box[0] = e + 1
            # paddle_tpu's seed string: both packages shuffle alike
            rng = random.Random("paddle_tpu.shuffle:%d:%d"
                                % (int(seed), e))
        buf = []
        for x in reader():
            buf.append(x)
            if len(buf) >= buf_size:
                rng.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if buf:
            rng.shuffle(buf)
            for b in buf:
                yield b
    return shuffle_reader


def buffered(reader, size):
    """Background-thread prefetch buffer (the Python tier of the reference's
    double-buffered reader)."""
    class _End(object):
        pass

    def buffered_reader():
        q = queue.Queue(maxsize=size)

        def worker():
            try:
                for d in reader():
                    q.put(d)
            finally:
                q.put(_End)
        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is _End:
                break
            yield item
    return buffered_reader


def chain(*readers):
    def chain_reader():
        for r in readers:
            for e in r():
                yield e
    return chain_reader


class ComposeNotAligned(ValueError):
    """Raised when composed readers end at different lengths
    (ref python/paddle/reader/decorator.py ComposeNotAligned)."""


def compose(*readers, **kwargs):
    check_alignment = kwargs.get("check_alignment", True)

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def compose_reader():
        if not check_alignment:
            for outputs in zip(*[r() for r in readers]):
                yield sum([make_tuple(x) for x in outputs], ())
            return
        sentinel = object()
        for outputs in itertools.zip_longest(*[r() for r in readers],
                                             fillvalue=sentinel):
            if any(o is sentinel for o in outputs):
                raise ComposeNotAligned(
                    "outputs of readers are not aligned (different "
                    "lengths); pass check_alignment=False to truncate "
                    "to the shortest")
            yield sum([make_tuple(x) for x in outputs], ())
    return compose_reader


def firstn(reader, n):
    def firstn_reader():
        return itertools.islice(reader(), n)
    return firstn_reader


def map_readers(func, *readers):
    def mapped():
        for vals in zip(*[r() for r in readers]):
            yield func(*vals)
    return mapped


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map over samples with worker threads."""
    def xmapped():
        in_q = queue.Queue(buffer_size)
        out_q = queue.Queue(buffer_size)
        END = object()

        def feeder():
            for i, s in enumerate(reader()):
                in_q.put((i, s))
            for _ in range(process_num):
                in_q.put(END)

        def worker():
            while True:
                item = in_q.get()
                if item is END:
                    out_q.put(END)
                    return
                i, s = item
                out_q.put((i, mapper(s)))

        threading.Thread(target=feeder, daemon=True).start()
        for _ in range(process_num):
            threading.Thread(target=worker, daemon=True).start()
        finished = 0
        pending = {}
        next_i = 0
        while finished < process_num:
            item = out_q.get()
            if item is END:
                finished += 1
                continue
            i, s = item
            if not order:
                yield s
            else:
                pending[i] = s
                while next_i in pending:
                    yield pending.pop(next_i)
                    next_i += 1
        for i in sorted(pending):
            yield pending[i]
    return xmapped


def cache(reader):
    all_data = []
    filled = []

    def cache_reader():
        if not filled:
            all_data.extend(reader())
            filled.append(True)
        return iter(all_data)
    return cache_reader


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """Reads ``readers`` in worker processes in the reference; spawning
    processes waits for a later slice of paddle_tpu_torch."""
    raise NotPortedError(
        "reader.multiprocess_reader spawns worker processes; it is not "
        "ported to paddle_tpu_torch yet (ROADMAP.md). Use chain(*readers) "
        "or xmap_readers, which read on threads")
