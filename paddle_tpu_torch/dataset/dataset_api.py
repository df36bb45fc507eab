"""Dataset API (counterpart of paddle_tpu/dataset/dataset_api.py).

Reference parity: python/paddle/fluid/dataset.py (DatasetFactory,
InMemoryDataset, QueueDataset) + framework/data_set.cc. Backed by the
C++ data plane (paddle_tpu_torch/native): InMemoryDataset loads, then
shuffles in host memory with ``random.Random(seed)``; QueueDataset
streams through the C++ ring buffer. Two on-disk formats, sniffed per
file:
  * ptrec binary records (native/dataplane.cc ring-buffer reader)
  * MultiSlot text (native ms_parse_file: the reference
    MultiSlotDataFeed format that incubate.data_generator emits)
Batches are numpy dicts made on the host thread that iterates the
dataset; the Executor copies them to the card.
"""
import random

import numpy as np

from ..native.recordio import RecordReader
from ..native.multislot import MultiSlotTextReader

_PTREC_MAGIC = b"crtp"  # u32 0x70747263 little-endian on disk


class DatasetFactory(object):
    def create_dataset(self, datafeed_class="QueueDataset"):
        if datafeed_class == "InMemoryDataset":
            return InMemoryDataset()
        return QueueDataset()


class DatasetBase(object):
    def __init__(self):
        self._paths = []
        self._batch_size = 1
        self._use_vars = []
        self._slot_dtypes = []
        self._thread = 2
        self._format = "auto"

    def set_filelist(self, filelist):
        self._paths = list(filelist)

    def set_batch_size(self, batch_size):
        self._batch_size = batch_size

    def set_thread(self, thread_num):
        self._thread = thread_num

    def set_use_var(self, var_list):
        self._use_vars = [v.name if hasattr(v, "name") else v
                          for v in var_list]
        # plain string names carry no dtype — leave None so the multislot
        # path (which must know int vs float per slot) raises instead of
        # silently mis-parsing id slots as floats
        self._slot_dtypes = [getattr(v, "dtype", None) for v in var_list]

    def set_length_buckets(self, buckets, by, pad_slots=None):
        """Length-bucketed batching for ragged data.

        Samples are grouped by the length of slot `by` into the smallest
        bucket that fits; each batch's ragged slots pad to the BUCKET
        width, not the global max. Two wins: one stable shape per bucket
        means one Executor graph key (one CUDA graph) per bucket, and no
        work is wasted padding every batch to max_len; the dense+lengths
        answer to the reference's zero-padding LoD kernels
        (sequence_ops/sequence_pool_op.h:29, which walk ragged offsets).

        buckets: ascending capacities, e.g. (32, 64, 128, 256). A sample
        longer than the largest bucket raises a named error.
        by: name of the slot whose length assigns the bucket.
        pad_slots: slots padded to the bucket width (default: [by]);
        each gets a "<name>__lens" int64 vector alongside."""
        bl = sorted(int(b) for b in buckets)
        if not bl:
            raise ValueError("set_length_buckets needs at least one bucket")
        self._buckets = bl
        self._bucket_by = by
        self._bucket_pad = list(pad_slots) if pad_slots is not None \
            else [by]
        if by not in self._bucket_pad:
            self._bucket_pad.append(by)

    def set_data_format(self, fmt):
        """"ptrec" | "multislot_text" | "auto" (default: sniff each
        file's leading magic bytes)."""
        if fmt not in ("ptrec", "multislot_text", "auto"):
            raise ValueError("unknown data format %r" % (fmt,))
        self._format = fmt

    @staticmethod
    def _detect_format(path):
        try:
            with open(path, "rb") as f:
                magic = f.read(4)
        except OSError:
            return "ptrec"
        return "ptrec" if magic == _PTREC_MAGIC else "multislot_text"

    def _multislot_slots(self):
        slots = list(zip(self._use_vars, self._slot_dtypes))
        if not slots or any(d is None for _, d in slots):
            raise ValueError(
                "multislot text needs set_use_var(...) with Variable "
                "objects (or anything carrying .name/.dtype) to declare "
                "the slot order and int/float dtypes")
        return slots

    def _sample_iter(self):
        """Per-file format detection; consecutive same-format files are
        grouped so ptrec runs keep their threaded ring-buffer reads."""
        if self._format == "auto":
            fmts = [self._detect_format(p) for p in self._paths]
        else:
            fmts = [self._format] * len(self._paths)
        runs = []
        for p, f in zip(self._paths, fmts):
            if runs and runs[-1][0] == f:
                runs[-1][1].append(p)
            else:
                runs.append([f, [p]])
        for fmt, paths in runs:
            if fmt == "multislot_text":
                for s in MultiSlotTextReader(
                        paths, self._multislot_slots()).samples():
                    yield s
            else:
                for s in RecordReader(
                        paths, num_threads=self._thread).samples():
                    # normalize to dicts when slot names are declared so
                    # a batch spanning a ptrec/text boundary collates
                    # uniformly
                    if self._use_vars and not isinstance(s, dict):
                        s = dict(zip(self._use_vars, s))
                    yield s

    def _batches(self, sample_iter):
        if getattr(self, "_buckets", None):
            return self._bucketed_batches(sample_iter)
        return self._plain_batches(sample_iter)

    def _plain_batches(self, sample_iter):
        buf = []
        for sample in sample_iter:
            buf.append(sample)
            if len(buf) == self._batch_size:
                yield self._collate(buf)
                buf = []
        if buf:
            yield self._collate(buf)

    def _as_dict(self, sample):
        if isinstance(sample, dict):
            return sample
        if not self._use_vars:
            raise ValueError(
                "length bucketing needs dict samples or set_use_var(...) "
                "to name tuple slots")
        return dict(zip(self._use_vars, sample))

    def _bucketed_batches(self, sample_iter):
        bufs = {b: [] for b in self._buckets}
        by = self._bucket_by
        for sample in sample_iter:
            sample = self._as_dict(sample)
            # every pad slot must fit the assigned bucket: the bucket is
            # picked by the longest one, with a named error past the cap
            ln = max(int(np.asarray(sample[s]).shape[0])
                     for s in self._bucket_pad)
            for b in self._buckets:
                if ln <= b:
                    break
            else:
                longest = max(self._bucket_pad,
                              key=lambda s: np.asarray(sample[s]).shape[0])
                raise ValueError(
                    "sample slot %r has length %d, longer than the "
                    "largest bucket %d"
                    % (longest, np.asarray(sample[longest]).shape[0],
                       self._buckets[-1]))
            bufs[b].append(sample)
            if len(bufs[b]) == self._batch_size:
                yield self._collate(bufs[b], width=b)
                bufs[b] = []
        for b in self._buckets:
            if bufs[b]:
                yield self._collate(bufs[b], width=b)

    def _collate(self, samples, width=None):
        """Stack a batch; ragged slots (variable-length MultiSlot values)
        are padded to the batch max and a "<name>__lens" int64 vector is
        added — the dense+lengths encoding of the reference's LoD batch
        (PORTING.md difference #1). With length bucketing, `width` pins
        the designated pad_slots to the bucket capacity so every batch
        from one bucket has the same shape (one graph key per bucket).
        A "__lens" name the program does not declare is dropped at the
        Executor's feed boundary."""
        if isinstance(samples[0], dict):
            out = {}
            pad_slots = self._bucket_pad if width is not None else ()
            for n in samples[0]:
                cols = [np.asarray(s[n]) for s in samples]
                lens = [c.shape[0] for c in cols]
                pinned = n in pad_slots
                if not pinned and len(set(lens)) == 1:
                    out[n] = np.stack(cols)
                    continue
                w = width if pinned else max(lens)
                padded = np.zeros((len(cols), w) + cols[0].shape[1:],
                                  cols[0].dtype)
                for i, c in enumerate(cols):
                    padded[i, :c.shape[0]] = c
                out[n] = padded
                out[n + "__lens"] = np.asarray(lens, np.int64)
            return out
        if width is not None:
            return self._collate([self._as_dict(s) for s in samples],
                                 width=width)
        cols = list(zip(*samples))
        return {n: np.stack(c)
                for n, c in zip(self._use_vars, cols)}


class QueueDataset(DatasetBase):
    """Streaming dataset: C++ threaded readers + ring buffer (ptrec) or
    the native MultiSlot text parser."""

    def __iter__(self):
        return self._batches(self._sample_iter())


class InMemoryDataset(DatasetBase):
    """Load-then-global-shuffle dataset (reference InMemoryDataset:
    load_into_memory + local/global_shuffle)."""

    def __init__(self):
        super(InMemoryDataset, self).__init__()
        self._samples = []
        self._seed = 0

    def load_into_memory(self):
        self._samples = list(self._sample_iter())

    def local_shuffle(self):
        random.Random(self._seed).shuffle(self._samples)
        self._seed += 1

    def global_shuffle(self, fleet=None):
        # single-host view of the reference's cross-node shuffle: every
        # host holds its own file shards and shuffles them locally
        self.local_shuffle()

    def get_memory_data_size(self):
        return len(self._samples)

    def release_memory(self):
        self._samples = []

    def __iter__(self):
        return self._batches(iter(self._samples))
