"""LoDTensor construction helpers (counterpart of paddle_tpu/lod_tensor.py;
ref python/paddle/fluid/lod_tensor.py).

The reference's LoDTensor couples a flat value buffer with level-of-
detail offsets.  The port's sequence design is dense ``(batch,
max_len, ...)`` + an explicit ``(batch,)`` length vector (see
layers/sequence_lod.py), so here a "LoDTensor" is a small record
carrying exactly that — plus ``recursive_sequence_lengths()`` /
``lod()`` accessors matching the reference reading of the metadata, so
book scripts that build LoDTensors feed straight into the dense kernels.
"""
import numpy as np

__all__ = ["LoDTensor", "create_lod_tensor",
           "create_random_int_lodtensor"]


class LoDTensor(object):
    """Dense padded data + per-sequence lengths (single LoD level; the
    reference's multi-level nesting flattens into repeated expansion —
    sequence_expand covers that path)."""

    def __init__(self, data=None, lengths=None):
        # no-arg form matches fluid.core.LoDTensor(): build empty, then
        # .set(array, place) / .set_recursive_sequence_lengths(lens)
        self.data = np.asarray(data) if data is not None \
            else np.zeros((0,), np.float32)
        if lengths is None:
            lengths = self._dense_lengths()
        self.lengths = np.asarray(lengths, dtype=np.int64)

    def _dense_lengths(self):
        # dense tensor without ragged structure: every row full length
        if self.data.ndim >= 2:
            return [self.data.shape[1]] * self.data.shape[0]
        return []

    def set(self, array, place=None):
        """fluid.core.LoDTensor().set(np_array, place) parity; place is
        ignored — feeds are staged by the Executor."""
        self.data = np.asarray(array)
        if self.lengths.size == 0:
            self.lengths = np.asarray(self._dense_lengths(), np.int64)
        return self

    def set_recursive_sequence_lengths(self, lens):
        """Length-style LoD; nested levels flatten to tokens-per-outer
        sequence, the same rule as create_lod_tensor."""
        if lens and isinstance(lens[0], (list, tuple)):
            if len(lens) > 1:
                flat, outer, merged, i = lens[-1], lens[0], [], 0
                for n in outer:
                    merged.append(int(np.sum(flat[i:i + n])))
                    i += n
                lens = merged
            else:
                lens = lens[0]
        self.lengths = np.asarray(lens, np.int64)
        return self

    def set_lod(self, lod):
        """Offset-style LoD -> lengths (nested levels flatten like
        set_recursive_sequence_lengths)."""
        nested = lod and isinstance(lod[0], (list, tuple))
        levels = [list(np.diff(np.asarray(l, np.int64)))
                  for l in (lod if nested else [lod])]
        return self.set_recursive_sequence_lengths(levels)

    def recursive_sequence_lengths(self):
        return [list(self.lengths)]

    def lod(self):
        """Offset-style LoD, as the reference stores it."""
        return [list(np.concatenate([[0], np.cumsum(self.lengths)]))]

    def shape(self):
        return self.data.shape

    def __array__(self, dtype=None):
        a = self.data
        return a.astype(dtype) if dtype is not None else a


def create_lod_tensor(data, recursive_seq_lens, place=None):
    """Pack ragged rows into the dense+lengths encoding (ref :25).

    ``data`` may be a list of per-sequence lists/arrays, or an ndarray of
    shape (sum(lens), D) to be split per ``recursive_seq_lens`` — both
    reference calling conventions.
    """
    if isinstance(recursive_seq_lens, (list, tuple)) and \
            recursive_seq_lens and \
            isinstance(recursive_seq_lens[0], (list, tuple)):
        if len(recursive_seq_lens) != 1:
            # flatten nested levels: total tokens per outer sequence
            flat = recursive_seq_lens[-1]
            outer = recursive_seq_lens[0]
            lens, i = [], 0
            for n in outer:
                lens.append(int(np.sum(flat[i:i + n])))
                i += n
            recursive_seq_lens = lens
        else:
            recursive_seq_lens = recursive_seq_lens[0]
    lens = [int(l) for l in recursive_seq_lens]

    if isinstance(data, np.ndarray):
        rows = np.split(data, np.cumsum(lens)[:-1], axis=0)
    else:
        rows = [np.asarray(r) for r in data]
        if rows and rows[0].ndim == 1:
            rows = [r[:, None] for r in rows]
    assert len(rows) == len(lens), \
        "rows (%d) vs recursive_seq_lens (%d)" % (len(rows), len(lens))
    max_len = max(lens) if lens else 0
    feat = rows[0].shape[1:] if rows else ()
    out = np.zeros((len(rows), max_len) + tuple(feat), rows[0].dtype
                   if rows else np.float32)
    for i, (r, l) in enumerate(zip(rows, lens)):
        out[i, :l] = r[:l]
    return LoDTensor(out, lens)


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place=None,
                                low=0, high=10):
    """Random-int LoDTensor with the given ragged layout (ref :102)."""
    lens = recursive_seq_lens[0] if (
        recursive_seq_lens and
        isinstance(recursive_seq_lens[0], (list, tuple))) \
        else recursive_seq_lens
    rows = [np.random.randint(low, high + 1,
                              size=(int(l),) + tuple(base_shape))
            for l in lens]
    return create_lod_tensor(rows, [list(lens)], place)
