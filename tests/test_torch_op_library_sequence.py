"""The op library's sequence ops and the sequence layers over them, the
port against the JAX package: sequence_erase, sequence_enumerate,
sequence_slice, sequence_expand_as, sequence_pad_dense, sequence_expand,
sequence_scatter (paddle_tpu/ops/sequence_ops.py:34-186) as registry
kernels forward and gradient (op_library_helpers.compare), and every
layer of layers/sequence_lod.py (dense (N, T, ...) tensors with length
vectors, no LoD) built through ``layers`` in both packages and run by
each Executor on the CPU (``run_pair``), its gradient that of sum_i
<out_i, cot_i>. f32 rtol 1e-5, atol 1e-5; lengths, ids and moved data
exactly.
"""
import numpy as np
import pytest

from op_library_helpers import compare, f32, registry_flags_match
from test_torch_ops import _cots, _data, _grad_data, _with_grads, _x
from test_torch_resnet import run_pair

SEQ_OPS = ("sequence_erase", "sequence_enumerate", "sequence_slice",
           "sequence_expand_as", "sequence_pad_dense", "sequence_expand",
           "sequence_scatter")
LENS = np.array([5, 0, 3, 7], np.int64)


def _tokens(seed=0):
    return np.random.RandomState(seed).randint(0, 6, (4, 7)).astype(np.int64)


@pytest.mark.parametrize("lengths", [False, True])
def test_sequence_erase(lengths):
    ins = {"X": [_tokens()]}
    if lengths:
        ins["Length"] = [LENS]
    compare("sequence_erase", ins, {"tokens": [2, 5], "pad_value": -1},
            exact=("Out", "OutLength"))


@pytest.mark.parametrize("lengths", [False, True])
def test_sequence_enumerate(lengths):
    ins = {"X": [_tokens(1)]}
    if lengths:
        ins["Length"] = [LENS]
    compare("sequence_enumerate", ins, {"win_size": 3, "pad_value": 9},
            exact=("Out",))


@pytest.mark.parametrize("lengths", [False, True])
def test_sequence_slice(lengths):
    rng = np.random.RandomState(2)
    ins = {"X": [f32(rng, 4, 7, 3)],
           "Offset": [np.array([1, 0, -2, 6], np.int64)],
           "SliceLength": [np.array([3, 4, 2, 5], np.int64)]}
    if lengths:
        ins["Length"] = [LENS]
    compare("sequence_slice", ins, {}, diff=[("X", 0)],
            exact=("OutLength",))


@pytest.mark.parametrize("xdim", [2, 3])
def test_sequence_expand_as(xdim):
    rng = np.random.RandomState(3)
    x = f32(rng, 4, 3) if xdim == 2 else f32(rng, 4, 1, 3)
    compare("sequence_expand_as", {"X": [x], "Y": [f32(rng, 4, 7, 3)],
                                   "Length": [LENS]}, {}, diff=[("X", 0)])


@pytest.mark.parametrize("padded_length", [-1, 5, 9])
def test_sequence_pad_dense(padded_length):
    rng = np.random.RandomState(4)
    compare("sequence_pad_dense", {"X": [f32(rng, 4, 7, 2)],
                                   "Length": [LENS]},
            {"pad_value": 0.5, "padded_length": padded_length},
            diff=[("X", 0)], exact=("Length",))


@pytest.mark.parametrize("counts,out_len", [([2, 0, 3, 1], 8),
                                            ([3, 3, 3, 3], 10)])
def test_sequence_expand(counts, out_len):
    """Row repeats packed from the top; the second case overflows the
    capacity. The source rows' gradient sums their repeats."""
    rng = np.random.RandomState(5)
    compare("sequence_expand", {"X": [f32(rng, 4, 3)],
                                "RepeatCounts": [np.array(counts,
                                                          np.int64)]},
            {"out_len": out_len}, diff=[("X", 0)], exact=("OutLength",))


@pytest.mark.parametrize("lengths", [False, True])
def test_sequence_scatter(lengths):
    """Repeated ids within a row add; an id in [-T, 0) wraps, one at T
    or past is dropped."""
    rng = np.random.RandomState(6)
    ids = np.array([[0, 2, 2, 6], [1, 1, 1, 1], [-1, 7, 3, -9],
                    [4, 5, 6, 0]], np.int64)
    ins = {"X": [f32(rng, 4, 7)], "Ids": [ids], "Updates": [f32(rng, 4, 4)]}
    if lengths:
        ins["Length"] = [np.array([4, 2, 4, 0], np.int64)]
    compare("sequence_scatter", ins, {}, diff=[("X", 0), ("Updates", 0)])


def test_flags_match_the_jax_package():
    registry_flags_match(SEQ_OPS)


# ---- the layers of layers/sequence_lod.py --------------------------------

N, T, D = 4, 6, 3
LEN6 = np.array([6, 2, 4, 1], np.int64)


def _seq_feed(n_out):
    return dict({"x": _x((N, T, D)), "lens": LEN6}, **_cots(n_out))


@pytest.mark.parametrize("pool_type", ["sum", "average", "max", "first",
                                       "last"])
@pytest.mark.parametrize("lengths", [False, True])
def test_sequence_pool(pool_type, lengths):
    def build(p):
        x = _grad_data(p, "x", (N, T, D))
        lens = _data(p, "lens", (N,), "int64") if lengths else None
        y = p.layers.sequence_pool(x, pool_type, lengths=lens)
        return _with_grads(p, [y], [x])
    run_pair(build, [_seq_feed(N * D)])


@pytest.mark.parametrize("lengths", [False, True])
def test_sequence_softmax_and_concat(lengths):
    """Softmax over time of (N, T) scores (the masked form adds the mask
    (N, T) to its input, so both packages take 2-D scores there)."""
    def build(p):
        x = _grad_data(p, "x", (N, T))
        lens = _data(p, "lens", (N,), "int64") if lengths else None
        y = p.layers.sequence_softmax(x, lengths=lens)
        z = p.layers.sequence_concat([x, y])
        return _with_grads(p, [y, z], [x])
    run_pair(build, [dict({"x": _x((N, T)), "lens": LEN6},
                          **_cots(N * T, 2 * N * T))])


@pytest.mark.parametrize("lengths", [False, True])
@pytest.mark.parametrize("filter_size,padding_start", [(3, None), (4, -1),
                                                       (2, 0)])
def test_sequence_conv(lengths, filter_size, padding_start):
    """The ``pad`` op's windows, one matmul, the mask (paddle_tpu's
    context convolution); gradients to X, the filter and the bias."""
    def build(p):
        x = _grad_data(p, "x", (N, T, D))
        lens = _data(p, "lens", (N,), "int64") if lengths else None
        y = p.layers.sequence_conv(x, 5, filter_size=filter_size,
                                   padding_start=padding_start,
                                   act="tanh", lengths=lens)
        ws = [v for v in p.default_main_program().global_block()
              .all_parameters()]
        return _with_grads(p, [y], [x] + ws)
    run_pair(build, [_seq_feed(N * T * 5)])


def test_sequence_expand_layers():
    def build(p):
        x = _grad_data(p, "x", (N, D))
        y = _data(p, "y", (N, T, D))
        lens = _data(p, "lens", (N,), "int64")
        cnt = _data(p, "cnt", (N,), "int64")
        a = p.layers.sequence_expand_as(x, y, lengths=lens)
        b, blen = p.layers.sequence_expand(x, cnt, out_len=7)
        return _with_grads(p, [a, b], [x]) + [blen]
    feed = dict({"x": _x((N, D)), "y": _x((N, T, D), 1), "lens": LEN6,
                 "cnt": np.array([2, 0, 3, 1], np.int64)},
                **_cots(N * T * D, 7 * D))
    run_pair(build, [feed])


def test_sequence_pad_unpad_slice_reverse_reshape():
    def build(p):
        x = _grad_data(p, "x", (N, T, D))
        lens = _data(p, "lens", (N,), "int64")
        off = _data(p, "off", (N,), "int64")
        ln = _data(p, "ln", (N,), "int64")
        padded, plen = p.layers.sequence_pad(x, pad_value=-1.0, maxlen=8,
                                             lengths=lens)
        unpadded = p.layers.sequence_unpad(x, lens)
        sliced, slen = p.layers.sequence_slice(x, off, ln)
        rev = p.layers.sequence_reverse(x)
        rev_len = p.layers.sequence_reverse(x, lengths=lens)
        first = p.layers.sequence_first_step(x)
        last = p.layers.sequence_last_step(x)
        reshaped = p.layers.sequence_reshape(x, new_dim=6)
        outs = [padded, unpadded, sliced, rev, rev_len, first, last,
                reshaped]
        return _with_grads(p, outs, [x]) + [plen, slen]
    sizes = [N * 8 * D, N * T * D, N * T * D, N * T * D, N * T * D, N * D,
             N * D, N * T * D]
    feed = dict({"x": _x((N, T, D)), "lens": LEN6,
                 "off": np.array([1, 0, 2, 0], np.int64),
                 "ln": np.array([3, 2, 5, 1], np.int64)}, **_cots(*sizes))
    run_pair(build, [feed])


def test_sequence_last_step_with_lengths():
    """A row's last valid step through ``sequence_slice`` (offset
    length - 1)."""
    def build(p):
        x = _grad_data(p, "x", (N, T, D))
        lens = _data(p, "lens", (N,), "int32")
        return _with_grads(p, [p.layers.sequence_last_step(x, lens)], [x])
    run_pair(build, [dict(_seq_feed(N * D),
                          lens=LEN6.astype(np.int32))])


def test_sequence_erase_enumerate_scatter_layers():
    def build(p):
        ids = _data(p, "ids", (N, T), "int64")
        lens = _data(p, "lens", (N,), "int64")
        erased, elen = p.layers.sequence_erase(ids, [1, 3], lengths=lens)
        enum = p.layers.sequence_enumerate(ids, 2, pad_value=0,
                                           lengths=lens)
        x = _grad_data(p, "x", (N, T))
        pos = _data(p, "pos", (N, 2), "int64")
        upd = _grad_data(p, "upd", (N, 2))
        sc = p.layers.sequence_scatter(x, pos, upd)
        return [erased, elen, enum] + _with_grads(p, [sc], [x, upd])
    feed = dict({"ids": _tokens()[:, :T], "lens": LEN6, "x": _x((N, T)),
                 "pos": np.array([[0, 0], [5, 1], [2, 9], [-1, 3]],
                                 np.int64),
                 "upd": _x((N, 2), 3)}, **_cots(N * T))
    run_pair(build, [feed])
