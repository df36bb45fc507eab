"""The Transformer slice: its eight new ops, its five programs, training,
greedy and beam-search decode and serving, the port against the JAX
package.

Ops: each built through the public ``layers`` API of both packages (the
sinusoid op through each package's ``transformer._pos_enc``), run with
each package's ``Executor(CPUPlace())`` on the same numpy feeds. Ops
that move or select data (fill, expand, arg_max, top_k, one_hot, an
integer cumsum) must agree exactly; the float ones are f32 on both sides,
one op, so only the order of a sum or a libm's last bit differs: rtol
1e-5, atol 1e-6 (the sinusoids atol 1e-5: sin and cos of angles up to
~40 rad, each package's own libm). Gradients where the op has one.

Programs: the train program, greedy and beam decode with and without
the K/V cache serialize the same in both packages (op types and counts,
attrs, var and parameter names).

A narrow model (d_model 32, 4 heads, 2 + 2 layers, vocab 64) runs from
the JAX startup's weights copied into the port. Training: three Adam
steps at dropout 0, losses rtol 1e-5; parameters rtol 1e-5, atol 1e-5,
but for the attention key biases, whose gradient is 0 in exact
arithmetic (a per-query constant added to every logit) and so only
rounding noise: Adam moves them by about lr a step on its sign, and they
are held to steps * lr. Decode: the cached greedy and beam programs give
the JAX package's ids exactly and its scores within rtol 1e-5; every
fetched integer tensor is int64 where JAX (without x64) has int32, the
float ones float32 in both. In the port the cached decode equals the
re-decode (ids exactly, scores rtol 1e-5), as tests/test_models.py holds
it in JAX, and the Predictor's beam answers at batch 3 (bucket 4) equal
Executor.run's at batch 3.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import io as jio
from paddle_tpu import optimizer as jopt
from paddle_tpu.models import transformer as jtr
from paddle_tpu_torch.models import transformer as ttr
from test_torch_gpt import _normalized
from test_torch_ops import _build, _cots, _grad_data, _run_both, \
    _with_grads, _x

LR, STEPS = 1e-3, 3
SRC, OUT, BEAM = 8, 6, 3
EXACT = dict(exact=True)


def _data(p, name, shape, dtype="float32"):
    return p.layers.data(name, list(shape), dtype=dtype,
                         append_batch_size=False)


def _helper(p):
    if p is pt:
        from paddle_tpu.layer_helper import LayerHelper
    else:
        from paddle_tpu_torch.layer_helper import LayerHelper
    return LayerHelper


def _ids(shape, lo, hi, seed=0):
    return np.random.RandomState(seed).randint(lo, hi, shape).astype(
        np.int64)


# ---------------------------------------------------------------------------
# the eight ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,value,in_idx,out_idx", [
    ("int64", 0.0, 0, 0), ("float32", 1.0, 0, 0),
    ("float32", -1e9, 1, 2)])
def test_fill_constant_batch_size_like(dtype, value, in_idx, out_idx):
    shape = [4, 1, 2]
    shape[out_idx] = -1

    def build(p):
        x = _data(p, "x", (3, 5, 2))
        return [p.layers.fill_constant_batch_size_like(
            x, shape, dtype, value, input_dim_idx=in_idx,
            output_dim_idx=out_idx)]
    _, (out,) = _run_both(build, {"x": _x((3, 5, 2))}, **EXACT)
    shape[out_idx] = (3, 5, 2)[in_idx]
    assert out.dtype == np.dtype(dtype) and list(out.shape) == shape
    assert (out == np.array(value, out.dtype)).all()


@pytest.mark.parametrize("times", [(1, 3, 1, 1), (2, 1, 2, 1)])
def test_expand_tiles_and_its_gradient_sums(times):
    shape = (2, 1, 3, 2)

    def build(p):
        x = _grad_data(p, "x", shape)
        return _with_grads(p, [p.layers.expand(x, list(times))], [x])
    n = int(np.prod(shape) * np.prod(times))
    _run_both(build, dict({"x": _x(shape)}, **_cots(n)))


def test_expand_is_dense_memory():
    """The beam program reshapes the tiled operand and feeds it to the
    flash kernel as a mask: the result must own its elements."""
    from paddle_tpu_torch.ops.registry import get_op
    import torch
    x = torch.arange(6.0).reshape(1, 2, 3)
    out = get_op("expand").fn(None, {"X": [x]},
                              {"expand_times": [4, 1, 1]})["Out"]
    assert out.is_contiguous() and out.stride() == (6, 3, 1)
    assert out.untyped_storage().data_ptr() != x.untyped_storage().data_ptr()


def test_arg_max_and_top_k_take_the_lowest_index_on_ties():
    x = np.array([[1.0, 3.0, 3.0, 0.5, 3.0, -2.0, 3.0, 1.0],
                  [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                  [-1e9, -1e9, -3.0, -1e9, -0.0, 0.0, -1e9, -3.0]],
                 np.float32)

    def build(p):
        v = _data(p, "x", x.shape)
        vals, idx = p.layers.topk(v, k=3)
        return [p.layers.argmax(v, axis=-1), p.layers.argmax(v, axis=0),
                vals, idx]
    jout, tout = _run_both(build, {"x": x}, **EXACT)
    np.testing.assert_array_equal(tout[0], [1, 0, 4])
    # +0.0 ranks above -0.0, as in lax.top_k's total order
    np.testing.assert_array_equal(tout[3], [[1, 2, 4], [0, 1, 2],
                                            [5, 4, 2]])
    assert [t.dtype for t in tout] == [np.int64, np.int64, np.float32,
                                       np.int64]


def test_top_k_ties_at_the_beam_shape():
    """Whole rows at -1e9 (the first beam step's empty beams) and random
    ties among the rest."""
    rng = np.random.RandomState(3)
    x = rng.randint(-4, 4, (5, 3 * 64)).astype(np.float32)
    x[:, 64:] = -1e9

    def build(p):
        return list(p.layers.topk(_data(p, "x", x.shape), k=3))
    _run_both(build, {"x": x}, **EXACT)


@pytest.mark.parametrize("axis,exclusive,reverse,flatten", [
    (0, False, False, False), (1, True, False, False),
    (-1, False, True, False), (1, True, True, False),
    (0, True, True, True)])
@pytest.mark.parametrize("dtype", ["float32", "int64"])
def test_cumsum(axis, exclusive, reverse, flatten, dtype):
    """``reverse`` with ``exclusive`` by the JAX op's own arithmetic (the
    reversed inclusive sum minus X)."""
    shape = (3, 4)
    x = _x(shape) if dtype == "float32" else _ids(shape, -5, 5)

    def build(p):
        h = _helper(p)("cumsum")
        v = _data(p, "x", shape, dtype)
        out = h.create_variable_for_type_inference(dtype)
        h.append_op("cumsum", inputs={"X": [v.name]},
                    outputs={"Out": [out.name]},
                    attrs={"axis": axis, "exclusive": exclusive,
                           "reverse": reverse, "flatten": flatten})
        return [out]
    jout, tout = _run_both(build, {"x": x}, exact=dtype == "int64")
    assert tout[0].dtype == np.dtype(dtype)


def test_cumsum_layer_gives_the_beam_row_index():
    def build(p):
        ones = p.layers.fill_constant_batch_size_like(
            _data(p, "x", (5, 2)), [-1, 4], "float32", 1.0)
        return [p.layers.cast(p.layers.scale(
            p.layers.cumsum(ones, axis=0), bias=-1.0), "int64")]
    _, (rows,) = _run_both(build, {"x": _x((5, 2))}, **EXACT)
    np.testing.assert_array_equal(rows, np.repeat(np.arange(5), 4)
                                  .reshape(5, 4))


@pytest.mark.parametrize("axis", [-1, 1])
def test_log_softmax_forward_and_grad(axis):
    shape = (2, 5, 7)

    def build(p):
        x = _grad_data(p, "x", shape)
        return _with_grads(p, [p.layers.log_softmax(x, axis=axis)], [x])
    _run_both(build, dict({"x": _x(shape) * 3}, **_cots(70)))


@pytest.mark.parametrize("prior", [False, True])
def test_label_smooth_forward_and_grad(prior):
    shape = (2, 3, 6)

    def build(p):
        x = _grad_data(p, "x", shape)
        d = _data(p, "prior", (1, 6)) if prior else None
        return _with_grads(p, [p.layers.label_smooth(x, prior_dist=d,
                                                     epsilon=0.1)], [x])
    feed = dict({"x": _x(shape), "prior": np.full((1, 6), 1 / 6.0,
                                                  np.float32)}, **_cots(36))
    _run_both(build, feed)


def test_one_hot_gives_a_zero_row_outside_the_depth():
    """``jax.nn.one_hot``'s rule (``F.one_hot`` would raise)."""
    ids = np.array([[[0], [3], [7]], [[-1], [8], [2]]], np.int64)

    def build(p):
        return [p.layers.one_hot(_data(p, "ids", ids.shape, "int64"), 8)]
    _, (out,) = _run_both(build, {"ids": ids}, **EXACT)
    assert out.shape == (2, 3, 8) and out.dtype == np.float32
    np.testing.assert_array_equal(out.sum(-1), [[1, 1, 1], [0, 0, 1]])
    np.testing.assert_array_equal(out[1, 1], np.zeros(8))


@pytest.mark.parametrize("offset,length", [(0, 7), (5, 1), (31, 1)])
def test_add_position_encoding(offset, length):
    """sin in the first half of the width, cos in the second, positions
    from ``pos_offset`` (a cached decode step's absolute position); the
    gradient to X passes through."""
    shape = (2, length, 16)
    cfg = (None, None)

    def build(p):
        mod = jtr if p is pt else ttr
        x = _grad_data(p, "x", shape)
        return _with_grads(p, [mod._pos_enc(x, cfg, offset)], [x])
    feed = dict({"x": _x(shape)}, **_cots(int(np.prod(shape))))
    jmain, jstart, jfetch = _build(pt, build)
    tmain, tstart, tfetch = _build(ptt, build)
    with pt.scope_guard(pt.Scope()):
        jout = pt.Executor(pt.CPUPlace()).run(jmain, feed=feed,
                                               fetch_list=jfetch)
    tout = ptt.Executor(ptt.CPUPlace()).run(tmain, feed=feed,
                                             fetch_list=tfetch,
                                             scope=ptt.Scope())
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t, np.asarray(j), rtol=1e-5, atol=1e-5)
    pos = np.arange(length)[:, None] + offset
    angle = pos / 10000.0 ** (2 * np.arange(8)[None, :] / 16.0)
    np.testing.assert_allclose(tout[0] - feed["x"],
                               np.concatenate([np.sin(angle),
                                               np.cos(angle)], -1)[None]
                               .repeat(2, 0), atol=1e-5)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _cfg(mod, **kw):
    base = dict(src_vocab=64, trg_vocab=64, d_model=32, d_inner=64,
                n_head=4, n_layer=2, dropout=0.0)
    return mod.TransformerConfig(**dict(base, **kw))


def _program(pkg, mod, kind, use_cache=True, **kw):
    with pkg.unique_name.guard():
        if kind == "train":
            opt = jopt if pkg is pt else ptt.optimizer
            return mod.transformer_train_program(
                _cfg(mod, **kw), SRC, SRC,
                optimizer_fn=lambda loss: opt.Adam(LR).minimize(loss))
        if kind == "greedy":
            return mod.greedy_decode_program(_cfg(mod, **kw), SRC, OUT,
                                             use_cache=use_cache)
        return mod.beam_search_decode_program(_cfg(mod, **kw), SRC, OUT,
                                              beam_size=BEAM,
                                              use_cache=use_cache)


@pytest.mark.parametrize("kind,use_cache", [
    ("train", True), ("greedy", True), ("greedy", False), ("beam", True),
    ("beam", False)])
def test_programs_serialize_equal(kind, use_cache):
    kw = dict(dropout=0.1) if kind == "train" else {}
    j = _program(pt, jtr, kind, use_cache, **kw)
    t = _program(ptt, ttr, kind, use_cache, **kw)
    assert _normalized(t[0]) == _normalized(j[0])
    assert _normalized(t[1]) == _normalized(j[1])
    assert t[2] == j[2]
    assert {k: v.name for k, v in t[3].items()} == \
        {k: v.name for k, v in j[3].items()}


def test_base_programs_op_counts():
    """Transformer-base's programs (the chip run's): op counts of the
    batch-64 train step with Adam and of the 32-token cached beam
    decode, the launches the chip run checks."""
    t = _program(ptt, ttr, "train", d_model=512, d_inner=2048, n_head=8,
                 n_layer=6, src_vocab=30000, trg_vocab=30000, dropout=0.1)
    types = [op.type for op in t[0].global_block().ops]
    assert [types.count(k) for k in ("scaled_dot_product_attention",
                                     "layer_norm", "adam", "dropout")] == \
        [18, 30, 255, 32]
    with ptt.unique_name.guard():
        beam = ttr.beam_search_decode_program(ttr.TransformerConfig(), 64,
                                              32, beam_size=4)
    types = [op.type for op in beam[0].global_block().ops]
    assert (len(types), types.count("scaled_dot_product_attention"),
            types.count("layer_norm")) == (8881, 6 + 31 * 12, 12 + 31 * 18)


def test_tensor_parallel_waits_for_the_multi_gpu_slice():
    with pytest.raises(ptt.NotPortedError, match="multi-GPU slice"):
        ttr.TransformerConfig(tp=True)


def test_synthetic_batch_matches_jax():
    for seed in (0, 2):
        j = jtr.synthetic_batch(_cfg(jtr), 3, 5, 4, seed=seed)
        t = ttr.synthetic_batch(_cfg(ttr), 3, 5, 4, seed=seed)
        assert sorted(j) == sorted(t)
        for k in j:
            np.testing.assert_array_equal(t[k], j[k])


def _started(j, t):
    """Run the JAX startup; copy its persistables into a port scope."""
    jscope, jexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    with pt.scope_guard(jscope):
        jexe.run(j[1])
    params = {v.name: np.asarray(jscope.find_var(v.name))
              for v in j[0].list_vars() if v.persistable}
    tscope = ptt.Scope()
    ptt.set_params_from_numpy(params, t[0], tscope, ptt.CPUPlace())
    return (jscope, jexe), (tscope, ptt.Executor(ptt.CPUPlace()))


def test_training_matches_jax():
    j = _program(pt, jtr, "train")
    t = _program(ptt, ttr, "train")
    (jscope, jexe), (tscope, texe) = _started(j, t)
    feed = jtr.synthetic_batch(_cfg(jtr), 4, SRC, SRC, seed=0)
    feed["trg_mask"][1, 5:] = 0.0          # a padded target row
    feed["src_mask"][2, 6:] = 0.0          # a padded source row
    for _ in range(STEPS):
        with pt.scope_guard(jscope):
            jl, = jexe.run(j[0], feed=feed, fetch_list=[j[3]["loss"]])
        tl, = texe.run(t[0], feed=feed, fetch_list=[t[3]["loss"]],
                       scope=tscope)
        np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-5)
    params = t[0].all_parameters()
    assert len(params) == 87 and all(
        "key_fc.b_0" in p.name for p in params
        if not np.allclose(tscope.find_var(p.name).numpy(),
                           np.asarray(jscope.find_var(p.name)),
                           rtol=1e-5, atol=1e-5))
    for p in params:
        if "key_fc.b_0" in p.name:
            gap = np.abs(tscope.find_var(p.name).numpy() -
                         np.asarray(jscope.find_var(p.name))).max()
            assert gap <= STEPS * LR * 1.01, p.name


def _decode_feed(n, seed=0):
    rng = np.random.RandomState(seed)
    feed = {"src_ids": rng.randint(1, 64, (n, SRC, 1)).astype(np.int64),
            "src_mask": np.ones((n, SRC, 1), np.float32)}
    feed["src_mask"][1, 6:] = 0.0
    return feed


def _int_fetches(program, fetch):
    """The fetch dict's vars; the outputs of the first cumsum, cast,
    fill_constant_batch_size_like and arg_max; and every output from the
    first top_k to the first gather (a beam step's index arithmetic)."""
    names = [fetch[k].name for k in sorted(fetch)]
    seen, in_step = set(), False
    for op in program.global_block().ops:
        first = op.type in ("cumsum", "cast", "arg_max",
                            "fill_constant_batch_size_like") and \
            op.type not in seen
        in_step = in_step or (op.type == "top_k" and "gather" not in seen)
        if first or in_step:
            for slot in sorted(op.outputs):
                names.extend(op.output(slot))
        seen.add(op.type)
        in_step = in_step and op.type != "gather"
    return names


def _jax_decode(kind, save_to=None):
    """The JAX package's cached ``kind`` program from its startup: (its
    program tuple, persistables, ``_int_fetches`` names and answers to
    ``_decode_feed(3)``); with ``save_to`` also saved there as an
    inference model."""
    j = _program(pt, jtr, kind)
    jscope, jexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    names = _int_fetches(j[0], j[3])
    with pt.scope_guard(jscope):
        jexe.run(j[1])
        jout = [np.asarray(o) for o in jexe.run(j[0], feed=_decode_feed(3),
                                                fetch_list=names)]
        if save_to:
            jio.save_inference_model(save_to, j[2],
                                     [j[3]["out_ids"], j[3]["scores"]], jexe,
                                     main_program=j[0])
    params = {v.name: np.asarray(jscope.find_var(v.name))
              for v in j[0].list_vars() if v.persistable}
    return j, params, names, jout


@pytest.fixture(scope="module")
def jax_beam(tmp_path_factory):
    """``_jax_decode("beam")``, saved to a directory, and the directory."""
    path = str(tmp_path_factory.mktemp("jax_beam"))
    return _jax_decode("beam", path) + (path,)


@pytest.mark.parametrize("kind", ["greedy", "beam"])
def test_cached_decode_matches_jax(kind, request):
    j, params, names, jout = request.getfixturevalue("jax_beam")[:4] \
        if kind == "beam" else _jax_decode(kind)
    t = _program(ptt, ttr, kind)
    tscope = ptt.Scope()
    ptt.set_params_from_numpy(params, t[0], tscope, ptt.CPUPlace())
    assert names == _int_fetches(t[0], t[3])
    assert len(names) == (3 if kind == "greedy" else 18)
    tout = ptt.Executor(ptt.CPUPlace()).run(
        t[0], feed=_decode_feed(3), fetch_list=names, scope=tscope)
    for name, a, b in zip(names, jout, tout):
        assert b.shape == a.shape, name
        want = np.int64 if a.dtype == np.int32 else a.dtype
        assert b.dtype == want, (name, a.dtype, b.dtype)
        if a.dtype.kind in "iu" or name == t[3]["out_ids"].name:
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6,
                                       err_msg=name)
    ids = tout[0]
    assert (ids[..., 0, 0] == 0).all()       # BOS first
    if kind == "beam":
        # distinct beams of each row, best first
        scores = tout[1]
        assert (np.diff(scores, axis=1) <= 0).all()
        for row in ids[..., 0]:
            assert len({tuple(b) for b in row}) == BEAM


@pytest.mark.parametrize("kind", ["greedy", "beam"])
def test_cached_decode_equals_redecode_in_the_port(kind):
    cached = _program(ptt, ttr, kind)
    full = _program(ptt, ttr, kind, use_cache=False)
    scope, exe = ptt.Scope(), ptt.Executor(ptt.CPUPlace())
    exe.run(cached[1], scope=scope)
    feed = _decode_feed(3, seed=1)
    names = sorted(cached[3])
    a = exe.run(cached[0], feed=feed,
                fetch_list=[cached[3][n] for n in names], scope=scope)
    b = exe.run(full[0], feed=feed,
                fetch_list=[full[3][n] for n in names], scope=scope)
    np.testing.assert_array_equal(a[names.index("out_ids")],
                                  b[names.index("out_ids")])
    if kind == "beam":
        np.testing.assert_allclose(a[names.index("scores")],
                                   b[names.index("scores")], rtol=1e-5)


def test_predictor_serves_the_beam_program_like_the_executor(tmp_path,
                                                            jax_beam):
    """Saved by the port; batch 3 pads to bucket 4 and is sliced back: ids
    equal to Executor.run's at batch 3, scores within rtol 1e-5. A
    directory the JAX package saved serves in the port with the JAX
    package's ids and scores (rtol 1e-5)."""
    from paddle_tpu_torch.inference import Config, create_predictor
    t = _program(ptt, ttr, "beam")
    scope, exe = ptt.Scope(), ptt.Executor(ptt.CPUPlace())
    exe.run(t[1], scope=scope)
    feed = _decode_feed(3, seed=2)
    fetch = [t[3]["out_ids"], t[3]["scores"]]
    want = exe.run(t[0], feed=feed, fetch_list=fetch, scope=scope)
    with ptt.scope_guard(scope):
        ptt.save_inference_model(str(tmp_path), t[2], fetch, exe,
                                 main_program=t[0])
    config = Config(str(tmp_path))
    config.place = ptt.CPUPlace()
    got = create_predictor(config).run(feed)
    assert got[0].shape == (3, BEAM, OUT, 1) and got[0].dtype == np.int64
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)

    _, _, names, jout, path = jax_beam
    config = Config(path)
    config.place = ptt.CPUPlace()
    got = create_predictor(config).run(_decode_feed(3))
    np.testing.assert_array_equal(got[0], jout[names.index(
        t[3]["out_ids"].name)])
    np.testing.assert_allclose(got[1], jout[names.index(
        t[3]["scores"].name)], rtol=1e-5)
