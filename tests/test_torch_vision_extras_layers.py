"""The layers over the vision and extras ops, the port against the JAX
package: the eleven ``layers/vision.py`` functions of the vision ops and
the 31 of ``layers/extras.py``. Each case builds the same calls through
``layers`` in both packages (same op types), starts both from the JAX
startup's persistables (``deformable_conv``'s filter and bias, the
``WeightNormParamAttr`` fc) and runs each Executor on the CPU on the same
feeds (test_torch_resnet.run_pair), comparing every fetch: outputs and
the gradients of sum_i <out_i, cot_i>; f32 rtol 1e-5, atol 1e-5, ids,
counts and moved data exactly. A training case takes three SGD steps
through the differentiable vision layers from copied weights. Layers
that draw (``random_crop``, the ``*_batch_size_like`` randoms) are held
by shape and range: the draws' statistics are tested in
test_torch_vision_extras_ops.py.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from test_torch_ops import _build, _cots, _data, _grad_data, _with_grads, _x
from test_torch_resnet import run_pair


def _params(p):
    return list(p.default_main_program().global_block().all_parameters())


def _one(build, feed, **kw):
    return run_pair(build, [feed], **kw)


def _grad_case(case, feed, **kw):
    """``case(p)`` -> (outs, differentiated inputs, more fetches): run in
    both packages with the gradients of sum_i <out_i, cot_i>, the
    cotangents sized from a forward run of the port."""
    main, start, fetch = _build(ptt, lambda p: case(p)[0])
    exe, scope = ptt.Executor(ptt.CPUPlace()), ptt.Scope()
    exe.run(start, scope=scope)
    outs = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)

    def build(p):
        o, ins, more = case(p)
        return _with_grads(p, o, ins) + list(more)
    return _one(build, dict(feed, **_cots(*[o.size for o in outs])), **kw)


# ---- layers/vision.py -------------------------------------------------------

def test_pool3d_layers():
    def build(p):
        x = _grad_data(p, "x", (2, 3, 5, 6, 6))
        L = p.layers
        outs = [L.pool3d(x, 2, "max", 2),
                L.pool3d(x, 3, "avg", 2, 1, ceil_mode=True),
                L.pool3d(x, [2, 3, 3], "avg", [1, 2, 2], exclusive=False),
                L.pool3d(x, global_pooling=True, pool_type="avg"),
                L.adaptive_pool3d(L.slice(x, [2], [0], [4]), [2, 3, 2],
                                  "max"),
                L.adaptive_pool3d(L.slice(x, [2], [0], [4]), [1, 2, 3],
                                  "avg")]
        return _with_grads(p, outs, [x])
    tout, _, _ = _one(build, dict({"x": _x((2, 3, 5, 6, 6))},
                                  **_cots(108, 288, 96, 6, 72, 36)))
    assert [t.shape for t in tout[:6]] == [
        (2, 3, 2, 3, 3), (2, 3, 3, 4, 4), (2, 3, 4, 2, 2), (2, 3, 1, 1, 1),
        (2, 3, 2, 3, 2), (2, 3, 1, 2, 3)]


def test_adaptive_pool3d_require_index_raises():
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start):
        x = _data(ptt, "x", (1, 1, 2, 2, 2))
        with pytest.raises(NotImplementedError, match="require_index"):
            ptt.layers.adaptive_pool3d(x, 1, require_index=True)


def test_affine_grid_and_grid_sampler_layers():
    def build(p):
        theta = _grad_data(p, "theta", (2, 2, 3))
        x = _grad_data(p, "x", (2, 3, 6, 7))
        grid = p.layers.affine_grid(theta, [2, 3, 4, 5])
        out = p.layers.grid_sampler(x, grid)
        return _with_grads(p, [grid, out], [theta, x])
    theta = (np.eye(2, 3)[None] + 0.4 * _x((2, 2, 3), 1)).astype(np.float32)
    _one(build, dict({"theta": theta, "x": _x((2, 3, 6, 7))},
                     **_cots(80, 120)))


def test_moving_layers():
    def case(p):
        L = p.layers
        x = _grad_data(p, "x", (2, 8, 4, 6))
        v = _grad_data(p, "v", (6, 8, 3, 2))
        outs = [L.pixel_shuffle(x, 2), L.space_to_depth(x, 2),
                L.shuffle_channel(x, 4), L.temporal_shift(v, 3, 0.25),
                L.unfold(x, [3, 2], strides=[1, 2], paddings=1,
                         dilations=[2, 1]),
                L.lrn(x, n=3, k=1.5, alpha=1e-2, beta=0.5)]
        return outs, [x, v], []
    _grad_case(case, {"x": _x((2, 8, 4, 6)), "v": _x((6, 8, 3, 2))})


@pytest.mark.parametrize("modulated,groups,dg", [(True, 1, 1),
                                                  (False, 2, 2)])
def test_deformable_conv_layer(modulated, groups, dg):
    def build(p):
        x = _grad_data(p, "x", (2, 4, 5, 6))
        off = _grad_data(p, "off", (2, 2 * dg * 9, 5, 6))
        mask = _grad_data(p, "mask", (2, dg * 9, 5, 6)) if modulated \
            else None
        y = p.layers.deformable_conv(x, off, mask, 6, 3, padding=1,
                                     groups=groups, deformable_groups=dg,
                                     modulated=modulated)
        ins = [x, off] + ([mask] if modulated else [])
        return _with_grads(p, [y], ins + _params(p))
    rng = np.random.RandomState(3)
    feed = {"x": _x((2, 4, 5, 6)),
            "off": (1.5 * _x((2, 2 * dg * 9, 5, 6), 1)).astype(np.float32),
            "mask": rng.rand(2, dg * 9, 5, 6).astype(np.float32)}
    if not modulated:
        del feed["mask"]
    _one(build, dict(feed, **_cots(360)))


def _rois(n, seed):
    rng = np.random.RandomState(seed)
    x1, y1 = rng.uniform(0, 10, n), rng.uniform(0, 8, n)
    return np.stack([x1, y1, x1 + rng.uniform(2, 14, n),
                     y1 + rng.uniform(2, 10, n)], 1).astype(np.float32)


def test_roi_pool_layers():
    def build(p):
        x = _grad_data(p, "x", (1, 2 * 2 * 3, 9, 10))
        rois = _data(p, "rois", (4, 4))
        nums = _data(p, "nums", (1,), "int32")
        outs = [p.layers.psroi_pool(x, rois, 2, 0.5, 2, 3),
                p.layers.prroi_pool(x, rois, 0.5, 3, 2, batch_roi_nums=nums),
                p.layers.prroi_pool(x, rois, 0.5, 2, 2)]
        return _with_grads(p, outs, [x])
    _one(build, dict({"x": _x((1, 12, 9, 10)), "rois": _rois(4, 0),
                      "nums": np.array([4], np.int32)},
                     **_cots(48, 288, 192)))


def test_vision_layers_train():
    """Three SGD steps through deformable_conv, lrn, pool3d,
    pixel_shuffle, unfold and an fc with a WeightNormParamAttr, from the
    JAX startup's weights: the losses and the updated parameters."""
    def build(p):
        L = p.layers
        x = _data(p, "x", (2, 4, 6, 6))
        off = _data(p, "off", (2, 18, 6, 6))
        y = L.deformable_conv(x, off, None, 8, 3, padding=1,
                              modulated=False)
        y = L.lrn(L.relu(y), n=3)
        y = L.pixel_shuffle(y, 2)                          # (2, 2, 12, 12)
        y = L.pool3d(L.reshape(y, [2, 1, 2, 12, 12]), [1, 2, 2], "max",
                     [1, 2, 2])
        y = L.unfold(L.reshape(y, [2, 2, 6, 6]), 2, strides=2)
        logits = L.fc(L.reshape(y, [2, 72]), 3,
                      param_attr=p.WeightNormParamAttr(name="wn_w"))
        loss = L.mean(L.softmax_with_cross_entropy(
            logits, _data(p, "label", (2, 1), "int64")))
        p.optimizer.SGD(0.5).minimize(loss)
        return [loss] + _params(p)
    feed = {"x": _x((2, 4, 6, 6)),
            "off": _x((2, 18, 6, 6), 1),
            "label": np.array([[1], [2]], np.int64)}
    tout, _, _ = run_pair(build, [feed] * 3)
    assert len(tout) == 1 + 4


# ---- layers/extras.py -------------------------------------------------------

def test_extras_dense_layers():
    """add_position_encoding, affine_channel, fsp_matrix,
    continuous_value_model, dice_loss, expand_as, pad_constant_like,
    strided_slice, sum, im2sequence, image_resize_short and
    resize_trilinear (shrinking: the antialiased weights)."""
    def case(p):
        L = p.layers
        x = _grad_data(p, "x", (2, 3, 4, 4))
        s = _grad_data(p, "s", (3,))
        b = _grad_data(p, "b", (3,))
        seq = _grad_data(p, "seq", (2, 5, 6))
        emb = _grad_data(p, "emb", (4, 7))
        cvm = _data(p, "cvm", (4, 2))
        prob = _grad_data(p, "prob", (4, 3))
        lab = _data(p, "lab", (4, 1), "int64")
        small = _grad_data(p, "small", (2, 3, 2, 3))
        vol = _grad_data(p, "vol", (1, 2, 4, 6, 6))
        outs = [L.add_position_encoding(seq, 0.5, 2.0),
                L.affine_channel(x, s, b, act="relu"),
                L.fsp_matrix(x, L.scale(x, 2.0)),
                L.continuous_value_model(emb, cvm, True),
                L.continuous_value_model(emb, cvm, False),
                L.dice_loss(prob, lab),
                L.expand_as(L.slice(x, [0], [0], [1]), x),
                L.pad_constant_like(x, small, 0.5),
                L.strided_slice(x, [1, 3], [2, 0], [0, 4], [-1, 2]),
                L.sum([x, x, L.scale(x, 3.0)]),
                L.im2sequence(x, 2, 2),
                L.image_resize_short(x, 6),
                L.resize_trilinear(vol, [2, 3, 4]),
                L.resize_trilinear(vol, [5, 9, 6])]
        return outs, [x, s, b, seq, emb, prob, small, vol], []
    cvm = np.abs(_x((4, 2), 3)) * 10
    feed = {"x": _x((2, 3, 4, 4)), "s": _x((3,), 1), "b": _x((3,), 2),
            "seq": _x((2, 5, 6), 4), "emb": _x((4, 7), 5), "cvm": cvm,
            "prob": np.abs(_x((4, 3), 6)), "lab": np.array([[0], [2], [1],
                                                            [2]]),
            "small": _x((2, 3, 2, 3), 7), "vol": _x((1, 2, 4, 6, 6), 8)}
    _grad_case(case, feed)


def test_extras_index_layers():
    """scatter_nd, gather_tree, hash, ctc_greedy_decoder,
    similarity_focus, filter_by_instag, shard_index, rank and size."""
    def case(p):
        L = p.layers
        idx = _data(p, "idx", (6, 1), "int64")
        upd = _grad_data(p, "upd", (6, 4))
        ids = _data(p, "ids", (5, 2, 3), "int64")
        par = _data(p, "par", (5, 2, 3), "int64")
        hid = _data(p, "hid", (4, 2), "int64")
        probs = _data(p, "probs", (3, 7, 4))
        lens = _data(p, "lens", (3,), "int64")
        sim = _data(p, "sim", (2, 3, 4, 5))
        rows = _data(p, "rows", (5, 3))
        tags = _data(p, "tags", (5, 2), "int64")
        filt = _data(p, "filt", (2,), "int64")
        shard = _data(p, "shard", (6, 1), "int64")
        dec, dlen = L.ctc_greedy_decoder(probs, 0, lens)
        fout, fw, fmap = L.filter_by_instag(rows, tags, filt)
        outs = [L.scatter_nd(idx, upd, [5, 4]),
                L.gather_tree(ids, par), L.hash(hid, 997, 3),
                dec, dlen, L.similarity_focus(sim, 1, [0, 2]),
                fout, fw, fmap, L.shard_index(shard, 20, 3, 1),
                L.rank(sim), L.size(sim)]
        return outs[:1], [upd], outs[1:]
    rng = np.random.RandomState(9)
    feed = {"idx": np.array([[0], [4], [4], [-1], [2], [7]]),
            "upd": _x((6, 4)),
            "ids": rng.randint(0, 9, (5, 2, 3)),
            "par": rng.randint(0, 3, (5, 2, 3)),
            "hid": rng.randint(-50, 50, (4, 2)),
            "probs": rng.randint(0, 3, (3, 7, 4)).astype(np.float32),
            "lens": np.array([7, 3, 0]),
            "sim": rng.randint(0, 3, (2, 3, 4, 5)).astype(np.float32),
            "rows": _x((5, 3), 1), "tags": rng.randint(0, 6, (5, 2)),
            "filt": np.array([1, 4]), "shard": rng.randint(0, 20, (6, 1))}
    _grad_case(case, feed, exact=False)


def test_deformable_roi_pooling_layer():
    def case(p):
        L = p.layers
        x = _grad_data(p, "x", (2, 8, 7, 9))
        rois = _data(p, "rois", (3, 5))
        trans = _grad_data(p, "trans", (3, 2, 2, 2))
        outs = [L.deformable_roi_pooling(x, rois, trans, spatial_scale=0.5,
                                         pooled_height=2, pooled_width=2,
                                         position_sensitive=True),
                L.deformable_roi_pooling(x, rois, trans, spatial_scale=0.5,
                                         pooled_height=2, pooled_width=2)]
        return outs, [x, trans], []
    rois = np.concatenate([np.array([[0], [1], [1]], np.float32),
                           _rois(3, 2)], 1)
    _grad_case(case, {"x": _x((2, 8, 7, 9)), "rois": rois,
                      "trans": _x((3, 2, 2, 2), 1)})


def test_deformable_roi_pooling_no_trans_reduces_to_the_roi_pools():
    for pkg in (pt, ptt):
        main, start = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, start):
            x = _data(pkg, "x", (1, 8, 7, 9))
            rois = _data(pkg, "rois", (3, 4))
            pkg.layers.deformable_roi_pooling(
                x, rois, None, no_trans=True, pooled_height=2,
                pooled_width=2, position_sensitive=True)
            pkg.layers.deformable_roi_pooling(
                x, rois, None, no_trans=True, pooled_height=2,
                pooled_width=2)
        assert [op.type for op in main.global_block().ops] == \
            ["psroi_pool", "prroi_pool"]


def test_identity_and_random_extras():
    """lod_reset, lod_append and the SelectedRows helpers hand their
    input back; random_crop and the *_batch_size_like randoms give their
    shapes and ranges."""
    main, start, fetch = _build(ptt, lambda p: [
        p.layers.random_crop(_data(p, "img", (4, 3, 9, 8)), [3, 5, 6]),
        p.layers.gaussian_random_batch_size_like(
            _data(p, "like", (6, 2)), [1, 5], seed=3),
        p.layers.uniform_random_batch_size_like(
            _data(p, "like2", (7, 2)), [2, 1], output_dim_idx=1, min=2.0,
            max=3.0)])
    x = main.global_block().var("img")
    L = ptt.layers
    assert L.lod_reset(x) is x and L.lod_append(x, 1) is x
    assert L.get_tensor_from_selected_rows(x) is x
    assert L.merge_selected_rows(x) is x
    exe = ptt.Executor(ptt.CPUPlace())
    img = np.arange(4 * 3 * 9 * 8, dtype=np.float32).reshape(4, 3, 9, 8)
    crop, g, u = exe.run(main, feed={"img": img,
                                     "like": np.zeros((6, 2), np.float32),
                                     "like2": np.zeros((7, 2), np.float32)},
                         fetch_list=fetch, scope=ptt.Scope())
    assert crop.shape == (4, 3, 5, 6) and g.shape == (6, 5) and \
        u.shape == (2, 7)
    y0, x0 = divmod(int(crop[0, 0, 0, 0]), 8)
    np.testing.assert_array_equal(crop, img[:, :, y0:y0 + 5, x0:x0 + 6])
    assert ((u >= 2.0) & (u < 3.0)).all()
