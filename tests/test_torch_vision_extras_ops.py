"""The vision and extras op types, the port against the JAX package:
pool3d, affine_grid, grid_sampler, pixel_shuffle, lrn, unfold,
temporal_shift, deformable_conv, psroi_pool, prroi_pool
(paddle_tpu/ops/vision_ops.py) and scatter_nd, gather_tree, hash,
space_to_depth, shuffle_channel, similarity_focus, filter_by_instag,
random_crop, ctc_greedy_decoder, resize_trilinear, cvm,
deformable_roi_pooling (extras_ops.py). Each registry kernel forward and
input gradients on the same inputs (op_library_helpers.compare): f32
rtol 1e-5, atol 1e-5; what only moves or chooses data exactly. Pinned:
a max pool's tie goes to the first element (integer-valued inputs
against ``jax.vjp``), ceil mode's padding, ``resize_trilinear``
shrinking (JAX's antialiased weights, not ``F.interpolate``), ``hash``
with negative and wide ids, bilinear taps landing on integers and off
the map, and ``random_crop``'s one offset per batch (by statistics:
Philox cannot match threefry).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from op_library_helpers import (TorchCtx, compare, f32,
                                registry_flags_match)
from paddle_tpu.ops.registry import get_op as jget
from paddle_tpu_torch.ops.registry import get_op as tget

VISION_OPS = ("pool3d", "affine_grid", "grid_sampler", "pixel_shuffle",
              "lrn", "unfold", "temporal_shift", "deformable_conv",
              "psroi_pool", "prroi_pool")
EXTRAS_OPS = ("scatter_nd", "gather_tree", "hash", "space_to_depth",
              "shuffle_channel", "similarity_focus", "filter_by_instag",
              "random_crop", "ctc_greedy_decoder", "resize_trilinear", "cvm",
              "deformable_roi_pooling")


def _r(seed=0):
    return np.random.RandomState(seed)


def test_registry_flags_match():
    assert len(set(VISION_OPS + EXTRAS_OPS)) == 22
    registry_flags_match(VISION_OPS + EXTRAS_OPS)


# ---- pool3d ---------------------------------------------------------------

@pytest.mark.parametrize("attrs", [
    dict(pooling_type="max", ksize=[2, 2, 2], strides=[2, 2, 2]),
    dict(pooling_type="max", ksize=[3, 3, 2], strides=[2, 1, 2],
         paddings=[1, 1, 0]),
    dict(pooling_type="max", ksize=[3, 3, 3], strides=[2, 2, 2],
         paddings=[1, 0, 1], ceil_mode=True),
    dict(pooling_type="avg", ksize=[3, 3, 3], strides=[2, 2, 2],
         paddings=[1, 1, 1], ceil_mode=True, exclusive=True),
    dict(pooling_type="avg", ksize=[2, 3, 3], strides=[2, 2, 2],
         paddings=[0, 1, 1], exclusive=False),
    dict(pooling_type="avg", ksize=[3, 2, 3], strides=[1, 2, 3],
         ceil_mode=True, exclusive=True),
    dict(pooling_type="max", ksize=[2, 3, 2], adaptive=True),
    dict(pooling_type="avg", ksize=[2, 3, 2], adaptive=True),
    dict(pooling_type="max", global_pooling=True),
    dict(pooling_type="avg", global_pooling=True),
], ids=lambda a: "-".join("%s%s" % (k[:4], v) for k, v in a.items()))
def test_pool3d(attrs):
    x = f32(_r(1), 2, 3, 6, 9, 8)
    compare("pool3d", {"X": [x]}, attrs, diff=[("X", 0)])


@pytest.mark.parametrize("attrs", [
    dict(pooling_type="max", ksize=[2, 2, 2], strides=[2, 2, 2]),
    dict(pooling_type="max", ksize=[3, 3, 3], strides=[2, 2, 2],
         paddings=[1, 1, 1], ceil_mode=True),
    dict(pooling_type="max", ksize=[2, 2, 2], adaptive=True),
    dict(pooling_type="max", global_pooling=True),
])
def test_pool3d_max_ties_take_the_jax_element(attrs):
    """Integer-valued inputs in {0, 1, 2}: most windows hold tied maxima;
    a window's gradient goes where XLA's select-and-scatter sends it (the
    first in raster order), a global or adaptive max shares it as
    ``jnp.max`` does."""
    x = _r(2).randint(0, 3, (2, 2, 4, 6, 4)).astype(np.float32)
    compare("pool3d", {"X": [x]}, attrs, diff=[("X", 0)])


def test_pool3d_ceil_mode_shapes_and_nonfinite_max():
    x = f32(_r(3), 1, 2, 7, 5, 6)
    x[0, 0, 3, 2, 1] = np.nan
    x[0, 1, 0, 0, 0] = np.inf
    attrs = dict(pooling_type="max", ksize=[2, 2, 2], strides=[2, 2, 2],
                 ceil_mode=True)
    got, want = compare("pool3d", {"X": [x]}, attrs)
    assert got["Out"][0].shape == (1, 2, 4, 3, 3)


def test_adaptive_pool3d_needs_divisible_sizes():
    x = torch.zeros(1, 1, 5, 4, 4)
    with pytest.raises(NotImplementedError, match="divisible"):
        tget("pool3d").fn(TorchCtx(), {"X": [x]},
                          {"ksize": [2, 2, 2], "adaptive": True})


# ---- sampling grids -------------------------------------------------------

def test_affine_grid_and_grid_sampler():
    rng = _r(4)
    theta = (np.eye(2, 3)[None] + 0.3 * f32(rng, 3, 2, 3)).astype(
        np.float32)
    attrs = {"output_shape": [3, 2, 5, 7]}
    got, _ = compare("affine_grid", {"Theta": [theta]}, attrs,
                     diff=[("Theta", 0)])
    grid = got["Output"][0] * 1.3               # some points off the map
    x = f32(rng, 3, 2, 6, 8)
    compare("grid_sampler", {"X": [x], "Grid": [grid]}, {},
            diff=[("X", 0), ("Grid", 0)])


def test_grid_sampler_on_integers_and_off_the_map():
    """Points on exact pixel centres (fx = fy = 0: the kinked gradient),
    on the far border and beyond it."""
    h, w = 5, 6
    ys, xs = np.meshgrid(np.arange(-1, h + 1), np.arange(-1, w + 1),
                         indexing="ij")
    grid = np.stack([xs / (w - 1) * 2 - 1, ys / (h - 1) * 2 - 1],
                    -1).astype(np.float32)[None].repeat(2, 0)
    x = f32(_r(5), 2, 3, h, w)
    compare("grid_sampler", {"X": [x], "Grid": [grid]}, {},
            diff=[("X", 0), ("Grid", 0)])


# ---- moves and windows ----------------------------------------------------

def test_pixel_shuffle_space_to_depth_shuffle_channel():
    rng = _r(6)
    compare("pixel_shuffle", {"X": [f32(rng, 2, 12, 3, 4)]},
            {"upscale_factor": 2}, diff=[("X", 0)], exact=("Out",))
    compare("space_to_depth", {"X": [f32(rng, 2, 3, 6, 4)]},
            {"blocksize": 2}, diff=[("X", 0)], exact=("Out",))
    compare("shuffle_channel", {"X": [f32(rng, 2, 12, 3, 2)]},
            {"group": 3}, diff=[("X", 0)], exact=("Out",))


@pytest.mark.parametrize("n", [5, 4])
def test_lrn(n):
    x = f32(_r(7), 2, 7, 4, 3)
    compare("lrn", {"X": [x]}, {"n": n, "k": 2.0, "alpha": 1e-2,
                                "beta": 0.75},
            diff=[("X", 0)], outs=["Out", "MidOut"])


@pytest.mark.parametrize("attrs", [
    dict(kernel_sizes=[3, 3], paddings=[1, 1]),
    dict(kernel_sizes=[2, 3], strides=[2, 1], paddings=[1, 0, 0, 2],
         dilations=[1, 2]),
    dict(kernel_sizes=[3, 2], strides=[1, 2], dilations=[2, 1]),
])
def test_unfold(attrs):
    x = f32(_r(8), 2, 3, 7, 8)
    compare("unfold", {"X": [x]}, attrs, diff=[("X", 0)], exact=("Y",))


@pytest.mark.parametrize("ratio", [0.25, 0.125])
def test_temporal_shift(ratio):
    x = f32(_r(9), 6, 16, 3, 2)
    compare("temporal_shift", {"X": [x]}, {"seg_num": 3,
                                           "shift_ratio": ratio},
            diff=[("X", 0)], exact=("Out",))


# ---- deformable conv ------------------------------------------------------

@pytest.mark.parametrize("groups,dg,masked", [(1, 1, True), (2, 2, True),
                                               (1, 2, False)])
def test_deformable_conv(groups, dg, masked):
    rng = _r(10)
    n, c, h, w, o, k = 2, 4, 6, 7, 6, 3
    x = f32(rng, n, c, h, w)
    offset = (2.0 * f32(rng, n, 2 * dg * k * k, h, w)).astype(np.float32)
    offset[:, ::3] = np.round(offset[:, ::3])      # taps on integers
    offset[:, 1, :2] = -9.0                        # wholly off the map
    filt = f32(rng, o, c // groups, k, k)
    ins = {"Input": [x], "Offset": [offset], "Filter": [filt]}
    diff = [("Input", 0), ("Offset", 0), ("Filter", 0)]
    if masked:
        ins["Mask"] = [rng.uniform(0, 1, (n, dg * k * k, h, w)).astype(
            np.float32)]
        diff.append(("Mask", 0))
    compare("deformable_conv", ins,
            {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
             "groups": groups, "deformable_groups": dg}, diff=diff)


def test_deformable_conv_strided_dilated():
    rng = _r(11)
    x = f32(rng, 1, 2, 9, 8)
    offset = f32(rng, 1, 2 * 9, 4, 2)
    filt = f32(rng, 3, 2, 3, 3)
    compare("deformable_conv", {"Input": [x], "Offset": [offset],
                                "Filter": [filt]},
            {"strides": [2, 2], "paddings": [1, 0], "dilations": [2, 2]},
            diff=[("Input", 0), ("Offset", 0), ("Filter", 0)])


# ---- RoI poolings ---------------------------------------------------------

def _rois(rng, r, h, w, scale):
    x1 = rng.uniform(-2, w / scale * 0.6, r)
    y1 = rng.uniform(-2, h / scale * 0.6, r)
    bw = rng.uniform(0.5, w / scale * 0.7, r)
    bh = rng.uniform(0.5, h / scale * 0.7, r)
    return np.stack([x1, y1, x1 + bw, y1 + bh], 1).astype(np.float32)


@pytest.mark.parametrize("batched", [False, True])
def test_psroi_pool(batched):
    rng = _r(12)
    n, oc, ph, pw, h, w = 2, 3, 2, 3, 7, 9
    x = f32(rng, n, oc * ph * pw, h, w)
    rois = _rois(rng, 5, h, w, 0.5)
    ins = {"X": [x], "ROIs": [rois]}
    if batched:
        ins["RoisNum"] = [np.array([2, 3], np.int32)]
    compare("psroi_pool", ins, {"output_channels": oc, "spatial_scale": 0.5,
                                "pooled_height": ph, "pooled_width": pw},
            diff=[("X", 0)])


@pytest.mark.parametrize("batched", [False, True])
def test_prroi_pool(batched):
    rng = _r(13)
    n, c, h, w = 2, 4, 8, 6
    x = f32(rng, n, c, h, w)
    rois = _rois(rng, 6, h, w, 0.25)
    rois[0] = [0.0, 0.0, 4 * (w - 1), 4 * (h - 1)]    # the whole map
    ins = {"X": [x], "ROIs": [rois]}
    if batched:
        ins["BatchRoINums"] = [np.array([4, 2], np.int32)]
    compare("prroi_pool", ins, {"spatial_scale": 0.25, "pooled_height": 3,
                                "pooled_width": 2}, diff=[("X", 0)])


@pytest.mark.parametrize("ps", [True, False])
def test_deformable_roi_pooling(ps):
    rng = _r(14)
    n, ph, pw, h, w = 2, 2, 3, 7, 8
    c = ph * pw * 2
    x = f32(rng, n, c, h, w)
    rois = np.concatenate([rng.randint(0, n, (5, 1)).astype(np.float32),
                           _rois(rng, 5, h, w, 0.5)], 1)
    trans = f32(rng, 5, 2, ph, pw)
    trans[0] = 50.0                                # clipped to the border
    trans[1] = 0.0
    compare("deformable_roi_pooling",
            {"Input": [x], "ROIs": [rois], "Trans": [trans]},
            {"spatial_scale": 0.5, "pooled_height": ph, "pooled_width": pw,
             "trans_std": 0.1, "position_sensitive": ps},
            diff=[("Input", 0), ("Trans", 0)])


def test_deformable_roi_pooling_centres_on_the_clip_bound():
    """A bin centre clipped exactly onto the map's edge: ``jnp.clip``'s
    gradient there is 1/2, which the port keeps."""
    x = f32(_r(15), 1, 4, 5, 5)
    rois = np.array([[0, 0.0, 0.0, 4.0, 4.0]], np.float32)
    # centres at 1 and 3 (bin 2 wide); trans moving 1 -> 0 and 3 -> 4
    trans = np.array([[[[-2.5, 2.5], [0.0, 0.0]],
                       [[-2.5, 0.0], [2.5, 0.0]]]], np.float32)
    compare("deformable_roi_pooling",
            {"Input": [x], "ROIs": [rois], "Trans": [trans]},
            {"pooled_height": 2, "pooled_width": 2, "trans_std": 0.1},
            diff=[("Input", 0), ("Trans", 0)])


# ---- the extras -----------------------------------------------------------

def test_scatter_nd_repeats_negatives_and_out_of_range():
    rng = _r(16)
    idx = rng.randint(-6, 6, (40, 2)).astype(np.int64)
    idx[::5] = [2, 3]                              # a hot coordinate
    idx[3] = [9, 0]                                # dropped
    upd = f32(rng, 40, 3)
    compare("scatter_nd", {"Index": [idx], "Updates": [upd]},
            {"shape": [6, 5, 3]}, diff=[("Updates", 0)])


def test_gather_tree():
    rng = _r(17)
    t, b, w = 6, 3, 4
    ids = rng.randint(0, 50, (t, b, w)).astype(np.int64)
    parents = rng.randint(0, w, (t, b, w)).astype(np.int64)
    compare("gather_tree", {"Ids": [ids], "Parents": [parents]}, {},
            exact=("Out",))


def test_hash_negative_and_wide_ids():
    rng = _r(18)
    x = rng.randint(-2 ** 31, 2 ** 31 - 1, (7, 3, 2)).astype(np.int64)
    x[0, 0] = [-1, -7]
    x[1, 0] = [2 ** 31 - 1, 0]
    got, _ = compare("hash", {"X": [x]}, {"mod_by": 1000003, "num_hash": 4},
                     exact=("Out",))
    assert got["Out"][0].shape == (7, 3, 4, 1)
    # ids past int32 wrap to their low 32 bits, as a uint32 cast does
    wide = x + (np.int64(5) << np.int64(32))
    again = tget("hash").fn(TorchCtx(), {"X": [torch.from_numpy(wide)]},
                            {"mod_by": 1000003, "num_hash": 4})["Out"]
    np.testing.assert_array_equal(again.numpy(), got["Out"][0])


@pytest.mark.parametrize("axis", [1, 2])
def test_similarity_focus(axis):
    rng = _r(19)
    x = rng.randint(0, 4, (3, 4, 5, 6)).astype(np.float32)   # many ties
    compare("similarity_focus", {"X": [x]},
            {"axis": axis, "indexes": [0, 2]}, exact=("Out",))


def test_filter_by_instag():
    rng = _r(20)
    rows = f32(rng, 9, 4)
    tags = rng.randint(0, 12, (9, 3)).astype(np.int64)
    filt = np.array([1, 5, 7], np.int64)
    compare("filter_by_instag", {"Ins": [rows], "Ins_tag": [tags],
                                 "Filter_tag": [filt]}, {},
            exact=("Out", "LossWeight", "IndexMap"))


@pytest.mark.parametrize("lengths", [False, True])
def test_ctc_greedy_decoder(lengths):
    rng = _r(21)
    probs = rng.randint(0, 3, (4, 12, 5)).astype(np.float32)  # ties
    ins = {"Input": [probs]}
    if lengths:
        ins["Length"] = [np.array([12, 0, 5, 9], np.int64)]
    compare("ctc_greedy_decoder", ins, {"blank": 0, "padding_value": -1},
            exact=("Out", "OutLength"))


@pytest.mark.parametrize("out_shape", [(6, 8, 10), (2, 2, 3), (3, 7, 5),
                                       (4, 4, 5)])
def test_resize_trilinear(out_shape):
    """Up, down (JAX antialiases: not F.interpolate's answer), mixed, and
    an axis left alone."""
    x = f32(_r(22), 2, 3, 4, 5, 5)
    got, _ = compare("resize_trilinear", {"X": [x]},
                     {"out_shape": list(out_shape)}, diff=[("X", 0)])
    if out_shape == (2, 2, 3):
        plain = torch.nn.functional.interpolate(
            torch.from_numpy(x), size=out_shape, mode="trilinear",
            align_corners=False).numpy()
        assert np.abs(plain - got["Out"][0]).max() > 1e-2


@pytest.mark.parametrize("use_cvm", [True, False])
def test_cvm(use_cvm):
    rng = _r(23)
    x = f32(rng, 6, 7)
    cvm = rng.randint(0, 30, (6, 2)).astype(np.float32)
    diff = [("X", 0), ("CVM", 0)] if use_cvm else [("X", 0)]
    compare("cvm", {"X": [x], "CVM": [cvm]}, {"use_cvm": use_cvm},
            diff=diff)


def test_random_crop_draws_one_offset_per_batch():
    """Every example of a batch is cropped at the same offsets (the JAX
    package's draw), and the offsets are uniform over the valid range."""
    h, w, oh, ow = 9, 7, 4, 3
    x = np.arange(5 * 2 * h * w, dtype=np.float32).reshape(5, 2, h, w)
    fn = tget("random_crop").fn
    starts = []
    for seed in range(400):
        out = fn(TorchCtx(seed), {"X": [torch.from_numpy(x)]},
                 {"shape": [oh, ow]})["Out"].numpy()
        assert out.shape == (5, 2, oh, ow)
        y0, x0 = divmod(int(out[0, 0, 0, 0]), w)
        np.testing.assert_array_equal(out, x[:, :, y0:y0 + oh, x0:x0 + ow])
        starts.append((y0, x0))
    starts = np.array(starts)
    for d, (size, crop) in enumerate(((h, oh), (w, ow))):
        k = size - crop + 1
        counts = np.bincount(starts[:, d], minlength=k)
        assert counts.size == k
        expect = len(starts) / k
        assert np.all(np.abs(counts - expect) <=
                      5 * np.sqrt(expect * (1 - 1 / k))), counts
    # the JAX op's contract is the same: one window for the batch
    class _JCtx(object):
        def rng(self):
            return jax.random.PRNGKey(3)
    jout = np.asarray(jget("random_crop").fn(
        _JCtx(), {"X": [jnp.asarray(x)]}, {"shape": [oh, ow]})["Out"])
    y0, x0 = divmod(int(jout[0, 0, 0, 0]), w)
    np.testing.assert_array_equal(jout, x[:, :, y0:y0 + oh, x0:x0 + ow])
