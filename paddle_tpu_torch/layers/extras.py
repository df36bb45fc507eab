"""The rest of the reference layers/nn.py public surface (counterpart of
paddle_tpu/layers/extras.py, the same signatures).

Reference parity: python/paddle/fluid/layers/nn.py — each function cites
its reference name; kernels live in ops/extras_ops.py where a composition
of existing ops does not suffice. SelectedRows-specific helpers are
identity by design (gradients are dense; there is no SelectedRows
format).
"""
import math

import numpy as np

from ..layer_helper import LayerHelper
from ..framework.program import default_main_program
from . import tensor as T
from .nn import (reduce_sum, elementwise_mul, elementwise_add,
                 elementwise_sub, elementwise_div, one_hot, reshape,
                 transpose, matmul, scale, cast)

__all__ = [
    "add_position_encoding", "affine_channel", "continuous_value_model",
    "ctc_greedy_decoder", "deformable_roi_pooling", "dice_loss",
    "expand_as", "filter_by_instag", "fsp_matrix", "gather_tree",
    "gaussian_random_batch_size_like", "get_tensor_from_selected_rows",
    "hash", "im2sequence", "image_resize_short", "lod_append", "lod_reset",
    "merge_selected_rows", "pad_constant_like", "random_crop", "rank",
    "resize_trilinear", "scatter_nd", "shard_index", "shuffle_channel",
    "similarity_focus", "size", "space_to_depth", "strided_slice", "sum",
    "uniform_random_batch_size_like",
]


def _append(op_type, inputs, out_dtype, attrs=None, n_out=1,
            out_slots=("Out",), out_dtypes=None, name=None,
            out_shapes=None):
    helper = LayerHelper(op_type, name=name)
    out_dtypes = out_dtypes or [out_dtype] * n_out
    out_shapes = out_shapes or [None] * n_out
    outs = [helper.create_variable_for_type_inference(dt, shape=sh)
            for dt, sh in zip(out_dtypes, out_shapes)]
    helper.append_op(op_type,
                     inputs={k: [v.name for v in vs]
                             for k, vs in inputs.items()},
                     outputs={s: [o.name] for s, o in zip(out_slots, outs)},
                     attrs=attrs or {})
    return outs[0] if n_out == 1 else outs


# ---- simple metadata / elementwise -------------------------------------

def rank(input):
    """Static rank as a (1,) int32 constant (ref nn.py rank)."""
    return T.fill_constant([1], "int32", len(input.shape))


def size(input):
    """Total element count as a (1,) int64 constant (ref nn.py size)."""
    n = 1
    for s in input.shape:
        if s in (None, -1):
            raise ValueError("size() needs fully static shapes")
        n *= s
    return T.fill_constant([1], "int64", n)


def sum(x):
    """Elementwise sum of a list of tensors (ref nn.py sum op)."""
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    helper = LayerHelper("sum")
    out = helper.create_variable_for_type_inference(xs[0].dtype)
    helper.append_op("sum", inputs={"X": [v.name for v in xs]},
                     outputs={"Out": [out.name]})
    return out


def expand_as(x, target_tensor, name=None):
    """Broadcast x to target's shape (ref nn.py expand_as)."""
    return _append("expand_as",
                   {"X": [x], "target_tensor": [target_tensor]},
                   x.dtype, name=name)


def strided_slice(input, axes, starts, ends, strides):
    """ref nn.py strided_slice."""
    return _append("strided_slice", {"Input": [input]}, input.dtype,
                   attrs={"axes": list(axes), "starts": list(starts),
                          "ends": list(ends), "strides": list(strides)})


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    """Map ids into shard-local ids; ids outside this shard become
    ignore_value (ref nn.py shard_index)."""
    if not 0 <= shard_id < nshards:
        raise ValueError("shard_id %d out of range [0, %d)"
                         % (shard_id, nshards))
    from .control_flow import less_than, logical_and, greater_equal
    from .nn import where
    shard_size = (index_num + nshards - 1) // nshards
    lo = T.fill_constant([1], str(input.dtype), shard_id * shard_size)
    hi = T.fill_constant([1], str(input.dtype),
                         (shard_id + 1) * shard_size)
    in_shard = logical_and(less_than(input, hi),
                           greater_equal(input, lo))
    local = elementwise_sub(input, lo)
    ign = scale(T.ones_like(input), scale=0.0, bias=float(ignore_value))
    return where(in_shard, local, cast(ign, str(input.dtype)))


# ---- losses / feature transforms ---------------------------------------

def dice_loss(input, label, epsilon=1e-5):
    """1 - 2*|X∩Y| / (|X|+|Y|) over one-hot labels (ref nn.py dice_loss:
    input (N, ..., C) probabilities, label (N, ..., 1) int)."""
    depth = int(input.shape[-1])
    lab = one_hot(reshape(label, list(label.shape[:-1])), depth)
    reduce_dims = list(range(1, len(input.shape)))
    inter = reduce_sum(elementwise_mul(input, lab), dim=reduce_dims)
    union = elementwise_add(reduce_sum(input, dim=reduce_dims),
                            reduce_sum(lab, dim=reduce_dims))
    dice = elementwise_div(scale(inter, scale=2.0),
                           scale(union, bias=epsilon))
    from .nn import reduce_mean
    return reduce_mean(scale(dice, scale=-1.0, bias=1.0))


def add_position_encoding(input, alpha=1.0, beta=1.0, name=None):
    """out = alpha*x + beta*sinusoidal_PE (ref nn.py
    add_position_encoding); input (N, T, D)."""
    _, t, d = input.shape
    pos = np.arange(t)[:, None]
    div = np.exp(np.arange(0, d, 2) * -(math.log(10000.0) / d))
    pe = np.zeros((t, d), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div[: d // 2])
    pe_var = T.assign(pe.reshape(1, t, d))
    return elementwise_add(scale(input, scale=float(alpha)),
                           scale(pe_var, scale=float(beta)))


def affine_channel(x, scale_var=None, bias=None, data_layout="NCHW",
                   name=None, act=None):
    """Per-channel x*scale + bias (ref nn.py affine_channel)."""
    c_axis = 1 if data_layout == "NCHW" else len(x.shape) - 1
    shape = [1] * len(x.shape)
    shape[c_axis] = x.shape[c_axis]
    out = elementwise_add(
        elementwise_mul(x, reshape(scale_var, shape)),
        reshape(bias, shape))
    if act:
        from . import ops as act_ops
        out = getattr(act_ops, act)(out)
    return out


def fsp_matrix(x, y):
    """Flow-of-solution-procedure matrix (ref nn.py fsp_matrix):
    (N,C1,H,W),(N,C2,H,W) -> (N,C1,C2) = x_flat y_flat^T / (H*W)."""
    n, c1, h, w = x.shape
    c2 = y.shape[1]
    xf = reshape(x, [n, c1, h * w])
    yf = transpose(reshape(y, [n, c2, h * w]), [0, 2, 1])
    return scale(matmul(xf, yf), scale=1.0 / float(h * w))


def continuous_value_model(input, cvm, use_cvm=True):
    """Show/click CTR embedding handling (ref nn.py
    continuous_value_model)."""
    return _append("cvm", {"X": [input], "CVM": [cvm]}, input.dtype,
                   attrs={"use_cvm": bool(use_cvm)}, out_slots=("Y",))


# ---- shape/layout ops ---------------------------------------------------

def space_to_depth(x, blocksize, name=None):
    b = int(blocksize)
    shape = None
    if x.shape and all(s not in (None, -1) for s in x.shape):
        n, c, h, w = x.shape
        shape = (n, c * b * b, h // b, w // b)
    return _append("space_to_depth", {"X": [x]}, x.dtype,
                   attrs={"blocksize": b}, name=name,
                   out_shapes=[shape])


def shuffle_channel(x, group, name=None):
    return _append("shuffle_channel", {"X": [x]}, x.dtype,
                   attrs={"group": int(group)}, name=name,
                   out_shapes=[tuple(x.shape) if x.shape else None])


def pad_constant_like(x, y, pad_value=0.0, name=None):
    """Pad y at the end of every dim up to x's shape (ref nn.py
    pad_constant_like)."""
    from .nn import pad
    paddings = []
    for sx, sy in zip(x.shape, y.shape):
        paddings += [0, int(sx) - int(sy)]
    return pad(y, paddings, pad_value=pad_value)


def im2sequence(input, filter_size=1, stride=1, padding=0,
                input_image_size=None, out_stride=1, name=None):
    """Sliding windows -> rows (ref nn.py im2sequence): (N,C,H,W) ->
    (N*oh*ow, C*fh*fw) via the unfold kernel."""
    from .vision import unfold
    fh, fw = (filter_size, filter_size) if isinstance(filter_size, int) \
        else filter_size
    sh, sw = (stride, stride) if isinstance(stride, int) else stride
    cols = unfold(input, [fh, fw], strides=[sh, sw],
                  paddings=[padding] * 4 if isinstance(padding, int)
                  else padding)                  # (N, C*fh*fw, L)
    n, c, h, w = input.shape
    p = [padding] * 4 if isinstance(padding, int) else list(padding)
    oh = (h + p[0] + p[1] - fh) // sh + 1
    ow = (w + p[2] + p[3] - fw) // sw + 1
    l = oh * ow
    ckk = c * fh * fw
    cols = reshape(cols, [n, ckk, l])
    return reshape(transpose(cols, [0, 2, 1]), [n * l, ckk])


def image_resize_short(input, out_short_len, resample="BILINEAR"):
    """Resize so the SHORT side equals out_short_len (ref nn.py
    image_resize_short); static input H,W."""
    from .nn import image_resize
    _, _, h, w = input.shape
    short = min(h, w)
    oh = int(round(h * out_short_len / float(short)))
    ow = int(round(w * out_short_len / float(short)))
    return image_resize(input, out_shape=[oh, ow],
                        resample=resample)


def resize_trilinear(input, out_shape=None, scale_var=None, name=None,
                     actual_shape=None, align_corners=True,
                     align_mode=1, data_format="NCDHW"):
    """3-D linear resize (ref nn.py resize_trilinear)."""
    if out_shape is None:
        raise ValueError("resize_trilinear needs a static out_shape "
                         "[D, H, W]")
    return _append("resize_trilinear", {"X": [input]}, input.dtype,
                   attrs={"out_shape": [int(s) for s in out_shape]},
                   name=name)


# ---- indexing / decoding -----------------------------------------------

def scatter_nd(index, updates, shape, name=None):
    """Zeros of `shape` with updates scattered/accumulated at index (ref
    nn.py scatter_nd)."""
    return _append("scatter_nd", {"Index": [index], "Updates": [updates]},
                   updates.dtype, attrs={"shape": [int(s) for s in shape]},
                   name=name)


def gather_tree(ids, parents):
    """Beam-search path reconstruction (ref nn.py gather_tree)."""
    return _append("gather_tree", {"Ids": [ids], "Parents": [parents]},
                   ids.dtype)


def hash(input, hash_size, num_hash=1, name=None):
    """Multi-seed bounded integer hash (ref nn.py hash)."""
    return _append("hash", {"X": [input]}, "int64",
                   attrs={"mod_by": int(hash_size),
                          "num_hash": int(num_hash)}, name=name)


def random_crop(x, shape=None, seed=None):
    """Random spatial crop to trailing `shape` (ref nn.py random_crop)."""
    return _append("random_crop", {"X": [x]}, x.dtype,
                   attrs={"shape": [int(s) for s in shape]})


def ctc_greedy_decoder(input, blank, input_length=None, padding_value=-1,
                       name=None):
    """Greedy CTC decode to dense ids + lengths (ref nn.py
    ctc_greedy_decoder; dense (N, T, V) + lengths replaces LoD)."""
    inputs = {"Input": [input]}
    if input_length is not None:
        inputs["Length"] = [input_length]
    helper = LayerHelper("ctc_greedy_decoder", name=name)
    out = helper.create_variable_for_type_inference("int64")
    out_len = helper.create_variable_for_type_inference("int32")
    helper.append_op("ctc_greedy_decoder",
                     inputs={k: [v.name for v in vs]
                             for k, vs in inputs.items()},
                     outputs={"Out": [out.name],
                              "OutLength": [out_len.name]},
                     attrs={"blank": int(blank),
                            "padding_value": int(padding_value)})
    return out, out_len


def similarity_focus(input, axis, indexes, name=None):
    """ref nn.py similarity_focus."""
    return _append("similarity_focus", {"X": [input]}, input.dtype,
                   attrs={"axis": int(axis),
                          "indexes": [int(i) for i in indexes]}, name=name)


def filter_by_instag(ins, ins_tag, filter_tag, is_lod=True,
                     out_val_if_empty=0):
    """ref nn.py filter_by_instag (dense/static form: kept rows packed to
    the top, mask in LossWeight, row mapping in IndexMap)."""
    helper = LayerHelper("filter_by_instag")
    out = helper.create_variable_for_type_inference(ins.dtype)
    lw = helper.create_variable_for_type_inference(ins.dtype)
    im = helper.create_variable_for_type_inference("int64")
    helper.append_op("filter_by_instag",
                     inputs={"Ins": [ins.name], "Ins_tag": [ins_tag.name],
                             "Filter_tag": [filter_tag.name]},
                     outputs={"Out": [out.name], "LossWeight": [lw.name],
                              "IndexMap": [im.name]})
    return out, lw, im


def deformable_roi_pooling(input, rois, trans, no_trans=False,
                           spatial_scale=1.0, group_size=(1, 1),
                           pooled_height=1, pooled_width=1, part_size=None,
                           sample_per_part=1, trans_std=0.1,
                           position_sensitive=False, name=None):
    """Deformable RoI pooling (ref nn.py deformable_roi_pooling):
    implemented as psroi/roi pooling with per-bin offsets from `trans`.
    the offsets shift the bin sampling grid before bilinear sampling;
    the no_trans path reduces to (ps)roi_pool."""
    from .vision import psroi_pool, prroi_pool
    if no_trans:
        if position_sensitive:
            c = int(input.shape[1]) // (pooled_height * pooled_width)
            return psroi_pool(input, rois, c, spatial_scale,
                              pooled_height, pooled_width)
        return prroi_pool(input, rois, spatial_scale, pooled_height,
                          pooled_width)
    helper = LayerHelper("deformable_roi_pooling", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "deformable_roi_pooling",
        inputs={"Input": [input.name], "ROIs": [rois.name],
                "Trans": [trans.name]},
        outputs={"Output": [out.name]},
        attrs={"spatial_scale": float(spatial_scale),
               "pooled_height": int(pooled_height),
               "pooled_width": int(pooled_width),
               "trans_std": float(trans_std),
               "position_sensitive": bool(position_sensitive)})
    return out


# ---- random batch-size-like --------------------------------------------

def _batch_size_like_shape(input, shape, input_dim_idx, output_dim_idx):
    shape = [int(s) for s in shape]
    b = input.shape[input_dim_idx]
    if b in (None, -1):
        raise ValueError("*_batch_size_like needs a static batch dim")
    shape[output_dim_idx] = int(b)
    return shape


def gaussian_random_batch_size_like(input, shape, input_dim_idx=0,
                                    output_dim_idx=0, mean=0.0, std=1.0,
                                    seed=0, dtype="float32"):
    """ref nn.py gaussian_random_batch_size_like."""
    shape = _batch_size_like_shape(input, shape, input_dim_idx,
                                   output_dim_idx)
    from .ops import gaussian_random
    return gaussian_random(shape, mean=mean, std=std, seed=seed,
                           dtype=dtype)


def uniform_random_batch_size_like(input, shape, dtype="float32",
                                   input_dim_idx=0, output_dim_idx=0,
                                   min=-1.0, max=1.0, seed=0):
    """ref nn.py uniform_random_batch_size_like."""
    shape = _batch_size_like_shape(input, shape, input_dim_idx,
                                   output_dim_idx)
    from .ops import uniform_random
    return uniform_random(shape, dtype=dtype, min=min, max=max, seed=seed)


# ---- LoD / SelectedRows parity shims -----------------------------------

def lod_reset(x, y=None, target_lod=None):
    """Dense+lengths design: LoD metadata travels as explicit length
    vectors, so resetting LoD is pairing x with the new lengths (ref
    nn.py lod_reset). Returns x unchanged; pass the new lengths alongside
    to the sequence_* ops."""
    return x


def lod_append(x, level):
    """See lod_reset — LoD is external lengths here (ref lod_append)."""
    return x


def get_tensor_from_selected_rows(x, name=None):
    """Identity: gradients are dense; there is no SelectedRows format
    (ref get_tensor_from_selected_rows)."""
    return x


def merge_selected_rows(x, name=None):
    """Identity — duplicate-row accumulation already happened in the
    dense grad (ref merge_selected_rows)."""
    return x
