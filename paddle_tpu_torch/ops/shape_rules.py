"""Static shape/dtype inference rules: the kernels' abstract twins.

Counterpart of paddle_tpu/ops/shape_rules.py (the same rule set, op for
op). Each reference OpMaker registers an InferShape beside its kernels
(paddle/fluid/framework/op_desc.cc InferShapeContext); here the rules sit
beside the torch kernel registry and framework/analysis.py's shape pass
reads them. A rule computes output metadata from input metadata without
running anything (no torch call) and raises :class:`ShapeError` on a
genuine violation.

Contract (the no-false-positive invariant):
  * metadata is a :class:`TensorMeta`: ``shape`` is a tuple whose
    entries may be None (unknown dim, e.g. the -1 batch dim) or None
    entirely (unknown rank); ``dtype`` is a canonical dtype string or
    None.
  * a rule skips any check that needs an unknown dim/dtype and
    propagates unknowns instead; ops with no registered rule infer top
    (fully unknown) everywhere.
  * ``ShapeError(msg, severity=)`` carries "error" for certain
    violations (wrong matmul width, unbroadcastable add, reshape
    element mismatch) and "warning" for suspicious-but-runnable
    patterns (an int/float elementwise mix, which torch promotes
    silently).
"""
import math

from .registry import register_shape_rule

_FLOATS = ("float16", "bfloat16", "float32", "float64")
_INTS = ("int8", "uint8", "int16", "int32", "int64", "bool")


class TensorMeta(object):
    """Abstract (shape, dtype) of one value flowing through a Program."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape=None, dtype=None):
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype

    @property
    def rank(self):
        return None if self.shape is None else len(self.shape)

    def __repr__(self):
        return "TensorMeta(%s, %s)" % (self.shape, self.dtype)


def top():
    return TensorMeta(None, None)


class ShapeError(Exception):
    """A static shape/dtype violation (severity "error" | "warning")."""

    def __init__(self, message, severity="error"):
        super(ShapeError, self).__init__(message)
        self.severity = severity


def _x(ins, slot="X"):
    vals = ins.get(slot) or [top()]
    return vals[0]


def _known(shape):
    return shape is not None and all(d is not None for d in shape)


def _same_shape_out(op, ins, attrs, slot="X", out="Out"):
    m = _x(ins, slot)
    return {out: [TensorMeta(m.shape, m.dtype)]}


def _dtype_mix(a, b, what):
    """Flag dtype mixes. Warning severity, not error: the AMP path
    (contrib/mixed_precision) leans on type promotion on purpose
    (bf16 matmul output + f32 master bias), so a mix is suspicious but
    runnable — strict mode must not refuse AMP programs."""
    if a is None or b is None or a == b:
        return
    if a in _FLOATS and b in _FLOATS:
        raise ShapeError(
            "%s mixes float dtypes %s and %s without a cast — the op "
            "promotes silently; intentional under AMP, a wasted-"
            "bandwidth bug anywhere else" % (what, a, b),
            severity="warning")
    if (a in _FLOATS) != (b in _FLOATS):
        raise ShapeError(
            "%s mixes %s and %s — type promotion will pick a type "
            "silently; cast explicitly" % (what, a, b),
            severity="warning")


def _result_dtype(a, b):
    if a == b:
        return a
    return None


# ---------------------------------------------------------------------------
# elementwise family (fluid axis-broadcast semantics, math_ops._bcast)
# ---------------------------------------------------------------------------

def _fluid_broadcast(xs, ys, axis):
    """Mirror math_ops._bcast on abstract shapes; None dims match
    anything. Returns the result shape or raises ShapeError."""
    if xs is None or ys is None:
        return None
    if len(ys) > len(xs):
        return _fluid_broadcast(ys, xs, axis)
    if len(xs) != len(ys):
        if axis is None or axis == -1:
            axis = len(xs) - len(ys)
        if axis < 0 or axis + len(ys) > len(xs):
            raise ShapeError(
                "elementwise axis=%d cannot align a rank-%d operand "
                "into rank %d" % (axis, len(ys), len(xs)))
        ys = (1,) * axis + tuple(ys) + (1,) * (len(xs) - axis - len(ys))
    out = []
    for a, b in zip(xs, ys):
        if a is None or b is None:
            out.append(a if b == 1 else (b if a == 1 else None))
        elif a == b or b == 1:
            out.append(a)
        elif a == 1:
            out.append(b)
        else:
            raise ShapeError(
                "elementwise operands are not broadcastable: %s vs %s"
                % (tuple(xs), tuple(ys)))
    return tuple(out)


def _elementwise_rule(op, ins, attrs):
    x, y = _x(ins, "X"), _x(ins, "Y")
    _dtype_mix(x.dtype, y.dtype,
               "op {%s}" % op.type)
    shape = _fluid_broadcast(x.shape, y.shape, attrs.get("axis", -1))
    return {"Out": [TensorMeta(shape, _result_dtype(x.dtype, y.dtype))]}


for _t in ("elementwise_add", "elementwise_sub", "elementwise_mul",
           "elementwise_div", "elementwise_max", "elementwise_min",
           "elementwise_pow", "elementwise_mod", "elementwise_floordiv"):
    register_shape_rule(_t)(_elementwise_rule)


@register_shape_rule("maximum", "minimum")
def _binop_nobcast(op, ins, attrs):
    x, y = _x(ins, "X"), _x(ins, "Y")
    _dtype_mix(x.dtype, y.dtype, "op {%s}" % op.type)
    shape = _fluid_broadcast(x.shape, y.shape, -1)
    return {"Out": [TensorMeta(shape, _result_dtype(x.dtype, y.dtype))]}


@register_shape_rule("sum")
def _sum_rule(op, ins, attrs):
    metas = ins.get("X") or [top()]
    shape, dtype = metas[0].shape, metas[0].dtype
    for m in metas[1:]:
        shape = _fluid_broadcast(shape, m.shape, -1)
        if dtype != m.dtype:
            dtype = None
    return {"Out": [TensorMeta(shape, dtype)]}


# ---------------------------------------------------------------------------
# shape-preserving unary ops (activations + friends)
# ---------------------------------------------------------------------------

def _register_unary():
    from .math_ops import _ACTIVATIONS
    unary = set(_ACTIVATIONS) | {
        "scale", "clip", "pow", "logical_not", "isnan", "isinf",
        "clip_by_norm", "increment", "assign", "fill_any_like",
        "fill_zeros_like", "softmax", "log_softmax", "label_smooth",
        "l2_normalize", "add_position_encoding",
    }
    for t in sorted(unary):
        register_shape_rule(t)(_same_shape_out)


_register_unary()


@register_shape_rule("cumsum")
def _cumsum_rule(op, ins, attrs):
    m = _x(ins)
    if attrs.get("flatten", False):
        n = math.prod(m.shape) if m.shape is not None and _known(m.shape) \
            else None
        return {"Out": [TensorMeta((n,), m.dtype)]}
    return {"Out": [TensorMeta(m.shape, m.dtype)]}


@register_shape_rule("dropout")
def _dropout_rule(op, ins, attrs):
    m = _x(ins)
    return {"Out": [TensorMeta(m.shape, m.dtype)],
            "Mask": [TensorMeta(m.shape, "uint8")]}


@register_shape_rule("cast")
def _cast_rule(op, ins, attrs):
    from ..framework.dtypes import normalize_dtype
    m = _x(ins)
    dt = attrs.get("out_dtype")
    try:
        dt = normalize_dtype(dt) if dt is not None else None
    except Exception:
        dt = None
    return {"Out": [TensorMeta(m.shape, dt)]}


@register_shape_rule("mean", "isfinite")
def _scalar_rule(op, ins, attrs):
    m = _x(ins)
    dt = "bool" if op.type == "isfinite" else m.dtype
    return {"Out": [TensorMeta((1,), dt)]}


@register_shape_rule("squared_l2_norm")
def _sq_l2_rule(op, ins, attrs):
    # the kernel reshapes to rank 0 (reshape(())), not (1,)
    return {"Out": [TensorMeta((), _x(ins).dtype)]}


# ---------------------------------------------------------------------------
# matmul / mul — the matmul family (wrong-width heads die here)
# ---------------------------------------------------------------------------

@register_shape_rule("matmul")
def _matmul_rule(op, ins, attrs):
    x, y = _x(ins, "X"), _x(ins, "Y")
    _dtype_mix(x.dtype, y.dtype, "op {matmul}")
    xs, ys = x.shape, y.shape
    if xs is not None and len(xs) == 1:
        xs = (1,) + tuple(xs)
    if ys is not None and len(ys) == 1:
        ys = tuple(ys) + (1,)
    if attrs.get("transpose_X", False) and xs is not None and len(xs) >= 2:
        xs = xs[:-2] + (xs[-1], xs[-2])
    if attrs.get("transpose_Y", False) and ys is not None and len(ys) >= 2:
        ys = ys[:-2] + (ys[-1], ys[-2])
    out_dt = attrs.get("out_dtype")
    if out_dt:
        from ..framework.dtypes import normalize_dtype
        try:
            dtype = normalize_dtype(out_dt)
        except Exception:
            dtype = None
    else:
        dtype = _result_dtype(x.dtype, y.dtype)
    if xs is None or ys is None or len(xs) < 2 or len(ys) < 2:
        return {"Out": [TensorMeta(None, dtype)]}
    k1, k2 = xs[-1], ys[-2]
    if k1 is not None and k2 is not None and k1 != k2:
        raise ShapeError(
            "matmul contraction width mismatch: X%s @ Y%s contracts "
            "%d against %d (after transpose flags)"
            % (tuple(xs), tuple(ys), k1, k2))
    # batch dims broadcast numpy-style
    batch = _fluid_broadcast(xs[:-2], ys[:-2], -1) \
        if (xs[:-2] or ys[:-2]) else ()
    return {"Out": [TensorMeta(tuple(batch or ()) + (xs[-2], ys[-1]),
                               dtype)]}


@register_shape_rule("mul")
def _mul_rule(op, ins, attrs):
    x, y = _x(ins, "X"), _x(ins, "Y")
    _dtype_mix(x.dtype, y.dtype, "op {mul}")
    xs, ys = x.shape, y.shape
    xn = attrs.get("x_num_col_dims", 1)
    yn = attrs.get("y_num_col_dims", 1)
    if xs is None or ys is None:
        return {"Out": [top()]}
    if len(xs) < xn + 1 or len(ys) < yn + 1:
        return {"Out": [top()]}
    kx = xs[xn:]
    ky = ys[:yn]
    if _known(kx) and _known(ky) and math.prod(kx) != math.prod(ky):
        raise ShapeError(
            "mul contraction width mismatch: X%s x_num_col_dims=%d "
            "flattens to %d columns but Y%s y_num_col_dims=%d provides "
            "%d rows" % (tuple(xs), xn, math.prod(kx), tuple(ys), yn,
                         math.prod(ky)))
    return {"Out": [TensorMeta(tuple(xs[:xn]) + tuple(ys[yn:]),
                               _result_dtype(x.dtype, y.dtype))]}


@register_shape_rule("dot")
def _dot_rule(op, ins, attrs):
    x, y = _x(ins, "X"), _x(ins, "Y")
    _dtype_mix(x.dtype, y.dtype, "op {dot}")
    shape = _fluid_broadcast(x.shape, y.shape, -1)
    if shape is not None and len(shape) >= 1:
        shape = tuple(shape[:-1]) + (1,)
    return {"Out": [TensorMeta(shape, _result_dtype(x.dtype, y.dtype))]}


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def _reduce_rule(op, ins, attrs):
    m = _x(ins)
    dtype = "bool" if op.type in ("reduce_all", "reduce_any") else m.dtype
    if m.shape is None:
        return {"Out": [TensorMeta(None, dtype)]}
    dims = attrs.get("dim", [0])
    reduce_all = attrs.get("reduce_all", False) or dims is None
    keep = attrs.get("keep_dim", False)
    rank = len(m.shape)
    if reduce_all:
        shape = (1,) * rank if keep else (1,)
        return {"Out": [TensorMeta(shape, dtype)]}
    if not isinstance(dims, (list, tuple)):
        dims = [dims]
    try:
        axes = {d % rank for d in dims}
    except (TypeError, ZeroDivisionError):
        return {"Out": [TensorMeta(None, dtype)]}
    for d in dims:
        if not -rank <= d < rank:
            raise ShapeError(
                "reduce dim %d out of range for rank-%d input %s"
                % (d, rank, m.shape))
    shape = tuple(1 if i in axes else d for i, d in enumerate(m.shape)) \
        if keep else tuple(d for i, d in enumerate(m.shape)
                           if i not in axes)
    return {"Out": [TensorMeta(shape, dtype)]}


for _t in ("reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
           "reduce_prod", "reduce_all", "reduce_any"):
    register_shape_rule(_t)(_reduce_rule)


# ---------------------------------------------------------------------------
# reshape / layout family
# ---------------------------------------------------------------------------

@register_shape_rule("reshape2")
def _reshape2_rule(op, ins, attrs):
    m = _x(ins)
    want = list(attrs.get("shape") or [])
    if not want:
        return {"Out": [TensorMeta(None, m.dtype)]}
    out = []
    for i, s in enumerate(want):
        if s == 0:
            if m.shape is not None and i < len(m.shape):
                out.append(m.shape[i])
            else:
                out.append(None)
        elif s == -1:
            out.append(-1)
        else:
            out.append(int(s))
    n_infer = sum(1 for d in out if d == -1)
    if n_infer > 1:
        raise ShapeError("reshape2 shape %r has more than one -1" % want)
    if m.shape is not None and _known(m.shape):
        total = math.prod(m.shape) if m.shape else 1
        fixed = [d for d in out if d not in (-1, None)]
        if None not in out:
            prod = math.prod(fixed) if fixed else 1
            if n_infer:
                if prod == 0 or total % prod != 0:
                    raise ShapeError(
                        "reshape2 cannot infer -1: input %s (%d elements) "
                        "does not divide by %r" % (m.shape, total, want))
                out[out.index(-1)] = total // prod
            elif prod != total:
                raise ShapeError(
                    "reshape2 element count mismatch: input %s has %d "
                    "elements, target %r has %d"
                    % (m.shape, total, want, prod))
    out = [None if d == -1 else d for d in out]
    return {"Out": [TensorMeta(tuple(out), m.dtype)]}


@register_shape_rule("transpose2")
def _transpose2_rule(op, ins, attrs):
    m = _x(ins)
    perm = attrs.get("axis")
    if m.shape is None or perm is None:
        return {"Out": [TensorMeta(None, m.dtype)]}
    if sorted(a % len(m.shape) if -len(m.shape) <= a < len(m.shape)
              else -1 for a in perm) != list(range(len(m.shape))):
        raise ShapeError(
            "transpose2 axis %r is not a permutation of rank %d"
            % (perm, len(m.shape)))
    return {"Out": [TensorMeta(tuple(m.shape[a] for a in perm),
                               m.dtype)]}


@register_shape_rule("flatten2")
def _flatten2_rule(op, ins, attrs):
    m = _x(ins)
    axis = attrs.get("axis", 1)
    if m.shape is None or not _known(m.shape):
        return {"Out": [TensorMeta(None, m.dtype)]}
    lead = math.prod(m.shape[:axis]) if axis else 1
    rest = math.prod(m.shape[axis:]) if m.shape[axis:] else 1
    return {"Out": [TensorMeta((lead, rest), m.dtype)]}


@register_shape_rule("concat")
def _concat_rule(op, ins, attrs):
    metas = ins.get("X") or [top()]
    axis = attrs.get("axis", 0)
    shapes = [m.shape for m in metas]
    if any(s is None for s in shapes):
        return {"Out": [TensorMeta(None, metas[0].dtype)]}
    rank = len(shapes[0])
    if any(len(s) != rank for s in shapes):
        raise ShapeError("concat operands have mixed ranks: %r" % (shapes,))
    ax = axis % rank if rank else 0
    out = []
    for i in range(rank):
        dims = [s[i] for s in shapes]
        if i == ax:
            out.append(None if any(d is None for d in dims)
                       else sum(dims))
        else:
            known = {d for d in dims if d is not None}
            if len(known) > 1:
                raise ShapeError(
                    "concat operands disagree on non-concat dim %d: %r"
                    % (i, shapes))
            out.append(known.pop() if known else None)
    dtype = metas[0].dtype
    if any(m.dtype != dtype for m in metas):
        dtype = None
    return {"Out": [TensorMeta(tuple(out), dtype)]}


@register_shape_rule("stack")
def _stack_rule(op, ins, attrs):
    metas = ins.get("X") or [top()]
    axis = attrs.get("axis", 0)
    s = metas[0].shape
    if s is None:
        return {"Y": [TensorMeta(None, metas[0].dtype)]}
    ax = axis % (len(s) + 1)
    return {"Y": [TensorMeta(tuple(s[:ax]) + (len(metas),)
                             + tuple(s[ax:]), metas[0].dtype)]}


@register_shape_rule("squeeze2")
def _squeeze2_rule(op, ins, attrs):
    m = _x(ins)
    axes = attrs.get("axes", [])
    if m.shape is None:
        return {"Out": [TensorMeta(None, m.dtype)]}
    rank = len(m.shape)
    if not axes:
        shape = tuple(d for d in m.shape if d != 1)
    else:
        drop = {a % rank for a in axes
                if m.shape[a % rank] == 1}
        shape = tuple(d for i, d in enumerate(m.shape) if i not in drop)
    return {"Out": [TensorMeta(shape, m.dtype)]}


@register_shape_rule("unsqueeze2")
def _unsqueeze2_rule(op, ins, attrs):
    m = _x(ins)
    if m.shape is None:
        return {"Out": [TensorMeta(None, m.dtype)]}
    shape = list(m.shape)
    for a in sorted(attrs.get("axes", [])):
        if not -len(shape) - 1 <= a <= len(shape):
            raise ShapeError(
                "unsqueeze2 axis %d out of range for rank %d"
                % (a, len(shape)))
        shape.insert(a if a >= 0 else a + len(shape) + 1, 1)
    return {"Out": [TensorMeta(tuple(shape), m.dtype)]}


# ---------------------------------------------------------------------------
# fills / constants
# ---------------------------------------------------------------------------

@register_shape_rule("fill_constant")
def _fill_constant_rule(op, ins, attrs):
    from ..framework.dtypes import normalize_dtype
    shape = attrs.get("shape")
    try:
        dt = normalize_dtype(attrs.get("dtype", "float32"))
    except Exception:
        dt = None
    return {"Out": [TensorMeta(tuple(shape) if shape else None, dt)]}


@register_shape_rule("fill_constant_batch_size_like")
def _fill_bsl_rule(op, ins, attrs):
    from ..framework.dtypes import normalize_dtype
    ref = _x(ins, "Input")
    shape = list(attrs.get("shape") or [])
    if not shape:
        return {"Out": [top()]}
    in_idx = attrs.get("input_dim_idx", 0)
    out_idx = attrs.get("output_dim_idx", 0)
    if ref.shape is not None and in_idx < len(ref.shape) \
            and out_idx < len(shape):
        shape[out_idx] = ref.shape[in_idx]
    shape = [None if d in (-1,) else d for d in shape]
    try:
        dt = normalize_dtype(attrs.get("dtype", "float32"))
    except Exception:
        dt = None
    return {"Out": [TensorMeta(tuple(shape), dt)]}


# ---------------------------------------------------------------------------
# embedding / one-hot
# ---------------------------------------------------------------------------

@register_shape_rule("lookup_table", "lookup_table_v2")
def _lookup_rule(op, ins, attrs):
    w, ids = _x(ins, "W"), _x(ins, "Ids")
    if ids.dtype is not None and ids.dtype in _FLOATS:
        raise ShapeError(
            "lookup_table Ids must be integer, got %s" % ids.dtype)
    if w.shape is None or len(w.shape) != 2 or ids.shape is None:
        return {"Out": [TensorMeta(None, w.dtype)]}
    ids_shape = ids.shape
    if len(ids_shape) >= 2 and ids_shape[-1] == 1:
        ids_shape = ids_shape[:-1]
    return {"Out": [TensorMeta(tuple(ids_shape) + (w.shape[1],),
                               w.dtype)]}


@register_shape_rule("one_hot")
def _one_hot_rule(op, ins, attrs):
    from ..framework.dtypes import normalize_dtype
    m = _x(ins)
    depth = attrs.get("depth")
    try:
        dt = normalize_dtype(attrs.get("dtype", "float32"))
    except Exception:
        dt = None
    if m.shape is None or depth is None:
        return {"Out": [TensorMeta(None, dt)]}
    shape = m.shape
    if len(shape) >= 2 and shape[-1] == 1:
        shape = shape[:-1]
    return {"Out": [TensorMeta(tuple(shape) + (int(depth),), dt)]}


# ---------------------------------------------------------------------------
# losses / heads — the CE family
# ---------------------------------------------------------------------------

def _ce_label_check(logits, label, op_type, soft, axis=-1):
    """Shared logits-vs-label structural check. Returns the per-example
    loss shape (label-aligned + trailing 1) or None when unknown."""
    if logits.shape is None or label.shape is None:
        return None
    ls = tuple(logits.shape)
    if axis not in (-1, len(ls) - 1):
        return None
    if soft:
        if len(label.shape) != len(ls):
            raise ShapeError(
                "op {%s} soft_label=True needs Label rank %d == Logits "
                "rank, got %s vs %s" % (op_type, len(ls), label.shape, ls))
        c1, c2 = ls[-1], label.shape[-1]
        if c1 is not None and c2 is not None and c1 != c2:
            raise ShapeError(
                "op {%s} soft Label width %d != class width %d of the "
                "logits %s — a wrong-width head" % (op_type, c2, c1, ls))
        return tuple(label.shape[:-1]) + (1,)
    lbl = tuple(label.shape)
    if len(lbl) == len(ls) and lbl[-1] == 1:
        lbl = lbl[:-1]
    if len(lbl) != len(ls) - 1:
        raise ShapeError(
            "op {%s} hard Label %s does not align with Logits %s "
            "(want the logits shape minus the class dim, optionally "
            "with a trailing 1)" % (op_type, label.shape, ls))
    for a, b in zip(lbl, ls[:-1]):
        if a is not None and b is not None and a != b:
            raise ShapeError(
                "op {%s} Label dims %s disagree with Logits dims %s"
                % (op_type, label.shape, ls))
    return tuple(lbl) + (1,)


@register_shape_rule("softmax_with_cross_entropy")
def _swce_rule(op, ins, attrs):
    logits, label = _x(ins, "Logits"), _x(ins, "Label")
    loss_shape = _ce_label_check(logits, label, op.type,
                                 attrs.get("soft_label", False),
                                 attrs.get("axis", -1))
    return {"Softmax": [TensorMeta(logits.shape, logits.dtype)],
            "Loss": [TensorMeta(loss_shape, logits.dtype)]}


@register_shape_rule("cross_entropy")
def _ce_rule(op, ins, attrs):
    x, label = _x(ins, "X"), _x(ins, "Label")
    loss_shape = _ce_label_check(x, label, op.type,
                                 attrs.get("soft_label", False))
    return {"Y": [TensorMeta(loss_shape, x.dtype)]}


@register_shape_rule("fused_mlm_head_loss")
def _mlm_head_rule(op, ins, attrs):
    hidden, weight = _x(ins, "Hidden"), _x(ins, "Weight")
    label = _x(ins, "Label")
    if hidden.shape is not None and weight.shape is not None \
            and len(hidden.shape) == 2 and len(weight.shape) == 2:
        d1, d2 = hidden.shape[-1], weight.shape[-1]
        if d1 is not None and d2 is not None and d1 != d2:
            raise ShapeError(
                "fused_mlm_head_loss Hidden width %d != Weight (V, D) "
                "width %d — a wrong-width head" % (d1, d2))
    t = hidden.shape[0] if hidden.shape is not None \
        and len(hidden.shape) >= 1 else None
    if label.shape is not None and _known(label.shape) and t is not None:
        lt = label.shape[0]
        if lt != t:
            raise ShapeError(
                "fused_mlm_head_loss Label rows %d != Hidden rows %s"
                % (lt, t))
    return {"Loss": [TensorMeta((t, 1), "float32")]}


@register_shape_rule("scaled_dot_product_attention")
def _sdpa_rule(op, ins, attrs):
    q, k, v = _x(ins, "Q"), _x(ins, "K"), _x(ins, "V")
    for name, m in (("Q", q), ("K", k), ("V", v)):
        if m.shape is not None and len(m.shape) < 2:
            raise ShapeError(
                "scaled_dot_product_attention %s needs rank >= 2, got %s"
                % (name, m.shape))
    if q.shape is None or k.shape is None or v.shape is None:
        return {"Out": [TensorMeta(None, q.dtype)]}
    dq, dk = q.shape[-1], k.shape[-1]
    if dq is not None and dk is not None and dq != dk:
        raise ShapeError(
            "scaled_dot_product_attention head width mismatch: Q%s vs "
            "K%s contract %d against %d" % (q.shape, k.shape, dq, dk))
    sk, sv = k.shape[-2], v.shape[-2]
    if sk is not None and sv is not None and sk != sv:
        raise ShapeError(
            "scaled_dot_product_attention K rows %d != V rows %d"
            % (sk, sv))
    return {"Out": [TensorMeta(tuple(q.shape[:-1]) + (v.shape[-1],),
                               q.dtype)]}


@register_shape_rule("layer_norm")
def _layer_norm_rule(op, ins, attrs):
    m = _x(ins)
    begin = attrs.get("begin_norm_axis", 1)
    mean_shape = None
    if m.shape is not None and 0 <= begin <= len(m.shape):
        mean_shape = tuple(m.shape[:begin])
    return {"Y": [TensorMeta(m.shape, m.dtype)],
            "Mean": [TensorMeta(mean_shape, "float32")],
            "Variance": [TensorMeta(mean_shape, "float32")]}


@register_shape_rule("batch_norm")
def _batch_norm_rule(op, ins, attrs):
    m = _x(ins)
    return {"Y": [TensorMeta(m.shape, m.dtype)]}
