"""Model PARAMs/FLOPs summary (counterpart of paddle_tpu/contrib/model_stat.py;
fluid's contrib/model_stat.py).

``summary(main_prog)`` walks the Program and prints a per-layer table of
parameter counts and forward FLOPs for the common compute ops (conv2d,
fc/mul/matmul, pool2d, norms, activations), by the reference's
conventions (2x multiply-add for convs and fc), from the Program's var
shapes, without running it.
"""
from collections import OrderedDict

__all__ = ["summary"]

_ACTS = ("sigmoid", "tanh", "relu", "leaky_relu", "prelu", "gelu", "swish")


def _numel(shape):
    n = 1
    for d in shape:
        n *= max(int(d), 1) if d != -1 else 1
    return n


def _var_shape(block, name):
    var = block._find_var_recursive(name) if hasattr(
        block, "_find_var_recursive") else block.var(name)
    return tuple(var.shape)


def _summary_op(block, op):
    """(in_shape, out_shape, params, flops) or None for non-compute ops."""
    t = op.type
    if t in ("conv2d", "depthwise_conv2d"):
        w = _var_shape(block, op.input("Filter")[0])
        ins = _var_shape(block, op.input("Input")[0])
        outs = _var_shape(block, op.output("Output")[0])
        c_out, c_in, k_h, k_w = w
        h_out, w_out = outs[-2], outs[-1]
        groups = op.attr("groups", 1) or 1
        kernel_ops = k_h * k_w * (c_in / groups)
        bias = 1 if op.input("Bias") else 0
        params = c_out * (kernel_ops + bias)
        flops = 2 * h_out * w_out * c_out * (kernel_ops + bias)
    elif t == "pool2d":
        ins = _var_shape(block, op.input("X")[0])
        outs = _var_shape(block, op.output("Out")[0])
        c_out, h_out, w_out = outs[-3], outs[-2], outs[-1]
        k = op.attr("ksize", [1, 1])
        params = 0
        flops = h_out * w_out * c_out * (k[0] * k[1])
    elif t in ("mul", "matmul"):
        w = _var_shape(block, op.input("Y")[0])
        ins = _var_shape(block, op.input("X")[0])
        outs = _var_shape(block, op.output("Out")[0])
        if len(w) != 2:
            return None
        k_in, k_out = w
        # bias lives in a separate elementwise op in this IR
        params = k_in * k_out
        flops = 2 * k_in * k_out * (_numel(ins) // max(k_in, 1))
    elif t == "elementwise_add":
        # fc/conv bias shows up as elementwise_add with a rank-1
        # Parameter operand — attribute it here so PARAMs stay complete
        yv = block._find_var_recursive(op.input("Y")[0]) if hasattr(
            block, "_find_var_recursive") else None
        if yv is None or not getattr(yv, "persistable", False) or \
                len(yv.shape or ()) != 1:
            return None
        ins = _var_shape(block, op.input("X")[0])
        outs = _var_shape(block, op.output("Out")[0])
        params = yv.shape[0]
        flops = _numel(outs)
    elif t in _ACTS:
        ins = _var_shape(block, op.input("X")[0])
        outs = _var_shape(block, op.output("Out")[0])
        params = 1 if t == "prelu" else 0
        flops = _numel(ins)
    elif t in ("batch_norm", "layer_norm", "group_norm", "instance_norm"):
        ins = _var_shape(block, op.input("X")[0])
        out_slot = "Y" if op.output("Y") else "Out"
        outs = _var_shape(block, op.output(out_slot)[0])
        c_in = ins[1] if len(ins) > 1 else ins[-1]
        params = c_in * 2
        flops = 2 * _numel(ins)
    else:
        return None
    return ins[1:], outs[1:], int(params), int(flops)


def summary(main_prog):
    """Print (and return) the layer table + totals (ref model_stat.py:40).

    Returns (rows, (total_params, total_flops)) so tests/tools can
    consume the numbers instead of scraping stdout.
    """
    collected = []
    for block in main_prog.blocks:
        for op in block.ops:
            res = _summary_op(block, op)
            if res is None:
                continue
            info = OrderedDict()
            info["type"] = op.type
            info["input_shape"] = res[0]
            info["out_shape"] = res[1]
            info["PARAMs"] = res[2]
            info["FLOPs"] = res[3]
            collected.append(info)
    total_params = sum(r["PARAMs"] for r in collected)
    total_flops = sum(r["FLOPs"] for r in collected)
    hdr = "%-4s %-12s %-20s %-20s %12s %14s" % (
        "No.", "TYPE", "INPUT", "OUTPUT", "PARAMs", "FLOPs")
    print(hdr)
    print("-" * len(hdr))
    for i, r in enumerate(collected):
        print("%-4d %-12s %-20s %-20s %12d %14d" % (
            i, r["type"], str(tuple(r["input_shape"])),
            str(tuple(r["out_shape"])), r["PARAMs"], r["FLOPs"]))
    print("Total PARAMs: %d (%.4fM)" % (total_params,
                                        total_params / 1e6))
    print("Total FLOPs: %d (%.2fG)" % (total_flops, total_flops / 1e9))
    return collected, (total_params, total_flops)
