#!/usr/bin/env python3
"""Time one family of the port's kernels in several checkouts, one after
the other on the same card, to compare two versions of them.

    python3 tools/port_kernel_ab.py --kernels flash_bwd A B B A
    python3 tools/port_kernel_ab.py --kernels head A B B A
    python3 tools/port_kernel_ab.py --kernels flash_fwd A B B A
    python3 tools/port_kernel_ab.py --kernels layer_norm A B B A

Each of A and B is the root of a checkout (with ``paddle_tpu_torch/``). Every
argument runs in its own process, in the order given, which builds that
tree's kernels into its own ``build/`` and prints one JSON line: the
card's name and power limit, and for each shape the kernels' median times
(CUDA events) and their errors against the tree's plain versions.

- ``head``: the fused head's forward, dhidden and dweight kernels and the
  pair (dhidden + dweight), beside the library's forward
  (``fwd_library_ms``, ``F.cross_entropy(h @ W.t())``) and backward
  (``library_ms``, autograd through it, both gradients), at GPT-base's
  shape in f32 and bf16.
- ``flash_bwd``: the flash-attention dK/dV and dQ kernels, the delta pass
  rowsum(dO * O) and the pair (dK/dV + dQ + delta), beside SDPA's
  backward (``library_ms``, autograd through
  ``F.scaled_dot_product_attention``), at GPT-base's and BERT-base
  training's shapes in f32 and bf16.
- ``flash_fwd``: the flash-attention forward kernel beside SDPA's forward
  (``library_ms``) and its bound, at GPT-base's causal T = 4096 and BERT-base
  serving's shape (key mask, T = 512), in f32 and bf16.
- ``layer_norm``: the LayerNorm forward and backward kernels beside
  ``F.layer_norm`` and ``aten.native_layer_norm_backward`` (all three
  gradients) and their byte bounds, at GPT-base's (8192, 768) and BERT-base
  training's (4096, 768) in f32 and bf16; each warm (the same inputs call
  after call, left in the 50 MB L2) and cold (``*_cold_ms``: the calls cycle
  through copies of the inputs that together exceed twice the L2).

Every time stands beside ``bound_ms`` where the tool gives one: the larger
of the bytes over 3.35 TB/s and the operations over the rate for their type
(f32: 495 / 3 TFLOP/s, the f32-accurate 3xTF32 rate; bf16: 989).

Needs a CUDA card; prints nothing and exits non-zero without one.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

# (name, T, D, V, dtype): GPT-base's head in f32 and bf16, a shorter bf16
# head, and two shapes whose tiles load element by element (D not a
# multiple of 4) or in 16-row blocks (D above 768)
HEAD_SHAPES = (("gpt_base_f32", 8192, 768, 32000, "float32"),
               ("gpt_base_bf16", 8192, 768, 32000, "bfloat16"),
               ("bf16", 2048, 768, 32000, "bfloat16"),
               ("ragged_d99_f32", 257, 99, 1001, "float32"),
               ("wide_d1000_f32", 300, 1000, 777, "float32"))
HEAD_TIMED = ("gpt_base_f32", "gpt_base_bf16", "bf16")
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2 ** 20
# (name, rows, cols, dtype): GPT-base's and BERT-base training's LayerNorms
LN_SHAPES = (("gpt_base_f32", 8192, 768, "float32"),
             ("gpt_base_bf16", 8192, 768, "bfloat16"),
             ("bert_base_f32", 4096, 768, "float32"),
             ("bert_base_bf16", 4096, 768, "bfloat16"))
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
# (name, B, H, T, D, dtype, mask, causal): GPT-base training (causal, T =
# 4096), BERT-base training (key mask, T = 128), BERT-base serving's
# shape in bf16
FLASH_SHAPES = (
    ("gpt_train_f32", 2, 12, 4096, 64, "float32", None, True),
    ("gpt_train_bf16", 2, 12, 4096, 64, "bfloat16", None, True),
    ("bert_train_f32", 32, 12, 128, 64, "float32", "k", False),
    ("bert_train_bf16", 32, 12, 128, 64, "bfloat16", "k", False),
    ("bert_serve_bf16", 8, 12, 512, 64, "bfloat16", "k", False))
FLASH_FWD_SHAPES = (
    ("gpt_train_f32", 2, 12, 4096, 64, "float32", None, True),
    ("gpt_train_bf16", 2, 12, 4096, 64, "bfloat16", None, True),
    ("bert_serve_f32", 8, 12, 512, 64, "float32", "k", False),
    ("bert_serve_bf16", 8, 12, 512, 64, "bfloat16", "k", False))


def _bound_ms(flops, nbytes, dtype):
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S) * 1e3


def _median_ms(torch, fn, reps=5, inner=3):
    """Median device time of one call (CUDA events over ``inner`` calls
    queued behind a sleep kernel, so the host's launch cost stays off the
    clock, as chip_smoke.py times)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _cold_ms(torch, fn, ring, reps=5):
    """Median device time of one call of ``fn(inputs)`` as the calls cycle
    through ``ring`` (input sets together above twice the L2: each call's
    inputs come from device memory)."""
    for inputs in ring:
        fn(inputs)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for inputs in ring:
            fn(inputs)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(ring))
    return statistics.median(times)


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def _head(torch, dev):
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import blockwise_ce as bce
    out = {}
    for name, t, d, v, dt in HEAD_SHAPES:
        g = torch.Generator(device=dev).manual_seed(1)
        dtype = getattr(torch, dt)
        h = torch.randn(t, d, generator=g, device=dev).to(dtype)
        w = (torch.randn(v, d, generator=g, device=dev) * 0.05).to(dtype)
        lab = torch.randint(0, v, (t,), generator=g, device=dev)
        lab[::97] = -100
        dl = torch.rand(t, generator=g, device=dev)
        loss, lse = bce.fused_head_loss(h, w, lab)
        want_loss, _ = bce.fused_head_loss_plain(h, w, lab)
        args = (h, w, lab, None, lse, dl)
        dh = bce.fused_head_dhidden(*args)
        dw, _ = bce.fused_head_dweight(*args)
        want_dh, want_dw, _ = bce.fused_head_bwd_plain(*args)
        torch.cuda.synchronize()

        def rel(a, b):
            return _max_err(a, b) / float(b.float().abs().max())
        r = {"loss_err": _max_err(loss, want_loss),
             "dh_rel": rel(dh, want_dh), "dw_rel": rel(dw, want_dw)}
        if name in HEAD_TIMED:
            r.update(
                fwd_ms=_median_ms(torch, lambda: bce.fused_head_loss(
                    h, w, lab)),
                dh_ms=_median_ms(torch, lambda: bce.fused_head_dhidden(
                    *args)),
                dw_ms=_median_ms(torch, lambda: bce.fused_head_dweight(
                    *args)))
            r["fwd_library_ms"] = _median_ms(
                torch, lambda: F.cross_entropy(h @ w.t(), lab,
                                               reduction="none"))
            lh, lw = (x.detach().requires_grad_() for x in (h, w))
            lib_loss = F.cross_entropy(lh @ lw.t(), lab, reduction="none")
            r["library_ms"] = _median_ms(torch, lambda: torch.autograd.grad(
                lib_loss, (lh, lw), dl.to(lib_loss.dtype),
                retain_graph=True))
            del lib_loss
            r["fwd_bound_ms"] = _bound_ms(
                2.0 * t * d * v, (t * d + v * d) * h.element_size() + 16 * t,
                dt)
            r["pair_ms"] = r["dh_ms"] + r["dw_ms"]
            r["pair_over_library"] = r["pair_ms"] / r["library_ms"]
        out[name] = r
    return out


def _flash_inputs(torch, dev, b, h, t, d, dtype, mode):
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v, do = (torch.randn(b, h, t, d, generator=g, device=dev)
                   .to(dtype) for _ in range(4))
    mask = None
    if mode == "k":
        lens = torch.randint(t // 2, t + 1, (b,), generator=g, device=dev)
        mask = torch.where(torch.arange(t, device=dev)[None, :] <
                           lens[:, None], 0.0, -1e4).reshape(b, 1, 1, t)
    return q, k, v, do, mask


def _flash_fwd(torch, dev):
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    out = {}
    for name, b, h, t, d, dt, mode, causal in FLASH_FWD_SHAPES:
        dtype = getattr(torch, dt)
        q, k, v, _, mask = _flash_inputs(torch, dev, b, h, t, d, dtype, mode)
        scale = d ** -0.5
        o, lse = fa.flash_attention(q, k, v, mask, scale, causal)
        want_o, want_lse = fa.flash_attention_plain(q, k, v, mask, scale,
                                                    causal)
        torch.cuda.synchronize()
        lib_mask = None if mask is None else mask.to(dtype)
        pairs = t * (t + 1) // 2 if causal else t * t
        nbytes = 4 * q.numel() * q.element_size() + lse.numel() * 4 + \
            (0 if mask is None else mask.numel() * 4)
        r = {"out_err": _max_err(o, want_o), "lse_err": _max_err(lse, want_lse),
             "ms": _median_ms(torch, lambda: fa.flash_attention(
                 q, k, v, mask, scale, causal)),
             "library_ms": _median_ms(
                 torch, lambda: F.scaled_dot_product_attention(
                     q, k, v, attn_mask=lib_mask, is_causal=causal,
                     scale=scale)),
             "bound_ms": _bound_ms(4.0 * b * h * pairs * d, nbytes, dt)}
        r["over_library"] = r["ms"] / r["library_ms"]
        r["tflops"] = 4.0 * b * h * pairs * d / r["ms"] / 1e9
        out[name] = r
    return out


def _flash_bwd(torch, dev):
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    out = {}
    for name, b, h, t, d, dt, mode, causal in FLASH_SHAPES:
        dtype = getattr(torch, dt)
        q, k, v, do, mask = _flash_inputs(torch, dev, b, h, t, d, dtype,
                                          mode)
        scale = d ** -0.5
        o, lse = fa.flash_attention(q, k, v, mask, scale, causal)
        delta = (do.float() * o.float()).sum(-1)
        args = (q, k, v, mask, lse, delta, do, scale, causal)
        got_k, got_v = fa.flash_attention_bwd_dkv(*args)
        got_q = fa.flash_attention_bwd_dq(*args)
        want_q, want_k, want_v = fa.flash_attention_bwd_plain(*args)
        torch.cuda.synchronize()
        lq, lk, lv = (x.detach().requires_grad_() for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(
            lq, lk, lv, attn_mask=None if mask is None else mask.to(dtype),
            is_causal=causal, scale=scale)
        r = {"dq_err": _max_err(got_q, want_q),
             "dk_err": _max_err(got_k, want_k),
             "dv_err": _max_err(got_v, want_v),
             "dkv_ms": _median_ms(torch, lambda: fa.flash_attention_bwd_dkv(
                 *args)),
             "dq_ms": _median_ms(torch, lambda: fa.flash_attention_bwd_dq(
                 *args)),
             "delta_ms": _median_ms(torch, lambda: (
                 do.float() * o.float()).sum(-1)),
             "library_ms": _median_ms(torch, lambda: torch.autograd.grad(
                 lib_out, (lq, lk, lv), do, retain_graph=True))}
        r["pair_ms"] = r["dkv_ms"] + r["dq_ms"] + r["delta_ms"]
        r["pair_over_library"] = r["pair_ms"] / r["library_ms"]
        out[name] = r
    return out


def _layer_norm(torch, dev):
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import layer_norm as ln
    out = {}
    for name, rows, cols, dt in LN_SHAPES:
        dtype = getattr(torch, dt)
        g = torch.Generator(device=dev).manual_seed(3)
        x = (torch.randn(rows, cols, generator=g, device=dev) * 3 + 1
             ).to(dtype)
        gy = torch.randn(rows, cols, generator=g, device=dev).to(dtype)
        scale = torch.rand(cols, generator=g, device=dev) + 0.5
        bias = torch.randn(cols, generator=g, device=dev)
        lw, lb = scale.to(dtype), bias.to(dtype)
        y, mean, rstd = ln.layer_norm(x, scale, bias, 1e-5)
        dx, dscale, dbias = ln.layer_norm_bwd(x, gy, scale, mean, rstd)
        want = ln.layer_norm_plain(x, scale, bias, 1e-5)
        want_b = ln.layer_norm_bwd_plain(x, gy, scale, mean, rstd)
        _, lmean, lrstd = torch.ops.aten.native_layer_norm(
            x, (cols,), lw, lb, 1e-5)
        torch.cuda.synchronize()

        def library_bwd(x, gy):
            return torch.ops.aten.native_layer_norm_backward(
                gy, x, (cols,), lmean, lrstd, lw, lb, [True, True, True])
        nbytes = x.numel() * x.element_size()
        ring = [(x.clone(), gy.clone())
                for _ in range(-(-2 * L2_BYTES // (2 * nbytes)) + 1)]
        r = {"y_err": _max_err(y, want[0]),
             "dx_err": _max_err(dx, want_b[0]),
             "cols_err": max(_max_err(dscale, want_b[1]),
                             _max_err(dbias, want_b[2])),
             "fwd_ms": _median_ms(torch, lambda: ln.layer_norm(
                 x, scale, bias, 1e-5), 7, 10),
             "fwd_cold_ms": _cold_ms(torch, lambda s: ln.layer_norm(
                 s[0], scale, bias, 1e-5), ring),
             "fwd_library_ms": _median_ms(torch, lambda: F.layer_norm(
                 x, (cols,), lw, lb, 1e-5), 7, 10),
             "fwd_library_cold_ms": _cold_ms(torch, lambda s: F.layer_norm(
                 s[0], (cols,), lw, lb, 1e-5), ring),
             "fwd_bound_ms": _bound_ms(8.0 * rows * cols, 2 * nbytes +
                                       8 * (rows + cols), "float32"),
             "bwd_ms": _median_ms(torch, lambda: ln.layer_norm_bwd(
                 x, gy, scale, mean, rstd), 7, 10),
             "bwd_cold_ms": _cold_ms(torch, lambda s: ln.layer_norm_bwd(
                 s[0], s[1], scale, mean, rstd), ring),
             "bwd_library_ms": _median_ms(torch, lambda: library_bwd(x, gy),
                                          7, 10),
             "bwd_library_cold_ms": _cold_ms(torch, lambda s: library_bwd(
                 *s), ring),
             "bwd_bound_ms": _bound_ms(12.0 * rows * cols, 3 * nbytes +
                                       8 * rows + 12 * cols, "float32")}
        for d in ("fwd", "bwd"):
            r[d + "_cold_share_of_bound"] = \
                r[d + "_bound_ms"] / r[d + "_cold_ms"]
        out[name] = r
        del ring
    return out


def _one_tree(kernels):
    import torch
    sys.path.insert(0, os.getcwd())
    from paddle_tpu_torch.framework.executor import set_precision
    set_precision()                          # no TF32 anywhere
    dev = torch.device("cuda", 0)
    out = {"tree": os.getcwd(), "kernels": kernels, "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()}
    out.update({"head": _head, "flash_bwd": _flash_bwd,
                "flash_fwd": _flash_fwd,
                "layer_norm": _layer_norm}[kernels](torch, dev))
    print(json.dumps(out), flush=True)


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", choices=("head", "flash_bwd", "flash_fwd",
                                          "layer_norm"), required=True)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("trees", nargs="*")
    args = ap.parse_args(argv)
    if args.one:
        import torch
        if not torch.cuda.is_available():
            return 2
        _one_tree(args.kernels)
        return 0
    for tree in args.trees:
        done = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", "--kernels", args.kernels], cwd=tree)
        if done.returncode:
            return done.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
