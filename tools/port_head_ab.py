#!/usr/bin/env python3
"""Time the port's fused-head kernels in several checkouts, one after the
other on the same card, to compare two versions of them.

    python3 tools/port_head_ab.py TREE_A TREE_B TREE_B TREE_A

Each TREE is the root of a checkout (with ``paddle_tpu_torch/``). Every
argument runs in its own process, in the order given, which builds that
tree's kernels into its own ``build/`` and prints one JSON line: the
card's name and power limit, and for each shape the forward, dhidden and
dweight kernels' median times (CUDA events) and their errors against the
tree's plain versions. Needs a CUDA card; prints nothing and exits
non-zero without one.
"""
import json
import os
import statistics
import subprocess
import sys

# (name, T, D, V, dtype): GPT-base's head in f32, a bf16 head, and two
# shapes whose tiles load element by element (D not a multiple of 4) or
# in 16-row blocks (D above 768)
SHAPES = (("gpt_base_f32", 8192, 768, 32000, "float32"),
          ("bf16", 2048, 768, 32000, "bfloat16"),
          ("ragged_d99_f32", 257, 99, 1001, "float32"),
          ("wide_d1000_f32", 300, 1000, 777, "float32"))
TIMED = ("gpt_base_f32", "bf16")


def _median_ms(torch, fn, reps=5, inner=3):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _one_tree():
    import torch
    sys.path.insert(0, os.getcwd())
    from paddle_tpu_torch.ops.kernels import blockwise_ce as bce
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out = {"tree": os.getcwd(), "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()}
    for name, t, d, v, dt in SHAPES:
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
            return float((a.float() - b.float()).abs().max() /
                         b.float().abs().max())
        r = {"loss_err": float((loss - want_loss).abs().max()),
             "dh_rel": rel(dh, want_dh), "dw_rel": rel(dw, want_dw)}
        if name in TIMED:
            r.update(
                fwd_ms=_median_ms(torch, lambda: bce.fused_head_loss(
                    h, w, lab)),
                dh_ms=_median_ms(torch, lambda: bce.fused_head_dhidden(
                    *args)),
                dw_ms=_median_ms(torch, lambda: bce.fused_head_dweight(
                    *args)))
        out[name] = r
    print(json.dumps(out), flush=True)


def main(trees):
    for tree in trees:
        done = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one"], cwd=tree)
        if done.returncode:
            return done.returncode
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--one"]:
        import torch
        if not torch.cuda.is_available():
            sys.exit(2)
        _one_tree()
    else:
        sys.exit(main(sys.argv[1:]))
