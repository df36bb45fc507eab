"""Kernel launch-config autotuner (counterpart of the JAX package's
tools/autotune.py).

Sweeps each kernel family's launch configs per (op, shape, dtype,
topology, card), pruned to the cost model's ``--top-k`` best-predicted
candidates by default (all of them with ``--top-k 0``), holds each
candidate's outputs against the plain version, times the survivors and
the library yardstick with CUDA events, banks the winners and every
measured row in the versioned JSON cache that ``CompiledProgram`` reads
through ``BuildStrategy.pallas_tune_cache`` (or, under
``kernel_policy="auto"``, the banked ``paddle_tpu_torch/tools/tuned/
<card>.json``), and prints ONE JSON summary line.

Usage (on the card):
  python -m paddle_tpu_torch.tools.autotune                  # all ops, top-3
  python -m paddle_tpu_torch.tools.autotune --top-k 0        # exhaustive
  python -m paddle_tpu_torch.tools.autotune --cost-model-only
  python -m paddle_tpu_torch.tools.autotune --ops adam,layer_norm \\
      --shape layer_norm=4096x768 --dtype bfloat16 --cache tune.json
  python -m paddle_tpu_torch.tools.autotune --bank nvidia-h100-80gb-hbm3
  python -m paddle_tpu_torch.tools.autotune --dry-run        # tiny shapes

``--bank CARD`` sweeps every candidate at ``DEFAULT_SHAPES`` (f32, and
LayerNorm, Adam and the head in bf16 too) on the attached card, whose backend name must be
CARD, into ``tools/tuned/CARD.json``, with the card's name and power
limit (``nvidia-smi``) in its meta; ``tools.tunecheck`` validates it.
``--dry-run`` sweeps tiny shapes on the card, or on the CPU where each
wrapper runs its plain version (the harness end to end), into a
throwaway file, and refuses ``tools/tuned/``: only ``--bank`` writes
there.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

#: the banked grid beyond DEFAULT_SHAPES in f32: bf16 too, but for CE
#: (the bf16 step's LayerNorm and Adam calls, the pallas_q head)
BANK_EXTRA = (("layer_norm", "bfloat16"), ("adam", "bfloat16"),
              ("fused_mlm_head_loss", "bfloat16"))


def _parse_shape(text):
    return tuple(int(d) for d in text.lower().split("x"))


def _under_tuned_dir(path, tuned_dir):
    return os.path.commonpath([os.path.abspath(path),
                               os.path.abspath(tuned_dir)]) == \
        os.path.abspath(tuned_dir)


def card_meta():
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, timeout=30, check=False)
        return out.stdout.decode(errors="replace").strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return None


def main(argv=None):
    import torch
    from paddle_tpu_torch.ops import kernel_dispatch as kd
    from paddle_tpu_torch.ops.kernels import autotune as at

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ops", default=",".join(kd.PALLAS_OPS),
                    help="comma-separated op names to sweep")
    ap.add_argument("--shape", action="append", default=[],
                    metavar="OP=DIMxDIM",
                    help="sweep shape override, e.g. layer_norm=4096x768 "
                         "(repeatable)")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--mesh-axes", default=None, metavar="AXIS=N,...",
                    help="mesh axes of the compile the cache will serve "
                         "(default: none in the key, serving every "
                         "topology)")
    ap.add_argument("--probes", type=int, default=3,
                    help="timed runs per candidate (best-of)")
    ap.add_argument("--top-k", type=int, default=3, metavar="K",
                    help="measure only the K best cost-model-predicted "
                         "candidates (0 = exhaustive sweep)")
    ap.add_argument("--cost-model-only", action="store_true",
                    help="measure NOTHING: bank the model's top "
                         "predicted config per key (zero probes)")
    ap.add_argument("--cache", default=None,
                    help="cache JSON path (default: $%s or ~/.cache/"
                         "paddle_tpu_torch/kernel_autotune.json)"
                         % at.DEFAULT_CACHE_ENV)
    ap.add_argument("--candidate-deadline-s", type=float, default=120.0,
                    help="wall budget per candidate")
    ap.add_argument("--dry-run", action="store_true",
                    help="tiny shapes, 1 probe, a throwaway cache: the "
                         "sweep harness itself (the CPU runs the plain "
                         "versions)")
    ap.add_argument("--bank", default=None, metavar="CARD",
                    help="refresh the committed tools/tuned/CARD.json: "
                         "an exhaustive sweep of DEFAULT_SHAPES on the "
                         "attached card")
    args = ap.parse_args(argv)

    ops = [o.strip() for o in args.ops.split(",") if o.strip()]
    unknown = sorted(set(ops) - set(kd.PALLAS_OPS))
    if unknown:
        ap.error("unknown ops %r (available: %s)"
                 % (unknown, ",".join(kd.PALLAS_OPS)))
    if args.dry_run and args.bank:
        ap.error("--dry-run and --bank are mutually exclusive (a smoke "
                 "run must never write the committed caches)")
    if args.cost_model_only and args.bank:
        ap.error("--cost-model-only and --bank are mutually exclusive: "
                 "the committed caches hold MEASURED rows (the cost "
                 "model fits learn from them)")
    mesh_axes = None
    if args.mesh_axes:
        try:
            mesh_axes = {a: int(n) for a, n in
                         (item.split("=") for item in
                          args.mesh_axes.split(","))}
        except ValueError:
            ap.error("bad --mesh-axes %r (want AXIS=N,...)"
                     % args.mesh_axes)
    cache_path = args.cache
    if args.dry_run and cache_path and \
            _under_tuned_dir(cache_path, at.tuned_dir()):
        ap.error("--dry-run refuses to write into %s (%s): the committed "
                 "banked caches are refreshed by --bank only"
                 % (at.tuned_dir(), cache_path))

    cuda = torch.cuda.is_available()
    if not cuda and not args.dry_run:
        ap.error("the sweep times the kernels on a CUDA card and torch "
                 "sees none; --dry-run exercises the harness on the CPU")
    device = torch.device("cuda", torch.cuda.current_device()) if cuda \
        else torch.device("cpu")
    backend = kd.backend_name(device)
    if cuda:
        from paddle_tpu_torch.framework.executor import set_precision
        set_precision()                 # f32 products in full f32
    grid = []                           # (op, shape, dtype)
    meta = None
    if args.bank:
        if args.bank != backend:
            ap.error("--bank %s on a card whose backend name is %s: a "
                     "banked verdict belongs to the card it was measured "
                     "on" % (args.bank, backend))
        grid = [(op, at.DEFAULT_SHAPES[op], "float32") for op in ops]
        grid += [(op, at.DEFAULT_SHAPES[op], dt) for op, dt in BANK_EXTRA
                 if op in ops]
        cache_path = at.banked_cache_path(args.bank)
        meta = {"backend": args.bank, "model_version": at.cm.MODEL_VERSION,
                "card": card_meta(), "torch": torch.__version__,
                "cuda": torch.version.cuda, "head_hidden": at.HEAD_D,
                "grid": {op: [list(at.DEFAULT_SHAPES[op])] for op in ops}}
    else:
        shapes = dict(at.DRY_SHAPES if args.dry_run else at.DEFAULT_SHAPES)
        for item in args.shape:
            op, _, dims = item.partition("=")
            if op not in shapes or not dims:
                ap.error("bad --shape %r (want OP=DIMxDIM)" % item)
            shapes[op] = _parse_shape(dims)
        grid = [(op, shapes[op], args.dtype) for op in ops]
        if cache_path is None and args.dry_run:
            fd, cache_path = tempfile.mkstemp(
                prefix="kernel_autotune_dry_", suffix=".json")
            os.close(fd)
    cache = at.AutotuneCache(cache_path, meta=meta)
    probes = 1 if args.dry_run else args.probes
    # banking keeps the rows whole (the fit learns from all of them)
    top_k = None if (args.bank or args.top_k <= 0 or
                     args.cost_model_only) else args.top_k
    hidden = at.DRY_HEAD_D if args.dry_run else at.HEAD_D
    summaries = {}
    ok = True
    for op, shape, dtype in grid:
        try:
            s = at.autotune_op(
                op, shape, dtype=dtype, probes=probes, device=device,
                cache=cache, mesh_axes=mesh_axes, backend=backend,
                candidate_deadline_s=args.candidate_deadline_s,
                top_k=top_k, cost_model_only=args.cost_model_only,
                d=hidden if op == "fused_mlm_head_loss" else None)
        except (RuntimeError, ValueError) as e:
            # one broken sweep must not eat the rest
            s = {"op": op, "shape": list(shape), "dtype": dtype,
                 "error": "%s: %s" % (type(e).__name__, e)}
            ok = False
        summaries["%s|%s" % (op, dtype)] = s
    print(json.dumps({
        "metric": "kernel_autotune", "dry_run": bool(args.dry_run),
        "bank": args.bank, "backend": backend, "top_k": top_k,
        "cost_model_only": bool(args.cost_model_only),
        "cache": cache.path, "entries": len(cache),
        "ok": ok and all("entry" in s for s in summaries.values()),
        "sweeps": summaries}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
