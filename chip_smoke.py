#!/usr/bin/env python3
"""Drive paddle_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

run from the root of a checkout, on a machine with an NVIDIA H100 (any
sm_90 card), ``nvcc`` and PyTorch built for CUDA. It builds the port's
CUDA kernels from ``paddle_tpu_torch/ops/kernels/csrc/``, holds each
against its plain PyTorch version at the main path's shapes, serves
BERT-base (full width, T=512, random weights from a seed) through
``inference.create_predictor`` on the card, checks the answers against
the same saved model served on the CPU, and checks from the kernels'
launch counters that every request went through both kernels. A
profile phase then splits one warm request's device time by kernel
family.

Each phase prints JSON lines. The last three lines are the card's
``nvidia-smi`` name and power limit, the ``{"kernels": [...]}`` summary
and ``{"ok": true, "device": {...}}``. Any failed phase exits non-zero
without the ``ok`` line; so does a machine without a CUDA device, or a
directory without the package.
"""
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

SEED = 1234
SEQ_LEN = 512
REQUEST_BATCHES = (1, 3, 8, 1, 3, 8)     # each size cold, then warm
BUCKETS = (1, 2, 4, 8)
FLASH_PER_REQUEST = 12                   # one attention per layer
LN_PER_REQUEST = 25                      # 1 + 2 per layer

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel is the
# larger of its bytes over the memory rate and its operations over the
# peak rate for their type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

# Tolerances of a kernel against its plain version on the same inputs.
# f32: both sum in f32, in another order -> a few ulps of values of
# order 1. bf16: both compute in f32 from the same bf16 inputs and round
# the output to bf16 (8 significant bits), so they may differ by one bf16
# ulp: 2^-7 of values up to 2 (attention averages values of order 1), up
# to 2^-5 for LayerNorm outputs that reach 4-8. mean/lse/rstd are f32.
TOL = {("flash", "float32"): 2e-5, ("flash", "bfloat16"): 1e-2,
       ("ln", "float32"): 1e-4, ("ln", "bfloat16"): 6.25e-2,
       "stat": 1e-4}
# GPU vs CPU serving of one request: f32 end to end without TF32 on
# either side; the summation order differs per matmul, LayerNorm and
# attention, and the differences pass through 12 layers of values of
# order 1.
SERVE_ATOL = 1e-3

_ROOT = os.path.dirname(os.path.abspath(__file__))
_failed = []


def emit(obj):
    print(json.dumps(obj), flush=True)


def phase(name):
    """Run the decorated function as phase ``name``; a raise marks the
    run failed and prints the error as the phase's line."""
    def deco(fn):
        def run(*args):
            try:
                return fn(*args)
            except Exception as e:  # report, and keep the other phases
                _failed.append(name)
                emit({"phase": name, "ok": False,
                      "error": "%s: %s" % (type(e).__name__, e)})
                return None
        return run
    return deco


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps=7, inner=10):
    """Median device time of one call of ``fn`` (CUDA events over
    ``inner`` calls queued behind a sleep kernel, so the host's launch
    cost stays off the clock)."""
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


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def flash_cases(torch, fa, F):
    """(name, b, h, tq, tk, d, dtype, mask mode, causal) on the card."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        ("bert_base_k_mask_f32", 8, 12, 512, 512, 64, f32, "k", False),
        ("bert_base_k_mask_bf16", 8, 12, 512, 512, 64, bf16, "k", False),
        ("gpt_base_causal_f32", 1, 12, 1024, 1024, 64, f32, None, True),
        ("qk_mask_f32", 2, 12, 256, 256, 64, f32, "qk", False),
        ("ragged_d128_k_mask_f32", 2, 8, 200, 333, 128, f32, "k", False),
        ("causal_tq_gt_tk_f32", 2, 12, 300, 200, 64, f32, None, True),
    ]
    dev = torch.device("cuda", 0)
    out = []
    for i, (name, b, h, tq, tk, d, dtype, mode, causal) in enumerate(cases):
        g = torch.Generator(device=dev).manual_seed(SEED + i)
        q, k, v = (torch.randn(b, h, t, d, generator=g, device=dev)
                   .to(dtype) for t in (tq, tk, tk))
        mask = None
        if mode == "k":
            # BERT's key-padding bias: 0 for tokens, -1e4 for the padding
            lens = torch.randint(tk // 2, tk + 1, (b,), generator=g,
                                 device=dev)
            mask = torch.where(torch.arange(tk, device=dev)[None, :] <
                               lens[:, None], 0.0, -1e4).reshape(b, 1, 1, tk)
        elif mode == "qk":
            mask = torch.randn(b, 1, tq, tk, generator=g, device=dev)
        scale = d ** -0.5
        got, lse = fa.flash_attention(q, k, v, mask, scale, causal)
        want, want_lse = fa.flash_attention_plain(q, k, v, mask, scale,
                                                  causal)
        torch.cuda.synchronize()
        err, lse_err = _max_err(got, want), _max_err(lse, want_lse)
        tol = TOL[("flash", str(dtype).split(".")[1])]
        library_ms = None
        if not causal or (mask is None and tq == tk):
            lib_mask = None if mask is None else mask.to(dtype)
            library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=lib_mask, is_causal=causal, scale=scale))
        # work this run needs: 4*D flops per visible (query, key) pair; a
        # causal row that sees no key averages every value (the
        # reference's definition), so it counts all keys
        if causal:
            pairs = sum(min(tk, i + tk - tq + 1) if i + tk - tq >= 0 else tk
                        for i in range(tq))
        else:
            pairs = tq * tk
        flops = 4.0 * b * h * pairs * d
        nbytes = (q.numel() * 2 + k.numel() + v.numel()) * q.element_size() \
            + (0 if mask is None else mask.numel() * 4) + lse.numel() * 4
        out.append(dict(
            name=name, shape=[b, h, tq, tk, d], dtype=str(dtype).split(".")[1],
            mask=mode, causal=causal,
            max_abs_err=err, lse_max_abs_err=lse_err, tol=tol,
            lse_tol=TOL["stat"],
            ok=err <= tol and lse_err <= TOL["stat"],
            kernel_ms=time_ms(torch, lambda: fa.flash_attention(
                q, k, v, mask, scale, causal)),
            plain_ms=time_ms(torch, lambda: fa.flash_attention_plain(
                q, k, v, mask, scale, causal)),
            library_ms=library_ms,
            **_bound(flops, nbytes, str(dtype).split(".")[1])))
    return out


def ln_cases(torch, ln, F):
    cases = [("bert_base_f32", 4096, 768, torch.float32),
             ("bert_base_bf16", 4096, 768, torch.bfloat16),
             ("wide_8192_f32", 64, 8192, torch.float32)]
    dev = torch.device("cuda", 0)
    out = []
    for i, (name, rows, cols, dtype) in enumerate(cases):
        g = torch.Generator(device=dev).manual_seed(SEED + 100 + i)
        x = (torch.randn(rows, cols, generator=g, device=dev) * 3 + 1
             ).to(dtype)
        scale = torch.rand(cols, generator=g, device=dev) + 0.5
        bias = torch.randn(cols, generator=g, device=dev)
        got = ln.layer_norm(x, scale, bias, 1e-5)
        want = ln.layer_norm_plain(x, scale, bias, 1e-5)
        torch.cuda.synchronize()
        err = _max_err(got[0], want[0])
        stat_err = max(_max_err(got[1], want[1]), _max_err(got[2], want[2]))
        tol = TOL[("ln", str(dtype).split(".")[1])]
        nbytes = 2 * x.numel() * x.element_size() + 2 * cols * 4 + \
            2 * rows * 4
        out.append(dict(
            name=name, shape=[rows, cols], dtype=str(dtype).split(".")[1],
            max_abs_err=err, stat_max_abs_err=stat_err, tol=tol,
            stat_tol=TOL["stat"], ok=err <= tol and stat_err <= TOL["stat"],
            kernel_ms=time_ms(torch, lambda: ln.layer_norm(
                x, scale, bias, 1e-5)),
            plain_ms=time_ms(torch, lambda: ln.layer_norm_plain(
                x, scale, bias, 1e-5)),
            library_ms=time_ms(torch, lambda: F.layer_norm(
                x, (cols,), scale.to(dtype), bias.to(dtype), 1e-5)),
            # ~8 f32 operations per element: mean, centre, square, sum,
            # normalise, scale, shift
            **_bound(8.0 * rows * cols, nbytes, "float32")))
    return out


def _bound(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(flops=flops, bytes=nbytes, bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def bert_feeds(np, rng, n, vocab):
    t = SEQ_LEN
    mask = np.ones((n, t, 1), np.float32)
    for row in range(1, n):                  # trailing padding
        mask[row, rng.randint(t // 4, t):, 0] = 0.0
    return {"src_ids": rng.randint(0, vocab, (n, t, 1)).astype(np.int64),
            "pos_ids": np.tile(np.arange(t).reshape(1, t, 1),
                               (n, 1, 1)).astype(np.int64),
            "sent_ids": (np.arange(t).reshape(1, t, 1) >= t // 2).repeat(
                n, 0).astype(np.int64),
            "input_mask": mask}


def serve(torch, np, ptt, fa, ln, model_dir):
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.models import bert

    cfg = bert.bert_base()
    t0 = time.perf_counter()
    main, startup = ptt.Program(), ptt.Program()
    startup.random_seed = SEED
    with ptt.unique_name.guard(), ptt.program_guard(main, startup):
        feeds = [layers.data(n, [SEQ_LEN, 1], dtype=dt) for n, dt in (
            ("src_ids", "int64"), ("pos_ids", "int64"),
            ("sent_ids", "int64"), ("input_mask", "float32"))]
        seq_out, pooled = bert.bert_encoder(*feeds, cfg, is_test=True)
    with ptt.scope_guard(ptt.Scope()):
        exe = ptt.Executor()                 # CUDAPlace(0)
        exe.run(startup)
        ptt.save_inference_model(model_dir, [f.name for f in feeds],
                                 [seq_out, pooled], exe, main_program=main)
    config = Config(model_dir)
    config.batch_buckets = BUCKETS
    pred = create_predictor(config)
    setup_s = time.perf_counter() - t0

    rng = np.random.RandomState(SEED)
    requests = [bert_feeds(np, rng, n, cfg.vocab_size)
                for n in REQUEST_BATCHES]
    fa.launches = ln.launches = 0            # the main path starts here
    lat, per_request, answers = [], [], []
    for feed in requests:
        before = (fa.launches, ln.launches)
        t1 = time.perf_counter()
        outs = pred.run(feed)                # numpy: synchronised
        lat.append((time.perf_counter() - t1) * 1e3)
        per_request.append([fa.launches - before[0],
                            ln.launches - before[1]])
        answers.append(outs)
    launches = {"flash_attention_fwd": fa.launches,
                "layer_norm_fwd": ln.launches}
    shapes_ok = all(
        o[0].shape == (len(f["src_ids"]), SEQ_LEN, cfg.hidden_size) and
        o[1].shape == (len(f["src_ids"]), cfg.hidden_size) and
        all(np.isfinite(a).all() for a in o)
        for f, o in zip(requests, answers))
    counts_ok = all(c == [FLASH_PER_REQUEST, LN_PER_REQUEST]
                    for c in per_request)

    # the same saved model served on the CPU (plain versions), request 0
    cpu_config = Config(model_dir)
    cpu_config.place = ptt.CPUPlace()
    t2 = time.perf_counter()
    cpu_outs = create_predictor(cpu_config).run(requests[0])
    cpu_ms = (time.perf_counter() - t2) * 1e3
    errs = [float(np.abs(g - c).max()) for g, c in zip(answers[0], cpu_outs)]
    ok = shapes_ok and counts_ok and max(errs) <= SERVE_ATOL
    emit({"phase": "serve", "ok": ok, "model": "bert_base",
          "hidden": cfg.hidden_size, "layers": cfg.num_layers,
          "heads": cfg.num_heads, "seq_len": SEQ_LEN, "dtype": "float32",
          "buckets": list(BUCKETS), "setup_s": setup_s,
          "request_batches": list(REQUEST_BATCHES), "latency_ms": lat,
          "launches_per_request": per_request, "shapes_finite_ok": shapes_ok,
          "cpu_request_ms": cpu_ms,
          "gpu_vs_cpu_max_abs_err": {"sequence_output": errs[0],
                                     "pooled": errs[1]},
          "atol": SERVE_ATOL,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    if not ok:
        raise AssertionError("serve checks failed (see the line above)")
    return launches, pred, requests


def _family(kernel):
    k = kernel.lower()
    for key, fam in (("flash_fwd_kernel", "flash_attention_fwd"),
                     ("ln_fwd_kernel", "layer_norm_fwd"),
                     ("memcpy", "memcpy host<->device"),
                     ("gemm", "matmul"), ("xmma", "matmul"),
                     ("cutlass", "matmul"), ("copy", "copy (layout/dtype)")):
        if key in k:
            return fam
    return "elementwise/other"


def profile(torch, pred, requests):
    """Where one warm request's time goes on the card: device time by
    kernel family from torch.profiler, against the request's host time
    (the profiler's own cost included). Diagnostic only: a profiler that
    records no device time is reported, not failed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    for feed in (requests[0], requests[2]):  # batch 1 and batch 8
        pred.run(feed)
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pred.run(feed)
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_family, top = {}, []
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            ms = e.self_device_time_total / 1e3
            fam = _family(e.key)
            by_family[fam] = by_family.get(fam, 0.0) + ms
            top.append([ms, e.count, e.key[:100]])
        busy = sum(by_family.values())
        emit({"phase": "profile", "batch": len(feed["src_ids"]),
              "host_ms": wall_ms, "device_busy_ms": busy if busy else
              "not measured",
              "idle_share": 1 - busy / wall_ms if busy else "not measured",
              "device_ms_by_family": by_family,
              "top_kernels": sorted(top, reverse=True)[:10]})


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this check runs on "
              "the card only", file=sys.stderr)
        return 2
    sys.path.insert(0, _ROOT)
    try:
        import paddle_tpu_torch as ptt
        from paddle_tpu_torch.ops.kernels import build
        from paddle_tpu_torch.ops.kernels import flash_attention as fa
        from paddle_tpu_torch.ops.kernels import layer_norm as ln
    except ImportError as e:
        print("chip_smoke: run it from a checkout of the repository "
              "(%s)" % e, file=sys.stderr)
        return 2
    import torch.nn.functional as F
    from paddle_tpu_torch.framework.executor import set_precision
    set_precision()                          # no TF32 anywhere

    smi = phase("device")(nvidia_smi)()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    lib = phase("build")(build.load)()
    if lib is None:
        return 1
    with open(os.path.join(build.library_dir(), "nvcc.log")) as f:
        ptxas = [ln_.strip() for ln_ in f if "Used" in ln_ or "spill" in ln_]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": build.build_seconds, "ptxas": ptxas})

    def kernels():
        fl, lc = flash_cases(torch, fa, F), ln_cases(torch, ln, F)
        ok = all(c["ok"] for c in fl + lc)
        emit({"phase": "kernels", "ok": ok, "flash_attention_fwd": fl,
              "layer_norm_fwd": lc})
        if not ok:
            raise AssertionError("a kernel disagrees with its plain version")
        return fl, lc
    cases = phase("kernels")(kernels)()

    model_dir = os.path.join(_ROOT, "build", "chip_smoke_model")
    try:
        served = phase("serve")(serve)(torch, np, ptt, fa, ln, model_dir)
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)
    launches = None
    if served is not None:
        launches, pred, requests = served
        phase("profile")(profile)(torch, pred, requests)

    if cases is not None and launches is not None:
        fl, lc = cases
        print(smi, flush=True)
        emit({"kernels": [
            _summary("flash_attention_fwd",
                     "paddle_tpu_torch/ops/kernels/csrc/flash_attention_fwd.cu",
                     "paddle_tpu/ops/pallas/flash_attention.py:211",
                     launches["flash_attention_fwd"], fl),
            _summary("layer_norm_fwd",
                     "paddle_tpu_torch/ops/kernels/csrc/layer_norm_fwd.cu",
                     "paddle_tpu/ops/pallas/layer_norm.py:97",
                     launches["layer_norm_fwd"], lc)]})
    if _failed or cases is None or launches is None:
        print("chip_smoke: failed phases: %s" % _failed, file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


def _summary(name, source, replaces, launches, cases):
    """A kernel's line: its numbers at the main path's shape (the first
    case: BERT-base at the largest bucket), every case beside them."""
    head = cases[0]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": head["max_abs_err"], "ms": head["kernel_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head["shape"], "cases": cases}


if __name__ == "__main__":
    sys.exit(main())
