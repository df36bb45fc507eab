#!/usr/bin/env python3
"""Drive paddle_tpu_torch's main paths on one CUDA card and check them.

    python3 chip_smoke.py

run from the root of a checkout, on a machine with an NVIDIA H100 (any
sm_90 card), ``nvcc`` and PyTorch built for CUDA. It builds the port's
CUDA kernels from ``paddle_tpu_torch/ops/kernels/csrc/`` and holds each
of the eleven against its plain PyTorch version at the main paths' shapes
(the flash, LayerNorm and head kernels and the CE backward also against
themselves: two runs must give equal bits; the flash backward pair, with
its delta pass, and the head backward pair also timed beside the
library's backward as ``pair_ms``; the LayerNorm kernels at BERT's and
GPT's shapes also timed with the L2 cold, ``kernel_cold_ms`` beside
``library_cold_ms``). Then it drives the main paths, each with the
kernels' launch counters set to 0 just before and read just after:

- ``serve``: BERT-base (full width, T=512, random weights from a seed)
  through ``inference.create_predictor`` on the card, answers checked
  against the same saved model served on the CPU; 12 flash-attention
  and 25 LayerNorm forward launches per request.
- ``train``: BERT-base MLM+NSP pretraining (full width, batch 32,
  seq 128, dropout 0.1, Adam 1e-4) for six steps on one batch; losses
  finite and falling; per step 12 flash-attention forward, 12 dK/dV, 12
  dQ, 26 LayerNorm forward, 26 LayerNorm backward and 206 fused-Adam
  launches.
- ``gpt_train``: GPT-base next-token pretraining (full width, vocab
  32000, batch 2 x 4096, f32, Adam 1e-4) for six steps on one batch;
  losses finite and falling; per step 12/12/12 flash-attention (causal,
  T = 4096), 25/25 LayerNorm, 148 fused-Adam and one launch of each of
  the three fused-head kernels; peak device memory.
- ``gpt_eval``: on the trained scope, the decode program's logits (2 x
  4096 x 32000) through ``softmax_with_cross_entropy``, a masked mean and
  its gradient to the logits: one launch each of the CE forward and
  backward kernels; the loss must equal the fused-head kernel's loss of
  the same weights and batch (``gpt_pretrain_program(is_test=True)``).
- ``gpt_decode``: ``greedy_generate`` (batch 4, a 64-token prompt, 16
  new tokens) on the card; the CPU's logits of the card's tokens must
  put each chosen token within SERVE_ATOL of its step's maximum.
- ``train_bf16``: BERT-base pretraining at bench.py:388-389 with nothing
  cut: bf16, batch 128 x 128, 20 masked positions, dropout 0.1, Adam
  1e-4, six steps; the launches of ``train`` a step; peak memory.
- ``gpt_train_bf16``: GPT-base at bench.py:596-601 exactly (bf16, flash,
  recompute, 2 x 4096, Adam 1e-4), six steps: per step 24 flash forward
  (each block's forward runs again in the backward), 12/12 flash
  backward, 49/25 LayerNorm, 148 Adam and 1/1/1 head launches; then
  three steps without recompute from the same startup (12 flash and 25
  LayerNorm forward a step), whose step must peak higher and whose first
  loss must equal the recomputed run's bit for bit.
- ``train_recipe``: the train_bf16 model and batch trained with the BERT
  recipe: AdamW (weight decay 0.01; the fused-Adam kernel with its decay,
  206 launches a step), a linear warmup over a polynomial decay, a
  global-norm clip at 1.0; six steps, the fetched rates equal to the
  schedules' closed form, the global norm finite, and train_bf16's
  flash and LayerNorm launches a step. ``train_recipe_lamb``: the same
  with LAMB, three steps, no Adam launch.

Every Executor.run with a fetch list on the card is graphed from its
key's second run (the first goes op by op, the second is captured into
a CUDA graph and replayed, later runs replay; ``Executor.run`` docs), so
the phases above time replays from their third step and their parity
phases hold replays against the CPU. The slice's own phases run each
path both ways in one process, op by op (``use_program_cache=False``)
and graphed, GRAPH_STEPS runs each from one startup and run counter:

- ``graph_serve``: BERT-base serving at T=512, batches 1 and 8: answers
  bit for bit equal, latency both ways, launches per request.
- ``graph_train``: the train_recipe step (bf16, batch 128 x 128, dropout
  0.1): fetches (losses, rate, global norm, a dropout Mask) and final
  state bit for bit equal, the Mask different every step, equal
  launches a step; and the step's 206 fused-Adam launches replayed from
  a graph against one launch per dtype over the same elements.
- ``run_steps``: a GRAPH_STEPS-step ``Executor.run_steps`` window of
  that step equals the graphed runs bit for bit; ms per step.
- ``graph_gpt``: GPT-base bf16 with flash and recompute at 2 x 4096,
  dropout 0.1 (the recomputed segments redraw their masks inside the
  graph), checked as graph_train; and a seedless dropout inside a
  recompute segment, replayed, whose gradient must use its forward's
  mask.

Each profiles one run both ways (device busy, idle share) and lists
the replay's kernels: the path's hand-written kernels must appear and
no library attention, LayerNorm or Adam kernel; the capture's time and
the pool's growth come from ``Executor.capture_log``. Every phase
closes its Executors (``close`` lines give the memory still reserved).

``train_parity`` and ``gpt_train_parity`` run three steps of a 2-layer
BERT-base-width / GPT-base-width model (GPT at 2 x 128 tokens, where the
head kernels tile) on the card and on the CPU from the same weights and
compare losses and final parameters (tolerances at PARITY_*);
``bf16_parity`` does the same in bf16, and on the card holds a 2-layer
bf16 GPT with recompute against the same without, bit for bit
(first-step loss and gradients, three losses, final parameters), and
decodes with a 2-layer bf16 GPT on the card against the CPU's f32 logits
(the widened tied head). ``optimizer_parity`` holds every optimizer
(SGD, Momentum, LarsMomentum, Adagrad, DecayedAdagrad, RMSProp, Adamax,
AdamW, Lamb, Ftrl, Adadelta; AdamW and Lamb also in bf16) under the
recipe's schedule (FTRL at a constant rate) and clip and an L2Decay
regularizer to the same card-against-CPU comparison, and DP-SGD's clip
and noise by their statistics on the card. A profile phase splits one
warm request's, one warm BERT training step's and one warm GPT training
step's device time by kernel family, f32 and bf16 (BERT at batch 128,
GPT with recompute, and the recipe's AdamW and LAMB steps), each a
replay, and ``host_ops`` the host's time issuing each op type of the
bf16 BERT steps run op by op.

Each phase prints JSON lines, also kept whole in
``chiprun_out/chip_smoke.jsonl``. The last three lines are the card's
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
# BERT-base pretraining step (bench.py:388 shapes, batch cut from 128 to
# 32 to keep the phase short): per step one attention per layer forward
# and backward, 25 encoder + 1 MLM-head LayerNorm forward and backward,
# one Adam update per parameter
TRAIN_BATCH, TRAIN_SEQ, TRAIN_PREDS, TRAIN_STEPS = 32, 128, 20, 6
NEW_KERNELS = ("fused_head_fwd", "fused_head_dh", "fused_head_dw", "ce_fwd",
               "ce_bwd")
TRAIN_PER_STEP = dict({"flash_attention_fwd": 12,
                       "flash_attention_bwd_dkv": 12,
                       "flash_attention_bwd_dq": 12, "layer_norm_fwd": 26,
                       "layer_norm_bwd": 26, "fused_adam": 206},
                      **{k: 0 for k in NEW_KERNELS})
PARITY_LAYERS, PARITY_BATCH, PARITY_STEPS = 2, 4, 3
# GPT-base pretraining (bench.py:596-601 widths; dtype bf16 -> f32 and
# recompute off, the port's current slice): per step one causal attention
# per layer forward and backward, 2 LayerNorms per block + the final one,
# one Adam update per parameter (12 per block, two embeddings, final LN
# scale and bias), one launch of each fused-head kernel
GPT_BATCH, GPT_SEQ, GPT_STEPS = 2, 4096, 6
GPT_PER_STEP = {"flash_attention_fwd": 12, "flash_attention_bwd_dkv": 12,
                "flash_attention_bwd_dq": 12, "layer_norm_fwd": 25,
                "layer_norm_bwd": 25, "fused_adam": 148,
                "fused_head_fwd": 1, "fused_head_dh": 1, "fused_head_dw": 1,
                "ce_fwd": 0, "ce_bwd": 0}
# bf16 training at bench.py's own settings, nothing cut. BERT-base
# (bench.py:388-389): bf16, batch 128 x 128, the same launches a step as
# the f32 step. GPT-base (bench.py:596-601): bf16, flash, recompute; the
# backward re-runs each block's forward, so a step launches the flash
# forward 24 times (12 + 12) and the LayerNorm forward 49 (25 + 24); then
# GPT_NO_RECOMPUTE_STEPS steps without recompute (GPT_PER_STEP's counts)
BF16_TRAIN_BATCH = 128
GPT_BF16_PER_STEP = dict(GPT_PER_STEP, flash_attention_fwd=24,
                         layer_norm_fwd=49)
GPT_NO_RECOMPUTE_STEPS = 3
# train_recipe / train_recipe_lamb: BERT-base at bench.py:388-389's
# shapes (bf16, batch 128 x 128, dropout 0.1) trained with the recipe of
# BERT pretraining (Devlin et al. 2018, A.2; LAMB: You et al. 2019):
# AdamW (weight decay 0.01) or LAMB (0.01, none on LayerNorm parameters
# and biases), a linear warmup from 0 over RECIPE_WARMUP steps on top of
# a polynomial decay of RECIPE_LR to 0 over RECIPE_DECAY_STEPS, and a
# global-norm clip at 1.0. The flash and LayerNorm launches of a step are
# train_bf16's; AdamW launches the fused-Adam kernel once per parameter,
# LAMB (plain jnp in the JAX package too) never. Each schedule appends an
# increment of the shared step counter, so the warmup reads counter
# 2k + 1 and the decay 2k at run k (as in the JAX package; ROADMAP.md
# Queue 3): the rates at runs 0-5 are 5e-5, 6.67e-5, 3.33e-5, 0, 0, 0.
RECIPE_LR, RECIPE_WARMUP, RECIPE_DECAY_STEPS = 1e-4, 2, 6
RECIPE_WEIGHT_DECAY, RECIPE_CLIP = 0.01, 1.0
RECIPE_STEPS, RECIPE_LAMB_STEPS = 6, 3
RECIPE_LAMB_PER_STEP = dict(TRAIN_PER_STEP, fused_adam=0)
RECIPE_LR_RTOL = 1e-6
# optimizer_parity: the PARITY_* comparison of train_parity (2-layer
# BERT-base-width, PARITY_BATCH x 128, three steps) for each optimizer
# under the recipe's schedule and clip and an L2Decay(PARITY_L2)
# regularizer, f32, and bf16 for AdamW and LAMB. Each base rate is chosen
# so that three steps move some element by at least 10 * PARITY_PARAM_ATOL
# (the comparison's own floor) while a near-zero gradient whose sign the
# two devices may see differently moves an element by at most
# PARITY_SIGN_FLIP_ATOL: the Adam-like rules step ~lr whatever the
# gradient's size, and the schedule's three rates sum to 1.5 times its
# base, so a base of 1.6e-4 moves an element by up to 2.4e-4 and a
# flipped one by up to 4.8e-4; SGD-like rules step lr * g on clipped
# gradients (|g| <~ 0.1); LARS scales lr by 1e-3 * ||p|| / ||g||; LAMB
# by ||p|| / ||r|| (~0.02 for BERT's weights). FTRL steps an element by
# lr in its gradient's sign however small the gradient (it has no
# epsilon), ~3 lr in three steps, and 2 lr where a near-zero gradient's
# sign differs; it runs at a constant rate: its linear accumulator mixes
# the rates of past steps, so under the schedule (rates 0.5, 0.67, 0.33
# of the base) an element moves by ~(lr_2 / lr_1 - 1) |p| times a ratio
# of its gradients (LayerNorm scales by ~0.4), which amplifies the
# summation-order differences of near-cancelling gradients past the
# comparison (on the H100, FTRL at 5e-6 under the schedule: 276 elements
# beyond PARITY_PARAM_ATOL, largest 3.0e-4; PERF.md).
PARITY_L2 = 1e-4
PARITY_OPTIMIZERS = (
    # (name, base rate, under the schedule, make(optimizer module, rate))
    ("SGD", 1e-2, True, lambda o, lr: o.SGD(lr)),
    ("Momentum_nesterov", 1e-2, True,
     lambda o, lr: o.Momentum(lr, 0.9, use_nesterov=True)),
    ("LarsMomentum", 1.0, True, lambda o, lr: o.LarsMomentum(lr, 0.9)),
    ("Adagrad", 1.6e-4, True, lambda o, lr: o.Adagrad(lr)),
    ("DecayedAdagrad", 1e-4, True, lambda o, lr: o.DecayedAdagrad(lr)),
    ("RMSProp_centered", 1e-4, True,
     lambda o, lr: o.RMSProp(lr, momentum=0.5, centered=True)),
    ("Adamax", 1.6e-4, True, lambda o, lr: o.Adamax(lr)),
    ("AdamW", 1.6e-4, True, lambda o, lr: o.AdamW(lr, weight_decay=0.01)),
    ("Lamb", 1e-3, True, lambda o, lr: o.Lamb(
        lr, lamb_weight_decay=0.01,
        exclude_from_weight_decay_fn=_no_weight_decay)),
    ("Ftrl", 1e-4, False, lambda o, lr: o.Ftrl(lr)),
    ("Adadelta", 1.0, True, lambda o, lr: o.Adadelta(lr)),
)
PARITY_BF16_OPTIMIZERS = ("AdamW", "Lamb")
# Dpsgd draws Gaussian noise: on the card, its clip (sigma 0: a step of
# lr times the gradient clipped to norm DPSGD_CLIP) and its noise (a zero
# gradient: the step is lr times the noise) over DPSGD_N elements, whose
# mean and std must lie within 5 standard errors of 0 and sigma * clip.
DPSGD_N, DPSGD_CLIP, DPSGD_SIGMA, DPSGD_LR = 10 ** 6, 1.0, 1.5, 0.1
DECODE_BATCH, DECODE_PROMPT, DECODE_NEW = 4, 64, 16
PROFILE_PLAIN_RUNS = 3
GPT_PARITY_BATCH, GPT_PARITY_SEQ = 2, 128
# graph_serve, graph_train, graph_gpt, run_steps: each path op by op
# (use_program_cache=False) and graphed (the default: a key's second run
# is captured into a CUDA graph, later runs replay it), GRAPH_STEPS runs
# each way from one startup and run counter, bit for bit equal. GPT runs
# bench.py:596-601 with dropout 0.1 instead of 0, so the recomputed
# segments redraw their masks inside the graph. A profiled replay must
# show the path's hand-written kernels (by _family) and no library
# attention, LayerNorm or Adam kernel (LIBRARY_KERNELS, lower case).
GRAPH_STEPS = 6
GRAPH_SERVE_BATCHES = (1, 8)
GRAPH_SERVE_REPS = 10
GRAPH_GPT_DROPOUT = 0.1
SERVE_FAMILIES = ("flash_attention_fwd", "layer_norm_fwd")
TRAIN_FAMILIES = SERVE_FAMILIES + ("flash_attention_bwd_dkv",
                                   "flash_attention_bwd_dq",
                                   "layer_norm_bwd", "fused_adam")
GPT_FAMILIES = TRAIN_FAMILIES + ("fused_head_fwd", "fused_head_dh",
                                 "fused_head_dw")
LIBRARY_KERNELS = ("pytorch_flash", "fmha", "sdpa", "efficient_attention",
                   "layer_norm", "layernorm", "rowwisemoments", "gammabeta",
                   "multi_tensor_apply", "fusedadam", "fused_adam")
# gpt_eval: the CE kernel's loss on matmul logits against the head
# kernel's on the same weights; both sum 8192 per-token losses of ~10 in
# f32 from logits that differ by summation order only (~1e-6 relative)
EVAL_LOSS_RTOL = 1e-5

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel is the
# larger of its bytes over the memory rate and its operations over the
# peak rate for their type. f32: an f32-accurate product on the tensor
# cores takes three TF32 products (3xTF32: hi*hi + hi*lo + lo*hi, the
# scheme SDPA's f32 path uses), so the least time is at 495 / 3 TFLOP/s,
# above the 67 TFLOP/s of f32 FFMA.
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2 ** 20
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}

# Tolerances of a kernel against its plain version on the same inputs.
# f32: both sum in f32, in another order -> a few ulps of values of
# order 1. bf16: both compute in f32 from the same bf16 inputs and round
# the output to bf16 (8 significant bits), so they may differ by one bf16
# ulp: 2^-7 of values up to 2 (attention averages values of order 1), up
# to 2^-5 for LayerNorm outputs that reach 4-8. mean/lse/rstd are f32.
TOL = {("flash", "float32"): 2e-5, ("flash", "bfloat16"): 1e-2,
       ("ln", "float32"): 1e-4, ("ln", "bfloat16"): 6.25e-2,
       "stat": 1e-4}
# Backward kernels against their plain versions: dq/dk/dv are sums over
# up to 1024 keys or queries of values of order 1 (results up to ~6): f32
# in another order stays below 1e-4; bf16 outputs may differ by one bf16
# ulp at up to 4-8, 2^-5. LayerNorm dx is of order 1-3 (one bf16 ulp at 2-4
# is 2^-6); its dscale/dbias are f32 sums over 4096 rows, held relative to
# their largest magnitude (random-walk rounding of 4096 terms is ~4e-6 of
# it).
BWD_TOL = {("flash", "float32"): 1e-4, ("flash", "bfloat16"): 3.2e-2,
           ("ln", "float32"): 1e-4, ("ln", "bfloat16"): 1.6e-2,
           "ln_cols_rel": 5e-5}
# Adam: each output (p', m1', m2') is held apart, against the plain
# version, relative to its own change in the step:
#   max|got - want| <= ADAM_REL_TOL * max|want - old| + eps(dtype) * max|want|
# The second term is one ulp of the output, the most the final rounding
# can differ by when the two order their multiply-adds differently (for a
# bf16 parameter, one bf16 ulp); the rest of f32 elementwise math agrees
# to ~1e-7 of the change. A case counts only where the change is at least
# 10 ulps, so an output left unwritten, a wrong beta or a stale moment
# misses by most of its change.
ADAM_REL_TOL = 1e-4
# AdamW's kernel cases: BERT's recipe decay at the Adam cases' rate. At
# 0.01 the decay (lr * coeff * p, ~1e-7) is below the tolerance of a
# step; one more case decays at 1.0 a weight near 1 (LayerNorm-scale-
# like), where it is ~1e-4, far above it, and must be seen there.
ADAMW_COEFF, ADAMW_VISIBLE_COEFF = 0.01, 1.0
# Head and CE kernels against their plain versions. loss and lse (f32,
# values ~10): both sum the same f32 products over D (head) or take the
# same logsumexp (CE) in another order: 1e-4. Gradients are held relative
# to their largest magnitude: f32 dhidden sums 32000 terms and dweight
# 8192, in another order than cuBLAS (random-walk rounding ~1e-6 of the
# largest value): 5e-5; bf16 dhidden/dweight are rounded to bf16 on
# output, one bf16 ulp (2^-7 of the largest value) apart at most. CE's
# dlogits (values below 1): 1e-6 in f32, a bf16 ulp below 1 (2^-8) in
# bf16.
HEAD_TOL = {"loss": 1e-4, ("grad_rel", "float32"): 5e-5,
            ("grad_rel", "bfloat16"): 2.0 ** -7,
            ("dlogits", "float32"): 1e-6, ("dlogits", "bfloat16"): 2.0 ** -8}
# train_parity, gpt_train_parity and bf16_parity: PARITY_STEPS Adam(1e-4)
# steps on the card and on the CPU from the same weights, one comparison
# for f32 and bf16 (readings: PERF.md, PR 8). f32 runs without TF32 on
# both sides, so a per-step loss differs only by summation order through
# two layers and the head (rtol 1e-4; measured 1e-7); bf16 rounds at the
# same ops on both sides but sums in another order, so a bf16 activation
# may land an ulp (2^-8 relative) apart at each layer (rtol 1e-3;
# measured 2.5e-5 BERT, 5.3e-5 GPT). Each final parameter element agrees
# within PARITY_PARAM_ATOL (2e-5, ~10x the 2.4e-6 measured in f32, while
# three steps move an element by ~3e-4) plus PARITY_PARAM_ULPS ulps of
# its own dtype at its own value: none for an f32 parameter, whose Adam
# update is computed and stored in f32; two for a bf16 one, where each
# step rounds to bf16 and a difference far below an ulp may round the
# other way. An element whose gradient sums to near zero may change sign
# between the two (atomics on the card; bf16 rounding, which makes the
# gradients of a bf16 model's f32 parameters noisier too), and Adam then
# steps it the other way, by up to lr a step: at most
# PARITY_SIGN_FLIP_SHARE (by the model's dtype) of the elements may fall
# beyond the bound (measured: f32 none; bf16 3.4e-4 BERT, 3.8e-4 GPT),
# none beyond 2 * steps * lr plus the ulps. Each tensor the CPU moved by
# at least lr somewhere moved as much on the card: the sums of
# |final - start| agree within PARITY_MOVED_RTOL (measured 0.096 at most,
# a bf16 attention key bias, whose gradient is zero in exact arithmetic;
# 0.015 next), so a tensor the card did not update, or stepped at a
# wrong scale, misses by its whole change. (An f32 key bias moves by
# ~1e-8 and is not held.)
PARITY_LR = 1e-4
PARITY_LOSS_RTOL = {"float32": 1e-4, "bfloat16": 1e-3}
PARITY_PARAM_ATOL = 2e-5
PARITY_PARAM_ULPS = {"float32": 0, "bfloat16": 2}
PARITY_SIGN_FLIP_ATOL = 6e-4                 # 2 * steps * lr
PARITY_SIGN_FLIP_SHARE = {"float32": 1e-6, "bfloat16": 1e-3}
PARITY_MOVED_RTOL = 0.25
MANTISSA_BITS = {"float32": 23, "bfloat16": 7}
# bf16 decode, card against CPU: the final hidden states are bf16 and may
# differ by a bf16 ulp (2^-8 relative, values up to ~4) in some elements;
# each such element moves a logit by its ulp times a tied-embedding
# weight (~0.02-0.1), over 768 columns. The widened product alone: the
# same exact bf16 products summed in f32 in another order (1e-5 of the
# largest |logit|); its bf16 gradients one bf16 ulp apart (2^-7 of the
# largest).
BF16_DECODE_ATOL = 2e-2
WIDEN_REL_TOL = (1e-5, 2.0 ** -7)
GPT_PARITY_DECODE_PROMPT = 16

# GPU vs CPU serving of one request: f32 end to end without TF32 on
# either side; the summation order differs per matmul, LayerNorm and
# attention, and the differences pass through 12 layers of values of
# order 1.
SERVE_ATOL = 1e-3

_ROOT = os.path.dirname(os.path.abspath(__file__))
# every emitted line is also kept here whole: a chip run's printed output
# may come back cut to its end
_LOG = os.path.join(_ROOT, "chiprun_out", "chip_smoke.jsonl")
_failed = []


def emit(obj):
    line = json.dumps(obj)
    print(line, flush=True)
    with open(_LOG, "a") as f:
        f.write(line + "\n")


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


def _clock(big):
    """time_ms, with fewer repetitions for a big case (T = 4096 attention,
    whose plain versions build (B, H, T, T) scores; GPT-sized heads)."""
    import torch
    reps, inner = (3, 2) if big else (7, 10)
    return lambda fn: time_ms(torch, fn, reps, inner)


def time_cold_ms(torch, fn, ring, reps=5):
    """Median device time of one call of ``fn(inputs)`` with the L2 cold:
    the calls cycle through ``ring``, input sets that together exceed
    twice the L2, so each call's inputs were evicted since their last
    use (CUDA events over one pass of the ring, behind a sleep kernel)."""
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


def _ring(torch, tensors):
    """Copies of ``tensors``, enough sets to exceed twice the L2."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    return [tuple(t.clone() for t in tensors)
            for _ in range(-(-2 * L2_BYTES // nbytes) + 1)]


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def flash_cases(torch, fa, F):
    """(name, b, h, tq, tk, d, dtype, mask mode, causal) on the card."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        ("bert_base_k_mask_f32", 8, 12, 512, 512, 64, f32, "k", False),
        ("bert_train_k_mask_f32", 32, 12, 128, 128, 64, f32, "k", False),
        ("bert_base_k_mask_bf16", 8, 12, 512, 512, 64, bf16, "k", False),
        ("gpt_base_causal_f32", 1, 12, 1024, 1024, 64, f32, None, True),
        ("qk_mask_f32", 2, 12, 256, 256, 64, f32, "qk", False),
        ("ragged_d128_k_mask_f32", 2, 8, 200, 333, 128, f32, "k", False),
        ("causal_tq_gt_tk_f32", 2, 12, 300, 200, 64, f32, None, True),
        ("gpt_train_causal_t4096_f32", 2, 12, 4096, 4096, 64, f32, None,
         True),
        ("gpt_train_causal_t4096_bf16", 2, 12, 4096, 4096, 64, bf16, None,
         True),
        # BERT-base bf16 training (bench.py:388-389): the key mask in bf16
        ("bert_train_b128_k_mask_bf16", 128, 12, 128, 128, 64, bf16, "k16",
         False),
    ]
    dev = torch.device("cuda", 0)
    out = []
    for i, (name, b, h, tq, tk, d, dtype, mode, causal) in enumerate(cases):
        clock = _clock(tq >= 4096)
        g = torch.Generator(device=dev).manual_seed(SEED + i)
        q, k, v = (torch.randn(b, h, t, d, generator=g, device=dev)
                   .to(dtype) for t in (tq, tk, tk))
        mask = _flash_mask(torch, g, dev, b, tq, tk, dtype, mode)
        scale = d ** -0.5
        got, lse = fa.flash_attention(q, k, v, mask, scale, causal)
        again, again_lse = fa.flash_attention(q, k, v, mask, scale, causal)
        want, want_lse = fa.flash_attention_plain(q, k, v, mask, scale,
                                                  causal)
        torch.cuda.synchronize()
        err, lse_err = _max_err(got, want), _max_err(lse, want_lse)
        same = torch.equal(got, again) and torch.equal(lse, again_lse)
        tol = TOL[("flash", str(dtype).split(".")[1])]
        library_ms = None
        if not causal or (mask is None and tq == tk):
            lib_mask = None if mask is None else mask.to(dtype)
            library_ms = clock(lambda: F.scaled_dot_product_attention(
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
            + (0 if mask is None else mask.numel() * mask.element_size()) \
            + lse.numel() * 4
        kernel_ms = clock(lambda: fa.flash_attention(q, k, v, mask, scale,
                                                     causal))
        out.append(dict(
            name=name, shape=[b, h, tq, tk, d], dtype=str(dtype).split(".")[1],
            mask=mode, causal=causal,
            max_abs_err=err, lse_max_abs_err=lse_err, tol=tol,
            lse_tol=TOL["stat"], bitwise_repeat=same,
            ok=err <= tol and lse_err <= TOL["stat"] and same,
            kernel_ms=kernel_ms, tflops=flops / kernel_ms / 1e9,
            plain_ms=clock(lambda: fa.flash_attention_plain(
                q, k, v, mask, scale, causal)),
            library_ms=library_ms,
            **_bound(flops, nbytes, str(dtype).split(".")[1])))
    return out


# LayerNorm cases (name, rows, cols, dtype, cold): BERT-base's training
# step (the kernel line's first case), its bf16 step at batch 128
# (bench.py:388-389), GPT-base's step, a wide row (the
# block tier), 300 columns on a view whose data_ptr() is not 16-byte
# aligned (element-wide access) and one row. ``cold`` cases are also timed
# with the L2 cold.
def _ln_case_list(torch):
    f32, bf16 = torch.float32, torch.bfloat16
    return [("bert_base_f32", 4096, 768, f32, True),
            ("bert_base_bf16", 4096, 768, bf16, True),
            ("bert_train_b128_bf16", 16384, 768, bf16, True),
            ("gpt_base_f32", 8192, 768, f32, True),
            ("gpt_base_bf16", 8192, 768, bf16, True),
            ("wide_8192_f32", 64, 8192, f32, False),
            ("ragged_unaligned_f32", 37, 300, f32, False),
            ("ragged_unaligned_bf16", 37, 300, bf16, False),
            ("one_row_f32", 1, 768, f32, False)]


def _ln_input(torch, g, dev, rows, cols, dtype, unaligned, scale=1.0,
              shift=0.0):
    """(rows, cols) normal values; ``unaligned`` puts them one element
    into their storage, so data_ptr() is not 16-byte aligned."""
    off = 1 if unaligned else 0
    flat = torch.randn(rows * cols + off, generator=g, device=dev)
    return (flat * scale + shift).to(dtype)[off:].view(rows, cols)


def ln_cases(torch, ln, F):
    dev = torch.device("cuda", 0)
    out = []
    for i, (name, rows, cols, dtype, cold) in enumerate(_ln_case_list(torch)):
        g = torch.Generator(device=dev).manual_seed(SEED + 100 + i)
        x = _ln_input(torch, g, dev, rows, cols, dtype, "unaligned" in name,
                      3.0, 1.0)
        scale = torch.rand(cols, generator=g, device=dev) + 0.5
        bias = torch.randn(cols, generator=g, device=dev)
        got = ln.layer_norm(x, scale, bias, 1e-5)
        again = ln.layer_norm(x, scale, bias, 1e-5)
        want = ln.layer_norm_plain(x, scale, bias, 1e-5)
        torch.cuda.synchronize()
        err = _max_err(got[0], want[0])
        stat_err = max(_max_err(got[1], want[1]), _max_err(got[2], want[2]))
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        tol = TOL[("ln", str(dtype).split(".")[1])]
        nbytes = 2 * x.numel() * x.element_size() + 2 * cols * 4 + \
            2 * rows * 4
        lw, lb = scale.to(dtype), bias.to(dtype)
        case = dict(
            name=name, shape=[rows, cols], dtype=str(dtype).split(".")[1],
            plan=ln._ln_plan(rows, cols, dtype, ln._aligned(x, scale, bias)
                             )._asdict(),
            max_abs_err=err, stat_max_abs_err=stat_err, tol=tol,
            stat_tol=TOL["stat"], bitwise_repeat=same,
            ok=err <= tol and stat_err <= TOL["stat"] and same,
            kernel_ms=time_ms(torch, lambda: ln.layer_norm(
                x, scale, bias, 1e-5)),
            plain_ms=time_ms(torch, lambda: ln.layer_norm_plain(
                x, scale, bias, 1e-5)),
            library_ms=time_ms(torch, lambda: F.layer_norm(
                x, (cols,), lw, lb, 1e-5)),
            kernel_cold_ms=None, library_cold_ms=None,
            # ~8 f32 operations per element: mean, centre, square, sum,
            # normalise, scale, shift
            **_bound(8.0 * rows * cols, nbytes, "float32"))
        if cold:
            ring = _ring(torch, (x,))
            case["kernel_cold_ms"] = time_cold_ms(
                torch, lambda s: ln.layer_norm(s[0], scale, bias, 1e-5), ring)
            case["library_cold_ms"] = time_cold_ms(
                torch, lambda s: F.layer_norm(s[0], (cols,), lw, lb, 1e-5),
                ring)
            del ring
        out.append(case)
    return out


def _visible(tq, tk, causal):
    """(query, key) pairs a row sees, and rows that see no key (causal,
    Tq > Tk: the backward gives them dv += dO / Tk over all keys)."""
    if not causal:
        return tq * tk, 0
    off = tk - tq
    pairs = sum(min(tk, i + off + 1) for i in range(tq) if i + off >= 0)
    return pairs, sum(1 for i in range(tq) if i + off < 0)


def _flash_mask(torch, g, dev, b, tq, tk, dtype, mode):
    """None, or the additive mask of ``mode``: "k" BERT's key-padding bias
    (0 for tokens, -1e4 for the padding) in f32, "k16" the same in the
    inputs' dtype (BERT's bf16 attention bias), "qk" a dense (B, 1, Tq,
    Tk) bias."""
    if mode in ("k", "k16"):
        lens = torch.randint(tk // 2, tk + 1, (b,), generator=g, device=dev)
        mask = torch.where(torch.arange(tk, device=dev)[None, :] <
                           lens[:, None], 0.0, -1e4).reshape(b, 1, 1, tk)
        return mask.to(dtype) if mode == "k16" else mask
    if mode == "qk":
        return torch.randn(b, 1, tq, tk, generator=g, device=dev)
    return None


def _flash_inputs(torch, dev, seed, b, h, tq, tk, d, dtype, mode):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(b, h, t, d, generator=g, device=dev)
                   .to(dtype) for t in (tq, tk, tk, tq))
    return q, k, v, do, _flash_mask(torch, g, dev, b, tq, tk, dtype, mode)


def flash_bwd_cases(torch, fa, F):
    """Both backward kernels against the plain backward, on the forward
    kernel's out and lse (themselves held against the plain forward on
    the same inputs), and against themselves (equal bits on a second
    run). ``pair_ms`` is dK/dV + dQ + the delta pass rowsum(dO * O), the
    work SDPA's backward (``library_ms``) does in one call."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        ("bert_train_k_mask_f32", 32, 12, 128, 128, 64, f32, "k", False),
        ("bert_serve_k_mask_f32", 8, 12, 512, 512, 64, f32, "k", False),
        ("bert_serve_k_mask_bf16", 8, 12, 512, 512, 64, bf16, "k", False),
        ("gpt_base_causal_f32", 1, 12, 1024, 1024, 64, f32, None, True),
        ("qk_mask_f32", 2, 12, 256, 256, 64, f32, "qk", False),
        ("ragged_d128_k_mask_f32", 2, 8, 200, 333, 128, f32, "k", False),
        ("causal_tq_gt_tk_f32", 2, 12, 300, 200, 64, f32, None, True),
        ("gpt_train_causal_t4096_f32", 2, 12, 4096, 4096, 64, f32, None,
         True),
        ("causal_t4096_d128_f32", 2, 12, 4096, 4096, 128, f32, None, True),
        # the bf16 training steps' shapes (bench.py:388-389, 596-601)
        ("bert_train_b128_k_mask_bf16", 128, 12, 128, 128, 64, bf16, "k16",
         False),
        ("gpt_train_causal_t4096_bf16", 2, 12, 4096, 4096, 64, bf16, None,
         True),
    ]
    dev = torch.device("cuda", 0)
    dkv, dq = [], []
    for i, (name, b, h, tq, tk, d, dtype, mode, causal) in enumerate(cases):
        clock = _clock(tq >= 4096)
        q, k, v, do, mask = _flash_inputs(torch, dev, SEED + 200 + i, b, h,
                                          tq, tk, d, dtype, mode)
        scale = d ** -0.5
        out, lse = fa.flash_attention(q, k, v, mask, scale, causal)
        want_out, want_lse = fa.flash_attention_plain(q, k, v, mask, scale,
                                                      causal)
        fwd_err = _max_err(out, want_out)
        fwd_lse_err = _max_err(lse, want_lse)
        fwd_tol = TOL[("flash", str(dtype).split(".")[1])]
        fwd_ok = fwd_err <= fwd_tol and fwd_lse_err <= TOL["stat"]
        delta = (do.float() * out.float()).sum(-1)
        args = (q, k, v, mask, lse, delta, do, scale, causal)
        got_k, got_v = fa.flash_attention_bwd_dkv(*args)
        got_q = fa.flash_attention_bwd_dq(*args)
        again_k, again_v = fa.flash_attention_bwd_dkv(*args)
        again_q = fa.flash_attention_bwd_dq(*args)
        want_q, want_k, want_v = fa.flash_attention_bwd_plain(*args)
        torch.cuda.synchronize()
        tol = BWD_TOL[("flash", str(dtype).split(".")[1])]
        err_kv = max(_max_err(got_k, want_k), _max_err(got_v, want_v))
        err_q = _max_err(got_q, want_q)
        same_kv = torch.equal(got_k, again_k) and torch.equal(got_v, again_v)
        same_q = torch.equal(got_q, again_q)
        plain_ms = clock(lambda: fa.flash_attention_bwd_plain(*args))
        library_ms = None
        if not causal or (mask is None and tq == tk):
            lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))
            lib_out = F.scaled_dot_product_attention(
                lq, lk, lv, attn_mask=None if mask is None else mask.to(dtype),
                is_causal=causal, scale=scale)
            library_ms = clock(lambda: torch.autograd.grad(
                lib_out, (lq, lk, lv), do, retain_graph=True))
        pairs, no_key = _visible(tq, tk, causal)
        el = q.element_size()
        dkv_ms = clock(lambda: fa.flash_attention_bwd_dkv(*args))
        dq_ms = clock(lambda: fa.flash_attention_bwd_dq(*args))
        delta_ms = clock(lambda: (do.float() * out.float()).sum(-1))
        common = dict(shape=[b, h, tq, tk, d], dtype=str(dtype).split(".")[1],
                      mask=mode, causal=causal, tol=tol, plain_ms=plain_ms,
                      library_ms=library_ms, delta_ms=delta_ms,
                      pair_ms=dkv_ms + dq_ms + delta_ms,
                      fwd_max_abs_err=fwd_err,
                      fwd_lse_max_abs_err=fwd_lse_err, fwd_tol=fwd_tol)
        side = (0 if mask is None else mask.numel() * mask.element_size()) \
            + 2 * lse.numel() * 4                      # mask, lse, delta
        # dK/dV: 8*D flops per visible pair (s, dp, dv, dk); a row that sees
        # no key adds 2*D per key (dv only). Reads q,k,v,dO, writes dk,dv.
        dkv.append(dict(
            name=name, max_abs_err=err_kv,
            ok=err_kv <= tol and same_kv and fwd_ok,
            bitwise_repeat=same_kv, kernel_ms=dkv_ms,
            **common, **_bound(8.0 * b * h * d * pairs +
                               2.0 * b * h * d * tk * no_key,
                               (2 * q.numel() + 4 * k.numel()) * el + side,
                               common["dtype"])))
        # dQ: 6*D flops per visible pair (s, dp, dq). Reads q,k,v,dO,
        # writes dq.
        dq.append(dict(
            name=name, max_abs_err=err_q,
            ok=err_q <= tol and same_q and fwd_ok,
            bitwise_repeat=same_q, kernel_ms=dq_ms,
            **common, **_bound(6.0 * b * h * d * pairs,
                               (3 * q.numel() + 2 * k.numel()) * el + side,
                               common["dtype"])))
    return dkv, dq


def ln_bwd_cases(torch, ln):
    dev = torch.device("cuda", 0)
    out = []
    for i, (name, rows, cols, dtype, cold) in enumerate(_ln_case_list(torch)):
        g = torch.Generator(device=dev).manual_seed(SEED + 300 + i)
        unaligned = "unaligned" in name
        x = _ln_input(torch, g, dev, rows, cols, dtype, unaligned, 3.0, 1.0)
        gy = _ln_input(torch, g, dev, rows, cols, dtype, unaligned)
        scale = torch.rand(cols, generator=g, device=dev) + 0.5
        bias = torch.randn(cols, generator=g, device=dev)
        _, mean, rstd = ln.layer_norm(x, scale, bias, 1e-5)
        args = (x, gy, scale, mean, rstd)
        got = ln.layer_norm_bwd(*args)
        again = ln.layer_norm_bwd(*args)
        want = ln.layer_norm_bwd_plain(*args)
        torch.cuda.synchronize()
        err = _max_err(got[0], want[0])
        col_rel = max(_max_err(got[j], want[j]) /
                      max(1.0, float(want[j].abs().max())) for j in (1, 2))
        same = all(torch.equal(a, b_) for a, b_ in zip(got, again))
        tol = BWD_TOL[("ln", str(dtype).split(".")[1])]
        lib_w, lib_b = scale.to(dtype), bias.to(dtype)
        _, lmean, lrstd = torch.ops.aten.native_layer_norm(
            x, (cols,), lib_w, lib_b, 1e-5)

        def library(x, gy):
            return torch.ops.aten.native_layer_norm_backward(
                gy, x, (cols,), lmean, lrstd, lib_w, lib_b,
                [True, True, True])
        el = x.element_size()
        nbytes = 3 * x.numel() * el + 2 * rows * 4 + 3 * cols * 4
        case = dict(
            name=name, shape=[rows, cols], dtype=str(dtype).split(".")[1],
            plan=ln._ln_plan(rows, cols, dtype, ln._aligned(x, gy, scale),
                             backward=True)._asdict(),
            max_abs_err=err, cols_rel_err=col_rel, tol=tol,
            cols_rel_tol=BWD_TOL["ln_cols_rel"], bitwise_repeat=same,
            ok=err <= tol and col_rel <= BWD_TOL["ln_cols_rel"] and same,
            kernel_ms=time_ms(torch, lambda: ln.layer_norm_bwd(*args)),
            plain_ms=time_ms(torch, lambda: ln.layer_norm_bwd_plain(*args)),
            library_ms=time_ms(torch, lambda: library(x, gy)),
            kernel_cold_ms=None, library_cold_ms=None,
            # ~12 f32 operations per element: x_hat, g*s, two row sums,
            # two column sums, dx
            **_bound(12.0 * rows * cols, nbytes, "float32"))
        if cold:
            ring = _ring(torch, (x, gy))
            case["kernel_cold_ms"] = time_cold_ms(
                torch, lambda s: ln.layer_norm_bwd(s[0], s[1], scale, mean,
                                                   rstd), ring)
            case["library_cold_ms"] = time_cold_ms(
                torch, lambda s: library(*s), ring)
            del ring
        out.append(case)
    return out


def adam_cases(torch, fad):
    """Adam and AdamW (the same kernel, coeff > 0) against the plain
    version at BERT's shapes, each timed beside torch's fused Adam/AdamW;
    for each AdamW case, coeff = 0 must give the bits of the call Adam
    makes (no coeff) on the same inputs."""
    f32, bf16 = torch.float32, torch.bfloat16
    # (name, elements, dtype, parameter centre and spread, gradient dtype,
    # coeff): BERT's weights start N(0, 0.02^2) and LayerNorm scales at 1;
    # the bf16 parameter is small enough (N(0, 1e-4^2), a bf16 ulp <=
    # 3.8e-6) that the step, ~1e-5 and up, shows in bf16; a bf16 layer of
    # the bf16 training steps gets a bf16 gradient, a clipped one f32
    cases = [("word_embedding", 30522 * 768, f32, 0.0, 0.02, f32, 0.0),
             ("ffn_weight", 768 * 3072, f32, 0.0, 0.02, f32, 0.0),
             ("layer_norm_scale", 768, f32, 1.0, 0.02, f32, 0.0),
             ("ffn_weight_bf16", 768 * 3072, bf16, 0.0, 1e-4, f32, 0.0),
             ("ffn_weight_bf16_grad_bf16", 768 * 3072, bf16, 0.0, 1e-4,
              bf16, 0.0),
             ("adamw_word_embedding", 30522 * 768, f32, 0.0, 0.02, f32,
              ADAMW_COEFF),
             ("adamw_ffn_weight_bf16", 768 * 3072, bf16, 0.0, 1e-4, f32,
              ADAMW_COEFF),
             ("adamw_ffn_weight_bf16_grad_bf16", 768 * 3072, bf16, 0.0,
              1e-4, bf16, ADAMW_COEFF),
             ("adamw_decay_visible", 768 * 3072, f32, 1.0, 0.02, f32,
              ADAMW_VISIBLE_COEFF)]
    dev = torch.device("cuda", 0)
    lr = torch.tensor([1e-4], device=dev)
    b1p = torch.tensor([0.9 ** 3], device=dev)
    b2p = torch.tensor([0.999 ** 3], device=dev)
    out = []
    for i, (name, n, dtype, centre, spread, gdtype, coeff) in \
            enumerate(cases):
        g = torch.Generator(device=dev).manual_seed(SEED + 400 + i)
        p = (centre + spread * torch.randn(n, generator=g, device=dev)
             ).to(dtype)
        gr = (torch.randn(n, generator=g, device=dev) * 1e-2).to(gdtype)
        m1 = torch.randn(n, generator=g, device=dev) * 1e-3
        m2 = torch.rand(n, generator=g, device=dev) * 1e-5
        want = fad.fused_adam_plain(p, gr, m1, m2, lr, b1p, b2p,
                                    coeff=coeff)
        got = fad.fused_adam(p.clone(), gr, m1.clone(), m2.clone(), lr, b1p,
                             b2p, coeff=coeff)
        torch.cuda.synchronize()
        errs, tols, changes, ok = {}, {}, {}, True
        for key, old, w, gt in zip(("p", "m1", "m2"), (p, m1, m2), want,
                                   got):
            ulp = torch.finfo(w.dtype).eps * float(w.float().abs().max())
            changes[key] = _max_err(w, old)
            errs[key] = _max_err(gt, w)
            tols[key] = ADAM_REL_TOL * changes[key] + ulp
            ok = ok and errs[key] <= tols[key] and changes[key] >= 10 * ulp
        extra = {}
        if coeff:
            # the decay's own share of the step (the plain version with
            # and without it), seen where it exceeds the tolerance
            shift = _max_err(want[0], fad.fused_adam_plain(
                p, gr, m1, m2, lr, b1p, b2p)[0])
            adam = fad.fused_adam(p.clone(), gr, m1.clone(), m2.clone(), lr,
                                  b1p, b2p)
            zero = fad.fused_adam(p.clone(), gr, m1.clone(), m2.clone(), lr,
                                  b1p, b2p, coeff=0.0)
            bits = all(torch.equal(a, b) for a, b in zip(adam, zero))
            ok = ok and bits and (shift > tols["p"] or
                                  coeff < ADAMW_VISIBLE_COEFF)
            extra = dict(coeff=coeff, decay_shift=shift,
                         decay_visible=shift > tols["p"],
                         coeff0_bits_equal_adam=bits)
        state = (p.clone(), m1.clone(), m2.clone())
        # yardstick: torch's fused Adam / AdamW on the same parameter (it
        # places eps differently, and AdamW decays before its step with
        # lr * wd, so it is a clock, not an oracle)
        lib_p = torch.nn.Parameter(p.clone())
        lib_p.grad = gr.to(p.dtype)
        lib_opt = torch.optim.AdamW([lib_p], lr=1e-4, weight_decay=coeff,
                                    fused=True) if coeff else \
            torch.optim.Adam([lib_p], lr=1e-4, fused=True)
        lib_opt.step()
        out.append(dict(
            name=name, numel=n, dtype=str(dtype).split(".")[1],
            grad_dtype=str(gdtype).split(".")[1],
            max_abs_err=max(errs.values()), abs_err=errs, tol=tols,
            change=changes, rel_tol=ADAM_REL_TOL, ok=ok,
            kernel_ms=time_ms(torch, lambda: fad.fused_adam(
                state[0], gr, state[1], state[2], lr, b1p, b2p,
                coeff=coeff)),
            plain_ms=time_ms(torch, lambda: fad.fused_adam_plain(
                p, gr, m1, m2, lr, b1p, b2p, coeff=coeff)),
            library_ms=time_ms(torch, lib_opt.step),
            # read p, g, m1, m2 and write p, m1, m2: 28 bytes per f32
            # element (24 with a bf16 p, 22 with a bf16 g too), AdamW's
            # decay included (p stays in registers); ~12 f32 operations
            # (14 with the decay)
            **dict(extra, **_bound((14.0 if coeff else 12.0) * n,
                                   (16.0 + 2 * p.element_size() +
                                    gr.element_size()) * n, "float32"))))
    return out


def _rel_err(got, want):
    """max |got - want| over max |want|."""
    return _max_err(got, want) / max(float(want.float().abs().max()), 1e-30)


def head_cases(torch, bce, F):
    """The fused head's forward, dhidden and dweight kernels against the
    plain head (which builds the (T, V) logits), the backward kernels also
    against a second run of themselves. Library yardstick:
    ``F.cross_entropy(h @ W^T + b, labels, reduction="none")`` and its
    autograd backward, which build (T, V) logits and their gradient;
    ``pair_ms`` is dhidden + dweight, the work that backward does in one
    call, and ``tflops`` a kernel's 4 T D V operations over its time."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # (name, T, D, V, dtype, bias)
        ("gpt_base_f32", 8192, 768, 32000, f32, False),
        ("bert_bias_f32", 640, 768, 32000, f32, True),
        ("gpt_base_bf16", 2048, 768, 32000, bf16, False),
        ("gpt_base_t8192_bf16", 8192, 768, 32000, bf16, False),
        # GPT-2's padded vocabulary: 3144 streamed tiles a token, the
        # longest dhidden sum of any case
        ("gpt2_vocab_f32", 8192, 768, 50304, f32, False),
        ("ragged_f32", 1000, 200, 5003, f32, True),
        ("wide_d1000_f32", 300, 1000, 777, f32, True),
        ("ragged_d99_f32", 257, 99, 1001, f32, False),  # scalar tile loads
    ]
    dev = torch.device("cuda", 0)
    fwd, dh_out, dw_out = [], [], []
    for i, (name, t, d, v, dtype, with_bias) in enumerate(cases):
        clock = _clock(t * v > 1e8)
        g = torch.Generator(device=dev).manual_seed(SEED + 500 + i)
        h = torch.randn(t, d, generator=g, device=dev).to(dtype)
        w = (torch.randn(v, d, generator=g, device=dev) * 0.05).to(dtype)
        b = torch.randn(v, generator=g, device=dev) * 0.1 if with_bias \
            else None
        lab = torch.randint(0, v, (t,), generator=g, device=dev)
        lab[::97] = -100                     # ignore_index rows hit nothing
        dl = torch.rand(t, generator=g, device=dev)
        loss, lse = bce.fused_head_loss(h, w, lab, b)
        loss2, lse2 = bce.fused_head_loss(h, w, lab, b)
        want_loss, want_lse = bce.fused_head_loss_plain(h, w, lab, b)
        args = (h, w, lab, b, lse, dl)
        dh = bce.fused_head_dhidden(*args)
        dw, db = bce.fused_head_dweight(*args)
        dh2 = bce.fused_head_dhidden(*args)
        dw2, db2 = bce.fused_head_dweight(*args)
        want_dh, want_dw, want_db = bce.fused_head_bwd_plain(*args)
        torch.cuda.synchronize()
        dt = str(dtype).split(".")[1]
        loss_err = max(_max_err(loss, want_loss), _max_err(lse, want_lse))
        rel_tol = HEAD_TOL[("grad_rel", dt)]
        dh_rel = _rel_err(dh, want_dh)
        dw_rel = max(_rel_err(dw, want_dw), _rel_err(db, want_db))
        same_fwd = torch.equal(loss, loss2) and torch.equal(lse, lse2)
        same_dh = torch.equal(dh, dh2)
        same_dw = torch.equal(dw, dw2) and torch.equal(db, db2)

        lh, lw = h.detach().requires_grad_(), w.detach().requires_grad_()
        lb = None if b is None else b.detach().requires_grad_()

        def lib_fwd():
            logits = lh @ lw.t()
            if lb is not None:
                logits = logits + lb.to(logits.dtype)
            return F.cross_entropy(logits, lab, reduction="none")
        lib_loss = lib_fwd()
        lib_ins = tuple(x for x in (lh, lw, lb) if x is not None)
        lib_bwd_ms = clock(lambda: torch.autograd.grad(
            lib_loss, lib_ins, dl.to(lib_loss.dtype), retain_graph=True))
        plain_bwd_ms = clock(lambda: bce.fused_head_bwd_plain(*args))
        el = h.element_size()
        common = dict(shape=[t, d, v], dtype=dt, bias=with_bias,
                      plain_bwd_ms=plain_bwd_ms)
        side = t * 8 + (v * 4 if with_bias else 0)    # labels, bias
        fwd_ms = clock(lambda: bce.fused_head_loss(h, w, lab, b))
        fwd.append(dict(
            name=name, max_abs_err=loss_err, tol=HEAD_TOL["loss"],
            bitwise_repeat=same_fwd,
            ok=loss_err <= HEAD_TOL["loss"] and same_fwd,
            kernel_ms=fwd_ms, tflops=2.0 * t * d * v / fwd_ms / 1e9,
            plain_ms=clock(lambda: bce.fused_head_loss_plain(h, w, lab, b)),
            library_ms=clock(lib_fwd), **common,
            # s = h W^T: 2 T D V; reads h, W, labels, bias, writes loss, lse
            **_bound(2.0 * t * d * v, (t * d + v * d) * el + side + 8 * t,
                     dt)))
        # each backward kernel recomputes s (2 T D V) and forms its
        # product (2 T D V); reads h, W, labels, bias, lse, dloss
        reads = (t * d + v * d) * el + side + 8 * t
        dh_ms = clock(lambda: bce.fused_head_dhidden(*args))
        dw_ms = clock(lambda: bce.fused_head_dweight(*args))
        # the library's backward gives all gradients in one call: the
        # pair is its counterpart
        common.update(pair_ms=dh_ms + dw_ms,
                      pair_over_library=(dh_ms + dw_ms) / lib_bwd_ms)
        dh_out.append(dict(
            name=name, max_abs_err=_max_err(dh, want_dh), rel_err=dh_rel,
            rel_tol=rel_tol, bitwise_repeat=same_dh,
            ok=dh_rel <= rel_tol and same_dh,
            kernel_ms=dh_ms, tflops=4.0 * t * d * v / dh_ms / 1e9,
            plain_ms=plain_bwd_ms, library_ms=lib_bwd_ms, **common,
            **_bound(4.0 * t * d * v, reads + t * d * el, dt)))
        dw_out.append(dict(
            name=name, max_abs_err=max(_max_err(dw, want_dw),
                                       _max_err(db, want_db)),
            rel_err=dw_rel, rel_tol=rel_tol, bitwise_repeat=same_dw,
            ok=dw_rel <= rel_tol and same_dw,
            kernel_ms=dw_ms, tflops=4.0 * t * d * v / dw_ms / 1e9,
            plain_ms=plain_bwd_ms, library_ms=lib_bwd_ms, **common,
            **_bound(4.0 * t * d * v, reads + v * d * el + 4 * v, dt)))
    return fwd, dh_out, dw_out


def ce_cases(torch, bce, F):
    """The CE forward and backward kernels against their plain versions
    (and the backward against a second run of itself). Library yardstick:
    ``F.cross_entropy(x, labels, reduction="none")`` and its autograd
    backward."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("gpt_base_f32", 8192, 32000, f32),
             ("bert_vocab_f32", 640, 30522, f32),
             ("ragged_bf16", 333, 1001, bf16)]
    dev = torch.device("cuda", 0)
    fwd, bwd = [], []
    for i, (name, t, v, dtype) in enumerate(cases):
        clock = _clock(t * v > 1e8)
        g = torch.Generator(device=dev).manual_seed(SEED + 600 + i)
        x = (torch.randn(t, v, generator=g, device=dev) * 3).to(dtype)
        lab = torch.randint(0, v, (t,), generator=g, device=dev)
        lab[::7] = -100                      # ignore_index rows hit nothing
        dl = torch.rand(t, generator=g, device=dev)
        loss, lse = bce.softmax_ce(x, lab)
        want_loss, want_lse = bce.softmax_ce_plain(x, lab)
        dx = bce.softmax_ce_bwd(x, lab, lse, dl)
        dx2 = bce.softmax_ce_bwd(x, lab, lse, dl)
        want_dx = bce.softmax_ce_bwd_plain(x, lab, lse, dl)
        torch.cuda.synchronize()
        dt = str(dtype).split(".")[1]
        loss_err = max(_max_err(loss, want_loss), _max_err(lse, want_lse))
        dx_err, dx_tol = _max_err(dx, want_dx), HEAD_TOL[("dlogits", dt)]
        same = torch.equal(dx, dx2)
        lx = x.detach().requires_grad_()
        lib_loss = F.cross_entropy(lx, lab, reduction="none")
        el = x.element_size()
        fwd.append(dict(
            name=name, shape=[t, v], dtype=dt, max_abs_err=loss_err,
            tol=HEAD_TOL["loss"], ok=loss_err <= HEAD_TOL["loss"],
            kernel_ms=clock(lambda: bce.softmax_ce(x, lab)),
            plain_ms=clock(lambda: bce.softmax_ce_plain(x, lab)),
            library_ms=clock(lambda: F.cross_entropy(x, lab,
                                                     reduction="none")),
            # ~4 operations per element (max, subtract, exp, add); reads
            # the logits and labels, writes loss and lse
            **_bound(4.0 * t * v, t * v * el + 16 * t, "float32")))
        bwd.append(dict(
            name=name, shape=[t, v], dtype=dt, max_abs_err=dx_err,
            tol=dx_tol, bitwise_repeat=same, ok=dx_err <= dx_tol and same,
            kernel_ms=clock(lambda: bce.softmax_ce_bwd(x, lab, lse, dl)),
            plain_ms=clock(lambda: bce.softmax_ce_bwd_plain(x, lab, lse,
                                                            dl)),
            library_ms=clock(lambda: torch.autograd.grad(
                lib_loss, (lx,), dl, retain_graph=True)),
            # ~5 operations per element (subtract, exp, onehot, multiply);
            # reads logits, labels, lse, dloss, writes dlogits
            **_bound(5.0 * t * v, 2 * t * v * el + 16 * t, "float32")))
    return fwd, bwd


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


def serve(torch, np, ptt, counters, model_dir):
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
    counters.zero()                          # the main path starts here
    lat, per_request, answers = [], [], []
    for feed in requests:
        before = counters.read()
        t1 = time.perf_counter()
        outs = pred.run(feed)                # numpy: synchronised
        lat.append((time.perf_counter() - t1) * 1e3)
        after = counters.read()
        per_request.append([after["flash_attention_fwd"] -
                            before["flash_attention_fwd"],
                            after["layer_norm_fwd"] -
                            before["layer_norm_fwd"]])
        answers.append(outs)
    launches = counters.read()
    shapes_ok = all(
        o[0].shape == (len(f["src_ids"]), SEQ_LEN, cfg.hidden_size) and
        o[1].shape == (len(f["src_ids"]), cfg.hidden_size) and
        all(np.isfinite(a).all() for a in o)
        for f, o in zip(requests, answers))
    counts_ok = all(c == [FLASH_PER_REQUEST, LN_PER_REQUEST]
                    for c in per_request) and \
        all(launches[k] == 0 for k in ("flash_attention_bwd_dkv",
                                       "flash_attention_bwd_dq",
                                       "layer_norm_bwd", "fused_adam") +
            NEW_KERNELS)

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
          "launches_per_request": per_request, "launches": launches,
          "shapes_finite_ok": shapes_ok,
          "cpu_request_ms": cpu_ms,
          "gpu_vs_cpu_max_abs_err": {"sequence_output": errs[0],
                                     "pooled": errs[1]},
          "atol": SERVE_ATOL,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    if not ok:
        raise AssertionError("serve checks failed (see the line above)")
    return launches, pred, requests


class Counters(object):
    """The eleven kernels' launch counters, read and zeroed together."""

    def __init__(self, fa, ln, fad, bce):
        self._fields = {
            "flash_attention_fwd": (fa, "launches"),
            "flash_attention_bwd_dkv": (fa, "dkv_launches"),
            "flash_attention_bwd_dq": (fa, "dq_launches"),
            "layer_norm_fwd": (ln, "launches"),
            "layer_norm_bwd": (ln, "bwd_launches"),
            "fused_adam": (fad, "launches"),
            "fused_head_fwd": (bce, "head_launches"),
            "fused_head_dh": (bce, "head_dh_launches"),
            "fused_head_dw": (bce, "head_dw_launches"),
            "ce_fwd": (bce, "ce_launches"),
            "ce_bwd": (bce, "ce_bwd_launches")}

    def zero(self):
        for mod, attr in self._fields.values():
            setattr(mod, attr, 0)

    def read(self):
        return {k: getattr(mod, attr)
                for k, (mod, attr) in self._fields.items()}


def _pretrain_program(ptt, bert, cfg, batch, optimizer_fn=None):
    """BERT pretraining with ``optimizer_fn`` (default Adam(1e-4)):
    (main, startup, [loss, mlm_loss, nsp_loss])."""
    with ptt.unique_name.guard():
        main, startup, _, fetch = bert.bert_pretrain_program(
            cfg, batch, TRAIN_SEQ, TRAIN_PREDS,
            optimizer_fn=optimizer_fn or (
                lambda loss: ptt.optimizer.Adam(1e-4).minimize(loss)))
    startup.random_seed = SEED
    return main, startup, [fetch["loss"], fetch["mlm_loss"],
                           fetch["nsp_loss"]]


def _no_weight_decay(param):
    """LAMB's exclusion in the BERT recipe: LayerNorm parameters and
    biases."""
    return param.name.endswith(("_ln_s", "_ln_b", ".b_0"))


def _recipe_schedule(ptt, base):
    """The recipe's rate: a linear warmup over a polynomial decay."""
    layers = ptt.layers
    return layers.linear_lr_warmup(
        layers.polynomial_decay(base, decay_steps=RECIPE_DECAY_STEPS,
                                end_learning_rate=0.0),
        warmup_steps=RECIPE_WARMUP, start_lr=0.0, end_lr=base)


def _recipe_rate(run, base):
    """The closed form of _recipe_schedule at run ``run``: the decay reads
    counter 2 run, the warmup 2 run + 1 (see RECIPE_LR)."""
    warm = 2 * run + 1
    if warm < RECIPE_WARMUP:
        return base * warm / RECIPE_WARMUP
    return base * (1 - min(2 * run, RECIPE_DECAY_STEPS) /
                   RECIPE_DECAY_STEPS)


def _recipe_optimizer(ptt, make, base, regularization=None, fetch=None,
                      scheduled=True):
    """optimizer_fn: ``make(optimizer module, rate)`` under the recipe's
    schedule (else at the constant ``base``) and global-norm clip; the
    rate and the global norm land in ``fetch``."""
    def fn(loss):
        lr = _recipe_schedule(ptt, base) if scheduled else base
        opt = make(ptt.optimizer, lr)
        opt.regularization = regularization
        out = opt.minimize(
            loss, grad_clip=ptt.clip.GradientClipByGlobalNorm(RECIPE_CLIP))
        if fetch is not None:
            fetch["lr"] = lr
            fetch["global_norm"] = _global_norm_var(loss.block.program)
        return out
    return fn


def _global_norm_var(main):
    """The global-norm clip's norm: the sqrt of the sum of the
    squared_l2_norm outputs."""
    block = main.global_block()
    squares = {op.output("Out")[0] for op in block.ops
               if op.type == "squared_l2_norm"}
    sums = {op.output("Out")[0] for op in block.ops
            if op.type == "sum" and set(op.input("X")) <= squares}
    norm, = [op.output("Out")[0] for op in block.ops
             if op.type == "sqrt" and op.input("X")[0] in sums]
    return block.var(norm)


def _steps(torch, np, ptt, counters, exe, main, scope, feed, fetch_list,
           n):
    """``n`` runs of ``main`` on the card, the launch counters set to 0
    just before: (step ms, losses, launches per step, launches)."""
    counters.zero()                          # the main path starts here
    step_ms, losses, per_step = [], [], []
    with ptt.scope_guard(scope):
        for _ in range(n):
            before = counters.read()
            t1 = time.perf_counter()
            out = exe.run(main, feed=feed, fetch_list=fetch_list)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            losses.append([float(np.asarray(o).reshape(())) for o in out])
            after = counters.read()
            per_step.append({k: after[k] - before[k] for k in after})
    return step_ms, losses, per_step, counters.read()


def _op_counts(main):
    """Op types of the global block; a recomputed program's segment ops
    (its sub-blocks, run twice a step) apart under "segments"."""
    ops = {}
    for op in main.global_block().ops:
        ops[op.type] = ops.get(op.type, 0) + 1
    if main.num_blocks > 1:
        seg = {}
        for blk in main.blocks[1:]:
            for op in blk.ops:
                seg[op.type] = seg.get(op.type, 0) + 1
        ops["segments"] = seg
    return ops


def _n_ops(ops):
    return sum(n if isinstance(n, int) else sum(n.values())
               for n in ops.values())


def _train_bert(torch, np, ptt, counters, label, cfg, batch, want,
                steps=TRAIN_STEPS, recipe=None):
    """Phase ``label``: BERT-base pretraining steps of ``cfg`` at ``batch``
    x TRAIN_SEQ on the card through Executor.run; ``want`` the launches a
    step. ``recipe``: (name, make(optimizer module, rate)) trains with the
    recipe's schedule and clip instead of Adam(1e-4), fetching the rate
    and the global norm, which must be the closed form and finite."""
    from paddle_tpu_torch.models import bert
    t0 = time.perf_counter()
    fetch = {}
    main, startup, fetch_list = _pretrain_program(
        ptt, bert, cfg, batch, recipe and _recipe_optimizer(
            ptt, recipe[1], RECIPE_LR, fetch=fetch))
    if recipe:
        fetch_list = fetch_list + [fetch["lr"], fetch["global_norm"]]
    ops = _op_counts(main)
    feed = bert.synthetic_batch(cfg, batch, TRAIN_SEQ, TRAIN_PREDS, seed=0)
    scope = ptt.Scope()
    exe = ptt.Executor()                     # CUDAPlace(0)
    with ptt.scope_guard(scope):
        exe.run(startup)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses, per_step, launches = _steps(
        torch, np, ptt, counters, exe, main, scope, feed, fetch_list,
        steps)
    peak = torch.cuda.max_memory_allocated()
    finite = all(np.isfinite(v) for row in losses for v in row)
    falling = losses[-1][0] < losses[0][0]
    counts_ok = all(c == want for c in per_step)
    tokens = batch * TRAIN_SEQ
    warm = step_ms[1:]
    ok = finite and falling and counts_ok
    extra = {"optimizer": "Adam(1e-4)"}
    if recipe:
        rates = [row[3] for row in losses]
        closed = [_recipe_rate(k, RECIPE_LR) for k in range(steps)]
        rates_ok = all(abs(r - c) <= RECIPE_LR_RTOL * abs(c)
                       for r, c in zip(rates, closed))
        ok = ok and rates_ok
        extra = {"optimizer": recipe[0], "learning_rates": rates,
                 "learning_rates_closed_form": closed,
                 "learning_rate_rtol": RECIPE_LR_RTOL,
                 "learning_rates_ok": rates_ok,
                 "global_norms": [row[4] for row in losses],
                 "clip_norm": RECIPE_CLIP}
    emit(dict({"phase": label, "ok": ok, "model": "bert_base",
          "hidden": cfg.hidden_size, "layers": cfg.num_layers,
          "heads": cfg.num_heads, "vocab": cfg.vocab_size,
          "batch": batch, "seq_len": TRAIN_SEQ,
          "max_preds": TRAIN_PREDS, "dropout": cfg.hidden_dropout,
          "dtype": cfg.dtype, "recompute": cfg.recompute,
          "parameters": n_params, "program_ops": _n_ops(ops),
          "op_counts": ops, "setup_s": setup_s, "step_ms": step_ms,
          "tokens_per_s_warm": tokens / (statistics.median(warm) / 1e3),
          "losses": losses, "finite": finite, "falling": falling,
          "launches_per_step": per_step, "launches": launches,
          "peak_mem_gb": peak / 2 ** 30,
          "step_peak_above_resident_gb": (peak - resident) / 2 ** 30},
         **extra))
    if not ok:
        raise AssertionError("%s checks failed (see the line above)"
                             % label)
    return launches, (exe, main, scope, feed, fetch_list)


def train(torch, np, ptt, counters):
    """BERT-base pretraining steps on the card through Executor.run: f32,
    batch 32, dropout 0.1."""
    from paddle_tpu_torch.models import bert
    return _train_bert(torch, np, ptt, counters, "train", bert.bert_base(),
                       TRAIN_BATCH, TRAIN_PER_STEP)


def train_bf16(torch, np, ptt, counters):
    """BERT-base pretraining at bench.py:388-389 with nothing cut: bf16,
    batch 128 x 128, 20 masked positions, dropout 0.1, Adam 1e-4."""
    from paddle_tpu_torch.models import bert
    return _train_bert(torch, np, ptt, counters, "train_bf16",
                       bert.bert_base(dtype="bfloat16"), BF16_TRAIN_BATCH,
                       TRAIN_PER_STEP)


def train_recipe(torch, np, ptt, counters):
    """BERT-base at bench.py:388-389's shapes (bf16, batch 128 x 128)
    trained with the BERT recipe: AdamW(weight_decay=0.01) under the
    warmup-and-decay schedule with a global-norm clip, six steps; the
    fused-Adam kernel once per parameter a step."""
    from paddle_tpu_torch.models import bert
    return _train_bert(
        torch, np, ptt, counters, "train_recipe",
        bert.bert_base(dtype="bfloat16"), BF16_TRAIN_BATCH, TRAIN_PER_STEP,
        RECIPE_STEPS,
        ("AdamW(schedule, weight_decay=0.01, GradientClipByGlobalNorm(1.0))",
         lambda o, lr: o.AdamW(lr, weight_decay=RECIPE_WEIGHT_DECAY)))


def train_recipe_lamb(torch, np, ptt, counters):
    """The train_recipe step with LAMB (weight decay 0.01, none on
    LayerNorm parameters and biases): plain torch ops, no Adam launch."""
    from paddle_tpu_torch.models import bert
    return _train_bert(
        torch, np, ptt, counters, "train_recipe_lamb",
        bert.bert_base(dtype="bfloat16"), BF16_TRAIN_BATCH,
        RECIPE_LAMB_PER_STEP, RECIPE_LAMB_STEPS,
        ("Lamb(schedule, lamb_weight_decay=0.01, "
         "GradientClipByGlobalNorm(1.0))",
         lambda o, lr: o.Lamb(lr, lamb_weight_decay=RECIPE_WEIGHT_DECAY,
                              exclude_from_weight_decay_fn=_no_weight_decay)))


def _card_vs_cpu(np, ptt, main, startup, fetch_list, feed):
    """PARITY_STEPS runs of a training program on the card and on the CPU
    (plain versions) from the same startup weights, held to PARITY_*; on
    the card also op by op, which must give the graphed runs' bits: (the
    comparison's numbers, whether it passed)."""
    from paddle_tpu_torch.io import set_params_from_numpy
    from paddle_tpu_torch.framework.scope import to_numpy
    init = ptt.Scope()
    with ptt.scope_guard(init):
        ptt.Executor().run(startup)
    # tensors, not numpy: bf16 weights keep their dtype
    arrays = {v.name: init.find_var(v.name).cpu()
              for v in main.list_vars() if v.persistable}
    runs = {}
    for label, place, cache in (("gpu", ptt.CUDAPlace(0), True),
                                ("gpu_op_by_op", ptt.CUDAPlace(0), False),
                                ("cpu", ptt.CPUPlace(), True)):
        scope = ptt.Scope()
        set_params_from_numpy(arrays, main, scope, place)
        exe = ptt.Executor(place)
        t0 = time.perf_counter()
        with ptt.scope_guard(scope):
            losses = [float(np.asarray(exe.run(
                main, feed=feed, fetch_list=fetch_list,
                use_program_cache=cache)[0]).reshape(()))
                for _ in range(PARITY_STEPS)]
        runs[label] = (losses, scope, (time.perf_counter() - t0) * 1e3)
        exe.close()
    # the card's graphed runs (a warm run, a capture, a replay) against
    # its op-by-op runs: equal bits
    op_scope = runs["gpu_op_by_op"][1]
    graphed_equal = runs["gpu"][0] == runs["gpu_op_by_op"][0] and all(
        np.array_equal(to_numpy(runs["gpu"][1].find_var(v.name)),
                       to_numpy(op_scope.find_var(v.name)))
        for v in main.list_vars() if v.persistable)
    (gl, gs, g_ms), (cl, cs, c_ms) = runs["gpu"], runs["cpu"]
    dtype = ("bfloat16" if any(p.dtype == "bfloat16"
                               for p in main.all_parameters()) else "float32")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
    beyond = elements = capped = 0
    param_err = moved = 0.0
    moved_errs = []
    for p in main.all_parameters():
        start = to_numpy(arrays[p.name]).astype(np.float32)
        got = to_numpy(gs.find_var(p.name)).astype(np.float32)
        want = to_numpy(cs.find_var(p.name)).astype(np.float32)
        diff = np.abs(got - want)
        # the spacing of p's own dtype at each element of the CPU's result
        _, exp = np.frexp(np.maximum(np.abs(want), 2.0 ** -126))
        ulps = PARITY_PARAM_ULPS[p.dtype] * np.ldexp(
            1.0, exp - 1 - MANTISSA_BITS[p.dtype])
        param_err = max(param_err, float(diff.max()))
        beyond += int((diff > PARITY_PARAM_ATOL + ulps).sum())
        capped += int((diff > PARITY_SIGN_FLIP_ATOL + ulps).sum())
        elements += diff.size
        on_card, on_cpu = np.abs(got - start), np.abs(want - start)
        moved = max(moved, float(on_card.max()))
        if on_cpu.max() >= PARITY_LR:
            moved_errs.append((abs(float(on_card.sum()) / float(
                on_cpu.sum()) - 1.0), p.name))
    moved_errs.sort(reverse=True)
    ok = (loss_rel <= PARITY_LOSS_RTOL[dtype] and all(np.isfinite(gl))
          and capped == 0
          and beyond <= PARITY_SIGN_FLIP_SHARE[dtype] * elements
          and bool(moved_errs) and moved_errs[0][0] <= PARITY_MOVED_RTOL
          and moved >= 10 * PARITY_PARAM_ATOL and graphed_equal)
    return {"steps": PARITY_STEPS, "dropout": 0.0, "dtype": dtype,
            "gpu_losses": gl, "cpu_losses": cl, "loss_max_rel_err": loss_rel,
            "loss_rtol": PARITY_LOSS_RTOL[dtype],
            "param_max_abs_err": param_err, "param_atol": PARITY_PARAM_ATOL,
            "param_ulps": PARITY_PARAM_ULPS, "param_elements": elements,
            "param_beyond_atol": beyond,
            "param_beyond_sign_flip_atol": capped,
            "sign_flip_atol": PARITY_SIGN_FLIP_ATOL,
            "sign_flip_share": PARITY_SIGN_FLIP_SHARE[dtype],
            "moved_rel_err_largest": moved_errs[:4],
            "moved_rtol": PARITY_MOVED_RTOL,
            "param_max_moved": moved, "gpu_ms": g_ms, "cpu_ms": c_ms,
            "graphed_bit_equal_op_by_op": graphed_equal}, ok


def train_parity(torch, np, ptt):
    """Three steps of a 2-layer BERT-base-width model on the card and on
    the CPU (plain versions) from the same weights."""
    from paddle_tpu_torch.models import bert
    cfg = bert.bert_base(num_layers=PARITY_LAYERS, hidden_dropout=0.0,
                         attn_dropout=0.0)
    main, startup, fetch_list = _pretrain_program(ptt, bert, cfg,
                                                  PARITY_BATCH)
    feed = bert.synthetic_batch(cfg, PARITY_BATCH, TRAIN_SEQ, TRAIN_PREDS,
                                seed=1)
    result, ok = _card_vs_cpu(np, ptt, main, startup, fetch_list, feed)
    emit(dict({"phase": "train_parity", "ok": ok, "layers": PARITY_LAYERS,
               "hidden": cfg.hidden_size, "batch": PARITY_BATCH,
               "seq_len": TRAIN_SEQ}, **result))
    if not ok:
        raise AssertionError("train_parity checks failed (see the line "
                             "above)")


def _gpt_cfg(gpt, **kw):
    """GPT-base at bench.py:596-601's widths, f32, dropout 0."""
    return gpt.gpt_base(**dict(dict(
        vocab_size=32000, hidden_size=768, num_layers=12, num_heads=12,
        ff_size=3072, max_position=4096, dropout=0.0, attn_impl="flash"),
        **kw))


def _gpt_train_program(ptt, gpt, cfg, batch, seq):
    with ptt.unique_name.guard():
        main, startup, _, fetch = gpt.gpt_pretrain_program(
            cfg, batch, seq,
            optimizer_fn=lambda loss: ptt.optimizer.Adam(1e-4).minimize(loss))
    startup.random_seed = SEED
    return main, startup, [fetch["loss"]]


def _gpt_run(torch, np, ptt, counters, cfg, steps, want):
    """``steps`` GPT-base pretraining steps of ``cfg`` at GPT_BATCH x
    GPT_SEQ on the card from its seeded startup: (the run's numbers, ok,
    the trained state)."""
    from paddle_tpu_torch.models import gpt
    t0 = time.perf_counter()
    main, startup, fetch_list = _gpt_train_program(ptt, gpt, cfg, GPT_BATCH,
                                                   GPT_SEQ)
    ops = _op_counts(main)
    feed = gpt.synthetic_batch(cfg, GPT_BATCH, GPT_SEQ, seed=0)
    scope = ptt.Scope()
    exe = ptt.Executor()                     # CUDAPlace(0)
    with ptt.scope_guard(scope):
        exe.run(startup)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses, per_step, launches = _steps(
        torch, np, ptt, counters, exe, main, scope, feed, fetch_list, steps)
    peak = torch.cuda.max_memory_allocated()
    finite = all(np.isfinite(row[0]) for row in losses)
    falling = losses[-1][0] < losses[0][0]
    counts_ok = all(c == want for c in per_step)
    warm = step_ms[1:]
    run = {"dtype": cfg.dtype, "recompute": cfg.recompute,
           "parameters": n_params, "program_ops": _n_ops(ops),
           "op_counts": ops, "setup_s": setup_s, "step_ms": step_ms,
           "tokens_per_s_warm": GPT_BATCH * GPT_SEQ /
           (statistics.median(warm) / 1e3),
           "losses": [row[0] for row in losses], "finite": finite,
           "falling": falling, "launches_per_step": per_step,
           "launches": launches, "peak_mem_gb": peak / 2 ** 30,
           "step_peak_above_resident_gb": (peak - resident) / 2 ** 30}
    return run, finite and falling and counts_ok, \
        (exe, main, scope, feed, fetch_list, cfg)


def gpt_train(torch, np, ptt, counters):
    """GPT-base pretraining steps at 2 x 4096 on the card through
    Executor.run: f32, recompute off."""
    from paddle_tpu_torch.models import gpt
    cfg = _gpt_cfg(gpt)
    run, ok, trained = _gpt_run(torch, np, ptt, counters, cfg, GPT_STEPS,
                                GPT_PER_STEP)
    emit(dict({"phase": "gpt_train", "ok": ok, "model": "gpt_base",
               "hidden": cfg.hidden_size, "layers": cfg.num_layers,
               "heads": cfg.num_heads, "vocab": cfg.vocab_size,
               "batch": GPT_BATCH, "seq_len": GPT_SEQ,
               "dropout": cfg.dropout, "optimizer": "Adam(1e-4)"}, **run))
    if not ok:
        raise AssertionError("gpt_train checks failed (see the line above)")
    return run["launches"], trained


def gpt_train_bf16(torch, np, ptt, counters):
    """GPT-base at bench.py:596-601 exactly: bf16, flash attention,
    recompute, dropout 0, 2 x 4096, Adam 1e-4, GPT_STEPS steps; then
    GPT_NO_RECOMPUTE_STEPS steps of the same model without recompute from
    the same seeded startup. The recomputed step re-runs each block's
    forward (flash forward and LayerNorm forward twice a block) and must
    peak lower; its first loss must equal the other's bit for bit (the
    same weights, the same forward kernels). The path's launches are the
    recomputed run's; the other run's are in its own record."""
    from paddle_tpu_torch.models import gpt
    cfg = _gpt_cfg(gpt, dtype="bfloat16", recompute=True)
    remat, remat_ok, trained = _gpt_run(torch, np, ptt, counters, cfg,
                                        GPT_STEPS, GPT_BF16_PER_STEP)
    plain, plain_ok, plain_trained = _gpt_run(
        torch, np, ptt, counters, _gpt_cfg(gpt, dtype="bfloat16"),
        GPT_NO_RECOMPUTE_STEPS, GPT_PER_STEP)
    close_executor(torch, "gpt_train_bf16 no recompute", plain_trained[0])
    lower = remat["step_peak_above_resident_gb"] < \
        plain["step_peak_above_resident_gb"]
    same_first = remat["losses"][0] == plain["losses"][0]
    loss_diff = max(abs(a - b) for a, b in zip(remat["losses"],
                                               plain["losses"]))
    ok = remat_ok and plain_ok and lower and same_first
    emit({"phase": "gpt_train_bf16", "ok": ok, "model": "gpt_base",
          "hidden": cfg.hidden_size, "layers": cfg.num_layers,
          "heads": cfg.num_heads, "vocab": cfg.vocab_size,
          "batch": GPT_BATCH, "seq_len": GPT_SEQ, "dropout": cfg.dropout,
          "attn_impl": cfg.attn_impl, "optimizer": "Adam(1e-4)",
          "recompute_run": remat, "no_recompute_run": plain,
          "recompute_peaks_lower": lower,
          "first_loss_bit_equal": same_first,
          "loss_max_abs_diff_first_steps": loss_diff,
          "launches": remat["launches"]})
    if not ok:
        raise AssertionError("gpt_train_bf16 checks failed (see the line "
                             "above)")
    return remat["launches"], trained


def gpt_eval(torch, np, ptt, counters, trained):
    """On the trained scope: the decode program's logits through
    softmax_with_cross_entropy, a masked mean and its gradient to the
    logits (the CE kernels), against the fused-head kernel's loss of the
    same weights and batch."""
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.framework.backward import gradients
    from paddle_tpu_torch.models import gpt
    exe, _, scope, feed, _, cfg = trained
    with ptt.unique_name.guard():
        main, startup, _, fetch = gpt.gpt_logits_program(cfg, GPT_SEQ)
        with ptt.program_guard(main, startup):
            labels = layers.data("labels", [GPT_SEQ, 1], dtype="int64")
            lmask = layers.data("loss_mask", [GPT_SEQ, 1], dtype="float32")
            ce = layers.softmax_with_cross_entropy(fetch["logits"], labels)
            loss = layers.elementwise_div(
                layers.reduce_sum(layers.elementwise_mul(ce, lmask)),
                layers.elementwise_add(
                    layers.reduce_sum(lmask),
                    layers.fill_constant([1], "float32", 1e-8)))
            dlogits, = gradients([loss], [fetch["logits"]])
        head_main, _, _, head_fetch = gpt.gpt_pretrain_program(
            cfg, GPT_BATCH, GPT_SEQ, is_test=True)
    with ptt.scope_guard(scope):
        counters.zero()                      # the CE run
        t0 = time.perf_counter()
        ce_loss, grad = exe.run(main, feed=feed, fetch_list=[loss, dlogits],
                                return_numpy=False)
        torch.cuda.synchronize()
        ce_ms = (time.perf_counter() - t0) * 1e3
        ce_launches = counters.read()
        counters.zero()                      # the fused-head run
        t0 = time.perf_counter()
        head_loss, = exe.run(head_main, feed=feed,
                             fetch_list=[head_fetch["loss"]])
        head_ms = (time.perf_counter() - t0) * 1e3
        head_launches = counters.read()
    ce_loss = float(ce_loss.reshape(()))
    head_loss = float(np.asarray(head_loss).reshape(()))
    rel = abs(ce_loss - head_loss) / abs(head_loss)
    # each row of dlogits is (p - onehot) * dloss: it sums to 0
    row_sum = float(grad.sum(dim=-1).abs().max())
    grad_finite = bool(torch.isfinite(grad).all())
    want_ce = {k: 0 for k in ce_launches}
    want_ce.update(flash_attention_fwd=12, layer_norm_fwd=25, ce_fwd=1,
                   ce_bwd=1)
    want_head = {k: 0 for k in head_launches}
    want_head.update(flash_attention_fwd=12, layer_norm_fwd=25,
                     fused_head_fwd=1)
    counts_ok = ce_launches == want_ce and head_launches == want_head
    ok = rel <= EVAL_LOSS_RTOL and grad_finite and row_sum <= 1e-6 and \
        counts_ok and tuple(grad.shape) == (GPT_BATCH, GPT_SEQ,
                                            cfg.vocab_size)
    launches = {k: ce_launches[k] + head_launches[k] for k in ce_launches}
    emit({"phase": "gpt_eval", "ok": ok, "batch": GPT_BATCH,
          "seq_len": GPT_SEQ, "ce_kernel_loss": ce_loss,
          "head_kernel_loss": head_loss, "loss_rel_err": rel,
          "loss_rtol": EVAL_LOSS_RTOL, "dlogits_shape": list(grad.shape),
          "dlogits_finite": grad_finite, "dlogits_row_sum_max": row_sum,
          "ce_run_ms": ce_ms, "head_run_ms": head_ms,
          "ce_run_launches": ce_launches,
          "head_run_launches": head_launches, "launches": launches})
    if not ok:
        raise AssertionError("gpt_eval checks failed (see the line above)")
    return launches


def gpt_decode(torch, np, ptt, counters, trained):
    """greedy_generate at full width on the card; the CPU's logits of the
    card's tokens must put each chosen token within SERVE_ATOL of its
    step's maximum (a check that holds through near-ties)."""
    from paddle_tpu_torch.framework.scope import to_numpy
    from paddle_tpu_torch.io import set_params_from_numpy
    from paddle_tpu_torch.models import gpt
    exe, _, scope, _, _, cfg = trained
    total = DECODE_PROMPT + DECODE_NEW
    with ptt.unique_name.guard():
        prog = gpt.gpt_logits_program(cfg, total)
    prompt = np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (DECODE_BATCH, DECODE_PROMPT))
    counters.zero()                          # the main path starts here
    t0 = time.perf_counter()
    with ptt.scope_guard(scope):
        toks = gpt.greedy_generate(exe, cfg, prompt, DECODE_NEW,
                                   logits_program=prog)
    decode_ms = (time.perf_counter() - t0) * 1e3
    launches = counters.read()
    main = prog[0]
    arrays = {p.name: to_numpy(scope.find_var(p.name))
              for p in main.all_parameters()}
    cpu_scope = ptt.Scope()
    set_params_from_numpy(arrays, main, cpu_scope, ptt.CPUPlace())
    pos = np.tile(np.arange(total).reshape(1, total, 1),
                  (DECODE_BATCH, 1, 1)).astype(np.int64)
    t0 = time.perf_counter()
    cpu_logits, = ptt.Executor(ptt.CPUPlace()).run(
        main, feed={"token_ids": toks[:, :, None], "pos_ids": pos},
        fetch_list=[prog[3]["logits"]], scope=cpu_scope)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    steps = cpu_logits[:, DECODE_PROMPT - 1:total - 1, :]
    chosen = toks[:, DECODE_PROMPT:]
    gap = steps.max(axis=-1) - np.take_along_axis(
        steps, chosen[..., None], axis=-1)[..., 0]
    want = {k: 0 for k in launches}
    want.update(flash_attention_fwd=12 * DECODE_NEW,
                layer_norm_fwd=25 * DECODE_NEW)
    ok = bool((toks[:, :DECODE_PROMPT] == prompt).all()) and \
        float(gap.max()) <= SERVE_ATOL and launches == want and \
        toks.shape == (DECODE_BATCH, total)
    emit({"phase": "gpt_decode", "ok": ok, "batch": DECODE_BATCH,
          "prompt": DECODE_PROMPT, "new_tokens": DECODE_NEW,
          "decode_ms": decode_ms, "ms_per_token": decode_ms / DECODE_NEW,
          "cpu_check_ms": cpu_ms, "max_gap_to_cpu_max_logit":
          float(gap.max()), "atol": SERVE_ATOL,
          "tokens_tail": toks[:, DECODE_PROMPT:].tolist(),
          "launches": launches})
    if not ok:
        raise AssertionError("gpt_decode checks failed (see the line above)")
    return launches


def gpt_train_parity(torch, np, ptt):
    """Three steps of a 2-layer GPT-base-width model (vocab 32000, 2 x 128
    tokens: the head kernels tile) on the card and on the CPU from the
    same weights."""
    from paddle_tpu_torch.models import gpt
    cfg = _gpt_cfg(gpt, num_layers=PARITY_LAYERS)
    main, startup, fetch_list = _gpt_train_program(
        ptt, gpt, cfg, GPT_PARITY_BATCH, GPT_PARITY_SEQ)
    feed = gpt.synthetic_batch(cfg, GPT_PARITY_BATCH, GPT_PARITY_SEQ, seed=1)
    result, ok = _card_vs_cpu(np, ptt, main, startup, fetch_list, feed)
    emit(dict({"phase": "gpt_train_parity", "ok": ok,
               "layers": PARITY_LAYERS, "hidden": cfg.hidden_size,
               "vocab": cfg.vocab_size, "batch": GPT_PARITY_BATCH,
               "seq_len": GPT_PARITY_SEQ}, **result))
    if not ok:
        raise AssertionError("gpt_train_parity checks failed (see the line "
                             "above)")


def _remat_on_card(torch, np, ptt):
    """A 2-layer bf16 GPT-base-width model (2 x 128) on the card with and
    without recompute from the same seeded startup: the first step's loss
    and every gradient, then PARITY_STEPS steps' losses and parameters.
    The re-run launches the same deterministic kernels on the same inputs,
    so all of it must be equal bit for bit."""
    from paddle_tpu_torch.models import gpt
    runs = {}
    for remat in (True, False):
        cfg = _gpt_cfg(gpt, num_layers=PARITY_LAYERS, dtype="bfloat16",
                       recompute=remat)
        main, startup, fetch_list = _gpt_train_program(
            ptt, gpt, cfg, GPT_PARITY_BATCH, GPT_PARITY_SEQ)
        feed = gpt.synthetic_batch(cfg, GPT_PARITY_BATCH, GPT_PARITY_SEQ,
                                   seed=1)
        names = [p.name for p in main.all_parameters()]
        scope, exe = ptt.Scope(), ptt.Executor()
        with ptt.scope_guard(scope):
            exe.run(startup)
            first = exe.run(main, feed=feed, return_numpy=False,
                            fetch_list=fetch_list + [n + "@GRAD"
                                                     for n in names])
            losses = [float(first[0].reshape(()))] + [float(np.asarray(
                exe.run(main, feed=feed, fetch_list=fetch_list)[0]
            ).reshape(())) for _ in range(PARITY_STEPS - 1)]
        runs[remat] = (first, losses, {n: scope.find_var(n) for n in names},
                       names)
        exe.close()
    (r_first, r_loss, r_par, names), (p_first, p_loss, p_par, _) = \
        runs[True], runs[False]
    unequal = [name for name, a, b in zip(["loss"] + names, r_first, p_first)
               if not torch.equal(a, b)]
    unequal += [n for n in names if not torch.equal(r_par[n], p_par[n])]
    par_diff = max(_max_err(r_par[n], p_par[n]) for n in names)
    ok = not unequal and r_loss == p_loss
    return {"layers": PARITY_LAYERS, "batch": GPT_PARITY_BATCH,
            "seq_len": GPT_PARITY_SEQ, "dtype": "bfloat16",
            "unequal": unequal,
            "losses_recompute": r_loss, "losses_no_recompute": p_loss,
            "losses_bit_equal": r_loss == p_loss,
            "loss_max_abs_diff": max(abs(a - b) for a, b in zip(r_loss,
                                                                p_loss)),
            "param_max_abs_diff": par_diff}, ok


def _bf16_decode_on_card(torch, np, ptt):
    """A 2-layer bf16 GPT-base-width model decodes DECODE_NEW tokens with
    ``greedy_generate`` on the card; the logits come back f32 (the tied
    head is ``matmul(out_dtype="float32")``: one cuBLAS product with an
    f32 output, ``torch.mm(out_dtype=)``), within BF16_DECODE_ATOL of the
    CPU's logits of the same tokens, and each chosen token within it of
    the CPU's largest logit. The widened product's gradients on the card
    (bf16, the cotangent cast first) are held against the CPU's."""
    from paddle_tpu_torch.framework.scope import to_numpy
    from paddle_tpu_torch.io import set_params_from_numpy
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.ops.math_ops import _MatmulWiden
    cfg = _gpt_cfg(gpt, num_layers=PARITY_LAYERS, dtype="bfloat16")
    total = GPT_PARITY_DECODE_PROMPT + DECODE_NEW
    with ptt.unique_name.guard():
        prog = gpt.gpt_logits_program(cfg, total)
    main, startup, _, fetch = prog
    prompt = np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (GPT_PARITY_BATCH, GPT_PARITY_DECODE_PROMPT))
    scope, exe = ptt.Scope(), ptt.Executor()
    with ptt.scope_guard(scope):
        exe.run(startup)
        toks = gpt.greedy_generate(exe, cfg, prompt, DECODE_NEW,
                                   logits_program=prog)
        feed = {"token_ids": toks[:, :, None],
                "pos_ids": np.tile(np.arange(total).reshape(1, total, 1),
                                   (GPT_PARITY_BATCH, 1, 1))}
        card, = exe.run(main, feed=feed, fetch_list=[fetch["logits"]],
                        return_numpy=False)
    exe.close()
    arrays = {p.name: scope.find_var(p.name).cpu()
              for p in main.all_parameters()}
    cpu_scope = ptt.Scope()
    set_params_from_numpy(arrays, main, cpu_scope, ptt.CPUPlace())
    cpu, = ptt.Executor(ptt.CPUPlace()).run(
        main, feed=feed, fetch_list=[fetch["logits"]], scope=cpu_scope)
    err = float(np.abs(to_numpy(card) - cpu).max())
    steps = cpu[:, GPT_PARITY_DECODE_PROMPT - 1:total - 1, :]
    gap = float((steps.max(axis=-1) - np.take_along_axis(
        steps, toks[:, GPT_PARITY_DECODE_PROMPT:, None], axis=-1)[..., 0]
    ).max())
    # the widened product alone, forward and backward, card against CPU
    g = torch.Generator(device="cuda").manual_seed(SEED + 700)
    h = torch.randn(GPT_PARITY_BATCH, total, cfg.hidden_size, generator=g,
                    device="cuda").to(torch.bfloat16)
    w = (0.02 * torch.randn(cfg.vocab_size, cfg.hidden_size, generator=g,
                            device="cuda")).to(torch.bfloat16)
    cot = torch.randn(GPT_PARITY_BATCH, total, cfg.vocab_size, generator=g,
                      device="cuda")
    widen = {}
    for dev in ("cuda", "cpu"):
        x = h.to(dev).requires_grad_()
        y = w.to(dev).requires_grad_()
        out = _MatmulWiden.apply(x, y.t(), torch.float32)
        dx, dy = torch.autograd.grad(out, (x, y), cot.to(dev))
        widen[dev] = (out.detach(), dx, dy)
    dtypes = [str(t.dtype).split(".")[1] for t in widen["cuda"]]
    widen_err = [_rel_err(a.cpu(), b) for a, b in zip(widen["cuda"],
                                                      widen["cpu"])]
    ok = (card.dtype == torch.float32 and err <= BF16_DECODE_ATOL and
          gap <= BF16_DECODE_ATOL and
          bool((toks[:, :GPT_PARITY_DECODE_PROMPT] == prompt).all()) and
          dtypes == ["float32", "bfloat16", "bfloat16"] and
          widen_err[0] <= WIDEN_REL_TOL[0] and
          max(widen_err[1:]) <= WIDEN_REL_TOL[1])
    return {"layers": PARITY_LAYERS, "batch": GPT_PARITY_BATCH,
            "prompt": GPT_PARITY_DECODE_PROMPT, "new_tokens": DECODE_NEW,
            "logits_dtype": str(card.dtype).split(".")[1],
            "logits_max_abs_err_vs_cpu": err,
            "max_gap_to_cpu_max_logit": gap, "atol": BF16_DECODE_ATOL,
            "widened_matmul_dtypes": dtypes,
            "widened_matmul_rel_err": widen_err,
            "widened_matmul_rel_tol": list(WIDEN_REL_TOL)}, ok


def bf16_parity(torch, np, ptt):
    """bf16 card against CPU: three steps of a 2-layer BERT-base-width
    (4 x 128) and GPT-base-width (2 x 128) model from the same weights;
    and on the card, recompute against none (``_remat_on_card``)."""
    from paddle_tpu_torch.models import bert, gpt
    cfg = bert.bert_base(num_layers=PARITY_LAYERS, hidden_dropout=0.0,
                         attn_dropout=0.0, dtype="bfloat16")
    main, startup, fetch_list = _pretrain_program(ptt, bert, cfg,
                                                  PARITY_BATCH)
    feed = bert.synthetic_batch(cfg, PARITY_BATCH, TRAIN_SEQ, TRAIN_PREDS,
                                seed=1)
    bert_result, bert_ok = _card_vs_cpu(np, ptt, main, startup, fetch_list,
                                        feed)
    gcfg = _gpt_cfg(gpt, num_layers=PARITY_LAYERS, dtype="bfloat16")
    main, startup, fetch_list = _gpt_train_program(
        ptt, gpt, gcfg, GPT_PARITY_BATCH, GPT_PARITY_SEQ)
    feed = gpt.synthetic_batch(gcfg, GPT_PARITY_BATCH, GPT_PARITY_SEQ,
                               seed=1)
    gpt_result, gpt_ok = _card_vs_cpu(np, ptt, main, startup, fetch_list,
                                      feed)
    remat, remat_ok = _remat_on_card(torch, np, ptt)
    decode, decode_ok = _bf16_decode_on_card(torch, np, ptt)
    ok = bert_ok and gpt_ok and remat_ok and decode_ok
    emit({"phase": "bf16_parity", "ok": ok,
          "bert": dict({"ok": bert_ok, "batch": PARITY_BATCH,
                        "seq_len": TRAIN_SEQ}, **bert_result),
          "gpt": dict({"ok": gpt_ok, "batch": GPT_PARITY_BATCH,
                       "seq_len": GPT_PARITY_SEQ}, **gpt_result),
          "recompute_vs_none_on_card": dict({"ok": remat_ok}, **remat),
          "decode_on_card": dict({"ok": decode_ok}, **decode)})
    if not ok:
        raise AssertionError("bf16_parity checks failed (see the line "
                             "above)")


def optimizer_parity(torch, np, ptt):
    """Each optimizer under the recipe's schedule and clip with an
    L2Decay regularizer: three steps of a 2-layer BERT-base-width model on
    the card and on the CPU from the same weights, held to PARITY_*; f32
    for every optimizer, bf16 for AdamW and LAMB. Then DP-SGD's clip and
    noise on the card (``_dpsgd_on_card``)."""
    from paddle_tpu_torch.models import bert
    results, ok = [], True
    for dtype in ("float32", "bfloat16"):
        cfg = bert.bert_base(num_layers=PARITY_LAYERS, hidden_dropout=0.0,
                             attn_dropout=0.0, dtype=dtype)
        feed = bert.synthetic_batch(cfg, PARITY_BATCH, TRAIN_SEQ,
                                    TRAIN_PREDS, seed=1)
        for name, base, scheduled, make in PARITY_OPTIMIZERS:
            if dtype == "bfloat16" and name not in PARITY_BF16_OPTIMIZERS:
                continue
            main, startup, fetch_list = _pretrain_program(
                ptt, bert, cfg, PARITY_BATCH, _recipe_optimizer(
                    ptt, make, base,
                    regularization=ptt.regularizer.L2Decay(PARITY_L2),
                    scheduled=scheduled))
            result, case_ok = _card_vs_cpu(np, ptt, main, startup,
                                           fetch_list, feed)
            ok = ok and case_ok
            results.append(dict({"optimizer": name, "base_lr": base,
                                 "scheduled": scheduled, "ok": case_ok},
                                **result))
    dpsgd, dpsgd_ok = _dpsgd_on_card(torch, np, ptt)
    ok = ok and dpsgd_ok
    emit({"phase": "optimizer_parity", "ok": ok, "layers": PARITY_LAYERS,
          "batch": PARITY_BATCH, "seq_len": TRAIN_SEQ,
          "regularizer": "L2Decay(%g)" % PARITY_L2,
          "clip": "GradientClipByGlobalNorm(%g)" % RECIPE_CLIP,
          "cases": results, "dpsgd": dict({"ok": dpsgd_ok}, **dpsgd)})
    if not ok:
        raise AssertionError("optimizer_parity checks failed (see the line "
                             "above)")


def _dpsgd_on_card(torch, np, ptt):
    """Dpsgd on a DPSGD_N-element parameter through Executor.run on the
    card: with sigma 0, the step is lr times the gradient clipped to norm
    DPSGD_CLIP (a gradient of norm 1000 * DPSGD_CLIP); with a zero
    gradient, the step is lr times the noise, whose mean and std must lie
    within 5 standard errors of 0 and sigma * clip."""
    def run(sigma, scale):
        main, startup = ptt.Program(), ptt.Program()
        startup.random_seed = SEED
        with ptt.unique_name.guard(), ptt.program_guard(main, startup):
            c = ptt.layers.data("c", [DPSGD_N], append_batch_size=False)
            w = ptt.layers.create_parameter([DPSGD_N], "float32")
            loss = ptt.layers.reduce_sum(ptt.layers.elementwise_mul(w, c))
            ptt.optimizer.Dpsgd(DPSGD_LR, clip=DPSGD_CLIP,
                                sigma=sigma).minimize(loss)
        scope = ptt.Scope()
        exe = ptt.Executor()                 # CUDAPlace(0)
        exe.run(startup, scope=scope)
        start = scope.find_var(w.name).clone()
        feed = {"c": np.full(DPSGD_N, scale, np.float32)}
        exe.run(main, feed=feed, scope=scope)
        step = (start - scope.find_var(w.name)).double() / DPSGD_LR
        return step.cpu().numpy()
    clipped = run(0.0, 1000.0 * DPSGD_CLIP / DPSGD_N ** 0.5)
    noise = run(DPSGD_SIGMA, 0.0)
    std = DPSGD_SIGMA * DPSGD_CLIP
    norm = float(np.linalg.norm(clipped))
    mean_bound = 5 * std / DPSGD_N ** 0.5
    std_bound = 5 * std / (2 * DPSGD_N) ** 0.5
    ok = (abs(norm - DPSGD_CLIP) <= 1e-3 * DPSGD_CLIP
          and abs(float(noise.mean())) <= mean_bound
          and abs(float(noise.std()) - std) <= std_bound)
    return {"elements": DPSGD_N, "clip": DPSGD_CLIP, "sigma": DPSGD_SIGMA,
            "clipped_step_norm": norm, "noise_mean": float(noise.mean()),
            "noise_std": float(noise.std()), "target_std": std,
            "mean_bound": mean_bound, "std_bound": std_bound}, ok


def close_executor(torch, label, exe):
    """Close a phase's Executor (its graphs and their pool go) and print
    the memory the process still holds."""
    exe.close()
    emit({"phase": "close", "of": label,
          "memory_reserved_gb": torch.cuda.memory_reserved() / 2 ** 30,
          "memory_allocated_gb": torch.cuda.memory_allocated() / 2 ** 30})


def _copy_scope(torch, ptt, scope):
    """A scope holding a clone of each of ``scope``'s tensors and its run
    counter, so two runs start from the same state and draw the same
    numbers."""
    out = ptt.Scope()
    for name, val in scope.items():
        out.set_var(name, val.clone() if isinstance(val, torch.Tensor)
                    else val)
    return out


def _kernel_check(found, families):
    """(the families of ``families`` that a profiled run shows no kernel
    of, the library kernels it shows)."""
    seen = {_family(k) for k in found["kernel_names"]}
    library = [k for k in found["kernel_names"]
               if any(p in k.lower() for p in LIBRARY_KERNELS)]
    return [f for f in families if f not in seen], library


def _capture_record(exe):
    return [{"feeds": c["feeds"], "capture_ms": c["capture_ms"],
             "pool_bytes": c["pool_bytes"]} for c in exe.capture_log]


def graph_serve(torch, np, ptt, counters, pred, requests):
    """BERT-base serving at T=512, batches 1 and 8, on the served
    predictor: op by op (``use_program_cache=False``) and graphed
    (``Predictor.run``; the serve phase ran each batch twice, so its
    bucket is captured). Answers bit for bit equal; latency both ways,
    GRAPH_SERVE_REPS requests each in turns; launches per request; one
    request each way profiled, the replay's kernel names checked."""
    exe = pred._exe
    cases, ok = [], True
    for n in GRAPH_SERVE_BATCHES:
        feed = next(r for r in requests if len(r["src_ids"]) == n)

        def op_by_op(feed=feed):
            with ptt.scope_guard(pred._scope):
                return exe.run(pred._program, feed=feed,
                               fetch_list=pred._fetch_names,
                               use_program_cache=False)
        ways = (("op_by_op", op_by_op), ("graphed", lambda f=feed:
                                          pred.run(f)))
        answers, launches, ms = {}, {}, {w: [] for w, _ in ways}
        for way, fn in ways:
            before = counters.read()
            answers[way] = fn()
            after = counters.read()
            launches[way] = {k: after[k] - before[k] for k in after
                             if after[k] != before[k]}
        for _ in range(GRAPH_SERVE_REPS):
            for way, fn in ways:
                t0 = time.perf_counter()
                fn()
                ms[way].append((time.perf_counter() - t0) * 1e3)
        found = {way: _profiled(torch, fn) for way, fn in ways}
        missing, library = _kernel_check(found["graphed"], SERVE_FAMILIES)
        equal = all(np.array_equal(a, b) for a, b in
                    zip(answers["op_by_op"], answers["graphed"]))
        want = {"flash_attention_fwd": FLASH_PER_REQUEST,
                "layer_norm_fwd": LN_PER_REQUEST}
        case_ok = equal and launches["op_by_op"] == want and \
            launches["graphed"] == want and not missing and not library
        ok = ok and case_ok
        cases.append({
            "batch": n, "ok": case_ok, "answers_bit_equal": equal,
            "request_ms": ms,
            "request_ms_median": {w: statistics.median(v)
                                  for w, v in ms.items()},
            "launches_per_request": launches,
            "captures": [c for c in _capture_record(exe)
                         if c["feeds"]["src_ids"][0] == n],
            "missing_kernel_families": missing,
            "library_kernels": library,
            "profile": found})
    emit({"phase": "graph_serve", "ok": ok, "seq_len": SEQ_LEN,
          "cases": cases})
    if not ok:
        raise AssertionError("graph_serve checks failed (see the line "
                             "above)")


def _both_ways(torch, np, ptt, counters, label, main, startup, feed,
               fetch_list, want, families):
    """GRAPH_STEPS runs of ``main`` op by op and graphed, each way on its
    own copy of one started scope (the run counter included), then one
    run each way profiled: (the record, ok, the graphed way's fetches and
    state after GRAPH_STEPS runs, the started scope). The last fetch is a
    dropout Mask, which must differ from step to step."""
    start = ptt.Scope()
    ptt.Executor().run(startup, scope=start)    # no fetch list: no graph
    persist = [v.name for v in main.list_vars() if v.persistable]
    ways = {}
    for way, cache in (("op_by_op", False), ("graphed", True)):
        scope, exe = _copy_scope(torch, ptt, start), ptt.Executor()
        step_ms, fetched, per_step = [], [], []
        counters.zero()                      # the main path starts here
        for _ in range(GRAPH_STEPS):
            before = counters.read()
            t0 = time.perf_counter()
            fetched.append(exe.run(main, feed=feed, fetch_list=fetch_list,
                                   scope=scope, use_program_cache=cache,
                                   return_numpy=False))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            after = counters.read()
            per_step.append({k: after[k] - before[k] for k in after})
        ways[way] = {"exe": exe, "scope": scope, "step_ms": step_ms,
                     "fetched": fetched, "per_step": per_step,
                     "launches": counters.read()}
    a, b = ways["op_by_op"], ways["graphed"]
    unequal = [fetch_list[i].name for i in range(len(fetch_list))
               if not all(torch.equal(x[i], y[i])
                          for x, y in zip(a["fetched"], b["fetched"]))]
    unequal += [n for n in persist if not torch.equal(
        a["scope"].find_var(n), b["scope"].find_var(n))]
    masks = [f[-1] for f in b["fetched"]]
    masks_differ = all(not torch.equal(x, y)
                       for x, y in zip(masks, masks[1:]))
    counts_ok = all(c == want for c in a["per_step"] + b["per_step"])
    reference = ([[t.clone() for t in f[:-1]] for f in b["fetched"]],
                 {n: b["scope"].find_var(n).clone() for n in persist})
    found = {}
    for way, cache in (("op_by_op", False), ("graphed", True)):
        w = ways[way]
        found[way] = _profiled(torch, lambda w=w, cache=cache: w["exe"].run(
            main, feed=feed, fetch_list=fetch_list, scope=w["scope"],
            use_program_cache=cache))
    missing, library = _kernel_check(found["graphed"], families)
    ok = not unequal and masks_differ and counts_ok and not missing and \
        not library and all(np.isfinite(float(f[0].reshape(())))
                            for f in b["fetched"])
    record = {
        "steps": GRAPH_STEPS, "bit_equal": not unequal,
        "unequal": unequal[:8], "masks_differ_step_to_step": masks_differ,
        "losses": {w: [float(f[0].reshape(())) for f in ways[w]["fetched"]]
                   for w in ways},
        "step_ms": {w: ways[w]["step_ms"] for w in ways},
        "replay_ms_median": statistics.median(b["step_ms"][2:]),
        "op_by_op_ms_median": statistics.median(a["step_ms"][1:]),
        "launches_per_step": {w: ways[w]["per_step"][-1] for w in ways},
        "launches_per_step_ok": counts_ok,
        "captures": _capture_record(b["exe"]),
        "missing_kernel_families": missing, "library_kernels": library,
        "profile": found}
    launches = b["launches"]
    for way in ways:
        close_executor(torch, "%s %s" % (label, way), ways[way]["exe"])
    return record, ok, reference, start, launches


def _dropout_mask(main):
    """A Mask output of a dropout op of ``main``'s global block."""
    return main.global_block().var(next(
        op.output("Mask")[0] for op in main.global_block().ops
        if op.type == "dropout"))


def _adam_in_graph(torch, np, fad, main):
    """The multi-tensor question: the recipe step's fused-Adam launches as
    a graph replays them (one per parameter, its shape and dtype, f32
    gradients and moments, AdamW's decay), against one launch per dtype
    over flat buffers of the same elements, also replayed from a graph.
    Device time by CUDA events."""
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    per = [(int(np.prod(p.shape)), dtypes[p.dtype])
           for p in main.all_parameters()]
    flat = {}
    for n, d in per:
        flat[d] = flat.get(d, 0) + n
    scalars = [torch.full((1,), v, device="cuda")
               for v in (RECIPE_LR, 0.9, 0.999)]

    def buffers(numels):
        return [(torch.zeros(n, dtype=d, device="cuda"),
                 torch.full((n,), 1e-3, device="cuda"),
                 torch.zeros(n, device="cuda"), torch.zeros(n, device="cuda"))
                for n, d in numels]

    def step(bufs):
        for p, g, m1, m2 in bufs:
            fad.fused_adam(p, g, m1, m2, *scalars, coeff=RECIPE_WEIGHT_DECAY)
    out = {"elements": sum(n for n, _ in per)}
    for label, numels in (("per_parameter", per),
                          ("one_per_dtype",
                           [(n, d) for d, n in flat.items()])):
        bufs = buffers(numels)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step(bufs)                       # warm
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step(bufs)
        out[label] = {"launches": len(bufs),
                      "graph_ms": time_ms(torch, graph.replay, 5, 5)}
        del graph, bufs
    extra = out["per_parameter"]["graph_ms"] - out["one_per_dtype"]["graph_ms"]
    out["extra_ms_for_the_launches"] = extra
    out["us_per_extra_launch"] = extra * 1e3 / (
        out["per_parameter"]["launches"] - out["one_per_dtype"]["launches"])
    return out


def graph_train(torch, np, ptt, counters, fad):
    """The BERT recipe step (bf16 BERT-base, batch 128 x 128, dropout 0.1,
    AdamW under the warmup and decay, global-norm clip) GRAPH_STEPS runs op
    by op and graphed from one startup and run counter: fetches (losses,
    rate, global norm, a dropout Mask) and final state bit for bit equal,
    the Mask different every step, train_recipe's launches a step both
    ways; one run each way profiled; the Adam launches inside a graph."""
    from paddle_tpu_torch.models import bert
    fetch = {}
    cfg = bert.bert_base(dtype="bfloat16")
    main, startup, fetch_list = _pretrain_program(
        ptt, bert, cfg, BF16_TRAIN_BATCH, _recipe_optimizer(
            ptt, lambda o, lr: o.AdamW(lr, weight_decay=RECIPE_WEIGHT_DECAY),
            RECIPE_LR, fetch=fetch))
    fetch_list = fetch_list + [fetch["lr"], fetch["global_norm"],
                               _dropout_mask(main)]
    feed = bert.synthetic_batch(cfg, BF16_TRAIN_BATCH, TRAIN_SEQ,
                                TRAIN_PREDS, seed=0)
    record, ok, reference, start, launches = _both_ways(
        torch, np, ptt, counters, "graph_train", main, startup, feed,
        fetch_list, TRAIN_PER_STEP, TRAIN_FAMILIES)
    adam = _adam_in_graph(torch, np, fad, main)
    emit(dict({"phase": "graph_train", "ok": ok, "model": "bert_base",
               "dtype": cfg.dtype, "batch": BF16_TRAIN_BATCH,
               "seq_len": TRAIN_SEQ, "dropout": cfg.hidden_dropout,
               "optimizer": "AdamW(schedule, weight_decay=0.01, "
               "GradientClipByGlobalNorm(1.0))",
               "adam_in_graph": adam}, **record))
    if not ok:
        raise AssertionError("graph_train checks failed (see the line "
                             "above)")
    return launches, (main, startup, feed, fetch_list[:-1], start,
                      reference)


def run_steps(torch, np, ptt, trained):
    """A GRAPH_STEPS-step ``run_steps`` window of the recipe step from
    graph_train's startup: its stacked fetches and final state equal the
    graphed runs' bit for bit; ms per step of that window (warm run and
    capture inside) and of a second one (replays only), one host sync
    each."""
    main, _, feed, fetch_list, start, (runs, state) = trained
    window = {k: np.stack([v] * GRAPH_STEPS) for k, v in feed.items()}
    scope, exe = _copy_scope(torch, ptt, start), ptt.Executor()
    timed = []
    for _ in range(2):
        t0 = time.perf_counter()
        stacked = exe.run_steps(main, feed=window, fetch_list=fetch_list,
                                scope=scope, return_numpy=False)
        torch.cuda.synchronize()
        timed.append((time.perf_counter() - t0) * 1e3)
        if len(timed) == 1:
            unequal = [fetch_list[i].name for i in range(len(fetch_list))
                       if not all(torch.equal(stacked[i][k], runs[k][i])
                                  for k in range(GRAPH_STEPS))]
            unequal += [n for n, t in state.items()
                        if not torch.equal(scope.find_var(n), t)]
    ok = not unequal and len(exe.capture_log) == 1
    emit({"phase": "run_steps", "ok": ok, "steps": GRAPH_STEPS,
          "bit_equal_to_runs": not unequal, "unequal": unequal[:8],
          "window_ms": timed,
          "ms_per_step": [t / GRAPH_STEPS for t in timed],
          "captures": _capture_record(exe)})
    close_executor(torch, "run_steps", exe)
    if not ok:
        raise AssertionError("run_steps checks failed (see the line above)")


def _segment_mask_on_card(torch, np, ptt):
    """A seedless dropout inside a recompute segment, GRAPH_STEPS runs on
    the card (the first op by op, then captured and replayed): the
    gradient of sum(c * dropout(2 w)) is 4 c where the forward kept an
    element and 0 where it dropped it, every run, and the masks differ
    from run to run."""
    main, startup = ptt.Program(), ptt.Program()
    with ptt.unique_name.guard(), ptt.program_guard(main, startup):
        w = ptt.layers.create_parameter(
            [256, 256], "float32", name="w",
            default_initializer=ptt.initializer.ConstantInitializer(1.0))
        c = ptt.layers.data("c", [256, 256], append_batch_size=False)
        h = ptt.layers.recompute_segment(
            lambda a: ptt.layers.dropout(
                ptt.layers.scale(a, scale=2.0), 0.5,
                dropout_implementation="upscale_in_train"), [w])
        loss = ptt.layers.reduce_sum(ptt.layers.elementwise_mul(h, c))
        (_, gw), = ptt.append_backward(loss)
    c_val = np.random.RandomState(SEED).rand(256, 256).astype(np.float32) + 1
    scope, exe = ptt.Scope(), ptt.Executor()
    exe.run(startup, scope=scope)
    kept, right = [], True
    for _ in range(GRAPH_STEPS):
        hv, g = exe.run(main, feed={"c": c_val}, fetch_list=[h, gw],
                        scope=scope)
        k = hv != 0
        right = right and bool((hv == np.where(k, 4.0, 0.0)).all()) and \
            bool((g == np.where(k, 4.0 * c_val, 0.0)).all()) and \
            bool(0.4 < k.mean() < 0.6)
        kept.append(k)
    differ = all((x != y).any() for x, y in zip(kept, kept[1:]))
    captured = len(exe.capture_log) == 1
    exe.close()
    return {"runs": GRAPH_STEPS, "gradient_uses_forward_mask": right,
            "masks_differ": differ, "captured": captured}, \
        right and differ and captured


def _set_params_between_replays(torch, np, ptt):
    """A weight replaced with ``set_params_from_numpy`` after the step was
    captured: the next replay copies it into the graph's static input and
    computes with it, and the scope holds the static tensor again."""
    main, startup = ptt.Program(), ptt.Program()
    with ptt.unique_name.guard(), ptt.program_guard(main, startup):
        x = ptt.layers.data("x", [64, 256], append_batch_size=False)
        w = ptt.layers.create_parameter([256, 128], "float32", name="w")
        y = ptt.layers.mul(x, w)
    rng = np.random.RandomState(SEED)
    xv = rng.rand(64, 256).astype(np.float32)
    scope, exe = ptt.Scope(), ptt.Executor()
    exe.run(startup, scope=scope)
    for _ in range(3):                       # warm run, capture, replay
        exe.run(main, feed={"x": xv}, fetch_list=[y], scope=scope)
    static = scope.find_var("w")
    new_w = rng.rand(256, 128).astype(np.float32)
    ptt.set_params_from_numpy({"w": new_w}, main, scope)
    replaced = scope.find_var("w") is not static
    got, = exe.run(main, feed={"x": xv}, fetch_list=[y], scope=scope)
    err = float(np.abs(got - xv.astype(np.float64) @ new_w).max())
    ok = replaced and scope.find_var("w") is static and err <= 1e-4 and \
        len(exe.capture_log) == 1
    exe.close()
    return {"replaced_in_scope": replaced, "max_abs_err_vs_numpy": err,
            "atol": 1e-4, "captures": len(exe.capture_log)}, ok


def graph_gpt(torch, np, ptt, counters):
    """GPT-base bf16 with flash and recompute at 2 x 4096 (bench.py:596-601
    but dropout 0.1, so the recomputed segments redraw masks),
    GRAPH_STEPS runs op by op and graphed from one startup and run
    counter: loss, the embedding dropout's Mask and final state bit for
    bit equal, the Mask different every step, gpt_train_bf16's launches a
    step both ways; one run each way profiled. Then a seedless dropout in
    a segment on the card (``_segment_mask_on_card``) and a weight set
    between replays (``_set_params_between_replays``)."""
    from paddle_tpu_torch.models import gpt
    cfg = _gpt_cfg(gpt, dtype="bfloat16", recompute=True,
                   dropout=GRAPH_GPT_DROPOUT)
    main, startup, fetch_list = _gpt_train_program(ptt, gpt, cfg, GPT_BATCH,
                                                   GPT_SEQ)
    fetch_list = fetch_list + [_dropout_mask(main)]
    feed = gpt.synthetic_batch(cfg, GPT_BATCH, GPT_SEQ, seed=0)
    record, ok, _, _, launches = _both_ways(
        torch, np, ptt, counters, "graph_gpt", main, startup, feed,
        fetch_list, GPT_BF16_PER_STEP, GPT_FAMILIES)
    segment, segment_ok = _segment_mask_on_card(torch, np, ptt)
    copy_in, copy_in_ok = _set_params_between_replays(torch, np, ptt)
    ok = ok and segment_ok and copy_in_ok
    emit(dict({"phase": "graph_gpt", "ok": ok, "model": "gpt_base",
               "dtype": cfg.dtype, "recompute": cfg.recompute,
               "batch": GPT_BATCH, "seq_len": GPT_SEQ,
               "dropout": cfg.dropout, "optimizer": "Adam(1e-4)",
               "segment_mask_on_card": segment,
               "set_params_between_replays": copy_in}, **record))
    if not ok:
        raise AssertionError("graph_gpt checks failed (see the line above)")
    return launches


def _family(kernel):
    k = kernel.lower()
    for key, fam in (("flash_fwd_kernel", "flash_attention_fwd"),
                     ("flash_bwd_dkv_kernel", "flash_attention_bwd_dkv"),
                     ("flash_bwd_dq_kernel", "flash_attention_bwd_dq"),
                     ("ln_fwd_", "layer_norm_fwd"),
                     ("ln_bwd_", "layer_norm_bwd"),
                     ("adam_kernel", "fused_adam"),
                     ("head_fwd_kernel", "fused_head_fwd"),
                     ("head_dh_kernel", "fused_head_dh"),
                     ("head_dw_kernel", "fused_head_dw"),
                     ("ce_fwd_kernel", "ce_fwd"),
                     ("ce_bwd_kernel", "ce_bwd"),
                     ("memcpy", "memcpy host<->device"),
                     ("gemm", "matmul"), ("xmma", "matmul"),
                     ("nvjet", "matmul"),
                     ("cutlass", "matmul"),
                     ("index", "scatter/index (embedding, gather)"),
                     ("scatter", "scatter/index (embedding, gather)"),
                     ("gather", "scatter/index (embedding, gather)"),
                     ("copy", "copy (layout/dtype)")):
        if key in k:
            return fam
    return "elementwise/other"


def _profiled(torch, fn):
    """Where one run of ``fn`` spends its time on the card: device time by
    kernel family from torch.profiler, against the host time of the
    profiled run (the profiler's own cost included) and the median host
    time of PROFILE_PLAIN_RUNS runs without the profiler just before it
    (``idle_share_unprofiled``); every kernel's name. A profiler that
    records no device time is reported, not failed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    plain = []
    for _ in range(PROFILE_PLAIN_RUNS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        plain.append((time.perf_counter() - t0) * 1e3)
    plain_ms = statistics.median(plain)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_family, top, names = {}, [], set()
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        fam = _family(e.key)
        by_family[fam] = by_family.get(fam, 0.0) + ms
        top.append([ms, e.count, e.key[:100]])
        names.add(e.key[:120])
    busy = sum(by_family.values())
    return {"host_ms": wall_ms,
            "device_busy_ms": busy if busy else "not measured",
            "idle_share": 1 - busy / wall_ms if busy else "not measured",
            "unprofiled_ms": plain,
            "idle_share_unprofiled": 1 - busy / plain_ms if busy else
            "not measured",
            "device_ms_by_family": by_family,
            "top_kernels": sorted(top, reverse=True)[:12],
            "kernel_names": sorted(names)}


def profile(torch, runs):
    """``_profiled`` for each (label, run) of ``runs``, a line each (the
    kernel names left out: the graph phases list them)."""
    for label, fn in runs:
        found = _profiled(torch, fn)
        found.pop("kernel_names")
        emit(dict({"phase": "profile", "run": label}, **found))


def host_ops(torch, runs):
    """Where a warm BERT bf16 step's host time goes when it runs op by op
    (a replay dispatches no op): one run with each op's dispatch timed on
    the host clock (the Executor's forward-op and grad_of calls; the card
    runs behind them, so this is the host's cost of issuing each op type),
    summed by op type, beside the run's whole host time. Diagnostic
    only."""
    from paddle_tpu_torch.framework import executor
    fwd, grad = executor._run_fwd_op, executor.trace.run_grad_op
    for label, fn in runs:
        fn()
        torch.cuda.synchronize()
        by_type = {}

        def timed(kind, inner):
            def call(op, *args):
                t0 = time.perf_counter()
                try:
                    return inner(op, *args)
                finally:
                    key = op.type if kind == "op" else \
                        "grad_of(%s)" % op.attrs["fwd_type"]
                    n, ms = by_type.get(key, (0, 0.0))
                    by_type[key] = (n + 1, ms + (time.perf_counter() - t0)
                                    * 1e3)
            return call
        executor._run_fwd_op = timed("op", fwd)
        executor.trace.run_grad_op = timed("grad", grad)
        try:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            executor._run_fwd_op, executor.trace.run_grad_op = fwd, grad
        emit({"phase": "host_ops", "run": label, "host_ms": wall_ms,
              "op_calls": sum(n for n, _ in by_type.values()),
              "dispatch_ms": sum(ms for _, ms in by_type.values()),
              "by_op_type": {k: [n, ms] for k, (n, ms) in sorted(
                  by_type.items(), key=lambda kv: -kv[1][1])}})


_KERNELS = (
    # name, source in the port, the TPU kernel it replaces
    ("flash_attention_fwd", "flash_attention_fwd.cu",
     "paddle_tpu/ops/pallas/flash_attention.py:211"),
    ("flash_attention_bwd_dkv", "flash_attention_bwd.cu",
     "paddle_tpu/ops/pallas/flash_attention.py:339"),
    ("flash_attention_bwd_dq", "flash_attention_bwd.cu",
     "paddle_tpu/ops/pallas/flash_attention.py:369"),
    ("layer_norm_fwd", "layer_norm_fwd.cu",
     "paddle_tpu/ops/pallas/layer_norm.py:97"),
    ("layer_norm_bwd", "layer_norm_bwd.cu",
     "paddle_tpu/ops/pallas/layer_norm.py:135"),
    ("fused_adam", "fused_adam.cu", "paddle_tpu/ops/pallas/fused_adam.py:85"),
    ("fused_head_fwd", "fused_head_fwd.cu",
     "paddle_tpu/ops/pallas/blockwise_ce.py:316"),
    ("fused_head_dh", "fused_head_bwd.cu",
     "paddle_tpu/ops/pallas/blockwise_ce.py:366"),
    ("fused_head_dw", "fused_head_bwd.cu",
     "paddle_tpu/ops/pallas/blockwise_ce.py:383"),
    ("ce_fwd", "blockwise_ce.cu", "paddle_tpu/ops/pallas/blockwise_ce.py:147"),
    ("ce_bwd", "blockwise_ce.cu", "paddle_tpu/ops/pallas/blockwise_ce.py:184"),
)


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
        from paddle_tpu_torch.ops.kernels import blockwise_ce as bce
        from paddle_tpu_torch.ops.kernels import build
        from paddle_tpu_torch.ops.kernels import flash_attention as fa
        from paddle_tpu_torch.ops.kernels import fused_adam as fad
        from paddle_tpu_torch.ops.kernels import layer_norm as ln
    except ImportError as e:
        print("chip_smoke: run it from a checkout of the repository "
              "(%s)" % e, file=sys.stderr)
        return 2
    import torch.nn.functional as F
    from paddle_tpu_torch.framework.executor import set_precision
    set_precision()                          # no TF32 anywhere
    counters = Counters(fa, ln, fad, bce)
    os.makedirs(os.path.dirname(_LOG), exist_ok=True)
    open(_LOG, "w").close()

    smi = phase("device")(nvidia_smi)()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "host_cpus": os.cpu_count()})

    t0 = time.perf_counter()
    lib = phase("build")(build.load)()
    if lib is None:
        return 1
    with open(os.path.join(build.library_dir(), "nvcc.log")) as f:
        ptxas = [ln_.strip() for ln_ in f
                 if "Used" in ln_ or "spill" in ln_ or "entry function" in ln_]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": build.build_seconds, "ptxas": ptxas})

    def kernels():
        dkv, dq = flash_bwd_cases(torch, fa, F)
        found = {"flash_attention_fwd": flash_cases(torch, fa, F),
                 "flash_attention_bwd_dkv": dkv,
                 "flash_attention_bwd_dq": dq,
                 "layer_norm_fwd": ln_cases(torch, ln, F),
                 "layer_norm_bwd": ln_bwd_cases(torch, ln),
                 "fused_adam": adam_cases(torch, fad)}
        (found["fused_head_fwd"], found["fused_head_dh"],
         found["fused_head_dw"]) = head_cases(torch, bce, F)
        found["ce_fwd"], found["ce_bwd"] = ce_cases(torch, bce, F)
        ok = all(c["ok"] for cs in found.values() for c in cs)
        emit(dict({"phase": "kernels", "ok": ok}, **found))
        if not ok:
            raise AssertionError("a kernel disagrees with its plain version")
        return found
    cases = phase("kernels")(kernels)()

    # each path's launches, None where its phase failed
    by_path = {}

    def finish(path, done, label, host=False):
        """A training path: its launches kept, one more step profiled (a
        replay) and, with ``host``, one op by op with each op's dispatch
        timed; then its Executor closed."""
        by_path[path] = None if done is None else done[0]
        if done is None:
            return
        exe, main_prog, scope, feed, fetch_list = done[1][:5]

        def step(cache=True):
            exe.run(main_prog, feed=feed, fetch_list=fetch_list, scope=scope,
                    use_program_cache=cache)
        phase("profile")(profile)(torch, [(label, step)])
        if host:
            phase("host_ops")(host_ops)(torch, [(label, lambda: step(False))])
        close_executor(torch, path, exe)

    model_dir = os.path.join(_ROOT, "build", "chip_smoke_model")
    try:
        served = phase("serve")(serve)(torch, np, ptt, counters, model_dir)
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)
    by_path["serve"] = None if served is None else served[0]
    if served is not None:
        _, pred, requests = served
        phase("profile")(profile)(torch, [
            ("serve batch 1", lambda: pred.run(requests[0])),
            ("serve batch 8", lambda: pred.run(requests[2]))])
        phase("graph_serve")(graph_serve)(torch, np, ptt, counters, pred,
                                          requests)
        close_executor(torch, "serve", pred._exe)
        del served, pred, requests
    finish("train", phase("train")(train)(torch, np, ptt, counters),
           "train step")
    phase("train_parity")(train_parity)(torch, np, ptt)
    gpt_trained = phase("gpt_train")(gpt_train)(torch, np, ptt, counters)
    by_path["gpt_eval"] = by_path["gpt_decode"] = None
    if gpt_trained is not None:
        by_path["gpt_eval"] = phase("gpt_eval")(gpt_eval)(
            torch, np, ptt, counters, gpt_trained[1])
        by_path["gpt_decode"] = phase("gpt_decode")(gpt_decode)(
            torch, np, ptt, counters, gpt_trained[1])
    finish("gpt_train", gpt_trained, "gpt train step")
    del gpt_trained
    phase("gpt_train_parity")(gpt_train_parity)(torch, np, ptt)
    finish("train_bf16", phase("train_bf16")(train_bf16)(
        torch, np, ptt, counters), "train step bf16 batch 128", host=True)
    finish("gpt_train_bf16", phase("gpt_train_bf16")(gpt_train_bf16)(
        torch, np, ptt, counters), "gpt train step bf16 recompute")
    phase("bf16_parity")(bf16_parity)(torch, np, ptt)
    finish("train_recipe", phase("train_recipe")(train_recipe)(
        torch, np, ptt, counters),
        "train step bf16 batch 128 recipe (AdamW)", host=True)
    finish("train_recipe_lamb", phase("train_recipe_lamb")(
        train_recipe_lamb)(torch, np, ptt, counters),
        "train step bf16 batch 128 recipe (LAMB)", host=True)
    phase("optimizer_parity")(optimizer_parity)(torch, np, ptt)
    graphed = phase("graph_train")(graph_train)(torch, np, ptt, counters,
                                                fad)
    by_path["graph_train"] = None if graphed is None else graphed[0]
    if graphed is not None:
        phase("run_steps")(run_steps)(torch, np, ptt, graphed[1])
    del graphed
    by_path["graph_gpt"] = phase("graph_gpt")(graph_gpt)(torch, np, ptt,
                                                         counters)

    if _failed or cases is None or None in by_path.values():
        print("chip_smoke: failed phases: %s" % _failed, file=sys.stderr)
        return 1
    summary = [
        _summary(name, "paddle_tpu_torch/ops/kernels/csrc/" + src, replaces,
                 {path: n[name] for path, n in by_path.items()},
                 cases[name])
        for name, src, replaces in _KERNELS]
    idle = [k["name"] for k in summary if k["launches"] < 1]
    if idle:
        print("chip_smoke: no main path launched %s" % idle, file=sys.stderr)
        return 1
    print(smi, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


def _summary(name, source, replaces, launches_by_path, cases):
    """A kernel's line: its numbers at the main path's shape (the first
    case: BERT-base serving at the largest bucket for the flash and
    LayerNorm forward kernels, the BERT-base training step's shapes for
    their backward kernels and Adam, GPT-base's head and logits for the
    head and CE kernels), every case beside them. ``launches`` sums the
    main paths' runs. The fused-Adam line also gives its first AdamW
    case's numbers (``adamw``: coeff > 0, the same kernel) beside Adam's,
    with the AdamW launches of the recipe's path."""
    head = cases[0]
    line = {"name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(launches_by_path.values()),
            "launches_by_path": launches_by_path,
            "max_abs_err": head["max_abs_err"], "ms": head["kernel_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head.get("shape", head.get("numel")), "cases": cases}
    adamw = [c for c in cases if c.get("coeff")]
    if adamw:
        line["adamw"] = dict(
            {k: adamw[0][k] for k in ("name", "coeff", "max_abs_err",
                                      "kernel_ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")},
            launches=launches_by_path.get("train_recipe"))
    return line


if __name__ == "__main__":
    sys.exit(main())
