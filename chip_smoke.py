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

``train_state`` drives the training-state slice, graphed: the
train_recipe step with ``ExponentialMovingAverage(0.999).update()`` on
top, six steps with two checkpoints of the whole scope after the third
(uncompressed; zlib, committed on its thread while steps 4-6 replay), a
resume from the zlib one in a fresh Executor and scope and from the
other in the live Executor (steps 4-6 again: fetches, dropout masks and
every persistable bit for bit, the run counter back as a Python int),
the eval program captured and replayed under ``ema.apply()``
(parameters and accumulators bit for bit after ``restore``; the next
training replay equal to an op-by-op run), a persistable set to a new
shape (a new key, never the old graph) and back (the old graph
replays); checkpoint bytes and seconds; EMA's device time a step against
the same step without EMA.

Then ResNet-50 and DeepFM at bench.py's own settings (no hand-written
kernel on the ResNet paths; DeepFM runs the fused-Adam kernel):

- ``resnet_train``: bench.py:472-486 (f32, batch 128 x 3 x 224 x 224,
  Momentum(0.1, 0.9)) six steps; losses finite, the first update
  lowering the loss; images/s over the replays, peak memory, the
  capture's time and pool growth, the step beside its f32 FFMA bound, an
  op-by-op step's device time by op type (forward ops and grad_of), the
  cost of cuDNN's deterministic algorithms; a replay profiled.
- ``resnet_serve``: the trained weights with is_test=True (the softmax)
  saved and served at batches 1 and 8 against the CPU, op by op and
  graphed. ``graph_resnet``: the training step op by op against
  graphed, losses, accuracies, parameters, velocities and moving
  statistics bit for bit; one step under torch's deterministic check.
- ``resnet_parity``: a narrow ResNet card against CPU (RESNET_PARITY_*).
- ``deepfm_train``: bench.py:565-578 (1,000,000 features, embedding 10,
  batch 2048, Adam(1e-3)) six steps; 11 fused-Adam launches a step, the
  AUC histograms against numpy's bins of the fetched predictions and the
  fetched AUC against a float64 integral of them, examples/s, graphed
  against op by op bit for bit. ``deepfm_parity``: 5000 features card
  against CPU. The kernels phase times Adam at DeepFM's 1,000,000 x 10
  table too, and the flash, LayerNorm and Adam kernels at the
  Transformer's shapes (a decode step's single query row, the decoder's
  key mask with causal, width 512, the 30000 x 512 tables).

Then the Transformer and ERNIE 2.0 at bench.py's own settings:

- ``transformer_train``: Transformer-base NMT at bench.py:540-562 (f32,
  batch 64, 64 source and 64 target tokens, dropout 0.1, label smoothing
  0.1, Adam(1e-4)) six steps; losses finite and falling; per step 18
  flash forward and backward launches each, 30/30 LayerNorm and 255
  Adam; tokens/s over the replays, peak memory, the capture's time and
  pool growth, the step beside its f32 FFMA bound, an op-by-op step's
  device time by op type. ``graph_transformer``: that step at dropout
  0.1 op by op against graphed, bit for bit.
- ``transformer_serve``: beam-search decode at bench.py:684-725 (batch
  16, beam 4, 64 source and 32 output tokens, the K/V cache) through
  Executor.run (tokens/s as bench.py counts them, 378 flash forward and
  570 LayerNorm launches a request), greedy decode beside it, the cache
  against the re-decode at full width (ids equal but where a step chose
  within DECODE_GAP_ATOL, scores within DECODE_SCORE_RTOL), the beam
  program saved and served through create_predictor at batches 1, 3
  (bucket 4) and 16, op by op and graphed, and batch 3 against the same
  directory on the CPU.
- ``transformer_parity``: a 2 + 2-layer Transformer at base width,
  three Adam steps and a beam decode, card graphed against CPU.
- ``ernie2_train``: ERNIE 2.0 multi-task pretraining at bench.py:491-515
  (bf16, batch 128 x 128, dropout 0.1, dynamic task weights, Adam(1e-4)),
  each step fed ernie2_task_schedule's next weight, op by op against
  graphed (losses, a dropout Mask and every parameter and moment bit for
  bit; each loss the fed weights' mix of the task losses);
  samples/s. ``ernie2_parity``: 2 layers, card against CPU.

Then the recurrent sequence models at their published settings (no
hand-written kernel but fused Adam: the JAX package computes the GRU,
CRF and CTC recursions with ``lax.scan``, the port with loops of plain
torch ops, thousands of small kernels a step that the CUDA graph
replays):

- ``lac_train``: LAC's BiGRU-CRF (PaddleNLP lexical_analysis: 20940
  words, 57 tags, embedding and GRU width 128, two BiGRU layers, batch
  300 padded to 64 words, Adam(1e-3)) six steps: losses finite and
  falling, Viterbi paths in range and 0 past each length, 16 Adam
  launches a step; words/s, the first run's host time, an op-by-op
  step's device time and kernels by op type (basic_gru's unread
  last-state chain apart). ``graph_lac``: that step op by op against
  graphed, bit for bit. ``lac_serve``: its Viterbi decode saved and
  served through the Predictor at batches 1, 3 (bucket 4) and 64, op by
  op and graphed, batch 3 against the CPU. ``lac_parity``: narrow, card
  against CPU, paths equal.
- ``ocr_train``: CRNN-CTC (ocr_recognition: 95 classes, 1 x 48 x 512,
  GRU width 200, batch 32, Adam(1e-3); the image width is the 512-step
  time axis) six steps: losses finite and falling, 17 Adam launches a
  step; images/s, the host's greedy decode, the CTC recursion beside
  ``F.ctc_loss`` (a yardstick the port never calls), device time by op
  type. ``ocr_parity``: narrow, card against CPU.

Then the data path, training fed as Paddle 1.6 scripts feed it:

- ``dataset_deepfm``: DeepFM at bench.py:565-578 (nothing cut) fed 24
  batches of samples written to record files by the port's RecordWriter
  and read by the C++ data plane into an InMemoryDataset (four threads,
  a global shuffle): ``train_from_dataset`` step by step and with
  ``steps_per_dispatch=4`` (equal bit for bit from the same start),
  ``infer_from_dataset`` on the is_test program, ``DataLoader.
  from_generator`` with exe.run, and one pre-staged batch: examples/s
  of each, the plane's read, load and collate rates with no step, a
  pass's idle share; 11 fused-Adam launches a training step whatever
  the feed.
- ``bucketed_train``: bench.py's bucketed model at its on-chip settings
  (bench.py:745-760), MultiSlot text from the data generator through a
  QueueDataset with length buckets: run_pass's warm pass and best of
  two, bucketed and at max_len; the samples/s ratio, the graph keys of
  each pass and the share of its steps that replayed a graph.
- ``py_reader_bert``: train_bf16's BERT-base fed by a py_reader for two
  epochs (EOF, reset), against the same batches fed and one epoch op
  by op, bit for bit; step ms beside the fed step's.

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
AdamW, Lamb, Ftrl, Adadelta; AdamW and Lamb also in bf16; AdamW under
ExponentialMovingAverage, LookaheadOptimizer (k = 2) and ModelAverage
(a window of 2), their state held too) under the recipe's schedule
(FTRL at a constant rate) and clip and an L2Decay regularizer to the
same card-against-CPU comparison, and DP-SGD's clip and noise by their
statistics on the card. A profile phase splits one
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
import math
import os
import shutil
import statistics
import subprocess
import sys
import threading
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
# optimizer_parity's wrapper cases, each around AdamW at 1.6e-4 under the
# schedule: EMA (decay 0.9, so that three steps move the averages well
# past PARITY_PARAM_ATOL), Lookahead (k = 2: the sync runs at the second
# step), ModelAverage (a window of 2: the sums move to sum_3 at the
# second step). Their state (WRAPPER_STATE_MARKS in the name) is held to
# the parameters' comparison, counters exactly.
PARITY_EMA_DECAY = 0.9
PARITY_LOOKAHEAD_ALPHA, PARITY_LOOKAHEAD_K = 0.5, 2
PARITY_AVERAGE_RATE, PARITY_AVERAGE_WINDOW = 0.5, 2
WRAPPER_STATE_MARKS = (".ema_", ".slow_", ".sum_1_", ".sum_2_", ".sum_3_",
                       ".num_accumulates_", ".old_num_accumulates_",
                       ".num_updates_")
# Dpsgd draws Gaussian noise: on the card, its clip (sigma 0: a step of
# lr times the gradient clipped to norm DPSGD_CLIP) and its noise (a zero
# gradient: the step is lr times the noise) over DPSGD_N elements, whose
# mean and std must lie within 5 standard errors of 0 and sigma * clip.
DPSGD_N, DPSGD_CLIP, DPSGD_SIGMA, DPSGD_LR = 10 ** 6, 1.0, 1.5, 0.1
DECODE_BATCH, DECODE_PROMPT, DECODE_NEW = 4, 64, 16
PROFILE_PLAIN_RUNS = 3
# the profiler now and then records no device event for a run that
# launches kernels (once seen on an H100 for a 1.5 ms DeepFM replay,
# whose op-by-op run profiled just before recorded 195 kernels):
# _profiled profiles such a run again, up to PROFILE_ATTEMPTS runs in all
PROFILE_ATTEMPTS = 3
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
# train_state: train_recipe's cell with ExponentialMovingAverage(
# STATE_EMA_DECAY).update() on top, graphed, RECIPE_STEPS steps with
# checkpoints after STATE_SAVE_AT; the new-shape check sets STATE_SHAPE_VAR
# (the pooler's bias, (768,)) to shape (1,), which the eval program's add
# would broadcast
STATE_EMA_DECAY = 0.999
STATE_SAVE_AT = 3
STATE_SHAPE_VAR = "pooled_fc.b_0"
GRAPH_SERVE_REPS = 10
GRAPH_GPT_DROPOUT = 0.1
# resnet_train, graph_resnet, resnet_serve: ResNet-50 at bench.py:472-486
# with nothing cut (1000 classes, 3 x 224 x 224 f32, Momentum(0.1, 0.9),
# batch 128, one batch drawn as bench.py draws it), TRAIN_STEPS steps
# from one startup; served from the trained scope with is_test=True (its
# softmax) at batches 1 and 8. No hand-written kernel runs on these paths:
# convolution, pooling and batch norm have no Pallas kernel in the JAX
# package, and its blockwise-CE rule declines 1000 classes. The step's
# least time is its convolutions' and the head's products (counted from
# the program's shapes, three passes: forward, input and filter
# gradients) at the H100 SXM's 67 TFLOP/s of f32 FFMA: the path runs
# full f32 convolutions (set_precision: no TF32).
RESNET_BATCH, RESNET_CLASSES = 128, 1000
RESNET_SERVE_BATCHES = (1, 8, 1, 8)          # each size cold, then warm
# the served logits, card against CPU: f32 through 53 convolutions summed
# in other orders, max |diff| over max |logit|
RESNET_SERVE_LOGIT_RTOL = 1e-4
FP32_FFMA_FLOPS = 67e12
# resnet_parity: a narrow ResNet (the stem's conv_bn_layer with 8 filters,
# the max pool, two bottleneck_blocks of 8 filters, the second with
# stride 2; RESNET_PARITY_SHAPE images, batch RESNET_PARITY_BATCH,
# Momentum(0.1, 0.9)) PARITY_STEPS steps on the card, graphed, and on the
# CPU from the same weights. f32 through five convolutions and batch
# norms a step, summed in other orders on the two devices: losses rtol
# 1e-5; every persistable (parameters, velocities, moving statistics)
# rtol 1e-4, atol 1e-5, as tests/test_torch_resnet.py holds the port to
# the JAX package (batch norm divides by a batch standard deviation, so
# a last-bit difference in a small variance grows there).
RESNET_PARITY_SHAPE, RESNET_PARITY_BATCH = (3, 16, 16), 4
RESNET_PARITY_RTOL, RESNET_PARITY_ATOL, PARITY_FETCH_RTOL = 1e-4, 1e-5, 1e-5
# deepfm_train: bench.py:565-578 with nothing cut (feature_dim 1,000,000,
# embedding 10, batch 2048, Adam(1e-3)), TRAIN_STEPS steps on one
# synthetic_batch(seed=0); one fused-Adam launch per parameter a step
# (the two tables, the dense weight, four fc layers' weights and biases).
# deepfm_parity: feature_dim 5000, embedding 8, batch 8, PARITY_STEPS
# steps card (graphed) against CPU: loss and predictions rtol 1e-5, AUC
# rtol 1e-6 (integer histograms, float64 sums), parameters and moments
# rtol 1e-4, atol 1e-6 (Adam divides by sqrt(m2) + eps), histograms equal.
DEEPFM_FEATURES, DEEPFM_BATCH, DEEPFM_EMBEDDING = 1000000, 2048, 10
DEEPFM_PER_STEP = {"fused_adam": 11}
DEEPFM_PARITY = dict(feature_dim=5000, embedding_size=8)
DEEPFM_PARITY_BATCH = 8
DEEPFM_PARITY_RTOL, DEEPFM_PARITY_ATOL, AUC_RTOL = 1e-4, 1e-6, 1e-6
# transformer_train, graph_transformer: Transformer-base NMT at
# bench.py:540-562 with nothing cut (d_model 512, d_inner 2048, 6 + 6
# layers, 8 heads, vocabularies of 30000, dropout 0.1, label smoothing
# 0.1, f32, batch 64 with 64 source and 64 target tokens, Adam(1e-4)),
# TRAIN_STEPS steps on one synthetic_batch(seed=0). A step: one attention
# per encoder layer and two per decoder layer (the decoder's own with its
# key mask and causal together), forward and backward; two LayerNorms
# per encoder layer and three per decoder layer; one Adam update per
# parameter. The soft-label cross-entropy is plain in both packages (the
# JAX package's blockwise kernel takes hard labels only).
TRANSFORMER_BATCH, TRANSFORMER_LEN = 64, 64
TRANSFORMER_PER_STEP = dict({"flash_attention_fwd": 18,
                             "flash_attention_bwd_dkv": 18,
                             "flash_attention_bwd_dq": 18,
                             "layer_norm_fwd": 30, "layer_norm_bwd": 30,
                             "fused_adam": 255},
                            **{k: 0 for k in NEW_KERNELS})
# transformer_serve: beam-search decode at bench.py:684-725 (batch 16, 64
# source tokens, 32 output tokens, beam 4, the K/V cache), BEAM_RUNS
# replays timed through Executor.run (bench.py runs 6), greedy decode
# beside it at the same widths; the beam program served through the
# Predictor at BEAM_SERVE_BATCHES (buckets 1, 4 and 16; each cold, then
# warm) and BEAM_SERVE_REPS requests a bucket each way. A request runs
# the encoder (6 attentions, 12 LayerNorms) and 31 cached steps, each 6
# self-attentions over the cache (one query row, Tk = 1 ... 31), 6 cross
# attentions (one query row, the 64 source keys and their mask) and 18
# LayerNorms. Decodes that should agree (cached against re-decoded,
# card against CPU) must give equal ids, except where a step chose
# between candidates within DECODE_GAP_ATOL of each other (f32 sums in
# another order move a score by ~1e-6 of its ~10-50), and scores within
# DECODE_SCORE_RTOL.
BEAM_BATCH, BEAM_SRC, BEAM_OUT, BEAM_SIZE, BEAM_RUNS = 16, 64, 32, 4, 6
DECODE_PER_REQUEST = dict({k: 0 for k in TRANSFORMER_PER_STEP},
                          flash_attention_fwd=6 + 31 * 12,
                          layer_norm_fwd=12 + 31 * 18)
BEAM_BUCKETS = (1, 4, 16)
BEAM_SERVE_BATCHES = (1, 3, 16, 1, 3, 16)
BEAM_SERVE_REPS = 3
DECODE_GAP_ATOL, DECODE_SCORE_RTOL = 1e-4, 1e-4
# transformer_parity: 2 + 2 layers at base width, batch PARITY_BATCH x
# TRANSFORMER_PARITY_LEN tokens, three Adam(PARITY_LR) steps, card
# against CPU by PARITY_*; then a cached beam decode of (batch, source,
# output tokens, beam) TRANSFORMER_PARITY_BEAM from seeded weights
TRANSFORMER_PARITY_LEN = 32
TRANSFORMER_PARITY_BEAM = (2, 16, 8, 4)
# ernie2_train: ERNIE 2.0 multi-task pretraining at bench.py:491-515 with
# nothing cut (bf16 ERNIE-base, batch 128 x 128, 20 masked positions,
# dropout 0.1, dynamic task weights, Adam(1e-4)); a step launches the
# BERT bf16 step's flash and LayerNorm kernels and one Adam update per
# parameter (BERT's, minus the NSP head's two, plus the task embedding
# and the reorder and IR heads' four). Its MLM head does not tile
# (vocab 30522) and its heads' CE is plain, as in the JAX package.
# ernie2_parity: 2 layers, PARITY_BATCH, three steps, card against CPU.
ERNIE2_FETCHES = ("loss", "mlm_loss", "reorder_loss", "ir_loss")
ERNIE2_PER_STEP = dict(TRAIN_PER_STEP, fused_adam=209)
# lac_train, graph_lac, lac_serve: BiGRU-CRF lexical analysis at LAC's
# published settings (PaddlePaddle/models, PaddleNLP/lexical_analysis,
# conf/args.yaml: word_emb_dim 128, grnn_hidden_dim 128, bigru_num 2, 57
# tags, Adam at 1e-3, batch 300; its word dictionary of 20940 entries),
# sentences padded to 64 words, f32, one synthetic_tagging_batch(seed=0)
# (lengths 32-64). A step: 2 layers x 2 directions x 64 GRU time steps,
# the CRF's forward recursion and the Viterbi decode over 63 steps each,
# basic_gru's unread last-state chain (the Executor runs it) and one
# fused-Adam launch per parameter (the embedding, four GRU input
# projections, four GRU weights and biases, the emission fc's weight and
# bias, crfw). Served: the decode saved with save_inference_model and
# served through create_predictor at LAC_SERVE_BATCHES (buckets 1, 4 and
# 64; each cold, then warm), LAC_SERVE_REPS requests a bucket each way.
LAC = dict(vocab_size=20940, num_labels=57, emb_dim=128, hidden=128,
           num_layers=2, seq_len=64)
LAC_BATCH, LAC_LR = 300, 1e-3
LAC_PER_STEP = {"fused_adam": 16}
LAC_BUCKETS = (1, 4, 64)
LAC_SERVE_BATCHES = (1, 3, 64, 1, 3, 64)
LAC_SERVE_REPS = 5
# lac_parity: LAC's tags and depth at narrow widths, PARITY_STEPS
# Adam(LAC_LR) steps on one batch of LAC_PARITY_BATCH, the card graphed
# against the CPU: losses rtol 1e-5, Viterbi paths equal, every
# persistable rtol 1e-4, atol 1e-5 (f32 through 16 GRU steps a direction
# and the CRF, summed in other orders; tests/test_torch_sequence_models.py
# holds the port to the JAX package at rtol 1e-5)
LAC_PARITY = dict(vocab_size=1000, num_labels=57, emb_dim=32, hidden=32,
                  num_layers=2, seq_len=16)
LAC_PARITY_BATCH = 8
LAC_PARITY_RTOL, LAC_PARITY_ATOL = 1e-4, 1e-5
# ocr_train: CRNN-CTC at ocr_recognition's published settings
# (PaddlePaddle/models, PaddleCV/ocr_recognition: 95 classes, 1 x 48 x 512
# images, RNN hidden size 200, batch 32), f32, Adam(1e-3), one
# synthetic_ocr_batch(seed=0). The JAX package's program pools the height
# only, so the image width is the time axis: T = 512 (the published model
# pools the width as well). max_label 32 is this port's choice. A step: 3
# convolutions with batch norm, 2 directions x 512 GRU time steps, the CTC
# recursion over 511 steps on up to 2 x 15 + 1 extended labels (its
# padded width S = 65), one fused-Adam launch per parameter (3 filters,
# 3 batch-norm scales and shifts, 2 GRU input projections, 2 GRU weights
# and biases, the logits fc's weight and bias).
OCR = dict(num_classes=95, image_shape=(1, 48, 512), hidden=200,
           max_label=32)
OCR_BATCH, OCR_LR = 32, 1e-3
OCR_PER_STEP = {"fused_adam": 17}
# ocr_parity: 95 classes at narrow widths, PARITY_STEPS Adam(PARITY_LR)
# steps on one batch, the card graphed against the CPU: losses rtol
# 1e-5; every float persistable rtol 1e-4, atol 3e-5, as
# tests/test_torch_sequence_models.py holds the port to the JAX package.
# At OCR_LR the batch norms of 4 images carry an element that Adam
# stepped the other way (its gradient at the noise level) into every
# gradient: some 0.1% of the elements part by more (measured on an
# H100).
OCR_PARITY = dict(num_classes=95, image_shape=(1, 16, 48), hidden=32,
                  max_label=8)
OCR_PARITY_BATCH = 4
OCR_PARITY_RTOL, OCR_PARITY_ATOL = 1e-4, 3e-5
# The data path (dataset, py_reader, DataLoader feeding training).
# dataset_deepfm: DeepFM at deepfm_train's settings (bench.py:565-578,
# nothing cut), DATASET_BATCHES synthetic_batch batches (seeds 0..23)
# written a sample a record over DATASET_FILES record files, read into
# an InMemoryDataset on DATASET_THREADS threads and shuffled; a warm
# train_from_dataset pass, a timed one, a windowed one
# (DATASET_WINDOW steps a run_steps window) from the same start (equal
# bit for bit: both replay one graph), infer_from_dataset on the is_test
# program, DataLoader.from_generator with exe.run, and the first batch
# fed DATASET_BATCHES times (deepfm_train's pre-staged way); 11 fused-Adam
# launches a training step whatever the feed.
DATASET_BATCHES, DATASET_FILES, DATASET_THREADS, DATASET_WINDOW = 24, 4, \
    4, 4
# bucketed_train: bench.py's bench_bucketed_training at its on-chip
# settings (bench.py:745-760: vocab 8192, hidden 512, 4 GELU layers,
# max_len 256, batch 128, 24 batches, buckets (32, 64, 128, 256), Adam
# 1e-3, lengths geometric(1 / (max_len // 8)) clipped to [4, max_len],
# seed 0), written as MultiSlot text by the data generator and read by
# a QueueDataset (the C++ ms_parse_file); run_pass's warm pass and best
# of BUCKETED_TIMED, bucketed and at (max_len,). One Adam launch per
# parameter (the embedding, five fc weights and biases) a step.
BUCKETED = dict(vocab=8192, hidden=512, n_layers=4, max_len=256,
                batch=128, n_batches=24, buckets=(32, 64, 128, 256))
BUCKETED_TIMED = 2
BUCKETED_PER_STEP = {"fused_adam": 11}
# py_reader_bert: train_bf16's model and batch (BERT-base bf16, batch 128
# x 128) fed by create_py_reader_by_data over the program's own feeds,
# PY_READER_BATCHES synthetic batches an epoch (a warm run, a capture and
# PY_READER_BATCHES - 2 replays), two epochs; against the same batches
# fed (graphed) and one epoch op by op: every fetch bit for bit, and
# train_bf16's launches a step.
PY_READER_BATCHES, PY_READER_CAPACITY = 3 + 3, 4
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
# wall seconds of each phase (summed over its calls), for the run's
# time budget
_seconds = {}


def emit(obj):
    line = json.dumps(obj)
    print(line, flush=True)
    with open(_LOG, "a") as f:
        f.write(line + "\n")


def phase(name):
    """Run the decorated function as phase ``name``; a raise marks the
    run failed and prints the error as the phase's line. Its wall time
    adds to ``_seconds[name]``."""
    def deco(fn):
        def run(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            except Exception as e:  # report, and keep the other phases
                _failed.append(name)
                emit({"phase": name, "ok": False,
                      "error": "%s: %s" % (type(e).__name__, e)})
                return None
            finally:
                _seconds[name] = _seconds.get(name, 0.0) + \
                    time.perf_counter() - t0
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
        # the Transformer (bench.py:540, 684): a decode step's single query
        # row against the cross-attention keys with the source mask, and
        # against the self-attention cache at its shortest and longest
        # (Tk = 1 and 31, no mask); its training step's decoder
        # self-attention, key mask and causal together
        ("transformer_decode_cross_k_mask_f32", 64, 8, 1, 64, 64, f32, "k",
         False),
        ("transformer_decode_self_tk1_f32", 64, 8, 1, 1, 64, f32, None,
         False),
        ("transformer_decode_self_tk31_f32", 64, 8, 1, 31, 64, f32, None,
         False),
        ("transformer_train_k_mask_causal_f32", 64, 8, 64, 64, 64, f32, "k",
         True),
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
        if not causal or tq == tk:
            lib_mask, lib_causal = _sdpa_mask(torch, fa, mask, causal, tq,
                                              tk, dtype)
            library_ms = clock(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=lib_mask, is_causal=lib_causal,
                scale=scale))
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
            ("one_row_f32", 1, 768, f32, False),
            # the Transformer's width 512: its training step (64 x 64
            # tokens) and a beam decode step (16 x 4 beams, one token)
            ("transformer_train_f32", 4096, 512, f32, True),
            ("transformer_decode_f32", 64, 512, f32, False)]


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


def _sdpa_mask(torch, fa, mask, causal, tq, tk, dtype):
    """(attn_mask, is_causal) for SDPA to compute the kernel's function:
    a key mask with ``causal`` becomes one additive mask with the causal
    fill in it (SDPA takes one or the other)."""
    if mask is None or not causal:
        return (None if mask is None else mask.to(dtype)), causal
    keep = fa._causal_keep(tq, tk, mask.device)
    return (mask.float() + torch.where(keep, 0.0, fa.NEG_INF)).to(dtype), \
        False


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
        # the Transformer's training step: the encoder's and cross
        # attention's key mask, and the decoder's key mask with causal
        ("transformer_train_k_mask_f32", 64, 8, 64, 64, 64, f32, "k", False),
        ("transformer_train_k_mask_causal_f32", 64, 8, 64, 64, 64, f32, "k",
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
        if not causal or tq == tk:
            lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))
            lib_mask, lib_causal = _sdpa_mask(torch, fa, mask, causal, tq,
                                              tk, dtype)
            lib_out = F.scaled_dot_product_attention(
                lq, lk, lv, attn_mask=lib_mask, is_causal=lib_causal,
                scale=scale)
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
              ADAMW_VISIBLE_COEFF),
             # DeepFM's largest table (bench.py:565-578: 1,000,000 x 10,
             # initialised N(0, (1 / sqrt(1e6))^2) truncated)
             ("deepfm_embedding", DEEPFM_FEATURES * DEEPFM_EMBEDDING, f32,
              0.0, DEEPFM_FEATURES ** -0.5, f32, 0.0),
             # the Transformer's embeddings and output projection (30000 x
             # 512, initialised N(0, 512^-1) and Xavier)
             ("transformer_embedding", 30000 * 512, f32, 0.0, 512 ** -0.5,
              f32, 0.0),
             # LAC's word embedding (20940 x 128) and CRF table (59 x 57),
             # Xavier-uniform spreads, and CRNN-CTC's largest convolution
             # filter (128 x 64 x 3 x 3) and its GRU input projection
             # (768 x 600)
             ("lac_embedding", LAC["vocab_size"] * LAC["emb_dim"], f32,
              0.0, 0.017, f32, 0.0),
             ("lac_crf_transition", (LAC["num_labels"] + 2) *
              LAC["num_labels"], f32, 0.0, 0.23, f32, 0.0),
             ("ocr_conv_filter", 128 * 64 * 3 * 3, f32, 0.0, 0.03, f32,
              0.0),
             ("ocr_gru_projection", 768 * 600, f32, 0.0, 0.06, f32, 0.0)]
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
                      scheduled=True, wrap=None):
    """optimizer_fn: ``make(optimizer module, rate)`` under the recipe's
    schedule (else at the constant ``base``) and global-norm clip; the
    rate and the global norm land in ``fetch``. ``wrap(optimizer module,
    inner optimizer, loss)`` minimizes through a wrapper (EMA, Lookahead,
    ModelAverage) and returns it, kept in ``fetch["wrapper"]``."""
    def fn(loss):
        lr = _recipe_schedule(ptt, base) if scheduled else base
        opt = make(ptt.optimizer, lr)
        opt.regularization = regularization
        clip = ptt.clip.GradientClipByGlobalNorm(RECIPE_CLIP)
        if wrap is None:
            out = opt.minimize(loss, grad_clip=clip)
        else:
            opt._grad_clip = clip            # a wrapper calls minimize(loss)
            wrapper = out = wrap(ptt.optimizer, opt, loss)
        if fetch is not None:
            fetch["lr"] = lr
            fetch["global_norm"] = _global_norm_var(loss.block.program)
            if wrap is not None:
                fetch["wrapper"] = wrapper
        return out
    return fn


def _wrap_ema(o, opt, loss, decay=None):
    opt.minimize(loss)
    ema = o.ExponentialMovingAverage(decay or PARITY_EMA_DECAY)
    ema.update()
    return ema


def _wrap_lookahead(o, opt, loss):
    lookahead = o.LookaheadOptimizer(opt, alpha=PARITY_LOOKAHEAD_ALPHA,
                                     k=PARITY_LOOKAHEAD_K)
    lookahead.minimize(loss)
    return lookahead


def _wrap_model_average(o, opt, loss):
    opt.minimize(loss)
    return o.ModelAverage(PARITY_AVERAGE_RATE,
                          min_average_window=PARITY_AVERAGE_WINDOW,
                          max_average_window=PARITY_AVERAGE_WINDOW)


def _wrapper_state(main):
    """The persistables a wrapper added: EMA accumulators, Lookahead's
    slow weights and step counter, ModelAverage's sums and counters."""
    return sorted(v.name for v in main.list_vars() if v.persistable and (
        v.name == "@LOOKAHEAD_STEP@" or any(
            m in v.name for m in WRAPPER_STATE_MARKS)))


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


def _fetch_steps(torch, ptt, counters, exe, main, scope, feed, fetch_list,
                 n):
    """``n`` runs of ``main`` on the card, the launch counters set to 0
    just before: (step ms, each run's fetches as numpy arrays, launches
    per step, launches)."""
    counters.zero()                          # the main path starts here
    step_ms, fetched, per_step = [], [], []
    with ptt.scope_guard(scope):
        for _ in range(n):
            before = counters.read()
            t1 = time.perf_counter()
            fetched.append(exe.run(main, feed=feed, fetch_list=fetch_list))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            after = counters.read()
            per_step.append({k: after[k] - before[k] for k in after})
    return step_ms, fetched, per_step, counters.read()


def _steps(torch, np, ptt, counters, exe, main, scope, feed, fetch_list,
           n):
    """_fetch_steps with every fetch a scalar: (step ms, losses, launches
    per step, launches)."""
    step_ms, fetched, per_step, launches = _fetch_steps(
        torch, ptt, counters, exe, main, scope, feed, fetch_list, n)
    return step_ms, [[float(np.asarray(o).reshape(())) for o in out]
                     for out in fetched], per_step, launches


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
    comparison's numbers, whether it passed). ``feed``: one feed, or a
    list of PARITY_STEPS feeds, one a run. A wrapper's state
    (``_wrapper_state``) is held as the parameters are, its integer
    counters exactly."""
    feeds = feed if isinstance(feed, list) else [feed] * PARITY_STEPS
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
                main, feed=step_feed, fetch_list=fetch_list,
                use_program_cache=cache)[0]).reshape(()))
                for step_feed in feeds]
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
    block = main.global_block()
    wrapper = [block.var(n) for n in _wrapper_state(main)]
    counters = [v.name for v in wrapper if v.dtype.startswith("int")]
    counters_equal = all(np.array_equal(to_numpy(gs.find_var(n)),
                                        to_numpy(cs.find_var(n)))
                         for n in counters)
    for p in main.all_parameters() + [v for v in wrapper
                                      if v.name not in counters]:
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
          and moved >= 10 * PARITY_PARAM_ATOL and graphed_equal
          and counters_equal)
    return {"steps": PARITY_STEPS, "dropout": 0.0, "dtype": dtype,
            "wrapper_state": len(wrapper), "wrapper_counters": counters[:4],
            "wrapper_counters_equal": counters_equal,
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
    for every optimizer, bf16 for AdamW and LAMB; then AdamW (f32) under
    EMA, Lookahead and ModelAverage, their state held too. Then DP-SGD's
    clip and noise on the card (``_dpsgd_on_card``)."""
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
    cfg = bert.bert_base(num_layers=PARITY_LAYERS, hidden_dropout=0.0,
                         attn_dropout=0.0)
    feed = bert.synthetic_batch(cfg, PARITY_BATCH, TRAIN_SEQ, TRAIN_PREDS,
                                seed=1)
    adamw = dict((c[0], c) for c in PARITY_OPTIMIZERS)["AdamW"]
    for name, wrap in (
            ("ExponentialMovingAverage(AdamW)", _wrap_ema),
            ("LookaheadOptimizer(AdamW, k=2)", _wrap_lookahead),
            ("ModelAverage(AdamW, window 2)", _wrap_model_average)):
        main, startup, fetch_list = _pretrain_program(
            ptt, bert, cfg, PARITY_BATCH, _recipe_optimizer(
                ptt, adamw[3], adamw[1],
                regularization=ptt.regularizer.L2Decay(PARITY_L2),
                wrap=wrap))
        result, case_ok = _card_vs_cpu(np, ptt, main, startup, fetch_list,
                                       feed)
        case_ok = case_ok and result["wrapper_state"] > 0
        ok = ok and case_ok
        results.append(dict({"optimizer": name, "base_lr": adamw[1],
                             "scheduled": True, "ok": case_ok}, **result))
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
               fetch_list, want, families, mask=True):
    """GRAPH_STEPS runs of ``main`` op by op and graphed, each way on its
    own copy of one started scope (the run counter included), then one
    run each way profiled: (the record, ok, the graphed way's fetches and
    state after GRAPH_STEPS runs, the started scope). ``feed``: one feed
    for every run, or a list of GRAPH_STEPS feeds, one a run (a replay
    reads each from its static feeds). With ``mask`` the last fetch is a
    dropout Mask, which must differ from step to step."""
    feeds = feed if isinstance(feed, list) else [feed] * GRAPH_STEPS
    feed = feeds[-1]
    start = ptt.Scope()
    ptt.Executor().run(startup, scope=start)    # no fetch list: no graph
    persist = [v.name for v in main.list_vars() if v.persistable]
    ways = {}
    for way, cache in (("op_by_op", False), ("graphed", True)):
        scope, exe = _copy_scope(torch, ptt, start), ptt.Executor()
        step_ms, fetched, per_step = [], [], []
        counters.zero()                      # the main path starts here
        for step_feed in feeds:
            before = counters.read()
            t0 = time.perf_counter()
            fetched.append(exe.run(main, feed=step_feed,
                                   fetch_list=fetch_list, scope=scope,
                                   use_program_cache=cache,
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
    masks = [f[-1] for f in b["fetched"]] if mask else []
    masks_differ = all(not torch.equal(x, y)
                       for x, y in zip(masks, masks[1:]))
    counts_ok = all(c == want for c in a["per_step"] + b["per_step"])
    kept = len(fetch_list) - 1 if mask else len(fetch_list)
    reference = ([[t.clone() for t in f[:kept]] for f in b["fetched"]],
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


def train_state(torch, np, ptt, counters):
    """The BERT recipe cell with ExponentialMovingAverage on top, graphed:
    RECIPE_STEPS steps with checkpoints after STATE_SAVE_AT of them (an
    uncompressed one, then a zlib one committed on a thread while the
    next steps replay), resumed from one in a fresh Executor and scope
    and from the other in the live Executor, each giving the last steps'
    fetches (losses, rate, global norm, a dropout Mask) and every
    persistable bit for bit; the eval program run under ``ema.apply()``
    (captured there, then replayed after ``restore``); a persistable set
    to a new shape and back; EMA's device time a step."""
    from paddle_tpu_torch import io as pio
    root = os.path.join(_ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    try:
        return _train_state(torch, np, ptt, counters, pio, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _state_program(ptt, bert, cfg, ema):
    """The recipe program (train_recipe's), with ``ema`` its EMA on top:
    (main, startup, fetch list ending in a dropout Mask, the EMA)."""
    fetch = {}
    main, startup, fetch_list = _pretrain_program(
        ptt, bert, cfg, BF16_TRAIN_BATCH, _recipe_optimizer(
            ptt, lambda o, lr: o.AdamW(lr, weight_decay=RECIPE_WEIGHT_DECAY),
            RECIPE_LR, fetch=fetch, wrap=(
                lambda o, opt, loss: _wrap_ema(o, opt, loss,
                                               STATE_EMA_DECAY))
            if ema else None))
    return main, startup, fetch_list + [
        fetch["lr"], fetch["global_norm"], _dropout_mask(main)], \
        fetch.get("wrapper")


def _train_state(torch, np, ptt, counters, pio, root):
    from paddle_tpu_torch.models import bert
    cfg = bert.bert_base(dtype="bfloat16")
    main, startup, fetch_list, ema = _state_program(ptt, bert, cfg, True)
    feed = bert.synthetic_batch(cfg, BF16_TRAIN_BATCH, TRAIN_SEQ,
                                TRAIN_PREDS, seed=0)
    persist = [v.name for v in main.list_vars() if v.persistable]
    params = [p.name for p in main.all_parameters()]
    pairs = sorted((p, v.name) for p, v in ema._ema_vars.items())
    dirs = {"none": os.path.join(root, "none"),
            "zlib": os.path.join(root, "zlib")}

    def run(exe, scope, n, prog=main, fetches=fetch_list, record=None,
            cache=True):
        out = []
        for _ in range(n):
            before = counters.read()
            t0 = time.perf_counter()
            out.append(exe.run(prog, feed=feed, fetch_list=fetches,
                               scope=scope, return_numpy=False,
                               use_program_cache=cache))
            torch.cuda.synchronize()
            if record is not None:
                after = counters.read()
                record.append(({k: after[k] - before[k] for k in after},
                               (time.perf_counter() - t0) * 1e3))
        return out

    def same(a, b):
        return len(a) == len(b) and all(
            torch.equal(x, y) for fa, fb in zip(a, b) for x, y in zip(fa, fb))

    def unequal(scope, ref, names=persist):
        return [n for n in names if not torch.equal(scope.find_var(n),
                                                    ref[n])]

    def snapshot(scope, names=persist):
        return {n: scope.find_var(n).clone() for n in names}

    # the slice's main path: six graphed recipe steps with EMA, the
    # checkpoints written after the third, the zlib one committed on its
    # thread while the rest of the phase runs
    scope, exe = ptt.Scope(), ptt.Executor()     # CUDAPlace(0)
    exe.run(startup, scope=scope)
    per_step = []
    counters.zero()                          # the main path starts here
    first = run(exe, scope, STATE_SAVE_AT, record=per_step)
    at_save = scope.find_var("@EAGER_SALT@")
    timing = {}
    t0 = time.perf_counter()
    pio.save_checkpoint(exe, dirs["none"], main, step=STATE_SAVE_AT,
                        scope=scope)
    timing["save_none_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    handle = pio.save_checkpoint(exe, dirs["zlib"], main,
                                 step=STATE_SAVE_AT, scope=scope,
                                 compress="zlib", blocking=False)
    timing["save_zlib_return_s"] = time.perf_counter() - t0
    committed = {}

    def watch():                             # the commit's own time
        try:
            handle.result()
        except BaseException as e:           # raised again below
            committed["error"] = repr(e)
        committed["s"] = time.perf_counter() - t0
    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    rest = run(exe, scope, RECIPE_STEPS - STATE_SAVE_AT, record=per_step)
    launches = counters.read()               # ... and ends here
    reference = snapshot(scope)
    salt = scope.find_var("@EAGER_SALT@")
    counts_ok = all(c == TRAIN_PER_STEP for c, _ in per_step)
    losses = [float(f[0].reshape(())) for f in first + rest]
    captures_a = len(exe.capture_log)

    # the eval program (is_test, the same parameters) under ema.apply():
    # captured there, replayed after
    with ptt.unique_name.guard():
        eval_prog, _, _, eval_fetch = bert.bert_pretrain_program(
            cfg, BF16_TRAIN_BATCH, TRAIN_SEQ, TRAIN_PREDS, is_test=True)
    loss = [eval_fetch["loss"]]
    trained = snapshot(scope, params)
    averages = snapshot(scope, [e for _, e in pairs])
    captures = len(exe.capture_log)
    with ptt.scope_guard(scope):
        with ema.apply(exe):
            applied = all(torch.equal(scope.find_var(p), averages[e])
                          for p, e in pairs)
            under = run(exe, scope, 2, eval_prog, loss)
    eval_captured = len(exe.capture_log) - captures
    restored = {"params": unequal(scope, trained, params)[:8],
                "ema": unequal(scope, averages, list(averages))[:8]}
    after = run(exe, scope, 1, eval_prog, loss)
    after_op = run(exe, scope, 1, eval_prog, loss, cache=False)
    after_kept = not unequal(scope, trained, params) and \
        not unequal(scope, averages, list(averages))
    # one more training replay against an op-by-op run of a copy
    copy = _copy_scope(torch, ptt, scope)
    op_by_op = run(exe, copy, 1, cache=False)
    replayed = run(exe, scope, 1)
    train_after = same(op_by_op, replayed) and not unequal(
        scope, snapshot(copy))
    del copy, trained, averages
    apply_record = {
        "params_hold_averages_under_apply": applied,
        "eval_captured_under_apply": eval_captured,
        "eval_losses_under_apply": [float(f[0].reshape(())) for f in under],
        "eval_loss_after_restore": float(after[0][0].reshape(())),
        "unequal_after_restore": restored,
        "replay_after_restore_equals_op_by_op": same(after, after_op),
        "replay_after_restore_keeps_params_and_ema": after_kept,
        "training_replay_equals_op_by_op": train_after}
    apply_ok = applied and eval_captured == 1 and same(under[:1], under[1:]) \
        and not restored["params"] and not restored["ema"] and \
        same(after, after_op) and after_kept and train_after and \
        not same(under[:1], after)

    # a persistable set to a new shape: a new key, never the old graph
    captures = len(exe.capture_log)
    old_eval = run(exe, scope, 1, eval_prog, loss)
    old = scope.find_var(STATE_SHAPE_VAR)
    scope.set_var(STATE_SHAPE_VAR, torch.zeros(1, dtype=old.dtype,
                                               device=old.device))
    op_error = None
    try:
        reshaped = run(exe, scope, 2, eval_prog, loss)
    except Exception as e:                   # the op's own shape error
        op_error = "%s: %s" % (type(e).__name__, str(e)[:200])
        reshaped = []
    new_key = len(exe.capture_log) == captures + 1
    scope.set_var(STATE_SHAPE_VAR, old)
    back = run(exe, scope, 1, eval_prog, loss)
    old_replays = same(back, old_eval) and \
        len(exe.capture_log) == captures + int(new_key)
    shape_record = {"var": STATE_SHAPE_VAR, "shape": list(old.shape),
                    "new_shape": [1], "new_key_captured": new_key,
                    "op_error": op_error,
                    "new_shape_losses": [float(f[0].reshape(()))
                                         for f in reshaped],
                    "old_key_replays_after": old_replays}
    shape_ok = (new_key or op_error is not None) and old_replays

    # EMA's device time a step: this step and the recipe step without
    # EMA, each profiled as a replay
    with_ema = _profiled(torch, lambda: exe.run(
        main, feed=feed, fetch_list=fetch_list, scope=scope))
    main0, startup0, fetch0, _ = _state_program(ptt, bert, cfg, False)
    scope0, exe0 = ptt.Scope(), ptt.Executor()
    exe0.run(startup0, scope=scope0)
    for _ in range(2):
        exe0.run(main0, feed=feed, fetch_list=fetch0, scope=scope0)
    without = _profiled(torch, lambda: exe0.run(
        main0, feed=feed, fetch_list=fetch0, scope=scope0))
    close_executor(torch, "train_state without EMA", exe0)
    del scope0
    busy = [f["device_busy_ms"] for f in (with_ema, without)]
    ema_cost = {
        "device_busy_ms": {"with_ema": busy[0], "without": busy[1]},
        "ema_device_ms": busy[0] - busy[1]
        if "not measured" not in busy else "not measured",
        "step_ms_unprofiled": {"with_ema": with_ema["unprofiled_ms"],
                               "without": without["unprofiled_ms"]},
        "ema_ops": 3 * len(pairs),
        "ema_elements": sum(int(np.prod(main.global_block().var(p).shape))
                            for p, _ in pairs)}

    # resumed in a fresh Executor and scope, from the zlib checkpoint
    watcher.join()
    handle.result()
    timing["save_zlib_commit_s"] = committed["s"]
    sizes = {c: dict(zip(("raw_bytes", "wire_bytes"),
                         pio.checkpoint_dir_bytes(d, STATE_SAVE_AT)))
             for c, d in dirs.items()}
    fresh_scope, fresh_exe = ptt.Scope(), ptt.Executor()
    t0 = time.perf_counter()
    step = pio.load_checkpoint(fresh_exe, dirs["zlib"], main,
                               scope=fresh_scope)
    torch.cuda.synchronize()
    timing["load_zlib_s"] = time.perf_counter() - t0
    fresh_salt = fresh_scope.find_var("@EAGER_SALT@")
    fresh = run(fresh_exe, fresh_scope, RECIPE_STEPS - STATE_SAVE_AT)
    fresh_record = {
        "step": step, "salt_restored_as_int": type(fresh_salt) is int,
        "salt": [fresh_salt, at_save], "fetches_equal": same(fresh, rest),
        "unequal_state": unequal(fresh_scope, reference)[:8],
        "captures": len(fresh_exe.capture_log)}
    fresh_ok = step == STATE_SAVE_AT and fresh_salt == at_save and \
        type(fresh_salt) is int and fresh_record["fetches_equal"] and \
        not fresh_record["unequal_state"] and \
        fresh_scope.find_var("@EAGER_SALT@") == salt and \
        fresh_record["captures"] == 1
    close_executor(torch, "train_state fresh", fresh_exe)
    del fresh_scope, fresh

    # resumed in the live Executor, from the uncompressed checkpoint: the
    # replays copy the loaded tensors into their static inputs
    captures = len(exe.capture_log)
    t0 = time.perf_counter()
    pio.load_checkpoint(exe, dirs["none"], main, scope=scope)
    torch.cuda.synchronize()
    timing["load_none_s"] = time.perf_counter() - t0
    live = run(exe, scope, RECIPE_STEPS - STATE_SAVE_AT)
    live_record = {"fetches_equal": same(live, rest),
                   "unequal_state": unequal(scope, reference)[:8],
                   "new_captures": len(exe.capture_log) - captures}
    live_ok = live_record["fetches_equal"] and \
        not live_record["unequal_state"] and \
        live_record["new_captures"] == 0
    close_executor(torch, "train_state", exe)
    del live, scope, reference

    ok = counts_ok and all(np.isfinite(losses)) and captures_a == 1 and \
        fresh_ok and live_ok and apply_ok and shape_ok
    emit({"phase": "train_state", "ok": ok, "model": "bert_base",
          "dtype": cfg.dtype, "batch": BF16_TRAIN_BATCH,
          "seq_len": TRAIN_SEQ, "dropout": cfg.hidden_dropout,
          "optimizer": "AdamW(schedule, weight_decay=0.01, "
          "GradientClipByGlobalNorm(1.0)) + ExponentialMovingAverage(%g)"
          % STATE_EMA_DECAY, "steps": RECIPE_STEPS,
          "checkpoint_after": STATE_SAVE_AT, "losses": losses,
          "step_ms": [ms for _, ms in per_step],
          "launches_per_step": per_step[-1][0],
          "launches_per_step_ok": counts_ok,
          "persistables": len(persist), "checkpoint_bytes": sizes,
          "seconds": timing, "resume_fresh": fresh_record,
          "resume_live": live_record, "ema_apply_restore": apply_record,
          "new_shape": shape_record, "ema_cost": ema_cost})
    if not ok:
        raise AssertionError("train_state checks failed (see the line "
                             "above)")
    return launches


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


def _no_launches(counters, **launched):
    """Every kernel's launch count 0, but ``launched``."""
    return dict({k: 0 for k in counters.read()}, **launched)


def _resnet_program(np, ptt, resnet, batch):
    """bench.py:472-486: ResNet-50 training with Momentum(0.1, 0.9) and its
    batch (RandomState(0): uniform images, random labels): (main, startup,
    [loss, acc1, acc5], feed)."""
    with ptt.unique_name.guard():
        main, startup, _, fetch = resnet.resnet_train_program(
            depth=50, class_dim=RESNET_CLASSES, image_shape=(3, 224, 224),
            optimizer_fn=lambda loss: ptt.optimizer.Momentum(
                0.1, 0.9).minimize(loss))
    startup.random_seed = SEED
    rng = np.random.RandomState(0)
    feed = {"image": rng.rand(batch, 3, 224, 224).astype(np.float32),
            "label": rng.randint(0, RESNET_CLASSES, (batch, 1)).astype(
                np.int64)}
    return main, startup, [fetch["loss"], fetch["acc1"], fetch["acc5"]], \
        feed


def _step_flops(main, batch):
    """The products a training step of ``main`` needs at ``batch``: each
    convolution's and fc's forward, and once more for each gradient its
    grad_of computes (input, filter), from the program's shapes (a dim of
    -1 or 0 is the batch); each attention's QK^T and PV over the pairs it
    sees (half of them, causal), and twice that in its backward (dP, dQ,
    dK, dV)."""
    block = main.global_block()

    def dims(name):
        return [batch if d in (-1, 0) else d for d in block.var(name).shape]
    fwd, attn = {}, set()
    for op in block.ops:
        if op.type in ("conv2d", "depthwise_conv2d"):
            out = block.var(op.output("Output")[0]).shape
            w = block.var(op.input("Filter")[0]).shape
            fwd[op.desc_id] = 2.0 * batch * out[1] * out[2] * out[3] * \
                w[1] * w[2] * w[3]
        elif op.type == "mul":
            w = block.var(op.input("Y")[0]).shape
            rows = math.prod(dims(op.input("X")[0])[
                :op.attrs.get("x_num_col_dims", 1)])
            fwd[op.desc_id] = 2.0 * rows * w[0] * w[1]
        elif op.type == "scaled_dot_product_attention":
            n, h, tq, d = dims(op.input("Q")[0])
            tk = dims(op.input("K")[0])[2]
            pairs, _ = _visible(tq, tk, op.attrs.get("causal", False))
            fwd[op.desc_id] = 4.0 * n * h * pairs * d
            attn.add(op.desc_id)
    flops = sum(fwd.values())
    for op in block.ops:
        if op.type == "grad_of" and op.attrs["fwd_id"] in fwd:
            fid = op.attrs["fwd_id"]
            flops += fwd[fid] * (2 if fid in attn else sum(
                1 for slot in op.outputs if slot.startswith("IG:")))
    return flops


def _device_ms_by_op_type(torch, fn, dead=()):
    """Device time and kernels of one run of ``fn`` (op by op) by op type
    ([calls, device ms, kernels] each): each forward op's and grad_of's
    call is a profiler range on the host, and each kernel counts for the
    range its launching host op starts in (a grad_of's kernels are
    launched by autograd's device thread while the range's thread waits
    in ``torch.autograd.grad``); beside the run's device busy (every
    kernel launched from the host). An op whose desc_id is in ``dead``
    counts under "dead:<type>". Read from the profiler's raw events
    (``_op_ranges_and_kernels``): building its event tree takes ~25 s
    for a CRNN-CTC step's 54k kernels."""
    import bisect
    from torch.profiler import ProfilerActivity, profile as tprofile
    from torch.profiler import record_function
    from paddle_tpu_torch.framework import executor
    fwd, grad = executor._run_fwd_op, executor.trace.run_grad_op

    def ranged(kind, inner):
        def call(op, *args):
            key = op.type if kind == "op" else \
                "grad_of(%s)" % op.attrs["fwd_type"]
            if op.desc_id in dead:
                key = "dead:" + key
            with record_function("op::" + key):
                return inner(op, *args)
        return call
    fn()
    torch.cuda.synchronize()
    executor._run_fwd_op = ranged("op", fwd)
    executor.trace.run_grad_op = ranged("grad", grad)
    try:
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        executor._run_fwd_op, executor.trace.run_grad_op = fwd, grad
    ranges, kernels = _op_ranges_and_kernels(prof)
    starts = [r[0] for r in ranges]
    by_type, busy = {}, 0.0
    for _, _, key in ranges:
        n, ms, k = by_type.get(key, (0, 0.0, 0))
        by_type[key] = (n + 1, ms, k)
    for launched, ms in kernels:
        busy += ms
        i = bisect.bisect_right(starts, launched) - 1
        key = ranges[i][2] if i >= 0 and launched <= ranges[i][1] else \
            "outside any op"
        n, total, k = by_type.get(key, (0, 0.0, 0))
        by_type[key] = (n, total + ms, k + 1)
    return {"device_busy_ms": busy,
            "by_op_type": {k: list(v) for k, v in sorted(
                by_type.items(), key=lambda kv: -kv[1][1])}}


def _op_ranges_and_kernels(prof):
    """From a finished torch.profiler run's raw events: the "op::" ranges
    on the host, sorted ((start ns, end ns, key)), and each device event
    (kernel, copy or fill; not a range's device-side mirror) as (the host
    start of the op that launched it, ns; its device ms). A device event
    names its launching op by ``linked_correlation_id``, as the
    profiler's own event tree links them."""
    from torch.autograd import DeviceType
    raw = prof.profiler.kineto_results.events()
    host, ranges = {}, []
    for e in raw:
        if e.device_type() != DeviceType.CPU or e.is_async() or \
                e.linked_correlation_id():
            continue
        host[e.correlation_id()] = e.start_ns()
        if e.name().startswith("op::"):
            ranges.append((e.start_ns(), e.end_ns(), e.name()[4:]))
    kernels = [(host[e.linked_correlation_id()], e.duration_ns() / 1e6)
               for e in raw if e.device_type() == DeviceType.CUDA and
               not e.name().startswith("op::") and
               e.linked_correlation_id() in host]
    return sorted(ranges), kernels


def _cudnn_deterministic_cost(torch, exe, main, scope, feed, fetch_list):
    """The step's cost of cuDNN's deterministic algorithms (set_precision
    asks for them): op-by-op steps with ``cudnn.deterministic`` on and off
    in turns (on, off, off, on), host ms each after a device sync; then
    on again."""
    ms = {True: [], False: []}
    try:
        for det in (True, False, False, True):
            torch.backends.cudnn.deterministic = det
            t0 = time.perf_counter()
            exe.run(main, feed=feed, fetch_list=fetch_list, scope=scope,
                    use_program_cache=False)
            torch.cuda.synchronize()
            ms[det].append((time.perf_counter() - t0) * 1e3)
    finally:
        torch.backends.cudnn.deterministic = True
    return {"op_by_op_step_ms_deterministic": ms[True],
            "op_by_op_step_ms_not_deterministic": ms[False]}


def resnet_train(torch, np, ptt, counters):
    """ResNet-50 training at bench.py:472-486 with nothing cut, TRAIN_STEPS
    steps on one batch through Executor.run (graphed from the second):
    losses finite, the first update lowering the loss (at lr 0.1 and
    momentum 0.9 from scratch the loss falls for two steps, then climbs
    past the first by the sixth, the same op by op and graphed; PERF.md),
    no hand-written kernel launched; images/s
    over the replays (third step on), peak memory and memory resident
    before the steps, the capture's time and pool growth, the step's FP32
    bound; then an op-by-op step's device time by op type and the cost of
    cuDNN's deterministic algorithms."""
    from paddle_tpu_torch.models import resnet
    t0 = time.perf_counter()
    main, startup, fetch_list, feed = _resnet_program(np, ptt, resnet,
                                                      RESNET_BATCH)
    scope, exe = ptt.Scope(), ptt.Executor()      # CUDAPlace(0)
    with ptt.scope_guard(scope):
        exe.run(startup)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses, per_step, launches = _steps(
        torch, np, ptt, counters, exe, main, scope, feed, fetch_list,
        TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated()
    finite = all(np.isfinite(v) for row in losses for v in row)
    descends = losses[1][0] < losses[0][0]
    counts_ok = all(c == _no_launches(counters) for c in per_step)
    replay_ms = statistics.median(step_ms[2:])
    flops = _step_flops(main, RESNET_BATCH)
    by_op = _device_ms_by_op_type(torch, lambda: exe.run(
        main, feed=feed, fetch_list=fetch_list, scope=scope,
        use_program_cache=False))
    det = _cudnn_deterministic_cost(torch, exe, main, scope, feed,
                                    fetch_list)
    ok = finite and descends and counts_ok
    emit({"phase": "resnet_train", "ok": ok, "model": "resnet50",
          "classes": RESNET_CLASSES, "image": [3, 224, 224],
          "batch": RESNET_BATCH, "dtype": "float32",
          "optimizer": "Momentum(0.1, 0.9)",
          "parameters": sum(int(np.prod(p.shape))
                            for p in main.all_parameters()),
          "program_ops": _n_ops(_op_counts(main)),
          "op_counts": _op_counts(main), "setup_s": setup_s,
          "step_ms": step_ms, "replay_ms_median": replay_ms,
          "images_per_s_replays": RESNET_BATCH / (replay_ms / 1e3),
          "losses": losses, "finite": finite,
          "first_update_descends": descends,
          "last_below_first": losses[-1][0] < losses[0][0],
          "launches_per_step": per_step[-1], "launches_per_step_ok":
          counts_ok, "launches": launches,
          "resident_gb": resident / 2 ** 30, "peak_mem_gb": peak / 2 ** 30,
          "step_peak_above_resident_gb": (peak - resident) / 2 ** 30,
          "captures": _capture_record(exe),
          "step_flops": flops, "fp32_ffma_bound_ms":
          flops / FP32_FFMA_FLOPS * 1e3,
          "device_ms_by_op_type_op_by_op": by_op,
          "cudnn_deterministic": det})
    if not ok:
        raise AssertionError("resnet_train checks failed (see the line "
                             "above)")
    return launches, (exe, main, scope, feed, fetch_list)


def _deterministic_warnings(torch, ptt, main, start, feed, fetch_list):
    """One op-by-op step on a copy of ``start`` under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``: the
    first line of each warning torch gives for an operation with no
    deterministic implementation (cuBLAS's workspace warning
    included)."""
    import warnings
    scope = _copy_scope(torch, ptt, start)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ptt.Executor().run(main, feed=feed, fetch_list=fetch_list,
                               scope=scope, use_program_cache=False)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).strip().splitlines()[0][:200]
                   for w in caught})


def graph_resnet(torch, np, ptt, counters):
    """resnet_train's step GRAPH_STEPS runs op by op and graphed from one
    startup: losses, acc1, acc5, every parameter, velocity and moving
    statistic bit for bit equal, no hand-written kernel either way; one
    run each way profiled; the warnings of a step under torch's
    deterministic-algorithms check."""
    from paddle_tpu_torch.models import resnet
    main, startup, fetch_list, feed = _resnet_program(np, ptt, resnet,
                                                      RESNET_BATCH)
    record, ok, _, start, launches = _both_ways(
        torch, np, ptt, counters, "graph_resnet", main, startup, feed,
        fetch_list, _no_launches(counters), (), mask=False)
    nondeterministic = _deterministic_warnings(torch, ptt, main, start, feed,
                                               fetch_list)
    emit(dict({"phase": "graph_resnet", "ok": ok, "model": "resnet50",
               "batch": RESNET_BATCH,
               "cudnn_deterministic": torch.backends.cudnn.deterministic,
               "cudnn_benchmark": torch.backends.cudnn.benchmark,
               "deterministic_check_warnings": nondeterministic}, **record))
    if not ok:
        raise AssertionError("graph_resnet checks failed (see the line "
                             "above)")
    return launches


def resnet_serve(torch, np, ptt, counters, model_dir, trained_scope):
    """ResNet-50 with is_test=True (the softmax of ``resnet.resnet``), its
    weights and moving statistics from resnet_train's scope, saved with
    save_inference_model and served through create_predictor on the card
    at RESNET_SERVE_BATCHES (buckets 1 and 8): answers of the shape,
    finite, rows summing to 1, no hand-written kernel; batch 8 within
    SERVE_ATOL of the same directory served on the CPU, and its logits
    (a second target) within RESNET_SERVE_LOGIT_RTOL; then each batch
    op by op and graphed (answers bit for bit equal, latency in turns,
    GRAPH_SERVE_REPS each), one request each way profiled."""
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.models import resnet
    main, startup = ptt.Program(), ptt.Program()
    with ptt.unique_name.guard(), ptt.program_guard(main, startup):
        image = layers.data("image", [3, 224, 224])
        logits = resnet.resnet(image, RESNET_CLASSES, 50, is_test=True)
        prob = layers.softmax(logits)
    with ptt.scope_guard(trained_scope):
        ptt.save_inference_model(model_dir, ["image"], [prob, logits],
                                 ptt.Executor(), main_program=main)
    config = Config(model_dir)
    config.batch_buckets = (1, 8)
    pred = create_predictor(config)
    rng = np.random.RandomState(SEED)
    requests = [{"image": rng.rand(n, 3, 224, 224).astype(np.float32)}
                for n in RESNET_SERVE_BATCHES]
    counters.zero()                          # the main path starts here
    lat, answers = [], []
    for feed in requests:
        t1 = time.perf_counter()
        answers.append(pred.run(feed))       # numpy: synchronised
        lat.append((time.perf_counter() - t1) * 1e3)
    launches = counters.read()
    shapes_ok = all(
        p.shape == (len(f["image"]), RESNET_CLASSES) and
        z.shape == p.shape and np.isfinite(p).all() and
        np.isfinite(z).all() and np.allclose(p.sum(1), 1.0, atol=1e-4)
        for f, (p, z) in zip(requests, answers))
    cpu_config = Config(model_dir)
    cpu_config.place = ptt.CPUPlace()
    t2 = time.perf_counter()
    cpu_prob, cpu_logits = create_predictor(cpu_config).run(requests[1])
    cpu_ms = (time.perf_counter() - t2) * 1e3
    err = float(np.abs(answers[1][0] - cpu_prob).max())
    # the logits too: a saturated softmax would agree whatever the logits
    logit_err = float(np.abs(answers[1][1] - cpu_logits).max()) / max(
        float(np.abs(cpu_logits).max()), 1e-30)
    exe, cases = pred._exe, []
    for n in (1, 8):
        feed = next(r for r in requests if len(r["image"]) == n)

        def op_by_op(feed=feed):
            with ptt.scope_guard(pred._scope):
                return exe.run(pred._program, feed=feed,
                               fetch_list=pred._fetch_names,
                               use_program_cache=False)
        ways = (("op_by_op", op_by_op),
                ("graphed", lambda f=feed: pred.run(f)))
        got, ms = {}, {w: [] for w, _ in ways}
        for way, fn in ways:
            got[way] = fn()
        for _ in range(GRAPH_SERVE_REPS):
            for way, fn in ways:
                t0 = time.perf_counter()
                fn()
                ms[way].append((time.perf_counter() - t0) * 1e3)
        found = {way: _profiled(torch, fn) for way, fn in ways}
        for f in found.values():
            f.pop("kernel_names")
        cases.append({
            "batch": n, "answers_bit_equal": all(
                np.array_equal(a, b) for a, b in
                zip(got["op_by_op"], got["graphed"])),
            "request_ms": ms,
            "request_ms_median": {w: statistics.median(v)
                                  for w, v in ms.items()},
            "captures": [c for c in _capture_record(exe)
                         if c["feeds"]["image"][0] == n],
            "profile": found})
    ok = shapes_ok and err <= SERVE_ATOL and \
        logit_err <= RESNET_SERVE_LOGIT_RTOL and \
        launches == _no_launches(counters) and \
        all(c["answers_bit_equal"] for c in cases)
    emit({"phase": "resnet_serve", "ok": ok, "model": "resnet50",
          "dtype": "float32", "buckets": [1, 8],
          "request_batches": list(RESNET_SERVE_BATCHES), "latency_ms": lat,
          "launches": launches, "shapes_finite_ok": shapes_ok,
          "top_probability": [float(v) for v in answers[1][0].max(1)],
          "cpu_request_ms": cpu_ms, "gpu_vs_cpu_max_abs_err": err,
          "atol": SERVE_ATOL, "gpu_vs_cpu_logits_rel_err": logit_err,
          "logits_rtol": RESNET_SERVE_LOGIT_RTOL, "cases": cases})
    close_executor(torch, "resnet_serve", exe)
    if not ok:
        raise AssertionError("resnet_serve checks failed (see the line "
                             "above)")
    return launches


def _card_vs_cpu_all(np, ptt, main, startup, fetch_list, feed, fetch_tols,
                     rtol, atol):
    """PARITY_STEPS runs of a training program on the card (graphed, and
    op by op) and on the CPU from the same startup weights: every fetch
    of every run within its (rtol, atol) of ``fetch_tols``, every
    persistable within (rtol, atol), integer ones equal; the card's
    graphed runs equal its op-by-op runs bit for bit. (the comparison's
    numbers, whether it passed)."""
    from paddle_tpu_torch.framework.scope import to_numpy
    from paddle_tpu_torch.io import set_params_from_numpy
    init = ptt.Scope()
    ptt.Executor().run(startup, scope=init)
    persist = sorted(v.name for v in main.list_vars() if v.persistable)
    arrays = {n: init.find_var(n).cpu() for n in persist}
    runs = {}
    for label, place, cache in (("gpu", ptt.CUDAPlace(0), True),
                                ("gpu_op_by_op", ptt.CUDAPlace(0), False),
                                ("cpu", ptt.CPUPlace(), True)):
        scope, exe = ptt.Scope(), ptt.Executor(place)
        set_params_from_numpy(arrays, main, scope, place)
        t0 = time.perf_counter()
        fetched = [exe.run(main, feed=feed, fetch_list=fetch_list,
                           scope=scope, use_program_cache=cache)
                   for _ in range(PARITY_STEPS)]
        runs[label] = (fetched, {n: to_numpy(scope.find_var(n))
                                 for n in persist},
                       (time.perf_counter() - t0) * 1e3)
        exe.close()
    (gf, gs, g_ms), (of, os_, _), (cf, cs, c_ms) = \
        runs["gpu"], runs["gpu_op_by_op"], runs["cpu"]
    graphed_equal = all(np.array_equal(a, b) for x, y in zip(gf, of)
                        for a, b in zip(x, y)) and \
        all(np.array_equal(gs[n], os_[n]) for n in persist)
    fetch_errs, fetches_ok = [], True
    for i, (frtol, fatol) in enumerate(fetch_tols):
        errs = [float(np.abs(g[i] - c[i]).max()) for g, c in zip(gf, cf)]
        fetches_ok = fetches_ok and all(
            np.allclose(g[i], c[i], rtol=frtol, atol=fatol)
            for g, c in zip(gf, cf))
        fetch_errs.append({"fetch": fetch_list[i].name, "rtol": frtol,
                           "atol": fatol, "max_abs_err_by_step": errs})
    beyond, worst, moved = [], (0.0, None), 0.0
    for n in persist:
        if gs[n].dtype.kind in "iu":
            if not np.array_equal(gs[n], cs[n]):
                beyond.append(n)
            continue
        diff = np.abs(gs[n] - cs[n])
        if not np.allclose(gs[n], cs[n], rtol=rtol, atol=atol):
            beyond.append(n)
        if diff.size and float(diff.max()) > worst[0]:
            worst = (float(diff.max()), n)
        moved = max(moved, float(np.abs(
            gs[n] - to_numpy(arrays[n])).max()) if gs[n].size else 0.0)
    ok = graphed_equal and fetches_ok and not beyond and moved > 10 * atol
    return {"steps": PARITY_STEPS,
            "losses": {"gpu": [float(f[0].reshape(())) for f in gf],
                       "cpu": [float(f[0].reshape(())) for f in cf]},
            "fetches": fetch_errs, "fetches_ok": fetches_ok,
            "persistables": len(persist), "rtol": rtol, "atol": atol,
            "beyond_tolerance": beyond[:8], "max_abs_err": worst[0],
            "max_abs_err_var": worst[1], "max_moved": moved,
            "graphed_bit_equal_op_by_op": graphed_equal,
            "gpu_ms": g_ms, "cpu_ms": c_ms}, ok


def resnet_parity(torch, np, ptt):
    """The narrow ResNet (RESNET_PARITY_*) three Momentum(0.1, 0.9) steps
    on one batch, the card graphed against the CPU from the same
    weights."""
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.models import resnet
    main, startup = ptt.Program(), ptt.Program()
    with ptt.unique_name.guard(), ptt.program_guard(main, startup):
        image = layers.data("image", list(RESNET_PARITY_SHAPE))
        label = layers.data("label", [1], dtype="int64")
        x = resnet.conv_bn_layer(image, 8, 3, stride=2, act="relu",
                                 name="conv1")
        x = layers.pool2d(x, 3, "max", 2, 1)
        x = resnet.bottleneck_block(x, 8, 1, "res2a")
        x = resnet.bottleneck_block(x, 8, 2, "res2b")
        pool = layers.pool2d(x, global_pooling=True, pool_type="avg")
        logits = layers.fc(layers.reshape(pool, [0, pool.shape[1]]), 10)
        loss, softmax = layers.softmax_with_cross_entropy(
            logits, label, return_softmax=True)
        loss = layers.mean(loss)
        acc = layers.accuracy(softmax, label, k=1)
        ptt.optimizer.Momentum(0.1, 0.9).minimize(loss)
    startup.random_seed = SEED
    rng = np.random.RandomState(7)
    feed = {"image": rng.rand(RESNET_PARITY_BATCH,
                              *RESNET_PARITY_SHAPE).astype(np.float32),
            "label": rng.randint(0, 10, (RESNET_PARITY_BATCH, 1)).astype(
                np.int64)}
    result, ok = _card_vs_cpu_all(
        np, ptt, main, startup, [loss, acc], feed,
        [(PARITY_FETCH_RTOL, 0.0), (0.0, 0.0)], RESNET_PARITY_RTOL,
        RESNET_PARITY_ATOL)
    emit(dict({"phase": "resnet_parity", "ok": ok,
               "image": list(RESNET_PARITY_SHAPE),
               "batch": RESNET_PARITY_BATCH}, **result))
    if not ok:
        raise AssertionError("resnet_parity checks failed (see the line "
                             "above)")


def _deepfm_program(np, ptt, deepfm, batch, **kw):
    """deepfm_train_program(**kw) with Adam(1e-3) and one
    synthetic_batch(seed=0): (main, startup, [loss, auc, predict], feed,
    the auc op)."""
    with ptt.unique_name.guard():
        main, startup, _, fetch = deepfm.deepfm_train_program(
            optimizer_fn=lambda loss: ptt.optimizer.Adam(1e-3).minimize(
                loss), **kw)
    startup.random_seed = SEED
    feed = deepfm.synthetic_batch(batch, feature_dim=kw["feature_dim"],
                                  seed=0)
    auc_op = next(op for op in main.global_block().ops if op.type == "auc")
    return main, startup, [fetch["loss"], fetch["auc"], fetch["predict"]], \
        feed, auc_op


def _numpy_auc(np, pos, neg):
    """The AUC of two histograms in float64 (the op's integral)."""
    tp = np.cumsum(pos[::-1])[::-1].astype(np.float64)
    fp = np.cumsum(neg[::-1])[::-1].astype(np.float64)
    tpn, fpn = np.append(tp[1:], 0.0), np.append(fp[1:], 0.0)
    if tp[0] == 0 or fp[0] == 0:
        return 0.0
    return float(((fp - fpn) * (tp + tpn) / 2).sum() / (tp[0] * fp[0]))


def deepfm_train(torch, np, ptt, counters):
    """DeepFM at bench.py:565-578 with nothing cut, TRAIN_STEPS Adam steps
    on one batch through Executor.run: losses finite and falling, one
    fused-Adam launch per parameter a step (DEEPFM_PER_STEP), examples/s
    over the replays; the AUC histograms read back from the scope equal
    numpy's bins of the fetched predictions, and the fetched AUC equals
    a float64 numpy integral of them; then GRAPH_STEPS runs op by op
    and graphed, bit for bit equal."""
    from paddle_tpu_torch.framework.scope import to_numpy
    from paddle_tpu_torch.models import deepfm
    t0 = time.perf_counter()
    kw = dict(feature_dim=DEEPFM_FEATURES, embedding_size=DEEPFM_EMBEDDING)
    main, startup, fetch_list, feed, auc_op = _deepfm_program(
        np, ptt, deepfm, DEEPFM_BATCH, **kw)
    scope, exe = ptt.Scope(), ptt.Executor()
    with ptt.scope_guard(scope):
        exe.run(startup)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step_ms, fetched, per_step, launches = _fetch_steps(
        torch, ptt, counters, exe, main, scope, feed, fetch_list,
        TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(f[0].reshape(())) for f in fetched]
    aucs = [float(f[1].reshape(())) for f in fetched]
    want = _no_launches(counters, **DEEPFM_PER_STEP)
    counts_ok = all(c == want for c in per_step)
    # the histograms against numpy's bins of every fetched prediction
    n_thr = auc_op.attrs["num_thresholds"]
    positive = feed["label"].reshape(-1) > 0
    bins = {True: np.zeros(n_thr + 1, np.int64),
            False: np.zeros(n_thr + 1, np.int64)}
    for f in fetched:
        idx = np.clip((f[2].reshape(-1) * np.float32(n_thr)).astype(
            np.int32), 0, n_thr)
        for side in (True, False):
            np.add.at(bins[side], idx[positive == side], 1)
    stat_pos = to_numpy(scope.find_var(auc_op.input("StatPos")[0]))
    stat_neg = to_numpy(scope.find_var(auc_op.input("StatNeg")[0]))
    bins_equal = np.array_equal(stat_pos, bins[True]) and \
        np.array_equal(stat_neg, bins[False])
    oracle = _numpy_auc(np, stat_pos, stat_neg)
    auc_ok = abs(aucs[-1] - oracle) <= AUC_RTOL * oracle
    finite = all(np.isfinite(losses)) and all(np.isfinite(aucs))
    falling = losses[-1] < losses[0]
    replay_ms = statistics.median(step_ms[2:])
    record, both_ok, _, _, _ = _both_ways(
        torch, np, ptt, counters, "deepfm_train", main, startup, feed,
        fetch_list, want, ("fused_adam",), mask=False)
    ok = finite and falling and counts_ok and bins_equal and auc_ok and \
        both_ok
    emit({"phase": "deepfm_train", "ok": ok, "model": "deepfm",
          "feature_dim": DEEPFM_FEATURES, "embedding": DEEPFM_EMBEDDING,
          "batch": DEEPFM_BATCH, "optimizer": "Adam(1e-3)",
          "parameters": sum(int(np.prod(p.shape))
                            for p in main.all_parameters()),
          "op_counts": _op_counts(main), "setup_s": setup_s,
          "step_ms": step_ms, "replay_ms_median": replay_ms,
          "examples_per_s_replays": DEEPFM_BATCH / (replay_ms / 1e3),
          "losses": losses, "aucs": aucs, "finite": finite,
          "falling": falling, "launches_per_step": per_step[-1],
          "launches_per_step_ok": counts_ok, "launches": launches,
          "histograms_equal_numpy_bins": bins_equal,
          "histogram_counts": [int(stat_pos.sum()), int(stat_neg.sum())],
          "auc_float64_numpy": oracle, "auc_rtol": AUC_RTOL,
          "resident_gb": resident / 2 ** 30, "peak_mem_gb": peak / 2 ** 30,
          "step_peak_above_resident_gb": (peak - resident) / 2 ** 30,
          "captures": _capture_record(exe), "both_ways": record})
    if not ok:
        raise AssertionError("deepfm_train checks failed (see the line "
                             "above)")
    return launches, (exe, main, scope, feed, fetch_list)


def deepfm_parity(torch, np, ptt):
    """DeepFM at DEEPFM_PARITY, batch DEEPFM_PARITY_BATCH, PARITY_STEPS Adam
    steps on one batch, the card graphed against the CPU from the same
    weights."""
    from paddle_tpu_torch.models import deepfm
    main, startup, fetch_list, feed, _ = _deepfm_program(
        np, ptt, deepfm, DEEPFM_PARITY_BATCH, **DEEPFM_PARITY)
    result, ok = _card_vs_cpu_all(
        np, ptt, main, startup, fetch_list, feed,
        [(PARITY_FETCH_RTOL, 0.0), (AUC_RTOL, 0.0),
         (PARITY_FETCH_RTOL, DEEPFM_PARITY_ATOL)],
        DEEPFM_PARITY_RTOL, DEEPFM_PARITY_ATOL)
    emit(dict({"phase": "deepfm_parity", "ok": ok,
               "batch": DEEPFM_PARITY_BATCH}, **dict(DEEPFM_PARITY,
                                                      **result)))
    if not ok:
        raise AssertionError("deepfm_parity checks failed (see the line "
                             "above)")


def _transformer_program(ptt, tr, cfg, batch, seq, lr=1e-4):
    """transformer_train_program(cfg, seq, seq) with Adam(lr) and one
    synthetic_batch(seed=0): (main, startup, [loss], feed)."""
    with ptt.unique_name.guard():
        main, startup, _, fetch = tr.transformer_train_program(
            cfg, seq, seq, optimizer_fn=lambda loss: ptt.optimizer.Adam(
                lr).minimize(loss))
    startup.random_seed = SEED
    return main, startup, [fetch["loss"]], tr.synthetic_batch(
        cfg, batch, seq, seq, seed=0)


def transformer_train(torch, np, ptt, counters):
    """Transformer-base NMT training at bench.py:540-562 with nothing cut
    (f32, batch 64, 64 source and 64 target tokens, dropout 0.1, label
    smoothing 0.1, Adam(1e-4)), TRAIN_STEPS steps on one batch through
    Executor.run (graphed from the second): losses finite and falling,
    TRANSFORMER_PER_STEP launches a step; tokens/s as bench.py:561 counts
    them (batch x target tokens) over the replays, peak memory above
    resident, the capture's time and pool growth, the step beside its f32
    FFMA bound, and an op-by-op step's device time by op type."""
    from paddle_tpu_torch.models import transformer as tr
    t0 = time.perf_counter()
    cfg = tr.TransformerConfig()
    main, startup, fetch_list, feed = _transformer_program(
        ptt, tr, cfg, TRANSFORMER_BATCH, TRANSFORMER_LEN)
    scope, exe = ptt.Scope(), ptt.Executor()      # CUDAPlace(0)
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses, per_step, launches = _steps(
        torch, np, ptt, counters, exe, main, scope, feed, fetch_list,
        TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated()
    finite = all(np.isfinite(v) for row in losses for v in row)
    falling = losses[-1][0] < losses[0][0]
    counts_ok = all(c == TRANSFORMER_PER_STEP for c in per_step)
    replay_ms = statistics.median(step_ms[2:])
    flops = _step_flops(main, TRANSFORMER_BATCH)
    by_op = _device_ms_by_op_type(torch, lambda: exe.run(
        main, feed=feed, fetch_list=fetch_list, scope=scope,
        use_program_cache=False))
    ok = finite and falling and counts_ok
    emit({"phase": "transformer_train", "ok": ok,
          "model": "transformer_base", "d_model": cfg.d_model,
          "d_inner": cfg.d_inner, "layers": [cfg.n_layer, cfg.n_layer],
          "heads": cfg.n_head, "vocab": [cfg.src_vocab, cfg.trg_vocab],
          "batch": TRANSFORMER_BATCH,
          "src_trg_len": [TRANSFORMER_LEN, TRANSFORMER_LEN],
          "dropout": cfg.dropout, "label_smooth_eps": cfg.label_smooth_eps,
          "dtype": "float32", "optimizer": "Adam(1e-4)",
          "parameters": sum(int(np.prod(p.shape))
                            for p in main.all_parameters()),
          "program_ops": _n_ops(_op_counts(main)),
          "op_counts": _op_counts(main), "setup_s": setup_s,
          "step_ms": step_ms, "replay_ms_median": replay_ms,
          "tokens_per_s_replays": TRANSFORMER_BATCH * TRANSFORMER_LEN /
          (replay_ms / 1e3),
          "losses": losses, "finite": finite, "falling": falling,
          "launches_per_step": per_step[-1], "launches_per_step_ok":
          counts_ok, "launches": launches,
          "resident_gb": resident / 2 ** 30, "peak_mem_gb": peak / 2 ** 30,
          "step_peak_above_resident_gb": (peak - resident) / 2 ** 30,
          "captures": _capture_record(exe),
          "step_flops": flops, "fp32_ffma_bound_ms":
          flops / FP32_FFMA_FLOPS * 1e3,
          "device_ms_by_op_type_op_by_op": by_op})
    if not ok:
        raise AssertionError("transformer_train checks failed (see the "
                             "line above)")
    return launches, (exe, main, scope, feed, fetch_list)


def graph_transformer(torch, np, ptt, counters):
    """transformer_train's step (dropout 0.1) GRAPH_STEPS runs op by op
    and graphed from one startup and run counter: the loss, a dropout
    Mask and every parameter and Adam moment bit for bit equal, the Mask
    different every step, TRANSFORMER_PER_STEP launches a step both ways;
    one run each way profiled."""
    from paddle_tpu_torch.models import transformer as tr
    cfg = tr.TransformerConfig()
    main, startup, fetch_list, feed = _transformer_program(
        ptt, tr, cfg, TRANSFORMER_BATCH, TRANSFORMER_LEN)
    fetch_list = fetch_list + [_dropout_mask(main)]
    record, ok, _, _, launches = _both_ways(
        torch, np, ptt, counters, "graph_transformer", main, startup, feed,
        fetch_list, TRANSFORMER_PER_STEP, TRAIN_FAMILIES)
    emit(dict({"phase": "graph_transformer", "ok": ok,
               "model": "transformer_base", "batch": TRANSFORMER_BATCH,
               "dropout": cfg.dropout}, **record))
    if not ok:
        raise AssertionError("graph_transformer checks failed (see the "
                             "line above)")
    return launches


def _decode_feed(np, n, src_len, vocab, seed=0):
    """bench.py:706-708's decode request: source ids from RandomState,
    every position kept."""
    rng = np.random.RandomState(seed)
    return {"src_ids": rng.randint(0, vocab, (n, src_len, 1)).astype(
                np.int64),
            "src_mask": np.ones((n, src_len, 1), np.float32)}


def _selectors(main):
    """Each decode step's selection, in program order: (the var it selects
    from: the beam's candidate scores or greedy's logits, how many it
    keeps)."""
    return [(op.input("X")[0], op.attrs.get("k", 1))
            for op in main.global_block().ops
            if op.type in ("top_k", "arg_max")]


def _first_divergence(np, a, b):
    """{row: the first output position where two decodes' ids (N, T, 1)
    or (N, beam, T, 1) differ as sets of beam prefixes}."""
    t = a.shape[-2]
    a, b = a.reshape(a.shape[0], -1, t), b.reshape(b.shape[0], -1, t)
    out = {}
    for row in range(a.shape[0]):
        for pos in range(1, t):
            if sorted(map(tuple, a[row, :, :pos + 1].tolist())) != \
                    sorted(map(tuple, b[row, :, :pos + 1].tolist())):
                out[row] = pos
                break
    return out


def _compare_decodes(np, main, got, want, fetch_a):
    """Two decodes of one program and request, each (ids, scores or None):
    ids equal, except where a step chose between candidates within
    DECODE_GAP_ATOL (the kept candidates' last against the first left
    out, in ``fetch_a``'s run: fetch_a(var name) -> array); the scores
    of rows whose ids agree within DECODE_SCORE_RTOL. (record, ok)."""
    diverged = _first_divergence(np, got[0], want[0])
    selectors, gaps = _selectors(main), []
    for row, pos in sorted(diverged.items())[:4]:
        name, k = selectors[pos - 1]
        cand = np.sort(fetch_a(name).reshape(got[0].shape[0], -1)[row])[::-1]
        gaps.append({"row": row, "position": pos, "step": pos - 1,
                     "gap": float(cand[k - 1] - cand[k])})
    ties_ok = len(gaps) == len(diverged) and all(
        g["gap"] <= DECODE_GAP_ATOL for g in gaps)
    rows = [r for r in range(got[0].shape[0]) if r not in diverged]
    score_err, scores_ok = None, True
    if got[1] is not None and rows:
        score_err = float(np.max(np.abs(got[1][rows] - want[1][rows]) /
                                 np.abs(want[1][rows])))
        scores_ok = score_err <= DECODE_SCORE_RTOL
    return {"ids_equal": not diverged, "diverged_rows": len(diverged),
            "near_ties": gaps, "gap_atol": DECODE_GAP_ATOL,
            "scores_max_rel_err": score_err,
            "scores_rtol": DECODE_SCORE_RTOL}, ties_ok and scores_ok


def _timed_runs(torch, fn, n):
    """``n`` calls of ``fn``, each synchronised: host ms each."""
    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def _decode_on_card(torch, np, ptt, counters, label, prog, scope, feed):
    """One decode program through Executor.run on the card: its first run
    op by op, the second captured, BEAM_RUNS replays timed as bench.py:725
    counts them (batch x output tokens x runs / seconds), DECODE_PER_
    REQUEST launches each run; one replay profiled. (record, the answer,
    ok, launches)."""
    main, _, _, fetch = prog
    fetch_list = [fetch[k] for k in sorted(fetch)]
    exe = ptt.Executor()
    counters.zero()                          # the main path starts here
    per_run, answers = [], []

    def run():
        before = counters.read()
        answers.append(exe.run(main, feed=feed, fetch_list=fetch_list,
                               scope=scope))
        after = counters.read()
        per_run.append({k: after[k] - before[k] for k in after})
    first = _timed_runs(torch, run, 2)
    ms = _timed_runs(torch, run, BEAM_RUNS)
    launches = counters.read()
    n, t_max = feed["src_ids"].shape[0], fetch["out_ids"].shape[-2]
    found = _profiled(torch, lambda: exe.run(main, feed=feed,
                                             fetch_list=fetch_list,
                                             scope=scope))
    missing, library = _kernel_check(found, SERVE_FAMILIES)
    found.pop("kernel_names")
    same = all(np.array_equal(a, b) for ans in answers[1:]
               for a, b in zip(ans, answers[0]))
    counts_ok = all(c == DECODE_PER_REQUEST for c in per_run)
    finite = all(np.isfinite(a).all() for a in answers[0])
    ok = same and counts_ok and finite and not missing and not library
    record = {"program": label, "batch": n, "out_len": t_max,
              "program_ops": _n_ops(_op_counts(main)),
              "op_by_op_ms": first[0], "capture_run_ms": first[1],
              "replay_ms": ms,
              "tokens_per_s": n * t_max * len(ms) / (sum(ms) / 1e3),
              "answers_bit_equal_every_run": same, "finite": finite,
              "launches_per_run": per_run[-1], "launches_per_run_ok":
              counts_ok, "captures": _capture_record(exe),
              "missing_kernel_families": missing,
              "library_kernels": library, "profile": found}
    exe.close()
    return record, dict(zip(sorted(fetch), answers[0])), ok, launches


def transformer_serve(torch, np, ptt, counters, model_dir):
    """Transformer-base decode at bench.py:684-725's settings (batch 16,
    64 source tokens, 32 output tokens, beam 4, the K/V cache), from
    random weights drawn from SEED: the beam and greedy programs through
    Executor.run (``_decode_on_card``); the beam program without the
    cache (the prefix re-decoded every step) against the cached one at
    full width (``_compare_decodes``); then the beam program saved with
    save_inference_model and served through create_predictor at
    BEAM_SERVE_BATCHES (buckets 1, 4, 16): answers of the shapes,
    DECODE_PER_REQUEST launches a request, the warm request equal to the
    cold one, batch 16 equal to Executor.run's; each bucket op by op and
    graphed (ms a request, BEAM_SERVE_REPS each), one graphed request
    profiled; batch 3 against the same directory served on the CPU."""
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.models import transformer as tr
    cfg = tr.TransformerConfig()
    progs = {}
    for label, use_cache in (("beam", True), ("beam_no_cache", False),
                             ("greedy", True)):
        with ptt.unique_name.guard():
            if label == "greedy":
                progs[label] = tr.greedy_decode_program(
                    cfg, BEAM_SRC, BEAM_OUT, use_cache=use_cache)
            else:
                progs[label] = tr.beam_search_decode_program(
                    cfg, BEAM_SRC, BEAM_OUT, beam_size=BEAM_SIZE,
                    use_cache=use_cache)
    beam = progs["beam"]
    beam[1].random_seed = SEED
    scope = ptt.Scope()
    ptt.Executor().run(beam[1], scope=scope)
    feed = _decode_feed(np, BEAM_BATCH, BEAM_SRC, cfg.src_vocab)
    records, answers, ok, launches = {}, {}, True, None
    for label in ("beam", "greedy"):
        rec, ans, run_ok, got = _decode_on_card(
            torch, np, ptt, counters, label, progs[label], scope, feed)
        records[label], answers[label] = rec, ans
        ok = ok and run_ok
        launches = got if launches is None else \
            {k: launches[k] + got[k] for k in got}
    # the cache against the re-decode, full width, on the card
    full = progs["beam_no_cache"]
    t0 = time.perf_counter()
    redecode = ptt.Executor().run(
        full[0], feed=feed, fetch_list=[full[3]["out_ids"],
                                        full[3]["scores"]], scope=scope)
    redecode_ms = (time.perf_counter() - t0) * 1e3
    cached = (answers["beam"]["out_ids"], answers["beam"]["scores"])
    versus, versus_ok = _compare_decodes(
        np, beam[0], cached, redecode, lambda name: ptt.Executor().run(
            beam[0], feed=feed, fetch_list=[name], scope=scope)[0])
    versus["redecode_ms"] = redecode_ms
    versus["redecode_program_ops"] = _n_ops(_op_counts(full[0]))
    ok = ok and versus_ok
    # served through the Predictor
    fetch = [beam[3]["out_ids"], beam[3]["scores"]]
    with ptt.scope_guard(scope):
        ptt.save_inference_model(model_dir, beam[2], fetch, ptt.Executor(),
                                 main_program=beam[0])
    config = Config(model_dir)
    config.batch_buckets = BEAM_BUCKETS
    pred = create_predictor(config)
    requests = {n: _decode_feed(np, n, BEAM_SRC, cfg.src_vocab, seed=n)
                for n in set(BEAM_SERVE_BATCHES)}
    requests[BEAM_BATCH] = feed
    served, lat, per_request = {}, [], []
    for n in BEAM_SERVE_BATCHES:
        before = counters.read()
        t1 = time.perf_counter()
        out = pred.run(requests[n])          # numpy: synchronised
        lat.append((time.perf_counter() - t1) * 1e3)
        after = counters.read()
        per_request.append({k: after[k] - before[k] for k in after})
        if n in served:
            ok = ok and all(np.array_equal(a, b)
                            for a, b in zip(out, served[n]))
        served[n] = out
    launches = {k: launches[k] + sum(r[k] for r in per_request)
                for k in launches}
    shapes_ok = all(
        o[0].shape == (n, BEAM_SIZE, BEAM_OUT, 1) and
        o[0].dtype == np.int64 and o[1].shape == (n, BEAM_SIZE) and
        np.isfinite(o[1]).all() for n, o in served.items())
    like_executor = np.array_equal(served[BEAM_BATCH][0], cached[0]) and \
        np.array_equal(served[BEAM_BATCH][1], cached[1])
    counts_ok = all(c == DECODE_PER_REQUEST for c in per_request)
    exe, buckets = pred._exe, []
    for n in sorted(set(BEAM_SERVE_BATCHES)):
        padded = {k: np.pad(v, [(0, pred._bucket(n) - n)] +
                            [(0, 0)] * (v.ndim - 1))
                  for k, v in requests[n].items()}

        def op_by_op(feed=padded):
            return exe.run(pred._program, feed=feed,
                           fetch_list=pred._fetch_names, scope=pred._scope,
                           use_program_cache=False)
        ways = (("op_by_op", op_by_op),
                ("graphed", lambda r=requests[n]: pred.run(r)))
        ms = {w: [] for w, _ in ways}
        for _ in range(BEAM_SERVE_REPS):
            for way, fn in ways:
                ms[way].extend(_timed_runs(torch, fn, 1))
        found = _profiled(torch, ways[1][1])
        found.pop("kernel_names")
        med = statistics.median(ms["graphed"])
        buckets.append({"batch": n, "bucket": pred._bucket(n),
                        "request_ms": ms,
                        "request_ms_median": {w: statistics.median(v)
                                              for w, v in ms.items()},
                        "tokens_per_s_graphed": n * BEAM_OUT / (med / 1e3),
                        "profile": found})
    # the card against the CPU on the same directory, batch 3 (bucket 4):
    # Executor.run of the loaded program on the padded request each side
    cpu_config = Config(model_dir)
    cpu_config.place = ptt.CPUPlace()
    cpu_pred = create_predictor(cpu_config)
    n = 3
    padded = {k: np.pad(v, [(0, pred._bucket(n) - n)] +
                        [(0, 0)] * (v.ndim - 1))
              for k, v in requests[n].items()}
    t2 = time.perf_counter()
    on_cpu = cpu_pred._exe.run(cpu_pred._program, feed=padded,
                               fetch_list=cpu_pred._fetch_names,
                               scope=cpu_pred._scope)
    cpu_ms = (time.perf_counter() - t2) * 1e3
    on_card = exe.run(pred._program, feed=padded,
                      fetch_list=pred._fetch_names, scope=pred._scope)
    cpu_vs, cpu_ok = _compare_decodes(
        np, pred._program, on_card, on_cpu, lambda name: exe.run(
            pred._program, feed=padded, fetch_list=[name],
            scope=pred._scope)[0])
    sliced = all(np.array_equal(a[:n], b)
                 for a, b in zip(on_card, served[n]))
    ok = ok and shapes_ok and like_executor and counts_ok and cpu_ok and \
        sliced
    emit({"phase": "transformer_serve", "ok": ok,
          "model": "transformer_base", "beam": BEAM_SIZE,
          "batch": BEAM_BATCH, "src_len": BEAM_SRC, "out_len": BEAM_OUT,
          "dtype": "float32", "runs": records,
          "cached_vs_redecode": versus,
          "predictor": {"buckets": list(BEAM_BUCKETS),
                        "request_batches": list(BEAM_SERVE_BATCHES),
                        "latency_ms": lat,
                        "launches_per_request": per_request[-1],
                        "launches_per_request_ok": counts_ok,
                        "shapes_ok": shapes_ok,
                        "batch_16_equals_executor": like_executor,
                        "batch_3_equals_padded_run": sliced,
                        "captures": _capture_record(exe),
                        "by_bucket": buckets},
          "card_vs_cpu_batch_3": dict(cpu_vs, cpu_ms=cpu_ms),
          "launches": launches,
          "beam_ids_row_0": answers["beam"]["out_ids"][0, :, :, 0].tolist(),
          "beam_scores_row_0": answers["beam"]["scores"][0].tolist()})
    close_executor(torch, "transformer_serve", exe)
    if not ok:
        raise AssertionError("transformer_serve checks failed (see the "
                             "line above)")
    return launches


def transformer_parity(torch, np, ptt):
    """A 2 + 2-layer Transformer at base width (d_model 512, 8 heads,
    vocab 30000, dropout 0) three Adam(PARITY_LR) steps, batch
    PARITY_BATCH x TRANSFORMER_PARITY_LEN tokens with padded source and
    target rows, the card graphed against the CPU (PARITY_*); and its
    cached beam decode (TRANSFORMER_PARITY_BEAM), the card graphed against
    the CPU (``_compare_decodes``)."""
    from paddle_tpu_torch.models import transformer as tr
    cfg = tr.TransformerConfig(n_layer=PARITY_LAYERS, dropout=0.0)
    main, startup, fetch_list, feed = _transformer_program(
        ptt, tr, cfg, PARITY_BATCH, TRANSFORMER_PARITY_LEN, lr=PARITY_LR)
    feed["src_mask"][1, TRANSFORMER_PARITY_LEN // 2:] = 0.0
    feed["trg_mask"][2, TRANSFORMER_PARITY_LEN // 2:] = 0.0
    train, train_ok = _card_vs_cpu(np, ptt, main, startup, fetch_list, feed)
    n, src, out_len, beam = TRANSFORMER_PARITY_BEAM
    with ptt.unique_name.guard():
        prog = tr.beam_search_decode_program(cfg, src, out_len,
                                             beam_size=beam)
    prog[1].random_seed = SEED
    init = ptt.Scope()
    ptt.Executor().run(prog[1], scope=init)
    arrays = {p.name: init.find_var(p.name).cpu()
              for p in prog[0].all_parameters()}
    dfeed = _decode_feed(np, n, src, cfg.src_vocab, seed=7)
    dfeed["src_mask"][1, src // 2:] = 0.0
    fetch = [prog[3]["out_ids"], prog[3]["scores"]]
    runs = {}
    for label, place in (("gpu", ptt.CUDAPlace(0)), ("cpu", ptt.CPUPlace())):
        scope, exe = ptt.Scope(), ptt.Executor(place)
        ptt.set_params_from_numpy(arrays, prog[0], scope, place)
        got = [exe.run(prog[0], feed=dfeed, fetch_list=fetch, scope=scope)
               for _ in range(3)]              # op by op, capture, replay
        runs[label] = (got, scope, exe)
    (gpu, gscope, gexe), (cpu, _, cexe) = runs["gpu"], runs["cpu"]
    replays_equal = all(np.array_equal(a, b) for run in gpu[1:]
                        for a, b in zip(run, gpu[0]))
    decode, decode_ok = _compare_decodes(
        np, prog[0], gpu[-1], cpu[-1], lambda name: gexe.run(
            prog[0], feed=dfeed, fetch_list=[name], scope=gscope)[0])
    gexe.close()
    cexe.close()
    ok = train_ok and decode_ok and replays_equal
    emit({"phase": "transformer_parity", "ok": ok, "layers": PARITY_LAYERS,
          "d_model": cfg.d_model, "batch": PARITY_BATCH,
          "src_trg_len": TRANSFORMER_PARITY_LEN, "train": train,
          "decode": dict(decode, batch=n, src_len=src, out_len=out_len,
                         beam=beam, graphed_equals_op_by_op=replays_equal)})
    if not ok:
        raise AssertionError("transformer_parity checks failed (see the "
                             "line above)")


def _ernie2(ptt, bert, cfg, batch, lr):
    """bench.py:491-515's program at ``cfg`` and ``batch``:
    ernie2_multitask_program(cfg, batch, 128, 20,
    dynamic_task_weights=True) with Adam(lr); (main, startup, [loss,
    mlm_loss, reorder_loss, ir_loss], one feed a step for n steps: the
    synthetic batch with ernie2_task_schedule's next task_weight)."""
    with ptt.unique_name.guard():
        main, startup, _, fetch = bert.ernie2_multitask_program(
            cfg, batch, TRAIN_SEQ, TRAIN_PREDS, dynamic_task_weights=True,
            optimizer_fn=lambda loss: ptt.optimizer.Adam(lr).minimize(loss))
    startup.random_seed = SEED
    base = bert.ernie2_synthetic_batch(cfg, batch, TRAIN_SEQ, TRAIN_PREDS)

    def feeds(n):
        return [dict(base, task_weight=w)
                for w in bert.ernie2_task_schedule(n, (1.0, 1.0, 1.0))]
    return main, startup, [fetch[k] for k in ERNIE2_FETCHES], feeds


def ernie2_train(torch, np, ptt, counters):
    """ERNIE 2.0 multi-task pretraining at bench.py:491-515 with nothing
    cut (bf16 ERNIE-base, batch 128 x 128, 20 masked positions, dropout
    0.1, Adam(1e-4)), each step fed the next task_weight of
    ernie2_task_schedule: GRAPH_STEPS steps op by op and graphed from one
    startup (``_both_ways``: losses, a dropout Mask and every parameter
    and moment bit for bit, ERNIE2_PER_STEP launches a step); each step's
    loss the fed weights' mix of the task losses (a replay reads the new
    weight); samples/s over the replays."""
    from paddle_tpu_torch.models import bert
    cfg = bert.bert_base(dtype="bfloat16")
    main, startup, fetch_list, feeds = _ernie2(ptt, bert, cfg,
                                               BF16_TRAIN_BATCH, 1e-4)
    steps = feeds(GRAPH_STEPS)
    fetch_list = fetch_list + [_dropout_mask(main)]
    record, ok, (fetched, _), _, launches = _both_ways(
        torch, np, ptt, counters, "ernie2_train", main, startup, steps,
        fetch_list, ERNIE2_PER_STEP, TRAIN_FAMILIES)
    mixes = [[float(t.reshape(())) for t in f] for f in fetched]
    weights_read = all(
        abs(m[0] - float(np.dot(s["task_weight"], m[1:]))) <=
        1e-6 * abs(m[0]) for m, s in zip(mixes, steps))
    tasks = [int(np.argmax(s["task_weight"])) for s in steps]
    ok = ok and weights_read and len(set(tasks)) > 1
    emit(dict({"phase": "ernie2_train", "ok": ok, "model": "ernie2_base",
               "dtype": cfg.dtype, "batch": BF16_TRAIN_BATCH,
               "seq_len": TRAIN_SEQ, "max_preds": TRAIN_PREDS,
               "dropout": cfg.hidden_dropout, "optimizer": "Adam(1e-4)",
               "program_ops": _n_ops(_op_counts(main)),
               "op_counts": _op_counts(main), "tasks_by_step": tasks,
               "task_losses_by_step": mixes,
               "loss_is_the_fed_mix": weights_read,
               "samples_per_s_replays": BF16_TRAIN_BATCH /
               (record["replay_ms_median"] / 1e3)}, **record))
    if not ok:
        raise AssertionError("ernie2_train checks failed (see the line "
                             "above)")
    return launches


def ernie2_parity(torch, np, ptt):
    """A 2-layer bf16 ERNIE 2.0 at base width (dropout 0) three
    Adam(PARITY_LR) steps at PARITY_BATCH x 128, each fed the schedule's
    next task_weight, the card graphed against the CPU (PARITY_*)."""
    from paddle_tpu_torch.models import bert
    cfg = bert.bert_base(num_layers=PARITY_LAYERS, hidden_dropout=0.0,
                         attn_dropout=0.0, dtype="bfloat16")
    main, startup, fetch_list, feeds = _ernie2(ptt, bert, cfg, PARITY_BATCH,
                                               PARITY_LR)
    result, ok = _card_vs_cpu(np, ptt, main, startup, fetch_list,
                              feeds(PARITY_STEPS))
    emit(dict({"phase": "ernie2_parity", "ok": ok, "layers": PARITY_LAYERS,
               "batch": PARITY_BATCH, "seq_len": TRAIN_SEQ}, **result))
    if not ok:
        raise AssertionError("ernie2_parity checks failed (see the line "
                             "above)")


def _lac_program(ptt, sl, widths, lr=LAC_LR):
    """bigru_crf_program(**widths) with Adam(lr): (main, startup,
    [loss, decode])."""
    with ptt.unique_name.guard():
        main, startup, _, fetch = sl.bigru_crf_program(
            optimizer_fn=lambda loss: ptt.optimizer.Adam(lr).minimize(loss),
            **widths)
    startup.random_seed = SEED
    return main, startup, [fetch["loss"], fetch["decode"]]


def _lac_feed(sl, widths, batch, seed=0):
    return sl.synthetic_tagging_batch(batch, widths["seq_len"],
                                      widths["vocab_size"],
                                      widths["num_labels"], seed=seed)


def _dead_op_ids(main, fetch_list):
    """desc_ids of the global block's ops whose outputs reach neither a
    fetch nor a persistable: ops a run computes for nothing."""
    live = {v.name for v in fetch_list} | \
        {v.name for v in main.list_vars() if v.persistable}
    dead = set()
    for op in reversed(main.global_block().ops):
        if any(n in live for names in op.outputs.values() for n in names):
            live.update(n for names in op.inputs.values() for n in names)
        else:
            dead.add(op.desc_id)
    return dead


def _dead_kernels(by_op):
    """(calls, device ms, kernels) of the "dead:" rows of a
    _device_ms_by_op_type breakdown."""
    rows = [v for k, v in by_op["by_op_type"].items()
            if k.startswith("dead:")]
    return [sum(r[i] for r in rows) for i in range(3)]


def _paths_ok(np, paths, lens, num_labels):
    """Viterbi paths (N, T, 1) int64: labels in range, 0 past each
    length."""
    t = paths.shape[1]
    valid = np.arange(t)[None, :] < lens.reshape(-1, 1)
    return paths.dtype == np.int64 and paths.shape[2] == 1 and \
        int(paths.min()) >= 0 and int(paths.max()) < num_labels and \
        not paths[..., 0][~valid].any()


def _train_record(torch, np, exe, main, scope, feed, fetch_list, step_ms,
                  per_step, want, resident, peak):
    """What lac_train and ocr_train report alike: the step's host times
    (the first op by op, the second the capture), replays, launches (the
    first step's op by op, the others' graphed), the memory, two op-by-op
    steps timed, and one op-by-op step's device time and kernels by op
    type, basic_gru's unread last-state chain apart ("dead:"), with the
    op-by-op step's idle share."""
    def op_by_op():
        exe.run(main, feed=feed, fetch_list=fetch_list, scope=scope,
                use_program_cache=False)
    op_ms = _timed_runs(torch, op_by_op, 2)
    dead = _dead_op_ids(main, fetch_list)
    t0 = time.perf_counter()
    by_op = _device_ms_by_op_type(torch, op_by_op, dead)
    counts_ok = all(c == want for c in per_step)
    return counts_ok, {
        "op_by_op_ms": op_ms, "op_by_op_kernels": sum(
            v[2] for v in by_op["by_op_type"].values()),
        "op_by_op_idle_share": 1 - by_op["device_busy_ms"] /
        statistics.median(op_ms),
        "by_op_type_profile_s": time.perf_counter() - t0,
        "parameters": sum(int(np.prod(p.shape))
                          for p in main.all_parameters()),
        "program_ops": _n_ops(_op_counts(main)),
        "op_counts": _op_counts(main), "step_ms": step_ms,
        "first_run_host_ms": step_ms[0], "capture_run_ms": step_ms[1],
        "replay_ms_median": statistics.median(step_ms[2:]),
        "launches_per_step": per_step[-1],
        "launches_per_step_ok": counts_ok,
        "resident_gb": resident / 2 ** 30, "peak_mem_gb": peak / 2 ** 30,
        "captures": _capture_record(exe),
        "dead_ops": len(dead),
        "dead_ops_calls_ms_kernels_op_by_op": _dead_kernels(by_op),
        "device_ms_by_op_type_op_by_op": by_op}


def lac_train(torch, np, ptt, counters):
    """LAC's BiGRU-CRF at its published settings (LAC, LAC_BATCH,
    Adam(LAC_LR)), TRAIN_STEPS steps on one batch through Executor.run
    (graphed from the second): losses finite and falling, the Viterbi
    paths in range and 0 past each length, LAC_PER_STEP launches a step;
    words/s over the replays (batch x 64 padded words, and the valid
    words of ``lens``), the first run's host time, the tags the decode
    gets right, and an op-by-op step's device time and kernels by op
    type with the unread last-state chain apart."""
    from paddle_tpu_torch.models import sequence_labeling as sl
    t0 = time.perf_counter()
    main, startup, fetch_list = _lac_program(ptt, sl, LAC)
    feed = _lac_feed(sl, LAC, LAC_BATCH)
    scope, exe = ptt.Scope(), ptt.Executor()      # CUDAPlace(0)
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step_ms, fetched, per_step, launches = _fetch_steps(
        torch, ptt, counters, exe, main, scope, feed, fetch_list,
        TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(f[0].reshape(())) for f in fetched]
    valid = np.arange(LAC["seq_len"])[None, :] < feed["lens"]
    tag_accuracy = [float((f[1][..., 0] == feed["targets"])[valid].mean())
                    for f in fetched]
    paths_ok = all(_paths_ok(np, f[1], feed["lens"], LAC["num_labels"])
                   for f in fetched)
    finite = all(np.isfinite(losses))
    falling = losses[-1] < losses[0]
    counts_ok, record = _train_record(
        torch, np, exe, main, scope, feed, fetch_list, step_ms, per_step,
        _no_launches(counters, **LAC_PER_STEP), resident, peak)
    replay_s = record["replay_ms_median"] / 1e3
    ok = finite and falling and paths_ok and counts_ok
    emit(dict({"phase": "lac_train", "ok": ok, "model": "bigru_crf_lac",
               "batch": LAC_BATCH, "dtype": "float32",
               "optimizer": "Adam(%g)" % LAC_LR, "setup_s": setup_s,
               "valid_words": int(feed["lens"].sum()),
               "words_per_s_replays": LAC_BATCH * LAC["seq_len"] / replay_s,
               "valid_words_per_s_replays": int(feed["lens"].sum()) /
               replay_s, "losses": losses, "finite": finite,
               "falling": falling, "paths_ok": paths_ok,
               "tag_accuracy": tag_accuracy, "launches": launches},
              **dict(LAC, **record)))
    if not ok:
        raise AssertionError("lac_train checks failed (see the line above)")
    return launches, (exe, main, scope, feed, fetch_list)


def graph_lac(torch, np, ptt, counters):
    """lac_train's step GRAPH_STEPS runs op by op and graphed from one
    startup: the loss, the Viterbi paths and every parameter and Adam
    moment bit for bit equal, LAC_PER_STEP launches a step both ways; one
    run each way profiled (kernels a step, idle share)."""
    from paddle_tpu_torch.models import sequence_labeling as sl
    main, startup, fetch_list = _lac_program(ptt, sl, LAC)
    record, ok, _, _, launches = _both_ways(
        torch, np, ptt, counters, "graph_lac", main, startup,
        _lac_feed(sl, LAC, LAC_BATCH), fetch_list,
        _no_launches(counters, **LAC_PER_STEP), ("fused_adam",), mask=False)
    emit(dict({"phase": "graph_lac", "ok": ok, "model": "bigru_crf_lac",
               "batch": LAC_BATCH}, **record))
    if not ok:
        raise AssertionError("graph_lac checks failed (see the line above)")
    return launches


def lac_serve(torch, np, ptt, counters, model_dir, trained_scope):
    """lac_train's weights saved with save_inference_model(["words",
    "lens"], [decode]) and served through create_predictor on the card at
    LAC_SERVE_BATCHES (buckets LAC_BUCKETS): the pruned program reads
    neither ``targets`` nor the CRF loss and runs no last-state chain;
    paths in range and 0 past each length (batch 3 pads to 4 with a row
    of length 0), a warm request equal to its cold one, no hand-written
    kernel launched; batch 3 equal to the same directory served on the
    CPU, and batch 64's share of equal tags; then each bucket op by op
    and graphed (paths bit for bit equal, latency in turns,
    LAC_SERVE_REPS each way, a graphed request profiled)."""
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.models import sequence_labeling as sl
    main, _, fetch_list = _lac_program(ptt, sl, LAC)
    with ptt.scope_guard(trained_scope):
        ptt.save_inference_model(model_dir, ["words", "lens"],
                                 [fetch_list[1]], ptt.Executor(),
                                 main_program=main)
    config = Config(model_dir)
    config.batch_buckets = LAC_BUCKETS
    pred = create_predictor(config)
    ops = pred._program.global_block().ops
    types = sorted({o.type for o in ops})
    reads = {n for o in ops for names in o.inputs.values() for n in names}
    pruned_ok = "targets" not in reads and \
        not set(types) & {"linear_chain_crf", "stack", "one_hot", "matmul"}
    requests = {}
    for n in sorted(set(LAC_SERVE_BATCHES)):
        f = _lac_feed(sl, LAC, n, seed=n)
        requests[n] = {"words": f["words"], "lens": f["lens"]}
    counters.zero()                          # the main path starts here
    lat, served, warm_equal = [], {}, True
    for n in LAC_SERVE_BATCHES:
        t1 = time.perf_counter()
        out = pred.run(requests[n])          # numpy: synchronised
        lat.append((time.perf_counter() - t1) * 1e3)
        if n in served:
            warm_equal = warm_equal and np.array_equal(out[0], served[n])
        served[n] = out[0]
    launches = counters.read()
    shapes_ok = all(p.shape == (n, LAC["seq_len"], 1) and _paths_ok(
        np, p, requests[n]["lens"], LAC["num_labels"])
        for n, p in served.items())
    cpu_config = Config(model_dir)
    cpu_config.place = ptt.CPUPlace()
    cpu_pred = create_predictor(cpu_config)
    t2 = time.perf_counter()
    cpu3, = cpu_pred.run(requests[3])
    cpu_ms = (time.perf_counter() - t2) * 1e3
    cpu64, = cpu_pred.run(requests[LAC_BUCKETS[-1]])
    equal3 = np.array_equal(served[3], cpu3)
    valid64 = np.arange(LAC["seq_len"])[None, :] < \
        requests[LAC_BUCKETS[-1]]["lens"]
    share64 = float((served[LAC_BUCKETS[-1]] == cpu64)[..., 0][valid64]
                    .mean())
    exe, buckets = pred._exe, []
    for n in sorted(set(LAC_SERVE_BATCHES)):
        padded = {k: np.pad(v, [(0, pred._bucket(n) - n)] +
                            [(0, 0)] * (v.ndim - 1))
                  for k, v in requests[n].items()}

        def op_by_op(feed=padded):
            return exe.run(pred._program, feed=feed,
                           fetch_list=pred._fetch_names, scope=pred._scope,
                           use_program_cache=False)
        ways = (("op_by_op", op_by_op),
                ("graphed", lambda r=requests[n]: pred.run(r)))
        got = {w: fn()[0][:n] for w, fn in ways}
        ms = {w: [] for w, _ in ways}
        for _ in range(LAC_SERVE_REPS):
            for way, fn in ways:
                ms[way].extend(_timed_runs(torch, fn, 1))
        found = _profiled(torch, ways[1][1])
        found.pop("kernel_names")
        buckets.append({
            "batch": n, "bucket": pred._bucket(n),
            "paths_bit_equal": bool(np.array_equal(got["op_by_op"],
                                                   got["graphed"])),
            "request_ms": ms,
            "request_ms_median": {w: statistics.median(v)
                                  for w, v in ms.items()},
            "words_per_s_graphed": n * LAC["seq_len"] / (statistics.median(
                ms["graphed"]) / 1e3),
            "profile": found})
    ok = pruned_ok and shapes_ok and warm_equal and equal3 and \
        launches == _no_launches(counters) and \
        all(b["paths_bit_equal"] for b in buckets)
    emit({"phase": "lac_serve", "ok": ok, "model": "bigru_crf_lac",
          "buckets": list(LAC_BUCKETS),
          "request_batches": list(LAC_SERVE_BATCHES), "latency_ms": lat,
          "served_op_types": types, "served_ops": len(ops),
          "pruned_ok": pruned_ok, "shapes_paths_ok": shapes_ok,
          "warm_equals_cold": warm_equal, "launches": launches,
          "cpu_request_ms_batch_3": cpu_ms, "batch_3_equals_cpu": equal3,
          "batch_64_tags_equal_cpu_share": share64,
          "captures": _capture_record(exe), "by_bucket": buckets})
    close_executor(torch, "lac_serve", exe)
    if not ok:
        raise AssertionError("lac_serve checks failed (see the line above)")
    return launches


def lac_parity(torch, np, ptt):
    """LAC at LAC_PARITY, PARITY_STEPS Adam steps, the card graphed
    against the CPU from the same weights (LAC_PARITY_*): losses, the
    Viterbi paths and every persistable."""
    from paddle_tpu_torch.models import sequence_labeling as sl
    main, startup, fetch_list = _lac_program(ptt, sl, LAC_PARITY)
    feed = _lac_feed(sl, LAC_PARITY, LAC_PARITY_BATCH, seed=5)
    feed["lens"][-1] = 1                     # a row of length 1
    result, ok = _card_vs_cpu_all(
        np, ptt, main, startup, fetch_list, feed, [(1e-5, 0.0), (0.0, 0.0)],
        LAC_PARITY_RTOL, LAC_PARITY_ATOL)
    emit(dict({"phase": "lac_parity", "ok": ok,
               "batch": LAC_PARITY_BATCH}, **dict(LAC_PARITY, **result)))
    if not ok:
        raise AssertionError("lac_parity checks failed (see the line "
                             "above)")


def _ocr_program(ptt, ocr, widths, lr=OCR_LR):
    """crnn_ctc_program(**widths) with Adam(lr): (main, startup,
    [loss, logits])."""
    with ptt.unique_name.guard():
        main, startup, _, fetch = ocr.crnn_ctc_program(
            optimizer_fn=lambda loss: ptt.optimizer.Adam(lr).minimize(loss),
            **widths)
    startup.random_seed = SEED
    return main, startup, [fetch["loss"], fetch["logits"]]


def _ocr_feed(ocr, widths, batch, seed=0):
    return ocr.synthetic_ocr_batch(batch, widths["image_shape"],
                                   widths["num_classes"],
                                   widths["max_label"], seed=seed)


def _ctc_yardstick(torch, np, logits, feed, blank):
    """The port's warpctc op against F.ctc_loss (a yardstick only: the
    port never calls it) on the same logits (T, N, C) on the card: each
    one's forward and gradient to the logits, host ms a call (synchronised;
    the port's recursion is launch-bound), losses and gradients against
    each other."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import crf_ops
    dev = torch.device("cuda", 0)
    x0 = torch.tensor(logits, device=dev)
    label = torch.tensor(feed["label"], device=dev).long()
    lbl_len = torch.tensor(feed["label_len"].reshape(-1), device=dev)
    in_len = torch.full((x0.shape[1],), x0.shape[0], dtype=torch.long,
                        device=dev)

    def ours():
        x = x0.clone().requires_grad_()
        loss = crf_ops._warpctc(None, {
            "Logits": [x], "Label": [label], "LogitsLength": [in_len],
            "LabelLength": [lbl_len]}, {"blank": blank})["Loss"][:, 0]
        return loss, torch.autograd.grad(loss.sum(), x)[0]

    def library():
        x = x0.clone().requires_grad_()
        loss = F.ctc_loss(F.log_softmax(x, -1), label, in_len, lbl_len,
                          blank=blank, reduction="none")
        return loss, torch.autograd.grad(loss.sum(), x)[0]
    ms = {"warpctc": _timed_runs(torch, ours, 3),
          "F.ctc_loss": _timed_runs(torch, library, 3)}
    (lo, go), (ll, gl) = ours(), library()
    lo, ll = lo.detach(), ll.detach()
    return {"shape": list(x0.shape), "host_ms": ms,
            "loss_max_rel_diff": float(((lo - ll).abs() / ll.abs()).max()),
            "grad_max_abs_diff": float((go - gl).abs().max())}


def ocr_train(torch, np, ptt, counters):
    """CRNN-CTC at ocr_recognition's published settings (OCR, OCR_BATCH,
    Adam(OCR_LR)), TRAIN_STEPS steps on one batch through Executor.run
    (graphed from the second): losses finite and falling, OCR_PER_STEP
    launches a step op by op and graphed; images/s over the replays, the
    first run's host time, ``ctc_greedy_decode`` of the fetched logits on
    the host (ms, transcripts right), the warpctc op beside F.ctc_loss,
    an op-by-op step's device time and kernels by op type. ocr_parity
    holds the graphed steps against op by op, bit for bit; ``finish``
    profiles a replay (kernels, idle share)."""
    from paddle_tpu_torch.models import ocr
    t0 = time.perf_counter()
    main, startup, fetch_list = _ocr_program(ptt, ocr, OCR)
    feed = _ocr_feed(ocr, OCR, OCR_BATCH)
    scope, exe = ptt.Scope(), ptt.Executor()      # CUDAPlace(0)
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step_ms, fetched, per_step, launches = _fetch_steps(
        torch, ptt, counters, exe, main, scope, feed, fetch_list,
        TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(f[0].reshape(())) for f in fetched]
    logits = fetched[-1][1]
    blank = OCR["num_classes"]
    t1 = time.perf_counter()
    decoded = ocr.ctc_greedy_decode(logits, blank)
    decode_ms = (time.perf_counter() - t1) * 1e3
    truth = [[int(k) for k in row[:n]] for row, n in zip(
        feed["label"], feed["label_len"].reshape(-1))]
    finite = all(np.isfinite(losses)) and bool(np.isfinite(logits).all())
    falling = losses[-1] < losses[0]
    shapes_ok = logits.shape == (OCR["image_shape"][2], OCR_BATCH,
                                 blank + 1)
    want = _no_launches(counters, **OCR_PER_STEP)
    counts_ok, record = _train_record(
        torch, np, exe, main, scope, feed, fetch_list, step_ms, per_step,
        want, resident, peak)
    t2 = time.perf_counter()
    yardstick = _ctc_yardstick(torch, np, logits, feed, blank)
    yardstick["seconds"] = time.perf_counter() - t2
    replay_s = record["replay_ms_median"] / 1e3
    ok = finite and falling and shapes_ok and counts_ok
    emit(dict({"phase": "ocr_train", "ok": ok, "model": "crnn_ctc",
               "batch": OCR_BATCH, "time_steps": OCR["image_shape"][2],
               "dtype": "float32", "optimizer": "Adam(%g)" % OCR_LR,
               "setup_s": setup_s,
               "images_per_s_replays": OCR_BATCH / replay_s,
               "losses": losses, "finite": finite, "falling": falling,
               "greedy_decode_host_ms": decode_ms,
               "transcripts_right": sum(d == t for d, t in zip(decoded,
                                                               truth)),
               "decoded_row_0": decoded[0], "truth_row_0": truth[0],
               "ctc_yardstick": yardstick, "launches": launches},
              **dict(OCR, **record)))
    if not ok:
        raise AssertionError("ocr_train checks failed (see the line above)")
    return launches, (exe, main, scope, feed, fetch_list)


def ocr_parity(torch, np, ptt):
    """CRNN-CTC at OCR_PARITY, PARITY_STEPS Adam(PARITY_LR) steps, the card
    graphed against the CPU from the same weights (OCR_PARITY_*)."""
    from paddle_tpu_torch.models import ocr
    main, startup, fetch_list = _ocr_program(ptt, ocr, OCR_PARITY,
                                             lr=PARITY_LR)
    feed = _ocr_feed(ocr, OCR_PARITY, OCR_PARITY_BATCH, seed=5)
    result, ok = _card_vs_cpu_all(
        np, ptt, main, startup, fetch_list[:1], feed, [(1e-5, 0.0)],
        OCR_PARITY_RTOL, OCR_PARITY_ATOL)
    emit(dict({"phase": "ocr_parity", "ok": ok,
               "batch": OCR_PARITY_BATCH}, **dict(OCR_PARITY, **result)))
    if not ok:
        raise AssertionError("ocr_parity checks failed (see the line "
                             "above)")


def _losses_of(np, exe):
    """Record the loss (the first fetch) of every step ``exe`` runs for
    the trainer, step by step or in a run_steps window; returns the
    list it appends to."""
    losses = []
    run, run_steps = exe.run, exe.run_steps

    def recorded(*args, **kwargs):
        out = run(*args, **kwargs)
        if out:
            losses.append(float(np.asarray(out[0]).reshape(())))
        return out

    def recorded_steps(*args, **kwargs):
        out = run_steps(*args, **kwargs)
        losses.extend(float(v) for v in np.asarray(out[0]).reshape(-1))
        return out
    exe.run, exe.run_steps = recorded, recorded_steps
    return losses


def _pass(torch, counters, fn):
    """One pass of ``fn``, the launch counters set to 0 just before and
    read just after: (seconds, launches, what ``fn`` returned)."""
    counters.zero()                          # the main path starts here
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, counters.read(), out


def _sum_launches(*launches):
    return {k: sum(d[k] for d in launches) for k in launches[0]}


def _snapshot(torch, scope):
    return {n: v.clone() if isinstance(v, torch.Tensor) else v
            for n, v in scope.items()}


def _restore(torch, scope, snap):
    """``snap``'s values back into ``scope``, each tensor copied into the
    scope's own (a captured step's static inputs stay its inputs)."""
    for n, v in snap.items():
        cur = scope.find_var(n)
        if isinstance(v, torch.Tensor) and isinstance(cur, torch.Tensor):
            cur.copy_(v)
        else:
            scope.set_var(n, v)


def _deepfm_records(deepfm, root):
    """DATASET_BATCHES synthetic_batch batches (seeds 0, 1, ...) written a
    sample a record, batch b into file b % DATASET_FILES, with the port's
    RecordWriter: (paths, records, seconds)."""
    from paddle_tpu_torch.native import RecordWriter
    os.makedirs(root, exist_ok=True)
    names = ("dense_input", "sparse_input", "label")
    paths = [os.path.join(root, "ctr-%d.ptrec" % i)
             for i in range(DATASET_FILES)]
    writers = [RecordWriter(p) for p in paths]
    n, t0 = 0, time.perf_counter()
    try:
        for b in range(DATASET_BATCHES):
            batch = deepfm.synthetic_batch(
                DEEPFM_BATCH, feature_dim=DEEPFM_FEATURES, seed=b)
            w = writers[b % DATASET_FILES]
            for i in range(DEEPFM_BATCH):
                w.write_sample([batch[k][i] for k in names])
                n += 1
    finally:
        for w in writers:
            w.close()
    return paths, n, time.perf_counter() - t0


def dataset_deepfm(torch, np, ptt, counters):
    """DeepFM at bench.py:565-578 fed from record files through an
    InMemoryDataset (DATASET_* above): examples/s of train_from_dataset
    step by step and windowed, of DataLoader with exe.run and of one
    pre-staged batch, side by side; the C++ plane's own rates (reading,
    loading, collating, no step) and its build seconds; the idle share of
    a train_from_dataset pass. Checks: the C++ plane read every record,
    11 fused-Adam launches a training step whatever the feed (none in
    inference), the windowed pass equal to the step-by-step one bit for
    bit from the same start, losses finite and the second pass's mean
    below the first's."""
    from paddle_tpu_torch.models import deepfm
    from paddle_tpu_torch.native import RecordReader, build as plane
    t0 = time.perf_counter()
    plane.load_dataplane()                   # DataPlaneBuildError if not
    plane_s = time.perf_counter() - t0
    kw = dict(feature_dim=DEEPFM_FEATURES, embedding_size=DEEPFM_EMBEDDING)
    main, startup, fetch_list, _, _ = _deepfm_program(
        np, ptt, deepfm, DEEPFM_BATCH, **kw)
    fetch_list = fetch_list[:2]              # loss, auc
    use = [main.global_block().var(n)
           for n in ("dense_input", "sparse_input", "label")]
    root = os.path.join(_ROOT, "build", "chip_smoke_data", "deepfm")
    paths, written, write_s = _deepfm_records(deepfm, root)
    t0 = time.perf_counter()
    read = sum(1 for _ in RecordReader(
        paths, num_threads=DATASET_THREADS).samples())
    read_s = time.perf_counter() - t0
    ds = ptt.DatasetFactory().create_dataset("InMemoryDataset")
    ds.set_filelist(paths)
    ds.set_batch_size(DEEPFM_BATCH)
    ds.set_thread(DATASET_THREADS)
    ds.set_use_var(use)
    t0 = time.perf_counter()
    ds.load_into_memory()
    load_s = time.perf_counter() - t0
    ds.global_shuffle()
    t0 = time.perf_counter()
    batches = list(ds)
    collate_s = time.perf_counter() - t0

    scope, exe = ptt.Scope(), ptt.Executor()
    exe.run(startup, scope=scope)
    losses = _losses_of(np, exe)

    def train(**extra):
        return exe.train_from_dataset(main, ds, scope=scope,
                                      fetch_list=fetch_list, **extra)
    feeds = {}

    def record(name, seconds, launches, steps, last=None):
        feeds[name] = {"seconds": seconds, "steps": steps,
                       "examples_per_s": steps * DEEPFM_BATCH / seconds,
                       "launches": launches, "losses": losses[:],
                       "last": None if last is None else
                       [float(np.asarray(v).reshape(-1)[0]) for v in last]}
        del losses[:]
    s, n, (steps, last) = _pass(torch, counters, train)
    record("train_from_dataset_warm", s, n, steps, last)
    start = _snapshot(torch, scope)
    s, n, (steps, step_last) = _pass(torch, counters, train)
    record("train_from_dataset", s, n, steps, step_last)
    per_step_state = _snapshot(torch, scope)
    _restore(torch, scope, start)
    s, n, (steps, win_last) = _pass(torch, counters, lambda: train(
        steps_per_dispatch=DATASET_WINDOW))
    record("train_from_dataset_windowed", s, n, steps, win_last)
    unequal = [k for k, v in per_step_state.items()
               if isinstance(v, torch.Tensor) and
               not torch.equal(v, scope.find_var(k))]
    windowed_equal = not unequal and feeds["train_from_dataset"][
        "losses"] == feeds["train_from_dataset_windowed"]["losses"] and \
        all(np.array_equal(a, b) for a, b in zip(step_last, win_last))

    loader = ptt.reader.DataLoader.from_generator(feed_list=use,
                                                   capacity=4)
    loader.set_batch_generator(lambda: (
        (b["dense_input"], b["sparse_input"], b["label"]) for b in ds))

    def fed(feed_iter):
        n = 0
        for feed in feed_iter:
            exe.run(main, feed=feed, fetch_list=fetch_list, scope=scope)
            n += 1
        return n
    s, n, steps = _pass(torch, counters, lambda: fed(loader()))
    record("dataloader", s, n, steps)
    s, n, steps = _pass(torch, counters, lambda: fed(
        [batches[0]] * DATASET_BATCHES))
    record("pre_staged", s, n, steps)

    with ptt.unique_name.guard():
        imain, _, _, ifetch = deepfm.deepfm_train_program(is_test=True,
                                                          **kw)
    s, n, (steps, last) = _pass(torch, counters, lambda: (
        exe.infer_from_dataset(imain, ds, scope=scope, fetch_list=[
            ifetch["loss"], ifetch["auc"]])))
    record("infer_from_dataset", s, n, steps, last)
    found = _profiled(torch, train)
    found.pop("kernel_names")
    del losses[:]

    train_feeds = [k for k in feeds if k != "infer_from_dataset"]
    want = _no_launches(counters, fused_adam=DEEPFM_PER_STEP["fused_adam"]
                        * DATASET_BATCHES)
    launches_ok = all(feeds[k]["launches"] == want for k in train_feeds) \
        and feeds["infer_from_dataset"]["launches"] == _no_launches(counters)
    steps_ok = all(f["steps"] == DATASET_BATCHES for f in feeds.values())
    all_losses = [v for k in train_feeds for v in feeds[k]["losses"]]
    finite = bool(np.isfinite(all_losses).all()) and all(
        np.isfinite(v) for f in feeds.values() for v in (f["last"] or []))
    falling = statistics.mean(feeds["train_from_dataset"]["losses"]) < \
        statistics.mean(feeds["train_from_dataset_warm"]["losses"])
    total = DATASET_BATCHES * DEEPFM_BATCH
    plane_ok = plane.native_available() and read == written == total \
        and ds.get_memory_data_size() == total
    ok = plane_ok and launches_ok and steps_ok and windowed_equal and \
        finite and falling
    emit({"phase": "dataset_deepfm", "ok": ok, "model": "deepfm",
          "feature_dim": DEEPFM_FEATURES, "embedding": DEEPFM_EMBEDDING,
          "batch": DEEPFM_BATCH, "batches": DATASET_BATCHES,
          "files": DATASET_FILES, "threads": DATASET_THREADS,
          "window": DATASET_WINDOW,
          "examples_per_s": {k: f["examples_per_s"]
                             for k, f in feeds.items()},
          "feeds": feeds,
          "dataplane": {"native": plane.native_available(),
                        "library": plane.library_path(),
                        "build_s": plane.build_seconds, "load_s": plane_s,
                        "records_written": written, "write_s": write_s,
                        "records_read": read, "read_samples_per_s":
                        read / read_s, "load_into_memory_samples_per_s":
                        total / load_s, "collate_samples_per_s":
                        total / collate_s, "ok": plane_ok},
          "windowed_equals_per_step": windowed_equal,
          "unequal": unequal[:8], "launches_ok": launches_ok,
          "steps_ok": steps_ok, "finite": finite, "falling": falling,
          "graph_runs": exe.graph_runs, "captures": _capture_record(exe),
          "profile_train_from_dataset_pass": found})
    close_executor(torch, "dataset_deepfm", exe)
    if not ok:
        raise AssertionError("dataset_deepfm checks failed (see the line "
                             "above)")
    return _sum_launches(*[feeds[k]["launches"] for k in feeds])


def _bucketed_program(ptt):
    """bench.py's bench_bucketed_training model at BUCKETED:
    (main, startup, [ids, label], loss)."""
    layers, c = ptt.layers, BUCKETED
    main, startup = ptt.Program(), ptt.Program()
    with ptt.unique_name.guard(), ptt.program_guard(main, startup):
        ids = layers.data("ids", [-1], dtype="int64")
        label = layers.data("label", [1], dtype="int64")
        emb = layers.embedding(ids, size=[c["vocab"], c["hidden"]])
        mask = layers.cast(
            layers.not_equal(ids, layers.zeros_like(ids)), "float32")
        h = emb
        for _ in range(c["n_layers"]):
            h = layers.fc(h, c["hidden"], num_flatten_dims=2, act="gelu")
        pooled = layers.reduce_sum(h * layers.unsqueeze(mask, [2]), dim=1)
        logits = layers.fc(pooled, size=2)
        loss = layers.reduce_mean(
            layers.softmax_with_cross_entropy(logits, label))
        ptt.optimizer.Adam(1e-3).minimize(loss)
    startup.random_seed = SEED
    return main, startup, [ids, label], loss


def _bucketed_text(np, root):
    """bench.py:755-760's samples (seed 0) written as MultiSlot text by
    the port's data generator: (path, lengths, seconds)."""
    from paddle_tpu_torch.incubate.data_generator import \
        MultiSlotDataGenerator
    c = BUCKETED
    rng = np.random.RandomState(0)
    lengths = []

    class Gen(MultiSlotDataGenerator):
        def generate_sample(self, line):
            def it():
                for _ in range(c["batch"] * c["n_batches"]):
                    ln = int(np.clip(rng.geometric(
                        1.0 / (c["max_len"] // 8)), 4, c["max_len"]))
                    lengths.append(ln)
                    ids = rng.randint(1, c["vocab"], (ln,))
                    label = rng.randint(0, 2, (1,))
                    yield [("ids", ids.tolist()), ("label", label.tolist())]
            return it
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "bucketed.txt")
    t0 = time.perf_counter()
    with open(path, "w") as f:
        Gen().run_from_memory(write=f.write)
    return path, lengths, time.perf_counter() - t0


def bucketed_train(torch, np, ptt, counters):
    """bench.py's bucketed-training metric at its on-chip settings
    (BUCKETED): MultiSlot text through a QueueDataset with length
    buckets (the C++ parse), run_pass's warm pass and best of
    BUCKETED_TIMED train_from_dataset passes, bucketed and at
    (max_len,); the bucketed / max-len samples/s ratio with both rates,
    each pass's graph keys and how many of its steps ran op by op, were
    captured or replayed, and one more pass profiled (device time by
    kernel family, idle share). Checks: every pass ran every batch,
    losses finite, 11 Adam launches a step, no captured step holds the
    unread ``ids__lens`` feed."""
    c = BUCKETED
    root = os.path.join(_ROOT, "build", "chip_smoke_data", "bucketed")
    path, lengths, write_s = _bucketed_text(np, root)
    n_samples = len(lengths)
    results, launches, ok = {}, [], True
    for label, bucket_list in (("bucketed", c["buckets"]),
                               ("max_len", (c["max_len"],))):
        main, startup, use, loss = _bucketed_program(ptt)
        ds = ptt.DatasetFactory().create_dataset("QueueDataset")
        ds.set_filelist([path])
        ds.set_batch_size(c["batch"])
        ds.set_use_var(use)
        ds.set_length_buckets(bucket_list, by="ids")
        widths = {}
        for b in ds:
            w = (b["ids"].shape[1], b["ids"].shape[0])
            widths[w] = widths.get(w, 0) + 1
        scope, exe = ptt.Scope(), ptt.Executor()
        exe.run(startup, scope=scope)
        passes = []
        for _ in range(1 + BUCKETED_TIMED):
            before = dict(exe.graph_runs)
            s, n, (steps, last) = _pass(torch, counters, lambda: (
                exe.train_from_dataset(main, ds, scope=scope,
                                       fetch_list=[loss])))
            launches.append(n)
            runs = {k: exe.graph_runs[k] - before[k] for k in before}
            passes.append({
                "seconds": s, "steps": steps,
                "samples_per_s": n_samples / s,
                "loss": float(np.asarray(last[0]).reshape(())),
                "graph_runs": runs,
                "graph_share": (runs["capture"] + runs["replay"]) / steps,
                "graph_keys": len(exe._graphs),
                "launches_ok": n == _no_launches(
                    counters, fused_adam=BUCKETED_PER_STEP["fused_adam"]
                    * steps)})
        feeds_ok = all(set(cap["feeds"]) == {"ids", "label"}
                       for cap in exe.capture_log)
        found = _profiled(torch, lambda: exe.train_from_dataset(
            main, ds, scope=scope, fetch_list=[loss]))
        found["kernel_names"] = len(found["kernel_names"])
        best = min(p["seconds"] for p in passes[1:])
        case_ok = feeds_ok and all(
            p["steps"] == sum(widths.values()) and p["launches_ok"] and
            np.isfinite(p["loss"]) for p in passes)
        ok = ok and case_ok
        results[label] = {
            "ok": case_ok, "buckets": list(bucket_list),
            "samples_per_s": n_samples / best,
            "batches_by_width_and_size": {
                "%dx%d" % (sz, w): k for (w, sz), k in sorted(
                    widths.items())},
            "passes": passes, "captured_feeds_lack_lens": feeds_ok,
            "captures": _capture_record(exe), "profile_pass": found}
        close_executor(torch, "bucketed_train " + label, exe)
    ratio = results["bucketed"]["samples_per_s"] / \
        results["max_len"]["samples_per_s"]
    emit({"phase": "bucketed_train", "ok": ok,
          "metric": "length-bucketed training speedup vs max-len padding",
          "value": ratio, "unit": "x",
          "bucketed_sps": results["bucketed"]["samples_per_s"],
          "maxlen_sps": results["max_len"]["samples_per_s"],
          "settings": c, "samples": n_samples,
          "mean_length": float(np.mean(lengths)), "write_s": write_s,
          "runs": results})
    if not ok:
        raise AssertionError("bucketed_train checks failed (see the line "
                             "above)")
    return _sum_launches(*launches)


def py_reader_bert(torch, np, ptt, counters):
    """BERT-base pretraining at train_bf16's settings fed by a py_reader
    (create_py_reader_by_data over the program's feeds,
    decorate_tensor_provider over PY_READER_BATCHES batches, start;
    exe.run with no feed until EOFException; reset; a second epoch),
    graphed; against the same batches fed (graphed) and one epoch op by
    op from the same start. Checks: EOF after exactly
    PY_READER_BATCHES runs an epoch; every fetch of both epochs and the
    final state equal to the fed run's bit for bit (no batch lost, stale
    or out of order across the reset); the first epoch equal to op by op
    bit for bit; train_bf16's launches every step. Reports the replayed
    step's ms beside the fed one's."""
    from paddle_tpu_torch.models import bert
    t0 = time.perf_counter()
    cfg = bert.bert_base(dtype="bfloat16")
    main, startup, fetch_list = _pretrain_program(ptt, bert, cfg,
                                                  BF16_TRAIN_BATCH)
    batches = [bert.synthetic_batch(cfg, BF16_TRAIN_BATCH, TRAIN_SEQ,
                                    TRAIN_PREDS, seed=k)
               for k in range(PY_READER_BATCHES)]
    names = sorted(batches[0])
    with ptt.program_guard(main, startup):
        reader = ptt.layers.create_py_reader_by_data(
            PY_READER_CAPACITY, [main.global_block().var(n) for n in names])
    reader.decorate_tensor_provider(lambda: (
        tuple(b[n] for n in names) for b in batches))
    start = ptt.Scope()
    ptt.Executor().run(startup, scope=start)   # no fetch list: no graph
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    persist = [v.name for v in main.list_vars() if v.persistable]

    def drive(epochs, fed=False, cache=True):
        scope, exe = _copy_scope(torch, ptt, start), ptt.Executor()
        fetched, step_ms, per_step, per_epoch = [], [], [], []
        counters.zero()                      # the main path starts here
        for _ in range(epochs):
            if not fed:
                reader.start()
            n = 0
            while not fed or n < len(batches):
                before = counters.read()
                t1 = time.perf_counter()
                try:
                    out = exe.run(main, feed=batches[n] if fed else None,
                                  fetch_list=fetch_list, scope=scope,
                                  use_program_cache=cache)
                except ptt.layers.EOFException:
                    break
                step_ms.append((time.perf_counter() - t1) * 1e3)
                after = counters.read()
                per_step.append({k: after[k] - before[k] for k in after})
                fetched.append(out)
                n += 1
            per_epoch.append(n)
            if not fed:
                reader.reset()
        return {"exe": exe, "scope": scope, "fetched": fetched,
                "step_ms": step_ms, "per_step": per_step,
                "runs_per_epoch": per_epoch, "launches": counters.read()}
    ways = {"py_reader": drive(2), "fed": drive(2, fed=True)}
    a, b = ways["py_reader"], ways["fed"]
    fed_equal = len(a["fetched"]) == len(b["fetched"]) and all(
        np.array_equal(x, y) for fa, fb in zip(a["fetched"], b["fetched"])
        for x, y in zip(fa, fb))
    state_unequal = [n for n in persist if not torch.equal(
        a["scope"].find_var(n), b["scope"].find_var(n))]
    for way in ("py_reader", "fed"):
        close_executor(torch, "py_reader_bert " + way, ways[way].pop("exe"))
        ways[way].pop("scope")
    ways["op_by_op"] = c = drive(1, cache=False)
    close_executor(torch, "py_reader_bert op_by_op", c.pop("exe"))
    c.pop("scope")
    op_equal = all(np.array_equal(x, y) for fa, fc in zip(
        a["fetched"], c["fetched"]) for x, y in zip(fa, fc))
    eof_ok = a["runs_per_epoch"] == [PY_READER_BATCHES] * 2 and \
        c["runs_per_epoch"] == [PY_READER_BATCHES]
    counts_ok = all(s == TRAIN_PER_STEP for w in ways.values()
                    for s in w["per_step"])
    losses = {w: [float(np.asarray(f[0]).reshape(())) for f in v["fetched"]]
              for w, v in ways.items()}
    finite = all(np.isfinite(v) for ls in losses.values() for v in ls)
    ok = fed_equal and not state_unequal and op_equal and eof_ok and \
        counts_ok and finite
    replays = {w: statistics.median(ways[w]["step_ms"][2:])
               for w in ("py_reader", "fed")}
    emit({"phase": "py_reader_bert", "ok": ok, "model": "bert_base",
          "dtype": cfg.dtype, "batch": BF16_TRAIN_BATCH,
          "seq_len": TRAIN_SEQ, "batches_per_epoch": PY_READER_BATCHES,
          "capacity": PY_READER_CAPACITY, "setup_s": setup_s,
          "replay_ms_median": replays,
          "py_reader_over_fed": replays["py_reader"] / replays["fed"],
          "step_ms": {w: v["step_ms"] for w, v in ways.items()},
          "runs_per_epoch": {w: v["runs_per_epoch"]
                             for w, v in ways.items()},
          "eof_ok": eof_ok, "equal_to_fed_bit_for_bit": fed_equal,
          "state_unequal": state_unequal[:8],
          "first_epoch_equal_to_op_by_op": op_equal,
          "launches_per_step": {w: v["per_step"][-1]
                                for w, v in ways.items()},
          "launches_per_step_ok": counts_ok, "losses": losses,
          "finite": finite})
    if not ok:
        raise AssertionError("py_reader_bert checks failed (see the line "
                             "above)")
    return _sum_launches(a["launches"], b["launches"], c["launches"])


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
                     ("fprop", "conv (cuDNN)"), ("dgrad", "conv (cuDNN)"),
                     ("wgrad", "conv (cuDNN)"), ("conv", "conv (cuDNN)"),
                     ("cudnn", "conv (cuDNN)"),
                     ("nchwtonhwc", "conv (cuDNN)"),
                     ("nhwctonchw", "conv (cuDNN)"),
                     ("pool", "pool"),
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
    (``idle_share_unprofiled``); every kernel's name. A profiled run that
    records no device event is profiled again, up to PROFILE_ATTEMPTS
    runs in all (``profile_attempts``); a profiler that still records no
    device time is reported, not failed."""
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
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_family, top, names, kernels = {}, [], set(), 0
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            ms = e.self_device_time_total / 1e3
            fam = _family(e.key)
            by_family[fam] = by_family.get(fam, 0.0) + ms
            top.append([ms, e.count, e.key[:100]])
            names.add(e.key[:120])
            kernels += e.count
        if kernels:
            break
    busy = sum(by_family.values())
    return {"host_ms": wall_ms, "device_kernels": kernels,
            "profile_attempts": attempt,
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

    def finish(path, done, label, host=False, profiled=True):
        """A training path: its launches kept, one more step profiled (a
        replay; not if ``profiled`` is False: another phase profiles the
        path) and, with ``host``, one op by op with each op's dispatch
        timed; then its Executor closed."""
        by_path[path] = None if done is None else done[0]
        if done is None:
            return
        exe, main_prog, scope, feed, fetch_list = done[1][:5]

        def step(cache=True):
            exe.run(main_prog, feed=feed, fetch_list=fetch_list, scope=scope,
                    use_program_cache=cache)
        if profiled:
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
    by_path["train_state"] = phase("train_state")(train_state)(
        torch, np, ptt, counters)
    by_path["graph_gpt"] = phase("graph_gpt")(graph_gpt)(torch, np, ptt,
                                                         counters)
    resnet_done = phase("resnet_train")(resnet_train)(torch, np, ptt,
                                                      counters)
    finish("resnet_train", resnet_done, "resnet train step")
    resnet_dir = os.path.join(_ROOT, "build", "chip_smoke_resnet")
    try:
        by_path["resnet_serve"] = phase("resnet_serve")(resnet_serve)(
            torch, np, ptt, counters, resnet_dir,
            None if resnet_done is None else resnet_done[1][2])
    finally:
        shutil.rmtree(resnet_dir, ignore_errors=True)
    del resnet_done
    by_path["graph_resnet"] = phase("graph_resnet")(graph_resnet)(
        torch, np, ptt, counters)
    phase("resnet_parity")(resnet_parity)(torch, np, ptt)
    finish("deepfm_train", phase("deepfm_train")(deepfm_train)(
        torch, np, ptt, counters), "deepfm train step")
    phase("deepfm_parity")(deepfm_parity)(torch, np, ptt)
    finish("transformer_train", phase("transformer_train")(
        transformer_train)(torch, np, ptt, counters),
        "transformer train step")
    by_path["graph_transformer"] = phase("graph_transformer")(
        graph_transformer)(torch, np, ptt, counters)
    beam_dir = os.path.join(_ROOT, "build", "chip_smoke_beam")
    try:
        by_path["transformer_serve"] = phase("transformer_serve")(
            transformer_serve)(torch, np, ptt, counters, beam_dir)
    finally:
        shutil.rmtree(beam_dir, ignore_errors=True)
    phase("transformer_parity")(transformer_parity)(torch, np, ptt)
    by_path["ernie2_train"] = phase("ernie2_train")(ernie2_train)(
        torch, np, ptt, counters)
    phase("ernie2_parity")(ernie2_parity)(torch, np, ptt)
    lac_done = phase("lac_train")(lac_train)(torch, np, ptt, counters)
    finish("lac_train", lac_done, "lac train step", host=True,
           profiled=False)
    by_path["graph_lac"] = phase("graph_lac")(graph_lac)(torch, np, ptt,
                                                         counters)
    lac_dir = os.path.join(_ROOT, "build", "chip_smoke_lac")
    try:
        by_path["lac_serve"] = phase("lac_serve")(lac_serve)(
            torch, np, ptt, counters, lac_dir,
            None if lac_done is None else lac_done[1][2])
    finally:
        shutil.rmtree(lac_dir, ignore_errors=True)
    del lac_done
    phase("lac_parity")(lac_parity)(torch, np, ptt)
    finish("ocr_train", phase("ocr_train")(ocr_train)(
        torch, np, ptt, counters), "ocr train step", host=True)
    phase("ocr_parity")(ocr_parity)(torch, np, ptt)
    data_root = os.path.join(_ROOT, "build", "chip_smoke_data")
    try:
        by_path["dataset_deepfm"] = phase("dataset_deepfm")(
            dataset_deepfm)(torch, np, ptt, counters)
        by_path["bucketed_train"] = phase("bucketed_train")(
            bucketed_train)(torch, np, ptt, counters)
    finally:
        shutil.rmtree(data_root, ignore_errors=True)
    by_path["py_reader_bert"] = phase("py_reader_bert")(py_reader_bert)(
        torch, np, ptt, counters)

    emit({"phase_seconds": _seconds})
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
    with the AdamW launches of the recipe's path, and its DeepFM case's
    (``deepfm_embedding``: the 1,000,000 x 10 table) with the launches
    of deepfm_train."""
    head = cases[0]
    line = {"name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(launches_by_path.values()),
            "launches_by_path": launches_by_path,
            "max_abs_err": head["max_abs_err"], "ms": head["kernel_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head.get("shape", head.get("numel")), "cases": cases}
    keys = ("name", "max_abs_err", "kernel_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    adamw = [c for c in cases if c.get("coeff")]
    if adamw:
        line["adamw"] = dict({k: adamw[0][k] for k in keys + ("coeff",)},
                             launches=launches_by_path.get("train_recipe"))
    deepfm = [c for c in cases if c["name"] == "deepfm_embedding"]
    if deepfm:
        line["deepfm_embedding"] = dict(
            {k: deepfm[0][k] for k in keys + ("numel",)},
            launches=launches_by_path.get("deepfm_train"))
    return line


if __name__ == "__main__":
    sys.exit(main())
