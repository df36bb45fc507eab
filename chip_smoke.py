#!/usr/bin/env python3
"""Drive paddle_tpu_torch's main paths on one CUDA card and check them.

    python3 chip_smoke.py

run from the root of a checkout, on a machine with an NVIDIA H100 (any
sm_90 card), ``nvcc`` and PyTorch built for CUDA. It builds the port's
CUDA kernels from ``paddle_tpu_torch/ops/kernels/csrc/`` and holds each
of the thirteen (the eleven of the JAX package's Pallas sites and the
numeric guard's two) against its plain PyTorch version at the main
paths' shapes
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

Then the control-flow layers and the RNN API: an LSTM seq2seq built
from ``layers.rnn`` and ``dynamic_decode(BeamSearchDecoder)`` (no model
module; ``_seq2seq_programs``) at PaddleNLP seq2seq's IWSLT'15 en->vi
settings, and the functional control flow on CUDA tensors:

- ``seq2seq_train``: 2 + 2 LSTM layers of width 512, vocabularies 17191
  and 7709, batch 128 x 50 source and 50 target tokens, Adam(1e-3) with
  a global-norm clip of 5, six steps graphed from the third: losses
  finite and falling, 11 fused-Adam launches a step, no capture refused;
  target tokens/s, an op-by-op step's device time by op type.
- ``seq2seq_serve``: the trained beam decode (beam 10, 50 unrolled
  steps) saved with save_inference_model and served through
  create_predictor at batches 128 and 16, each cold (op by op), captured
  and replayed: a replay equal to the cold run bit for bit, ids in range,
  an ended beam emitting only the end token, beams best first, no
  hand-written kernel launched; sentences/s.
- ``control_flow``: ``cond``, ``switch_case`` and ``while_loop`` on CUDA
  tensors (a program the Executor never captures: each run op by op,
  the refusal recorded naming the op, the answers equal to the CPU's);
  and ``bounded_while``, ``StaticRNN`` and ``select_input`` in a
  training step (Adam), op by op against graphed, bit for bit.
- ``seq2seq_parity``: the seq2seq at narrow widths, three Adam steps and
  a beam decode, card graphed against the CPU.

Then the rest of the model zoo (no hand-written kernel but fused Adam:
the JAX package computes these ops with ``lax`` and ``jnp``), each step
graphed from its key's second run and one replay held against an
op-by-op step bit for bit:

- ``vision_train``: MobileNet v1, VGG-16 and SE-ResNeXt-50 at
  bench.py:472-486's ResNet-50 settings (batch 128 x 3 x 224 x 224, 1000
  classes, Momentum(0.1, 0.9); VGG-16 at 0.01), six steps each: losses
  finite, the first update lowering the loss, no hand-written kernel;
  images/s, peak memory above resident, the capture's time, the step's
  f32 FFMA bound, SE-ResNeXt-50's op-by-op step's device time by op type.
- ``yolo_train``: YOLOv3 (darknet-53) at PaddleCV yolov3's training
  settings (608 x 608, 80 classes, 50 boxes, batch 8, Momentum(0.001,
  0.9) with L2Decay(5e-4)), six steps, the same checks; images/s.
- ``yolo_serve``: the inference program (conf 0.005, 400 candidates a
  class, 100 kept, IoU 0.45), its weights seeded and its batch-norm
  statistics calibrated by forward runs, saved and served through
  create_predictor
  at batches 1 and 8, each cold, captured and replayed: replays equal the
  cold answer bit for bit, the card's pre-NMS boxes and scores within
  tolerance of the CPU's, the card's NMS equal to the plain NMS run on
  its own pre-NMS tensors; ms and kernels a request, the NMS alone.
- ``dcgan_train``: the MNIST DCGAN (100-d noise, 64 / 128 channels, 28 x
  28 x 1, batch 128, Adam(2e-4, beta1 0.5) for each player), six steps:
  d_loss and g_loss finite, 16 fused-Adam launches a step.
- ``simple_train``: the book's MLP (784-200-200-10) and word2vec (2073
  words, width 32, window 2) at batch 128 with Adam(1e-3), three steps
  each: 6 and 3 fused-Adam launches a step.
- ``zoo_parity``: each model narrow (MobileNet's first blocks at scale
  0.25, VGG-11, one SE bottleneck, tiny YOLOv3 trained and served, DCGAN
  at width 8), card graphed against CPU; DCGAN's is the check that shows
  the in-place rule on the card (its generator's backward runs after the
  discriminator's in-place Adam).

Then training that survives faults (the recipe step of train_recipe,
its decay over GUARD_DECAY_STEPS runs):

- ``compiled_recipe``: the recipe through ``CompiledProgram(main)
  .with_data_parallel(loss_name=, build_strategy=BuildStrategy(),
  exec_strategy=ExecutionStrategy())``, through ``ParallelExecutor`` and
  with ``check_numerics=True``, six steps each, equal to
  ``Executor.run``'s fetches and persistables bit for bit, the launches
  of train_recipe a step (and one finite check with the guard); the
  guard's replay ms, device ms, launches and pool bytes.
- ``numeric_skip``: ``numeric_policy="skip"`` with the failpoint
  ``executor.step:corrupt=input_mask@3``: the poisoned run leaves every
  persistable and the run counter as they were, the later runs equal a
  clean run without that batch bit for bit; the same inside a six-step
  ``run_steps`` window poisoned at step 2; the skip budget; "raise"
  naming its culprit, graphed equal to op by op.
- ``resilient_recipe``: ResilientTrainer over eight batches
  (checkpoint_every=3, keep_last=2), each run bit-equal to its
  uninterrupted reference, at 2 layers of BERT-base's width: (a)
  ``step:preempt@6``, (b) numeric_policy="rewind" with batch 4
  poisoned, (c) run_steps windows, (d) a torn checkpoint
  (``io.manifest_write:raise@2``), (e) a stalled card under
  collective_timeout_s; checkpoint and restore seconds and bytes, steps
  replayed.
- ``pod_recipe``: the pod half of the robustness stack, its hosts
  threads on one LocalCoordinator, each with its own Executor, Scope
  and checkpoint dir, on the recipe step and the replicated feed; every
  live host bit-equal to the uninterrupted one-host run: (a) 12 layers,
  two hosts, PodResilientTrainer with the buddy tier (zlib, p2p,
  delta), run_steps windows of 4, ``step:preempt@3`` restored from the
  buddy mailboxes with no disk read; at 2 layers, four hosts: (b) a
  torn checkpoint lowering the consensus to step 0, (c) ElasticTrainer
  with a host dying (shrink at 3/4, no restore) and rejoining (grow at
  4/4, its state shipped zlib), (d) numeric_policy="rewind" with one
  batch NaN-poisoned and skipped by all; each host's launches a step
  (train_recipe's, or derived from the 2-layer program), snapshot
  encode seconds and bytes, restore seconds, steps replayed, peak.
- ``compiled_parity``: 2-layer BERT under numeric_policy="skip", card
  graphed against CPU with the same batch poisoned: the same step
  skipped on both, the rest within PARITY_*.

Then dygraph (eager mode), the hand-written kernels launched outside the
Executor (no trace record, no CUDA graph), with GPT-base built from
``dygraph.nn`` Layers and the static layer functions run eagerly (no
model module in the JAX package: ``_dygraph_gpt``):

- ``dygraph_gpt``: GPT-base at 2 x 4096 f32 (bench.py:596-601's widths,
  dropout 0), DYGRAPH_STEPS steps of ``loss.backward();
  opt.minimize(loss)`` with ``dygraph.optimizers.Adam(1e-4)`` on one
  batch: losses finite and falling, GPT_PER_STEP's launches a step (12
  flash forward, 12/12 flash backward, 25/25 LayerNorm, 148 fused Adam,
  1/1/1 head), step ms (median of the last DYGRAPH_TIMED) against this
  run's graphed static step and the recorded one, tokens/s, peak memory
  above resident; one more step profiled (idle share, the path's kernel
  families, no library kernel).
- ``dygraph_traced``: ``TracedLayer`` over the trained model at batch 1
  (one CUDA graph): the replay equal to the eager forward bit for bit
  (the loss and every token's), eager and replayed ms, no wrapper launch
  on a replay; after one more ``minimize`` the replay equal to the new
  eager forward bit for bit. Then a Conv2D + BatchNorm and a Linear
  through a SpectralNorm'd weight (state the forward updates), traced in
  eval mode, a training step between replays: each replay equal to the
  eager forward from the same state, buffers included; a Linear re-loaded
  by ``set_dict`` at another width captured again.
- ``dygraph_parity``: 2 layers at GPT-base width, 2 x 128 tokens, the
  static program's startup weights copied in name for name, three Adam
  steps: the card's dygraph against the card's static ``Executor.run``
  and the CPU's dygraph, held to PARITY_*.
- ``dygraph_zoo``: every ``dygraph.nn`` layer and the ``rnn_impl`` units
  forward and backward, card against CPU (ZOO_TOL); Dropout and NCE's
  sampling by their statistics.

Then the op library's slice: the Paddle Book's eight chapters built from
``layers`` and ``nets`` (no model module, as in the JAX package;
``_book_chapter``) at the widths, batches and optimizers of PaddlePaddle
1.6's book tests (BOOK), fed from ``dataset``'s corpora:

- ``book``: fit_a_line, recognize_digits (conv), image_classification
  (resnet_cifar10, depth 32), word2vec, understand_sentiment (conv),
  recommender_system, label_semantic_roles and machine_translation,
  BOOK_STEPS runs each through Executor.run, graphed from the second:
  each loss falling by its chapter's bar (BOOK_TEST_BARS:
  tests/test_book.py's, scaled to the runs and the Book's rate), ms a
  step, the capture record, one fused-Adam launch a parameter a step in
  the two Adam chapters; fit_a_line and recognize_digits saved, loaded
  back by io.load_inference_model and by the Predictor, against the CPU.
  Where the Book feeds LoD (sentences, a movie's categories and title)
  the chapters take dense ids with lengths, and ``pool_type="sqrt"``
  becomes "max", as tests/test_book.py builds them.
- ``book_parity``: each chapter at those widths, BOOK_PARITY_STEPS runs,
  card against CPU and graphed against op by op (PARITY_*).
- ``op_library``: each of the 74 op types at a working size (OP_LIB_*),
  card against the CPU's plain path, forward and backward, twice on the
  card for equal bits (the gathers' gradients and the scatters' adds sum
  in a fixed order); the random ops by their statistics; programs
  holding where_index, range, py_func or load_tensor refused capture.

Then the Program verifier, serving on one host and the spans:

- ``verifier`` (before ``serving_artifact``, whose corrupted program
  must not count): ``analysis_totals()`` over every program the run
  verified so far under the default mode; the recipe step and the
  GPT-base bf16 step, one run each under ``verify_program="strict"``.
- ``serving_artifact``: BERT-base (serve's model, 2 layers deep)
  exported by ``save_inference_model(format="stablehlo")`` as
  ``torch.export`` programs (plain at buckets 1 and 8, q8 at bucket 1):
  export seconds and bytes, 2 flash_attention_fwd and 5 layer_norm_fwd
  custom ops in every graph and no plain attention;
  ``load_serving_artifact`` with ``max_in_flight=2``, ``warmup()`` (each
  bucket's first call launches 2 flash and 5 LayerNorm forward kernels,
  then is captured) and
  ``health()``; the serve phase's requests against the in-process
  Predictor on the card and the CPU (SERVE_ATOL), replays bit-equal to
  the exported program run eagerly, latency beside the Predictor's; a
  deadline miss, shedding past max_in_flight, a degraded serve from a
  warm bucket while the orphaned worker captures the cold one, health's
  counters; q8 against plain (Q8_SERVE_ATOL) and bit-equal to the codec's
  oracle; a corrupted shipped program refused at load.
- ``spans``: with ``obs.enable()``, three graphed recipe steps and three
  served requests: the exec.step labels and parents, valid Chrome-trace
  JSON, and the replay's ms with the engine off and on.

Then mixed precision and the training contribs (the kernels phase also
holds the flash kernels in fp16: forward at BERT-base's (8, 12, 512,
512, 64) with its key mask, GPT-base's causal T = 4096 and amp_bert's
(128, 12, 128, 128, 64) with its fp16 key mask, dK/dV and dQ there too
and at a dO that carries a 2^16 loss scale, FP16_REL_TOL):

- ``amp_bert``: f32 BERT-base at bench.py:388-389's shapes trained
  through ``contrib.mixed_precision.decorate(Adam(1e-4))``, bf16 and
  fp16 with dynamic loss scaling from 2^15, each GRAPH_STEPS runs op by
  op and graphed (bit for bit equal; the train step's launches, every
  flash launch of the fp16 runs counted as the fp16 instantiation's and
  none of the bf16 runs'); fp16 with an overflow first (parameters
  bit-equal after it) and one replayed last (Adam's moments decayed by
  beta1 / beta2 exactly, as the zero gradient the reference hands the
  optimizer gives), each multiplying the scale by decr_ratio; step ms
  beside train_bf16's and train's, the cast ops, the loss-scale and
  good-steps sequences, the device ms of the finiteness chain.
- ``amp_parity``: a narrow BERT (AMP_PARITY: 2 layers, hidden 128; 4 x
  128 tokens) decorated bf16 and fp16, three steps card against CPU
  (bf16's PARITY_*, fp16's no looser).
- ``amp_resnet``: ResNet-50 at bench.py:472-486 decorated bf16, six
  steps graphed, beside resnet_train's and graph_resnet's f32 replays.
- ``grad_merge``: BERT-base (bf16) at batch 32 under
  ``GradientMergeOptimizer(Adam(1e-4), k_steps=4)``, eight runs op by op
  and graphed (bit for bit), the reference's rule held at each run.
- ``contrib_surface``: ``ctr_metric_bundle`` on DeepFM at
  bench.py:565-578 against numpy; ``profiler.profiler`` around three
  replays of amp_bert's fp16 step (its table names the flash and
  LayerNorm kernels); ``contrib.Trainer`` on fit_a_line two epochs and
  ``Inferencer`` from its saved parameters; ``summary``,
  ``memory_usage`` and ``op_freq_statistic`` of BERT-base.

Then the rest of the fluid surface and the vision and extras ops:

- ``fluid_surface`` (inside the serving_artifact block, on its BERT-base
  plain artifact): ``install_check.run_check()`` on the card, ``core``'s
  places and ``cuda_places`` against torch's device count; the two CLIs
  as subprocesses (``python -m paddle_tpu_torch.tools.progcheck DIR
  --json``: exit 0, and 2 on a copy with an op's input renamed;
  ``python -m paddle_tpu_torch.tools.serving_probe DIR --warmup
  --strict``: exit 0, every bucket warm, its own request served, and 2
  on a copy with its program cut in half), each one's seconds, the
  kernels not built again; the probe once more in this process, its
  flash and LayerNorm launches counted.
- ``vision_extras``: the 22 vision and extras op types, each through its
  layers function into its own program with append_backward of its
  outputs against seeded random cotangents, at a published model's shape (TSM, DCNv2, R-FCN,
  Deformable R-FCN, PrRoI pooling, C3D, the Spatial Transformer,
  AlexNet's LRN, EDSR, ResNet-50's im2col, YOLOv2, ShuffleNet, 3D U-Net,
  BERT-base's embedding table, the beam, CRNN-CTC, DeepFM, an
  interaction map, the ImageNet crop): graphed replays equal to op-by-op
  runs bit for bit, two runs bit-equal, card against the CPU within
  OP_LIB_TOL (exactly for what moves or chooses data; pool3d at a cut
  batch, VX_CUT), random_crop by its draws, each kernel's
  forward and backward ms; no launch of a hand-written kernel.

Then model compression (contrib/slim, contrib/quantize; no kernel is new):

- ``slim_bert``: BERT-base (f32, dropout 0.1) at batch 32 x 128 made
  quant-aware (``slim.quant_aware``: 75 weight and 51 activation
  fake-quant ops) under Adam(1e-4), GRAPH_STEPS runs op by op and
  graphed (fetches and every persistable, the moving averages too, bit
  for bit; the train step's launches a step); losses finite and falling;
  the moving averages' state the closed form; the step beside the
  unquantized one; the fake-quant ops' device ms and kernels. Then
  ``convert`` of its test clone, served at batches 1 and 8 on the card
  and the CPU, and saved as int8 (every parameter an ``.int8`` member,
  each dequantized weight within scale / 2), loaded and run on both;
  a narrow BERT (SLIM_PARITY) quant-aware, card against CPU.
- ``slim_vision``: ResNet-50 at batch 32 quant-aware (per channel on its
  53 conv filters and the fc), a warm run and four graphed steps beside
  the unquantized model's; that model pruned by
  ``StructurePruner(0.5, axis=0)`` over its filters with ``apply_masks``
  after each replayed step (masks equal to numpy's, half of each
  filter's channels zero), the sensitivity of three parameters (weights
  restored bit for bit); a ResNet-50 teacher merged into a MobileNet v1
  student and distilled by the ``Compressor`` (2 epochs x 2 steps, the
  hooks in order, a checkpoint an epoch, the teacher unchanged); the
  NAS ``ControllerServer`` on 127.0.0.1 with a ``SearchAgent``, token
  for token an in-process ``SAController`` of the same seed.

Each phase prints JSON lines, also kept whole in
``chiprun_out/chip_smoke.jsonl``. The last three lines are the card's
``nvidia-smi`` name and power limit, the ``{"kernels": [...]}`` summary
and ``{"ok": true, "device": {...}}``. Any failed phase exits non-zero
without the ``ok`` line; so does a machine without a CUDA device, or a
directory without the package.
"""
import contextlib
import importlib
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
# compiled_recipe / numeric_skip / resilient_recipe (the compiled front
# door, the numeric guard, resilient training): train_recipe's program
# (BERT-base bf16, batch 128 x 128, dropout 0.1, AdamW, the warmup over
# the polynomial decay, the global-norm clip) with the decay over
# GUARD_DECAY_STEPS runs, so the rate stays above 0 over every run of
# these phases (train_recipe's 6 reaches 0 at run 3, after which a
# skipped or replayed step would move no parameter). numeric_skip: the
# failpoint executor.step:corrupt=input_mask@GUARD_POISON_RUN NaN-poisons
# one element of that run's float feed (models/bert.py input_mask); the
# window poisons step GUARD_WINDOW_POISON of GUARD_WINDOW; the skip guard
# launches the finite check once and the guarded copy twice (backup,
# gated restore) a replayed step; the check alone (check_numerics=True,
# "raise") launches the finite check once.
GUARD_DECAY_STEPS = 100
GUARD_STEPS = 6
GUARD_POISON_RUN = 3
GUARD_WINDOW, GUARD_WINDOW_POISON = 6, 2
GUARD_SKIP_BUDGET = 2
GUARD_SKIP_PER_STEP = {"finite_flags": 1, "guarded_copy": 2}
# resilient_recipe: RESILIENT_BATCHES batches, a checkpoint every
# RESILIENT_CKPT_EVERY steps, the newest RESILIENT_KEEP kept; every run
# at RESILIENT_LAYERS layers of the same width (the smoke's time budget;
# pod_recipe (a) runs the 12-layer ResilientTrainer); (b) poisons batch
# RESILIENT_REWIND_POISON; (e)
# stalls the card RESILIENT_STALL_S (a sleep kernel) before run
# RESILIENT_STALL_RUN under collective_timeout_s=RESILIENT_TIMEOUT_S,
# above a 2-layer step's ~20 ms and below the stalled step's time.
RESILIENT_BATCHES, RESILIENT_CKPT_EVERY, RESILIENT_KEEP = 8, 3, 2
RESILIENT_LAYERS = 2
RESILIENT_REWIND_POISON = 4
RESILIENT_STALL_RUN = 5
RESILIENT_STALL_S, RESILIENT_TIMEOUT_S = 3.0, 1.0
# pod_recipe: a pod of simulated hosts (threads on one LocalCoordinator,
# each with its own Executor, Scope and checkpoint dir) training the
# recipe step on the replicated feed, POD_BATCHES batches. (a) 12 layers,
# POD_A_HOSTS hosts, PodResilientTrainer with the buddy tier (zlib, p2p,
# delta), windows of POD_A_WINDOW (run_steps) and a checkpoint at each
# POD_A_CKPT_EVERY: ``step:preempt@POD_A_PREEMPT`` fires at the first
# dispatch of window 2, and the pod restores the buddy generation at
# step POD_A_WINDOW from memory. (b)-(d) RESILIENT_LAYERS layers,
# POD_HOSTS hosts, windows of one step, a checkpoint every
# POD_CKPT_EVERY (the run's end: two saves a host, the phase's time),
# buddy tier off: (b) ``io.manifest_write:raise@POD_TORN_AT`` tears one
# host's step-POD_CKPT_EVERY save (visits 1-4 are the step-0 baselines)
# and the consensus falls to step 0; (c)
# ElasticTrainer(rejoin=True), ``step:die@POD_DIE_AT`` (round 3's first
# dispatch): shrink at 3/4, the host rejoins at 4/4 with its state
# shipped zlib; (d) numeric_policy="rewind" on every host, batch
# RESILIENT_REWIND_POISON NaN-poisoned in the shared feed. A coordinator
# timeout of POD_TIMEOUT_S: no loss is meant to come from a slow host.
POD_BATCHES, POD_KEEP, POD_TIMEOUT_S = 8, 2, 300.0
POD_A_HOSTS, POD_A_WINDOW, POD_A_CKPT_EVERY, POD_A_PREEMPT = 2, 4, 8, 3
POD_HOSTS, POD_CKPT_EVERY, POD_TORN_AT, POD_DIE_AT = 4, 8, 6, 9
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
# seq2seq_train: PaddlePaddle/models PaddleNLP/seq2seq/seq2seq's base
# model at its IWSLT'15 en->vi settings (run.sh and args.py: 2 LSTM
# layers, hidden 512, source vocabulary 17191, target 7709, batch 128,
# Adam 1e-3, max_grad_norm 5, init_scale 0.1 (U(-0.1, 0.1)), beam 10),
# sentences padded to 50 tokens, dropout 0.2 between layers in training
# (0 in the decode and parity programs), f32, one seq2seq_batch
# (seed 0). A step: 2 layers x 50 encoder and 50 decoder LSTM steps (two
# recurrent_scan ops), the 7709-way projection and a masked
# softmax_with_cross_entropy (7709 columns do not tile into the CE
# kernel's blocks: the JAX package's plain lowering), the global-norm
# clip and one fused-Adam launch per parameter (2 embeddings, 4 LSTM
# weights and biases, the projection). Served: the beam decode (50
# unrolled steps over batch x 10 rows) saved with save_inference_model
# and served through create_predictor at SEQ2SEQ_SERVE_BATCHES.
SEQ2SEQ = dict(src_vocab=17191, trg_vocab=7709, hidden=512, n_layers=2,
               batch=128, src_len=50, trg_len=50, beam=10, max_decode=50)
SEQ2SEQ_LR, SEQ2SEQ_CLIP, SEQ2SEQ_INIT = 1e-3, 5.0, 0.1
SEQ2SEQ_BOS, SEQ2SEQ_EOS = 1, 2
SEQ2SEQ_PER_STEP = {"fused_adam": 11}
SEQ2SEQ_SERVE_BATCHES = (128, 16) * 5
# seq2seq_parity: the seq2seq's layers at narrow widths (below),
# PARITY_STEPS Adam(PARITY_LR) steps on one batch of 8, the card graphed
# against the CPU: losses rtol 1e-5, logits rtol 1e-4 atol 1e-5, every
# persistable rtol 1e-4, atol 1e-5 (f32 through 2 x 12 + 2 x 10 LSTM steps
# summed in other orders; tests/test_torch_seq2seq.py holds the port to
# the JAX package there); then the beam decode from the same weights,
# card graphed against the CPU (``_compare_decodes``).
SEQ2SEQ_PARITY = dict(src_vocab=1000, trg_vocab=800, hidden=64, n_layers=2,
                      batch=8, src_len=12, trg_len=10, beam=4, max_decode=10)
SEQ2SEQ_PARITY_RTOL, SEQ2SEQ_PARITY_ATOL = 1e-4, 1e-5
# control_flow: CONTROL_FLOW_FEEDS runs of a program holding cond,
# switch_case and an unbounded while_loop over CONTROL_FLOW_WIDTH
# elements (each a flag, a branch index and a trip count), card against
# CPU; the device loops' training step at CONTROL_FLOW_RNN (time, batch,
# width) with a bounded_while of CONTROL_FLOW_TRIPS iterations, checked
# by _both_ways with 2 fused-Adam launches a step (its two parameters).
CONTROL_FLOW_WIDTH = 1 << 20
CONTROL_FLOW_FEEDS = ((1.0, 0, 3), (0.0, 1, 7), (1.0, 2, 0), (0.0, 5, 12),
                      (1.0, 0, 3))
CONTROL_FLOW_RNN, CONTROL_FLOW_TRIPS = (16, 64, 256), 8
CONTROL_FLOW_PER_STEP = {"fused_adam": 2}
# The rest of the zoo (vision_train, yolo_train, yolo_serve, dcgan_train,
# simple_train, zoo_parity). The classifiers train as bench.py:472-486
# trains ResNet-50 (batch 128 x 3 x 224 x 224, 1000 classes, Momentum(0.1,
# 0.9)); no hand-written kernel is on their paths (cuDNN convolutions,
# MobileNet's depthwise and SE-ResNeXt's 32-group ones included).
VISION_ARCHS = ("mobilenet", "vgg16", "se_resnext50")
VISION_BATCH = 128
# VGG-16 has no batch norm: at lr 0.1 its first update raised the loss
# (6.9653 -> 7.0038, PERF.md), so it trains at the VGG paper's 0.01
VISION_LR = {"mobilenet": 0.1, "vgg16": 0.01, "se_resnext50": 0.1}
# YOLOv3 at PaddleCV yolov3's published training settings (input 608, 80
# COCO classes, 50 boxes, 8 images a card, Momentum(0.001, 0.9) with
# L2Decay(5e-4)); served at its inference settings (conf 0.005, 400
# candidates a class, 100 kept, NMS IoU 0.45) at batches 1 and 8, each
# cold (op by op), captured, then replayed YOLO_SERVE_REPLAYS times.
YOLO = dict(class_num=80, image_size=608, max_box=50)
YOLO_BATCH, YOLO_LR, YOLO_DECAY = 8, 0.001, 5e-4
YOLO_SERVE = dict(conf_thresh=0.005, nms_topk=400, keep_topk=100,
                  nms_thresh=0.45)
YOLO_SERVE_BATCHES, YOLO_SERVE_REPLAYS = (1, 8), 5
YOLO_CALIBRATION_RUNS = 40        # moving statistics at 0.9^40 ~ 1.5% init
# the served pre-NMS boxes and scores, card against CPU (batch 1): f32
# through 75 convolutions summed in other orders (one cuDNN convolution's
# output is within 1.1e-6 of its largest of a float64 reference on the
# H100: zoo_parity's conv_precision; 75 deep, the boxes and scores
# came within 1.0e-5 and 0.85e-5 of their largest): rtol 1e-4, atol 1e-4
# of the largest magnitude
YOLO_BOX_RTOL, YOLO_BOX_ATOL_SHARE = 1e-4, 1e-4
# DCGAN: the fluid models repo's MNIST dc_gan (100-d noise, a 128 x 7 x 7
# generator seed, 64 / 128 channels, 28 x 28 x 1), batch 128, the
# program's own Adam(2e-4, beta1 0.5): 6 discriminator and 10 generator
# fused-Adam launches a step
DCGAN = dict(noise_dim=100, base_channels=64, image_size=28,
             image_channels=1)
DCGAN_BATCH = 128
DCGAN_PER_STEP = {"fused_adam": 16}
# the book's MLP (784-200-200-10) and word2vec (imikolov: 2073 words,
# width 32, window 2) at batch 128, Adam(1e-3), SIMPLE_STEPS steps each
SIMPLE_BATCH, SIMPLE_STEPS, SIMPLE_LR = 128, 3, 1e-3
WORD2VEC = dict(vocab_size=2073, emb_size=32, window=2)
MLP_PER_STEP, WORD2VEC_PER_STEP = {"fused_adam": 6}, {"fused_adam": 3}
# zoo_parity: each model narrow, PARITY_STEPS steps card (graphed and op
# by op) against CPU from the same startup (_card_vs_cpu_all): MobileNet
# at scale 0.25 cut after three depthwise-separable blocks on 32 x 32
# (the whole net's batch-norm scale gradients cancel to ~1e-3 of their
# terms, so two runs part chaotically by the second step: PERF.md),
# VGG-11 with its dropout in test mode (the CPU's and the card's
# generators draw other masks) on 32 x 32, one SE-ResNeXt bottleneck on
# 16 x 16, tiny YOLOv3 at 64 x 64 (batch 2, trained, then served card
# against CPU), DCGAN at base width 8 and 16 x 16 images; batch 8. DCGAN:
# losses rtol 1e-5, persistables rtol 1e-4, atol 1e-5 times the tensor's
# largest magnitude (at least 1). The others pass their activations
# through relu (leaky for YOLO) and max pools, whose kinks a value a few
# ulps from 0 (or from its pool neighbour) crosses on one side on the
# card and on the other on the CPU, routing a gradient differently: VGG-11
# agreed to 2.4e-7 for two steps, then one such crossing moved its third
# loss by 8.5e-6 (relative) and a velocity by 3.6% of its move in L2 (at
# its 2 x 2 maps one element holds 1/32 of a filter's gradient; PERF.md).
# Those are held by losses within rtol 1e-4 (PARITY_LOSS_RTOL's f32) and
# each persistable's L2 difference within 10% of how far the CPU's three
# steps moved it (a wrong kernel misses by its whole move); DCGAN's
# strict check is the one that catches a subtle error (without the
# in-place rule it misses by 8.3e-4).
ZOO_PARITY_BATCH = 8
ZOO_PARITY_RTOL, ZOO_PARITY_ATOL = 1e-4, 1e-5
ZOO_KINK_LOSS_RTOL, ZOO_KINK_MOVED_RTOL = 1e-4, 0.1
# zoo_parity's record of cuDNN's precision: (name, input, filter, groups,
# stride) of a plain 3x3, SE-ResNeXt-50's first 32-group 3x3 (batch cut
# to 32) and MobileNet's first depthwise 3x3 (batch 32)
CONV_PRECISION_CASES = (
    ("plain_3x3", (8, 64, 16, 16), (64, 64, 3, 3), 1, 1),
    ("se_resnext_grouped", (32, 128, 56, 56), (128, 4, 3, 3), 32, 1),
    ("mobilenet_depthwise", (32, 32, 112, 112), (32, 1, 3, 3), 32, 1))
ZOO_PARITY_YOLO = dict(class_num=4, image_size=64, max_box=6)
ZOO_PARITY_DCGAN = dict(noise_dim=16, base_channels=8, image_size=16,
                        image_channels=1)
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
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12, "float16": 989e12}

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
# fp16 flash kernels (forward, dK/dV, dQ) against the plain version, which
# computes in f32 from the same fp16 inputs, as the JAX kernel does: both
# round an f32 result to fp16 (11 significant bits), so an element may
# land one fp16 ulp apart, at most 2^-10 of its magnitude. Held relative
# to each output's largest magnitude, which also covers a gradient carrying
# a loss scale (FP16_LOSS_SCALE: dO = 2^16 * g with g ~ N(0, 2^-8), so
# dS = P (dP - delta) passes fp16's 65504 inside the kernel).
FP16_REL_TOL = 2.0 ** -10
FP16_LOSS_SCALE = 2.0 ** 16
FP16_GRAD_STD = 2.0 ** -4
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
PARITY_LOSS_RTOL = {"float32": 1e-4, "bfloat16": 1e-3, "float16": 1e-3}
PARITY_PARAM_ATOL = 2e-5
PARITY_PARAM_ULPS = {"float32": 0, "bfloat16": 2, "float16": 2}
PARITY_SIGN_FLIP_ATOL = 6e-4                 # 2 * steps * lr
PARITY_SIGN_FLIP_SHARE = {"float32": 1e-6, "bfloat16": 1e-3,
                          "float16": 1e-3}
PARITY_MOVED_RTOL = 0.25
MANTISSA_BITS = {"float32": 23, "bfloat16": 7, "float16": 10}
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

# dygraph (eager mode): GPT-base at GPT_BATCH x GPT_SEQ f32 built
# from dygraph.nn Layers and the static layer functions run eagerly (no
# model module in the JAX package: _dygraph_gpt), Adam(DYGRAPH_LR),
# DYGRAPH_STEPS steps on one batch, the step's ms the median of the last
# DYGRAPH_TIMED; its launches a step are GPT_PER_STEP's (the graphed
# static step's). DYGRAPH_YARDSTICK_MS: the graphed static f32 GPT step at
# the same settings as PERF.md records it (an NVIDIA H100 80GB HBM3 at
# 700.00 W); the phase also takes this run's gpt_train step.
# dygraph_traced: TracedLayer over the trained model at batch 1,
# DYGRAPH_TRACED_REPS timed calls eager and replayed; then layers with
# state (BatchNorm, SpectralNorm) and a set_dict at another width at
# batch DYGRAPH_STATE_BATCH. dygraph_parity: the
# PARITY_* comparison at PARITY_LAYERS layers and GPT_PARITY_BATCH x
# GPT_PARITY_SEQ tokens, card dygraph against the card's static
# Executor.run and the CPU's dygraph, from the static startup's weights.
# dygraph_zoo: each dygraph.nn layer and the two rnn_impl units at small
# sizes, forward and backward, card against CPU within ZOO_TOL of the
# CPU's largest magnitude (f32 both sides, no TF32; sums in another
# order); Dropout (ZOO_DROPOUT_N elements) and NCE's noise classes
# (ZOO_NCE_DRAWS) by their statistics, within 5 standard errors.
DYGRAPH_LR, DYGRAPH_STEPS, DYGRAPH_TIMED = 1e-4, 5, 3
DYGRAPH_YARDSTICK_MS = (197.6, 198.3)
DYGRAPH_TRACED_REPS = 10
DYGRAPH_STATE_BATCH = 8
ZOO_TOL = 1e-4
ZOO_DROPOUT_N = 1 << 20
ZOO_NCE_DRAWS = 1 << 14
# The Paddle Book (the op library's slice): eight chapters of
# PaddlePaddle 1.6's python/paddle/fluid/tests/book/, built from layers
# and nets as tests/test_book.py builds them (dense (N, T) ids with
# lengths where the Book feeds LoD), at the Book tests' widths, batches
# and optimizers (BOOK), fed from paddle_tpu_torch.dataset's corpora.
# book: BOOK_STEPS runs of each through Executor.run (graphed from the
# second; no chapter holds an op that refuses capture), cycling over
# BOOK_BATCHES batches where tests/test_book.py cycles (``cycle``) and on
# one batch where it feeds one; the loss must fall by the chapter's bar
# (BOOK_BARS, below). fit_a_line and recognize_digits are saved and
# served again through io.load_inference_model and the Predictor.
# book_parity: each chapter at these widths, BOOK_PARITY_STEPS steps,
# card against CPU and graphed against op by op (_card_vs_cpu,
# PARITY_*). op_library: each of the 74 op types at a working size
# (OP_LIB_*), card against the CPU's plain path.
BOOK_STEPS, BOOK_BATCHES, BOOK_PARITY_STEPS = 30, 5, 3
BOOK_PARITY_DEPTH = 8                # resnet_cifar10 in book_parity
OP_LIB_TYPES = 74
OP_LIB_ELEM = (4096, 1024)
OP_LIB_ROWS, OP_LIB_WIDTH, OP_LIB_IDS = 1000000, 16, 65536
OP_LIB_SEQ = (64, 512, 128)
# f32 on both sides, sums in another order: within rtol 1e-5 and an atol
# of 1e-5 times the CPU answer's largest magnitude (at least 1)
OP_LIB_TOL = dict(rtol=1e-5, atol=1e-5)
BOOK = {
    "fit_a_line": dict(batch=20, lr=0.001, cycle=True),
    "recognize_digits": dict(batch=64, filters=(20, 50), lr=0.001,
                             cycle=True),
    "image_classification": dict(batch=128, depth=32, lr=0.001,
                                 cycle=True),
    "word2vec": dict(batch=32, n=5, emb=32, hidden=256, min_freq=50,
                     lr=0.001, cycle=True),
    "understand_sentiment": dict(batch=128, seq=256, emb=32, filters=32,
                                 lr=0.002, cycle=True),
    "recommender_system": dict(batch=256, emb=32, small=16, hidden=200,
                               cats=3, title=4, lr=0.2, cycle=False),
    "label_semantic_roles": dict(batch=10, seq=32, word=32, mark=5,
                                 hidden=512, depth=8, crf_lr=1e-3, lr=0.01,
                                 decay_steps=100000, decay_rate=0.5,
                                 cycle=False),
    "machine_translation": dict(batch=2, seq=32, dict=30000, word=16,
                                hidden=32, lr=1e-4, l2=0.1, cycle=False),
}

# serving on one host (the serving slice): BERT-base as ``serve`` builds
# it but ARTIFACT_LAYERS deep (cut from 12: the smoke's budget; export
# time grows with depth), exported by save_inference_model(format=
# "stablehlo") at ARTIFACT_BUCKETS (plain layout) and ARTIFACT_Q8_BUCKETS
# (q8 layout) and served by load_serving_artifact(max_in_flight=
# ARTIFACT_IN_FLIGHT); every bucket's graph holds one flash_attention_fwd
# a layer and one layer_norm_fwd custom op for the embeddings and two a
# layer (_artifact_launches). A robustness case sleeps
# ARTIFACT_SLOW_S inside the request (fire("serve")) against a deadline
# of ARTIFACT_DEADLINE_S. q8 against plain: int8 blocks of 256 with a
# scale each, set for 12 layers of values of order 1-4 (a 2-layer cut at
# hidden 768, T = 64, differed by 0.026 on the CPU); the q8 artifact must
# also equal the plain artifact serving the q8 payload's dequantized
# weights bit for bit (the codec's oracle). verifier: the recipe step and
# the GPT bf16 step, one run each through CompiledProgram under
# verify_program="strict". spans: SPAN_STEPS graphed recipe steps and
# served requests with obs enabled, then SPAN_TIMED replays each way.
ARTIFACT_LAYERS = 2
ARTIFACT_BUCKETS = (1, 8)
ARTIFACT_Q8_BUCKETS = (1,)
ARTIFACT_IN_FLIGHT = 2
ARTIFACT_SLOW_S = 0.3
ARTIFACT_DEADLINE_S = 0.15
ARTIFACT_WAIT_S = 120.0
Q8_SERVE_ATOL = 0.25
SPAN_STEPS = 3
SPAN_TIMED = 5
# mixed precision and the contribs: fp16's first loss scale (amp_bert,
# amp_parity) and decorate's default decr_ratio; GradientMerge's window
# and runs (two windows); ctr_metric_bundle's f32 sums over DeepFM's 2048
# predictions against numpy's f64 ones (random-walk rounding of 2048 f32
# terms ~1e-6 of the sum)
AMP_FP16_INIT_SCALE = 2.0 ** 15
AMP_DECR_RATIO = 0.8
AMP_PARITY = dict(num_layers=2, hidden_size=128, num_heads=2, ff_size=512)
GRAD_MERGE_K, GRAD_MERGE_STEPS = 4, 8
CTR_RTOL = 1e-5
# the fluid surface and the vision and extras ops: vision_extras runs
# each op type at the published shape of _vx_feeds on the card and holds
# it against the CPU there, but for pool3d: its CPU side took 1.50 s at
# batch 2 on the H100's host (so about 6 s at the full batch of 8), so
# its comparison cuts the batch to VX_CUT's, never a width. The
# differentiated loss is the sum of each float output times a seeded
# N(0, 1) cotangent of its shape, so every gradient is of order one
# against OP_LIB_TOL's atol. random_crop is held by VX_CROP_DRAWS draws
# (33 offsets a dim: about 10 a value).
VX_CUT = {"pool3d": 2}
VX_CROP_DRAWS = 330
# The detection phases. detection_ssd: PaddleCV ssd/mobilenet_ssd.py's
# MobileNet-v1 SSD300 on VOC (21 classes; multi_box_head over the 19, 10,
# 5, 3, 2 and 1 maps with its sizes and ratios: SSD_PRIORS priors), its
# training batch 64, ground truth padded to 50 boxes an image, ssd_loss at
# its defaults summed, RMSProp(1e-3) with L2Decay(5e-5); served by
# detection_output (softmaxed scores, NMS 0.45, keep_top_k 200) at
# SSD_SERVE_BATCHES, the NMS's inputs (decoded boxes, scores) within
# SSD_SERVE_TOL of the CPU's and the NMS on the card's inputs equal on
# the CPU.
SSD = dict(batch=64, image=300, classes=21, max_box=50, gt=6, scale=1.0,
           lr=1e-3, l2=5e-5,
           min_sizes=[60.0, 105.0, 150.0, 195.0, 240.0, 285.0],
           max_sizes=[[], 150.0, 195.0, 240.0, 285.0, 300.0],
           aspect_ratios=[[2.0]] + [[2.0, 3.0]] * 5, nms=0.45,
           keep_top_k=200)
SSD_PRIORS = 1917
SSD_STEPS = 6
SSD_SERVE_BATCHES = (1, 8)
SSD_SERVE_TOL = 1e-4
# detection_rcnn: Faster R-CNN ResNet-50-C4 at PaddleCV rcnn's COCO
# training settings (one 800 x 1333 image, 81 classes; anchors 32-512 at
# ratios 0.5/1/2, stride 16, variances 1; rpn_target_assign 256 an image,
# fg 0.5, 0.7/0.3; generate_proposals 12000 -> 2000 at NMS 0.7;
# generate_proposal_labels 512, fg 0.25, bbox_reg_weights 0.1/0.1/0.2/0.2;
# roi_align 14 x 14 at 1/16, res5, a global average pool, the class and
# box fc layers; Momentum(0.01, 0.9)); eight ground truths padded to 50.
# The sampled RoIs (at most 512 of the 2000) are gathered in front of the
# box head, as the reference hands it 512. Its heads are held card
# against CPU on a fed res4 map of the full (1, 1024, 50, 84) shape with
# use_random=False: the RPN part whole, the box head on the card's first
# RCNN_CPU_ROIS sampled RoIs (the CPU side cut in the head's batch).
RCNN = dict(image=(800, 1333), feat=(50, 84), classes=81, max_box=50, gt=8,
            anchor_sizes=[32.0, 64.0, 128.0, 256.0, 512.0],
            ratios=[0.5, 1.0, 2.0], rpn_batch=256, rpn_fg=0.5, rpn_pos=0.7,
            rpn_neg=0.3, pre_nms=12000, post_nms=2000, nms=0.7,
            roi_batch=512, roi_fg=0.25, reg_weights=[0.1, 0.1, 0.2, 0.2],
            roi_res=14, lr=0.01, momentum=0.9, trunk="c4", head="res5",
            width=1024)
RCNN_STEPS = 3
RCNN_CPU_ROIS = 64
RCNN_TOL = dict(rtol=1e-4, atol=1e-4)
# the heads' gradients, held by their relative L2 error: a relu whose
# input is within rounding of 0 passes its gradient on one side only, and
# res5's ~29M units at 64 RoIs hold a few such; on the CPU alone a 1e-7
# relative change of the res4 map moves res5's gradients by up to 7e-3 of
# their largest magnitude elementwise and 5.3e-4 in L2 (measured with
# _rcnn_program's "box" part at 320 x 448)
RCNN_GRAD_L2 = 1e-2
# detection_ops: each op type at a published model's shape (_dx_feeds).
# Where the CPU side would take seconds at that shape, the comparison
# cuts it in batch (images, or a RoI head's RoIs) and only there: DX_CUT,
# an int for every feed's first axis or {feed: rows}. The ops whose greedy
# loop launches a few kernels a candidate (DX_LOOP_OPS) are timed once,
# op by op and replayed, with their launches (_op_case's ``loop``).
DX_CUT = {"sigmoid_focal_loss": 200700, "roi_align": {"rois": 128},
          "roi_pool": {"x": 1, "rois": 16, "nums": 1},
          "retinanet_target_assign": {"gt": 1, "label": 1},
          "generate_mask_labels": 1}
DX_LOOP_OPS = ("generate_proposals", "locality_aware_nms",
               "retinanet_detection_output")
DX_SHUFFLE_DRAWS = 2000
# The slim phases (contrib/slim, contrib/quantize). slim_bert: BERT-base
# (f32, dropout 0.1) at the train phase's batch made quant-aware
# (quant_aware's defaults: 8-bit weights per channel, 8-bit activations
# by a moving average at SLIM_RATE) under Adam(1e-4); its moving-average
# state after n steps must be the closed form rate^n + (1 - rate^n) /
# (1 - rate) from 1, within SLIM_STATE_RTOL (one f32 rounding an update);
# the converted program served at SLIM_SERVE_BATCHES. slim_vision:
# ResNet-50 at batch SLIM_RESNET_BATCH (224^2, 1000 classes,
# Momentum(0.1, 0.9)) quant-aware, a warm run and SLIM_RESNET_GRAPHED
# graphed steps; the unquantized ResNet-50 at that batch pruned by
# StructurePruner(SLIM_PRUNE_RATIO, axis=0) over its conv filters; the
# sensitivity of SLIM_SENSITIVITY_PARAMS filters at SLIM_SENSITIVITY_
# RATIOS; a ResNet-50 teacher distilled into a MobileNet v1 student
# (soft labels at SLIM_DISTILL_T) by the Compressor, SLIM_DISTILL_EPOCHS
# x SLIM_DISTILL_STEPS; the NAS controller server on loopback for
# SLIM_NAS_STEPS tokens.
SLIM_RATE = 0.9
SLIM_STATE_RTOL = 8 * 2.0 ** -24
SLIM_SERVE_BATCHES = (1, 8)
# the narrow quant-aware BERT card against CPU is held at bf16's PARITY_*
# (_card_vs_cpu's compute dtype): its activations and weights run on
# 8-bit levels (a step of 1/127 of a tensor's abs max), coarser than
# bf16's 8-bit significand, and an activation that another summation
# order moves by an ulp across a level moves by a whole step, so Adam's
# first steps flip the sign of more near-zero gradients than f32's
# 1e-6 share allows (a probe: 112 of 4.43M elements, none past
# PARITY_SIGN_FLIP_ATOL)
SLIM_PARITY = AMP_PARITY
SLIM_PARITY_DTYPE = "bfloat16"
SLIM_RESNET_BATCH = 32
SLIM_RESNET_GRAPHED = 4
SLIM_PRUNE_RATIO = 0.5
SLIM_SENSITIVITY_PARAMS = 3
SLIM_SENSITIVITY_RATIOS = (0.3, 0.7)
SLIM_DISTILL_T = 2.0
SLIM_DISTILL_EPOCHS, SLIM_DISTILL_STEPS = 2, 2
SLIM_DISTILL_LR = 0.01
SLIM_NAS_STEPS = 12
SLIM_NAS_TABLE = (4, 4, 4, 4, 4)
FAKE_QUANT_OPS = ("fake_quantize_dequantize_abs_max",
                  "fake_quantize_dequantize_moving_average_abs_max",
                  "fake_channel_wise_quantize_dequantize_abs_max")

_ROOT = os.path.dirname(os.path.abspath(__file__))
# every emitted line is also kept here whole: a chip run's printed output
# may come back cut to its end
_LOG = os.path.join(_ROOT, "chiprun_out", "chip_smoke.jsonl")
_failed = []
# wall seconds of each phase (summed over its calls), for the run's
# time budget
_seconds = {}
# replay-median step ms of the training phases, read by the phases that
# print a step beside them (amp_bert, amp_resnet)
_STEP_MS = {}


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


# the sleep kernel a timing queues its calls behind: SLEEP_CYCLES for the
# first repetition, then twice the host time those calls took to enqueue
# (at least SLEEP_MIN_MS), so that the calls still run back to back
SLEEP_CYCLES, SLEEP_MIN_MS = 20_000_000, 1.0
_CYCLES_PER_MS = []


def _sleep_cycles(torch, host_s):
    """Cycles of a sleep that covers ``host_s`` seconds of enqueue twice
    over, between SLEEP_MIN_MS and SLEEP_CYCLES; SLEEP_CYCLES for None."""
    if host_s is None:
        return SLEEP_CYCLES
    if not _CYCLES_PER_MS:
        _CYCLES_PER_MS.append(_cycles_per_ms(torch))
    ms = max(SLEEP_MIN_MS, 2e3 * host_s)
    return int(min(SLEEP_CYCLES, ms * _CYCLES_PER_MS[0]))


def _timed_behind_sleep(torch, calls, reps, per):
    """Median device time of ``calls()`` over ``per`` (CUDA events,
    queued behind a sleep kernel, so the host's launch cost stays off the
    clock)."""
    times, host_s = [], None
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(_sleep_cycles(torch, host_s))
        start.record()
        t0 = time.perf_counter()
        calls()
        host_s = time.perf_counter() - t0
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per)
    return statistics.median(times)


def time_ms(torch, fn, reps=7, inner=10):
    """Median device time of one call of ``fn`` (CUDA events over
    ``inner`` calls queued behind a sleep kernel)."""
    fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(inner):
            fn()
    return _timed_behind_sleep(torch, calls, reps, inner)


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
    def calls():
        for inputs in ring:
            fn(inputs)
    calls()
    torch.cuda.synchronize()
    return _timed_behind_sleep(torch, calls, reps, len(ring))


def _ring(torch, tensors):
    """Copies of ``tensors``, enough sets to exceed twice the L2."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    return [tuple(t.clone() for t in tensors)
            for _ in range(-(-2 * L2_BYTES // nbytes) + 1)]


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def nan_cases(torch, fa, bce):
    """NaN propagation, kernel against plain version: the flash forward
    with a NaN in the key mask (batch 0, key 0) and in one query element,
    f32 and bf16, and the CE forward with a NaN logit, must put NaN where
    the plain version does (the JAX package's arithmetic) and agree
    elsewhere: a kernel that turned a NaN into a finite value would hide
    a poisoned step from the numeric guard."""
    dev = torch.device("cuda", 0)
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=dev).manual_seed(SEED + 950)
        q, k, v = (torch.randn(2, 2, 128, 64, generator=g, device=dev)
                   .to(dtype) for _ in range(3))
        mask = torch.zeros(2, 1, 1, 128, device=dev, dtype=dtype)
        mask[0, 0, 0, 0] = float("nan")
        q[1, 0, 5, 3] = float("nan")
        got, lse = fa.flash_attention(q, k, v, mask)
        want, want_lse = fa.flash_attention_plain(q, k, v, mask)
        torch.cuda.synchronize()
        same = torch.equal(torch.isnan(got), torch.isnan(want)) and \
            torch.equal(torch.isnan(lse), torch.isnan(want_lse))
        keep = ~torch.isnan(want)
        err = _max_err(got[keep], want[keep])
        tol = TOL[("flash", str(dtype).split(".")[1])]
        out.append(dict(name="nan_mask_and_query_" + str(dtype).split(".")[1],
                        shape=[2, 2, 128, 128, 64], ok=same and err <= tol,
                        nan_positions_equal=same,
                        kernel_nans=int(torch.isnan(got).sum()),
                        plain_nans=int(torch.isnan(want).sum()),
                        max_abs_err=err, tol=tol))
    g = torch.Generator(device=dev).manual_seed(SEED + 951)
    x = torch.randn(256, 32000, generator=g, device=dev)
    x[3, 17] = float("nan")
    lab = torch.randint(0, 32000, (256,), generator=g, device=dev)
    loss, lse = bce.softmax_ce(x, lab)
    want_loss, want_lse = bce.softmax_ce_plain(x, lab)
    torch.cuda.synchronize()
    same = torch.equal(torch.isnan(loss), torch.isnan(want_loss)) and \
        torch.equal(torch.isnan(lse), torch.isnan(want_lse))
    keep = ~torch.isnan(want_loss)
    err = _max_err(loss[keep], want_loss[keep])
    ce = [dict(name="nan_logit", shape=[256, 32000],
               ok=same and err <= 1e-4, nan_positions_equal=same,
               kernel_nans=int(torch.isnan(loss).sum()),
               plain_nans=int(torch.isnan(want_loss).sum()),
               max_abs_err=err, tol=1e-4)]
    return out, ce


def flash_cases(torch, fa, F):
    """(name, b, h, tq, tk, d, dtype, mask mode, causal) on the card."""
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
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
        # fp16 (an fp16-decorated BERT or GPT): BERT-base serving's shape
        # with its key mask, GPT-base training's causal shape, and
        # amp_bert's fp16 step (batch 128 x 128; decorate casts the key
        # mask to fp16 with Q, K, V)
        ("bert_base_k_mask_f16", 8, 12, 512, 512, 64, f16, "k", False),
        ("gpt_train_causal_t4096_f16", 2, 12, 4096, 4096, 64, f16, None,
         True),
        ("bert_train_b128_k_mask_f16", 128, 12, 128, 128, 64, f16, "k16",
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
        tol = _flash_tol(TOL, dtype, want)
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


def _flash_tol(table, dtype, want):
    """A flash output's tolerance: the table's for f32 and bf16; for fp16
    FP16_REL_TOL of the output's largest magnitude."""
    if str(dtype) == "torch.float16":
        return FP16_REL_TOL * float(want.float().abs().max())
    return table[("flash", str(dtype).split(".")[1])]


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
    work SDPA's backward (``library_ms``) does in one call. A case's
    optional last field scales dO (the fp16 loss-scale cases)."""
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    ls = FP16_LOSS_SCALE * FP16_GRAD_STD
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
        # fp16 (an fp16-decorated model): BERT-base at T = 512 with its key
        # mask and GPT-base's causal T = 4096, each also with a dO that
        # carries the 2^16 loss scale
        ("bert_serve_k_mask_f16", 8, 12, 512, 512, 64, f16, "k", False),
        ("bert_serve_k_mask_f16_scaled", 8, 12, 512, 512, 64, f16, "k",
         False, ls),
        ("gpt_train_causal_t4096_f16", 2, 12, 4096, 4096, 64, f16, None,
         True),
        ("gpt_train_causal_t4096_f16_scaled", 2, 12, 4096, 4096, 64, f16,
         None, True, ls),
        # amp_bert's fp16 step: batch 128 x 128, the key mask in fp16,
        # plain and at the loss scale
        ("bert_train_b128_k_mask_f16", 128, 12, 128, 128, 64, f16, "k16",
         False),
        ("bert_train_b128_k_mask_f16_scaled", 128, 12, 128, 128, 64, f16,
         "k16", False, ls),
    ]
    dev = torch.device("cuda", 0)
    dkv, dq = [], []
    for i, (name, b, h, tq, tk, d, dtype, mode, causal, *do_scale) in \
            enumerate(cases):
        clock = _clock(tq >= 4096)
        q, k, v, do, mask = _flash_inputs(torch, dev, SEED + 200 + i, b, h,
                                          tq, tk, d, dtype, mode)
        if do_scale:
            do = (do.float() * do_scale[0]).to(dtype)
        scale = d ** -0.5
        out, lse = fa.flash_attention(q, k, v, mask, scale, causal)
        want_out, want_lse = fa.flash_attention_plain(q, k, v, mask, scale,
                                                      causal)
        fwd_err = _max_err(out, want_out)
        fwd_lse_err = _max_err(lse, want_lse)
        fwd_tol = _flash_tol(TOL, dtype, want_out)
        fwd_ok = fwd_err <= fwd_tol and fwd_lse_err <= TOL["stat"]
        delta = (do.float() * out.float()).sum(-1)
        args = (q, k, v, mask, lse, delta, do, scale, causal)
        got_k, got_v = fa.flash_attention_bwd_dkv(*args)
        got_q = fa.flash_attention_bwd_dq(*args)
        again_k, again_v = fa.flash_attention_bwd_dkv(*args)
        again_q = fa.flash_attention_bwd_dq(*args)
        want_q, want_k, want_v = fa.flash_attention_bwd_plain(*args)
        torch.cuda.synchronize()
        tol = _flash_tol(BWD_TOL, dtype, want_q)
        tol_kv = max(_flash_tol(BWD_TOL, dtype, want_k),
                     _flash_tol(BWD_TOL, dtype, want_v))
        err_kv = max(_max_err(got_k, want_k), _max_err(got_v, want_v))
        err_q = _max_err(got_q, want_q)
        finite = all(bool(torch.isfinite(t).all())
                     for t in (got_k, got_v, got_q))
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
            tol_kv=tol_kv, do_scale=do_scale[0] if do_scale else 1.0,
            ok=err_kv <= tol_kv and same_kv and fwd_ok and finite,
            bitwise_repeat=same_kv, kernel_ms=dkv_ms,
            **common, **_bound(8.0 * b * h * d * pairs +
                               2.0 * b * h * d * tk * no_key,
                               (2 * q.numel() + 4 * k.numel()) * el + side,
                               common["dtype"])))
        # dQ: 6*D flops per visible pair (s, dp, dq). Reads q,k,v,dO,
        # writes dq.
        dq.append(dict(
            name=name, max_abs_err=err_q,
            ok=err_q <= tol and same_q and fwd_ok and finite,
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
    version at the shapes of the main paths' parameters, each timed
    beside torch's fused Adam/AdamW; for each AdamW case, coeff = 0 must
    give the bits of the call Adam makes (no coeff) on the same inputs."""
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
             ("ocr_gru_projection", 768 * 600, f32, 0.0, 0.06, f32, 0.0),
             # the seq2seq's parameters (U(-0.1, 0.1), spread 0.1 / sqrt
             # 3): the source embedding (17191 x 512), the target
             # embedding and output projection (7709 x 512), an LSTM
             # weight ((512 + 512) x 2048) and bias (2048)
             ("seq2seq_src_embedding", SEQ2SEQ["src_vocab"] *
              SEQ2SEQ["hidden"], f32, 0.0, SEQ2SEQ_INIT / 3 ** 0.5, f32,
              0.0),
             ("seq2seq_trg_embedding", SEQ2SEQ["trg_vocab"] *
              SEQ2SEQ["hidden"], f32, 0.0, SEQ2SEQ_INIT / 3 ** 0.5, f32,
              0.0),
             ("seq2seq_lstm_weight", 2 * SEQ2SEQ["hidden"] * 4 *
              SEQ2SEQ["hidden"], f32, 0.0, SEQ2SEQ_INIT / 3 ** 0.5, f32,
              0.0),
             ("seq2seq_lstm_bias", 4 * SEQ2SEQ["hidden"], f32, 0.0,
              SEQ2SEQ_INIT / 3 ** 0.5, f32, 0.0),
             # control_flow's two parameters: cf_w (256 x 256, N(0,
             # 0.05^2)) and cf_u (256, constant 0.9)
             ("control_flow_w", CONTROL_FLOW_RNN[2] ** 2, f32, 0.0, 0.05,
              f32, 0.0),
             ("control_flow_u", CONTROL_FLOW_RNN[2], f32, 0.9, 0.0, f32,
              0.0),
             # DCGAN's generator fc weight (100 x 6272, N(0, 0.02^2)) and
             # word2vec's table (2073 x 32, Xavier-uniform spread)
             ("dcgan_generator_fc", DCGAN["noise_dim"] * 2 *
              DCGAN["base_channels"] * (DCGAN["image_size"] // 4) ** 2,
              f32, 0.0, 0.02, f32, 0.0),
             ("word2vec_embedding", WORD2VEC["vocab_size"] *
              WORD2VEC["emb_size"], f32, 0.0, (6.0 / (
                  WORD2VEC["vocab_size"] + WORD2VEC["emb_size"])) ** 0.5 /
              3 ** 0.5, f32, 0.0)]
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
    """The kernels' launch counters, zeroed together. ``read`` gives the
    eleven kernels' of the Pallas sites, ``read_all`` also the numeric
    guard's two (``finite_flags``, ``guarded_copy``), ``read_f16`` the
    flash kernels' launches of their fp16 instantiation."""

    def __init__(self, fa, ln, fad, bce, ng):
        self._guard = {"finite_flags": (ng, "launches"),
                       "guarded_copy": (ng, "copy_launches")}
        self._f16 = {"flash_attention_fwd": (fa, "f16_launches"),
                     "flash_attention_bwd_dkv": (fa, "f16_dkv_launches"),
                     "flash_attention_bwd_dq": (fa, "f16_dq_launches")}
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
        for mod, attr in list(self._fields.values()) + list(
                self._guard.values()) + list(self._f16.values()):
            setattr(mod, attr, 0)

    def read(self):
        return {k: getattr(mod, attr)
                for k, (mod, attr) in self._fields.items()}

    def read_all(self):
        return dict(self.read(), **{k: getattr(mod, attr)
                                    for k, (mod, attr) in
                                    self._guard.items()})

    def read_f16(self):
        return {k: getattr(mod, attr) for k, (mod, attr) in self._f16.items()}


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


def _recipe_schedule(ptt, base, decay_steps=RECIPE_DECAY_STEPS):
    """The recipe's rate: a linear warmup over a polynomial decay."""
    layers = ptt.layers
    return layers.linear_lr_warmup(
        layers.polynomial_decay(base, decay_steps=decay_steps,
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
                      scheduled=True, wrap=None,
                      decay_steps=RECIPE_DECAY_STEPS):
    """optimizer_fn: ``make(optimizer module, rate)`` under the recipe's
    schedule (else at the constant ``base``) and global-norm clip; the
    rate and the global norm land in ``fetch``. ``wrap(optimizer module,
    inner optimizer, loss)`` minimizes through a wrapper (EMA, Lookahead,
    ModelAverage) and returns it, kept in ``fetch["wrapper"]``."""
    def fn(loss):
        lr = _recipe_schedule(ptt, base, decay_steps) if scheduled \
            else base
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
    """Op types of the global block; the ops of the program's sub-blocks
    (a recomputed segment, run twice a step; a loop's or branch's body,
    run once a trip) apart under "segments"."""
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
    _STEP_MS[label] = statistics.median(step_ms[2:])
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


def _card_vs_cpu(np, ptt, main, startup, fetch_list, feed, target=None,
                 skip_step=None, dtype=None, state=None):
    """PARITY_STEPS runs of a training program on the card and on the CPU
    (plain versions) from the same startup weights, held to PARITY_*; on
    the card also op by op, which must give the graphed runs' bits: (the
    comparison's numbers, whether it passed). ``feed``: one feed, or a
    list of feeds, one a run. A wrapper's state (``_wrapper_state``) is
    held as the parameters are, its integer counters exactly. ``target``:
    what the Executor runs (a CompiledProgram of ``main``); ``skip_step``:
    the run its numeric guard must skip on every device (a non-finite
    loss, one "skip" numeric_fault event naming the same culprit), left
    out of the loss comparison. ``dtype``: the compute dtype whose
    tolerances apply, to the loss, the sign-flip share and each
    parameter element's ulps (a decorated program's, whose f32 master
    weights take their updates from gradients computed in ``dtype``;
    default the parameters' own). ``state``: a scope holding state the
    startup does not make (quant-aware training's moving averages),
    which the startup runs into."""
    feeds = feed if isinstance(feed, list) else [feed] * PARITY_STEPS
    from paddle_tpu_torch.framework import resilience
    from paddle_tpu_torch.io import set_params_from_numpy
    from paddle_tpu_torch.framework.scope import to_numpy
    init = ptt.Scope() if state is None else state
    with ptt.scope_guard(init):
        ptt.Executor().run(startup)
    # tensors, not numpy: bf16 weights keep their dtype
    arrays = {v.name: init.find_var(v.name).cpu()
              for v in main.list_vars() if v.persistable}
    runs, faults = {}, {}
    for label, place, cache in (("gpu", ptt.CUDAPlace(0), True),
                                ("gpu_op_by_op", ptt.CUDAPlace(0), False),
                                ("cpu", ptt.CPUPlace(), True)):
        scope = ptt.Scope()
        set_params_from_numpy(arrays, main, scope, place)
        exe = ptt.Executor(place)
        resilience.clear_events()
        t0 = time.perf_counter()
        with ptt.scope_guard(scope):
            losses = [float(np.asarray(exe.run(
                main if target is None else target, feed=step_feed,
                fetch_list=fetch_list,
                use_program_cache=cache)[0]).reshape(()))
                for step_feed in feeds]
        runs[label] = (losses, scope, (time.perf_counter() - t0) * 1e3)
        faults[label] = [(e["policy"], e.get("culprit"))
                         for e in resilience.events("numeric_fault")]
        exe.close()
    # the card's graphed runs (a warm run, a capture, a replay) against
    # its op-by-op runs: equal values, compared on the card
    op_scope = runs["gpu_op_by_op"][1]
    graphed_equal = np.array_equal(runs["gpu"][0], runs["gpu_op_by_op"][0],
                                   equal_nan=True) and all(
        _equal_on_card(runs["gpu"][1].find_var(v.name),
                       op_scope.find_var(v.name))
        for v in main.list_vars() if v.persistable)
    (gl, gs, g_ms), (cl, cs, c_ms) = runs["gpu"], runs["cpu"]
    skipped_ok = True
    if skip_step is not None:
        skipped_ok = all(
            not np.isfinite(runs[k][0][skip_step]) and len(faults[k]) == 1
            and faults[k][0][0] == "skip" and faults[k][0][1] and
            faults[k][0] == faults["cpu"][0] for k in runs)
        gl = [v for i, v in enumerate(gl) if i != skip_step]
        cl = [v for i, v in enumerate(cl) if i != skip_step]
    amp = dtype
    dtype = dtype or ("bfloat16" if any(p.dtype == "bfloat16"
                                        for p in main.all_parameters())
                      else "float32")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
    block = main.global_block()
    wrapper = [block.var(n) for n in _wrapper_state(main)]
    counters = [v.name for v in wrapper if v.dtype.startswith("int")]
    counters_equal = all(np.array_equal(to_numpy(gs.find_var(n)),
                                        to_numpy(cs.find_var(n)))
                         for n in counters)
    agreement, params_ok = _param_agreement(np, dtype, (
        (p.name, p.dtype if amp is None else amp, arrays[p.name],
         gs.find_var(p.name), cs.find_var(p.name))
        for p in main.all_parameters() + [v for v in wrapper
                                          if v.name not in counters]))
    ok = (loss_rel <= PARITY_LOSS_RTOL[dtype] and all(np.isfinite(gl))
          and params_ok and graphed_equal and counters_equal and skipped_ok)
    extra = {} if skip_step is None else {
        "skipped_step": skip_step, "skipped_on_every_device": skipped_ok,
        "numeric_faults": faults}
    return dict({"steps": len(feeds), "dropout": 0.0, "dtype": dtype,
            "wrapper_state": len(wrapper), "wrapper_counters": counters[:4],
            "wrapper_counters_equal": counters_equal,
            "gpu_losses": gl, "cpu_losses": cl, "loss_max_rel_err": loss_rel,
            "loss_rtol": PARITY_LOSS_RTOL[dtype]}, **agreement,
            gpu_ms=g_ms, cpu_ms=c_ms,
            graphed_bit_equal_op_by_op=graphed_equal, **extra), ok


def _equal_on_card(a, b):
    """np.array_equal of two tensors' host copies, computed where ``a``
    lies: same shape and dtype, equal values, NaN unequal to
    everything."""
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a, b.to(a.device))


def _param_agreement(np, dtype, tensors):
    """PARITY_* agreement of two devices' final tensors, each from the
    same start: ``tensors`` yields (name, the tensor's dtype, start, got,
    want) with arrays or tensors, compared as float32 on the card;
    ``dtype`` the model's (its sign-flip share). Each
    element within PARITY_PARAM_ATOL plus the tensor's own ulps but for
    a PARITY_SIGN_FLIP_SHARE of them, none beyond PARITY_SIGN_FLIP_ATOL;
    each tensor that moved at least PARITY_LR on ``want``'s side moved as
    far on ``got``'s within PARITY_MOVED_RTOL; the largest move at least
    10 PARITY_PARAM_ATOL. (the numbers, whether they pass)."""
    import torch
    beyond = elements = capped = 0
    param_err = moved = 0.0
    moved_errs = []
    for name, p_dtype, start, got, want in tensors:
        start, got, want = (
            (a if isinstance(a, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(a))).detach().to("cuda", torch.float32)
            for a in (start, got, want))
        diff = (got - want).abs()
        # the spacing of the tensor's own dtype at each element of want,
        # and the bounds, in float64
        _, exp = torch.frexp(torch.clamp(want.abs(), min=2.0 ** -126))
        ulps = PARITY_PARAM_ULPS[p_dtype] * torch.ldexp(
            torch.ones((), dtype=torch.float64, device=exp.device),
            (exp - 1 - MANTISSA_BITS[p_dtype]).double())
        wide = diff.double()
        param_err = max(param_err, float(diff.max()))
        beyond += int((wide > PARITY_PARAM_ATOL + ulps).sum())
        capped += int((wide > PARITY_SIGN_FLIP_ATOL + ulps).sum())
        elements += diff.numel()
        on_got, on_want = (got - start).abs(), (want - start).abs()
        moved = max(moved, float(on_got.max()))
        if float(on_want.max()) >= PARITY_LR:
            moved_errs.append((abs(float(on_got.sum()) / float(
                on_want.sum()) - 1.0), name))
    moved_errs.sort(reverse=True)
    ok = (capped == 0 and beyond <= PARITY_SIGN_FLIP_SHARE[dtype] * elements
          and bool(moved_errs) and moved_errs[0][0] <= PARITY_MOVED_RTOL
          and moved >= 10 * PARITY_PARAM_ATOL)
    return {"param_max_abs_err": param_err, "param_atol": PARITY_PARAM_ATOL,
            "param_ulps": PARITY_PARAM_ULPS, "param_elements": elements,
            "param_beyond_atol": beyond,
            "param_beyond_sign_flip_atol": capped,
            "sign_flip_atol": PARITY_SIGN_FLIP_ATOL,
            "sign_flip_share": PARITY_SIGN_FLIP_SHARE[dtype],
            "moved_rel_err_largest": moved_errs[:4],
            "moved_rtol": PARITY_MOVED_RTOL,
            "param_max_moved": moved}, ok


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
    _measured["gpt_train_step_ms"] = statistics.median(
        run["step_ms"][-DYGRAPH_TIMED:])
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
               fetch_list, want, families, mask=True, nonfinite=(),
               watch=None, on_run=None, start=None):
    """GRAPH_STEPS runs of ``main`` op by op and graphed, each way on its
    own copy of one started scope (the run counter included), then one
    run each way profiled: (the record, ok, the graphed way's fetches and
    state after its runs, the started scope). ``feed``: one feed
    for every run, or a list of feeds, one a run (a replay
    reads each from its static feeds). With ``mask`` the last fetch is a
    dropout Mask, which must differ from step to step. ``nonfinite``: the
    runs whose loss may be non-finite (a loss-scale overflow).
    ``on_run(k, before, scope, exe)`` is called on the graphed way after
    its run k (from 1), ``before`` holding the tensors that ``watch(k)``
    names as they were before that run. ``start``: a scope already
    holding state the startup does not make (quant-aware training's
    moving averages), which the startup runs into."""
    feeds = feed if isinstance(feed, list) else [feed] * GRAPH_STEPS
    feed = feeds[-1]
    start = ptt.Scope() if start is None else start
    ptt.Executor().run(startup, scope=start)    # no fetch list: no graph
    persist = [v.name for v in main.list_vars() if v.persistable]
    ways = {}
    for way, cache in (("op_by_op", False), ("graphed", True)):
        scope, exe = _copy_scope(torch, ptt, start), ptt.Executor()
        step_ms, fetched, per_step = [], [], []
        hook = cache and on_run is not None
        counters.zero()                      # the main path starts here
        for k, step_feed in enumerate(feeds, 1):
            if hook:
                held = {n: scope.find_var(n).clone() for n in watch(k)}
            before = counters.read()
            t0 = time.perf_counter()
            fetched.append(exe.run(main, feed=step_feed,
                                   fetch_list=fetch_list, scope=scope,
                                   use_program_cache=cache,
                                   return_numpy=False))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            after = counters.read()
            per_step.append({c: after[c] - before[c] for c in after})
            if hook:
                on_run(k, held, scope, exe)
                del held
        ways[way] = {"exe": exe, "scope": scope, "step_ms": step_ms,
                     "fetched": fetched, "per_step": per_step,
                     "launches": counters.read(),
                     "float16_launches": counters.read_f16()}
    a, b = ways["op_by_op"], ways["graphed"]

    def same(x, y):       # equal, or the same bits (a NaN of an overflow)
        return torch.equal(x, y) or _same_bits(torch, x, y)
    unequal = [fetch_list[i].name for i in range(len(fetch_list))
               if not all(same(x[i], y[i])
                          for x, y in zip(a["fetched"], b["fetched"]))]
    unequal += [n for n in persist if not same(
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
                            for i, f in enumerate(b["fetched"])
                            if i not in nonfinite)
    record = {
        "steps": len(feeds), "bit_equal": not unequal,
        "unequal": unequal[:8], "masks_differ_step_to_step": masks_differ,
        "losses": {w: [float(f[0].reshape(())) for f in ways[w]["fetched"]]
                   for w in ways},
        "step_ms": {w: ways[w]["step_ms"] for w in ways},
        "replay_ms_median": statistics.median(b["step_ms"][2:]),
        "op_by_op_ms_median": statistics.median(a["step_ms"][1:]),
        "launches_per_step": {w: ways[w]["per_step"][-1] for w in ways},
        "launches_per_step_ok": counts_ok,
        "launches_by_way": {w: ways[w]["launches"] for w in ways},
        "float16_launches_by_way": {w: ways[w]["float16_launches"]
                                    for w in ways},
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


def _resnet_program(np, ptt, resnet, batch, wrap=None, before=None):
    """bench.py:472-486: ResNet-50 training with Momentum(0.1, 0.9) (or
    ``wrap`` of it: a decorated optimizer) and its batch (RandomState(0):
    uniform images, random labels): (main, startup, [loss, acc1, acc5],
    feed). ``before(loss)`` runs before the optimizer's ops are added (a
    program pass: quant_aware)."""
    def opt_fn(loss):
        if before is not None:
            before(loss)
        opt = ptt.optimizer.Momentum(0.1, 0.9)
        (wrap(opt) if wrap else opt).minimize(loss)
    with ptt.unique_name.guard():
        main, startup, _, fetch = resnet.resnet_train_program(
            depth=50, class_dim=RESNET_CLASSES, image_shape=(3, 224, 224),
            optimizer_fn=opt_fn)
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
    _STEP_MS["resnet_train"] = replay_ms
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
    _STEP_MS["graph_resnet"] = record["replay_ms_median"]
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
                     rtol, atol, atol_scaled=False, moved_rtol=None,
                     bounded=None):
    """PARITY_STEPS runs of a training program on the card (graphed, and
    op by op) and on the CPU from the same startup weights: every fetch
    of every run within its (rtol, atol) of ``fetch_tols``, every
    persistable within (rtol, atol), integer ones equal (``atol_scaled``:
    atol times the CPU tensor's largest magnitude, at least 1; with
    ``moved_rtol``, a float persistable is held instead by the L2 norm of
    its card-CPU difference within ``moved_rtol`` of how far the CPU's
    steps moved it, plus atol per element; ``bounded``: {name: bound},
    persistables held instead by their largest card-CPU difference
    within the bound); the card's graphed runs equal its op-by-op runs
    bit for bit. (the comparison's numbers, whether it passed)."""
    from paddle_tpu_torch.framework.scope import to_numpy
    from paddle_tpu_torch.io import set_params_from_numpy
    init = ptt.Scope()
    ptt.Executor().run(startup, scope=init)
    persist = sorted(v.name for v in main.list_vars() if v.persistable)
    arrays = {n: init.find_var(n).cpu() for n in persist}
    runs, faults = {}, {}
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
    beyond, worst, moved, moved_ratio = [], (0.0, None), 0.0, 0.0
    for n in persist:
        if n in (bounded or {}):
            if float(np.abs(gs[n] - cs[n]).max()) > bounded[n]:
                beyond.append(n)
            continue
        if gs[n].dtype.kind in "iu":
            if not np.array_equal(gs[n], cs[n]):
                beyond.append(n)
            continue
        diff = np.abs(gs[n] - cs[n])
        tol = atol * max(1.0, float(np.abs(cs[n]).max())) \
            if atol_scaled and cs[n].size else atol
        if moved_rtol is not None:
            step = float(np.linalg.norm(cs[n] - to_numpy(arrays[n])))
            err = float(np.linalg.norm(diff))
            moved_ratio = max(moved_ratio, err / max(step, 1e-30))
            if err > moved_rtol * step + tol * diff.size ** 0.5:
                beyond.append(n)
        elif not np.allclose(gs[n], cs[n], rtol=rtol, atol=tol):
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
            "beyond_tolerance": beyond[:8], "moved_rtol": moved_rtol,
            "max_err_over_moved_l2": moved_ratio if moved_rtol else None,
            "max_abs_err": worst[0],
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


def _stacked_cell(ptt, n_layers, hidden, name, dropout=0.0):
    """The recipe's encoder/decoder cell: ``n_layers`` LSTMCells (weights
    U(-SEQ2SEQ_INIT, SEQ2SEQ_INIT)), each layer's output (after an
    upscale-in-train dropout where ``dropout`` > 0) the next one's input;
    states [[h, c], ...]."""
    class Stacked(ptt.layers.RNNCell):
        def __init__(self):
            attr = ptt.ParamAttr(initializer=ptt.initializer.Uniform(
                -SEQ2SEQ_INIT, SEQ2SEQ_INIT, seed=SEED))
            self.cells = [ptt.layers.LSTMCell(hidden, param_attr=attr,
                                              name="%s_l%d" % (name, i))
                          for i in range(n_layers)]

        @property
        def state_shape(self):
            return [c.state_shape for c in self.cells]

        def call(self, inputs, states):
            new = []
            for cell, state in zip(self.cells, states):
                inputs, s = cell(inputs, state)
                if dropout > 0:
                    inputs = ptt.layers.dropout(
                        inputs, dropout,
                        dropout_implementation="upscale_in_train")
                new.append(s)
            return inputs, new
    return Stacked()


def _seq2seq_programs(ptt, w, lr=SEQ2SEQ_LR, dropout=0.0):
    """PaddleNLP seq2seq's base model from the port's user API: (train
    main, its startup, [loss, logits], the beam decode program (batch
    -1), [ids (N, beam, T), scores (N, beam)]); the two programs share
    every parameter name. tests/test_torch_seq2seq.py builds the same
    (dropout 0) in both packages."""
    L = ptt.layers

    def emb(ids, vocab, name):
        return L.embedding(ids, size=[vocab, w["hidden"]],
                           param_attr=ptt.ParamAttr(
                               name=name, initializer=ptt.initializer.Uniform(
                                   -SEQ2SEQ_INIT, SEQ2SEQ_INIT, seed=SEED)))

    def proj(x, flatten):
        return L.fc(x, w["trg_vocab"], num_flatten_dims=flatten,
                    bias_attr=False, param_attr=ptt.ParamAttr(
                        name="out_w", initializer=ptt.initializer.Uniform(
                            -SEQ2SEQ_INIT, SEQ2SEQ_INIT, seed=SEED)))

    def encoder(batch):
        src = L.data("src", [batch, w["src_len"]], "int64",
                     append_batch_size=False)
        src_len = L.data("src_len", [batch], "int64",
                         append_batch_size=False)
        x = emb(src, w["src_vocab"], "src_emb")
        zero = [[L.fill_constant_batch_size_like(x, [-1, w["hidden"]],
                                                 "float32", 0.0)
                 for _ in range(2)] for _ in range(w["n_layers"])]
        _, final = L.rnn(_stacked_cell(ptt, w["n_layers"], w["hidden"], "enc",
                                       dropout), x, initial_states=zero,
                         sequence_length=src_len)
        return final

    train, startup = ptt.Program(), ptt.Program()
    with ptt.unique_name.guard(), ptt.program_guard(train, startup):
        final = encoder(w["batch"])
        trg = L.data("trg", [w["batch"], w["trg_len"]], "int64",
                     append_batch_size=False)
        trg_len = L.data("trg_len", [w["batch"]], "int64",
                         append_batch_size=False)
        label = L.data("label", [w["batch"], w["trg_len"], 1], "int64",
                       append_batch_size=False)
        out, _ = L.rnn(_stacked_cell(ptt, w["n_layers"], w["hidden"], "dec",
                                     dropout),
                       emb(trg, w["trg_vocab"], "trg_emb"),
                       initial_states=final)
        logits = proj(out, 2)
        ce = L.softmax_with_cross_entropy(logits, label)
        mask = L.unsqueeze(L.sequence_mask(trg_len, maxlen=w["trg_len"],
                                           dtype="float32"), [2])
        loss = L.reduce_sum(L.reduce_mean(L.elementwise_mul(ce, mask),
                                          dim=[0]))
        ptt.optimizer.Adam(lr, grad_clip=ptt.clip.GradientClipByGlobalNorm(
            SEQ2SEQ_CLIP)).minimize(loss)
    startup.random_seed = SEED
    decode = ptt.Program()
    with ptt.unique_name.guard(), ptt.program_guard(decode, ptt.Program()):
        final = encoder(-1)
        decoder = L.BeamSearchDecoder(
            _stacked_cell(ptt, w["n_layers"], w["hidden"], "dec"),
            start_token=SEQ2SEQ_BOS, end_token=SEQ2SEQ_EOS,
            beam_size=w["beam"], embedding_fn=lambda ids: L.reshape(
                emb(ids, w["trg_vocab"], "trg_emb"), [-1, w["hidden"]]),
            output_fn=lambda h: proj(h, 1))
        ids, states = L.dynamic_decode(decoder, inits=final,
                                       max_step_num=w["max_decode"])
    return train, startup, [loss, logits], decode, [ids, states.log_probs]


def _seq2seq_batch(np, w, seed=0, n=None):
    """Token ids in [3, vocab) (0 pad, 1 bos, 2 eos) and lengths in
    [1, len], the target fed from bos and labelled up to eos."""
    rng = np.random.RandomState(seed)
    n = w["batch"] if n is None else n
    s, t = w["src_len"], w["trg_len"]
    src_len, trg_len = rng.randint(1, s + 1, n), rng.randint(1, t + 1, n)
    src = rng.randint(3, w["src_vocab"], (n, s))
    src[np.arange(s)[None, :] >= src_len[:, None]] = 0
    trg = rng.randint(3, w["trg_vocab"], (n, t))
    trg[:, 0] = SEQ2SEQ_BOS
    label = np.concatenate([trg[:, 1:], np.full((n, 1), SEQ2SEQ_EOS)], 1)
    return {"src": src.astype(np.int64), "src_len": src_len.astype(np.int64),
            "trg": trg.astype(np.int64), "trg_len": trg_len.astype(np.int64),
            "label": label[..., None].astype(np.int64)}


def _beams_ok(np, ids, scores, vocab):
    """Beam decode output (N, beam, T) ids, (N, beam) scores: ids in
    range, an ended beam emitting only the end token, beams best first,
    scores finite."""
    ended = np.cumsum(ids == SEQ2SEQ_EOS, axis=2) > 0
    return bool(ids.min() >= 0 and ids.max() < vocab and
                (ids[:, :, 1:][ended[:, :, :-1]] == SEQ2SEQ_EOS).all() and
                np.isfinite(scores).all() and
                (np.diff(scores, axis=1) <= 0).all())


def seq2seq_train(torch, np, ptt, counters):
    """The seq2seq at SEQ2SEQ (dropout 0.2 between layers, as published),
    TRAIN_STEPS steps on one batch through Executor.run (graphed from the
    second, no refusal): losses finite and falling, SEQ2SEQ_PER_STEP
    launches a step; target tokens/s over the replays, the first run's
    host time, an op-by-op step's device time and kernels by op type."""
    t0 = time.perf_counter()
    main, startup, fetch_list, _, _ = _seq2seq_programs(ptt, SEQ2SEQ,
                                                        dropout=0.2)
    fetch_list = fetch_list[:1]
    feed = _seq2seq_batch(np, SEQ2SEQ)
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
    finite = all(np.isfinite(losses))
    falling = losses[-1] < losses[0]
    graph_runs = dict(exe.graph_runs)
    graphed = graph_runs["capture"] == 1 and not exe.refusals
    counts_ok, record = _train_record(
        torch, np, exe, main, scope, feed, fetch_list, step_ms, per_step,
        _no_launches(counters, **SEQ2SEQ_PER_STEP), resident, peak)
    replay_s = record["replay_ms_median"] / 1e3
    tokens = SEQ2SEQ["batch"] * SEQ2SEQ["trg_len"]
    ok = finite and falling and graphed and counts_ok
    emit(dict({"phase": "seq2seq_train", "ok": ok,
               "model": "seq2seq_lstm_iwslt15_en_vi", "dtype": "float32",
               "dropout": 0.2, "optimizer": "Adam(%g), global-norm clip %g"
               % (SEQ2SEQ_LR, SEQ2SEQ_CLIP), "setup_s": setup_s,
               "target_tokens_per_s_replays": tokens / replay_s,
               "valid_target_tokens_per_s_replays": int(
                   feed["trg_len"].sum()) / replay_s,
               "losses": losses, "finite": finite, "falling": falling,
               "graph_runs": graph_runs,
               "refusals": list(exe.refusals.values()),
               "launches": launches}, **dict(SEQ2SEQ, **record)))
    if not ok:
        raise AssertionError("seq2seq_train checks failed (see the line "
                             "above)")
    return launches, (exe, main, scope, feed, fetch_list)


def seq2seq_serve(torch, np, ptt, counters, model_dir, trained_scope):
    """seq2seq_train's weights in the beam decode (SEQ2SEQ's beam and
    max_decode), saved with save_inference_model and served through
    create_predictor on the card at SEQ2SEQ_SERVE_BATCHES (one request a
    batch, sent five times: cold, captured, then replayed):
    every answer equal to its batch's cold, op-by-op answer bit for bit,
    the beams well formed, no hand-written kernel launched, no refusal;
    request ms and sentences/s over the replays, a replay profiled."""
    from paddle_tpu_torch.inference import Config, create_predictor
    _, _, _, decode, fetch = _seq2seq_programs(ptt, SEQ2SEQ)
    with ptt.scope_guard(trained_scope):
        ptt.save_inference_model(model_dir, ["src", "src_len"], fetch,
                                 ptt.Executor(), main_program=decode)
    pred = create_predictor(Config(model_dir))
    requests = {}
    for n in sorted(set(SEQ2SEQ_SERVE_BATCHES)):
        f = _seq2seq_batch(np, SEQ2SEQ, seed=n, n=n)
        requests[n] = {"src": f["src"], "src_len": f["src_len"]}
    counters.zero()                          # the main path starts here
    lat, served, equal = {}, {}, True
    for n in SEQ2SEQ_SERVE_BATCHES:
        t1 = time.perf_counter()
        out = pred.run(requests[n])          # numpy: synchronised
        lat.setdefault(n, []).append((time.perf_counter() - t1) * 1e3)
        if n in served:
            equal = equal and all(np.array_equal(a, b)
                                  for a, b in zip(out, served[n]))
        else:
            served[n] = out
    launches = counters.read()
    beams_ok = all(out[0].shape == (n, SEQ2SEQ["beam"],
                                    SEQ2SEQ["max_decode"]) and
                   _beams_ok(np, out[0], out[1], SEQ2SEQ["trg_vocab"])
                   for n, out in served.items())
    exe = pred._exe
    graph_runs = dict(exe.graph_runs)
    big = max(SEQ2SEQ_SERVE_BATCHES)
    found = _profiled(torch, lambda: pred.run(requests[big]))
    found.pop("kernel_names")
    replay_ms = {n: statistics.median(ms[2:]) for n, ms in lat.items()}
    ok = equal and beams_ok and not exe.refusals and \
        graph_runs["capture"] == len(served) and \
        launches == _no_launches(counters)
    emit({"phase": "seq2seq_serve", "ok": ok,
          "model": "seq2seq_lstm_iwslt15_en_vi", "beam": SEQ2SEQ["beam"],
          "max_decode": SEQ2SEQ["max_decode"],
          "request_batches": list(SEQ2SEQ_SERVE_BATCHES),
          "request_ms": lat, "replay_ms": replay_ms,
          "sentences_per_s_replays": {n: n / (ms / 1e3)
                                      for n, ms in replay_ms.items()},
          "replays_equal_cold": equal, "beams_ok": beams_ok,
          "served_ops": len(pred._program.global_block().ops),
          "graph_runs": graph_runs,
          "refusals": list(exe.refusals.values()),
          "launches": launches, "captures": _capture_record(exe),
          "profile_batch_%d" % big: found})
    close_executor(torch, "seq2seq_serve", exe)
    if not ok:
        raise AssertionError("seq2seq_serve checks failed (see the line "
                             "above)")
    return launches


def _host_choice_program(ptt):
    """cond, switch_case and an unbounded while_loop over a vector:
    (main, feed names, fetch list)."""
    L = ptt.layers
    main = ptt.Program()
    with ptt.unique_name.guard(), ptt.program_guard(main, ptt.Program()):
        x = L.data("x", [CONTROL_FLOW_WIDTH], "float32",
                   append_batch_size=False)
        flag = L.data("flag", [1], "float32", append_batch_size=False)
        idx = L.data("idx", [1], "int64", append_batch_size=False)
        n = L.data("n", [1], "int64", append_batch_size=False)
        a = L.cond(L.greater_than(L.reduce_sum(flag), 0.5),
                   lambda: L.tanh(x), lambda: L.scale(x, 2.0, bias=1.0))
        b = L.switch_case(idx, {0: lambda: L.exp(L.scale(x, 0.1)),
                                1: lambda: L.elementwise_mul(x, a),
                                2: lambda: L.sigmoid(a)},
                          default=lambda: L.scale(a, -1.0))
        c0 = L.fill_constant([1], "int64", 0)
        c, v = L.while_loop(
            lambda c, v: L.less_than(c, n),
            lambda c, v: [L.increment(c, 1, in_place=False),
                          L.scale(v, 0.5, bias=1.0)], [c0, b])
    return main, [a, b, c, v]


def _device_loop_program(ptt):
    """A training step whose control flow stays on the device: a
    StaticRNN over CONTROL_FLOW_RNN, a bounded_while of
    CONTROL_FLOW_TRIPS iterations whose predicate turns false half way,
    select_input between two branches; Adam(1e-3). (main, startup,
    [loss])."""
    L = ptt.layers
    t, b, d = CONTROL_FLOW_RNN
    main, startup = ptt.Program(), ptt.Program()
    with ptt.unique_name.guard(), ptt.program_guard(main, startup):
        x = L.data("x", [t, b, d], "float32", append_batch_size=False)
        pick = L.data("pick", [1], "int32", append_batch_size=False)
        w = L.create_parameter([d, d], "float32", name="cf_w",
                               default_initializer=ptt.initializer.Normal(
                                   0.0, 0.05, seed=SEED))
        u = L.create_parameter([d], "float32", name="cf_u",
                               default_initializer=ptt.initializer.Constant(
                                   0.9))
        rnn = L.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)
            h_prev = rnn.memory(shape=[-1, d], batch_ref=x_t)
            h = L.tanh(L.elementwise_add(L.matmul(x_t, w), h_prev))
            rnn.update_memory(h_prev, h)
            rnn.step_output(h)
        hs = rnn()
        i0 = L.fill_constant([1], "float32", 0.0)
        _, v = L.while_loop(
            lambda i, v: L.less_than(L.reduce_sum(i),
                                     CONTROL_FLOW_TRIPS / 2 - 0.5),
            lambda i, v: (L.scale(i, bias=1.0), L.sqrt(
                L.elementwise_add(L.square(L.elementwise_mul(v, u)),
                                  L.fill_constant([1], "float32", 1e-3)))),
            [i0, L.reduce_mean(hs, dim=[0])],
            maximum_trip_count=CONTROL_FLOW_TRIPS)
        helper = ptt.layer_helper.LayerHelper("select_input")
        sel = helper.create_variable_for_type_inference("float32", (b, d))
        helper.append_op("select_input", inputs={
            "X": [v.name, L.scale(v, -2.0).name], "Mask": [pick.name]},
            outputs={"Out": [sel.name]})
        loss = L.reduce_mean(L.square(sel))
        ptt.optimizer.Adam(1e-3).minimize(loss)
    startup.random_seed = SEED
    return main, startup, [loss]


def control_flow(torch, np, ptt, counters):
    """The functional control flow on CUDA tensors. cond, switch_case
    and while_loop: each of CONTROL_FLOW_FEEDS through Executor.run with
    the program cache (the graphed path's entry), which must refuse
    capture, record the refusal once naming the op, and run op by op
    (no capture, no replay), the answers equal to the CPU's (rtol 1e-6:
    tanh, exp and sigmoid are the library's on each side) and the trip
    counts exact; host ms a run. Then the device loops' training step
    (bounded_while, StaticRNN, select_input) op by op against graphed
    (_both_ways): fetches and state bit for bit, 2 Adam launches a step;
    its capture is not refused."""
    main, fetch = _host_choice_program(ptt)
    rng = np.random.RandomState(SEED)
    x = rng.randn(CONTROL_FLOW_WIDTH).astype(np.float32)
    gexe, cexe = ptt.Executor(), ptt.Executor(ptt.CPUPlace())
    gscope, cscope = ptt.Scope(), ptt.Scope()
    counters.zero()                          # the main path starts here
    runs, ms, agree, trips_ok = [], [], True, True
    for flag, idx, n in CONTROL_FLOW_FEEDS:
        feed = {"x": x, "flag": np.array([flag], np.float32),
                "idx": np.array([idx], np.int64), "n": np.array([n])}
        t0 = time.perf_counter()
        got = gexe.run(main, feed=feed, fetch_list=fetch, scope=gscope)
        ms.append((time.perf_counter() - t0) * 1e3)
        want = cexe.run(main, feed=feed, fetch_list=fetch, scope=cscope)
        agree = agree and all(np.allclose(g, w, rtol=1e-6, atol=0.0)
                              for g, w in zip(got, want))
        trips_ok = trips_ok and int(got[2][0]) == n
        runs.append({"flag": flag, "idx": idx, "trips": n,
                     "max_abs_err": max(float(np.abs(g - w).max())
                                        for g, w in zip(got, want))})
    launches = counters.read()
    refusals = list(gexe.refusals.values())
    graph_runs = dict(gexe.graph_runs)
    refused_ok = len(refusals) == 1 and "{cond}" in refusals[0] \
        and graph_runs == {"warm": 0, "capture": 0, "replay": 0,
                           "refused": len(CONTROL_FLOW_FEEDS)} and \
        not gexe.capture_log
    close_executor(torch, "control_flow host", gexe)
    dmain, dstart, dfetch = _device_loop_program(ptt)
    t, b, d = CONTROL_FLOW_RNN
    feeds = [{"x": np.random.RandomState(s).randn(t, b, d).astype(
        np.float32), "pick": np.array([s % 2], np.int32)}
        for s in range(GRAPH_STEPS)]
    record, loops_ok, _, _, loop_launches = _both_ways(
        torch, np, ptt, counters, "control_flow", dmain, dstart, feeds,
        dfetch, _no_launches(counters, **CONTROL_FLOW_PER_STEP),
        ("fused_adam",), mask=False)
    ok = agree and trips_ok and refused_ok and loops_ok and \
        launches == _no_launches(counters)
    emit({"phase": "control_flow", "ok": ok, "width": CONTROL_FLOW_WIDTH,
          "host_choice": {"runs": runs, "run_ms": ms,
                          "equal_cpu_rtol_1e-6": agree,
                          "trip_counts_exact": trips_ok,
                          "refusals": refusals, "graph_runs": graph_runs,
                          "refused_op_by_op_ok": refused_ok,
                          "launches": launches},
          "device_loops": dict(record, rnn_time_batch_width=list(
              CONTROL_FLOW_RNN), bounded_trips=CONTROL_FLOW_TRIPS)})
    if not ok:
        raise AssertionError("control_flow checks failed (see the line "
                             "above)")
    return _sum_launches(launches, loop_launches)


def seq2seq_parity(torch, np, ptt):
    """The seq2seq at SEQ2SEQ_PARITY, PARITY_STEPS Adam(PARITY_LR) steps
    on one batch, the card graphed (and op by op) against the CPU
    (``_card_vs_cpu_all``); then the beam decode from the startup's
    weights, three runs on the card (op by op, captured, replayed: equal
    bit for bit) against the CPU (``_compare_decodes``)."""
    w = SEQ2SEQ_PARITY
    main, startup, fetch, decode, dfetch = _seq2seq_programs(
        ptt, w, lr=PARITY_LR)
    feed = _seq2seq_batch(np, w, seed=5)
    train, train_ok = _card_vs_cpu_all(
        np, ptt, main, startup, fetch, feed, [(1e-5, 0.0), (1e-4, 1e-5)],
        SEQ2SEQ_PARITY_RTOL, SEQ2SEQ_PARITY_ATOL)
    init = ptt.Scope()
    ptt.Executor().run(startup, scope=init)
    arrays = {p.name: init.find_var(p.name).cpu()
              for p in decode.all_parameters()}
    dfeed = {k: feed[k] for k in ("src", "src_len")}
    runs = {}
    for label, place in (("gpu", ptt.CUDAPlace(0)), ("cpu", ptt.CPUPlace())):
        scope, exe = ptt.Scope(), ptt.Executor(place)
        ptt.set_params_from_numpy(arrays, decode, scope, place)
        got = [exe.run(decode, feed=dfeed, fetch_list=dfetch, scope=scope)
               for _ in range(3)]              # op by op, capture, replay
        runs[label] = (got, scope, exe)
    (gpu, gscope, gexe), (cpu, _, cexe) = runs["gpu"], runs["cpu"]
    replays_equal = all(np.array_equal(a, b) for run in gpu[1:]
                        for a, b in zip(run, gpu[0]))

    def with_bos(out):
        """(ids with a leading bos column, as _compare_decodes reads a
        decode whose position 0 is no choice; scores)."""
        ids = out[0]
        bos = np.full(ids.shape[:2] + (1,), SEQ2SEQ_BOS, ids.dtype)
        return [np.concatenate([bos, ids], 2)[..., None], out[1]]
    decoded, decode_ok = _compare_decodes(
        np, decode, with_bos(gpu[-1]), with_bos(cpu[-1]),
        lambda name: gexe.run(decode, feed=dfeed, fetch_list=[name],
                              scope=gscope)[0])
    beams_ok = _beams_ok(np, gpu[-1][0], gpu[-1][1], w["trg_vocab"])
    gexe.close()
    cexe.close()
    ok = train_ok and decode_ok and replays_equal and beams_ok
    emit({"phase": "seq2seq_parity", "ok": ok, "widths": w, "train": train,
          "decode": dict(decoded, graphed_equals_op_by_op=replays_equal,
                         beams_ok=beams_ok)})
    if not ok:
        raise AssertionError("seq2seq_parity checks failed (see the line "
                             "above)")


def _replay_equals_op_by_op(torch, ptt, exe, main, scope, feed, fetch_list):
    """One more step of a captured key replayed on ``scope`` and the same
    step op by op on a copy of it (the run counter included): (fetches
    and every persistable bit for bit equal, the names that differ)."""
    twin = _copy_scope(torch, ptt, scope)
    got = exe.run(main, feed=feed, fetch_list=fetch_list, scope=scope,
                  return_numpy=False)
    want = exe.run(main, feed=feed, fetch_list=fetch_list, scope=twin,
                   use_program_cache=False, return_numpy=False)
    torch.cuda.synchronize()
    unequal = [f.name for f, a, b in zip(fetch_list, got, want)
               if not torch.equal(a, b)]
    unequal += [v.name for v in main.list_vars() if v.persistable and
                not torch.equal(scope.find_var(v.name),
                                twin.find_var(v.name))]
    return not unequal, unequal[:8]


def _train_zoo(torch, np, ptt, counters, main, startup, feed, fetch_list,
               steps, want):
    """``steps`` steps of ``main`` on the card (graphed from the second),
    then one replay against an op-by-op step: the numbers every zoo
    training phase reports, whether its checks passed, the launches and
    (exe, scope)."""
    scope, exe = ptt.Scope(), ptt.Executor()      # CUDAPlace(0)
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses, per_step, launches = _steps(
        torch, np, ptt, counters, exe, main, scope, feed, fetch_list, steps)
    peak = torch.cuda.max_memory_allocated()
    equal, unequal = _replay_equals_op_by_op(torch, ptt, exe, main, scope,
                                             feed, fetch_list)
    finite = all(np.isfinite(v) for row in losses for v in row)
    counts_ok = all(c == want for c in per_step)
    replays = step_ms[2:] or step_ms[-1:]
    record = {"parameters": sum(int(np.prod(p.shape))
                                for p in main.all_parameters()),
              "program_ops": _n_ops(_op_counts(main)), "step_ms": step_ms,
              "replay_ms_median": statistics.median(replays),
              "losses": losses, "finite": finite,
              "launches_per_step": per_step[-1],
              "launches_per_step_ok": counts_ok,
              "replay_bit_equal_op_by_op": equal, "unequal": unequal,
              "resident_gb": resident / 2 ** 30,
              "peak_mem_gb": peak / 2 ** 30,
              "step_peak_above_resident_gb": (peak - resident) / 2 ** 30,
              "captures": _capture_record(exe)}
    return record, finite and counts_ok and equal, launches, (exe, scope)


def _sum_counts(total, launches):
    return {k: total.get(k, 0) + v for k, v in launches.items()}


def vision_train(torch, np, ptt, counters):
    """MobileNet v1, VGG-16 and SE-ResNeXt-50 (VISION_ARCHS), each at
    bench.py:472-486's ResNet-50 settings (batch 128 x 3 x 224 x 224, 1000
    classes, Momentum(0.1, 0.9), VGG-16 at 0.01: VISION_LR;
    RandomState(0) images and labels),
    TRAIN_STEPS steps graphed from the second: losses finite, the first
    update lowering the loss, no hand-written kernel launched, a replay
    equal to an op-by-op step bit for bit; images/s over the replays,
    peak memory above resident, the capture's time, the step beside its
    f32 FFMA bound; SE-ResNeXt-50's op-by-op step's device time by op
    type (its 32-group convolutions)."""
    from paddle_tpu_torch.models import vision
    rng = np.random.RandomState(0)
    feed = {"image": rng.rand(VISION_BATCH, 3, 224, 224).astype(np.float32),
            "label": rng.randint(0, RESNET_CLASSES, (VISION_BATCH, 1)
                                 ).astype(np.int64)}
    total, archs, ok = {}, {}, True
    for arch in VISION_ARCHS:
        with ptt.unique_name.guard():
            main, startup, _, fetch = vision.classification_train_program(
                arch, class_dim=RESNET_CLASSES, image_shape=(3, 224, 224),
                optimizer_fn=lambda loss: ptt.optimizer.Momentum(
                    VISION_LR[arch], 0.9).minimize(loss))
        startup.random_seed = SEED
        fetch_list = [fetch["loss"], fetch["acc"]]
        record, good, launches, (exe, scope) = _train_zoo(
            torch, np, ptt, counters, main, startup, feed, fetch_list,
            TRAIN_STEPS, _no_launches(counters))
        losses = record["losses"]
        descends = losses[1][0] < losses[0][0]
        flops = _step_flops(main, VISION_BATCH)
        record.update(
            first_update_descends=descends,
            images_per_s_replays=VISION_BATCH / (
                record["replay_ms_median"] / 1e3),
            step_flops=flops,
            fp32_ffma_bound_ms=flops / FP32_FFMA_FLOPS * 1e3)
        if arch == "se_resnext50":
            record["device_ms_by_op_type_op_by_op"] = _device_ms_by_op_type(
                torch, lambda: exe.run(main, feed=feed,
                                       fetch_list=fetch_list, scope=scope,
                                       use_program_cache=False))
        archs[arch] = record
        ok = ok and good and descends
        total = _sum_counts(total, launches)
        close_executor(torch, "vision_train " + arch, exe)
        del exe, scope
    emit({"phase": "vision_train", "ok": ok, "batch": VISION_BATCH,
          "classes": RESNET_CLASSES, "image": [3, 224, 224],
          "optimizer": "Momentum(VISION_LR, 0.9)", "lr": VISION_LR,
          "archs": archs})
    if not ok:
        raise AssertionError("vision_train checks failed (see the line "
                             "above)")
    return total


def _yolo_programs(ptt, yolov3, widths, batch, tiny, lr=YOLO_LR):
    """YOLOv3's training program (Momentum(lr, 0.9) with L2Decay), its
    inference program (YOLO_SERVE), each under a fresh unique_name guard
    so their parameter names match, and a synthetic batch: (main,
    startup, [loss], infer, [pred, pre-NMS boxes, pre-NMS scores], feed,
    nms attrs)."""
    with ptt.unique_name.guard():
        main, startup, _, fetch = yolov3.yolov3_train_program(
            tiny=tiny, optimizer_fn=lambda loss: ptt.optimizer.Momentum(
                lr, 0.9, regularization=ptt.regularizer.L2Decay(
                    YOLO_DECAY)).minimize(loss), **widths)
    startup.random_seed = SEED
    serve = dict(YOLO_SERVE, class_num=widths["class_num"],
                 image_size=widths["image_size"], tiny=tiny)
    with ptt.unique_name.guard():
        infer, _, _, ifetch = yolov3.yolov3_infer_program(**serve)
    nms = next(op for op in infer.global_block().ops
               if op.type == "multiclass_nms")
    targets = [ifetch["pred"]] + [infer.global_block().var(
        nms.input(slot)[0]) for slot in ("BBoxes", "Scores")]
    feed = yolov3.synthetic_detection_batch(
        batch, widths["image_size"], widths["max_box"],
        widths["class_num"], seed=0)
    return main, startup, [fetch["loss"]], infer, targets, feed, nms.attrs


def yolo_train(torch, np, ptt, counters):
    """YOLOv3 (darknet-53, three scales) at PaddleCV yolov3's training
    settings (YOLO, YOLO_BATCH, Momentum(0.001, 0.9) with L2Decay(5e-4);
    the program's ignore_thresh 0.7, no label smoothing), TRAIN_STEPS
    steps on synthetic_detection_batch graphed from the second: losses
    finite, the first update lowering the loss, no hand-written kernel, a
    replay equal to an op-by-op step bit for bit; images/s, the step's
    FFMA bound, an op-by-op step's device time by op type."""
    from paddle_tpu_torch.models import yolov3
    main, startup, fetch_list, _, _, feed, _ = _yolo_programs(
        ptt, yolov3, YOLO, YOLO_BATCH, tiny=False)
    record, ok, launches, (exe, scope) = _train_zoo(
        torch, np, ptt, counters, main, startup, feed, fetch_list,
        TRAIN_STEPS, _no_launches(counters))
    losses = record["losses"]
    descends = losses[1][0] < losses[0][0]
    flops = _step_flops(main, YOLO_BATCH)
    record.update(
        first_update_descends=descends,
        images_per_s_replays=YOLO_BATCH / (record["replay_ms_median"] / 1e3),
        step_flops=flops, fp32_ffma_bound_ms=flops / FP32_FFMA_FLOPS * 1e3,
        device_ms_by_op_type_op_by_op=_device_ms_by_op_type(
            torch, lambda: exe.run(main, feed=feed, fetch_list=fetch_list,
                                   scope=scope, use_program_cache=False)))
    ok = ok and descends
    close_executor(torch, "yolo_train", exe)
    emit(dict({"phase": "yolo_train", "ok": ok, "model": "yolov3",
               "widths": YOLO, "batch": YOLO_BATCH,
               "optimizer": "Momentum(0.001, 0.9), L2Decay(5e-4)"},
              **record))
    if not ok:
        raise AssertionError("yolo_train checks failed (see the line "
                             "above)")
    return launches


def _plain_nms(torch, boxes, scores, attrs):
    """The port's multiclass_nms (plain torch) on the CPU, on copies of
    ``boxes`` and ``scores`` (numpy): its Out."""
    from paddle_tpu_torch.ops import detection_ops
    out = detection_ops._multiclass_nms(
        None, {"BBoxes": [torch.from_numpy(boxes)],
               "Scores": [torch.from_numpy(scores)]}, attrs)
    return out["Out"].numpy()


def _serve_yolo(torch, np, ptt, counters, model_dir, scope, infer, targets,
                requests, attrs, cpu_batch):
    """Save ``infer`` from ``scope`` and serve ``requests`` through
    create_predictor on the card, each batch cold (op by op), captured,
    then replayed: every replay equal to the cold answer bit for bit; the
    pre-NMS boxes and scores of ``cpu_batch`` against the CPU's; the NMS
    output of each answer equal to the plain NMS run on the CPU on the
    card's own pre-NMS tensors. (record, ok, launches)."""
    from paddle_tpu_torch.inference import Config, create_predictor
    with ptt.scope_guard(scope):
        ptt.save_inference_model(model_dir, ["image", "im_size"], targets,
                                 ptt.Executor(), main_program=infer)
    config = Config(model_dir)
    config.batch_buckets = tuple(sorted({len(r["image"])
                                         for r in requests}))
    pred = create_predictor(config)
    counters.zero()                          # the main path starts here
    cases, ok = [], True
    for req in requests:
        n = len(req["image"])
        ms, answers = [], []
        for _ in range(2 + YOLO_SERVE_REPLAYS):   # cold, capture, replays
            t0 = time.perf_counter()
            answers.append(pred.run(req))          # numpy: synchronised
            ms.append((time.perf_counter() - t0) * 1e3)
        replays_equal = all(np.array_equal(a, b) for run in answers[1:]
                            for a, b in zip(run, answers[0]))
        out, boxes, scores = answers[-1]
        nms_equal = np.array_equal(out, _plain_nms(torch, boxes, scores,
                                                   attrs))
        kept = (out[..., 1] > 0).sum(-1)
        cases.append({"batch": n, "request_ms": ms, "cold_ms": ms[0],
                      "replay_ms_median": statistics.median(ms[2:]),
                      "replays_bit_equal_cold": replays_equal,
                      "nms_equal_plain_nms_of_card_inputs": nms_equal,
                      "kept_per_image": kept.tolist(),
                      "finite": bool(np.isfinite(out).all())})
        ok = ok and replays_equal and nms_equal and \
            bool(np.isfinite(out).all()) and out.shape[0] == n
    launches = counters.read()
    cpu_req = next(r for r in requests if len(r["image"]) == cpu_batch)
    cpu_config = Config(model_dir)
    cpu_config.place = ptt.CPUPlace()
    t0 = time.perf_counter()
    cpu = create_predictor(cpu_config).run(cpu_req)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    card = pred.run(cpu_req)
    errs = {}
    for name, got, want in (("boxes", card[1], cpu[1]),
                            ("scores", card[2], cpu[2])):
        atol = YOLO_BOX_ATOL_SHARE * float(np.abs(want).max())
        errs[name] = {"max_abs_err": float(np.abs(got - want).max()),
                      "atol": atol, "ok": bool(np.allclose(
                          got, want, rtol=YOLO_BOX_RTOL, atol=atol))}
        ok = ok and errs[name]["ok"]
    for case in cases:
        req = next(r for r in requests if len(r["image"]) == case["batch"])
        prof = _profiled(torch, lambda req=req: pred.run(req))
        prof.pop("kernel_names")
        case["kernels_per_request"] = prof["device_kernels"]
        case["profile"] = prof
    big = max(requests, key=lambda r: len(r["image"]))
    _, boxes, scores = pred.run(big)
    b = torch.from_numpy(boxes).to(pred._exe.device)
    s = torch.from_numpy(scores).to(pred._exe.device)
    from paddle_tpu_torch.ops import detection_ops
    nms_prof = _profiled(torch, lambda: detection_ops._multiclass_nms(
        None, {"BBoxes": [b], "Scores": [s]}, attrs))
    nms_prof.pop("kernel_names")
    record = {"cases": cases, "launches": launches,
              "cpu_batch": cpu_batch, "cpu_request_ms": cpu_ms,
              "card_vs_cpu_pre_nms": errs, "rtol": YOLO_BOX_RTOL,
              "captures": _capture_record(pred._exe),
              "nms_alone_batch": len(big["image"]),
              "nms_alone_op_by_op": nms_prof}
    close_executor(torch, "yolo_serve", pred._exe)
    return record, ok and launches == _no_launches(counters), launches


def yolo_serve(torch, np, ptt, counters, model_dir):
    """YOLOv3 at PaddleCV's inference settings (YOLO_SERVE: conf 0.005,
    400 candidates a class, 100 kept, NMS IoU 0.45), saved with
    save_inference_model and served through create_predictor at
    YOLO_SERVE_BATCHES (``_serve_yolo``): ms and kernels a request, no
    hand-written kernel; the NMS alone profiled op by op at batch 8. Its
    weights: the training program's startup (seeded; both programs built
    under fresh unique_name guards, so the inference program finds them
    by name), the batch norms' moving statistics calibrated by
    YOLO_CALIBRATION_RUNS runs of the training program's forward (no
    optimizer) on synthetic_detection_batch. Not yolo_train's weights:
    six steps at a constant 0.001 without PaddleCV's warmup diverge
    (PERF.md). Not the startup's statistics either: with moving variance
    1 the 23 residual adds of darknet-53 grow the activations until
    exp(tw) overflows to inf and a masked box is inf * 0 = NaN, as in the
    JAX package's arithmetic."""
    from paddle_tpu_torch.models import yolov3
    _, startup, _, infer, targets, feed, attrs = _yolo_programs(
        ptt, yolov3, YOLO, YOLO_BATCH, tiny=False)
    with ptt.unique_name.guard():
        calib, _, _, cfetch = yolov3.yolov3_train_program(tiny=False, **YOLO)
    scope, exe = ptt.Scope(), ptt.Executor()
    exe.run(startup, scope=scope)
    t0 = time.perf_counter()
    for _ in range(YOLO_CALIBRATION_RUNS):
        exe.run(calib, feed=feed, fetch_list=[cfetch["loss"]], scope=scope)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    exe.close()
    side = YOLO["image_size"]
    rng = np.random.RandomState(SEED)
    requests = [{"image": rng.rand(n, 3, side, side).astype(np.float32),
                 "im_size": np.tile(np.array([[side, side]], np.int32),
                                    (n, 1))}
                for n in YOLO_SERVE_BATCHES]
    record, ok, launches = _serve_yolo(torch, np, ptt, counters, model_dir,
                                       scope, infer, targets, requests,
                                       attrs, cpu_batch=1)
    emit(dict({"phase": "yolo_serve", "ok": ok, "model": "yolov3",
               "serve": YOLO_SERVE, "batches": list(YOLO_SERVE_BATCHES),
               "calibration_runs": YOLO_CALIBRATION_RUNS,
               "calibration_s": calib_s}, **record))
    if not ok:
        raise AssertionError("yolo_serve checks failed (see the line "
                             "above)")
    return launches


def dcgan_train(torch, np, ptt, counters):
    """DCGAN at the fluid models repo's MNIST settings (DCGAN, batch 128,
    the program's Adam(2e-4, beta1 0.5) for each player), TRAIN_STEPS
    steps graphed from the second: d_loss and g_loss finite, 16 fused-Adam
    launches a step (6 discriminator, 10 generator), a replay equal to an
    op-by-op step bit for bit; the records the in-place rule copies;
    samples/s."""
    from paddle_tpu_torch.framework import trace
    from paddle_tpu_torch.models import dcgan
    cfg = dcgan.DCGANConfig(**DCGAN)
    with ptt.unique_name.guard():
        main, startup, _, fetch = dcgan.dcgan_train_program(cfg)
    startup.random_seed = SEED
    feed = dcgan.synthetic_batch(cfg, DCGAN_BATCH, seed=0)
    fetch_list = [fetch["d_loss"], fetch["g_loss"]]
    record, ok, launches, (exe, scope) = _train_zoo(
        torch, np, ptt, counters, main, startup, feed, fetch_list,
        TRAIN_STEPS, _no_launches(counters, **DCGAN_PER_STEP))
    blk = main.global_block()
    kept = trace.overwritten_inputs(blk, trace.wanted_grads(blk)[1])
    record.update(
        samples_per_s_replays=DCGAN_BATCH / (
            record["replay_ms_median"] / 1e3),
        in_place_rule_copies=sorted(
            op.input(slot)[i] for op in blk.ops if op.desc_id in kept
            for slot, idx in kept[op.desc_id].items() for i in idx))
    close_executor(torch, "dcgan_train", exe)
    emit(dict({"phase": "dcgan_train", "ok": ok, "widths": DCGAN,
               "batch": DCGAN_BATCH}, **record))
    if not ok:
        raise AssertionError("dcgan_train checks failed (see the line "
                             "above)")
    return launches


def simple_train(torch, np, ptt, counters):
    """The book's MLP (784-200-200-10) and word2vec (WORD2VEC) at batch
    128 with Adam(1e-3), SIMPLE_STEPS steps each graphed from the second:
    losses finite, 6 and 3 fused-Adam launches a step, a replay equal to
    an op-by-op step bit for bit."""
    from paddle_tpu_torch.models import simple
    rng = np.random.RandomState(0)
    opt = lambda loss: ptt.optimizer.Adam(SIMPLE_LR).minimize(loss)  # noqa
    with ptt.unique_name.guard():
        mlp = simple.mlp_classifier_program(optimizer_fn=opt)
    with ptt.unique_name.guard():
        w2v = simple.word2vec_program(optimizer_fn=opt, **WORD2VEC)
    runs = {
        "mlp": (mlp, {"x": rng.rand(SIMPLE_BATCH, 784).astype(np.float32),
                      "y": rng.randint(0, 10, (SIMPLE_BATCH, 1)).astype(
                          np.int64)}, MLP_PER_STEP),
        "word2vec": (w2v, {n: rng.randint(
            0, WORD2VEC["vocab_size"], (SIMPLE_BATCH, 1)).astype(np.int64)
            for n in w2v[2]}, WORD2VEC_PER_STEP)}
    total, records, ok = {}, {}, True
    for name, ((main, startup, _, fetch), feed, per_step) in runs.items():
        startup.random_seed = SEED
        record, good, launches, (exe, _) = _train_zoo(
            torch, np, ptt, counters, main, startup, feed, [fetch["loss"]],
            SIMPLE_STEPS, _no_launches(counters, **per_step))
        records[name] = record
        ok = ok and good
        total = _sum_counts(total, launches)
        close_executor(torch, "simple_train " + name, exe)
    emit({"phase": "simple_train", "ok": ok, "batch": SIMPLE_BATCH,
          "word2vec": WORD2VEC, "runs": records})
    if not ok:
        raise AssertionError("simple_train checks failed (see the line "
                             "above)")
    return total


def _zoo_classifier(ptt, vision, arch, image):
    """A narrow classifier of ``vision``'s blocks trained on cross_entropy
    with Momentum(0.01, 0.9): (main, startup, [loss, acc])."""
    main, startup = ptt.Program(), ptt.Program()
    with ptt.unique_name.guard(), ptt.program_guard(main, startup):
        img = ptt.layers.data("image", list(image), "float32")
        label = ptt.layers.data("label", [1], "int64")
        if arch == "mobilenet_blocks":
            y = vision._conv_bn(img, 8, 3, stride=2)
            for ch_in, ch_out, stride in ((32, 64, 1), (64, 128, 2),
                                          (128, 128, 1)):
                y = vision._depthwise_separable(y, ch_in, ch_out, stride,
                                                0.25)
            pool = ptt.layers.pool2d(y, pool_type="avg",
                                     global_pooling=True)
            prob = ptt.layers.fc(pool, size=10, act="softmax")
        elif arch == "vgg11":
            prob = vision.vgg_net(img, class_dim=10, layers_cfg=11,
                                  is_test=True)
        else:
            y = vision._conv_bn(img, 16, 3)
            y = vision._se_bottleneck(y, 16, 64, stride=2, cardinality=32)
            pool = ptt.layers.pool2d(y, pool_type="avg",
                                     global_pooling=True)
            prob = ptt.layers.fc(pool, size=10, act="softmax")
        loss = ptt.layers.reduce_mean(ptt.layers.cross_entropy(prob, label))
        acc = ptt.layers.accuracy(prob, label)
        ptt.optimizer.Momentum(0.01, 0.9).minimize(loss)
    startup.random_seed = SEED
    return main, startup, [loss, acc]


def _conv_precision(torch):
    """cuDNN's convolutions as the port runs them (deterministic, TF32
    off) against a float64 CPU reference: the forward, input and filter
    gradients' largest difference over the reference's largest
    magnitude, for a plain 3x3, SE-ResNeXt's 32-group and MobileNet's
    depthwise convolutions (CONV_PRECISION_CASES), beside the CPU's f32."""
    import torch.nn.functional as F
    out = {}
    for name, xs, ws, groups, stride in CONV_PRECISION_CASES:
        g = torch.Generator().manual_seed(SEED)
        x = torch.randn(xs, generator=g)
        w = torch.randn(ws, generator=g) * 0.1
        cot = torch.randn(F.conv2d(x, w, stride=stride, padding=1,
                                   groups=groups).shape, generator=g)

        def run(dev, dtype):
            xx = x.to(dev, dtype).requires_grad_()
            ww = w.to(dev, dtype).requires_grad_()
            y = F.conv2d(xx, ww, stride=stride, padding=1, groups=groups)
            dx, dw = torch.autograd.grad(y, [xx, ww], cot.to(dev, dtype))
            return [t.detach().double().cpu() for t in (y, dx, dw)]
        ref = run("cpu", torch.float64)
        out[name] = {}
        for label, dev in (("cudnn", "cuda"), ("cpu_f32", "cpu")):
            got = run(dev, torch.float32)
            out[name][label] = {
                k: float((a - b).abs().max() / b.abs().max())
                for k, a, b in zip(("y", "dx", "dw"), got, ref)}
    return out


def _dcgan_parity(np, ptt):
    """DCGAN at ZOO_PARITY_DCGAN, PARITY_STEPS steps card against CPU:
    (the comparison, ok). Its generator's backward runs after the
    discriminator's in-place Adam on the card, so this is the check that
    shows the in-place rule there."""
    from paddle_tpu_torch.models import dcgan
    cfg = dcgan.DCGANConfig(**ZOO_PARITY_DCGAN)
    with ptt.unique_name.guard():
        main, startup, _, fetch = dcgan.dcgan_train_program(cfg)
    startup.random_seed = SEED
    return _card_vs_cpu_all(
        np, ptt, main, startup, [fetch["d_loss"], fetch["g_loss"]],
        dcgan.synthetic_batch(cfg, ZOO_PARITY_BATCH, seed=3),
        [(PARITY_FETCH_RTOL, 0.0), (PARITY_FETCH_RTOL, 0.0)],
        ZOO_PARITY_RTOL, ZOO_PARITY_ATOL, atol_scaled=True)


def zoo_parity(torch, np, ptt, counters, model_dir):
    """Each new model narrow (ZOO_PARITY_*), PARITY_STEPS steps on the card
    graphed (and op by op) against the CPU from the same startup
    (``_card_vs_cpu_all``); tiny YOLOv3 then served from the card's
    trained weights card against CPU (``_serve_yolo``). DCGAN's check is
    the one that shows the in-place rule on the card: its generator's
    backward reads the discriminator from before the in-place Adam."""
    from paddle_tpu_torch.models import vision, yolov3
    results, ok = {}, True
    rng = np.random.RandomState(7)
    for arch, image in (("mobilenet_blocks", (3, 32, 32)),
                        ("vgg11", (3, 32, 32)),
                        ("se_bottleneck", (3, 16, 16))):
        main, startup, fetch_list = _zoo_classifier(ptt, vision, arch, image)
        feed = {"image": rng.rand(ZOO_PARITY_BATCH, *image).astype(
                    np.float32),
                "label": rng.randint(0, 10, (ZOO_PARITY_BATCH, 1)).astype(
                    np.int64)}
        results[arch], good = _card_vs_cpu_all(
            np, ptt, main, startup, fetch_list, feed,
            [(ZOO_KINK_LOSS_RTOL, 0.0), (0.0, 0.0)], ZOO_PARITY_RTOL,
            ZOO_PARITY_ATOL, atol_scaled=True, moved_rtol=ZOO_KINK_MOVED_RTOL)
        ok = ok and good
    main, startup, fetch_list, infer, targets, feed, attrs = _yolo_programs(
        ptt, yolov3, ZOO_PARITY_YOLO, 2, tiny=True)
    results["tiny_yolov3"], good = _card_vs_cpu_all(
        np, ptt, main, startup, fetch_list, feed, [(ZOO_KINK_LOSS_RTOL, 0.0)],
        ZOO_PARITY_RTOL, ZOO_PARITY_ATOL, atol_scaled=True,
        moved_rtol=ZOO_KINK_MOVED_RTOL)
    ok = ok and good
    scope = ptt.Scope()
    ptt.Executor().run(startup, scope=scope)
    exe = ptt.Executor()
    exe.run(main, feed=feed, fetch_list=fetch_list, scope=scope)
    exe.close()
    side = ZOO_PARITY_YOLO["image_size"]
    requests = [{"image": rng.rand(n, 3, side, side).astype(np.float32),
                 "im_size": np.tile(np.array([[side, side]], np.int32),
                                    (n, 1))} for n in (1, 4)]
    results["tiny_yolov3_serve"], good, _ = _serve_yolo(
        torch, np, ptt, counters, model_dir, scope, infer, targets,
        requests, attrs, cpu_batch=4)
    ok = ok and good
    results["dcgan"], good = _dcgan_parity(np, ptt)
    ok = ok and good
    results["conv_precision"] = _conv_precision(torch)
    emit({"phase": "zoo_parity", "ok": ok, "batch": ZOO_PARITY_BATCH,
          "models": results})
    if not ok:
        raise AssertionError("zoo_parity checks failed (see the line "
                             "above)")


# -- the compiled front door, the numeric guard, resilient training ------

def _bits(torch, t):
    """``t``'s raw bits (a float tensor viewed as integers), so that two
    NaNs of one pattern compare equal."""
    t = t.detach().contiguous()
    if t.is_floating_point():
        return t.view({2: torch.int16, 4: torch.int32,
                       8: torch.int64}[t.element_size()])
    return t


def _same_bits(torch, a, b):
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return a.shape == b.shape and a.dtype == b.dtype and \
            torch.equal(_bits(torch, a), _bits(torch, b.to(a.device)))
    return a == b


def _unequal_state(torch, names, a, b):
    """The names (and the run counter) whose values differ in bits
    between scopes (or snapshots) ``a`` and ``b``."""
    from paddle_tpu_torch.framework.executor import _SALT_VAR
    get_a = a.find_var if hasattr(a, "find_var") else a.get
    get_b = b.find_var if hasattr(b, "find_var") else b.get
    out = [n for n in names if not _same_bits(torch, get_a(n), get_b(n))]
    if (get_a(_SALT_VAR) or 0) != (get_b(_SALT_VAR) or 0):
        out.append(_SALT_VAR)
    return out


def _guard_program(ptt, bert, cfg, batch):
    """train_recipe's program (AdamW, the schedule, the clip) with the
    schedule's decay over GUARD_DECAY_STEPS: (main, startup, [loss,
    mlm_loss, nsp_loss])."""
    return _pretrain_program(ptt, bert, cfg, batch, _recipe_optimizer(
        ptt, lambda o, lr: o.AdamW(lr, weight_decay=RECIPE_WEIGHT_DECAY),
        RECIPE_LR, decay_steps=GUARD_DECAY_STEPS))


def _started(ptt, startup):
    scope = ptt.Scope()
    ptt.Executor().run(startup, scope=scope)
    return scope


def _guard_family_ms(found):
    fams = found["device_ms_by_family"]
    return {k: fams.get(k, 0.0) for k in ("finite_flags", "guarded_copy")}


def compiled_recipe(torch, np, ptt, counters):
    """The recipe step (BERT-base bf16, batch 128 x 128, dropout 0.1,
    AdamW, the schedule and the clip) through a fluid script's front
    door: GUARD_STEPS runs each of ``Executor.run(main)``,
    ``Executor.run(CompiledProgram(main).with_data_parallel(loss_name=,
    build_strategy=BuildStrategy(), exec_strategy=ExecutionStrategy()))``,
    ``ParallelExecutor(use_cuda=True, loss_name=)`` and the compiled
    program with ``check_numerics=True``, each on its own copy of one
    started scope: every fetch and persistable equal to the Executor's
    bit for bit, TRAIN_PER_STEP launches a step (and one finite-check
    launch with the guard); replay ms with and without the guard, the
    guard's device ms in a profiled replay, its launches and pool
    bytes."""
    from paddle_tpu_torch.models import bert
    cfg = bert.bert_base(dtype="bfloat16")
    t0 = time.perf_counter()
    main, startup, fetch_list = _guard_program(ptt, bert, cfg,
                                               BF16_TRAIN_BATCH)
    loss = fetch_list[0]
    feeds = [bert.synthetic_batch(cfg, BF16_TRAIN_BATCH, TRAIN_SEQ,
                                  TRAIN_PREDS, seed=s)
             for s in range(GUARD_STEPS)]
    start = _started(ptt, startup)
    setup_s = time.perf_counter() - t0
    persist = [v.name for v in main.list_vars() if v.persistable]

    def compiled(**kw):
        return ptt.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, build_strategy=ptt.BuildStrategy(**kw),
            exec_strategy=ptt.ExecutionStrategy())
    ways = {}
    for way in ("executor", "compiled", "parallel_executor", "guarded"):
        scope = _copy_scope(torch, ptt, start)
        if way == "parallel_executor":
            pe = ptt.ParallelExecutor(use_cuda=True, loss_name=loss.name,
                                      main_program=main, scope=scope)
            exe = pe._exe

            def run(f, pe=pe):
                return pe.run(fetch_list, feed=f, return_numpy=False)
            mesh = pe._compiled._build_strategy.mesh_axes
        else:
            exe = ptt.Executor()
            target = {"executor": main, "compiled": compiled(),
                      "guarded": compiled(check_numerics=True)}[way]
            mesh = None if way == "executor" else \
                target._build_strategy.mesh_axes

            def run(f, exe=exe, target=target, scope=scope):
                return exe.run(target, feed=f, fetch_list=fetch_list,
                               scope=scope, return_numpy=False)
        step_ms, fetched, per_step = [], [], []
        counters.zero()                      # the main path starts here
        for f in feeds:
            before = counters.read_all()
            t1 = time.perf_counter()
            fetched.append(run(f))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            after = counters.read_all()
            per_step.append({k: after[k] - before[k] for k in after})
        ways[way] = {"exe": exe, "scope": scope, "run": run,
                     "fetched": fetched, "step_ms": step_ms,
                     "per_step": per_step, "mesh_axes": mesh,
                     "launches": counters.read_all()}
    ref = ways["executor"]
    record, ok = {}, True
    for way, w in ways.items():
        fetch_equal = all(_same_bits(torch, a, b)
                          for x, y in zip(w["fetched"], ref["fetched"])
                          for a, b in zip(x, y))
        unequal = _unequal_state(torch, persist, w["scope"], ref["scope"])
        want = dict(TRAIN_PER_STEP, finite_flags=int(way == "guarded"),
                    guarded_copy=0)
        counts_ok = all(c == want for c in w["per_step"])
        finite = all(np.isfinite(float(f[0].reshape(())))
                     for f in w["fetched"])
        ok = ok and fetch_equal and not unequal and counts_ok and finite
        record[way] = {
            "mesh_axes": w["mesh_axes"], "fetches_bit_equal": fetch_equal,
            "state_unequal": unequal[:8], "launches_per_step": w["per_step"][-1],
            "launches_ok": counts_ok, "step_ms": w["step_ms"],
            "replay_ms_median": statistics.median(w["step_ms"][2:]),
            "losses": [float(f[0].reshape(())) for f in w["fetched"]],
            "captures": [dict(c, launches=None) for c in w["exe"].capture_log]}
    g = ways["guarded"]
    found = {w: _profiled(torch, lambda w=w: ways[w]["run"](feeds[-1]))
             for w in ("compiled", "guarded")}
    guard_ms = _guard_family_ms(found["guarded"])
    plain_replay = record["compiled"]["replay_ms_median"]
    guard_replay = record["guarded"]["replay_ms_median"]
    cap = g["exe"].capture_log[-1]
    emit({"phase": "compiled_recipe", "ok": ok, "model": "bert_base",
          "dtype": cfg.dtype, "batch": BF16_TRAIN_BATCH,
          "seq_len": TRAIN_SEQ, "dropout": cfg.hidden_dropout,
          "decay_steps": GUARD_DECAY_STEPS, "setup_s": setup_s,
          "ways": record, "state_tensors": len(persist),
          "guard": {"policy": "raise (check_numerics=True)",
                    "replay_ms": guard_replay, "unguarded_replay_ms":
                    plain_replay, "step_share": guard_replay / plain_replay
                    - 1, "device_ms": guard_ms,
                    "device_busy_ms": {w: found[w]["device_busy_ms"]
                                       for w in found},
                    "launches_per_step": {"finite_flags": 1,
                                          "guarded_copy": 0},
                    "checked_tensors": len(next(iter(
                        g["exe"]._guards.values())).names),
                    "capture_pool_bytes": cap["pool_bytes"],
                    "unguarded_capture_pool_bytes":
                        ways["compiled"]["exe"].capture_log[-1]["pool_bytes"]},
          "profile": {w: {k: v for k, v in found[w].items()
                          if k != "kernel_names"} for w in found}})
    launches = _sum_launches(*[w["launches"] for w in ways.values()])
    for way, w in ways.items():
        close_executor(torch, "compiled_recipe %s" % way, w["exe"])
    if not ok:
        raise AssertionError("compiled_recipe checks failed (see the line "
                             "above)")
    return launches


def numeric_skip(torch, np, ptt, counters):
    """numeric_policy="skip" on the recipe step at full width, graphed:
    GUARD_STEPS runs with ``executor.step:corrupt=input_mask@3`` poisoning
    the third run's batch (a non-finite loss; every persistable and the
    run counter equal to their values before it, bit for bit; one
    numeric_fault event naming a culprit), the later runs equal to a clean
    run of the same batches without the poisoned one bit for bit; then a
    GUARD_WINDOW-step run_steps window with step GUARD_WINDOW_POISON
    poisoned, equal to the window without that batch (the event's step
    is GUARD_WINDOW_POISON); the skip budget (GUARD_SKIP_BUDGET with
    ``@1+``: the third consecutive skip raises SkipBudgetExceededError, a
    clean step ends the streak); and "raise" naming a culprit, its
    poisoned state written back, graphed equal to op by op. Replay ms
    with the skip guard and without, its device ms, launches and pool
    bytes."""
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.framework import faultinject, resilience
    cfg = bert.bert_base(dtype="bfloat16")
    main, startup, fetch_list = _guard_program(ptt, bert, cfg,
                                               BF16_TRAIN_BATCH)
    loss = fetch_list[0]
    persist = [v.name for v in main.list_vars() if v.persistable]

    def batch(seed):
        return bert.synthetic_batch(cfg, BF16_TRAIN_BATCH, TRAIN_SEQ,
                                    TRAIN_PREDS, seed=seed)
    start = _started(ptt, startup)
    guarded, clean = _copy_scope(torch, ptt, start), \
        _copy_scope(torch, ptt, start)
    exe = ptt.Executor()
    skip = ptt.CompiledProgram(main, ptt.BuildStrategy(
        numeric_policy="skip", numeric_skip_budget=GUARD_SKIP_BUDGET)
    ).with_data_parallel(loss_name=loss.name)
    feeds = [batch(100 + s) for s in range(GUARD_STEPS)]
    poisoned = GUARD_POISON_RUN - 1
    resilience.clear_events()
    got, step_ms, per_step = [], [], []
    counters.zero()                          # the main path starts here
    with faultinject.failpoints(["executor.step:corrupt=input_mask@%d"
                                 % GUARD_POISON_RUN]):
        for i, f in enumerate(feeds):
            if i == poisoned:
                pre = _snapshot(torch, guarded)
            before = counters.read_all()
            t1 = time.perf_counter()
            got.append(exe.run(skip, feed=f, fetch_list=fetch_list,
                               scope=guarded, return_numpy=False))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            after = counters.read_all()
            per_step.append({k: after[k] - before[k] for k in after})
            if i == poisoned:
                reverted = _unequal_state(torch, persist, pre, guarded)
                del pre
    launches = counters.read_all()
    faults = resilience.events("numeric_fault")
    clean_ms, ref = [], []
    for i, f in enumerate(feeds):
        if i == poisoned:
            continue
        t1 = time.perf_counter()
        ref.append(exe.run(main, feed=f, fetch_list=fetch_list, scope=clean,
                           return_numpy=False))
        torch.cuda.synchronize()
        clean_ms.append((time.perf_counter() - t1) * 1e3)
    kept = [o for i, o in enumerate(got) if i != poisoned]
    run_equal = all(_same_bits(torch, a, b) for x, y in zip(kept, ref)
                    for a, b in zip(x, y))
    run_state = _unequal_state(torch, persist, guarded, clean)
    poisoned_loss = float(got[poisoned][0].reshape(()))
    want = dict(TRAIN_PER_STEP, **GUARD_SKIP_PER_STEP)
    run_ok = (not reverted and run_equal and not run_state
              and not np.isfinite(poisoned_loss)
              and len(faults) == 1 and faults[0]["policy"] == "skip"
              and bool(faults[0].get("culprit"))
              and all(c == want for c in per_step[1:]))
    # the window: run_steps with step GUARD_WINDOW_POISON poisoned,
    # against the clean window without that batch
    wfeeds = [batch(200 + s) for s in range(GUARD_WINDOW)]
    stacked = {k: np.stack([f[k] for f in wfeeds]) for k in wfeeds[0]}
    stacked["input_mask"][GUARD_WINDOW_POISON].reshape(-1)[0] = np.nan
    rest = [f for i, f in enumerate(wfeeds) if i != GUARD_WINDOW_POISON]
    resilience.clear_events()
    t1 = time.perf_counter()
    wgot = exe.run_steps(skip, feed=stacked, fetch_list=fetch_list,
                         scope=guarded, return_numpy=False)
    torch.cuda.synchronize()
    window_ms = (time.perf_counter() - t1) * 1e3
    wfaults = resilience.events("numeric_fault")
    wref = exe.run_steps(main, feed={k: np.stack([f[k] for f in rest])
                                     for k in rest[0]},
                         fetch_list=fetch_list, scope=clean,
                         return_numpy=False)
    keep = [i for i in range(GUARD_WINDOW) if i != GUARD_WINDOW_POISON]
    window_equal = all(_same_bits(torch, g[keep], r)
                       for g, r in zip(wgot, wref))
    window_state = _unequal_state(torch, persist, guarded, clean)
    window_ok = (window_equal and not window_state
                 and not np.isfinite(float(wgot[0][GUARD_WINDOW_POISON]))
                 and [(e["policy"], e["step"]) for e in wfaults]
                 == [("skip", GUARD_WINDOW_POISON)]
                 and bool(wfaults[0].get("culprit")))
    # the skip guard's cost: a profiled replay of each key
    found = {"skip_guard": _profiled(torch, lambda: exe.run(
        skip, feed=feeds[0], fetch_list=fetch_list, scope=guarded)),
        "unguarded": _profiled(torch, lambda: exe.run(
            main, feed=feeds[0], fetch_list=fetch_list, scope=clean))}
    guard = next(gd for gd in exe._guards.values() if gd.policy == "skip")
    # the budget: every run poisoned from the first on
    resilience.clear_events()
    budget_error = None
    with faultinject.failpoints(["executor.step:corrupt=input_mask@1+"]):
        try:
            for _ in range(GUARD_SKIP_BUDGET + 1):
                exe.run(skip, feed=feeds[0], fetch_list=fetch_list,
                        scope=guarded)
        except resilience.SkipBudgetExceededError as e:
            budget_error = "%s: %s" % (type(e).__name__, e)
    exe.run(skip, feed=feeds[1], fetch_list=fetch_list, scope=guarded)
    streak_ended = exe._numeric_skips == 0
    with faultinject.failpoints(["executor.step:corrupt=input_mask@1"]):
        exe.run(skip, feed=feeds[2], fetch_list=fetch_list, scope=guarded)
    budget_ok = (budget_error is not None and streak_ended
                 and exe._numeric_skips == 1
                 and len(resilience.events("numeric_fault"))
                 == GUARD_SKIP_BUDGET + 2)
    # "raise": graphed (a warm run, a capture, then the poisoned replay)
    # against op by op from a copy of the scope before the poisoned step
    check = ptt.CompiledProgram(main, ptt.BuildStrategy(
        check_numerics=True)).with_data_parallel(loss_name=loss.name)
    for f in feeds[3:5]:
        exe.run(check, feed=f, fetch_list=fetch_list, scope=guarded)
    op_scope = _copy_scope(torch, ptt, guarded)
    bad = dict(feeds[5])
    bad["input_mask"] = bad["input_mask"].copy()
    bad["input_mask"].reshape(-1)[0] = np.nan
    raised = {}
    for way, scope, cache in (("graphed", guarded, True),
                              ("op_by_op", op_scope, False)):
        try:
            exe.run(check, feed=bad, fetch_list=fetch_list, scope=scope,
                    use_program_cache=cache)
        except FloatingPointError as e:
            raised[way] = "%s: %s" % (type(e).__name__, e)
    raise_state = _unequal_state(torch, persist, guarded, op_scope)
    poisoned_state = any(not bool(torch.isfinite(guarded.find_var(n)).all())
                         for n in persist
                         if guarded.find_var(n).is_floating_point())
    raise_ok = (len(raised) == 2 and "var '" in raised["graphed"]
                and not raise_state and poisoned_state)
    ok = run_ok and window_ok and budget_ok and raise_ok
    skip_replay = statistics.median(step_ms[GUARD_POISON_RUN:])
    clean_replay = statistics.median(clean_ms[2:])
    emit({"phase": "numeric_skip", "ok": ok, "model": "bert_base",
          "dtype": cfg.dtype, "batch": BF16_TRAIN_BATCH,
          "dropout": cfg.hidden_dropout,
          "failpoint": "executor.step:corrupt=input_mask@%d"
          % GUARD_POISON_RUN,
          "run": {"ok": run_ok, "poisoned_run": GUARD_POISON_RUN,
                  "poisoned_loss": poisoned_loss,
                  "state_after_skip_unequal_pre": reverted[:8],
                  "later_runs_equal_clean": run_equal,
                  "state_unequal_clean": run_state[:8],
                  "events": [{k: v for k, v in e.items() if k != "time"}
                             for e in faults],
                  "launches_per_step": per_step, "step_ms": step_ms,
                  "clean_step_ms": clean_ms},
          "window": {"ok": window_ok, "steps": GUARD_WINDOW,
                     "poisoned_step": GUARD_WINDOW_POISON,
                     "equal_clean_window": window_equal,
                     "state_unequal_clean": window_state[:8],
                     "events": [{k: v for k, v in e.items() if k != "time"}
                                for e in wfaults],
                     "window_ms": window_ms},
          "budget": {"ok": budget_ok, "budget": GUARD_SKIP_BUDGET,
                     "error": budget_error, "streak_ended": streak_ended},
          "raise": {"ok": raise_ok, "errors": raised,
                    "graphed_state_unequal_op_by_op": raise_state[:8],
                    "poisoned_state_written_back": poisoned_state},
          "guard": {"policy": "skip", "replay_ms": skip_replay,
                    "unguarded_replay_ms": clean_replay,
                    "step_share": skip_replay / clean_replay - 1,
                    "device_ms": _guard_family_ms(found["skip_guard"]),
                    "device_busy_ms": {k: v["device_busy_ms"]
                                       for k, v in found.items()},
                    "launches_per_step": GUARD_SKIP_PER_STEP,
                    "written_tensors": len(guard.writes),
                    "checked_tensors": len(guard.names),
                    "copies_bytes": guard.pool_bytes,
                    "captures": [dict(c, launches=None)
                                 for c in exe.capture_log]},
          "profile": {k: {kk: vv for kk, vv in v.items()
                          if kk != "kernel_names"}
                      for k, v in found.items()}})
    close_executor(torch, "numeric_skip", exe)
    if not ok:
        raise AssertionError("numeric_skip checks failed (see the line "
                             "above)")
    return launches


class _Timed(object):
    """Seconds of each call of a trainer's ``_save``."""

    def __init__(self, fn):
        self.fn, self.seconds = fn, []

    def __call__(self, *args):
        t0 = time.perf_counter()
        try:
            return self.fn(*args)
        finally:
            self.seconds.append(time.perf_counter() - t0)


def _uninterrupted(torch, ptt, main, start, batches, fetch_list):
    """The batches run one by one on a copy of ``start``: (each run's
    fetches as numpy arrays, the scope)."""
    scope, exe = _copy_scope(torch, ptt, start), ptt.Executor()
    out = [exe.run(main, feed=b, fetch_list=fetch_list, scope=scope)
           for b in batches]
    exe.close()
    return out, scope


def _resilient(torch, np, ptt, label, exe, target, main, start, batches,
               fetch_list, root, want, persist, **kw):
    """One ResilientTrainer run on a copy of ``start`` against ``want``
    ((fetches, scope) of the uninterrupted run; a None fetch is a batch
    that must be skipped): its record and whether it ended bit-equal."""
    from paddle_tpu_torch.framework import resilience
    scope = _copy_scope(torch, ptt, start)
    ckpt = os.path.join(root, label)
    runs = [0]
    run, run_steps = exe.run, exe.run_steps

    def counted(*a, **k):
        runs[0] += 1
        return run(*a, **k)

    def counted_steps(*a, **k):
        runs[0] += len(next(iter(k["feed"].values())))
        return run_steps(*a, **k)
    exe.run, exe.run_steps = counted, counted_steps
    trainer = resilience.ResilientTrainer(
        exe, target, ckpt, fetch_list=fetch_list,
        checkpoint_every=RESILIENT_CKPT_EVERY, keep_last=RESILIENT_KEEP,
        retry_policy=resilience.RetryPolicy(base_delay_s=0.0, jitter=0.0,
                                            sleep=lambda s: None),
        scope=scope, **kw)
    trainer._save = _Timed(trainer._save)
    restore, scrubbed = trainer._restore, []

    def scrub_then_restore(*a):
        # what a restore finds on disk, before it reads anything
        report = ptt.io.scrub_checkpoint(ckpt)
        scrubbed.append({n: st["status"]
                         for n, st in sorted(report["steps"].items())})
        return restore(*a)
    trainer._restore = scrub_then_restore
    resilience.clear_events()
    t0 = time.perf_counter()
    fetched = trainer.run(batches)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    want_fetches, want_scope = want
    skipped = [i for i, f in enumerate(want_fetches) if f is None]
    fetch_equal = all(
        (g is None) if w is None else
        (g is not None and all(np.array_equal(a, b)
                               for a, b in zip(g, w)))
        for g, w in zip(fetched, want_fetches))
    unequal = _unequal_state(torch, persist, scope, want_scope)
    evs = {k: [{kk: vv for kk, vv in e.items() if kk != "time"}
               for e in resilience.events(k)]
           for k in ("fault", "failpoint", "restart", "restore",
                     "numeric_fault", "poison_batch", "watchdog_timeout",
                     "ckpt_quarantine", "scrub")}
    ckpt_bytes = resilience.bytes_totals().get("ckpt", {})
    report = ptt.io.scrub_checkpoint(ckpt)
    shutil.rmtree(ckpt, ignore_errors=True)
    ok = fetch_equal and not unequal and len(evs["restart"]) == 1
    return {"ok": ok, "fetches_bit_equal": fetch_equal,
            "state_unequal": unequal[:8], "batches": len(batches),
            "skipped_batches": skipped, "runs_dispatched": runs[0],
            # runs beyond one a kept batch, less those a fault stopped
            # before they ran and the poisoned runs
            "steps_replayed": runs[0] - (len(batches) - len(skipped))
            - len(evs["fault"]) - len(evs["numeric_fault"]),
            "seconds": seconds,
            "checkpoint_seconds": trainer._save.seconds,
            "checkpoint_bytes": ckpt_bytes,
            "restore_seconds": [e["latency_s"] for e in evs["restore"]],
            "scrub_at_restore": scrubbed,
            "scrub_after": {"valid": report["valid_steps"],
                            "quarantined": report["quarantined"]},
            "events": evs}, ok


def resilient_recipe(torch, np, ptt, counters):
    """ResilientTrainer over RESILIENT_BATCHES batches of the recipe step
    (checkpoint_every=RESILIENT_CKPT_EVERY, keep_last=RESILIENT_KEEP),
    each run ending bit-equal to its uninterrupted reference, at
    RESILIENT_LAYERS layers of BERT-base's width: (a) ``step:preempt@6``
    (one restore to step 3); (b) numeric_policy=
    "rewind" with batch RESILIENT_REWIND_POISON poisoned (against the
    uninterrupted run of the other batches; a poison_batch event); (c)
    steps_per_dispatch=2, the windows through run_steps, preempted at the
    4th dispatch; (d) a torn checkpoint (``io.manifest_write:raise@2``:
    the step-3 shards on disk, no manifest; the restore falls back to
    step 0); (e) collective_timeout_s=RESILIENT_TIMEOUT_S with the card
    stalled RESILIENT_STALL_S before run RESILIENT_STALL_RUN: a
    CollectiveTimeoutError, classified transient, recovered.
    Checkpoint seconds and bytes, restore seconds, steps replayed."""
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.framework import faultinject, resilience
    root = os.path.join(_ROOT, "build", "chip_smoke_resilient")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    out, ok = {}, True
    counters.zero()                          # the main path starts here
    try:
        # RESILIENT_LAYERS layers of the same width (the 12-layer
        # ResilientTrainer runs under the pod in pod_recipe (a))
        cfg = bert.bert_base(dtype="bfloat16", num_layers=RESILIENT_LAYERS)
        main, startup, fetch_list = _guard_program(ptt, bert, cfg,
                                                   BF16_TRAIN_BATCH)
        loss = fetch_list[0]
        persist = [v.name for v in main.list_vars() if v.persistable]
        batches = [bert.synthetic_batch(cfg, BF16_TRAIN_BATCH, TRAIN_SEQ,
                                        TRAIN_PREDS, seed=400 + s)
                   for s in range(RESILIENT_BATCHES)]
        start = _started(ptt, startup)
        want = _uninterrupted(torch, ptt, main, start, batches, fetch_list)
        clean = [b for i, b in enumerate(batches)
                 if i != RESILIENT_REWIND_POISON]
        fetches7, scope7 = _uninterrupted(torch, ptt, main, start, clean,
                                          fetch_list)
        want7 = (fetches7[:RESILIENT_REWIND_POISON] + [None]
                 + fetches7[RESILIENT_REWIND_POISON:], scope7)
        exe = ptt.Executor()
        with resilience.inject("step:preempt@6"):
            out["a_preempt"], done = _resilient(
                torch, np, ptt, "a", exe, main, main, start, batches,
                fetch_list, root, want, persist)
        done = done and out["a_preempt"]["events"]["restore"][-1][
            "step"] == RESILIENT_CKPT_EVERY
        out["a_preempt"].update(layers=cfg.num_layers, ok=done)
        ok = ok and done
        close_executor(torch, "resilient_recipe a", exe)
        poisoned = list(batches)
        poisoned[RESILIENT_REWIND_POISON] = dict(
            batches[RESILIENT_REWIND_POISON])
        mask = poisoned[RESILIENT_REWIND_POISON]["input_mask"].copy()
        mask.reshape(-1)[0] = np.nan
        poisoned[RESILIENT_REWIND_POISON]["input_mask"] = mask

        def compiled(**kw):
            return ptt.CompiledProgram(main, ptt.BuildStrategy(
                **kw)).with_data_parallel(loss_name=loss.name)
        exe = ptt.Executor()
        out["b_rewind"], done = _resilient(
            torch, np, ptt, "b", exe, compiled(numeric_policy="rewind"),
            main, start, poisoned, fetch_list, root, want7, persist)
        done = done and [e["batch"] for e in out["b_rewind"]["events"][
            "poison_batch"]] == [RESILIENT_REWIND_POISON]
        out["b_rewind"]["ok"] = done
        ok = ok and done
        with resilience.inject("step:preempt@4"):
            out["c_windows"], done = _resilient(
                torch, np, ptt, "c", exe, main, main, start, batches,
                fetch_list, root, want, persist, steps_per_dispatch=2)
        out["c_windows"]["steps_per_dispatch"] = 2
        ok = ok and done
        with faultinject.failpoints(["io.manifest_write:raise@2"]):
            out["d_torn_write"], done = _resilient(
                torch, np, ptt, "d", exe, main, main, start, batches,
                fetch_list, root, want, persist)
        done = done and out["d_torn_write"]["events"]["restore"][-1][
            "step"] == 0
        out["d_torn_write"]["ok"] = done
        ok = ok and done
        close_executor(torch, "resilient_recipe b-d", exe)

        class Stalled(ptt.Executor):
            """An Executor whose card stalls before one run: a sleep
            kernel queued on the caller's stream, which the step waits
            for."""
            calls = 0

            def run(self, *a, **k):
                Stalled.calls += 1
                if Stalled.calls == RESILIENT_STALL_RUN:
                    torch.cuda._sleep(int(RESILIENT_STALL_S * 1e3
                                          * _cycles_per_ms(torch)))
                return super().run(*a, **k)
        exe = Stalled()
        out["e_timeout"], done = _resilient(
            torch, np, ptt, "e", exe,
            compiled(collective_timeout_s=RESILIENT_TIMEOUT_S), main, start,
            batches, fetch_list, root, want, persist)
        evs = out["e_timeout"]["events"]
        done = done and len(evs["watchdog_timeout"]) == 1 and \
            evs["restart"][0]["error"] == "CollectiveTimeoutError"
        out["e_timeout"].update(
            ok=done, timeout_s=RESILIENT_TIMEOUT_S,
            stall_s=RESILIENT_STALL_S, stall_before_run=RESILIENT_STALL_RUN,
            classified=resilience.classify(
                resilience.CollectiveTimeoutError("a timed-out step")))
        ok = ok and done
        close_executor(torch, "resilient_recipe e", exe)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = counters.read_all()
    emit({"phase": "resilient_recipe", "ok": ok, "model": "bert_base",
          "dtype": "bfloat16", "batch": BF16_TRAIN_BATCH,
          "layers": RESILIENT_LAYERS,
          "checkpoint_every": RESILIENT_CKPT_EVERY,
          "keep_last": RESILIENT_KEEP, "runs": out})
    if not ok:
        raise AssertionError("resilient_recipe checks failed (see the line "
                             "above)")
    return launches


def _program_launches(main, guard=False):
    """The kernels' launches a step of a BERT recipe program, derived from
    its ops: one flash forward, dK/dV and dQ per attention op, one
    LayerNorm forward and backward per layer_norm op, one fused Adam per
    adamw op, and with ``guard`` (numeric_policy "rewind") one finite
    check."""
    ops = _op_counts(main)
    att, ln_ = ops.get("scaled_dot_product_attention", 0), \
        ops.get("layer_norm", 0)
    want = dict({k: 0 for k in TRAIN_PER_STEP},
                flash_attention_fwd=att, flash_attention_bwd_dkv=att,
                flash_attention_bwd_dq=att, layer_norm_fwd=ln_,
                layer_norm_bwd=ln_, fused_adam=ops.get("adamw", 0),
                finite_flags=int(guard), guarded_copy=0)
    return want


def _host_calls(exe, counters):
    """Wrap a pod host's Executor: each run / run_steps call recorded as
    (steps it carried, the launches it made by name, the error it raised
    or None), read from the kernels' counters before and after the call
    under the Executors' step lock, so no other host's thread steps in
    between."""
    from paddle_tpu_torch.framework import executor
    from paddle_tpu_torch.ops import kernels
    by = {(id(m), a): n for n, (m, a) in list(counters._fields.items())
          + list(counters._guard.items())}
    names = [by.get((id(m), a)) for m, a in kernels.LAUNCH_COUNTERS]
    calls = []
    run, run_steps = exe.run, exe.run_steps

    def record(fn, n, *a, **k):
        with executor._STEP_LOCK:
            before = kernels.launch_counts()
            err = None
            try:
                return fn(*a, **k)
            except Exception as e:
                err = type(e).__name__
                raise
            finally:
                delta = {nm: b - a_ for nm, a_, b in zip(
                    names, before, kernels.launch_counts())
                    if nm is not None}
                calls.append((n, delta, err))
    exe.run = lambda *a, **k: record(run, 1, *a, **k)
    exe.run_steps = lambda *a, **k: record(
        run_steps, len(next(iter(k["feed"].values()))), *a, **k)
    return calls


def _pod_run(torch, np, ptt, label, n_hosts, make_target, start, batches,
             fetch_list, root, want, persist, per_step, window, ckpt_every,
             counters, elastic=False, fault=None, failpoint=None,
             **pod_kw):
    """One pod on POD_BATCHES batches: each host a thread with its own
    Executor, a copy of ``start`` and its checkpoint dir. Its record (each
    live host's fetches and persistables against ``want``, bit for bit;
    every call's launches ``per_step`` times its steps, or none for a
    call a fault stopped before it dispatched; a step without fetches
    only on a host that a ``host_death`` event names; events by kind and
    host; seconds, peak memory) and whether it passed."""
    from paddle_tpu_torch.framework import (coordination, faultinject,
                                            obs, resilience)
    trainers, calls = [], []
    for h in range(n_hosts):
        exe = ptt.Executor()
        calls.append(_host_calls(exe, counters))
        trainers.append(resilience.ResilientTrainer(
            exe, make_target(), os.path.join(root, label, "h%d" % h),
            fetch_list=fetch_list, checkpoint_every=ckpt_every,
            keep_last=POD_KEEP, steps_per_dispatch=window,
            retry_policy=resilience.RetryPolicy(
                base_delay_s=0.0, jitter=0.0, sleep=lambda s: None),
            scope=_copy_scope(torch, ptt, start)))
    cls = coordination.ElasticTrainer if elastic \
        else coordination.PodResilientTrainer
    co = coordination.LocalCoordinator(n_hosts, timeout_s=POD_TIMEOUT_S)
    pod = cls(trainers, co, **pod_kw)
    resilience.clear_events()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    obs.enable()
    obs.clear()
    t0 = time.perf_counter()
    try:
        with contextlib.ExitStack() as ctx:
            if fault:
                ctx.enter_context(resilience.inject(fault))
            if failpoint:
                ctx.enter_context(faultinject.failpoints([failpoint]))
            out = pod.run(batches)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        spans = obs.spans()
    finally:
        obs.disable()
        obs.clear()
    peak = torch.cuda.max_memory_allocated()
    want_fetches, want_scope = want
    dead = {e.get("host") for e in resilience.events("host_death")}
    hosts = []
    for h, (trainer, got) in enumerate(zip(trainers, out)):
        fetch_equal = all(
            (g is None) if w is None else
            (g is None or all(np.array_equal(a, b) for a, b in zip(g, w)))
            for g, w in zip(got, want_fetches))
        missed = [i for i, (g, w) in enumerate(zip(got, want_fetches))
                  if g is None and w is not None]
        unequal = _unequal_state(torch, persist, trainer._scope,
                                 want_scope)
        bad_calls = [(n, d, e) for n, d, e in calls[h]
                     if d != {k: v * n for k, v in per_step.items()}
                     and not (e is not None and not any(d.values()))]
        hosts.append({"host": h, "fetches_bit_equal": fetch_equal,
                      "steps_missed": missed,
                      "steps_missed_ok": not missed or h in dead,
                      "state_unequal": unequal[:8],
                      "calls": len(calls[h]),
                      "steps_dispatched": sum(
                          n for n, d, e in calls[h] if any(d.values())),
                      "launches_per_step_ok": not bad_calls,
                      "bad_calls": bad_calls[:3]})
        trainer._executor.close()
    kinds = {}
    for e in resilience.events():
        if e["kind"] in ("ckpt", "program_analysis"):
            continue
        key = "%s/host%s" % (e["kind"], e.get("host"))
        kinds[key] = kinds.get(key, 0) + 1
    evs = {k: [{kk: vv for kk, vv in e.items() if kk != "time"}
               for e in resilience.events(k)]
           for k in ("pod_restore", "consensus", "buddy_restore",
                     "elastic_shrink", "elastic_grow", "rejoin",
                     "poison_batch", "buddy_adopt", "host_death")}
    metrics = resilience.metrics()
    buddy = {"gauges": [g for g in metrics["gauges"]
                        if "buddy" in g["name"]],
             "restores": [c for c in metrics["counters"]
                          if "buddy_restore" in c["name"]],
             "snapshot_bytes": resilience.bytes_totals().get(
                 "buddy_snapshot"),
             "stateship_bytes": resilience.bytes_totals().get(
                 "stateship"),
             "meta": {h: co.buddy_meta(h) for h in range(n_hosts)}}
    sends = [s for s in spans if s["name"] == "buddy.send"]
    restores = [s for s in spans if s["name"] == "buddy.restore"]
    runs = sum(hh["steps_dispatched"] for hh in hosts)
    kept = sum(1 for f in want_fetches if f is not None)
    shutil.rmtree(os.path.join(root, label), ignore_errors=True)
    ok = all(hh["fetches_bit_equal"] and hh["steps_missed_ok"]
             and not hh["state_unequal"] and hh["launches_per_step_ok"]
             for hh in hosts)
    return {"hosts_n": n_hosts, "seconds": seconds,
            "peak_mem_gb": peak / 2 ** 30,
            "peak_above_resident_gb": (peak - resident) / 2 ** 30,
            "hosts": hosts, "events_by_kind_and_host": kinds,
            "events": evs, "buddy": buddy,
            "snapshot_encode_s": [
                {"host": sp["labels"].get("host"),
                 "gen": sp["labels"].get("gen"),
                 "seconds": sp["t1"] - sp["t0"]} for sp in sends],
            "buddy_restore_s": [sp["t1"] - sp["t0"] for sp in restores],
            "steps_replayed": runs - kept * n_hosts + sum(
                len(hh["steps_missed"]) for hh in hosts),
            "launches_per_step": per_step, "ok": ok}, ok


def pod_recipe(torch, np, ptt, counters):
    """The pod half of the robustness stack on one card: simulated hosts
    (threads on one LocalCoordinator, each with its own Executor, Scope
    and checkpoint dir) train the recipe step (BERT-base bf16, batch 128
    x 128, dropout 0.1, AdamW, the warmup over the polynomial decay, the
    global-norm clip) on the replicated feed, and every live host ends
    bit-equal to the uninterrupted one-host run: (a) 12 layers, two
    hosts, PodResilientTrainer with the buddy tier, preempted and
    restored from the buddy mailboxes (no disk read); at
    RESILIENT_LAYERS layers, four hosts: (b) a torn checkpoint lowers
    the consensus to step 0, every host restores it from disk; (c)
    ElasticTrainer: a host dies, the rest shrink to 3/4 and go on with
    no restore, the host rejoins at 4/4 with the state shipped zlib; (d)
    numeric_policy="rewind" on every host, one batch NaN-poisoned and
    skipped by all. Each host's launches a step: train_recipe's at 12
    layers, derived from the program at 2 (and one finite check under
    (d))."""
    from paddle_tpu_torch.models import bert
    root = os.path.join(_ROOT, "build", "chip_smoke_pod")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    out, ok = {}, True
    counters.zero()                          # the main path starts here
    try:
        cfg = bert.bert_base(dtype="bfloat16")
        main, startup, fetch_list = _guard_program(ptt, bert, cfg,
                                                   BF16_TRAIN_BATCH)
        persist = [v.name for v in main.list_vars() if v.persistable]
        per_step = _program_launches(main)
        want_launch = dict(TRAIN_PER_STEP, finite_flags=0, guarded_copy=0)
        batches = [bert.synthetic_batch(cfg, BF16_TRAIN_BATCH, TRAIN_SEQ,
                                        TRAIN_PREDS, seed=500 + s)
                   for s in range(POD_BATCHES)]
        start = _started(ptt, startup)
        want = _uninterrupted(torch, ptt, main, start, batches, fetch_list)
        out["a_buddy"], done = _pod_run(
            torch, np, ptt, "a", POD_A_HOSTS, lambda: main, start, batches,
            fetch_list, root, want, persist, per_step, POD_A_WINDOW,
            POD_A_CKPT_EVERY, counters,
            fault="step:preempt@%d" % POD_A_PREEMPT, buddy=True,
            buddy_compress="zlib", buddy_p2p=True, buddy_delta=True)
        evs = out["a_buddy"]["events"]
        done = (done and per_step == want_launch
                and {e["step"] for e in evs["pod_restore"]} == {POD_A_WINDOW}
                and {e["outcome"] for e in evs["buddy_restore"]} == {"ok"}
                and len(evs["pod_restore"]) == POD_A_HOSTS
                and not any(k.startswith("restore/") for k in
                            out["a_buddy"]["events_by_kind_and_host"]))
        out["a_buddy"].update(layers=cfg.num_layers, ok=done,
                              preempt="step:preempt@%d" % POD_A_PREEMPT)
        ok = ok and done
        del start, want
        # (b)-(d) at RESILIENT_LAYERS layers of the same width
        cfg = bert.bert_base(dtype="bfloat16", num_layers=RESILIENT_LAYERS)
        main, startup, fetch_list = _guard_program(ptt, bert, cfg,
                                                   BF16_TRAIN_BATCH)
        loss = fetch_list[0]
        persist = [v.name for v in main.list_vars() if v.persistable]
        per_step = _program_launches(main)
        batches = [bert.synthetic_batch(cfg, BF16_TRAIN_BATCH, TRAIN_SEQ,
                                        TRAIN_PREDS, seed=600 + s)
                   for s in range(POD_BATCHES)]
        start = _started(ptt, startup)
        want = _uninterrupted(torch, ptt, main, start, batches, fetch_list)
        out["b_torn"], done = _pod_run(
            torch, np, ptt, "b", POD_HOSTS, lambda: main, start, batches,
            fetch_list, root, want, persist, per_step, 1, POD_CKPT_EVERY,
            counters, failpoint="io.manifest_write:raise@%d" % POD_TORN_AT,
            buddy=False)
        evs = out["b_torn"]["events"]
        done = (done and {e["step"] for e in evs["consensus"]} == {0}
                and [e["step"] for e in evs["pod_restore"]]
                == [0] * POD_HOSTS)
        out["b_torn"]["ok"] = done
        ok = ok and done
        out["c_elastic"], done = _pod_run(
            torch, np, ptt, "c", POD_HOSTS, lambda: main, start, batches,
            fetch_list, root, want, persist, per_step, 1, POD_CKPT_EVERY,
            counters, elastic=True, fault="step:die@%d" % POD_DIE_AT,
            rejoin=True, ship_compress="zlib", buddy=False)
        evs = out["c_elastic"]["events"]
        kinds = out["c_elastic"]["events_by_kind_and_host"]
        done = (done and len(evs["host_death"]) == 1
                and {e["capacity"] for e in evs["elastic_shrink"]}
                == {"%d/%d" % (POD_HOSTS - 1, POD_HOSTS)}
                and len(evs["elastic_shrink"]) == POD_HOSTS - 1
                and {e["capacity"] for e in evs["elastic_grow"]}
                == {"%d/%d" % (POD_HOSTS, POD_HOSTS)}
                and len(evs["elastic_grow"]) == POD_HOSTS
                and len(evs["rejoin"]) == 1
                and not any(k.split("/")[0] in ("restore", "pod_restore")
                            for k in kinds))
        out["c_elastic"]["ok"] = done
        ok = ok and done
        clean = [b for i, b in enumerate(batches)
                 if i != RESILIENT_REWIND_POISON]
        fetches7, scope7 = _uninterrupted(torch, ptt, main, start, clean,
                                          fetch_list)
        want7 = (fetches7[:RESILIENT_REWIND_POISON] + [None]
                 + fetches7[RESILIENT_REWIND_POISON:], scope7)
        poisoned = list(batches)
        poisoned[RESILIENT_REWIND_POISON] = dict(
            batches[RESILIENT_REWIND_POISON])
        mask = poisoned[RESILIENT_REWIND_POISON]["input_mask"].copy()
        mask.reshape(-1)[0] = np.nan
        poisoned[RESILIENT_REWIND_POISON]["input_mask"] = mask
        out["d_rewind"], done = _pod_run(
            torch, np, ptt, "d", POD_HOSTS,
            lambda: ptt.CompiledProgram(main, ptt.BuildStrategy(
                numeric_policy="rewind")).with_data_parallel(
                    loss_name=loss.name),
            start, poisoned, fetch_list, root, want7, persist,
            _program_launches(main, guard=True), 1, POD_CKPT_EVERY,
            counters, buddy=False)
        evs = out["d_rewind"]["events"]
        done = (done and {e["batch"] for e in evs["poison_batch"]}
                == {RESILIENT_REWIND_POISON}
                and len(evs["pod_restore"]) == POD_HOSTS)
        out["d_rewind"]["ok"] = done
        ok = ok and done
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = counters.read_all()
    emit({"phase": "pod_recipe", "ok": ok, "model": "bert_base",
          "dtype": "bfloat16", "batch": BF16_TRAIN_BATCH,
          "batches": POD_BATCHES, "layers": {"a": 12,
                                             "b-d": RESILIENT_LAYERS},
          "hosts": {"a": POD_A_HOSTS, "b-d": POD_HOSTS},
          "windows": {"a": POD_A_WINDOW, "b-d": 1},
          "checkpoint_every": {"a": POD_A_CKPT_EVERY, "b-d": POD_CKPT_EVERY},
          "coordinator_timeout_s": POD_TIMEOUT_S, "runs": out})
    if not ok:
        raise AssertionError("pod_recipe checks failed (see the line "
                             "above)")
    return launches


def _cycles_per_ms(torch):
    """Cycles of torch.cuda._sleep a millisecond on this card (timed)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    n = 50_000_000
    start.record()
    torch.cuda._sleep(n)
    end.record()
    end.synchronize()
    return n / start.elapsed_time(end)


def compiled_parity(torch, np, ptt):
    """A 2-layer BERT-base-width model (dropout 0) under
    numeric_policy="skip", graphed on the card against the CPU from the
    same weights, PARITY_STEPS + 1 runs with the second batch poisoned:
    the same step skipped on both (one numeric_fault event each, the same
    culprit), the other losses and every persistable within PARITY_*."""
    from paddle_tpu_torch.models import bert
    cfg = bert.bert_base(num_layers=PARITY_LAYERS, hidden_dropout=0.0,
                         attn_dropout=0.0)
    main, startup, fetch_list = _pretrain_program(ptt, bert, cfg,
                                                  PARITY_BATCH)
    feeds = [bert.synthetic_batch(cfg, PARITY_BATCH, TRAIN_SEQ, TRAIN_PREDS,
                                  seed=1 + s)
             for s in range(PARITY_STEPS + 1)]
    feeds[1] = dict(feeds[1])
    feeds[1]["input_mask"] = feeds[1]["input_mask"].copy()
    feeds[1]["input_mask"].reshape(-1)[0] = np.nan
    target = ptt.CompiledProgram(main, ptt.BuildStrategy(
        numeric_policy="skip")).with_data_parallel(
            loss_name=fetch_list[0].name)
    result, ok = _card_vs_cpu(np, ptt, main, startup, fetch_list, feeds,
                              target=target, skip_step=1)
    emit(dict({"phase": "compiled_parity", "ok": ok,
               "layers": PARITY_LAYERS, "hidden": cfg.hidden_size,
               "batch": PARITY_BATCH, "seq_len": TRAIN_SEQ,
               "policy": "skip", "poisoned_step": 1}, **result))
    if not ok:
        raise AssertionError("compiled_parity checks failed (see the line "
                             "above)")


def _recipe_state(torch, ptt, ng):
    """Random tensors of the recipe step's float persistables (BERT-base
    bf16 with AdamW, the schedule and the clip: parameters, moments, beta
    powers, the rate), in name order: the numeric guard's state."""
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.framework.dtypes import to_torch_dtype
    main, _, _ = _guard_program(ptt, bert, bert.bert_base(dtype="bfloat16"),
                                BF16_TRAIN_BATCH)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(SEED + 900)
    state = []
    for v in sorted(main.list_vars(), key=lambda v: v.name):
        dt = to_torch_dtype(v.dtype)
        if v.persistable and ng.is_guarded_dtype(dt):
            state.append(torch.randn([int(d) for d in v.shape], generator=g,
                                     device=dev).to(dt))
    return state


def _replay_ms(torch, fn, tables):
    """time_ms of ``fn`` captured once into a CUDA graph and replayed: the
    guard's kernels run so inside a captured step, their pointer tables
    written once (``tables`` flushed after the capture), where a direct
    call rebuilds and uploads its table each time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                 # reserves the tables
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    for t in tables:
        t.flush()
    return time_ms(torch, graph.replay)


def _amp_finite_check(torch, dev, tensors):
    """The library's call that gives the finite check's verdict over a
    tensor list, ``torch._amp_foreach_non_finite_check_and_unscale_``
    with an unscale of 1: timed on copies of the floating tensors, a
    bf16 one as an f32 copy (the call takes f16, f32 and f64 only); it
    also writes each tensor, so it moves twice the bytes it reads. Its
    verdict, the bytes it reads and writes, and the tensors it cannot
    take (integers)."""
    flt = [t.float() if t.dtype == torch.bfloat16 else t.clone()
           for t in tensors if t.is_floating_point()]
    found = torch.zeros(1, device=dev)
    one = torch.ones(1, device=dev)
    check = torch._amp_foreach_non_finite_check_and_unscale_
    check(flt, found, one)
    verdict = int(float(found.item()) > 0)
    ms = time_ms(torch, lambda: check(flt, found, one))
    moved = 2 * sum(t.numel() * t.element_size() for t in flt)
    return {"library_ms": ms, "any": verdict, "library_bytes": moved,
            "library_skips_tensors": len(tensors) - len(flt)}


def guard_cases(torch, ng, ptt):
    """The numeric guard's two kernels against their plain versions at
    the recipe step's state (~620 tensors, 1.1 GB): ``finite_flags``
    clean, with a NaN, +Inf and -Inf in three tensors (a bf16 parameter's
    last element, an f32 moment's middle, a one-element tensor), and on
    f16 / f64 / odd-sized / unaligned tensors; flags equal byte for byte
    (``max_abs_err`` counts differing bytes). ``guarded_copy`` as the
    backup (no gate), the restore of a clean step (gate 0: nothing
    written) and of a poisoned one (gate 1), equal bit for bit
    (``max_abs_err`` counts unequal tensors); the backup beside
    ``torch._foreach_copy_``, the finite check beside the library's
    ``_amp_foreach_non_finite_check_and_unscale_`` (``_amp_finite_check``:
    the same verdict, one read and one write of each tensor). Bytes bound
    both. Each kernel is timed as it runs in a captured step
    (``_replay_ms``)."""
    dev = torch.device("cuda", 0)
    state = _recipe_state(torch, ptt, ng)
    n_bytes = sum(t.numel() * t.element_size() for t in state)
    n_elems = sum(t.numel() for t in state)
    poisoned = list(state)
    bf16 = next(i for i, t in enumerate(state)
                if t.dtype == torch.bfloat16 and t.numel() > 1000)
    f32 = next(i for i, t in enumerate(state)
               if t.dtype == torch.float32 and t.numel() > 1000)
    one = next(i for i, t in enumerate(state) if t.numel() == 1)
    for i, pos, val in ((bf16, -1, float("nan")),
                        (f32, state[f32].numel() // 2, float("inf")),
                        (one, 0, float("-inf"))):
        t = state[i].clone()
        t.view(-1)[pos] = val
        poisoned[i] = t
    base16 = torch.randn(1000004, device=dev).half()
    base64 = torch.randn(77, device=dev).double()
    mixed = [base16[1:1000004], base64[3:70].clone(), base64[1:8],
             torch.randn(1, device=dev), torch.randn(5, 3, device=dev)]
    mixed[0].view(-1)[999001] = float("nan")
    mixed[2][6] = float("inf")
    finite = []
    for name, tensors in (("recipe_state", state),
                          ("recipe_state_poisoned", poisoned),
                          ("mixed_dtypes_unaligned", mixed)):
        table = ng.TensorTable(dev)
        got = torch.zeros(len(tensors) + 2, dtype=torch.uint8, device=dev)
        want = torch.zeros_like(got)
        ng.finite_flags(tensors, got, table)
        ng.finite_flags_plain(tensors, want)
        torch.cuda.synchronize()
        diff = int((got != want).sum())
        nb = sum(t.numel() * t.element_size() for t in tensors)
        ne = sum(t.numel() for t in tensors)
        flags = [i for i, b in enumerate(got[:-2].tolist()) if b]
        lib = _amp_finite_check(torch, dev, tensors)
        finite.append(dict(
            name=name, tensors=len(tensors), numel=ne, max_abs_err=diff,
            flagged=flags, any=int(got[-2]), ok=diff == 0 and (
                bool(flags) == (name != "recipe_state")),
            kernel_ms=_replay_ms(torch, lambda: ng.finite_flags(
                tensors, got, table), [table]),
            plain_ms=time_ms(torch, lambda: ng.finite_flags_plain(
                tensors, want), reps=3, inner=2),
            library_ms=lib.pop("library_ms"),
            library_verdict_equal=lib.pop("any") == int(got[-2]), **lib,
            **_bound(float(ne), float(nb), "float32")))
        del lib
    table = ng.TensorTable(dev)
    dst = [torch.empty_like(t) for t in state]
    lib_dst = [torch.empty_like(t) for t in state]
    pairs = list(zip(state, dst))
    ng.guarded_copy(pairs, table)
    torch.cuda.synchronize()
    unequal = sum(not _same_bits(torch, a, b) for a, b in pairs)
    copy = [dict(
        name="recipe_backup", tensors=len(pairs), numel=n_elems,
        max_abs_err=unequal, ok=unequal == 0,
        kernel_ms=_replay_ms(torch, lambda: ng.guarded_copy(pairs, table),
                             [table]),
        plain_ms=time_ms(torch, lambda: ng.guarded_copy_plain(pairs),
                         reps=3, inner=2),
        library_ms=time_ms(torch, lambda: torch._foreach_copy_(lib_dst,
                                                               state)),
        **_bound(0.0, 2.0 * n_bytes, "float32"))]
    for name, gate_value in (("recipe_restore_clean", 0),
                             ("recipe_restore_poisoned", 1)):
        gate = torch.full((1,), gate_value, dtype=torch.uint8, device=dev)
        dst = [torch.randn(t.shape, device=dev).to(t.dtype) for t in state]
        before = [t.clone() for t in dst]
        gpairs = list(zip(state, dst))
        ng.guarded_copy(gpairs, table, gate=gate)
        torch.cuda.synchronize()
        expect = state if gate_value else before
        unequal = sum(not _same_bits(torch, a, b)
                      for a, b in zip(dst, expect))
        copy.append(dict(
            name=name, tensors=len(gpairs), numel=n_elems, gate=gate_value,
            max_abs_err=unequal, ok=unequal == 0,
            kernel_ms=_replay_ms(torch, lambda: ng.guarded_copy(
                gpairs, table, gate=gate), [table]),
            plain_ms=time_ms(torch, lambda: ng.guarded_copy_plain(
                gpairs, gate=gate), reps=3, inner=2),
            library_ms=None,
            **_bound(0.0, 2.0 * n_bytes if gate_value else 1.0,
                     "float32")))
    return finite, copy


_GPT_FEEDS = ("token_ids", "pos_ids", "labels", "loss_mask")
# this run's numbers other phases compare with (gpt_train's step ms)
_measured = {}


def _dygraph_gpt(pkg, cfg):
    """GPT of ``cfg`` as a dygraph Layer of package ``pkg``, block for
    block models/gpt.py's (pre-LN, fused causal attention, tied-embedding
    fused head; dropout 0): ``dygraph.Embedding``, ``LayerNorm`` and
    ``Linear`` with ``layers.split``, ``reshape``, ``transpose``,
    ``fused_attention``, ``fused_mlm_head_loss`` and the masked mean run
    eagerly. forward(token_ids, pos_ids, labels, loss_mask) -> (loss, the
    per-token loss (N * T, 1)). tests/test_torch_dygraph_gpt.py builds
    its narrow model with this function, in the port and in the JAX
    package."""
    dy, L = pkg.dygraph, pkg.layers
    d, nh = cfg.hidden_size, cfg.num_heads
    dh = d // nh

    def heads(x):
        return L.transpose(L.reshape(x, [0, 0, nh, dh]), [0, 2, 1, 3])

    class Block(dy.Layer):
        def __init__(self):
            super(Block, self).__init__()
            self.ln1 = dy.LayerNorm(d)
            self.qkv = dy.Linear(d, 3 * d)
            self.proj = dy.Linear(d, d)
            self.ln2 = dy.LayerNorm(d)
            self.ffn0 = dy.Linear(d, cfg.ff_size, act="gelu")
            self.ffn1 = dy.Linear(cfg.ff_size, d)

        def forward(self, x):
            q, k, v = L.split(self.qkv(self.ln1(x)), 3, dim=2)
            ctx = L.fused_attention(heads(q), heads(k), heads(v),
                                    scale=1.0 / math.sqrt(dh), causal=True)
            ctx = L.reshape(L.transpose(ctx, [0, 2, 1, 3]), [0, 0, d])
            x = L.elementwise_add(x, self.proj(ctx))
            return L.elementwise_add(x, self.ffn1(self.ffn0(self.ln2(x))))

    class GPT(dy.Layer):
        def __init__(self):
            super(GPT, self).__init__()
            self.word_emb = dy.Embedding([cfg.vocab_size, d])
            self.pos_emb = dy.Embedding([cfg.max_position, d])
            self.blocks = dy.LayerList([Block()
                                        for _ in range(cfg.num_layers)])
            self.lnf = dy.LayerNorm(d)

        def forward(self, tok, pos, lbl, mask):
            x = L.elementwise_add(self.word_emb(tok), self.pos_emb(pos))
            for block in self.blocks:
                x = block(x)
            h = L.reshape(self.lnf(x), [-1, d])
            ce = L.fused_mlm_head_loss(h, self.word_emb.weight,
                                       L.reshape(lbl, [-1, 1]))
            m = L.reshape(mask, [-1, 1])
            loss = L.elementwise_div(
                L.reduce_sum(L.elementwise_mul(ce, m)),
                L.elementwise_add(L.reduce_sum(m),
                                  L.fill_constant([1], "float32", 1e-8)))
            return loss, ce

    return GPT()


def _dygraph_static_names(n_layers):
    """_dygraph_gpt's parameter names -> gpt_pretrain_program's."""
    names = {"word_emb.weight": "gpt_word_embedding",
             "pos_emb.weight": "gpt_pos_embedding",
             "lnf.weight": "gpt_lnf_s", "lnf.bias": "gpt_lnf_b"}
    for i in range(n_layers):
        pre = "gpt_layer_%d" % i
        for sub in ("ln1", "ln2"):
            names["blocks.%d.%s.weight" % (i, sub)] = "%s_%s_s" % (pre, sub)
            names["blocks.%d.%s.bias" % (i, sub)] = "%s_%s_b" % (pre, sub)
        for sub in ("qkv", "proj", "ffn0", "ffn1"):
            names["blocks.%d.%s.weight" % (i, sub)] = "%s_%s.w_0" % (pre,
                                                                     sub)
            names["blocks.%d.%s.bias" % (i, sub)] = "%s_%s.b_0" % (pre, sub)
    return names


def _dygraph_inputs(pkg, feed):
    """The batch as eager variables; the mask wants no gradient."""
    ins = [pkg.dygraph.to_variable(feed[k]) for k in _GPT_FEEDS]
    ins[-1].stop_gradient = True
    return ins


def _dygraph_step(model, opt, ins):
    """One fluid dygraph training step: (the loss as a Python float)."""
    loss, _ = model(*ins)
    loss.backward()
    opt.minimize(loss)
    model.clear_gradients()
    return float(loss.numpy().reshape(()))


def dygraph_gpt(torch, np, ptt, counters):
    """GPT-base at GPT_BATCH x GPT_SEQ f32 trained in dygraph mode on the
    card: DYGRAPH_STEPS Adam steps of loss.backward(); opt.minimize(loss)
    on one batch, every kernel launched eagerly (no Executor, no CUDA
    graph): losses finite and falling, GPT_PER_STEP's launches a step,
    step ms against the graphed static step, tokens/s, peak memory above
    resident; one more step profiled (idle share, the path's kernels, no
    library kernel)."""
    from paddle_tpu_torch.models import gpt
    cfg = _gpt_cfg(gpt)
    t0 = time.perf_counter()
    with ptt.dygraph.guard():                # CUDAPlace(0)
        np.random.seed(SEED)
        model = _dygraph_gpt(ptt, cfg)
        opt = ptt.dygraph.optimizers.Adam(
            DYGRAPH_LR, parameter_list=model.parameters())
        feed = gpt.synthetic_batch(cfg, GPT_BATCH, GPT_SEQ, seed=0)
        ins = _dygraph_inputs(ptt, feed)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        n_params = sum(p.value.numel() for p in model.parameters())
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        counters.zero()                      # the main path starts here
        step_ms, losses, per_step = [], [], []
        for _ in range(DYGRAPH_STEPS):
            before = counters.read()
            t1 = time.perf_counter()
            losses.append(_dygraph_step(model, opt, ins))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            after = counters.read()
            per_step.append({k: after[k] - before[k] for k in after})
        launches = counters.read()
        peak = torch.cuda.max_memory_allocated()
        found = _profiled(torch, lambda: _dygraph_step(model, opt, ins))
    missing, library = _kernel_check(found, GPT_FAMILIES)
    found.pop("kernel_names")
    ms = statistics.median(step_ms[-DYGRAPH_TIMED:])
    static_ms = _measured.get("gpt_train_step_ms")
    finite = all(np.isfinite(losses))
    falling = losses[-1] < losses[0]
    counts_ok = all(c == GPT_PER_STEP for c in per_step)
    ok = finite and falling and counts_ok and not missing and not library
    emit({"phase": "dygraph_gpt", "ok": ok, "model": "gpt_base",
          "mode": "dygraph", "hidden": cfg.hidden_size,
          "layers": cfg.num_layers, "heads": cfg.num_heads,
          "vocab": cfg.vocab_size, "batch": GPT_BATCH, "seq_len": GPT_SEQ,
          "dtype": "float32", "dropout": 0.0,
          "optimizer": "Adam(%g)" % DYGRAPH_LR, "parameters": n_params,
          "setup_s": setup_s, "step_ms": step_ms,
          "step_ms_median_last": ms, "timed_steps": DYGRAPH_TIMED,
          "tokens_per_s": GPT_BATCH * GPT_SEQ / (ms / 1e3),
          "static_graphed_step_ms_this_run": static_ms,
          "ratio_to_static_this_run":
          None if not static_ms else ms / static_ms,
          "static_graphed_step_ms_recorded": DYGRAPH_YARDSTICK_MS,
          "ratio_to_static_recorded": [ms / y for y in DYGRAPH_YARDSTICK_MS],
          "losses": losses, "finite": finite, "falling": falling,
          "launches_per_step": per_step, "launches_per_step_ok": counts_ok,
          "launches": launches, "peak_mem_gb": peak / 2 ** 30,
          "step_peak_above_resident_gb": (peak - resident) / 2 ** 30,
          "profile": found, "families_missing": missing,
          "library_kernels": library})
    if not ok:
        raise AssertionError("dygraph_gpt checks failed (see the line "
                             "above)")
    return launches, (model, opt, ins, feed)


def dygraph_traced(torch, np, ptt, counters, trained):
    """TracedLayer over the trained dygraph GPT-base's forward at batch 1
    (eval mode): the capture's launches, the replay equal to the eager
    forward bit for bit (loss and every token's loss), eager and replayed
    ms; then one more training step (minimize) on the training batch,
    after which the replay must equal the new eager forward bit for bit."""
    model, opt, ins, feed = trained
    with ptt.dygraph.guard():
        one = [ptt.dygraph.to_variable(feed[k][:1]) for k in _GPT_FEEDS]

        def eager():
            with ptt.dygraph.no_grad():
                loss, ce = model(*one)
            return loss.value, ce.value

        def same(outs, ref):
            return all(torch.equal(o.value, r) for o, r in zip(outs, ref))

        model.eval()
        ref = eager()
        counters.zero()
        t0 = time.perf_counter()
        outs, traced = ptt.dygraph.TracedLayer.trace(model, one)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        launches = counters.read()
        replay_equal = same(outs, ref) and same(traced(one), ref)
        before = counters.read()
        eager_ms = _timed_runs(torch, eager, DYGRAPH_TRACED_REPS)
        replay_ms = _timed_runs(torch, lambda: traced(one),
                                DYGRAPH_TRACED_REPS)
        after = counters.read()
        model.train()
        _dygraph_step(model, opt, ins)
        model.eval()
        new_ref = eager()
        follows = same(traced(one), new_ref)
        moved = not torch.equal(new_ref[1], ref[1])
        model.train()
    replay_launches = (after["flash_attention_fwd"] -
                       before["flash_attention_fwd"]) - DYGRAPH_TRACED_REPS \
        * GPT_PER_STEP["flash_attention_fwd"]
    state = _traced_state_cases(torch, np, ptt)
    ok = replay_equal and follows and moved and traced.captures == 1 and \
        replay_launches == 0 and all(c["ok"] for c in state.values())
    emit({"phase": "dygraph_traced", "ok": ok, "batch": 1,
          "seq_len": GPT_SEQ, "capture_s": capture_s,
          "capture_launches": launches, "captures": traced.captures,
          "replay_bit_equal_eager": replay_equal,
          "eager_ms": eager_ms, "replay_ms": replay_ms,
          "eager_ms_median": statistics.median(eager_ms),
          "replay_ms_median": statistics.median(replay_ms),
          "replays_launch_no_wrapper": replay_launches == 0,
          "follows_minimize_bit_equal": follows,
          "weights_moved": moved, "state_cases": state})
    if not ok:
        raise AssertionError("dygraph_traced checks failed (see the line "
                             "above)")
    return launches


def _traced_state_cases(torch, np, ptt):
    """TracedLayer over layers with state the forward itself updates, or
    a tensor set_dict moves (DYGRAPH_STATE_BATCH, f32, eval mode): a
    Conv2D + BatchNorm (its moving statistics) and a Linear through a
    SpectralNorm'd weight (its U/V advance at every call), each traced
    after one training step, then trained one more step (Adam 1e-2) and
    replayed again; each replay equal bit for bit to the eager forward
    from the same state, buffers included (the replay's state kept, the
    state before it restored for the eager call); a Linear re-loaded by
    set_dict at another width: the next call captures again and equals
    the eager forward. {case: its numbers and ok}."""
    dy = ptt.dygraph
    rng = np.random.RandomState(SEED)

    class SNLinear(dy.Layer):
        def __init__(self, n_in, n_out):
            super(SNLinear, self).__init__()
            self.w = self.add_parameter(
                "w", self.create_parameter([n_in, n_out]))
            self.sn = dy.SpectralNorm([n_in, n_out], dim=1, power_iters=2)

        def forward(self, x):
            return ptt.layers.matmul(x, self.sn(self.w))

    def buffers(net):
        return [v for l in [net] + net.sublayers() for k, v in
                sorted(vars(l).items()) if k in ("_mean", "_variance",
                                                  "_u", "_v")]

    def replay_equals_eager(net, traced, x):
        bufs = [b.value for b in buffers(net)]
        before = [b.clone() for b in bufs]
        got = traced([x]).value
        replayed = [b.clone() for b in bufs]
        with torch.no_grad():
            for b, v in zip(bufs, before):
                b.copy_(v)
        with dy.no_grad():
            want = net(x).value
        return torch.equal(got, want) and all(
            torch.equal(a, b) for a, b in zip(replayed, bufs)), got

    def train_step(net, opt, x):
        net.train()
        loss = ptt.layers.reduce_mean(net(x))
        loss.backward()
        opt.minimize(loss)
        net.clear_gradients()
        net.eval()

    n, c, hw, d = DYGRAPH_STATE_BATCH, 16, 32, 256
    cases = {}
    with dy.guard():
        np.random.seed(SEED)
        for name, net, x in (
                ("conv_batch_norm",
                 dy.Sequential(dy.Conv2D(c, c, 3, padding=1),
                               dy.BatchNorm(c, act="relu")),
                 rng.standard_normal((n, c, hw, hw))),
                ("spectral_norm", SNLinear(d, d),
                 rng.standard_normal((n, d)))):
            x = dy.to_variable(x.astype(np.float32))
            opt = dy.optimizers.Adam(1e-2, parameter_list=net.parameters())
            train_step(net, opt, x)
            traced = dy.TracedLayer(net)
            first, out0 = replay_equals_eager(net, traced, x)
            again, _ = replay_equals_eager(net, traced, x)
            train_step(net, opt, x)
            after, out1 = replay_equals_eager(net, traced, x)
            moved = not torch.equal(out0, out1)
            cases[name] = {"buffers": len(buffers(net)),
                           "replay_bit_equal_eager": [first, again],
                           "after_a_step_bit_equal_eager": after,
                           "output_moved": moved,
                           "captures": traced.captures,
                           "ok": first and again and after and moved and
                           traced.captures == 1}
        net = dy.Linear(d, d)
        x = dy.to_variable(rng.standard_normal((n, d)).astype(np.float32))
        traced = dy.TracedLayer(net)
        with dy.no_grad():
            first = torch.equal(traced([x]).value, net(x).value)
        net.set_dict({"weight": rng.standard_normal((d, d // 2)).astype(
            np.float32), "bias": np.zeros(d // 2, np.float32)})
        got = traced([x]).value
        with dy.no_grad():
            want = net(x).value
        cases["set_dict_other_width"] = {
            "shape": list(got.shape), "captures": traced.captures,
            "bit_equal_eager": [first, torch.equal(got, want)],
            "ok": first and torch.equal(got, want) and
            traced.captures == 2 and tuple(got.shape) == (n, d // 2)}
    return cases


def dygraph_parity(torch, np, ptt):
    """A PARITY_LAYERS-layer GPT-base-width model at GPT_PARITY_BATCH x
    GPT_PARITY_SEQ: the static gpt_pretrain_program's startup weights
    copied into the dygraph model name for name, PARITY_STEPS Adam steps
    on one batch in dygraph mode on the card, against the card's static
    Executor.run (graphed) and the CPU's dygraph (plain versions), held
    to PARITY_*."""
    from paddle_tpu_torch.framework.scope import to_numpy
    from paddle_tpu_torch.models import gpt
    cfg = _gpt_cfg(gpt, num_layers=PARITY_LAYERS)
    main, startup, fetch_list = _gpt_train_program(
        ptt, gpt, cfg, GPT_PARITY_BATCH, GPT_PARITY_SEQ)
    feed = gpt.synthetic_batch(cfg, GPT_PARITY_BATCH, GPT_PARITY_SEQ,
                               seed=1)
    names = _dygraph_static_names(cfg.num_layers)
    scope = ptt.Scope()
    exe = ptt.Executor()
    exe.run(startup, scope=scope)
    start = {k: to_numpy(scope.find_var(v)) for k, v in names.items()}
    static_losses = [float(np.asarray(exe.run(
        main, feed=feed, fetch_list=fetch_list, scope=scope)[0]).reshape(()))
        for _ in range(PARITY_STEPS)]
    static = {k: to_numpy(scope.find_var(v)) for k, v in names.items()}
    exe.close()
    runs = {}
    for label, place in (("gpu", ptt.CUDAPlace(0)), ("cpu", ptt.CPUPlace())):
        t0 = time.perf_counter()
        with ptt.dygraph.guard(place):
            model = _dygraph_gpt(ptt, cfg)
            model.set_dict(start)
            opt = ptt.dygraph.optimizers.Adam(
                PARITY_LR, parameter_list=model.parameters())
            ins = _dygraph_inputs(ptt, feed)
            losses = [_dygraph_step(model, opt, ins)
                      for _ in range(PARITY_STEPS)]
            runs[label] = (losses, model.state_dict(),
                           (time.perf_counter() - t0) * 1e3)
        del model, opt
    (gl, gs, g_ms), (cl, cs, c_ms) = runs["gpu"], runs["cpu"]
    rel = lambda a, b: max(abs(x - y) / abs(y) for x, y in zip(a, b))
    vs_static, static_ok = _param_agreement(np, "float32", (
        (k, "float32", start[k], gs[k], static[k]) for k in static))
    vs_cpu, cpu_ok = _param_agreement(np, "float32", (
        (k, "float32", start[k], gs[k], cs[k]) for k in static))
    bit_equal = gl == static_losses and all(
        np.array_equal(gs[k], static[k]) for k in static)
    loss_ok = rel(gl, static_losses) <= PARITY_LOSS_RTOL["float32"] and \
        rel(gl, cl) <= PARITY_LOSS_RTOL["float32"] and \
        all(np.isfinite(gl))
    ok = loss_ok and static_ok and cpu_ok
    emit({"phase": "dygraph_parity", "ok": ok, "layers": PARITY_LAYERS,
          "hidden": cfg.hidden_size, "vocab": cfg.vocab_size,
          "batch": GPT_PARITY_BATCH, "seq_len": GPT_PARITY_SEQ,
          "steps": PARITY_STEPS, "lr": PARITY_LR,
          "gpu_dygraph_losses": gl, "gpu_static_losses": static_losses,
          "cpu_dygraph_losses": cl,
          "loss_max_rel_err_vs_static": rel(gl, static_losses),
          "loss_max_rel_err_vs_cpu": rel(gl, cl),
          "loss_rtol": PARITY_LOSS_RTOL["float32"],
          "vs_static": vs_static, "vs_cpu": vs_cpu,
          "bit_equal_static": bit_equal, "gpu_ms": g_ms, "cpu_ms": c_ms})
    if not ok:
        raise AssertionError("dygraph_parity checks failed (see the line "
                             "above)")


def _zoo_layers(np, ptt, rng):
    """(name, factory, numpy inputs) of every dygraph.nn layer but Dropout
    and NCE (dygraph_zoo checks those by statistics) and the two
    rnn_impl units, at small sizes."""
    from paddle_tpu_torch.contrib.layers import rnn_impl
    dy = ptt.dygraph

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    edges = np.array([[[0, 1], [0, 2], [1, 3], [-1, -1]]], np.int64)
    return [
        ("Linear", lambda: dy.Linear(16, 8, act="relu"), [f(4, 16)]),
        ("Conv2D", lambda: dy.Conv2D(3, 8, 3, padding=1, act="relu"),
         [f(2, 3, 16, 16)]),
        ("Pool2D", lambda: dy.Pool2D(pool_size=2, pool_stride=2,
                                     pool_type="avg"), [f(2, 3, 8, 8)]),
        ("BatchNorm", lambda: dy.BatchNorm(8), [f(4, 8, 6, 6)]),
        ("Embedding", lambda: dy.Embedding([100, 16]),
         [rng.randint(0, 100, (4, 5, 1)).astype(np.int64)]),
        ("LayerNorm", lambda: dy.LayerNorm(32), [f(4, 6, 32)]),
        ("GRUUnit", lambda: dy.GRUUnit(48), [f(4, 48), f(4, 16)]),
        ("FC", lambda: dy.FC("fc", 7, num_flatten_dims=2),
         [f(2, 3, 4, 5)]),
        ("Conv2DTranspose", lambda: dy.Conv2DTranspose(3, 5, 3, stride=2),
         [f(2, 3, 8, 8)]),
        ("Conv3D", lambda: dy.Conv3D(3, 4, 3, padding=1),
         [f(2, 3, 4, 6, 6)]),
        ("Conv3DTranspose", lambda: dy.Conv3DTranspose(3, 4, 2, stride=2),
         [f(2, 3, 4, 6, 6)]),
        ("GroupNorm", lambda: dy.GroupNorm(8, 4), [f(2, 8, 5, 5)]),
        ("SpectralNorm", lambda: dy.SpectralNorm([6, 4], power_iters=5),
         [f(6, 4)]),
        ("PRelu", lambda: dy.PRelu("channel", input_shape=[2, 3, 8, 8]),
         [f(2, 3, 8, 8)]),
        ("BilinearTensorProduct",
         lambda: dy.BilinearTensorProduct(4, 5, 6), [f(3, 4), f(3, 5)]),
        ("RowConv", lambda: dy.RowConv("rc", 2), [f(2, 7, 5)]),
        ("SequenceConv", lambda: dy.SequenceConv("sc", 6, 3),
         [f(2, 7, 5)]),
        ("TreeConv", lambda: dy.TreeConv("tc", 6, 2), [f(1, 5, 4), edges]),
        ("BasicGRUUnit", lambda: rnn_impl.BasicGRUUnit("gru", 16),
         [f(4, 8), f(4, 16)]),
        ("BasicLSTMUnit", lambda: rnn_impl.BasicLSTMUnit("lstm", 16),
         [f(4, 8), f(4, 16), f(4, 16)]),
    ]


def _zoo_run(np, ptt, place, make, arrays, seed):
    """One layer's forward and backward (the float outputs against fixed
    random cotangents) on ``place``: {name: array} of its outputs, its
    parameters' and float inputs' gradients and its buffers."""
    L = ptt.layers
    with ptt.dygraph.guard(place):
        np.random.seed(seed)
        layer = make()
        ins = [ptt.dygraph.to_variable(a) for a in arrays]
        out = layer(*ins)
        outs = [o for o in (out if isinstance(out, (tuple, list))
                            else [out]) if o.dtype.startswith("float")]
        cots = np.random.RandomState(seed + 1)
        total = None
        for o in outs:
            cot = ptt.dygraph.to_variable(
                cots.standard_normal(o.shape).astype(np.float32))
            cot.stop_gradient = True
            term = L.reduce_sum(L.elementwise_mul(o, cot))
            total = term if total is None else L.elementwise_add(total, term)
        total.backward()
        got = {"out%d" % i: o.numpy() for i, o in enumerate(outs)}
        got.update({"grad:" + n: p.gradient()
                    for n, p in layer.named_parameters()
                    if p.gradient() is not None})
        got.update({"dx%d" % i: v.gradient() for i, v in enumerate(ins)
                    if v.gradient() is not None})
        for buf in ("_mean", "_variance", "_u", "_v"):
            if hasattr(layer, buf):
                got[buf] = getattr(layer, buf).numpy()
    return got


def _zoo_dropout(torch, np, ptt):
    """Dropout on the card by its statistics: the kept share within 5
    standard errors of 1 - p, kept values x (downgrade_in_infer) or x / (1
    - p) (upscale_in_train), the gradient the same mask, eval mode x * (1 -
    p) or x."""
    p, n = 0.3, ZOO_DROPOUT_N
    out = {}
    ok = True
    with ptt.dygraph.guard():
        for mode, kept_value, eval_scale in (
                ("downgrade_in_infer", 1.0, 1.0 - p),
                ("upscale_in_train", 1.0 / (1.0 - p), 1.0)):
            layer = ptt.dygraph.Dropout(p, mode)
            x = ptt.dygraph.to_variable(np.ones(n, np.float32))
            y = layer(x)
            ptt.layers.reduce_sum(y).backward()
            yv, gv = y.numpy(), x.gradient()
            keep = yv != 0
            share = float(keep.mean())
            se = math.sqrt(p * (1 - p) / n)
            layer.eval()
            ev = layer(x).numpy()
            case_ok = bool(abs(share - (1 - p)) <= 5 * se and
                           np.allclose(yv[keep], kept_value, rtol=1e-6) and
                           np.array_equal(gv != 0, keep) and
                           np.allclose(ev, eval_scale, rtol=1e-6))
            out[mode] = {"kept_share": share, "expected": 1 - p,
                         "standard_error": se, "ok": case_ok}
            ok = ok and case_ok
    return out, ok


def _zoo_nce(torch, np, ptt):
    """NCE: the layer forward and backward on the card (finite cost (N,
    1), a weight gradient); its noise classes by their statistics
    (uniform and log-uniform counts over ZOO_NCE_DRAWS draws, each within
    5 standard errors of its expectation); its cost given the same noise
    classes on the card and on the CPU (within ZOO_TOL)."""
    from paddle_tpu_torch.ops import loss_extra_ops as lx
    rng = np.random.RandomState(3)
    c, d, n, k = 20, 8, 4, 5
    feats = rng.standard_normal((n, d)).astype(np.float32)
    labels = rng.randint(0, c, (n, 1)).astype(np.int64)
    with ptt.dygraph.guard():
        np.random.seed(5)
        layer = ptt.dygraph.NCE(num_total_classes=c, dim=d,
                                num_neg_samples=k)
        cost = layer(ptt.dygraph.to_variable(feats),
                     ptt.dygraph.to_variable(labels))
        ptt.layers.reduce_sum(cost).backward()
        layer_ok = (cost.shape == (n, 1) and
                    bool(np.isfinite(cost.numpy()).all()) and
                    float(np.abs(layer.weight.gradient()).sum()) > 0)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    stats = {}
    for sampler in ("uniform", "log_uniform"):
        drawn = lx.sample_classes(g, c, ZOO_NCE_DRAWS, sampler, dev)
        counts = np.bincount(drawn.cpu().numpy(), minlength=c)
        q = lx._sampler_prob(torch.arange(c), c, sampler).numpy()
        se = np.sqrt(ZOO_NCE_DRAWS * q * (1 - q))
        worst = float((np.abs(counts - ZOO_NCE_DRAWS * q) / se).max())
        stats[sampler] = {"worst_standard_errors": worst,
                          "ok": bool(worst <= 5.0 and counts.sum() ==
                                     ZOO_NCE_DRAWS)}
    neg = torch.as_tensor(rng.randint(0, c, k))
    w = torch.as_tensor(rng.standard_normal((c, d)).astype(np.float32))
    b = torch.as_tensor(rng.standard_normal(c).astype(np.float32))
    args = [torch.as_tensor(feats), torch.as_tensor(labels.reshape(-1)), w,
            b, neg]
    want = lx.nce_cost(*args, c, "log_uniform").numpy()
    got = lx.nce_cost(*[a.to(dev) for a in args], c,
                      "log_uniform").cpu().numpy()
    cost_err = float(np.abs(got - want).max())
    ok = layer_ok and all(s["ok"] for s in stats.values()) and \
        cost_err <= ZOO_TOL * float(np.abs(want).max())
    return {"layer_ok": layer_ok, "samplers": stats,
            "cost_max_abs_err": cost_err}, ok


def dygraph_zoo(torch, np, ptt):
    """Every dygraph.nn layer and the two rnn_impl units forward and
    backward on the card against the CPU at small sizes (outputs,
    parameter and input gradients, buffers within ZOO_TOL of the CPU's
    largest magnitude); Dropout and NCE by their statistics."""
    rng = np.random.RandomState(SEED)
    cases, ok = {}, True
    for i, (name, make, arrays) in enumerate(_zoo_layers(np, ptt, rng)):
        gpu = _zoo_run(np, ptt, ptt.CUDAPlace(0), make, arrays, 100 + i)
        cpu = _zoo_run(np, ptt, ptt.CPUPlace(), make, arrays, 100 + i)
        errs = {}
        case_ok = set(gpu) == set(cpu)
        for key, want in cpu.items():
            got = gpu.get(key)
            if got is None or got.shape != want.shape:
                case_ok = False
                continue
            err = float(np.abs(got - want).max())
            errs[key] = err
            case_ok = case_ok and err <= ZOO_TOL * max(
                float(np.abs(want).max()), 1e-6)
        cases[name] = {"ok": case_ok, "checked": sorted(errs),
                       "max_abs_err": max(errs.values()) if errs else None}
        ok = ok and case_ok
    cases["Dropout"], drop_ok = _zoo_dropout(torch, np, ptt)
    cases["NCE"], nce_ok = _zoo_nce(torch, np, ptt)
    ok = ok and drop_ok and nce_ok
    emit({"phase": "dygraph_zoo", "ok": ok, "tol": ZOO_TOL,
          "layers": len(cases), "cases": cases})
    if not ok:
        raise AssertionError("dygraph_zoo checks failed (see the line "
                             "above)")


def _book_chapter(pkg, name, w):
    """One Book chapter built with ``pkg``'s layers (paddle_tpu_torch, or
    the JAX package in tests/test_torch_book.py) at widths ``w`` (BOOK's
    keys and ``_book_widths``'): (main, startup, [loss, ...], the
    inference program's (feed names, targets) or None). Every feed has a
    static batch; sequences are dense (N, T) ids, with lengths where the
    Book's LoD ends a sequence."""
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    # the two served chapters take any batch (the Predictor's buckets)
    b = -1 if name in ("fit_a_line", "recognize_digits") else w["batch"]

    def data(n, shape, dtype="float32"):
        return L.data(n, [b] + list(shape), dtype, append_batch_size=False)

    serve = None
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        if name == "fit_a_line":
            x, y = data("x", [13]), data("y", [1])
            pred = L.fc(x, 1)
            loss = L.mean(L.square_error_cost(pred, y))
            fetch, serve = [loss], (["x"], [pred])
            opt = pkg.optimizer.SGD(w["lr"])
        elif name == "recognize_digits":
            img, label = data("img", [1, 28, 28]), data("label", [1],
                                                         "int64")
            h = pkg.nets.simple_img_conv_pool(
                img, filter_size=5, num_filters=w["filters"][0], pool_size=2,
                pool_stride=2, act="relu")
            h = L.batch_norm(h)
            h = pkg.nets.simple_img_conv_pool(
                h, filter_size=5, num_filters=w["filters"][1], pool_size=2,
                pool_stride=2, act="relu")
            pred = L.fc(h, 10, act="softmax")
            loss = L.mean(L.cross_entropy(pred, label))
            fetch = [loss, L.accuracy(pred, label)]
            serve = (["img"], [pred])
            opt = pkg.optimizer.Adam(w["lr"])
        elif name == "image_classification":
            img, label = data("img", [3, 32, 32]), data("label", [1],
                                                         "int64")
            pred = L.fc(_resnet_cifar10(L, img, w["depth"]), 10,
                        act="softmax")
            loss = L.mean(L.cross_entropy(pred, label))
            fetch = [loss, L.accuracy(pred, label)]
            opt = pkg.optimizer.Adam(w["lr"])
        elif name == "word2vec":
            words = [data("w%d" % i, [1], "int64") for i in range(w["n"])]
            dict_size = w["dict_size"]
            embs = [L.embedding(v, size=[dict_size, w["emb"]],
                                param_attr="shared_w")
                    for v in words[:-1]]
            hidden = L.fc(L.concat(embs, axis=1), w["hidden"],
                          act="sigmoid")
            pred = L.fc(hidden, dict_size, act="softmax")
            loss = L.mean(L.cross_entropy(pred, words[-1]))
            fetch = [loss]
            opt = pkg.optimizer.SGD(w["lr"])
        elif name == "understand_sentiment":
            ids, label = data("ids", [w["seq"]], "int64"), data(
                "label", [1], "int64")
            emb = L.embedding(ids, size=[w["dict_size"], w["emb"]])
            convs = [pkg.nets.sequence_conv_pool(
                emb, num_filters=w["filters"], filter_size=k, act="tanh",
                pool_type="max") for k in (3, 4)]
            pred = L.fc(convs, 2, act="softmax")
            loss = L.mean(L.cross_entropy(pred, label))
            fetch = [loss, L.accuracy(pred, label)]
            opt = pkg.optimizer.Adagrad(w["lr"])
        elif name == "recommender_system":
            fetch = [_recommender(pkg, L, data, w)]
            opt = pkg.optimizer.SGD(w["lr"])
        elif name == "label_semantic_roles":
            fetch = [_semantic_roles(pkg, L, data, w)]
            opt = pkg.optimizer.SGD(L.exponential_decay(
                w["lr"], w["decay_steps"], w["decay_rate"], staircase=True))
        elif name == "machine_translation":
            src, trg, nxt = (data(n, [w["seq"]], "int64")
                             for n in ("src", "trg", "nxt"))
            gru = pkg.contrib.layers.basic_gru
            _, enc_h = gru(L.embedding(src, size=[w["dict"], w["word"]]),
                           None, hidden_size=w["hidden"])
            dec, _ = gru(L.embedding(trg, size=[w["dict"], w["word"]]),
                         enc_h, hidden_size=w["hidden"])
            logits = L.fc(dec, w["dict"], num_flatten_dims=2)
            loss = L.reduce_mean(L.softmax_with_cross_entropy(
                logits, L.unsqueeze(nxt, [2])))
            fetch = [loss]
            opt = pkg.optimizer.Adagrad(
                w["lr"], regularization=pkg.regularizer.L2Decay(w["l2"]))
        else:
            raise KeyError(name)
        opt.minimize(fetch[0])
    startup.random_seed = SEED
    return main, startup, fetch, serve


def _resnet_cifar10(L, x, depth):
    """The Book's resnet_cifar10: conv_bn 16, three stages of (depth - 2)
    / 6 basic blocks at 16, 32 and 64 channels, an 8 x 8 average pool."""
    def conv_bn(h, ch, k, stride, pad, act="relu", bias_attr=False):
        h = L.conv2d(h, ch, k, stride=stride, padding=pad, act=None,
                     bias_attr=bias_attr)
        return L.batch_norm(h, act=act)

    def block(h, ch_in, ch_out, stride):
        t = conv_bn(h, ch_out, 3, stride, 1)
        t = conv_bn(t, ch_out, 3, 1, 1, act=None, bias_attr=None)
        short = conv_bn(h, ch_out, 1, stride, 0, None) if ch_in != ch_out \
            else h
        return L.elementwise_add(t, short, act="relu")

    n = (depth - 2) // 6
    h = conv_bn(x, 16, 3, 1, 1)
    for ch_in, ch_out, stride in ((16, 16, 1), (16, 32, 2), (32, 64, 2)):
        h = block(h, ch_in, ch_out, stride)
        for _ in range(1, n):
            h = block(h, ch_out, ch_out, 1)
    return L.pool2d(h, pool_size=8, pool_type="avg", pool_stride=1)


def _recommender(pkg, L, data, w):
    """The Book's dual tower: the user's id, gender, age and job
    embeddings each through an fc, concatenated, fc tanh; the movie's id
    embedding through an fc, its categories' embeddings summed over their
    count (``sequence_pool``), its title's through ``sequence_conv_pool``
    (window 3, sum); cos_sim of the towers times 5 against the rating."""
    e, s = w["emb"], w["small"]
    usr = []
    for n, size, width in (("uid", w["users"], e), ("gender", 2, s),
                           ("age", w["ages"], s), ("job", w["jobs"], s)):
        emb = L.embedding(data(n, [1], "int64"), size=[size, width],
                          param_attr=n + "_table")
        usr.append(L.fc(emb, width))
    usr = L.fc(L.concat(usr, axis=1), w["hidden"], act="tanh")
    mov = L.fc(L.embedding(data("mid", [1], "int64"),
                           size=[w["movies"], e],
                           param_attr="movie_table"), e)
    cats = L.embedding(data("cats", [w["cats"]], "int64"),
                       size=[w["categories"], e])
    cats = L.sequence_pool(cats, "sum",
                           lengths=data("cat_len", [], "int64"))
    title = pkg.nets.sequence_conv_pool(
        L.embedding(data("title", [w["title"]], "int64"),
                    size=[w["titles"], e]),
        num_filters=e, filter_size=3, act="tanh", pool_type="sum")
    mov = L.fc(L.concat([mov, cats, title], axis=1), w["hidden"],
               act="tanh")
    pred = L.scale(L.cos_sim(usr, mov), scale=5.0)
    return L.mean(L.square_error_cost(pred, data("score", [1])))


def _semantic_roles(pkg, L, data, w):
    """The Book's db_lstm: the word and its five context words through one
    fixed embedding table, the predicate's and the mark's embeddings, an
    fc tanh each, summed; ``depth`` dynamic LSTMs of size ``hidden``
    (hidden / 4 units), alternating direction, each fed the sum of an fc
    of the previous mix and one of its LSTM's output; a CRF over the
    label dict (its transitions at ``crf_lr``). Dense (N, T) tokens: the
    LSTMs run over the padded steps, the CRF reads the lengths."""
    t, h = w["seq"], w["hidden"]
    table = pkg.ParamAttr(name="emb", trainable=False)
    embs = [L.embedding(data(n, [t], "int64"), size=[w["words"], w["word"]],
                        param_attr=table)
            for n in ("word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1",
                      "ctx_p2")]
    embs.append(L.embedding(data("verb", [t], "int64"),
                            size=[w["verbs"], w["word"]], param_attr="vemb"))
    embs.append(L.embedding(data("mark", [t], "int64"), size=[2, w["mark"]]))
    mix = L.sums([L.fc(e, h, num_flatten_dims=2, act="tanh") for e in embs])
    lstm, _ = L.dynamic_lstm(mix, h, candidate_activation="relu",
                             gate_activation="sigmoid",
                             cell_activation="sigmoid")
    for i in range(1, w["depth"]):
        mix = L.sums([L.fc(mix, h, num_flatten_dims=2, act="tanh"),
                      L.fc(lstm, h, num_flatten_dims=2, act="tanh")])
        lstm, _ = L.dynamic_lstm(mix, h, candidate_activation="relu",
                                 gate_activation="sigmoid",
                                 cell_activation="sigmoid",
                                 is_reverse=(i % 2) == 1)
    feature = L.sums([L.fc(mix, w["labels"], num_flatten_dims=2, act="tanh"),
                      L.fc(lstm, w["labels"], num_flatten_dims=2,
                           act="tanh")])
    crf = L.linear_chain_crf(
        feature, data("target", [t], "int64"),
        param_attr=pkg.ParamAttr(name="crfw", learning_rate=w["crf_lr"]),
        length=data("length", [], "int64"))
    # the op gives each row's log-likelihood: the cost is its negation,
    # as tests/test_book.py takes it
    return L.mean(L.scale(crf, scale=-1.0))


def _bn_fed_biases(main):
    """The biases added straight before a batch norm (resnet_cifar10's
    second convolution of a block): the norm removes any constant, so
    their gradient is zero up to rounding."""
    ops = main.global_block().ops
    bn_inputs = {n for o in ops if o.type == "batch_norm"
                 for n in o.input("X")}
    return [o.input("Y")[0] for o in ops if o.type == "elementwise_add"
            and o.output("Out")[0] in bn_inputs and
            main.global_block().var(o.input("Y")[0]).persistable]


def _book_widths(ds, name, w):
    """``w`` with the sizes the chapter reads from its corpus (the
    module ``ds``: either package's dataset)."""
    w = dict(w)
    if name == "word2vec":
        w["dict_size"] = len(ds.imikolov.build_dict(w["min_freq"]))
    elif name == "understand_sentiment":
        w["dict_size"] = len(ds.imdb.word_dict())
    elif name == "recommender_system":
        ml = ds.movielens
        w.update(users=ml.max_user_id() + 1, movies=ml.max_movie_id() + 1,
                 jobs=ml.max_job_id() + 1, ages=len(ml.age_table),
                 categories=len(ml.movie_categories()),
                 titles=len(ml.get_movie_title_dict()))
    elif name == "label_semantic_roles":
        words, verbs, labels = ds.conll05.get_dict()
        w.update(words=len(words), verbs=len(verbs), labels=len(labels))
    return w


def _pad_rows(np, rows, width, pad=0):
    """(len(rows), width) int64 of ``rows`` cut or padded with ``pad``, and
    each row's length within ``width``."""
    out = np.full((len(rows), width), pad, np.int64)
    lens = np.zeros(len(rows), np.int64)
    for i, r in enumerate(rows):
        n = min(len(r), width)
        out[i, :n] = r[:n]
        lens[i] = n
    return out, lens


def _book_batches(np, ds, name, w, n):
    """``n`` consecutive batches of the chapter's corpus (the module
    ``ds``: either package's dataset), as feeds."""
    import itertools
    b = w["batch"]

    def take(reader):
        rows = list(itertools.islice(reader(), b * n))
        return [rows[i * b:(i + 1) * b] for i in range(n)]

    if name == "fit_a_line":
        return [{"x": np.stack([r[0] for r in rs]),
                 "y": np.stack([r[1] for r in rs])}
                for rs in take(ds.uci_housing.train())]
    if name == "recognize_digits":
        return [{"img": np.stack([r[0] for r in rs]).reshape(b, 1, 28, 28),
                 "label": np.array([[r[1]] for r in rs], np.int64)}
                for rs in take(ds.mnist.train())]
    if name == "image_classification":
        return [{"img": np.stack([r[0] for r in rs]).reshape(b, 3, 32, 32),
                 "label": np.array([[r[1]] for r in rs], np.int64)}
                for rs in take(ds.cifar.train10())]
    if name == "word2vec":
        d = ds.imikolov.build_dict(w["min_freq"])
        return [{"w%d" % i: np.array([[r[i]] for r in rs], np.int64)
                 for i in range(w["n"])}
                for rs in take(ds.imikolov.train(d, w["n"]))]
    if name == "understand_sentiment":
        return [{"ids": _pad_rows(np, [r[0] for r in rs], w["seq"])[0],
                 "label": np.array([[r[1]] for r in rs], np.int64)}
                for rs in take(ds.imdb.train(ds.imdb.word_dict()))]
    if name == "recommender_system":
        out = []
        for rs in take(ds.movielens.train):
            cats, cat_len = _pad_rows(np, [r[5] for r in rs], w["cats"])
            out.append({
                "uid": np.array([[r[0]] for r in rs], np.int64),
                "gender": np.array([[r[1]] for r in rs], np.int64),
                "age": np.array([[r[2]] for r in rs], np.int64),
                "job": np.array([[r[3]] for r in rs], np.int64),
                "mid": np.array([[r[4]] for r in rs], np.int64),
                "cats": cats, "cat_len": cat_len,
                "title": _pad_rows(np, [r[6] for r in rs], w["title"])[0],
                "score": np.array([r[7] for r in rs],
                                  np.float32).reshape(b, 1)})
        return out
    if name == "label_semantic_roles":
        out = []
        keys = ("word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1", "ctx_p2",
                "verb", "mark", "target")
        for rs in take(ds.conll05.test()):
            feed = {k: _pad_rows(np, [r[i] for r in rs], w["seq"])[0]
                    for i, k in enumerate(keys)}
            feed["length"] = _pad_rows(np, [r[0] for r in rs], w["seq"])[1]
            out.append(feed)
        return out
    if name == "machine_translation":
        return [{k: _pad_rows(np, [r[i] for r in rs], w["seq"])[0]
                 for i, k in enumerate(("src", "trg", "nxt"))}
                for rs in take(ds.wmt14.train(w["dict"]))]
    raise KeyError(name)


# each chapter's bar, from tests/test_book.py's: (what, the test file's
# bar, its steps, its learning rate). A loss bar is the fall the test asks
# (1 - its ratio, or nats), an accuracy bar the rise above chance; each is
# scaled to BOOK_STEPS runs at the Book's rate (the test file trains at
# another): the fall times min(1, steps * rate / (its steps * its rate)).
# image_classification has no test there: its loss must fall. The Book's
# machine_translation trains with Adagrad at 1e-4 over a 30000-word
# softmax, which moves its loss ~1e-4 of itself in 30 runs (a CPU run of
# this chapter): it is held to falling, not to the scaled 0.7.
BOOK_TEST_BARS = {
    "fit_a_line": ("ratio", 0.2, 105, 0.01),
    "recognize_digits": ("accuracy", 0.9, 36, 0.001, 0.1),
    "image_classification": ("ratio", 1.0, 1, 1.0),
    "word2vec": ("nats", 0.5, 80, 0.005),
    "understand_sentiment": ("accuracy", 0.85, 48, 0.002, 0.5),
    "recommender_system": ("ratio", 0.6, 60, 0.005),
    "label_semantic_roles": ("ratio", 0.8, 30, 0.005),
    "machine_translation": ("ratio", 1.0, 1, 1.0),
}


def _book_bar(name, lr):
    """(what, bar) of a chapter: the last pass's mean loss at most
    ``bar`` times the first pass's ("ratio"), at least ``bar`` nats below
    it ("nats"), or the last pass's mean accuracy at least ``bar``
    ("accuracy"), with the loss falling in every case."""
    what, bar, steps, rate = BOOK_TEST_BARS[name][:4]
    scale = min(1.0, BOOK_STEPS * lr / (steps * rate))
    if what == "ratio":
        return what, 1.0 - (1.0 - bar) * scale
    if what == "nats":
        return what, bar * scale
    chance = BOOK_TEST_BARS[name][4]
    return what, chance + (bar - chance) * scale


def _book_passes(np, rows, k):
    """The mean of each fetch over the first and the last ``k`` runs."""
    a = np.asarray(rows, np.float64)
    return a[:k].mean(0).tolist(), a[-k:].mean(0).tolist()


def _book_serve(torch, np, ptt, name, exe, main, scope, serve, batch,
                model_dir):
    """A served chapter: saved from the trained scope, loaded back by
    io.load_inference_model and by the Predictor, on the card, and the
    Predictor on the CPU; the three answers agree (SERVE_ATOL) and equal
    the trained program's forward on the card within it."""
    from paddle_tpu_torch.inference import Config, create_predictor
    feeds, targets = serve
    with ptt.scope_guard(scope):
        ptt.io.save_inference_model(model_dir, feeds, targets, exe,
                                    main_program=main)
    req = {n: batch[n] for n in feeds}
    load_exe, load_scope = ptt.Executor(), ptt.Scope()
    with ptt.scope_guard(load_scope):
        prog, fnames, fetches = ptt.io.load_inference_model(model_dir,
                                                            load_exe)
        loaded = [np.asarray(load_exe.run(prog, feed=req,
                                          fetch_list=fetches)[0])
                  for _ in range(3)]          # warm, capture, replay
    card = create_predictor(Config(model_dir))
    served = [np.asarray(card.run(req)[0]) for _ in range(3)]
    cpu_cfg = Config(model_dir)
    cpu_cfg.place = ptt.CPUPlace()
    cpu = np.asarray(create_predictor(cpu_cfg).run(req)[0])
    err = max(float(np.abs(a - cpu).max()) for a in loaded + served)
    replay_equal = all(np.array_equal(a, loaded[0]) for a in loaded) and \
        all(np.array_equal(a, served[0]) for a in served)
    close_executor(torch, "book serve " + name, load_exe)
    close_executor(torch, "book predictor " + name, card._exe)
    return {"feeds": fnames, "batch": int(cpu.shape[0]),
            "answer_shape": list(cpu.shape), "max_abs_err_vs_cpu": err,
            "atol": SERVE_ATOL, "replays_equal": replay_equal}, \
        err <= SERVE_ATOL and replay_equal and np.isfinite(cpu).all()


def book(torch, np, ptt, counters):
    """The eight Book chapters (BOOK) on the card, BOOK_STEPS runs each
    through Executor.run, graphed from the second (no op of theirs
    refuses capture): each loss curve, its first and last pass, the
    chapter's bar (_book_bar), ms a step, the capture record and the
    fused-Adam launches a step (one an Adam-updated parameter:
    recognize_digits and image_classification). fit_a_line and
    recognize_digits are saved and served again (_book_serve). The
    launch counters are set to 0 before the first chapter's runs and
    read after the last."""
    records, ok = {}, True
    model_root = os.path.join(_ROOT, "build", "chip_smoke_book")
    counters.zero()                          # the main path starts here
    for name, widths in BOOK.items():
        w = _book_widths(ptt.dataset, name, widths)
        main, startup, fetch, serve = _book_chapter(ptt, name, w)
        batches = _book_batches(np, ptt.dataset, name, w,
                                BOOK_BATCHES if w["cycle"] else 1)
        scope, exe = ptt.Scope(), ptt.Executor()         # CUDAPlace(0)
        exe.run(startup, scope=scope)
        adam = sum(1 for op in main.global_block().ops if op.type == "adam")
        rows, step_ms, per_step = [], [], []
        with ptt.scope_guard(scope):
            for i in range(BOOK_STEPS):
                before = counters.read()
                t1 = time.perf_counter()
                out = exe.run(main, feed=batches[i % len(batches)],
                              fetch_list=fetch)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t1) * 1e3)
                after = counters.read()
                per_step.append({k: after[k] - before[k] for k in after})
                rows.append([float(np.asarray(o).reshape(-1)[0])
                             for o in out])
        first, last = _book_passes(np, rows, len(batches))
        what, bar = _book_bar(name, w["lr"])
        falls = last[0] < first[0]
        if what == "ratio":
            cleared = last[0] <= bar * first[0]
        elif what == "nats":
            cleared = first[0] - last[0] >= bar
        else:
            cleared = last[1] >= bar
        finite = bool(np.isfinite(np.asarray(rows)).all())
        adam_ok = all(c["fused_adam"] == adam for c in per_step)
        others = all(v == 0 for c in per_step for k, v in c.items()
                     if k != "fused_adam")
        graphed = exe.graph_runs["replay"] >= BOOK_STEPS - 2 and \
            not exe.refusals
        rec = {"widths": {k: v for k, v in w.items()
                          if not isinstance(v, dict)},
               "parameters": sum(int(np.prod(p.shape))
                                 for p in main.all_parameters()),
               "program_ops": _n_ops(_op_counts(main)),
               "losses": [r[0] for r in rows],
               "first_pass": first, "last_pass": last, "bar": [what, bar],
               "falls": falls, "cleared": cleared, "finite": finite,
               "step_ms": step_ms,
               "replay_ms_median": statistics.median(step_ms[2:]),
               "fused_adam_per_step": adam, "launches_ok": adam_ok and others,
               "graph_runs": dict(exe.graph_runs),
               "refusals": list(exe.refusals.values()),
               "captures": _capture_record(exe)}
        good = finite and falls and cleared and adam_ok and others and \
            graphed
        if serve is not None:
            try:
                rec["serve"], served_ok = _book_serve(
                    torch, np, ptt, name, exe, main, scope, serve,
                    batches[0], os.path.join(model_root, name))
            finally:
                shutil.rmtree(os.path.join(model_root, name),
                              ignore_errors=True)
            good = good and served_ok
        rec["ok"] = good = bool(good)
        records[name] = rec
        ok = ok and good
        close_executor(torch, "book " + name, exe)
    launches = counters.read()
    emit({"phase": "book", "ok": ok, "steps": BOOK_STEPS,
          "chapters": records, "launches": launches})
    if not ok:
        raise AssertionError("book checks failed (see the line above)")
    return launches


def book_parity(torch, np, ptt, counters):
    """Each Book chapter at BOOK's widths, BOOK_PARITY_STEPS runs on its
    batches from the same startup weights, card graphed against the CPU
    and against op by op (_card_vs_cpu, PARITY_*; image_classification
    by _card_vs_cpu_all on one batch, PARITY_STEPS runs, at
    BOOK_PARITY_DEPTH); the card's launches over the phase."""
    records, ok = {}, True
    counters.zero()
    for name, widths in BOOK.items():
        w = _book_widths(ptt.dataset, name, widths)
        main, startup, fetch, _ = _book_chapter(ptt, name, w)
        batches = _book_batches(np, ptt.dataset, name, w,
                                BOOK_BATCHES if w["cycle"] else 1)
        feeds = [batches[i % len(batches)]
                 for i in range(BOOK_PARITY_STEPS)]
        if name == "image_classification":
            # resnet_cifar10 cut to BOOK_PARITY_DEPTH (its widths kept),
            # held as zoo_parity holds such models (losses, and each
            # tensor's L2 move): a net of relus and batch norms trained by
            # Adam at 1e-3 parts on last-bit differences (at depth 32 its
            # third loss by ~1e-3). Each block's second convolution has a
            # bias that feeds batch norm straight, whose gradient is zero
            # up to rounding: Adam moves it by up to lr a step either way
            # on either device, so it is held within 2 lr a step
            w = dict(w, depth=BOOK_PARITY_DEPTH)
            main, startup, fetch, _ = _book_chapter(ptt, name, w)
            flat = 2 * w["lr"] * PARITY_STEPS * (1 + 1e-3)
            records[name], good = _card_vs_cpu_all(
                np, ptt, main, startup, fetch, feeds[0],
                [(ZOO_KINK_LOSS_RTOL, 0.0), (0.0, 0.0)], ZOO_PARITY_RTOL,
                ZOO_PARITY_ATOL, atol_scaled=True,
                moved_rtol=ZOO_KINK_MOVED_RTOL,
                bounded={n: flat for n in _bn_fed_biases(main)})
            records[name]["depth"] = BOOK_PARITY_DEPTH
            good = good and bool(_bn_fed_biases(main))
        else:
            records[name], good = _card_vs_cpu(np, ptt, main, startup,
                                               fetch[:1], feeds)
        ok = ok and good
    emit({"phase": "book_parity", "ok": ok, "chapters": records,
          "launches": counters.read()})
    if not ok:
        raise AssertionError("book_parity checks failed (see the line "
                             "above)")


class _OpCtx(object):
    """The run context of a kernel called alone (op_library): its device,
    a generator seeded from ``seed`` there, constants made at once."""

    def __init__(self, torch, device, seed=0):
        self.device = torch.device(device)
        self._torch = torch
        self._seed = seed

    def generator(self, attrs=None, flagged=True):
        g = self._torch.Generator(device=self.device)
        g.manual_seed(self._seed)
        return g

    def constant(self, make):
        return make()


def _op_cases(np, tmp):
    """(op, inputs {slot: [numpy]}, attrs, differentiable slots, outputs
    held exactly) for each deterministic op type of the library at
    OP_LIB's working sizes: elementwise ops and reductions on
    OP_LIB_ELEM f32, the index ops on an OP_LIB_ROWS-row table read and
    written at OP_LIB_IDS ids (repeats, and ids in [-n, 0) and past the
    end), the sequence ops on OP_LIB_SEQ (N, T, D)."""
    rng = np.random.RandomState(SEED)
    r, c = OP_LIB_ELEM
    rows, width = OP_LIB_ROWS, OP_LIB_WIDTH
    n, t, d = OP_LIB_SEQ

    def f(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    x, y = f(r, c), f(r, c)
    pos = np.abs(f(r, c)) + 0.1
    nonfinite = x.copy()
    nonfinite[::97, ::13] = np.nan
    nonfinite[::89, ::7] = np.inf
    table = f(rows, width)
    ids = rng.randint(0, rows, OP_LIB_IDS).astype(np.int64)
    ids[::8] = 7                               # a hot id, many repeats
    ids[1::97] = -rng.randint(1, rows, ids[1::97].size)
    ids[2::101] = rows + rng.randint(0, 5, ids[2::101].size)
    lens = rng.randint(0, t + 1, n).astype(np.int64)
    tokens = rng.randint(0, 50, (n, t)).astype(np.int64)
    seq = f(n, t, d)
    labels = rng.randint(0, c, (r, 1)).astype(np.int64)
    tags = rng.randint(0, 13, (n, t)).astype(np.int64)
    probs = rng.uniform(0.01, 0.99, (r, 1)).astype(np.float32)
    npy = os.path.join(tmp, "op_library_tensor.npy")
    np.save(npy, table[:4096])
    mean_iou_n = OP_LIB_IDS * 16
    cases = [
        ("reduce_max", {"X": [x]}, {"dim": [1]}, ["X"], ()),
        ("reduce_min", {"X": [x]}, {"dim": [0]}, ["X"], ()),
        ("reduce_prod", {"X": [rng.uniform(0.99, 1.01, (r, c)).astype(
            np.float32)]}, {"dim": [1]}, ["X"], ()),
        ("reduce_all", {"X": [x > -3]}, {"dim": [1]}, [], ("Out",)),
        ("reduce_any", {"X": [x > 3]}, {"reduce_all": True}, [], ("Out",)),
        ("logsumexp", {"X": [x]}, {"dim": [1]}, ["X"], ()),
        ("isfinite", {"X": [nonfinite]}, {}, [], ("Out",)),
        ("isnan", {"X": [nonfinite]}, {}, [], ("Out",)),
        ("isinf", {"X": [nonfinite]}, {}, [], ("Out",)),
        ("maximum", {"X": [x], "Y": [y]}, {}, ["X", "Y"], ("Out",)),
        ("minimum", {"X": [x], "Y": [y]}, {}, ["X", "Y"], ("Out",)),
        ("dot", {"X": [x], "Y": [y]}, {}, ["X", "Y"], ()),
        ("arg_min", {"X": [x]}, {"axis": 1}, [], ("Out",)),
        ("argsort", {"X": [x]}, {"axis": 1, "descending": True}, ["X"],
         ("Out", "Indices")),
        ("coalesce_tensor", {"Input": [x, y[:7]]}, {}, ["Input"],
         ("Output", "FusedOutput")),
        ("diag", {"Diagonal": [x[0]]}, {}, ["Diagonal"], ("Out",)),
        ("expand_as", {"X": [x[:1]], "target_tensor": [x]}, {}, ["X"],
         ("Out",)),
        ("eye", {}, {"num_rows": r, "num_columns": c}, [], ("Out",)),
        ("flatten2", {"X": [x.reshape(64, 64, c)]}, {"axis": 2}, ["X"],
         ("Out",)),
        ("flatten_contiguous_range", {"X": [x.reshape(64, 64, c)]},
         {"start_axis": 0, "stop_axis": 1}, ["X"], ("Out",)),
        ("gather_nd", {"X": [table], "Index": [ids.reshape(-1, 1)]}, {},
         ["X"], ("Out",)),
        ("index_select", {"X": [table], "Index": [ids]}, {"dim": 0}, ["X"],
         ("Out",)),
        ("linspace", {"Start": [np.array([-3.0], np.float32)],
                      "Stop": [np.array([5.0], np.float32)],
                      "Num": [np.array([r * 4], np.int32)]}, {}, [], ()),
        ("load_tensor", {}, {"file_path": npy}, [], ("Out",)),
        ("meshgrid", {"X": [x[0], x[:, 0]]}, {}, ["X"], ("Out",)),
        ("range", {"Start": [np.array([0], np.int64)],
                   "End": [np.array([r * c], np.int64)],
                   "Step": [np.array([3], np.int64)]}, {}, [], ("Out",)),
        ("roll", {"X": [x]}, {"shifts": [5, -3], "axis": [0, 1]}, ["X"],
         ("Out",)),
        ("scatter", {"X": [table], "Ids": [ids],
                     "Updates": [f(OP_LIB_IDS, width)]},
         {"overwrite": True}, ["X", "Updates"], ("Out",)),
        ("scatter", {"X": [table], "Ids": [ids],
                     "Updates": [f(OP_LIB_IDS, width)]},
         {"overwrite": False}, ["X", "Updates"], ()),
        ("scatter_nd_add", {"X": [table], "Index": [ids.reshape(-1, 1)],
                            "Updates": [f(OP_LIB_IDS, width)]}, {},
         ["X", "Updates"], ()),
        ("shape", {"Input": [x]}, {}, [], ("Out",)),
        ("strided_slice", {"Input": [x]}, {"axes": [0, 1],
                                           "starts": [-1, 3],
                                           "ends": [0, c],
                                           "strides": [-3, 2]}, ["Input"],
         ("Out",)),
        ("take_along_axis", {"Input": [table],
                             "Index": [np.stack([ids] * width, 1)]},
         {"Axis": 0}, ["Input"], ("Result",)),
        ("tile", {"X": [x[:64]]}, {"repeat_times": [64, 1]}, ["X"],
         ("Out",)),
        ("tril_triu", {"X": [x]}, {"lower": False, "diagonal": 2}, ["X"],
         ("Out",)),
        ("unstack", {"X": [x.reshape(4, r // 4, c)]}, {"axis": 0}, ["X"],
         ("Y",)),
        ("where_index", {"Condition": [x > 2.5]}, {}, [], ("Out",)),
        ("bpr_loss", {"X": [x], "Label": [labels]}, {}, ["X"], ()),
        ("huber_loss", {"X": [x], "Y": [y]}, {"delta": 0.7}, ["X"], ()),
        ("instance_norm", {"X": [x.reshape(64, 16, 64, 64)],
                           "Scale": [f(16)], "Bias": [f(16)]},
         {"epsilon": 1e-5}, ["X", "Scale", "Bias"], ()),
        ("kldiv_loss", {"X": [x], "Target": [pos]}, {"reduction": "mean"},
         ["X"], ()),
        ("l2_normalize", {"X": [x]}, {"axis": 1, "epsilon": 1e-10}, ["X"],
         ()),
        ("log_loss", {"Predicted": [probs], "Labels": [(probs > 0.5).astype(
            np.float32)]}, {"epsilon": 1e-4}, ["Predicted"], ()),
        ("lookup_table_v2", {"W": [table], "Ids": [ids.reshape(-1, 1)]},
         {"padding_idx": 7}, ["W"], ("Out",)),
        ("margin_rank_loss", {"X1": [x[:, :1]], "X2": [y[:, :1]],
                              "Label": [np.sign(x[:, 1:2])]},
         {"margin": 0.1}, ["X1", "X2"], ("Activated",)),
        ("mse_loss", {"Input": [x], "Label": [y]}, {}, ["Input"], ()),
        ("pad", {"X": [x]}, {"paddings": [1, 2, 3, 0], "pad_value": 0.5},
         ["X"], ("Out",)),
        ("pad2d", {"X": [x.reshape(64, 16, 64, 64)]},
         {"paddings": [2, 1, 0, 3], "mode": "reflect"}, ["X"], ("Out",)),
        ("smooth_l1_loss", {"X": [x], "Y": [y]}, {"sigma": 2.0}, ["X"], ()),
        ("square_error_cost", {"X": [x], "Y": [y]}, {}, ["X", "Y"], ()),
        ("cos_sim", {"X": [x], "Y": [y]}, {}, ["X", "Y"], ()),
        ("crop", {"X": [x]}, {"shape": [r // 2, c // 2],
                              "offsets": [7, 11]}, ["X"], ("Out",)),
        ("multiplex", {"X": [x, y, pos, -x],
                       "Ids": [rng.randint(-5, 6, (r, 1))]}, {}, ["X"],
         ("Out",)),
        ("unique", {"X": [ids]}, {}, [], ("Out", "Index", "Count")),
        ("unique_with_counts", {"X": [ids]}, {}, [],
         ("Out", "Index", "Counts", "Count")),
        ("mean_iou", {"Predictions": [rng.randint(0, 33, mean_iou_n)],
                      "Labels": [rng.randint(0, 32, mean_iou_n)]},
         {"num_classes": 32}, [], ("OutWrong", "OutCorrect")),
        ("chunk_eval", {"Inference": [tags], "Label": [np.where(
            rng.rand(n, t) < 0.2, 12, tags)], "SeqLength": [lens]},
         {"chunk_scheme": "IOB", "num_chunk_types": 6}, [],
         ("NumInferChunks", "NumLabelChunks", "NumCorrectChunks")),
        ("data_norm", {"X": [x], "BatchSize": [np.full(c, 1e4, np.float32)],
                       "BatchSum": [f(c)], "BatchSquareSum": [
                           np.full(c, 1e4, np.float32)]}, {}, ["X"], ()),
        ("center_loss", {"X": [x], "Label": [labels % 1000],
                         "Centers": [f(1000, c)],
                         "CenterUpdateRate": [np.array([0.5], np.float32)]},
         {"update_center": True}, ["X"], ()),
        ("edit_distance", {"Hyps": [tokens[:, :128] % 8],
                           "Refs": [tokens[:, 128:256] % 8],
                           "HypsLength": [np.minimum(lens, 128)],
                           "RefsLength": [lens % 129]},
         {"normalized": False}, [], ("Out", "SequenceNum")),
        ("hierarchical_sigmoid", {"X": [x], "Label": [labels % 1000],
                                  "W": [f(999, c)], "Bias": [f(999, 1)]},
         {"num_classes": 1000}, ["X", "W", "Bias"], ()),
        ("sampled_softmax_with_cross_entropy", {
            "Logits": [x], "Label": [labels],
            "Neg": [rng.randint(0, c, 64).astype(np.int64)]}, {},
         ["Logits"], ()),
        ("teacher_student_sigmoid_loss", {"X": [x[:, :1]],
                                          "Label": [y[:, :1] * 2]}, {},
         ["X"], ()),
        ("sequence_erase", {"X": [tokens], "Length": [lens]},
         {"tokens": [3, 4, 5]}, [], ("Out", "OutLength")),
        ("sequence_enumerate", {"X": [tokens], "Length": [lens]},
         {"win_size": 3}, [], ("Out",)),
        ("sequence_slice", {"X": [seq], "Offset": [lens // 3],
                            "SliceLength": [lens // 2], "Length": [lens]},
         {}, ["X"], ("Out", "OutLength")),
        ("sequence_expand_as", {"X": [seq[:, 0]], "Y": [seq],
                                "Length": [lens]}, {}, ["X"], ("Out",)),
        ("sequence_pad_dense", {"X": [seq], "Length": [lens]},
         {"pad_value": -1.0, "padded_length": t + 16}, ["X"],
         ("Out", "Length")),
        ("sequence_expand", {"X": [seq[:, 0]],
                             "RepeatCounts": [lens % 9]},
         {"out_len": n * 8}, ["X"], ("Out", "OutLength")),
        ("sequence_scatter", {"X": [seq[:, :, 0]],
                              "Ids": [rng.randint(-t - 2, t + 2, (n, d))],
                              "Updates": [seq[:, :d, 1]],
                              "Length": [np.minimum(lens, d)]}, {},
         ["X", "Updates"], ()),
    ]
    return cases


def _fixed_draws(op):
    """The kernel of a random op type given its draws as an input, so the
    card and the CPU compute the same function (their generators' streams
    differ): sampled softmax's loss of the classes ``Neg``."""
    if op != "sampled_softmax_with_cross_entropy":
        return None
    from paddle_tpu_torch.ops import loss_extra_ops

    def fn(ctx, ins, attrs):
        return {"Loss": loss_extra_ops.sampled_softmax_ce(
            ins["Logits"][0], ins["Label"][0].reshape(-1), ins["Neg"][0])}
    return fn


def _host_call(torch, fn, ctx, ins, attrs, diff, cot_seed):
    """One kernel call on ``ctx``'s device: its outputs and the gradients
    of sum <out, cot> (fixed random cotangents over every float output)
    to the inputs of the ``diff`` slots, all as CPU tensors."""
    tins = {k: [torch.as_tensor(v).to(ctx.device) for v in vs]
            for k, vs in ins.items()}
    leaves = []
    for slot in diff:
        tins[slot] = [v.clone().requires_grad_() for v in tins[slot]]
        leaves.extend(tins[slot])
    with torch.enable_grad():
        outs = fn(ctx, tins, attrs)
    flat = {k: (list(v) if isinstance(v, (list, tuple)) else [v])
            for k, v in outs.items()}
    grads = []
    if leaves:
        vals = [o for vs in flat.values() for o in vs if o.requires_grad]
        g = torch.Generator().manual_seed(cot_seed)
        cots = [torch.randn(o.shape, generator=g).to(o.device, o.dtype)
                for o in vals]
        grads = torch.autograd.grad(vals, leaves, cots, allow_unused=True)
        grads = [torch.zeros_like(l) if gr is None else gr
                 for l, gr in zip(leaves, grads)]
    return ({k: [o.detach().cpu() for o in vs] for k, vs in flat.items()},
            [gr.detach().cpu() for gr in grads])


def _same_values(torch, a, b):
    """Equal values, a NaN equal to a NaN."""
    if a.is_floating_point():
        return bool(torch.equal(torch.isnan(a), torch.isnan(b)) and
                    torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))
    return bool(torch.equal(a, b))


def _close_to(torch, got, want, exact):
    """(max abs error, whether ``got`` is within OP_LIB_TOL of ``want``
    (atol times want's largest magnitude, at least 1; exactly where
    ``exact``), NaN in the same places)."""
    if got.shape != want.shape:
        return float("inf"), False
    if exact or not want.is_floating_point():
        same = _same_values(torch, got, want)
        return (0.0 if same else float("inf")), same
    gf, wf = got.double(), want.double()
    nan_same = torch.equal(torch.isnan(gf), torch.isnan(wf))
    fin = torch.isfinite(wf)
    inf_same = torch.equal(gf[~fin & ~torch.isnan(wf)],
                           wf[~fin & ~torch.isnan(wf)])
    gf, wf = gf[fin], wf[fin]
    if wf.numel() == 0:
        return 0.0, nan_same and inf_same
    err = (gf - wf).abs()
    scale = max(1.0, float(wf.abs().max()))
    tol = OP_LIB_TOL["atol"] * scale + OP_LIB_TOL["rtol"] * wf.abs()
    return float(err.max()), bool(nan_same and inf_same and
                                  (err <= tol).all())


def _random_op_stats(torch, np, ptt):
    """The four random op types on the card by their statistics (within
    5 standard errors), a seed repeating a draw, and, in a program run by
    an Executor and graphed, each replay drawing anew while a second
    Executor on a fresh scope draws what the first drew, run for run."""
    from paddle_tpu_torch.ops.registry import get_op
    out, ok = {}, True
    ctx = _OpCtx(torch, "cuda", SEED)
    n = OP_LIB_ELEM[0] * OP_LIB_ELEM[1]
    a = get_op("randint").fn(ctx, {}, {"shape": [n], "low": -3,
                                       "high": 7})["Out"]
    counts = torch.bincount((a + 3).cpu(), minlength=10).numpy()
    se = np.sqrt(n * 0.1 * 0.9)
    good = bool(np.all(np.abs(counts - n * 0.1) <= 5 * se)) and \
        torch.equal(a, get_op("randint").fn(ctx, {}, {
            "shape": [n], "low": -3, "high": 7})["Out"])
    out["randint"] = {"n": n, "counts": counts.tolist(), "ok": good}
    ok = ok and good
    perm = get_op("randperm").fn(ctx, {}, {"n": OP_LIB_ROWS})["Out"]
    good = torch.equal(torch.sort(perm).values,
                       torch.arange(OP_LIB_ROWS, device=perm.device))
    firsts = perm.cpu().numpy()[:1000]
    good = bool(good and abs(firsts.mean() - OP_LIB_ROWS / 2) <
                5 * OP_LIB_ROWS / np.sqrt(12 * 1000))
    out["randperm"] = {"n": OP_LIB_ROWS, "ok": good,
                       "first_mean": float(firsts.mean())}
    ok = ok and good
    p = torch.rand(OP_LIB_ELEM, device="cuda")
    b = get_op("bernoulli").fn(ctx, {"X": [p]}, {})["Out"]
    dev = float((b - p).sum()) / math.sqrt(float((p * (1 - p)).sum()))
    out["bernoulli"] = {"z": dev, "ok": abs(dev) < 5}
    ok = ok and abs(dev) < 5
    row = torch.tensor([2.0, 0.0, 1.0, 5.0], device="cuda")
    k = 1 << 20
    s = get_op("sampling_id").fn(ctx, {"X": [row.expand(k, 4)]}, {})["Out"]
    counts = torch.bincount(s.cpu(), minlength=4).numpy()
    q = (row / row.sum()).cpu().numpy()
    good = bool(counts[1] == 0 and np.all(
        np.abs(counts - k * q) <= 5 * np.sqrt(k * q * (1 - q)) + 1e-9))
    out["sampling_id"] = {"counts": counts.tolist(), "ok": good}
    ok = ok and good
    # graphed: a replay draws anew; a fresh Executor repeats the stream
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start):
        L = ptt.layers
        x = L.data("p", [256, 8], append_batch_size=False)
        helper = ptt.layer_helper.LayerHelper("random_ops")
        fetch = []
        for op, ins, attrs in (("randint", {}, {"shape": [256], "low": 0,
                                                "high": 1000}),
                               ("randperm", {}, {"n": 256}),
                               ("bernoulli", {"X": [x.name]}, {}),
                               ("sampling_id", {"X": [x.name]}, {})):
            v = helper.create_variable_for_type_inference(
                "float32" if op == "bernoulli" else "int64")
            helper.append_op(op, inputs=ins, outputs={"Out": [v.name]},
                             attrs=attrs)
            fetch.append(v)
    main.random_seed = SEED
    feed = {"p": np.full((256, 8), 0.5, np.float32)}
    draws = []
    for _ in range(2):
        exe, scope = ptt.Executor(), ptt.Scope()
        draws.append([exe.run(main, feed=feed, fetch_list=fetch,
                              scope=scope) for _ in range(3)])
        replays = exe.graph_runs["replay"] + exe.graph_runs["capture"]
        exe.close()
    anew = all(not np.array_equal(draws[0][1][i], draws[0][2][i])
               for i in range(4))
    repeat = all(np.array_equal(a, b) for ra, rb in zip(*draws)
                 for a, b in zip(ra, rb))
    out["graphed"] = {"runs_graphed": replays, "replays_draw_anew": anew,
                      "fresh_executor_repeats": repeat}
    return out, ok and anew and repeat and replays >= 2


def _refusing_programs(np, ptt, tmp):
    """Programs holding where_index, range, py_func and load_tensor run
    op by op on the card (each refusal in Executor.refusals names the op)
    and answer as the CPU does."""
    L = ptt.layers
    npy = os.path.join(tmp, "op_library_load.npy")
    np.save(npy, np.arange(12, dtype=np.float32).reshape(3, 4))
    builds = {}

    def where_index():
        x = L.data("x", [64, 32], append_batch_size=False)
        helper = ptt.layer_helper.LayerHelper("where_index")
        out = helper.create_variable_for_type_inference("int64")
        helper.append_op("where_index",
                         inputs={"Condition": [L.greater_than(
                             x, L.fill_constant([64, 32], "float32",
                                                1.0)).name]},
                         outputs={"Out": [out.name]})
        return [out]

    def range_():
        return [L.range(0, 40, 3, "int64"),
                L.scale(L.cast(L.range(0.5, 4.0, 0.5, "float32"),
                               "float32"), 2.0)]

    def py_func():
        x = L.data("x", [64, 32], append_batch_size=False)
        out = ptt.default_main_program().global_block().create_var(
            name="py_out", dtype="float32", shape=(64, 32))
        L.py_func(lambda a: np.tanh(a), x, out)
        return [L.scale(out, 3.0)]

    def load():
        out = ptt.default_main_program().global_block().create_var(
            name="loaded", dtype="float32", shape=(3, 4))
        L.load(out, npy)
        return [L.scale(out, 0.5)]

    feed = {"x": np.random.RandomState(3).randn(64, 32).astype(np.float32)}
    records, ok = {}, True
    for name, build in (("where_index", where_index), ("range", range_),
                        ("py_func", py_func), ("load_tensor", load)):
        main, start = ptt.Program(), ptt.Program()
        with ptt.unique_name.guard(), ptt.program_guard(main, start):
            fetch = build()
        feeds = feed if "x" in main.global_block().vars else {}
        answers = {}
        for label, place in (("gpu", ptt.CUDAPlace(0)),
                             ("cpu", ptt.CPUPlace())):
            exe, scope = ptt.Executor(place), ptt.Scope()
            exe.run(start, scope=scope)
            answers[label] = [exe.run(main, feed=feeds, fetch_list=fetch,
                                      scope=scope) for _ in range(3)]
            if label == "gpu":
                refusals = list(exe.refusals.values())
                runs = dict(exe.graph_runs)
            exe.close()
        same = all(np.allclose(a, b, rtol=1e-5, atol=1e-6)
                   for ra, rb in zip(answers["gpu"], answers["cpu"])
                   for a, b in zip(ra, rb))
        good = same and len(refusals) == 1 and name in refusals[0] and \
            runs["refused"] == 3 and runs["replay"] == 0
        records[name] = {"refusals": refusals, "graph_runs": runs,
                         "answers_equal_cpu": same, "ok": good}
        ok = ok and good
    return records, ok


def op_library(torch, np, ptt, counters):
    """Each of the op library's 74 op types on the card against the CPU's
    plain path at a working size (_op_cases): outputs and the gradients
    of every differentiable input within OP_LIB_TOL, what only moves or
    chooses data exactly; every deterministic op run twice on the card
    gives the same bits (the gathers' gradients and the scatters' adds
    sum in a fixed order, ops/tensor_ops.py); the random op types by
    their statistics (_random_op_stats); the host-reading ones refused
    capture (_refusing_programs). No op of the library reaches a
    hand-written kernel (the JAX package's reach no Pallas call): the
    launch counters stay at 0 over the phase."""
    from paddle_tpu_torch.ops.registry import get_op
    counters.zero()
    tmp = os.path.join(_ROOT, "build", "chip_smoke_op_library")
    os.makedirs(tmp, exist_ok=True)
    try:
        results, ok, seen = {}, True, set()
        cpu, card = _OpCtx(torch, "cpu", SEED), _OpCtx(torch, "cuda", SEED)
        for i, (op, ins, attrs, diff, exact) in enumerate(_op_cases(np,
                                                                    tmp)):
            fn = _fixed_draws(op) or get_op(op).fn
            t0 = time.perf_counter()
            want, wgrads = _host_call(torch, fn, cpu, ins, attrs, diff, i)
            got, grads = _host_call(torch, fn, card, ins, attrs, diff, i)
            again, grads2 = _host_call(torch, fn, card, ins, attrs, diff, i)
            errs, good = {}, True
            for slot, ws in want.items():
                for j, (w, g, g2) in enumerate(zip(ws, got[slot],
                                                   again[slot])):
                    e, close = _close_to(torch, g, w, slot in exact)
                    errs["%s[%d]" % (slot, j)] = e
                    good = good and close and _same_values(torch, g, g2)
            for j, (w, g, g2) in enumerate(zip(wgrads, grads, grads2)):
                e, close = _close_to(torch, g, w, False)
                errs["grad%d" % j] = e
                good = good and close and _same_values(torch, g, g2)
            key = op if op not in seen else op + "_" + str(i)
            seen.add(op)
            results[key] = {"ok": good, "max_abs_err": errs,
                            "inputs": {k: [list(np.shape(v)) for v in vs]
                                       for k, vs in ins.items()},
                            "grads": len(wgrads),
                            "seconds": time.perf_counter() - t0}
            ok = ok and good
        results["random"], good = _random_op_stats(torch, np, ptt)
        ok = ok and good
        results["refused_capture"], good = _refusing_programs(np, ptt, tmp)
        ok = ok and good
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    covered = seen | {"randint", "randperm", "bernoulli", "sampling_id",
                      "py_func"}
    launches = counters.read_all()
    ok = ok and len(covered) == OP_LIB_TYPES and not any(launches.values())
    from paddle_tpu_torch.ops import registry
    emit({"phase": "op_library", "ok": ok, "op_types": len(covered),
          "registry": len(registry._REGISTRY), "tol": OP_LIB_TOL,
          "launches": launches, "ops": results})
    if not ok:
        raise AssertionError("op_library checks failed (see the line "
                             "above)")


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
                     ("finite_kernel(", "finite_flags"),
                     ("finite_kernelepkx", "finite_flags"),
                     ("::copy_kernel(long long", "guarded_copy"),
                     ("11copy_kernelepkx", "guarded_copy"),
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
    # the numeric guard: XLA code in the JAX package (its per-var finite
    # mask and its skip revert), no Pallas site
    ("finite_flags", "numeric_guard.cu",
     "paddle_tpu/framework/executor.py:707"),
    ("guarded_copy", "numeric_guard.cu",
     "paddle_tpu/framework/executor.py:101"),
)


def _graph_ops(text):
    """The custom ops and the plain attention ops an exported graph's
    text names."""
    return {"flash_attention_fwd": text.count(
        "target=torch.ops.paddle_tpu_torch.flash_attention_fwd.default"),
        "layer_norm_fwd": text.count(
            "target=torch.ops.paddle_tpu_torch.layer_norm_fwd.default"),
        "plain_attention": sorted({op for op in (
            "aten._softmax", "aten.softmax", "aten._safe_softmax",
            "aten.logsumexp", "aten.special_logsumexp") if op in text})}


def _wait_until(cond, what, timeout_s=ARTIFACT_WAIT_S, poll=None):
    end = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > end:
            raise AssertionError("timed out waiting for %s" % what)
        if poll is not None:
            poll()
        else:
            time.sleep(0.005)


def _eager_bucket(torch, np, pred, b, feed):
    """The exported program of bucket ``b`` run eagerly (no graph) on
    ``feed`` (already at the bucket's batch), on the bucket's stream."""
    fn = pred._fns[b]
    args = [torch.from_numpy(np.asarray(feed[n], dtype=dt)).cuda()
            for n, (_, dt) in zip(pred.get_input_names(), fn.specs)]
    with torch.no_grad(), torch.cuda.stream(fn.stream):
        outs = [o.cpu().numpy() for o in fn.module(*fn.weights, *args)]
    return outs


def _artifact_launches():
    """One request's launches of the served artifact: a flash forward a
    layer, a LayerNorm forward for the embeddings and two a layer."""
    return {"flash_attention_fwd": ARTIFACT_LAYERS,
            "layer_norm_fwd": 1 + 2 * ARTIFACT_LAYERS}


def serving_artifact(torch, np, ptt, counters, art_dir):
    """BERT-base (serve's model, T=512, f32) at ARTIFACT_LAYERS layers
    exported by ``save_inference_model(format="stablehlo")`` (plain at
    ARTIFACT_BUCKETS, q8 at ARTIFACT_Q8_BUCKETS) and served by
    ``load_serving_artifact``: export seconds and bytes, each graph's
    custom ops; warmup (each bucket's first call: _artifact_launches,
    then the capture) and health; the serve
    phase's requests, answers against the in-process Predictor on the
    card and the CPU's (SERVE_ATOL), replays bit-equal to the exported
    program run eagerly; latency beside the in-process Predictor's;
    deadline, shedding, degraded mode with the orphaned worker's capture,
    health's counters; q8 against plain (Q8_SERVE_ATOL) and the codec's
    oracle; a corrupted shipped program refused at load."""
    from paddle_tpu_torch import layers, serving
    from paddle_tpu_torch.framework import resilience
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.models import bert

    cfg = bert.bert_base(num_layers=ARTIFACT_LAYERS)
    want = _artifact_launches()
    plain_dir = os.path.join(art_dir, "plain")
    q8_dir = os.path.join(art_dir, "q8")
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
        export_s = {}
        for d, kw in ((plain_dir, dict(batch_sizes=ARTIFACT_BUCKETS)),
                      (q8_dir, dict(batch_sizes=ARTIFACT_Q8_BUCKETS,
                                    weight_compress="q8"))):
            t1 = time.perf_counter()
            ptt.save_inference_model(d, [f.name for f in feeds],
                                     [seq_out, pooled], exe,
                                     main_program=main, format="stablehlo",
                                     **kw)
            export_s[os.path.basename(d)] = time.perf_counter() - t1
        exe.close()
    setup_s = time.perf_counter() - t0
    artifacts, graphs_ok = {}, True
    for label, d in (("plain", plain_dir), ("q8", q8_dir)):
        sdir = os.path.join(d, "serving")
        with open(os.path.join(sdir, "meta.json")) as f:
            meta = json.load(f)
        graphs = {}
        for b in meta["buckets"]:
            with open(os.path.join(sdir, "module_b%s.txt" % b)) as f:
                graphs[b] = _graph_ops(f.read())
            graphs_ok = graphs_ok and graphs[b] == dict(
                want, plain_attention=[])
        artifacts[label] = {
            "save_s": export_s[label],
            "export_s_per_bucket": meta["export_seconds"],
            "pt2_bytes": {b: os.path.getsize(os.path.join(
                sdir, "export_b%s.pt2" % b)) for b in meta["buckets"]},
            "weights_file": meta["weight_file"],
            "weights_bytes": os.path.getsize(os.path.join(
                sdir, meta["weight_file"])),
            "format_version": meta["format_version"],
            "device": meta["device"], "runtime": meta["runtime"],
            "graph_ops": graphs}
    shrink = artifacts["plain"]["weights_bytes"] / \
        artifacts["q8"]["weights_bytes"]

    # serve: load, warm up (the first call of each bucket), the requests
    t1 = time.perf_counter()
    pred = serving.load_serving_artifact(plain_dir,
                                         max_in_flight=ARTIFACT_IN_FLIGHT)
    load_s = time.perf_counter() - t1
    health_cold = pred.health()
    counters.zero()                          # the main path starts here
    first = {}
    for b in ARTIFACT_BUCKETS:
        before = counters.read()
        t1 = time.perf_counter()
        pred.warmup([b])
        ms = (time.perf_counter() - t1) * 1e3
        after = counters.read()
        first[b] = {"ms": ms, "capture_ms": pred._fns[b].capture_ms,
                    "launches": {k: after[k] - before[k] for k in after
                                 if after[k] != before[k]}}
    health_warm = pred.health()
    rng = np.random.RandomState(SEED)
    requests = [bert_feeds(np, rng, n, cfg.vocab_size)
                for n in REQUEST_BATCHES]
    lat, per_request, answers = [], [], []
    for feed in requests:
        before = counters.read()
        t1 = time.perf_counter()
        answers.append(pred.run(feed))
        lat.append((time.perf_counter() - t1) * 1e3)
        after = counters.read()
        per_request.append({k: after[k] - before[k] for k in after
                            if after[k] != before[k]})
    launches = counters.read()
    counts_ok = all(f["launches"] == want for f in first.values()) and \
        all(c == want for c in per_request)
    shapes_ok = all(
        o[0].shape == (len(f["src_ids"]), SEQ_LEN, cfg.hidden_size) and
        o[1].shape == (len(f["src_ids"]), cfg.hidden_size) and
        all(np.isfinite(a).all() for a in o)
        for f, o in zip(requests, answers))
    # replays bit-equal to the exported program run eagerly
    replay_equal = {}
    for b in ARTIFACT_BUCKETS:
        i = REQUEST_BATCHES.index(b)
        eager = _eager_bucket(torch, np, pred, b, requests[i])
        replay_equal[b] = all(np.array_equal(e, a)
                              for e, a in zip(eager, answers[i]))
    # the in-process Predictor on the same directory, on the card and the
    # CPU; its latency beside the artifact's, in turns
    config = Config(plain_dir)
    config.batch_buckets = BUCKETS
    inproc = create_predictor(config)
    inproc_errs = []
    for feed, got in zip(requests, answers):
        for g, w in zip(got, inproc.run(feed)):
            inproc_errs.append(float(np.abs(g - w).max()))
    cpu_config = Config(plain_dir)
    cpu_config.place = ptt.CPUPlace()
    cpu_outs = create_predictor(cpu_config).run(requests[0])
    cpu_errs = [float(np.abs(g - c).max())
                for g, c in zip(answers[0], cpu_outs)]
    request_ms = {}
    for b in ARTIFACT_BUCKETS:
        feed = requests[REQUEST_BATCHES.index(b)]
        inproc.run(feed)
        ms = {"artifact": [], "predictor": []}
        for _ in range(GRAPH_SERVE_REPS):
            for way, fn in (("artifact", pred.run), ("predictor",
                                                      inproc.run)):
                t1 = time.perf_counter()
                fn(feed)
                ms[way].append((time.perf_counter() - t1) * 1e3)
        request_ms[b] = {w: statistics.median(v) for w, v in ms.items()}
    close_executor(torch, "serving_artifact predictor", inproc._exe)
    del inproc

    # robustness on the warm predictor: a deadline miss, shedding
    resilience.clear_events()
    slow = "serve:slow=%g" % ARTIFACT_SLOW_S
    with resilience.inject(slow + "@1"):
        try:
            pred.run(requests[0], deadline_s=ARTIFACT_DEADLINE_S)
            deadline_raised = False
        except resilience.DeadlineExceededError:
            deadline_raised = True
        _wait_until(lambda: pred.in_flight == 0, "the orphaned worker")
    box = []
    with resilience.inject("%s@1,%s@2" % (slow, slow)):
        threads = [threading.Thread(
            target=lambda: box.append(pred.run(requests[1])))
            for _ in range(ARTIFACT_IN_FLIGHT)]
        for t in threads:
            t.start()
        _wait_until(lambda: pred.in_flight == ARTIFACT_IN_FLIGHT,
                    "two requests in flight")
        saturated = pred.health()["status"]
        try:
            pred.run(requests[1])
            shed = False
        except resilience.ServerOverloadedError:
            shed = True
        for t in threads:
            t.join(ARTIFACT_WAIT_S)
    shed_equal = len(box) == ARTIFACT_IN_FLIGHT and all(
        np.array_equal(a, b) for out in box for a, b in zip(out,
                                                            answers[1]))
    health = pred.health()
    # the requests, the timed ones, the deadline case and the shed case
    want_health = {"requests": len(REQUEST_BATCHES) + len(ARTIFACT_BUCKETS)
                   * GRAPH_SERVE_REPS + 1 + ARTIFACT_IN_FLIGHT + 1,
                   "deadline_misses": 1, "sheds": 1,
                   "degraded_serves": 0, "errors": 0, "in_flight": 0,
                   "ready": True, "status": "degraded"}
    health_ok = {k: health[k] for k in want_health} == want_health
    # degraded mode: a fresh predictor with bucket 8 warm only; the cold
    # bucket-1 request blows its deadline and is served from bucket 8
    # while its orphaned worker runs and captures bucket 1, and this
    # thread keeps serving bucket 8
    pred2 = serving.load_serving_artifact(
        plain_dir, max_in_flight=ARTIFACT_IN_FLIGHT)
    pred2.warmup([8])
    resilience.clear_events()
    served_during = []
    with resilience.inject(slow + "@1"):
        degraded = pred2.run(requests[0], deadline_s=ARTIFACT_DEADLINE_S)
        _wait_until(lambda: 1 in pred2.health()["warm_buckets"] and
                    pred2.in_flight == 0, "the orphaned bucket-1 capture",
                    poll=lambda: served_during.append(
                        pred2.run(requests[2])))
    events = [e["kind"] for e in resilience.events()]
    after = [pred2.run(requests[0]) for _ in range(2)]
    degraded_errs = [float(np.abs(g - w).max())
                     for g, w in zip(degraded, answers[0])]
    orphan_equal = all(np.array_equal(a, b) for run in after
                       for a, b in zip(run, answers[0]))
    during_equal = all(np.array_equal(a, b) for out in served_during
                       for a, b in zip(out, answers[2]))
    health2 = pred2.health()
    want_health2 = {"requests": 3 + len(served_during),
                    "deadline_misses": 1, "degraded_serves": 1,
                    "sheds": 0, "errors": 0, "ready": True}
    health2_ok = {k: health2[k] for k in want_health2} == want_health2
    del pred2

    # q8: against plain, then the codec's oracle (the q8 payload's
    # dequantized weights served by the plain artifact, in place)
    pq8 = serving.load_serving_artifact(q8_dir)
    q8_out = pq8.run(requests[0])
    q8_errs = [float(np.abs(g - w).max()) for g, w in zip(q8_out,
                                                         answers[0])]
    same_names = pq8._meta["weight_names"] == pred._meta["weight_names"]
    with torch.no_grad():
        for w, w8 in zip(pred._weights, pq8._weights):
            w.copy_(w8)
    oracle = pred.run(requests[0])
    oracle_equal = same_names and all(
        np.array_equal(a, b) for a, b in zip(q8_out, oracle))
    del pq8

    # a corrupted shipped program is refused at load (the file is put
    # back after: fluid_surface vets the artifact next)
    model_path = os.path.join(plain_dir, "__model__.json")
    with open(model_path) as f:
        shipped = f.read()
    model = json.loads(shipped)
    ops = model["program"]["blocks"][0]["ops"]
    ops[0]["inputs"] = {k: ["gone_var"] for k in ops[0]["inputs"]}
    with open(model_path, "w") as f:
        json.dump(model, f)
    try:
        serving.load_serving_artifact(plain_dir)
        corrupt_refused = False
    except ValueError as e:
        corrupt_refused = "program verification" in str(e)
    with open(model_path, "w") as f:
        f.write(shipped)

    ok = (graphs_ok and counts_ok and shapes_ok and
          all(replay_equal.values()) and
          max(inproc_errs) <= SERVE_ATOL and max(cpu_errs) <= SERVE_ATOL and
          health_cold["status"] == "cold" and health_warm["ready"] and
          health_warm["status"] == "ok" and deadline_raised and
          saturated == "saturated" and shed and shed_equal and health_ok and
          "degraded" in events and max(degraded_errs) <= SERVE_ATOL and
          orphan_equal and during_equal and health2_ok and
          max(q8_errs) <= Q8_SERVE_ATOL and oracle_equal and
          corrupt_refused and
          all(launches[k] == 0 for k in launches if k not in want))
    emit({"phase": "serving_artifact", "ok": ok, "model": "bert_base",
          "hidden": cfg.hidden_size, "layers": cfg.num_layers,
          "heads": cfg.num_heads, "seq_len": SEQ_LEN, "dtype": "float32",
          "setup_s": setup_s, "artifacts": artifacts,
          "q8_weight_shrink": shrink, "graphs_ok": graphs_ok,
          "load_s": load_s, "health_cold": health_cold,
          "first_call": first, "health_warm": health_warm,
          "request_batches": list(REQUEST_BATCHES), "latency_ms": lat,
          "launches_per_request": per_request, "launches": launches,
          "shapes_finite_ok": shapes_ok,
          "replay_equals_eager": replay_equal,
          "vs_predictor_max_abs_err": max(inproc_errs),
          "vs_cpu_max_abs_err": cpu_errs, "atol": SERVE_ATOL,
          "request_ms_median": request_ms,
          "deadline_raised": deadline_raised,
          "saturated_status": saturated, "shed": shed,
          "shed_answers_equal": shed_equal, "health": health,
          "health_ok": health_ok, "degraded_events": events,
          "degraded_max_abs_err": degraded_errs,
          "served_during_orphan": len(served_during),
          "orphan_bucket_replays_equal": orphan_equal,
          "during_orphan_equal": during_equal, "health_degraded": health2,
          "health_degraded_ok": health2_ok,
          "q8_vs_plain_max_abs_err": q8_errs, "q8_atol": Q8_SERVE_ATOL,
          "q8_equals_codec_oracle": oracle_equal,
          "corrupt_program_refused": corrupt_refused,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    if not ok:
        raise AssertionError("serving_artifact checks failed (see the line "
                             "above)")
    # the predictor (serving the q8 oracle's weights now) serves the spans
    # phase, which reads only its spans
    return launches, pred, requests


def verifier(torch, np, ptt):
    """The verifier at the compile seam: the recipe step (BERT-base bf16,
    batch 128 x 128, AdamW, the schedule and the clip) and the GPT-base
    bf16 step with recompute (2 x 4096), one run each through
    ``CompiledProgram(BuildStrategy(verify_program="strict"))``; their
    diagnostics by pass and severity; and analysis_totals() over every
    program this run verified before, under the default mode ("warn").
    Returns the recipe's (main, started scope, feed, fetch_list)."""
    from paddle_tpu_torch.framework import analysis, resilience
    from paddle_tpu_torch.models import bert, gpt
    totals = {"%s/%s" % k: v
              for k, v in sorted(resilience.analysis_totals().items())}
    cfg = bert.bert_base(dtype="bfloat16")
    main, startup, fetch_list = _guard_program(ptt, bert, cfg,
                                               BF16_TRAIN_BATCH)
    feed = bert.synthetic_batch(cfg, BF16_TRAIN_BATCH, TRAIN_SEQ,
                                TRAIN_PREDS, seed=0)
    gcfg = _gpt_cfg(gpt, dtype="bfloat16", recompute=True)
    gmain, gstartup, gfetch = _gpt_train_program(ptt, gpt, gcfg, GPT_BATCH,
                                                 GPT_SEQ)
    gfeed = gpt.synthetic_batch(gcfg, GPT_BATCH, GPT_SEQ, seed=0)
    runs, ok, recipe = {}, True, None
    for label, prog, start, f, fetch in (
            ("recipe", main, startup, feed, fetch_list),
            ("gpt_bf16", gmain, gstartup, gfeed, gfetch)):
        scope = _started(ptt, start)
        exe = ptt.Executor()
        comp = ptt.CompiledProgram(prog, ptt.BuildStrategy(
            verify_program="strict")).with_data_parallel(
                loss_name=fetch[0].name)
        t0 = time.perf_counter()
        loss = float(np.asarray(exe.run(comp, feed=f, fetch_list=fetch[:1],
                                        scope=scope)[0]).reshape(()))
        run_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        result = analysis.verify_program(
            prog, feeds={k: np.shape(v) for k, v in f.items()},
            fetch_list=fetch[:1])
        walk_ms = (time.perf_counter() - t0) * 1e3
        counts = {}
        for d in result:
            key = "%s/%s" % (d.pass_name, d.severity)
            counts[key] = counts.get(key, 0) + 1
        runs[label] = {"ops": sum(len(b.ops) for b in prog.blocks),
                       "loss": loss, "run_s": run_s, "walk_ms": walk_ms,
                       "diagnostics": counts,
                       "errors": len(result.errors())}
        ok = ok and np.isfinite(loss) and not result.errors()
        close_executor(torch, "verifier " + label, exe)
        if label == "recipe":
            recipe = (main, _started(ptt, startup), feed, fetch_list)
    errors = sum(v for k, v in totals.items() if k.endswith("/error"))
    emit({"phase": "verifier", "ok": ok, "strict_runs": runs,
          "analysis_totals_default_mode": totals,
          "error_diagnostics_default_mode": errors})
    if not ok:
        raise AssertionError("verifier checks failed (see the line above)")
    return recipe


def spans(torch, np, ptt, pred, requests, recipe):
    """obs enabled: SPAN_STEPS graphed recipe steps (the key's first run,
    its capture, a replay) and SPAN_STEPS served requests; the exec.step
    labels (miss, miss, hit), each phase's parent, the serve.request /
    serve.call pairs, chrome_trace() as valid JSON; then the replay's ms
    with the engine off and on, SPAN_TIMED runs each in turns."""
    from paddle_tpu_torch.framework import obs
    main, start, feed, fetch_list = recipe
    scope = _copy_scope(torch, ptt, start)
    exe = ptt.Executor()
    obs.clear()
    obs.enable("chip_smoke")
    try:
        for _ in range(SPAN_STEPS):
            exe.run(main, feed=feed, fetch_list=fetch_list, scope=scope)
        for feed_ in requests[:SPAN_STEPS]:
            pred.run(feed_)
        got = obs.spans()
        trace = json.loads(json.dumps(obs.chrome_trace()))
    finally:
        obs.disable()
    steps = [s for s in got if s["name"] == "exec.step"]
    ids = {s["id"]: i for i, s in enumerate(steps)}

    def parents(name):
        return [ids.get(s["parent"]) for s in got if s["name"] == name]
    calls = [s for s in got if s["name"] == "serve.call"]
    reqs = {s["id"] for s in got if s["name"] == "serve.request"}
    labels = [s["labels"].get("cache") for s in steps]
    checks = {
        "cache_labels": labels == ["miss", "miss", "hit"],
        "compile_parents": parents("exec.compile") == [0, 1],
        "execute_parents": parents("exec.execute") == [0, 1, 2],
        "writeback_parents": parents("exec.writeback") == [0, 1, 2],
        "serve_pairs": len(reqs) == SPAN_STEPS and len(calls) ==
        SPAN_STEPS and all(c["parent"] in reqs for c in calls),
        "chrome_trace": len([e for e in trace["traceEvents"]
                             if e["ph"] == "X"]) == len(got)}
    ms = {"off": [], "on": []}
    for _ in range(SPAN_TIMED):
        for way in ("off", "on"):
            (obs.enable if way == "on" else obs.disable)()
            t0 = time.perf_counter()
            exe.run(main, feed=feed, fetch_list=fetch_list, scope=scope)
            ms[way].append((time.perf_counter() - t0) * 1e3)
    obs.disable()
    obs.clear()
    close_executor(torch, "spans", exe)
    ok = all(checks.values())
    emit({"phase": "spans", "ok": ok, "checks": checks,
          "cache_labels": labels, "spans": len(got),
          "span_names": sorted({s["name"] for s in got}),
          "replay_ms": ms,
          "replay_ms_median": {w: statistics.median(v)
                               for w, v in ms.items()}})
    if not ok:
        raise AssertionError("spans checks failed (see the line above)")


# ---- mixed precision and the training contribs ------------------------------

def _amp_program(ptt, bert, cfg, batch, amp):
    """BERT pretraining under ``decorate(Adam(1e-4), **amp)``: (main,
    startup, fetch list: [loss, mlm_loss, nsp_loss] and, with loss
    scaling, the scale and the good-steps counter, the optimizer)."""
    from paddle_tpu_torch.contrib import mixed_precision
    held = {}

    def opt_fn(loss):
        held["opt"] = mixed_precision.decorate(ptt.optimizer.Adam(1e-4),
                                               **amp)
        held["opt"].minimize(loss)
    main, startup, fetch_list = _pretrain_program(ptt, bert, cfg, batch,
                                                  opt_fn)
    opt = held["opt"]
    if opt.get_loss_scaling() is not None:
        fetch_list = fetch_list + [opt.get_loss_scaling()]
        if opt._good_steps is not None:
            fetch_list.append(opt._good_steps)
    return main, startup, fetch_list, opt


def _overflow_feed(feed):
    """``feed`` with one input-mask element at 1e36: its attention bias
    (mask * 1e4 - 1e4) is Inf, so the step's loss and gradients are not
    finite."""
    bad = dict(feed)
    bad["input_mask"] = feed["input_mask"].copy()
    bad["input_mask"][0, 0, 0] = 1e36
    return bad


def _adam_moment_betas(main):
    """{each Adam moment of ``main``'s parameters: the beta that decays it
    (moment1 0.9, moment2 0.999)}."""
    names = {v.name for v in main.list_vars() if v.persistable}
    return {"%s_%s_0" % (p.name, which): beta
            for which, beta in (("moment1", 0.9), ("moment2", 0.999))
            for p in main.all_parameters()
            if "%s_%s_0" % (p.name, which) in names}


def _amp_isfinite_ms(torch, ptt, main, start, feed, fetch_list):
    """Device ms of an op-by-op step's finiteness chain (each gradient's
    isfinite and the logical_and that joins it), and of the whole step,
    on a copy of ``start``."""
    scope, exe = _copy_scope(torch, ptt, start), ptt.Executor()
    found = _device_ms_by_op_type(torch, lambda: exe.run(
        main, feed=feed, fetch_list=fetch_list, scope=scope,
        use_program_cache=False))
    close_executor(torch, "amp isfinite profile", exe)
    chain = {k: v for k, v in found["by_op_type"].items()
             if k in ("isfinite", "logical_and")}
    return {"ops": chain, "device_ms": sum(v[1] for v in chain.values()),
            "step_device_busy_ms": found["device_busy_ms"]}


def amp_bert(torch, np, ptt, counters):
    """BERT-base (f32) at bench.py:388-389's shapes (batch 128 x 128, 20
    masked positions, dropout 0.1) trained with ``decorate(Adam(1e-4))``:
    bf16, then fp16 with dynamic loss scaling from 2^15. Each dtype runs
    GRAPH_STEPS steps op by op and graphed from one startup (``_both_ways``:
    fetches and every persistable bit for bit equal, the train step's
    launches a step, the profile naming the hand-written kernels and no
    library attention); every flash launch of the fp16 runs is of the
    kernels' fp16 instantiation, none of the bf16 runs'. fp16's runs: an
    overflow first (Adam's moments still 0: every parameter bit-equal
    after it), four clean, an overflow replayed from the graph; each
    overflow multiplies the scale by decr_ratio and zeroes good steps, and
    the replayed one decays Adam's moments by beta1 / beta2 exactly (the
    zero gradient the reference hands the optimizer); both read on the
    graphed way's own runs. Step ms beside train_bf16's and train's; the
    cast ops; peak above resident (fp16's includes the copies of the
    watched tensors, ``watched_gb``); the device ms of fp16's finiteness
    chain. Returns ({dtype: launches}, the fp16 way's handles for
    contrib_surface, the fp16 graphed way's fp16 flash launches)."""
    from paddle_tpu_torch.models import bert
    cfg = bert.bert_base()                       # f32, dropout 0.1
    feed = bert.synthetic_batch(cfg, BF16_TRAIN_BATCH, TRAIN_SEQ,
                                TRAIN_PREDS, seed=0)
    bad = _overflow_feed(feed)
    out, launches, ok, handles, f16_launches = {}, {}, True, None, None
    for label, amp, feeds in (
            ("bf16", dict(dtype="bfloat16"), [feed] * GRAPH_STEPS),
            ("fp16", dict(dtype="float16",
                          init_loss_scaling=AMP_FP16_INIT_SCALE,
                          use_dynamic_loss_scaling=True),
             [bad] + [feed] * (GRAPH_STEPS - 2) + [bad])):
        main, startup, fetch_list, opt = _amp_program(
            ptt, bert, cfg, BF16_TRAIN_BATCH, amp)
        casts = sum(op.type == "cast" and op.attrs.get("op_role") == "amp"
                    for op in main.global_block().ops)
        params = [p.name for p in main.all_parameters()]
        betas = _adam_moment_betas(main)
        seen = {}

        def watch(k):
            return params if k == 1 else list(betas) \
                if k == len(feeds) else ()

        def on_run(k, before, scope, exe):
            # run 1 leaves the parameters, the last run decays the moments
            seen[k] = {"replays": exe.graph_runs["replay"], "unequal": [
                n for n in before if not torch.equal(
                    scope.find_var(n), before[n] * betas.get(n, 1.0))],
                "gb": sum(t.numel() * t.element_size()
                          for t in before.values()) / 2 ** 30}
        hooks = dict(watch=watch, on_run=on_run) if label == "fp16" else {}
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        record, both_ok, ref, start, n = _both_ways(
            torch, np, ptt, counters, "amp_bert_" + label, main, startup,
            feeds, fetch_list, TRAIN_PER_STEP, TRAIN_FAMILIES, mask=False,
            nonfinite=[i for i, f in enumerate(feeds) if f is bad], **hooks)
        peak = torch.cuda.max_memory_allocated()
        fetched, state = ref
        losses = [float(f[0].reshape(())) for f in fetched]
        clean = [v for v, f in zip(losses, feeds) if f is feed]
        # the flash launches of each way against their fp16 share
        dtype_ok = all(
            f16[k] == (record["launches_by_way"][w][k]
                       if label == "fp16" else 0) and
            record["launches_by_way"][w][k] > 0
            for w, f16 in record["float16_launches_by_way"].items()
            for k in f16)
        row = dict(record, casts=casts, program_ops=_n_ops(_op_counts(main)),
                   clean_losses=clean, flash_dtype_ok=dtype_ok,
                   step_peak_above_resident_gb=(peak - resident) / 2 ** 30)
        finite = all(np.isfinite(clean))
        falling = clean[-1] < clean[0]
        checks = both_ok and finite and falling and dtype_ok
        if label == "fp16":
            last = len(feeds)
            scales = [float(f[3].reshape(())) for f in fetched]
            goods = [float(f[4].reshape(())) for f in fetched]
            init = np.float32(AMP_FP16_INIT_SCALE)
            decr = np.float32(AMP_DECR_RATIO)
            still = seen[1]["unequal"]
            decayed = (bool(betas) and not seen[last]["unequal"] and
                       seen[last]["replays"] > seen[last - 1]["replays"])
            scale_ok = (scales[0] == float(init * decr) and goods[0] == 0.0
                        and scales[-1] == float(np.float32(scales[-2]) *
                                                decr)
                        and goods[-1] == 0.0 and
                        goods[1:-1] == [float(i) for i in
                                        range(1, GRAPH_STEPS - 1)])
            checks = checks and scale_ok and not still and decayed
            row.update(loss_scale=scales, good_steps=goods,
                       loss_scale_ok=scale_ok,
                       overflow_first_params_changed=still[:4],
                       overflow_replayed_moments_decayed=decayed,
                       overflow_replayed_moments_unequal=seen[last][
                           "unequal"][:4],
                       watched_gb=max(v["gb"] for v in seen.values()),
                       decr_ratio=AMP_DECR_RATIO,
                       isfinite_chain=_amp_isfinite_ms(
                           torch, ptt, main, start, feed, fetch_list))
            handles = (main, start, feed, fetch_list)
            f16_launches = record["float16_launches_by_way"]["graphed"]
        row.update(finite=finite, falling=falling, ok=checks)
        ok = ok and checks
        out[label] = row
        launches[label] = n
    emit({"phase": "amp_bert", "ok": ok, "model": "bert_base",
          "dtype_params": "float32", "batch": BF16_TRAIN_BATCH,
          "seq_len": TRAIN_SEQ, "max_preds": TRAIN_PREDS,
          "dropout": cfg.hidden_dropout, "optimizer": "Adam(1e-4)",
          "fp16_init_loss_scaling": AMP_FP16_INIT_SCALE,
          "beside_ms": {k: _STEP_MS.get(k) for k in ("train_bf16", "train")},
          "beside_note": "train_bf16: bf16 weights, batch 128; train: f32, "
                         "batch 32 (replay medians of this run)",
          "dtypes": out})
    if not ok:
        raise AssertionError("amp_bert checks failed (see the line above)")
    return launches, handles, f16_launches


def amp_parity(torch, np, ptt):
    """A narrow BERT (AMP_PARITY: 2 layers, hidden 128, two 64-wide heads;
    4 x 128 tokens) decorated in bf16 and in fp16 (dynamic loss scaling
    from 2^15), three steps card against CPU from the same weights, by the
    bf16 PARITY_* comparison with each f32 master weight's elements held
    at the compute dtype's ulps (two bf16 ulps; two fp16 ulps, 8x
    tighter), graphed against op by op on the card. (At BERT-base width
    the CPU's fp16 matmuls took 58 s for the three steps.)"""
    from paddle_tpu_torch.models import bert
    cfg = bert.bert_base(hidden_dropout=0.0, attn_dropout=0.0,
                         **AMP_PARITY)
    feed = bert.synthetic_batch(cfg, PARITY_BATCH, TRAIN_SEQ, TRAIN_PREDS,
                                seed=1)
    rows, ok = {}, True
    for label, amp in (("bf16", dict(dtype="bfloat16")),
                       ("fp16", dict(dtype="float16",
                                     init_loss_scaling=AMP_FP16_INIT_SCALE,
                                     use_dynamic_loss_scaling=True))):
        main, startup, fetch_list, _ = _amp_program(ptt, bert, cfg,
                                                    PARITY_BATCH, amp)
        rows[label], good = _card_vs_cpu(np, ptt, main, startup, fetch_list,
                                         feed, dtype=amp["dtype"])
        ok = ok and good
    emit({"phase": "amp_parity", "ok": ok, "config": AMP_PARITY,
          "batch": PARITY_BATCH, "seq_len": TRAIN_SEQ, "dtypes": rows})
    if not ok:
        raise AssertionError("amp_parity checks failed (see the line above)")


def amp_resnet(torch, np, ptt, counters):
    """ResNet-50 at bench.py:472-486 (batch 128 x 3 x 224 x 224,
    Momentum(0.1, 0.9)) decorated in bf16, TRAIN_STEPS steps graphed from
    the second: losses finite and the first update lowering the loss (the
    f32 run's criterion: at lr 0.1 from scratch the loss climbs again by
    the sixth step); the step beside resnet_train's f32 replays and
    graph_resnet's; no hand-written kernel."""
    from paddle_tpu_torch.contrib import mixed_precision
    from paddle_tpu_torch.models import resnet
    main, startup, fetch_list, feed = _resnet_program(
        np, ptt, resnet, RESNET_BATCH,
        lambda opt: mixed_precision.decorate(opt, dtype="bfloat16"))
    scope, exe = ptt.Scope(), ptt.Executor()
    with ptt.scope_guard(scope):
        exe.run(startup)
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
    ok = finite and descends and counts_ok
    casts = sum(op.type == "cast" and op.attrs.get("op_role") == "amp"
                for op in main.global_block().ops)
    emit({"phase": "amp_resnet", "ok": ok, "model": "resnet50",
          "batch": RESNET_BATCH, "dtype": "bfloat16 (decorate)",
          "optimizer": "Momentum(0.1, 0.9)", "casts": casts,
          "step_ms": step_ms, "replay_ms_median": replay_ms,
          "images_per_s_replays": RESNET_BATCH / (replay_ms / 1e3),
          "f32_replay_ms": {k: _STEP_MS.get(k) for k in
                            ("resnet_train", "graph_resnet")},
          "losses": losses, "finite": finite,
          "first_update_descends": descends,
          "launches_per_step_ok": counts_ok, "launches": launches,
          "step_peak_above_resident_gb": (peak - resident) / 2 ** 30})
    close_executor(torch, "amp_resnet", exe)
    if not ok:
        raise AssertionError("amp_resnet checks failed (see the line above)")
    return launches


def grad_merge(torch, np, ptt, counters):
    """BERT-base (bf16 config, dropout 0.1) at batch 32 x 128 under
    ``GradientMergeOptimizer(Adam(1e-4), k_steps=4)``: GRAD_MERGE_STEPS runs
    (two windows) op by op and graphed from one startup (``_both_ways``),
    fetches and every persistable bit for bit equal; on the graphed way,
    the reference's rule at each run: off an apply run Adam gets a zero
    gradient (its moments times beta1 / beta2 bit for bit; the parameters
    unchanged while the moments are 0, in the first window), on an apply
    run (4, 8) the parameters move and the accumulators restart at 0."""
    from paddle_tpu_torch.contrib.extend_optimizer import (
        GradientMergeOptimizer)
    from paddle_tpu_torch.models import bert
    cfg = bert.bert_base(dtype="bfloat16")

    def opt_fn(loss):
        GradientMergeOptimizer(ptt.optimizer.Adam(1e-4),
                               k_steps=GRAD_MERGE_K).minimize(loss)
    main, startup, fetch_list = _pretrain_program(ptt, bert, cfg,
                                                  TRAIN_BATCH, opt_fn)
    feed = bert.synthetic_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, TRAIN_PREDS,
                                seed=0)
    params = [p.name for p in main.all_parameters()]
    betas = _adam_moment_betas(main)
    accs = [v.name for v in main.list_vars()
            if v.persistable and ".grad_acc" in v.name]
    rule = []

    def on_run(k, before, scope, exe):
        apply = k % GRAD_MERGE_K == 0
        moved = sum(not torch.equal(scope.find_var(p), before[p])
                    for p in params)
        if apply:
            good = all(not bool(scope.find_var(a).any()) for a in accs) \
                and moved >= len(params) // 2
        else:
            decayed = all(torch.equal(scope.find_var(n), before[n] * beta)
                          for n, beta in betas.items())
            good = bool(betas) and decayed and (k > GRAD_MERGE_K or
                                                moved == 0)
        rule.append({"run": k, "apply": apply, "parameters_moved": moved,
                     "ok": good})
    record, both_ok, (_, state), _, launches = _both_ways(
        torch, np, ptt, counters, "grad_merge", main, startup,
        [feed] * GRAD_MERGE_STEPS, fetch_list, TRAIN_PER_STEP,
        TRAIN_FAMILIES, mask=False, watch=lambda k: params + list(betas),
        on_run=on_run)
    ok = (both_ok and len(rule) == GRAD_MERGE_STEPS and
          all(r["ok"] for r in rule) and "@GRAD_MERGE_STEP@" in state)
    plain = _plain_step_ms(torch, np, ptt, cfg, TRAIN_BATCH, feed)
    emit(dict({"phase": "grad_merge", "ok": ok, "model": "bert_base",
               "dtype": "bfloat16", "batch": TRAIN_BATCH,
               "seq_len": TRAIN_SEQ, "k_steps": GRAD_MERGE_K,
               "accumulators": len(accs), "rule": rule,
               "plain_adam_replay_ms": plain}, **record))
    if not ok:
        raise AssertionError("grad_merge checks failed (see the line above)")
    return launches


def _plain_step_ms(torch, np, ptt, cfg, batch, feed, runs=5):
    """The replay ms (median of the runs from the third) of ``cfg``'s
    pretraining step under plain Adam(1e-4): a yardstick beside a
    wrapped optimizer's step."""
    from paddle_tpu_torch.models import bert
    main, startup, fetch_list = _pretrain_program(ptt, bert, cfg, batch)
    scope, exe = ptt.Scope(), ptt.Executor()
    exe.run(startup, scope=scope)
    ms = []
    for _ in range(runs):
        t0 = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=fetch_list, scope=scope)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    close_executor(torch, "plain step", exe)
    return statistics.median(ms[2:])


def _ctr_bundle_on_card(torch, np, ptt):
    """DeepFM at bench.py:565-578 with ``ctr_metric_bundle`` of its
    prediction: three graphed steps; each step's six aggregates against
    numpy's of the fetched predictions and the feed's labels (f32 sums of
    2048 terms in another order: rtol CTR_RTOL)."""
    from paddle_tpu_torch.contrib.layers import ctr_metric_bundle
    from paddle_tpu_torch.models import deepfm
    kw = dict(feature_dim=DEEPFM_FEATURES, embedding_size=DEEPFM_EMBEDDING)
    main, startup, fetch_list, feed, _ = _deepfm_program(
        np, ptt, deepfm, DEEPFM_BATCH, **kw)
    predict = fetch_list[2]
    with ptt.program_guard(main, startup):
        bundle = ctr_metric_bundle(predict,
                                   main.global_block().var("label"))
    scope, exe = ptt.Scope(), ptt.Executor()
    with ptt.scope_guard(scope):
        exe.run(startup)
        runs = [exe.run(main, feed=feed, fetch_list=[predict] + list(bundle))
                for _ in range(3)]
    close_executor(torch, "ctr_metric_bundle", exe)
    label = np.asarray(feed["label"], np.float64).reshape(-1)
    errs = []
    for out in runs:
        p = np.asarray(out[0], np.float64).reshape(-1)
        want = [((p - label) ** 2).sum(), np.abs(p - label).sum(), p.sum(),
                (p * p).sum(), label.sum(), float(len(p))]
        errs.append(max(abs(float(np.asarray(g).reshape(-1)[0]) - w) /
                        max(abs(w), 1e-12)
                        for g, w in zip(out[1:], want)))
    return {"steps": 3, "max_rel_err": max(errs), "rtol": CTR_RTOL,
            "replays": exe.graph_runs["replay"]}, max(errs) <= CTR_RTOL


def _trainer_on_card(np, ptt, root):
    """``contrib.Trainer`` training fit_a_line (uci_housing, batch 20) two
    epochs on the card, its events counted, the parameters saved;
    ``contrib.Inferencer`` serving the saved parameters: its answers
    against the trained program's own prediction of the same rows."""
    from paddle_tpu_torch.contrib import Inferencer, Trainer
    from paddle_tpu_torch.dataset import uci_housing
    L = ptt.layers

    def predict():
        x = L.data("x", [13], dtype="float32")
        return L.fc(x, 1, param_attr=ptt.ParamAttr(name="fit_w"),
                    bias_attr=ptt.ParamAttr(name="fit_b"))

    def train_func():
        y = L.data("y", [1], dtype="float32")
        return [L.mean(L.square_error_cost(predict(), y))]
    events, losses = {}, []

    def handler(e):
        events[type(e).__name__] = events.get(type(e).__name__, 0) + 1
        if type(e).__name__ == "EndStepEvent" and e.metrics:
            losses.append(float(np.asarray(e.metrics[0]).reshape(-1)[0]))
    trainer = Trainer(train_func,
                      lambda: ptt.optimizer.SGD(learning_rate=0.01))
    reader = ptt.batch(uci_housing.train(), batch_size=20, drop_last=True)
    trainer.train(2, handler, reader=reader, feed_order=["x", "y"])
    params = os.path.join(root, "fit_a_line")
    trainer.save_params(params)
    rows = np.stack([s[0] for s, _ in zip(uci_housing.test()(), range(8))])
    inf = Inferencer(predict, params)
    got = inf.infer({"x": rows.astype(np.float32)})[0]
    w = trainer.scope.find_var("fit_w").cpu().numpy()
    b = trainer.scope.find_var("fit_b").cpu().numpy()
    want = rows.astype(np.float32) @ w + b
    err = float(np.abs(np.asarray(got) - want).max())
    ok = (losses[-1] < losses[0] and np.isfinite(losses).all() and
          events.get("EndEpochEvent") == 2 and err <= 1e-4)
    return {"events": events, "first_loss": losses[0],
            "last_loss": losses[-1], "infer_max_abs_err": err,
            "infer_device": str(inf.exe.device)}, ok


def contrib_surface(torch, np, ptt, counters, amp_handles, root):
    """The contribs on the card: ``ctr_metric_bundle`` on DeepFM,
    ``profiler.profiler`` around three replays of amp_bert's fp16 step
    (its table must name the flash and LayerNorm kernels), the Book's
    ``Trainer``/``Inferencer`` on fit_a_line, and ``summary`` /
    ``memory_usage`` / ``op_freq_statistic`` of BERT-base."""
    import contextlib
    import io
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.contrib import (memory_usage, op_freq_statistic,
                                          summary)
    from paddle_tpu_torch.models import bert
    ctr, ctr_ok = _ctr_bundle_on_card(torch, np, ptt)
    prof_ok, families, launches, rows = False, [], None, []
    if amp_handles is not None:
        main, start, feed, fetch_list = amp_handles
        scope, exe = _copy_scope(torch, ptt, start), ptt.Executor()
        for _ in range(2):                   # warm run, capture
            exe.run(main, feed=feed, fetch_list=fetch_list, scope=scope)
        counters.zero()                      # the main path starts here
        with contextlib.redirect_stdout(io.StringIO()):
            with profiler.profiler("All", "total") as p:
                for _ in range(3):
                    exe.run(main, feed=feed, fetch_list=fetch_list,
                            scope=scope)
        launches = counters.read()
        close_executor(torch, "contrib_surface profiler", exe)
        rows = p.rows
        families = sorted({_family(r[0]) for r in rows})
        prof_ok = set(TRAIN_FAMILIES) <= set(families)
    fit, fit_ok = _trainer_on_card(np, ptt, root)
    cfg = bert.bert_base()
    main, _, _ = _pretrain_program(ptt, bert, cfg, TRAIN_BATCH)
    with contextlib.redirect_stdout(io.StringIO()) as text:
        _, (n_params, flops) = summary(main)
    uni, adj = op_freq_statistic(main)
    low, high = memory_usage(main, TRAIN_BATCH)
    ok = ctr_ok and prof_ok and fit_ok
    emit({"phase": "contrib_surface", "ok": ok, "ctr_metric_bundle": ctr,
          "profiler_families": families, "profiler_ok": prof_ok,
          "profiler_rows": [list(r) for r in rows[:6]],
          "trainer": fit, "summary_params": n_params,
          "summary_flops": flops,
          "summary_tail": text.getvalue().splitlines()[-2:],
          "op_freq_top": list(uni.items())[:6],
          "op_pairs_top": list(adj.items())[:4],
          "memory_usage_mb": [low, high]})
    if not ok:
        raise AssertionError("contrib_surface checks failed (see the line "
                             "above)")
    return launches


# ---------------------------------------------------------------------------
# the fluid surface and the vision and extras ops (fluid_surface,
# vision_extras)
# ---------------------------------------------------------------------------

def _clis(commands):
    """Each ``python -m <args>`` of ``commands`` ({label: args}) from the
    checkout, all at once: {label: (exit code, stdout, stderr, its own
    wall seconds)}."""
    env = dict(os.environ, PYTHONPATH=_ROOT)
    done = {}

    def run(label, args):
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m"] + args, cwd=_ROOT, env=env,
                           capture_output=True, text=True, timeout=600)
        done[label] = (p.returncode, p.stdout, p.stderr,
                       time.perf_counter() - t0)
    threads = [threading.Thread(target=run, args=item)
               for item in commands.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return done


def _broken_artifact(src, dst, how):
    """A copy of the exported model directory ``src`` with its program
    broken: one op's input renamed to a var nobody declares, or the
    ``__model__.json`` cut in half."""
    shutil.copytree(src, dst)
    path = os.path.join(dst, "__model__.json")
    with open(path) as f:
        text = f.read()
    if how == "truncate":
        text = text[:len(text) // 2]
    else:
        model = json.loads(text)
        op = model["program"]["blocks"][0]["ops"][0]
        op["inputs"][sorted(op["inputs"])[0]] = ["renamed_by_corruption"]
        text = json.dumps(model)
    with open(path, "w") as f:
        f.write(text)
    return dst


def fluid_surface(torch, np, ptt, counters, art_dir):
    """The top-level fluid surface on the card: ``install_check.run_check``
    (CUDAPlace(0) by default), ``core``'s places and ``cuda_places``
    against torch's device count; the two CLIs as subprocesses on the
    serving_artifact phase's BERT-base plain artifact (progcheck --json:
    exit 0, and 2 on a copy with an op's input renamed; serving_probe
    --warmup --strict: exit 0, every bucket warm and its own request
    served, and 2 on a copy with its program cut in half), each one's
    seconds, and whether a subprocess built the kernels again (it
    should find serving_artifact's build under build/); then the probe in
    this process, its launches counted."""
    from paddle_tpu_torch import core
    from paddle_tpu_torch.layers import device as ldevice
    from paddle_tpu_torch.ops.kernels import build
    from paddle_tpu_torch.tools import serving_probe
    import warnings

    plain_dir = os.path.join(art_dir, "plain")
    t0 = time.perf_counter()
    checked = ptt.run_check()
    check_s = time.perf_counter() - t0
    n = torch.cuda.device_count()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        get_places = ldevice.get_places()
    places = {"device_count": n, "cuda_places": repr(ptt.cuda_places()),
              "core_device_count": core.get_cuda_device_count(),
              "compiled_with_cuda": core.is_compiled_with_cuda(),
              "get_places": repr(get_places)}
    places_ok = (ptt.cuda_places() == [ptt.CUDAPlace(i) for i in range(n)]
                 and core.get_cuda_device_count() == n and n >= 1 and
                 core.is_compiled_with_cuda() and
                 core.CUDAPlace is ptt.CUDAPlace and
                 get_places == ptt.cuda_places())
    renamed = _broken_artifact(plain_dir, os.path.join(art_dir, "renamed"),
                               "rename")
    truncated = _broken_artifact(plain_dir, os.path.join(art_dir, "cut"),
                                 "truncate")
    lib = os.path.join(build.library_dir(), build.LIB_NAME)
    lib_stat = os.stat(lib).st_mtime_ns
    progcheck = "paddle_tpu_torch.tools.progcheck"
    probe = "paddle_tpu_torch.tools.serving_probe"
    want = {"progcheck": 0, "progcheck_renamed": 2, "probe": 0,
            "probe_cut": 2}
    done = _clis({"progcheck": [progcheck, plain_dir, "--json"],
                  "progcheck_renamed": [progcheck, renamed, "--json"],
                  "probe": [probe, plain_dir, "--warmup", "--strict"],
                  "probe_cut": [probe, truncated]})
    runs = {}
    for label, (rc, out, err, seconds) in sorted(done.items()):
        lines = out.strip().splitlines()
        runs[label] = {"rc": rc, "want": want[label], "seconds": seconds,
                       "json": json.loads(lines[-1]) if lines else None}
        if rc != want[label]:
            runs[label]["stderr"] = err[-3000:]
    rebuilt = os.stat(lib).st_mtime_ns != lib_stat
    for label in ("progcheck", "progcheck_renamed"):
        doc = runs[label]["json"] or {}
        runs[label]["json"] = {"exit_code": doc.get("exit_code"),
                               "counts": [p.get("counts", p.get(
                                   "load_error")) for p in
                                   doc.get("programs", [])]}
    health = runs["probe"]["json"] or {}
    buckets = list(ARTIFACT_BUCKETS)
    probe_ok = (health.get("ready") is True and
                health.get("status") == "ok" and
                health.get("buckets") == buckets and
                health.get("warm_buckets") == buckets and
                health.get("requests") == 1 and health.get("errors") == 0)
    cut = runs["probe_cut"]["json"] or {}
    # the same probe in this process, its launches counted
    counters.zero()
    t1 = time.perf_counter()
    health_in = serving_probe.probe(plain_dir, warmup=True)
    in_process_s = time.perf_counter() - t1
    launches = counters.read_all()
    launched = {k: v for k, v in launches.items() if v}
    per_request = _artifact_launches()
    launches_ok = set(launched) == set(SERVE_FAMILIES) and \
        launched["flash_attention_fwd"] * per_request["layer_norm_fwd"] == \
        launched["layer_norm_fwd"] * per_request["flash_attention_fwd"]
    ok = (checked is True and places_ok and probe_ok and not rebuilt and
          all(r["rc"] == r["want"] for r in runs.values()) and
          cut.get("status") == "broken" and health_in["ready"] and
          health_in["requests"] == 1 and launches_ok)
    emit({"phase": "fluid_surface", "ok": ok, "run_check": checked,
          "run_check_s": check_s, "places": places, "places_ok": places_ok,
          "cli": runs, "probe_health_ok": probe_ok,
          "kernels_built_again": rebuilt, "in_process_probe_s": in_process_s,
          "in_process_health": health_in, "launches": launches})
    if not ok:
        raise AssertionError("fluid_surface checks failed (see the line "
                             "above)")
    return launches


def _vx_feeds(np, rng):
    """(op type, feeds {name: numpy}, layer call (L, vars) -> outputs,
    differentiable feeds, outputs held exactly) for each of the 22 op
    types at a published model's shape."""
    def f(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def rois(r, img_h, img_w, with_index=False):
        x1 = rng.uniform(0, img_w * 0.8, r)
        y1 = rng.uniform(0, img_h * 0.8, r)
        box = np.stack([x1, y1, x1 + rng.uniform(16, img_w * 0.5, r),
                        y1 + rng.uniform(16, img_h * 0.5, r)], 1)
        if with_index:
            box = np.concatenate([np.zeros((r, 1)), box], 1)
        return box.astype(np.float32)

    n_dc = 2
    offset = f(n_dc, 18, 25, 42, scale=2.0)
    offset[:, ::3] = np.round(offset[:, ::3])       # taps on integers
    n_gs = 32
    ang = rng.uniform(-0.3, 0.3, n_gs)
    sc = rng.uniform(0.6, 1.2, n_gs)
    theta = np.stack([np.stack([sc * np.cos(ang), -sc * np.sin(ang),
                                rng.uniform(-0.2, 0.2, n_gs)], 1),
                      np.stack([sc * np.sin(ang), sc * np.cos(ang),
                                rng.uniform(-0.2, 0.2, n_gs)], 1)], 1)
    ys, xs = np.meshgrid(np.linspace(-1, 1, 224), np.linspace(-1, 1, 224),
                         indexing="ij")
    base = np.stack([xs, ys, np.ones_like(xs)], -1)
    grid = np.einsum("hwk,njk->nhwj", base, theta).astype(np.float32)
    deepfm = 2048 * 26                       # DeepFM's batch x its slots
    ids = rng.randint(0, 30522, 4096).astype(np.int64)
    ids[::4] = 101                           # a hot id ([CLS])
    probs = np.exp(f(32, 512, 96))
    img = (np.arange(256)[:, None] * 256 + np.arange(256)[None, :]).astype(
        np.float32)
    parents = rng.randint(0, 4, (32, 16, 4)).astype(np.int64)
    return [
        ("temporal_shift", {"x": f(128, 256, 56, 56)},
         lambda L, v: [L.temporal_shift(v["x"], 8, 0.125)], ["x"], (0,)),
        ("deformable_conv", {"x": f(n_dc, 512, 25, 42), "offset": offset,
                             "mask": rng.uniform(0, 1, (n_dc, 9, 25, 42))
                             .astype(np.float32)},
         lambda L, v: [L.deformable_conv(v["x"], v["offset"], v["mask"],
                                         512, 3, padding=1)],
         ["x", "offset", "mask"], ()),
        ("psroi_pool", {"x": f(1, 1029, 38, 63), "rois": rois(300, 600,
                                                               1000)},
         lambda L, v: [L.psroi_pool(v["x"], v["rois"], 21, 1 / 16.0, 7, 7)],
         ["x"], ()),
        ("deformable_roi_pooling",
         {"x": f(1, 1029, 38, 63), "rois": rois(300, 600, 1000, True),
          "trans": f(300, 2, 7, 7)},
         lambda L, v: [L.deformable_roi_pooling(
             v["x"], v["rois"], v["trans"], spatial_scale=1 / 16.0,
             pooled_height=7, pooled_width=7, trans_std=0.1,
             position_sensitive=True)], ["x", "trans"], ()),
        ("prroi_pool", {"x": f(1, 1024, 38, 63),
                        "rois": rois(300, 600, 1000)},
         lambda L, v: [L.prroi_pool(v["x"], v["rois"], 1 / 16.0, 7, 7)],
         ["x"], ()),
        ("pool3d", {"x": f(8, 128, 16, 56, 56)},
         lambda L, v: [L.pool3d(v["x"], 2, "max", 2),
                       L.pool3d(v["x"], 3, "avg", 2, 1, ceil_mode=True),
                       L.adaptive_pool3d(v["x"], [4, 7, 7], "avg")],
         ["x"], (0,)),
        ("affine_grid", {"theta": theta[:32].astype(np.float32)},
         lambda L, v: [L.affine_grid(v["theta"], [theta.shape[0], 3, 224,
                                                  224])], ["theta"], ()),
        ("grid_sampler", {"x": f(n_gs, 3, 448, 448), "grid": grid},
         lambda L, v: [L.grid_sampler(v["x"], v["grid"])], ["x", "grid"],
         ()),
        ("lrn", {"x": f(128, 96, 55, 55)},
         lambda L, v: [L.lrn(v["x"], n=5, k=2.0, alpha=1e-4, beta=0.75)],
         ["x"], ()),
        ("pixel_shuffle", {"x": f(16, 256, 48, 48)},
         lambda L, v: [L.pixel_shuffle(v["x"], 2)], ["x"], (0,)),
        ("unfold", {"x": f(32, 128, 28, 28)},
         lambda L, v: [L.unfold(v["x"], 3, paddings=1)], ["x"], (0,)),
        ("space_to_depth", {"x": f(16, 64, 26, 26)},
         lambda L, v: [L.space_to_depth(v["x"], 2)], ["x"], (0,)),
        ("shuffle_channel", {"x": f(128, 240, 28, 28)},
         lambda L, v: [L.shuffle_channel(v["x"], 3)], ["x"], (0,)),
        ("resize_trilinear", {"up": f(2, 128, 16, 32, 32),
                              "down": f(2, 64, 32, 64, 64)},
         lambda L, v: [L.resize_trilinear(v["up"], [32, 64, 64]),
                       L.resize_trilinear(v["down"], [16, 32, 32])],
         ["up", "down"], ()),
        ("scatter_nd", {"index": ids.reshape(-1, 1), "updates": f(4096,
                                                                   768)},
         lambda L, v: [L.scatter_nd(v["index"], v["updates"], [30522,
                                                                768])],
         ["updates"], ()),
        ("gather_tree", {"ids": rng.randint(0, 32000, (32, 16, 4)).astype(
            np.int64), "parents": parents},
         lambda L, v: [L.gather_tree(v["ids"], v["parents"])], [], (0,)),
        ("ctc_greedy_decoder",
         {"probs": probs / probs.sum(-1, keepdims=True),
          "lens": rng.randint(256, 513, 32).astype(np.int64)},
         lambda L, v: list(L.ctc_greedy_decoder(v["probs"], 95,
                                                v["lens"])), [], (0, 1)),
        ("cvm", {"x": f(deepfm, 11), "cvm": rng.randint(
            0, 1000, (deepfm, 2)).astype(np.float32)},
         lambda L, v: [L.continuous_value_model(v["x"], v["cvm"])],
         ["x", "cvm"], ()),
        ("filter_by_instag", {"ins": f(2048, 26 * 9), "tags": rng.randint(
            0, 64, (2048, 4)).astype(np.int64), "filter": rng.choice(
                64, 8, replace=False).astype(np.int64)},
         lambda L, v: list(L.filter_by_instag(v["ins"], v["tags"],
                                              v["filter"])), [], (0, 1, 2)),
        ("hash", {"ids": rng.randint(-2 ** 40, 2 ** 40, (deepfm, 2)).astype(
            np.int64)},
         lambda L, v: [L.hash(v["ids"], 10 ** 6, 4)], [], (0,)),
        ("similarity_focus", {"x": rng.randint(0, 50, (32, 8, 64, 64))
                              .astype(np.float32)},
         lambda L, v: [L.similarity_focus(v["x"], 1, [0, 3])], [], (0,)),
        ("random_crop", {"x": np.broadcast_to(img, (128, 3, 256, 256))
                         .copy()},
         lambda L, v: [L.random_crop(v["x"], [3, 224, 224])], [], (0,)),
    ]


def _vx_out_shapes(torch, ptt, feed, call):
    """The shapes of the layer call's outputs on ``feed``, from one
    op-by-op forward run on the card (several of these layers leave
    their output's static shape unknown)."""
    main, start = ptt.Program(), ptt.Program()
    main.random_seed = start.random_seed = SEED
    with ptt.unique_name.guard(), ptt.program_guard(main, start):
        v = {n: ptt.layers.data(n, list(a.shape), dtype=str(a.dtype),
                                append_batch_size=False)
             for n, a in feed.items()}
        outs = call(ptt.layers, v)
    exe = ptt.Executor()
    scope = ptt.Scope()
    exe.run(start, scope=scope)
    got = exe.run(main, feed={k: torch.from_numpy(a).cuda()
                              for k, a in feed.items()},
                  fetch_list=outs, scope=scope, return_numpy=False,
                  use_program_cache=False)
    exe.close()
    return [list(t.shape) for t in got]


def _vx_program(np, ptt, feed, call, diff, shapes=None):
    """The op's program: a data var per feed (differentiable where
    ``diff`` names it), the layer call, and where anything is
    differentiable the sum over its float outputs of each output times
    a cotangent fed beside it (``cot_<i>``, of the output's shape in
    ``shapes``, N(0, 1) from the seed) and append_backward of it to the
    differentiable feeds and the parameters. Returns (main, startup,
    fetch vars, the number of outputs, the feed with the
    cotangents)."""
    main, start = ptt.Program(), ptt.Program()
    main.random_seed = start.random_seed = SEED
    feed = dict(feed)
    rng = np.random.RandomState(SEED + 1)
    with ptt.unique_name.guard(), ptt.program_guard(main, start):
        L = ptt.layers
        v = {n: L.data(n, list(a.shape), dtype=str(a.dtype),
                       append_batch_size=False, stop_gradient=n not in diff)
             for n, a in feed.items()}
        outs = call(L, v)
        fetch = list(outs)
        if diff:
            terms = []
            for i, o in enumerate(outs):
                if o.dtype not in ("float32", "float64"):
                    continue
                shape = shapes[i]
                name = "cot_%d" % i
                feed[name] = rng.standard_normal(shape).astype(o.dtype)
                w = L.data(name, shape, dtype=o.dtype,
                           append_batch_size=False)
                terms.append(L.reduce_sum(L.elementwise_mul(o, w)))
            loss = L.sums(terms)
            roots = [v[n] for n in diff] + main.all_parameters()
            fetch += [g for _, g in ptt.append_backward(
                loss, parameter_list=roots)]
    return main, start, fetch, len(outs), feed


def _vx_runs(torch, ptt, main, start, feed, fetch, runs=4):
    """On the card: ``runs`` graphed runs (the first op by op, the second
    captured, then replays) and two op-by-op runs on one scope, fetches
    kept on the device; returns (graphed, op by op, the scope, the
    Executor, the device feed, the wall ms of the first op-by-op run, of
    the capturing run and of the last replay)."""
    dev = {k: torch.from_numpy(v).cuda() for k, v in feed.items()}
    scope = ptt.Scope()
    exe = ptt.Executor()
    exe.run(start, scope=scope)
    walls, graphed, plain = [], [], []
    for cache in [True] * runs + [False] * 2:
        t0 = time.perf_counter()
        out = exe.run(main, feed=dev, fetch_list=fetch, scope=scope,
                      return_numpy=False, use_program_cache=cache)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        (graphed if cache else plain).append(out)
    return graphed, plain, scope, exe, dev, {
        "op_by_op": walls[runs], "capture": walls[1],
        "replay": walls[runs - 1]}


def _to_cpu_scope(torch, ptt, main, start, scope):
    """A CPU scope holding ``main``'s persistables copied from the card's
    ``scope``."""
    values = {v.name: scope.find_var(v.name).cpu().numpy()
              for v in main.list_vars() if v.persistable
              and scope.find_var(v.name) is not None}
    cscope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(start, scope=cscope)
    ptt.set_params_from_numpy(values, main, cscope, ptt.CPUPlace())
    return cscope, exe


def _vx_on_cpu(torch, ptt, main, start, feed, fetch, scope):
    """The program on the CPU from the card scope's persistables."""
    cscope, exe = _to_cpu_scope(torch, ptt, main, start, scope)
    t0 = time.perf_counter()
    out = exe.run(main, feed=feed, fetch_list=fetch, scope=cscope,
                  return_numpy=False)
    return out, time.perf_counter() - t0


def _vx_op_ms(torch, np, op, feed, diff, prog):
    """Device ms of the op's kernel, forward and backward of the mean of
    its float outputs (time_ms), on the program's own inputs and
    attributes (parameters from its startup's shapes). (The mean's
    cotangent costs the backward what the program's fed one does.)"""
    from paddle_tpu_torch.ops.registry import get_op
    desc = [o for o in prog.global_block().ops if o.type == op]
    ctx = _OpCtx(torch, "cuda", SEED)
    blk = prog.global_block()

    def value(name):
        if name in feed:
            return feed[name]
        var = blk.var(name)
        g = torch.Generator(device=ctx.device).manual_seed(SEED)
        return torch.randn(tuple(var.shape), device=ctx.device, generator=g)

    calls = []
    for d in desc:
        ins = {slot: [value(n) for n in names]
               for slot, names in d.inputs.items()}
        leaves = []
        for slot, vs in ins.items():
            names = d.inputs[slot]
            for i, n in enumerate(names):
                if n in diff or (n not in feed and blk.var(n).persistable):
                    vs[i] = vs[i].detach().clone().requires_grad_()
                    leaves.append(vs[i])
        calls.append((get_op(op).fn, ins, dict(d.attrs), leaves))

    def run():
        with torch.enable_grad():
            for fn, ins, attrs, leaves in calls:
                outs = fn(ctx, ins, attrs)
                vals = [o for vs in outs.values()
                        for o in (vs if isinstance(vs, list) else [vs])
                        if o.is_floating_point() and o.requires_grad]
                if leaves and vals:
                    loss = sum(o.mean() for o in vals)
                    torch.autograd.grad(loss, leaves)
    return time_ms(torch, run, reps=3, inner=3)


def _vx_random_crop(torch, np, ptt, feed, call):
    """random_crop by its draws: VX_CROP_DRAWS graphed replays of the
    crop's corner (the image codes each pixel y * 256 + x), one offset
    for all 128 x 3 planes of a draw, offsets uniform over their 33
    values (each count within 5 standard errors), a fresh Executor
    drawing the same offsets run for run and op by op the same as
    graphed; three full crops equal to the image's window; the kernel's
    forward ms."""
    main, start = ptt.Program(), ptt.Program()
    main.random_seed = start.random_seed = SEED
    with ptt.unique_name.guard(), ptt.program_guard(main, start):
        L = ptt.layers
        x = L.data("x", list(feed["x"].shape), append_batch_size=False)
        crop = call(L, {"x": x})[0]
        corner = L.slice(crop, [2, 3], [0, 0], [1, 1])
    dev = torch.from_numpy(feed["x"]).cuda()

    def draws(n, cache=True, fetch=corner):
        exe = ptt.Executor()
        scope = ptt.Scope()
        out = [exe.run(main, feed={"x": dev}, fetch_list=[fetch],
                       scope=scope, return_numpy=False,
                       use_program_cache=cache)[0] for _ in range(n)]
        exe.close()
        return out
    t0 = time.perf_counter()
    corners = draws(VX_CROP_DRAWS)
    one_offset = all(bool((c == c.reshape(-1)[0]).all()) for c in corners)
    codes = np.array([int(c.reshape(-1)[0]) for c in corners])
    y0, x0 = codes // 256, codes % 256
    again = draws(3)
    by_op = draws(3, cache=False)
    repeat = all(_same_bits(torch, a, b) for a, b in zip(corners, again))
    op_by_op = all(_same_bits(torch, a, b) for a, b in zip(corners, by_op))
    k = 256 - 224 + 1
    n = len(codes)
    se = math.sqrt(n / k * (1 - 1 / k))
    counts = [np.bincount(y0, minlength=k), np.bincount(x0, minlength=k)]
    uniform = all(c.size == k and np.all(np.abs(c - n / k) <= 5 * se)
                  for c in counts)
    windows = True
    for full in draws(3, fetch=crop):
        yy, xx = divmod(int(full.reshape(-1)[0]), 256)
        windows = windows and bool(torch.equal(
            full, dev[:, :, yy:yy + 224, xx:xx + 224]))
    ms = _vx_op_ms(torch, np, "random_crop", {"x": dev}, [], main)
    good = one_offset and uniform and repeat and op_by_op and windows
    return {"ok": good, "fwd_ms": ms, "draws": n,
            "one_offset_per_batch": one_offset,
            "offset_counts_y": counts[0].tolist(),
            "offset_counts_x": counts[1].tolist(), "uniform": uniform,
            "fresh_executor_repeats": repeat,
            "op_by_op_equals_graphed": op_by_op, "windows_equal": windows,
            "seconds": time.perf_counter() - t0}


def _op_case(torch, np, ptt, op, feed, call, diff, exact, cut=None,
             loop=False):
    """One op type of vision_extras or detection_ops through its layers
    function into its own program (_vx_program): graphed replays equal
    to op-by-op runs bit for bit, two runs of each kind bit-equal,
    outputs finite (_vx_runs); the card against the CPU within
    OP_LIB_TOL (what moves or chooses data exactly: ``exact``) at the
    full shape, or at ``cut``'s batch on the CPU side only (_cut_feed);
    the kernel's device ms forward and backward (_vx_op_ms), or for a
    ``loop`` op (its greedy loop a launch group a step) a replay's wall
    ms, its device kernels (_profiled), the op-by-op run's ms and the
    capture. Returns its result record."""
    t0 = time.perf_counter()
    shapes = _vx_out_shapes(torch, ptt, feed, call) if diff else None
    main, start, fetch, n_out, feed = _vx_program(np, ptt, feed, call,
                                                  diff, shapes)
    graphed, plain, scope, exe, dev, walls = _vx_runs(torch, ptt, main,
                                                      start, feed, fetch)
    replay_equal = all(_same_bits(torch, a, b) for a, b in
                       zip(graphed[2], plain[0]))
    replays_equal = all(_same_bits(torch, a, b) for a, b in
                        zip(graphed[2], graphed[3]))
    plain_equal = all(_same_bits(torch, a, b) for a, b in
                      zip(plain[0], plain[1]))
    finite = all(bool(torch.isfinite(t).all()) for t in graphed[3]
                 if t.is_floating_point())
    runs = dict(exe.graph_runs)
    extra = {}
    if loop:
        prof = _profiled(torch, lambda: exe.run(
            main, feed=dev, fetch_list=fetch, scope=scope,
            return_numpy=False))
        ms = walls["replay"]
        extra["loop"] = {
            "op_by_op_ms": walls["op_by_op"],
            "capture_run_ms": walls["capture"], "replay_ms": ms,
            "capture": _capture_record(exe),
            "replay_device_kernels": prof["device_kernels"],
            "replay_device_busy_ms": prof["device_busy_ms"]}
    else:
        ms = _vx_op_ms(torch, np, op, dev, diff, main)
    if cut is not None:
        cfeed = _cut_feed(feed, cut)
        cmain, cstart, cfetch, _, cfeed = _vx_program(
            np, ptt, cfeed, call, diff,
            _vx_out_shapes(torch, ptt, cfeed, call) if diff else None)
        cgraphed, _, cscope, cexe, _, _ = _vx_runs(torch, ptt, cmain,
                                                   cstart, cfeed, cfetch,
                                                   runs=3)
        card, want_main, want_start, want_feed, want_fetch = \
            cgraphed[2], cmain, cstart, cfeed, cfetch
        card_scope = cscope
        cexe.close()
    else:
        card, want_main, want_start, want_feed, want_fetch = \
            graphed[2], main, start, feed, fetch
        card_scope = scope
    want, cpu_s = _vx_on_cpu(torch, ptt, want_main, want_start, want_feed,
                             want_fetch, card_scope)
    errs, scales, close = [], [], True
    for i, (g, w) in enumerate(zip(card, want)):
        e, good = _close_to(torch, g.cpu(), w, i in exact)
        errs.append(e)
        scales.append(float(w.double().abs().max()) if w.numel()
                      else 0.0)
        close = close and good
    exe.close()
    good = (replay_equal and replays_equal and plain_equal and finite and
            close and runs["replay"] >= 2)
    return dict({
        "ok": good, "shapes": {k: list(v.shape) for k, v in feed.items()
                               if not k.startswith("cot_")},
        "cpu_shapes": ({k: list(v.shape) for k, v in want_feed.items()
                        if not k.startswith("cot_")}
                       if cut is not None else "full"),
        "outputs": n_out, "grads": len(fetch) - n_out,
        "replay_equals_op_by_op": replay_equal,
        "replays_equal": replays_equal, "op_by_op_runs_equal": plain_equal,
        "finite": finite, "graph_runs": runs,
        "max_abs_err_vs_cpu": errs, "max_abs_cpu": scales,
        "exact": list(exact), "cpu_s": cpu_s, "fwd_bwd_ms": ms,
        "seconds": time.perf_counter() - t0}, **extra)


def _cut_feed(feed, cut):
    """The CPU side's feed cut in batch: ``cut`` an int (every feed's
    first axis) or {name: rows}; the cotangents are made again."""
    if isinstance(cut, int):
        return {k: v[:cut] for k, v in feed.items()
                if not k.startswith("cot_")}
    return {k: (v[:cut[k]] if k in cut else v) for k, v in feed.items()
            if not k.startswith("cot_")}


def vision_extras(torch, np, ptt, counters):
    """The 22 vision and extras op types on the card, each at a published
    model's shape (_vx_feeds) through _op_case: graphed replays equal to
    op-by-op runs bit for bit, the card against the CPU at the full shape
    or, for pool3d, whose CPU side would take about 6 s at it, at
    VX_CUT's batch; random_crop by its draws (_vx_random_crop). No op
    reaches a hand-written kernel: the launch counters stay at 0."""
    counters.zero()
    results, ok = {}, True
    for op, feed, call, diff, exact in _vx_feeds(
            np, np.random.RandomState(SEED)):
        if op == "random_crop":
            results[op] = _vx_random_crop(torch, np, ptt, feed, call)
        else:
            results[op] = _op_case(torch, np, ptt, op, feed, call, diff,
                                   exact, VX_CUT.get(op))
        ok = ok and results[op]["ok"]
    launches = counters.read_all()
    ok = ok and len(results) == 22 and not any(launches.values())
    emit({"phase": "vision_extras", "ok": ok, "op_types": len(results),
          "tol": OP_LIB_TOL, "cut_for_cpu": VX_CUT,
          "launches": launches, "ops": results})
    if not ok:
        raise AssertionError("vision_extras checks failed (see the line "
                             "above)")
    return launches

def _ssd_maps(pkg, img, w, is_test=False):
    """The feature maps multi_box_head reads: PaddleCV mobilenet_ssd's
    module11, module13 and the four extra blocks (19, 10, 5, 3, 2, 1 at
    300 x 300), or with ``narrow`` two maps of a conv and two blocks."""
    vis = importlib.import_module(pkg.__name__ + ".models.vision")

    def conv_bn(x, c, k, stride=1):
        return vis._conv_bn(x, c, k, stride=stride, is_test=is_test)

    def dw_sep(x, cin, cout, stride, s=1.0):
        return vis._depthwise_separable(x, cin, cout, stride, s,
                                        is_test=is_test)

    def extra(x, c1, c2):
        # PaddleCV mobilenet_ssd's extra_block: 1x1, then 3x3 stride 2
        return conv_bn(conv_bn(x, c1, 1), c2, 3, stride=2)
    if w.get("narrow"):
        m1 = dw_sep(conv_bn(img, 8, 3, stride=2), 8, 16, 2)
        return [m1, extra(m1, 8, 16)]
    s = w["scale"]
    h = conv_bn(img, int(32 * s), 3, stride=2)
    for cin, cout, st in ((32, 64, 1), (64, 128, 2), (128, 128, 1),
                          (128, 256, 2), (256, 256, 1), (256, 512, 2)) + \
            ((512, 512, 1),) * 5:
        h = dw_sep(h, cin, cout, st, s)
    maps = [h]
    h = dw_sep(h, 512, 1024, 2, s)
    maps.append(dw_sep(h, 1024, 1024, 1, s))
    for c1, c2 in ((256, 512), (128, 256), (128, 256), (64, 128)):
        maps.append(extra(maps[-1], int(c1 * s), int(c2 * s)))
    return maps


def _ssd_program(pkg, w, serve=False, batch=None):
    """MobileNet-v1 SSD (SSD's keys) built with ``pkg``'s layers (the
    port, or the JAX package in tests/test_torch_detection_layers.py):
    (main, startup, fetch). Training: [summed ssd_loss, the priors] with
    RMSProp and L2Decay; ``serve``: [detection_output's rows (N,
    keep_top_k, 6), the priors] at ``batch``, the batch norms in test
    mode. Both build the same parameters in the same order, so the names
    match."""
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    b = batch or w["batch"]
    im = w["image"]
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        img = L.data("image", [b, 3, im, im], append_batch_size=False)
        locs, confs, box, var = L.multi_box_head(
            _ssd_maps(pkg, img, w, is_test=serve), img, base_size=im,
            num_classes=w["classes"], aspect_ratios=w["aspect_ratios"],
            min_sizes=w["min_sizes"], max_sizes=w["max_sizes"], offset=0.5,
            flip=True)
        if serve:
            fetch = [L.detection_output(locs, L.softmax(confs), box, var,
                                        nms_threshold=w["nms"],
                                        keep_top_k=w["keep_top_k"]), box]
        else:
            g = w["max_box"]
            gt_box = L.data("gt_box", [b, g, 4], append_batch_size=False)
            gt_label = L.data("gt_label", [b, g, 1], "int32",
                              append_batch_size=False)
            loss = L.reduce_sum(L.ssd_loss(locs, confs, gt_box, gt_label,
                                           box, var))
            pkg.optimizer.RMSProp(
                w["lr"], regularization=pkg.regularizer.L2Decay(w["l2"])
            ).minimize(loss)
            fetch = [loss, box]
    startup.random_seed = SEED
    return main, startup, fetch


def _ssd_feed(np, w, seed=0, batch=None):
    """Images in [0, 1) and each image's ``gt`` ground truths (the rest
    of max_box zero), normalized xyxy boxes of a tenth to a half of the
    image, classes 1..classes-1."""
    rng = np.random.RandomState(seed)
    b = batch or w["batch"]
    feed = {"image": rng.rand(b, 3, w["image"], w["image"]).astype(
        np.float32)}
    if batch is not None:
        return feed
    g, k = w["max_box"], w["gt"]
    lo = rng.uniform(0.0, 0.5, (b, k, 2))
    box = np.concatenate([lo, lo + rng.uniform(0.1, 0.5, (b, k, 2))], -1)
    feed["gt_box"] = np.zeros((b, g, 4), np.float32)
    feed["gt_box"][:, :k] = np.minimum(box, 1.0)
    feed["gt_label"] = np.zeros((b, g, 1), np.int32)
    feed["gt_label"][:, :k, 0] = rng.randint(1, w["classes"], (b, k))
    return feed


def _c4_trunk(pkg, res, img, w):
    """ResNet-50 through res4 (stride 16, 1024 channels) from
    ``models/resnet.py``'s layers, or with trunk "tiny" two stride-4
    conv_bns to ``width`` channels."""
    L = pkg.layers
    if w["trunk"] == "tiny":
        h = res.conv_bn_layer(img, 8, 3, stride=4, act="relu", name="t1")
        return res.conv_bn_layer(h, w["width"], 3, stride=4, act="relu",
                                 name="t2")
    h = res.conv_bn_layer(img, 64, 7, stride=2, act="relu", name="conv1")
    h = L.pool2d(h, 3, "max", 2, 1)
    for stage, (n, f, st) in enumerate(((3, 64, 1), (4, 128, 2),
                                        (6, 256, 2))):
        for i in range(n):
            h = res.bottleneck_block(h, f, st if i == 0 else 1,
                                     "res%d%s" % (stage + 2, chr(97 + i)))
    return h


def _normal(pkg, name, std):
    return pkg.ParamAttr(name=name,
                         initializer=pkg.initializer.Normal(0.0, std))


def _per_sampled(L, total, mask):
    """``total`` over the count of ``mask``'s ones (at least 1)."""
    count = L.clip(L.reduce_sum(mask), 1.0, 1e30)
    count.stop_gradient = True
    return L.elementwise_div(L.reduce_sum(total), count)


def _rcnn_rpn(pkg, L, feat, gt_box, is_crowd, im_info, w, use_random):
    """The RPN head (a 3x3 conv, the objectness and box 1x1 convs), its
    anchors, rpn_target_assign and the two RPN losses (sigmoid CE over
    the sampled anchors, smooth-L1 at sigma 3 over the foreground, both
    per sampled anchor): (cls loss, box loss, objectness logits map, box
    map, anchors, variances)."""
    na = len(w["anchor_sizes"]) * len(w["ratios"])
    conv = L.conv2d(feat, w["width"], 3, padding=1, act="relu",
                    param_attr=_normal(pkg, "conv_rpn_w", 0.01),
                    bias_attr=pkg.ParamAttr(name="conv_rpn_b"))
    cls = L.conv2d(conv, na, 1, param_attr=_normal(pkg, "rpn_cls_w", 0.01),
                   bias_attr=pkg.ParamAttr(name="rpn_cls_b"))
    bbox = L.conv2d(conv, 4 * na, 1,
                    param_attr=_normal(pkg, "rpn_bbox_w", 0.01),
                    bias_attr=pkg.ParamAttr(name="rpn_bbox_b"))
    anchor, var = L.anchor_generator(
        feat, anchor_sizes=w["anchor_sizes"], aspect_ratios=w["ratios"],
        variance=[1.0, 1.0, 1.0, 1.0], stride=[16.0, 16.0])
    # the anchors are (H, W, A, 4): the maps go to that order
    cls_t = L.reshape(L.transpose(cls, [0, 2, 3, 1]), [1, -1])
    box_t = L.reshape(L.transpose(bbox, [0, 2, 3, 1]), [1, -1, 4])
    _, _, labels, tgt, inw = L.rpn_target_assign(
        box_t, cls_t, L.reshape(anchor, [-1, 4]), L.reshape(var, [-1, 4]),
        gt_box, is_crowd, im_info, rpn_batch_size_per_im=w["rpn_batch"],
        rpn_straddle_thresh=0.0, rpn_fg_fraction=w["rpn_fg"],
        rpn_positive_overlap=w["rpn_pos"],
        rpn_negative_overlap=w["rpn_neg"], use_random=use_random)
    labf = L.cast(labels, "float32")
    sampled = L.clip(L.scale(labf, bias=1.0), 0.0, 1.0)
    target = L.relu(labf)
    cls_loss = _per_sampled(L, L.elementwise_mul(
        L.sigmoid_cross_entropy_with_logits(cls_t, target), sampled),
        sampled)
    box_loss = _per_sampled(L, L.smooth_l1(box_t, tgt, inw, inw, sigma=3.0),
                            sampled)
    return cls_loss, box_loss, cls, bbox, anchor, var


def _rcnn_sampled(pkg, L, rois, labels, tgt, inw, n):
    """The ``n`` RoIs generate_proposal_labels sampled (label >= 0; the
    first in top_k's order of a 0/1 key, so every sampled one while there
    are at most ``n``), gathered: (rois, labels, targets, weights, 0/1
    sampled)."""
    key = L.clip(L.scale(L.cast(labels, "float32"), bias=1.0), 0.0, 1.0)
    _, idx = L.topk(key, n)
    idx = L.reshape(idx, [-1])

    def pick(v, k):
        out = L.gather(L.reshape(v, [-1, k]), idx)
        out.stop_gradient = True
        return out
    return (pick(rois, 4), pick(labels, 1), pick(tgt, 4), pick(inw, 4),
            pick(key, 1))


def _rcnn_box_head(pkg, L, res, feat, rois, labels, tgt, inw, sampled, w):
    """roi_align 14 x 14 at 1/16 (sampling_ratio 0), res5 (or with head
    "tiny" one conv_bn), a global average pool, the class and
    class-specific box fc layers; softmax CE over the sampled RoIs and
    smooth-L1 of the label's box over the foreground, both per sampled
    RoI: (cls loss, box loss)."""
    c = w["classes"]
    h = L.reshape(L.roi_align(feat, rois, w["roi_res"], w["roi_res"],
                              1.0 / 16.0, sampling_ratio=0),
                  [-1, w["width"], w["roi_res"], w["roi_res"]])
    if w["head"] == "tiny":
        h = res.conv_bn_layer(h, 16, 3, stride=2, act="relu", name="h5")
    else:
        for i, st in enumerate((2, 1, 1)):
            h = res.bottleneck_block(h, 512, st, "res5%s" % chr(97 + i))
    h = L.pool2d(h, pool_type="avg", global_pooling=True)
    score = L.fc(h, c, param_attr=_normal(pkg, "cls_score_w", 0.01),
                 bias_attr=pkg.ParamAttr(name="cls_score_b"))
    pred = L.fc(h, 4 * c, param_attr=_normal(pkg, "bbox_pred_w", 0.001),
                bias_attr=pkg.ParamAttr(name="bbox_pred_b"))
    lab = L.cast(L.relu(L.cast(labels, "float32")), "int64")
    cls_loss = _per_sampled(L, L.elementwise_mul(
        L.softmax_with_cross_entropy(score, lab), sampled), sampled)
    hot = L.one_hot(lab, c)
    hot.stop_gradient = True
    mine = L.reduce_sum(L.elementwise_mul(
        L.reshape(pred, [-1, c, 4]), L.unsqueeze(hot, [2])), dim=1)
    box_loss = _per_sampled(L, L.smooth_l1(mine, tgt, inw, inw, sigma=1.0),
                            sampled)
    return cls_loss, box_loss


def _rcnn_program(pkg, w, part="train", use_random=True, rois=None):
    """Faster R-CNN ResNet-50-C4 (RCNN's keys) built with ``pkg``'s
    layers: (main, startup, fetch). ``part`` "train": the image through
    the trunk, the RPN (its losses; generate_proposals, then
    generate_proposal_labels), the sampled RoIs' box head; fetch the four
    losses, their sum first, then the box head's gathered inputs (RoIs,
    labels, targets, weights, sampled mask); Momentum. "rpn": the RPN's two losses from a
    fed ``res4`` map; "box": the box head's two from a fed ``res4`` and
    ``rois`` fed RoIs with their labels, targets, weights and sampled
    mask; both fetch the gradients of the sum to the map and every
    parameter after the losses. Parameters are named, so the parts share
    the train program's."""
    L = pkg.layers
    res = importlib.import_module(pkg.__name__ + ".models.resnet")
    main, startup = pkg.Program(), pkg.Program()
    g = w["max_box"]

    def data(name, shape, dtype="float32", grad=False):
        return L.data(name, list(shape), dtype, append_batch_size=False,
                      stop_gradient=not grad)
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        gt_box = data("gt_box", (1, g, 4))
        gt_class = data("gt_class", (1, g, 1), "int32")
        is_crowd = data("is_crowd", (1, g, 1), "int32")
        im_info = data("im_info", (1, 3))
        if part == "train":
            feat = _c4_trunk(pkg, res, data("image", (1, 3) + tuple(
                w["image"])), w)
        else:
            feat = data("res4", (1, w["width"]) + tuple(w["feat"]),
                        grad=True)
        losses = []
        if part in ("train", "rpn"):
            rpn_cls, rpn_box, cls, bbox, anchor, var = _rcnn_rpn(
                pkg, L, feat, gt_box, is_crowd, im_info, w, use_random)
            losses += [rpn_cls, rpn_box]
        if part == "train":
            props, _ = L.generate_proposals(
                L.sigmoid(cls), bbox, im_info, anchor, var,
                pre_nms_top_n=w["pre_nms"], post_nms_top_n=w["post_nms"],
                nms_thresh=w["nms"], min_size=0.0, eta=1.0)
            # the reference's generate_proposal_labels samples from the
            # proposals and the ground truths: they go in after the
            # proposals here (padding gts are empty boxes, background)
            props = L.concat([L.reshape(props, [1, w["post_nms"], 4]),
                              gt_box], axis=1)
            props.stop_gradient = True
            rois_all, labels, tgt, inw, _ = L.generate_proposal_labels(
                props, gt_class, is_crowd, gt_box, im_info,
                batch_size_per_im=w["roi_batch"], fg_fraction=w["roi_fg"],
                fg_thresh=0.5, bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                bbox_reg_weights=w["reg_weights"], class_nums=w["classes"],
                use_random=use_random)
            head_in = _rcnn_sampled(pkg, L, rois_all, labels, tgt, inw,
                                    w["roi_batch"])
        elif part == "box":
            head_in = (data("rois", (rois, 4)),
                       data("labels", (rois, 1), "int32"),
                       data("tgt", (rois, 4)), data("inw", (rois, 4)),
                       data("sampled", (rois, 1)))
        if part in ("train", "box"):
            losses += list(_rcnn_box_head(pkg, L, res, feat, *head_in,
                                          w=w))
        total = L.sums(losses)
        fetch = [total] + losses
        if part == "train":
            pkg.optimizer.Momentum(w["lr"], w["momentum"]).minimize(total)
            fetch += list(head_in)
        else:
            fetch += [gv for _, gv in pkg.append_backward(
                total, parameter_list=[feat] + main.all_parameters())]
    startup.random_seed = SEED
    return main, startup, fetch


def _rcnn_feed(np, w, seed=0, part="train"):
    """One image's feed: ``gt`` ground-truth boxes of 48 to 400 pixels
    (the rest of max_box zero), classes 1..80, none crowd; the image in
    [0, 1) (train) or a res4 map of N(0, 1) values (the parts)."""
    rng = np.random.RandomState(seed)
    hh, ww = w["image"]
    g, k = w["max_box"], w["gt"]
    x1 = rng.uniform(0, ww * 0.6, k)
    y1 = rng.uniform(0, hh * 0.6, k)
    side = rng.uniform(48, 400, (k, 2)) * np.array([ww, hh]) / 1333.0
    box = np.stack([x1, y1, np.minimum(x1 + side[:, 0], ww - 1),
                    np.minimum(y1 + side[:, 1], hh - 1)], 1)
    feed = {"gt_box": np.zeros((1, g, 4), np.float32),
            "gt_class": np.zeros((1, g, 1), np.int32),
            "is_crowd": np.zeros((1, g, 1), np.int32),
            "im_info": np.float32([[hh, ww, 1.0]])}
    feed["gt_box"][0, :k] = box
    feed["gt_class"][0, :k, 0] = rng.randint(1, w["classes"], k)
    if part == "train":
        feed["image"] = rng.rand(1, 3, hh, ww).astype(np.float32)
    else:
        feed["res4"] = rng.standard_normal(
            (1, w["width"]) + tuple(w["feat"])).astype(np.float32)
    return feed


def _detections_match(np, got, want, tol):
    """Rows of detection_output (N, K, 6) [label, score, box] held card
    against CPU: each image's kept rows (label >= 0) matched one to one,
    a card row to an unmatched CPU row of the same label whose score and
    box agree within ``tol`` (rows whose scores agree within it may come
    in either order); the padding rows equal. Returns (ok, kept rows,
    unmatched rows)."""
    kept, unmatched = 0, 0
    for g, w_ in zip(got, want):
        gk, wk = g[g[:, 0] >= 0], w_[w_[:, 0] >= 0]
        kept += len(wk)
        if len(gk) != len(wk) or not np.array_equal(g[g[:, 0] < 0],
                                                    w_[w_[:, 0] < 0]):
            unmatched += abs(len(gk) - len(wk)) or 1
            continue
        free = np.ones(len(wk), bool)
        for row in gk:
            hit = np.flatnonzero(free & (wk[:, 0] == row[0]) & np.all(
                np.abs(wk[:, 1:] - row[1:]) <= tol, axis=1))
            if hit.size:
                free[hit[0]] = False
            else:
                unmatched += 1
    return unmatched == 0, kept, unmatched


def detection_ssd(torch, np, ptt, counters):
    """MobileNet-v1 SSD300 at PaddleCV ssd's VOC settings (SSD,
    _ssd_program): the priors (SSD_PRIORS, their values against the
    CPU's exactly); SSD_STEPS training steps graphed from the second
    (losses finite, the last below the first, a replay equal to an
    op-by-op step bit for bit, ms a step, peak memory, no hand-written
    kernel launched); then detection_output from the trained weights at
    SSD_SERVE_BATCHES: graphed replays equal to an op-by-op request bit
    for bit, the card's answers against the CPU's (below), a replayed
    request's ms, its device kernels and busy
    time (torch.profiler), no hand-written kernel launched. The card's
    answers are held through the NMS's inputs: the decoded boxes and the
    softmaxed scores within SSD_SERVE_TOL of the CPU's, and the NMS run
    on the CPU from the card's own inputs giving the card's rows bit for
    bit. End to end, the rows are matched too (_detections_match) and
    the unmatched counted, not failed: a suppression whose IoU sits
    within rounding of the threshold goes either way, and the rest of
    that class's greedy pass follows it."""
    w = SSD
    main, start, fetch = _ssd_program(ptt, w)
    feed = _ssd_feed(np, w)
    record, ok, launches, (exe, scope) = _train_zoo(
        torch, np, ptt, counters, main, start, feed, fetch[:1], SSD_STEPS,
        _no_launches(counters))
    losses = [row[0] for row in record["losses"]]
    falling = losses[-1] < losses[0]
    serve = {}
    priors_ok = False
    from paddle_tpu_torch.ops.registry import get_op
    for b in SSD_SERVE_BATCHES:
        imain, istart, ifetch = _ssd_program(ptt, w, serve=True, batch=b)
        nms = next(op for op in imain.global_block().ops
                   if op.type == "multiclass_nms")
        ifetch = ifetch + [imain.global_block().var(nms.input(slot)[0])
                           for slot in ("BBoxes", "Scores")]
        ifeed = _ssd_feed(np, w, seed=1, batch=b)
        dev = {k: torch.from_numpy(v).cuda() for k, v in ifeed.items()}
        counters.zero()
        runs = [exe.run(imain, feed=dev, fetch_list=ifetch, scope=scope,
                        return_numpy=False) for _ in range(4)]
        plain = exe.run(imain, feed=dev, fetch_list=ifetch, scope=scope,
                        return_numpy=False, use_program_cache=False)
        served = counters.read()
        equal = all(_same_bits(torch, a, p) for a, p in zip(runs[3], plain))
        times = []
        for _ in range(GRAPH_SERVE_REPS):
            t0 = time.perf_counter()
            exe.run(imain, feed=dev, fetch_list=ifetch, scope=scope,
                    return_numpy=False)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        prof = _profiled(torch, lambda: exe.run(
            imain, feed=dev, fetch_list=ifetch, scope=scope,
            return_numpy=False))
        cscope, cexe = _to_cpu_scope(torch, ptt, imain, istart, scope)
        want = cexe.run(imain, feed=ifeed, fetch_list=ifetch, scope=cscope)
        got = runs[3][0].cpu().numpy()
        match, kept, unmatched = _detections_match(np, got, want[0],
                                                   SSD_SERVE_TOL)
        pre_err = [float(np.abs(runs[3][i].cpu().numpy() - want[i]).max())
                   for i in (2, 3)]
        pre_ok = max(pre_err) <= SSD_SERVE_TOL
        on_cpu = get_op("multiclass_nms").fn(
            _OpCtx(torch, "cpu"), {"BBoxes": [runs[3][2].cpu()],
                                   "Scores": [runs[3][3].cpu()]},
            dict(nms.attrs))["Out"]
        nms_same = bool(torch.equal(on_cpu, runs[3][0].cpu()))
        priors = runs[3][1]
        priors_ok = priors.shape[0] == SSD_PRIORS and bool(torch.equal(
            priors.cpu(), torch.from_numpy(np.asarray(want[1]))))
        good = equal and pre_ok and nms_same and priors_ok and \
            not any(served.values())
        serve[str(b)] = {
            "ok": good, "replay_equals_op_by_op": equal,
            "nms_inputs_max_err_vs_cpu": pre_err,
            "nms_on_cpu_from_card_inputs_equal": nms_same,
            "rows_match_cpu_end_to_end": match, "kept_rows": kept,
            "unmatched_rows_end_to_end": unmatched, "request_ms": times,
            "request_ms_median": statistics.median(times),
            "device_kernels": prof["device_kernels"],
            "device_busy_ms": prof["device_busy_ms"],
            "idle_share_unprofiled": prof["idle_share_unprofiled"],
            "launches": served, "priors": int(priors.shape[0]),
            "priors_equal_cpu": priors_ok}
        ok = ok and good
    ok = ok and falling
    close_executor(torch, "detection_ssd", exe)
    emit(dict({"phase": "detection_ssd", "ok": ok, "model": "mobilenet_ssd",
               "widths": w, "priors": SSD_PRIORS, "losses_fall": falling,
               "optimizer": "RMSProp(1e-3), L2Decay(5e-5)",
               "serve": serve, "serve_tol": SSD_SERVE_TOL}, **record))
    if not ok:
        raise AssertionError("detection_ssd checks failed (see the line "
                             "above)")
    return launches


def _both_ways_runs(torch, ptt, main, start, feed, fetch, runs):
    """``runs`` graphed runs of ``main`` on the card (the first op by op,
    the second captured, then replays) and as many op-by-op runs from a
    copy of the started scope: (graphed fetches, op-by-op fetches, the
    graphed step ms, the scope, the Executor)."""
    dev = {k: torch.from_numpy(v).cuda() for k, v in feed.items()}
    scope, exe = ptt.Scope(), ptt.Executor()
    exe.run(start, scope=scope)
    twin = _copy_scope(torch, ptt, scope)
    graphed, step_ms = [], []
    for _ in range(runs):
        t0 = time.perf_counter()
        graphed.append(exe.run(main, feed=dev, fetch_list=fetch,
                               scope=scope, return_numpy=False))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    plain = [exe.run(main, feed=dev, fetch_list=fetch, scope=twin,
                     return_numpy=False, use_program_cache=False)
             for _ in range(runs)]
    return graphed, plain, step_ms, scope, exe


def _part_vs_cpu(torch, np, ptt, w, part, feed, rois=None):
    """An RCNN part on the card (graphed and op by op, _vx_runs) and
    on the CPU from the card's parameters, its losses within RCNN_TOL
    (atol times the largest magnitude) and its gradients within
    RCNN_GRAD_L2 in relative L2: (record, ok)."""
    main, start, fetch = _rcnn_program(ptt, w, part=part, use_random=False,
                                       rois=rois)
    graphed, plain, scope, exe, _, walls = _vx_runs(torch, ptt, main, start,
                                                    feed, fetch)
    equal = all(_same_bits(torch, a, b) for g in graphed[2:] + plain[1:]
                for a, b in zip(g, plain[0]))
    cscope, cexe = _to_cpu_scope(torch, ptt, main, start, scope)
    t0 = time.perf_counter()
    want = cexe.run(main, feed=feed, fetch_list=fetch, scope=cscope,
                    return_numpy=False)
    cpu_s = time.perf_counter() - t0
    errs, l2s, close = [], [], True
    for i, (g, c) in enumerate(zip(graphed[0], want)):
        g, c = g.cpu().double(), c.double()
        scale = max(float(c.abs().max()), 1e-30)
        errs.append(float((g - c).abs().max()) / scale)
        l2s.append(float((g - c).norm() / max(float(c.norm()), 1e-30)))
        if i < 3:
            close = close and bool(((g - c).abs() <= RCNN_TOL["atol"] *
                                    scale + RCNN_TOL["rtol"] *
                                    c.abs()).all())
        else:
            close = close and l2s[-1] <= RCNN_GRAD_L2
    exe.close()
    record = {"ok": equal and close, "replay_equals_op_by_op": equal,
              "close_to_cpu": close,
              "losses": [float(v) for v in graphed[0][:3]],
              "grads": len(fetch) - 3, "max_err_over_scale": errs,
              "l2_rel_err": l2s, "walls_ms": walls, "cpu_s": cpu_s}
    return record, equal and close


def detection_rcnn(torch, np, ptt, counters):
    """A Faster R-CNN ResNet-50-C4 training step at PaddleCV rcnn's COCO
    settings (RCNN, _rcnn_program): RCNN_STEPS steps graphed from the
    second and as many op by op from the same start, bit for bit equal
    (the sampling ops draw the same at every run: no op of the program is
    flagged uses_rng); losses finite; ms a step, peak memory, the
    capture; no hand-written kernel. Its heads card against CPU on a fed
    res4 map of the full shape, use_random=False (_part_vs_cpu): the
    RPN part (losses, the gradients to the map and its parameters) and
    the box head on RCNN_CPU_ROIS of the last step's sampled RoIs, its
    foreground first (_part_vs_cpu)."""
    w = RCNN
    main, start, fetch = _rcnn_program(ptt, w)
    feed = _rcnn_feed(np, w)
    counters.zero()
    torch.cuda.reset_peak_memory_stats()
    graphed, plain, step_ms, scope, exe = _both_ways_runs(
        torch, ptt, main, start, feed, fetch, RCNN_STEPS)
    peak = torch.cuda.max_memory_allocated()
    launches = counters.read()
    equal = all(_same_bits(torch, a, b) for g, p in zip(graphed, plain)
                for a, b in zip(g, p))
    losses = [[float(v) for v in g[:5]] for g in graphed]
    finite = all(np.isfinite(row).all() for row in losses)
    captures = _capture_record(exe)
    runs = dict(exe.graph_runs)
    head = graphed[-1][5:]          # the last step's sampled RoIs etc.
    exe.close()
    part_feed = _rcnn_feed(np, w, part="rpn")
    rpn, rpn_ok = _part_vs_cpu(torch, np, ptt, w, "rpn", part_feed)
    k = RCNN_CPU_ROIS
    # the foreground RoIs first, so the box loss has terms
    pick = torch.argsort(-head[1][:, 0].float(), stable=True)[:k]
    box_feed = dict(part_feed, **{
        n: t[pick].cpu().numpy() for n, t in zip(
            ("rois", "labels", "tgt", "inw", "sampled"), head)})
    box_feed["labels"] = box_feed["labels"].astype(np.int32)
    box, box_ok = _part_vs_cpu(torch, np, ptt, w, "box", box_feed, rois=k)
    ok = equal and finite and rpn_ok and box_ok and \
        not any(launches.values()) and runs["replay"] >= 1
    emit({"phase": "detection_rcnn", "ok": ok,
          "model": "faster_rcnn_resnet50_c4", "widths": w,
          "optimizer": "Momentum(0.01, 0.9)", "losses": losses,
          "loss_names": ["total", "rpn_cls", "rpn_box", "rcnn_cls",
                         "rcnn_box"],
          "finite": finite, "step_ms": step_ms,
          "replay_equals_op_by_op": equal, "graph_runs": runs,
          "peak_mem_gb": peak / 2 ** 30, "captures": captures,
          "sampled_fg": int((head[1][:, 0] > 0).sum()),
          "sampled": int(head[4].sum()), "launches": launches,
          "heads_vs_cpu": {"tol": RCNN_TOL, "grad_l2": RCNN_GRAD_L2,
                           "rpn": rpn, "box": box,
                           "box_rois": k}})
    if not ok:
        raise AssertionError("detection_rcnn checks failed (see the line "
                             "above)")
    return launches


def _dx_boxes(np, rng, r, img_h, img_w, lo=16.0, frac=0.5):
    """r xyxy boxes inside an img_h x img_w image."""
    x1 = rng.uniform(0, img_w * 0.8, r)
    y1 = rng.uniform(0, img_h * 0.8, r)
    return np.stack([x1, y1,
                     np.minimum(x1 + rng.uniform(lo, img_w * frac, r),
                                img_w - 1),
                     np.minimum(y1 + rng.uniform(lo, img_h * frac, r),
                                img_h - 1)], 1).astype(np.float32)


def _dx_grid(np, h, w, a, stride, sizes):
    """Anchors (h, w, a, 4) at ``stride`` with ``a`` square-ish sizes."""
    out = np.zeros((h, w, a, 4), np.float32)
    cx = (np.arange(w) + 0.5) * stride
    cy = (np.arange(h) + 0.5) * stride
    for k in range(a):
        s = sizes[k % len(sizes)] * (0.7 + 0.3 * (k // len(sizes)))
        out[..., k, 0] = cx[None, :] - s / 2
        out[..., k, 1] = cy[:, None] - s / 2
        out[..., k, 2] = cx[None, :] + s / 2
        out[..., k, 3] = cy[:, None] + s / 2
    return out


def _dx_feeds(np, rng):
    """(op type, feeds {name: numpy}, layer call (L, vars) -> outputs,
    differentiable feeds, outputs held exactly) for the 28 deterministic
    op types of the detection and text-matching slice at a published
    model's shape (shuffle_batch apart: _dx_shuffle): SSD300's 1917
    priors at batch 64 (ssd_loss, mine_hard_examples, bipartite_match,
    target_assign, box_coder, iou_similarity, prior_box), Faster R-CNN's
    res4 (50 x 84 x 15 anchors: anchor_generator, generate_proposals at
    12000 -> 2000, rpn_target_assign, generate_proposal_labels, box_clip),
    Mask R-CNN FPN's P2 (roi_align, 512 RoIs at 200 x 336 x 256),
    generate_mask_labels, distribute/collect_fpn_proposals, RetinaNet
    (200700 anchors, 80 classes: retinanet_target_assign,
    sigmoid_focal_loss, retinanet_detection_output), EAST's 128 x 128
    geometry map (polygon_box_transform, locality_aware_nms over 16384
    boxes), PyramidBox's density priors, Fast R-CNN VGG16's roi_pool,
    Cascade R-CNN's box_decoder_and_assign, a text-recognition crop
    (roi_perspective_transform), and MM-DNN's text matching at batch
    128 and lengths 64. The sampling ops run with use_random=False: the
    card's Philox draws are not the CPU's."""
    def f(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def u(*shape):
        return rng.uniform(0, 1, shape).astype(np.float32)

    def gts(b, g, k, h, w):
        out = np.zeros((b, g, 4), np.float32)
        for i in range(b):
            out[i, :k] = _dx_boxes(np, rng, k, h, w, lo=32.0)
        return out
    ssd_prior = np.concatenate([_dx_boxes(np, rng, 1917, 1.0, 1.0, 0.02,
                                          0.4)])
    ssd_var = np.tile(np.float32([0.1, 0.1, 0.2, 0.2]), (1917, 1))
    ssd_gt = gts(64, 50, 6, 1.0, 1.0) / 1.0
    ssd_gt = np.where(ssd_gt > 0, np.clip(ssd_gt / 1.0, 0, 1), 0).astype(
        np.float32)
    ssd_lab = np.zeros((64, 50, 1), np.int32)
    ssd_lab[:, :6, 0] = rng.randint(1, 21, (64, 6))
    match = rng.randint(-1, 50, (64, 1917)).astype(np.int32)
    match[rng.uniform(0, 1, (64, 1917)) < 0.9] = -1
    rcnn_anc = _dx_grid(np, 50, 84, 15, 16.0, [32, 64, 128, 256, 512])
    rcnn_var = np.ones_like(rcnn_anc)
    rcnn_gt = gts(1, 50, 8, 800, 1333)
    im_info = np.float32([[800, 1333, 1.0]])
    retina_levels = [(100, 167, 8.0), (50, 84, 16.0), (25, 42, 32.0),
                     (13, 21, 64.0), (7, 11, 128.0)]
    retina_anc = [_dx_grid(np, h, w, 9, s, [4 * s]).reshape(-1, 4)
                  for h, w, s in retina_levels]
    retina_all = np.concatenate(retina_anc)
    east = u(1, 16384, 4) * 8 + np.repeat(
        (np.stack(np.meshgrid(np.arange(128), np.arange(128)), -1)
         .reshape(1, -1, 2) * 4).astype(np.float32), 2, -1)
    east[..., 2:] += 12.0
    quads = np.zeros((1, 64, 8), np.float32)
    for j in range(64):
        x0, y0 = rng.uniform(0, 400), rng.uniform(0, 400)
        dx, dy = rng.uniform(40, 100), rng.uniform(16, 40)
        sk = rng.uniform(-6, 6, 4)
        quads[0, j] = [x0 + sk[0], y0, x0 + dx, y0 + sk[1], x0 + dx + sk[2],
                       y0 + dy, x0, y0 + dy + sk[3]]
    fpn_rois = np.concatenate([_dx_boxes(np, rng, 1000, 800, 1333, 8, 0.1),
                               _dx_boxes(np, rng, 1000, 800, 1333, 64, 0.6)])
    mask_rois = np.stack([_dx_boxes(np, rng, 512, 800, 1333)
                          for _ in range(2)])
    mask_gt = gts(2, 50, 8, 800, 1333)
    mask_lab = rng.randint(-1, 81, (2, 512)).astype(np.int32)
    mm_x, mm_y = f(128, 64, 128), f(128, 64, 128)
    lens = rng.randint(8, 65, 128).astype(np.int64)
    lens2 = rng.randint(8, 65, 128).astype(np.int64)
    return [
        ("prior_box", {"feat": f(1, 512, 19, 19), "img": f(1, 3, 300, 300)},
         lambda L, v: list(L.prior_box(v["feat"], v["img"], [60.0], [],
                                       [2.0], flip=True, clip=True)),
         [], (0, 1)),
        ("density_prior_box", {"feat": f(1, 512, 80, 80),
                               "img": f(1, 3, 640, 640)},
         lambda L, v: list(L.density_prior_box(
             v["feat"], v["img"], densities=[4, 2, 1],
             fixed_sizes=[32.0, 64.0, 128.0], fixed_ratios=[1.0],
             clip=True, flatten_to_2d=True)), [], (0, 1)),
        ("anchor_generator", {"feat": f(1, 1024, 50, 84)},
         lambda L, v: list(L.anchor_generator(
             v["feat"], [32.0, 64.0, 128.0, 256.0, 512.0], [0.5, 1.0, 2.0],
             [1.0, 1.0, 1.0, 1.0], [16.0, 16.0])), [], (0, 1)),
        ("iou_similarity", {"prior": ssd_prior, "gt": ssd_gt[:8].reshape(
            -1, 4)},
         lambda L, v: [L.iou_similarity(v["gt"], v["prior"])], [], ()),
        ("box_coder", {"prior": ssd_prior, "var": ssd_var,
                       "loc": f(64, 1917, 4), "gt": ssd_gt[:8].reshape(-1,
                                                                      4)},
         lambda L, v: [L.box_coder(v["prior"], v["var"], v["loc"],
                                   "decode_center_size"),
                       L.box_coder(v["prior"], v["var"], v["gt"])], [], ()),
        ("box_clip", {"boxes": _dx_boxes(np, rng, 4000, 900, 1500).reshape(
            2, 2000, 4) - 50.0, "im_info": np.float32([[800, 1333, 1.0],
                                                        [600, 1000, 0.75]])},
         lambda L, v: [L.box_clip(v["boxes"], v["im_info"])], ["boxes"], ()),
        ("bipartite_match", {"dist": u(64, 50, 1917)},
         lambda L, v: list(L.bipartite_match(v["dist"], "per_prediction",
                                             0.5)), [], (0, 1)),
        ("target_assign", {"x": ssd_gt, "match": match,
                           "neg": (rng.uniform(0, 1, (64, 1917, 1)) < 0.1)
                           .astype(np.int32)},
         lambda L, v: list(L.target_assign(v["x"], v["match"], v["neg"])),
         [], (0, 1)),
        ("mine_hard_examples", {"cls": u(64, 1917) * 3, "loc": u(64, 1917),
                                "match": match, "dist": u(64, 1917)},
         lambda L, v: _mine_hard_examples_layer(L, v), [], (0, 1)),
        ("ssd_loss", {"loc": f(64, 1917, 4), "conf": f(64, 1917, 21),
                      "gt": ssd_gt, "label": ssd_lab, "prior": ssd_prior,
                      "var": ssd_var},
         lambda L, v: [L.ssd_loss(v["loc"], v["conf"], v["gt"], v["label"],
                                  v["prior"], v["var"])], ["loc", "conf"],
         ()),
        ("sigmoid_focal_loss", {"x": f(2 * 200700, 80),
                                "label": rng.randint(-1, 81, (2 * 200700, 1))
                                .astype(np.int32),
                                "fg": np.int32([1200])},
         lambda L, v: [L.sigmoid_focal_loss(v["x"], v["label"], v["fg"])],
         ["x"], ()),
        ("polygon_box_transform", {"geo": f(16, 8, 128, 128)},
         lambda L, v: [L.polygon_box_transform(v["geo"])], [], ()),
        ("roi_align", {"x": f(1, 256, 200, 336),
                       "rois": _dx_boxes(np, rng, 512, 800, 1344)},
         lambda L, v: [L.roi_align(v["x"], v["rois"], 14, 14, 0.25, 2)],
         ["x"], ()),
        ("roi_pool", {"x": f(2, 512, 38, 63),
                      "rois": np.concatenate([_dx_boxes(np, rng, 64, 600,
                                                         1000)] * 2),
                      "nums": np.int32([64, 64])},
         lambda L, v: [L.roi_pool(v["x"], v["rois"], 7, 7, 1 / 16.0,
                                  rois_num=v["nums"])], ["x"], ()),
        ("box_decoder_and_assign",
         {"prior": _dx_boxes(np, rng, 512, 800, 1333),
          "var": np.float32([0.1, 0.1, 0.2, 0.2]), "deltas": f(512, 324),
          "score": u(512, 81)},
         lambda L, v: list(L.box_decoder_and_assign(
             v["prior"], v["var"], v["deltas"], v["score"], 4.135)), [], ()),
        ("generate_proposals",
         {"scores": u(1, 15, 50, 84), "deltas": f(1, 60, 50, 84, scale=0.3),
          "im_info": im_info, "anchors": rcnn_anc, "var": rcnn_var},
         lambda L, v: list(L.generate_proposals(
             v["scores"], v["deltas"], v["im_info"], v["anchors"], v["var"],
             12000, 2000, 0.7, 0.0, 1.0, return_rois_num=True)), [],
         (1, 2)),
        ("distribute_fpn_proposals", {"rois": fpn_rois,
                                      "num": np.int32([1800])},
         lambda L, v: _flatten(L.distribute_fpn_proposals(
             v["rois"], 2, 5, 4, 224, rois_num=v["num"])), [],
         tuple(range(9))),
        ("collect_fpn_proposals",
         dict({"r%d" % i: _dx_boxes(np, rng, 2000, 800, 1333)
               for i in range(5)},
              **{"s%d" % i: u(2000, 1) for i in range(5)},
              **{"n%d" % i: np.int32([2000 - 300 * i]) for i in range(5)}),
         lambda L, v: list(L.collect_fpn_proposals(
             [v["r%d" % i] for i in range(5)],
             [v["s%d" % i] for i in range(5)], 2, 6, 2000,
             rois_num_per_level=[v["n%d" % i] for i in range(5)])), [],
         (0, 1)),
        ("rpn_target_assign", {"anc": rcnn_anc.reshape(-1, 4),
                               "var": rcnn_var.reshape(-1, 4),
                               "gt": rcnn_gt,
                               "crowd": np.zeros((1, 50, 1), np.int32),
                               "im_info": im_info},
         lambda L, v: list(L.rpn_target_assign(
             v["anc"], v["anc"], v["anc"], v["var"], v["gt"], v["crowd"],
             v["im_info"], use_random=False)[2:]), [], (0, 2)),
        ("retinanet_target_assign",
         {"anc": retina_all, "gt": gts(2, 100, 12, 800, 1333),
          "label": rng.randint(1, 81, (2, 100, 1)).astype(np.int32)},
         lambda L, v: list(L.retinanet_target_assign(
             v["anc"], v["anc"], v["anc"], v["anc"], v["gt"], v["label"],
             num_classes=80)[2:]), [], (0, 2, 3)),
        ("generate_proposal_labels",
         {"rois": np.stack([_dx_boxes(np, rng, 2000, 800, 1333)]),
          "cls": rng.randint(1, 81, (1, 50, 1)).astype(np.int32),
          "crowd": np.zeros((1, 50, 1), np.int32), "gt": rcnn_gt,
          "im_info": im_info},
         lambda L, v: list(L.generate_proposal_labels(
             v["rois"], v["cls"], v["crowd"], v["gt"], v["im_info"],
             use_random=False)), [], (0, 1, 3, 4)),
        ("locality_aware_nms", {"boxes": east, "scores": u(1, 1, 16384)},
         lambda L, v: [L.locality_aware_nms(v["boxes"], v["scores"], 0.1,
                                            -1, 100, 0.2)], [], ()),
        ("retinanet_detection_output",
         dict({"d%d" % i: f(1, a.shape[0], 4, scale=0.2)
               for i, a in enumerate(retina_anc)},
              **{"s%d" % i: u(1, a.shape[0], 80) * 0.2
                 for i, a in enumerate(retina_anc)},
              **{"a%d" % i: a for i, a in enumerate(retina_anc)},
              im_info=im_info),
         lambda L, v: [L.retinanet_detection_output(
             [v["d%d" % i] for i in range(5)],
             [v["s%d" % i] for i in range(5)],
             [v["a%d" % i] for i in range(5)], v["im_info"],
             score_threshold=0.05, nms_top_k=1000, keep_top_k=100,
             nms_threshold=0.5)], [], ()),
        ("roi_perspective_transform", {"x": f(1, 256, 128, 128),
                                       "quads": quads},
         lambda L, v: [L.roi_perspective_transform(v["x"], v["quads"], 8,
                                                   64, 0.25)], ["x"], ()),
        ("generate_mask_labels",
         {"im_info": np.float32([[800, 1333, 1.0]] * 2),
          "cls": rng.randint(1, 81, (2, 50, 1)).astype(np.int32),
          "crowd": np.zeros((2, 50, 1), np.int32),
          "segms": (rng.uniform(0, 1, (2, 50, 112, 112)) > 0.5)
          .astype(np.int32), "rois": mask_rois, "labels": mask_lab,
          "gt": mask_gt},
         lambda L, v: list(L.generate_mask_labels(
             v["im_info"], v["cls"], v["crowd"], v["segms"], v["rois"],
             v["labels"], 81, 28, gt_boxes=v["gt"])), [], (0, 1, 2)),
        ("match_matrix_tensor", {"x": mm_x, "y": mm_y},
         lambda L, v: [_cl().match_matrix_tensor(
             v["x"], v["y"], 5)[0]], ["x", "y"], ()),
        ("sequence_topk_avg_pooling",
         {"mm": f(128, 5, 64, 64), "rl": lens, "cl": lens2},
         lambda L, v: [_cl().sequence_topk_avg_pooling(
             v["mm"], v["rl"], v["cl"], [1, 3, 5, 10], 5)], ["mm"], ()),
        ("var_conv_2d", {"mm": f(128, 5, 64, 64), "rl": lens, "cl": lens2},
         lambda L, v: [_cl().var_conv_2d(
             v["mm"], v["rl"], v["cl"], 5, 8, [3, 3], stride=[1, 1])],
         ["mm"], ()),
    ]


def _cl():
    return importlib.import_module("paddle_tpu_torch.contrib.layers")


def _flatten(outs):
    flat = []
    for o in outs:
        flat.extend(o if isinstance(o, (list, tuple)) else [o])
    return flat


def _mine_hard_examples_layer(L, v):
    """mine_hard_examples appended by hand (no layers function calls it;
    ssd_loss holds its ranking inside)."""
    from paddle_tpu_torch.layer_helper import LayerHelper
    helper = LayerHelper("mine_hard_examples")
    neg = helper.create_variable_for_type_inference("int32")
    upd = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        "mine_hard_examples",
        inputs={"ClsLoss": [v["cls"].name], "LocLoss": [v["loc"].name],
                "MatchIndices": [v["match"].name],
                "MatchDist": [v["dist"].name]},
        outputs={"NegIndices": [neg.name], "UpdatedMatchIndices": [upd.name]},
        attrs={"neg_pos_ratio": 3.0, "neg_dist_threshold": 0.5,
               "mining_type": "max_negative"})
    return [neg, upd]


def _dx_shuffle(torch, np, ptt):
    """shuffle_batch at MM-DNN's batch (128 x 64 x 128): by its draws,
    DX_SHUFFLE_DRAWS graphed replays of the permutation's first entry
    uniform over the 128 rows (within 5 standard errors), each replay's
    Out equal to X[ShuffleIdx] and a permutation, op by op drawing the
    same as graphed run for run; startup_seed pinning the draw; the
    kernel's forward and backward ms."""
    x = np.random.RandomState(SEED).standard_normal((128, 64, 128)).astype(
        np.float32)
    dev = torch.from_numpy(x).cuda()

    def program(seed=None):
        main, start = ptt.Program(), ptt.Program()
        main.random_seed = start.random_seed = SEED
        with ptt.unique_name.guard(), ptt.program_guard(main, start):
            xv = ptt.layers.data("x", [128, 64, 128],
                                 append_batch_size=False)
            out = _cl().shuffle_batch(xv, seed=seed)
            idx = main.global_block().ops[-1].output("ShuffleIdx")[0]
        return main, [out, main.global_block().var(idx)]

    def draws(main, fetch, n, cache=True):
        exe = ptt.Executor()
        scope = ptt.Scope()
        out = [exe.run(main, feed={"x": dev}, fetch_list=fetch, scope=scope,
                       return_numpy=False, use_program_cache=cache)
               for _ in range(n)]
        exe.close()
        return out
    t0 = time.perf_counter()
    main, fetch = program()
    runs = draws(main, fetch, DX_SHUFFLE_DRAWS)
    perm_ok = all(bool(torch.equal(torch.sort(i).values,
                                   torch.arange(128, device=i.device)))
                  and bool(torch.equal(o, dev[i])) for o, i in runs)
    first = np.array([int(i[0]) for _, i in runs])
    by_op = draws(main, fetch, 3, cache=False)
    same = all(bool(torch.equal(a[1], b[1])) for a, b in zip(runs, by_op))
    n = len(first)
    se = math.sqrt(n / 128 * (1 - 1 / 128))
    counts = np.bincount(first, minlength=128)
    uniform = bool(np.all(np.abs(counts - n / 128) <= 5 * se))
    pmain, pfetch = program(seed=7)
    pinned = draws(pmain, pfetch, 2)
    pin_ok = bool(torch.equal(pinned[0][1], pinned[1][1]))
    ms = _vx_op_ms(torch, np, "shuffle_batch", {"x": dev}, ["x"], main)
    good = perm_ok and same and uniform and pin_ok
    return {"ok": good, "fwd_bwd_ms": ms, "draws": n,
            "permutation_and_gather_ok": perm_ok, "uniform": uniform,
            "first_index_counts_max": int(counts.max()),
            "first_index_counts_min": int(counts.min()),
            "op_by_op_equals_graphed": same, "startup_seed_pins": pin_ok,
            "seconds": time.perf_counter() - t0}


def detection_ops(torch, np, ptt, counters):
    """The 29 detection and text-matching op types on the card, each at a
    published model's shape (_dx_feeds) through _op_case: graphed replays
    equal to op-by-op runs bit for bit, the card against the CPU (within
    OP_LIB_TOL, what moves or chooses data exactly) at the full shape or,
    where DX_CUT names the op, at a smaller batch on the CPU side only;
    the loop ops DX_LOOP_OPS with their launches, op-by-op and replayed
    ms and capture; shuffle_batch by its draws (_dx_shuffle). No op
    reaches a hand-written kernel: the counters stay at 0."""
    counters.zero()
    results = {"shuffle_batch": _dx_shuffle(torch, np, ptt)}
    ok = results["shuffle_batch"]["ok"]
    for op, feed, call, diff, exact in _dx_feeds(
            np, np.random.RandomState(SEED)):
        results[op] = _op_case(torch, np, ptt, op, feed, call, diff, exact,
                               DX_CUT.get(op), op in DX_LOOP_OPS)
        ok = ok and results[op]["ok"]
    launches = counters.read_all()
    ok = ok and len(results) == 29 and not any(launches.values())
    emit({"phase": "detection_ops", "ok": ok, "op_types": len(results),
          "tol": OP_LIB_TOL, "cut_for_cpu": DX_CUT,
          "launches": launches, "ops": results})
    if not ok:
        raise AssertionError("detection_ops checks failed (see the line "
                             "above)")
    return launches

def _qat_bert_program(ptt, bert, cfg, batch, scope):
    """BERT pretraining under Adam(1e-4), made quant-aware in its
    optimizer_fn (``slim.quant_aware`` at SLIM_RATE; the moving-average
    state goes into ``scope``): (main, startup, [loss, mlm_loss,
    nsp_loss])."""
    from paddle_tpu_torch.contrib import slim

    def opt_fn(loss):
        slim.quant_aware(loss.block.program, moving_rate=SLIM_RATE,
                         scope=scope)
        ptt.optimizer.Adam(1e-4).minimize(loss)
    return _pretrain_program(ptt, bert, cfg, batch, opt_fn)


def _fake_quant_counts(main):
    ops = main.global_block().ops
    return {t: sum(op.type == t for op in ops) for t in FAKE_QUANT_OPS}


def _moving_states(main):
    """The moving averages' state counters of a quant-aware program."""
    return sorted(v.name for v in main.list_vars() if v.persistable and
                  v.name.endswith(".quantized.act.state"))


def _states_closed_form(np, state, names, runs):
    """The largest relative error of each name's value in ``state`` ({name:
    tensor}) against rate^n + (1 - rate^n) / (1 - rate) after ``runs``
    updates from 1 (f64)."""
    closed = SLIM_RATE ** runs + (1 - SLIM_RATE ** runs) / (1 - SLIM_RATE)
    got = [float(state[n].reshape(-1)[0]) for n in names]
    return closed, max(abs(g - closed) / closed for g in got)


def _fake_quant_ms(torch, ptt, main, start, feed, fetch_list):
    """Device ms and kernels of an op-by-op step's fake-quant ops and of
    their grad_of (``_device_ms_by_op_type``), on a copy of ``start``."""
    scope, exe = _copy_scope(torch, ptt, start), ptt.Executor()
    found = _device_ms_by_op_type(torch, lambda: exe.run(
        main, feed=feed, fetch_list=fetch_list, scope=scope,
        use_program_cache=False))
    close_executor(torch, "fake-quant profile", exe)
    ops = {k: v for k, v in found["by_op_type"].items() if "fake_" in k}
    return {"ops": ops, "device_ms": sum(v[1] for v in ops.values()),
            "kernels": sum(v[2] for v in ops.values()),
            "step_device_busy_ms": found["device_busy_ms"]}


def _encoder_targets(main):
    """(the encoder's sequence output, the NSP logits) of a BERT
    pretraining program: what its converted clone serves."""
    ops = main.global_block().ops
    flat = next(op for op in ops if op.type == "gather").input("X")[0]
    seq = next(op for op in ops if flat in op.output_names()).input("X")[0]
    logits = next(op for op in ops if op.type ==
                  "softmax_with_cross_entropy").input("Logits")[0]
    return [main.global_block().var(seq), main.global_block().var(logits)]


_SERVE_FEEDS = ("src_ids", "pos_ids", "sent_ids", "input_mask")


def _answers_err(np, got, want):
    return max(float(np.abs(np.asarray(g) - np.asarray(w)).max())
               for g, w in zip(got, want))


def _slim_serve(torch, np, ptt, infer, scope, cfg, root):
    """The converted program ``infer`` with ``scope``'s trained weights:
    saved by ``save_inference_model`` and served by the Predictor at
    SLIM_SERVE_BATCHES on the card and on the CPU; saved by
    ``save_quantized_inference_model``, loaded on the card and on the CPU
    and run at the same batches. (the record, ok)."""
    from paddle_tpu_torch.contrib import quantize
    from paddle_tpu_torch.framework.scope import to_numpy
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.models import bert
    targets = _encoder_targets(infer)
    requests = [{k: v for k, v in bert.synthetic_batch(
        cfg, n, TRAIN_SEQ, TRAIN_PREDS, seed=10 + n).items()
        if k in _SERVE_FEEDS} for n in SLIM_SERVE_BATCHES]
    plain_dir = os.path.join(root, "converted")
    q_dir = os.path.join(root, "int8")
    exe = ptt.Executor()
    t0 = time.perf_counter()
    with ptt.scope_guard(scope):
        ptt.save_inference_model(plain_dir, list(_SERVE_FEEDS), targets,
                                 exe, main_program=infer)
        save_s = time.perf_counter() - t0
        quantize.save_quantized_inference_model(
            q_dir, list(_SERVE_FEEDS), targets, exe, main_program=infer)
    q_save_s = time.perf_counter() - t0 - save_s
    config = Config(plain_dir)
    config.batch_buckets = SLIM_SERVE_BATCHES
    pred = create_predictor(config)
    cpu_config = Config(plain_dir)
    cpu_config.place = ptt.CPUPlace()
    cpu_pred = create_predictor(cpu_config)
    served = []
    for req in requests:
        ms = []
        for _ in range(3):         # a bucket's warm run, capture, replay
            t1 = time.perf_counter()
            got = pred.run(req)
            ms.append((time.perf_counter() - t1) * 1e3)
        served.append({"batch": len(req["src_ids"]), "op_by_op_ms": ms[0],
                       "capture_ms": ms[1], "ms": ms[2],
                       "shapes": [list(g.shape) for g in got],
                       "finite": all(np.isfinite(g).all() for g in got),
                       "max_abs_err_vs_cpu": _answers_err(
                           np, got, cpu_pred.run(req))})
    close_executor(torch, "slim_bert serve", pred._exe)
    with np.load(os.path.join(q_dir, "params.npz")) as z:
        members = set(z.files)
    with open(os.path.join(q_dir, "quant_scales.json")) as f:
        scales = json.load(f)
    params = [p.name for p in infer.all_parameters()]
    int8_ok = all(p + ".int8" in members and p not in members
                  for p in params)
    others = sorted(m for m in members if not m.endswith(".int8"))
    loaded, qexe = ptt.Scope(), ptt.Executor()
    cpu_loaded, cexe = ptt.Scope(), ptt.Executor(ptt.CPUPlace())
    with ptt.scope_guard(loaded):
        qprog, _, qfetch = quantize.load_quantized_inference_model(
            q_dir, qexe)
    with ptt.scope_guard(cpu_loaded):
        cprog, _, _ = quantize.load_quantized_inference_model(q_dir, cexe)
    worst = 0.0                 # the largest error over its bound
    for p in params:
        trained, deq = scope.find_var(p), loaded.find_var(p)
        bound = scales[p] / 2 + float(np.spacing(np.float32(
            float(trained.abs().max()))))
        worst = max(worst, float((deq - trained).abs().max()) / bound)
    int8_runs = []
    for req in requests:
        with ptt.scope_guard(loaded):
            got = qexe.run(qprog, feed=req, fetch_list=qfetch)
        with ptt.scope_guard(cpu_loaded):
            want = cexe.run(cprog, feed=req, fetch_list=qfetch)
        int8_runs.append({"batch": len(req["src_ids"]),
                          "finite": all(np.isfinite(g).all() for g in got),
                          "max_abs_err_vs_cpu": _answers_err(np, got,
                                                             want)})
    close_executor(torch, "slim_bert int8", qexe)
    del loaded, cpu_loaded
    ok = (all(r["finite"] and r["max_abs_err_vs_cpu"] <= SERVE_ATOL
              for r in served + int8_runs) and int8_ok and worst <= 1.0
          and all(r["shapes"][1] == [r["batch"], 2] for r in served))
    return {"save_s": save_s, "quantized_save_s": q_save_s,
            "served": served, "int8_members_ok": int8_ok,
            "int8_parameters": len(params),
            "other_persistables_stored": len(others),
            "dequantized_err_over_half_scale_max": worst,
            "int8_runs": int8_runs, "atol": SERVE_ATOL}, ok


def slim_bert(torch, np, ptt, counters, root):
    """BERT-base (f32, dropout 0.1) at batch 32 x 128 made quant-aware
    (contrib.slim.quant_aware) under Adam(1e-4): GRAPH_STEPS runs op by op
    and graphed from one startup (``_both_ways``: fetches and every
    persistable, the moving averages too, bit for bit; the train step's
    launches a step: quant-aware training adds no attention, LayerNorm or
    parameter); losses finite and falling; each moving average's state
    the closed form; the step's replay ms beside the unquantized step's;
    the fake-quant ops' device ms and kernels in an op-by-op step. Then
    ``clone(for_test=True)`` and ``slim.convert``: no moving-average op
    left, every weight's per-channel scale positive; served at
    SLIM_SERVE_BATCHES and saved as int8 (``_slim_serve``). Last, a
    narrow BERT (SLIM_PARITY) quant-aware, card against CPU (PARITY_*)."""
    from paddle_tpu_torch.contrib import slim
    from paddle_tpu_torch.models import bert
    marks = [("start", time.perf_counter())]
    cfg = bert.bert_base()
    start = ptt.Scope()
    main, startup, fetch_list = _qat_bert_program(ptt, bert, cfg,
                                                  TRAIN_BATCH, start)
    fq = _fake_quant_counts(main)
    states = _moving_states(main)
    feed = bert.synthetic_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, TRAIN_PREDS,
                                seed=0)
    record, both_ok, (_, final), start, launches = _both_ways(
        torch, np, ptt, counters, "slim_bert", main, startup, feed,
        fetch_list + [_dropout_mask(main)], TRAIN_PER_STEP, TRAIN_FAMILIES,
        start=start)
    marks.append(("train_both_ways", time.perf_counter()))
    losses = record["losses"]["graphed"]
    falling = losses[-1] < losses[0]
    closed, state_err = _states_closed_form(np, final, states, GRAPH_STEPS)
    plain_ms = _plain_step_ms(torch, np, ptt, cfg, TRAIN_BATCH, feed)
    marks.append(("plain_step", time.perf_counter()))
    chain = _fake_quant_ms(torch, ptt, main, start, feed, fetch_list)
    marks.append(("fake_quant_profile", time.perf_counter()))
    scope = ptt.Scope()
    for name, value in final.items():
        scope.set_var(name, value)
    infer = main.clone(for_test=True)
    scales = slim.convert(infer, scope=scope)
    left = _fake_quant_counts(infer)
    w_scales = scales["weights"]
    convert_ok = (left[FAKE_QUANT_OPS[1]] == 0 and
                  left[FAKE_QUANT_OPS[2]] == fq[FAKE_QUANT_OPS[2]] and
                  len(w_scales) == fq[FAKE_QUANT_OPS[2]] and
                  all((np.asarray(s) > 0).all() for s in w_scales.values())
                  and len(scales["activations"]) == fq[FAKE_QUANT_OPS[1]])
    serve_rec, serve_ok = _slim_serve(torch, np, ptt, infer, scope, cfg,
                                      root)
    marks.append(("convert_serve_int8", time.perf_counter()))
    del scope, final
    pcfg = bert.bert_base(hidden_dropout=0.0, attn_dropout=0.0,
                          **SLIM_PARITY)
    pstate = ptt.Scope()
    pmain, pstart, pfetch = _qat_bert_program(ptt, bert, pcfg, PARITY_BATCH,
                                              pstate)
    parity, parity_ok = _card_vs_cpu(
        np, ptt, pmain, pstart, pfetch, bert.synthetic_batch(
            pcfg, PARITY_BATCH, TRAIN_SEQ, TRAIN_PREDS, seed=1),
        dtype=SLIM_PARITY_DTYPE, state=pstate)
    marks.append(("parity", time.perf_counter()))
    ok = (both_ok and falling and state_err <= SLIM_STATE_RTOL and
          convert_ok and serve_ok and parity_ok)
    emit(dict({"phase": "slim_bert", "ok": ok, "model": "bert_base",
               "dtype": "float32", "batch": TRAIN_BATCH,
               "seq_len": TRAIN_SEQ, "dropout": cfg.hidden_dropout,
               "optimizer": "Adam(1e-4)", "moving_rate": SLIM_RATE,
               "fake_quant_ops": fq, "moving_averages": len(states),
               "program_ops": len(main.global_block().ops),
               "losses_falling": falling,
               "state_closed_form": closed, "state_max_rel_err": state_err,
               "state_rtol": SLIM_STATE_RTOL,
               "plain_step_replay_ms": plain_ms,
               "fake_quant_chain": chain, "convert_ok": convert_ok,
               "ops_after_convert": left,
               "activation_scales": len(scales["activations"]),
               "serve": serve_rec, "parity_config": SLIM_PARITY,
               "parity": parity,
               "seconds": {b[0]: b[1] - a[1] for a, b in zip(marks,
                                                             marks[1:])}},
              **record))
    if not ok:
        raise AssertionError("slim_bert checks failed (see the line above)")
    return launches


def _conv_filters(main):
    return [op.input("Filter")[0] for op in main.global_block().ops
            if op.type in ("conv2d", "depthwise_conv2d")]


def _numpy_filter_mask(np, value, ratio):
    """StructurePruner(ratio, axis=0)'s mask of a filter, by numpy alone:
    the int(ratio * O) output channels of least L1 norm zeroed."""
    norms = np.abs(value).sum(axis=tuple(range(1, value.ndim)))
    keep = np.ones(value.shape[0], np.float32)
    keep[np.argsort(norms)[:int(value.shape[0] * ratio)]] = 0.0
    return np.broadcast_to(keep.reshape((-1,) + (1,) * (value.ndim - 1)),
                           value.shape)


def _slim_qat_resnet(torch, np, ptt, counters, resnet):
    """ResNet-50 quant-aware at SLIM_RESNET_BATCH: a warm run and
    SLIM_RESNET_GRAPHED graphed steps (_steps: the counters set to 0 just
    before). (record, ok, launches)."""
    from paddle_tpu_torch.contrib import slim
    start = ptt.Scope()
    main, startup, fetch_list, feed = _resnet_program(
        np, ptt, resnet, SLIM_RESNET_BATCH,
        before=lambda loss: slim.quant_aware(loss.block.program,
                                             moving_rate=SLIM_RATE,
                                             scope=start))
    fq = _fake_quant_counts(main)
    exe = ptt.Executor()
    exe.run(startup, scope=start)
    runs = 1 + SLIM_RESNET_GRAPHED
    step_ms, losses, per_step, launches = _steps(
        torch, np, ptt, counters, exe, main, start, feed, fetch_list, runs)
    states = _moving_states(main)
    closed, state_err = _states_closed_form(
        np, {n: start.find_var(n) for n in states}, states, runs)
    graphs = dict(exe.graph_runs)
    close_executor(torch, "slim_vision qat", exe)
    finite = all(np.isfinite(v) for row in losses for v in row)
    descends = losses[1][0] < losses[0][0]
    counts_ok = all(c == _no_launches(counters) for c in per_step)
    ok = (finite and descends and counts_ok
          and state_err <= SLIM_STATE_RTOL
          and graphs["capture"] == 1 and
          graphs["replay"] == SLIM_RESNET_GRAPHED - 1 and
          fq[FAKE_QUANT_OPS[2]] == len(_conv_filters(main)) + 1)
    return {"fake_quant_ops": fq, "filters": len(_conv_filters(main)),
            "step_ms": step_ms, "replay_ms_median":
            statistics.median(step_ms[2:]), "losses": losses,
            "finite": finite, "first_update_descends": descends,
            "graph_runs": graphs, "launches_per_step_ok": counts_ok,
            "state_max_rel_err": state_err, "state_closed_form": closed,
            "ok": ok}, ok, launches


def _slim_prune(torch, np, ptt, slim, resnet, exe, main, scope, feed,
                fetch_list):
    """StructurePruner(SLIM_PRUNE_RATIO, axis=0) over every conv filter of
    the started ``main``, masks against ``_numpy_filter_mask`` of the
    same host values, then SLIM_RESNET_GRAPHED replayed steps with
    ``apply_masks`` after each; then the sensitivity sweep of three
    parameters on the model's forward and loss, weights restored bit for
    bit. (record, ok)."""
    from paddle_tpu_torch.framework.scope import to_numpy
    filters = _conv_filters(main)
    host = {f: to_numpy(scope.find_var(f)) for f in filters}
    helper = slim.PruneHelper(main, {f: SLIM_PRUNE_RATIO for f in filters},
                              pruner_cls=slim.StructurePruner, scope=scope,
                              axis=0)
    masks = helper.compute_masks()
    masks_equal = all(np.array_equal(
        to_numpy(masks[f]), _numpy_filter_mask(np, host[f],
                                               SLIM_PRUNE_RATIO))
        for f in filters)
    helper.apply_masks()
    replays, ms = exe.graph_runs["replay"], []
    for _ in range(SLIM_RESNET_GRAPHED):
        t0 = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=fetch_list, scope=scope)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        helper.apply_masks()
    replayed = exe.graph_runs["replay"] - replays
    zeros = total = 0
    live_ok = True
    for f in filters:
        w = to_numpy(scope.find_var(f))
        zeros += int((w == 0).sum())
        total += w.size
        live = int((np.abs(w).reshape(w.shape[0], -1).sum(1) > 0).sum())
        live_ok = live_ok and live == w.shape[0] - int(
            w.shape[0] * SLIM_PRUNE_RATIO) and \
            not w[to_numpy(masks[f]) == 0].any()
    # the forward and loss alone (batch norm on batch statistics, as the
    # steps ran it: after a few steps the moving ones are still far off)
    with ptt.unique_name.guard():
        fwd, _, _, fwd_fetch = resnet.resnet_train_program(
            depth=50, class_dim=RESNET_CLASSES, image_shape=(3, 224, 224))
    probed = [filters[0], filters[len(filters) // 2], "fc_0.w_0"]
    before = {n: scope.find_var(n).clone() for n in probed}
    t0 = time.perf_counter()
    base, report = slim.sensitivity(
        fwd, exe, feed, fwd_fetch["loss"], param_names=probed,
        ratios=SLIM_SENSITIVITY_RATIOS, scope=scope)
    sens_s = time.perf_counter() - t0
    restored = all(torch.equal(scope.find_var(n), before[n]) for n in probed)
    finite = np.isfinite(base) and all(
        np.isfinite(v) for r in report.values() for v in r.values())
    ok = (masks_equal and helper.sparsity() == SLIM_PRUNE_RATIO and
          live_ok and replayed == SLIM_RESNET_GRAPHED and restored and
          finite and len(report) == SLIM_SENSITIVITY_PARAMS)
    return {"filters": len(filters), "masks_equal_numpy": masks_equal,
            "sparsity": helper.sparsity(), "zero_share": zeros / total,
            "live_channels_ok": live_ok, "step_ms": ms,
            "replayed": replayed, "sensitivity_base": base,
            "sensitivity": {n: {str(k): v for k, v in r.items()}
                            for n, r in report.items()},
            "sensitivity_s": sens_s, "weights_restored": restored,
            "ok": ok}, ok


def _distill_programs(ptt, slim, resnet, vision, scope):
    """A ResNet-50 teacher (is_test, started in ``scope``) merged into a
    MobileNet v1 student's program, whose loss is its cross-entropy plus
    ``soft_label_loss`` of its logits against the teacher's at
    SLIM_DISTILL_T, under Momentum(SLIM_DISTILL_LR, 0.9): (main, startup,
    [loss, ce, soft], the teacher's parameters in the student)."""
    layers = ptt.layers
    image = [3, 224, 224]
    teacher, t_start = ptt.Program(), ptt.Program()
    t_start.random_seed = SEED
    with ptt.unique_name.guard(), ptt.program_guard(teacher, t_start):
        img = layers.data("image", image, "float32")
        t_logits = resnet.resnet(img, RESNET_CLASSES, 50, is_test=True)
    ptt.Executor().run(t_start, scope=scope)
    main, startup = ptt.Program(), ptt.Program()
    startup.random_seed = SEED + 1
    with ptt.unique_name.guard(), ptt.program_guard(main, startup):
        img = layers.data("image", image, "float32")
        label = layers.data("label", [1], "int64")
        prob = vision.mobilenet_v1(img, RESNET_CLASSES)
        softmax = main.global_block().ops[-1]
        s_logits = main.global_block().var(softmax.input("X")[0])
        ce = layers.reduce_mean(layers.cross_entropy(prob, label))
        var_map = slim.merge(teacher, main, scope=scope)
        soft = slim.soft_label_loss(s_logits, var_map[t_logits.name],
                                    SLIM_DISTILL_T, SLIM_DISTILL_T)
        loss = layers.elementwise_add(ce, soft)
        ptt.optimizer.Momentum(SLIM_DISTILL_LR, 0.9).minimize(loss)
    taught = ["teacher_" + p.name for p in teacher.all_parameters()]
    return main, startup, [loss, ce, soft], taught


def _slim_distill(torch, np, ptt, slim, resnet, vision, root):
    """The Compressor over the distillation program: SLIM_DISTILL_EPOCHS
    epochs of SLIM_DISTILL_STEPS steps on one batch, a recording strategy,
    an eval of the test clone an epoch, a checkpoint an epoch. (record,
    ok)."""
    scope = ptt.Scope()
    main, startup, fetch_list, taught = _distill_programs(
        ptt, slim, resnet, vision, scope)
    ptt.Executor().run(startup, scope=scope)
    teacher = {n: scope.find_var(n).clone() for n in taught}
    eval_prog = main.clone(for_test=True)
    feed = {"image": np.random.RandomState(2).rand(
        SLIM_RESNET_BATCH, 3, 224, 224).astype(np.float32),
        "label": np.random.RandomState(3).randint(
            0, RESNET_CLASSES, (SLIM_RESNET_BATCH, 1)).astype(np.int64)}
    hooks, losses, step_ms = [], [], []

    class Recorder(object):
        def on_compression_begin(self, ctx):
            hooks.append("begin")

        def on_epoch_begin(self, ctx):
            hooks.append("epoch_begin %d" % ctx.epoch_id)

        def on_epoch_end(self, ctx):
            hooks.append("epoch_end %d" % ctx.epoch_id)

        def on_compression_end(self, ctx):
            hooks.append("end")

    def train_fn(exe):
        for _ in range(SLIM_DISTILL_STEPS):
            t0 = time.perf_counter()
            out = exe.run(main, feed=feed, fetch_list=fetch_list)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append([float(np.asarray(o).reshape(())) for o in out])

    def eval_fn(exe):
        out = exe.run(eval_prog, feed=feed, fetch_list=fetch_list)
        return {"loss": float(np.asarray(out[0]).reshape(()))}
    ck = os.path.join(root, "distill_ckpt")
    t0 = time.perf_counter()
    comp = slim.Compressor(ptt.CUDAPlace(0), scope, main,
                           epoch=SLIM_DISTILL_EPOCHS, strategies=[Recorder()],
                           train_fn=train_fn, eval_fn=eval_fn,
                           checkpoint_path=ck)
    ctx = comp.run()
    seconds = time.perf_counter() - t0
    close_executor(torch, "slim_vision distill", comp._exe)
    want_hooks = ["begin"] + [h % e for e in range(SLIM_DISTILL_EPOCHS)
                              for h in ("epoch_begin %d", "epoch_end %d")]
    want_hooks.append("end")
    unchanged = all(torch.equal(scope.find_var(n), t)
                    for n, t in teacher.items())
    steps = sorted(d for d in os.listdir(ck) if d.startswith("step_"))
    finite = all(np.isfinite(v) for row in losses for v in row)
    ok = (hooks == want_hooks and finite and losses[-1][0] < losses[0][0]
          and unchanged and bool(teacher) and
          os.path.exists(os.path.join(ck, "latest")) and
          len(steps) == SLIM_DISTILL_EPOCHS and
          len(ctx.eval_results["loss"]) == SLIM_DISTILL_EPOCHS)
    return {"teacher": "resnet50", "student": "mobilenet_v1",
            "batch": SLIM_RESNET_BATCH, "temperature": SLIM_DISTILL_T,
            "teacher_parameters": len(teacher), "hooks": hooks,
            "losses": losses, "step_ms": step_ms,
            "eval_losses": ctx.eval_results["loss"],
            "teacher_unchanged": unchanged, "checkpoints": steps,
            "seconds": seconds, "ok": ok}, ok


def _nas_round_trip():
    """ControllerServer on 127.0.0.1 (port 0) with an SAController, a
    SearchAgent asking it for SLIM_NAS_STEPS tokens and reporting
    rewards, beside an in-process SAController of the same seed."""
    from paddle_tpu_torch.contrib.slim.nas import (ControllerServer,
                                                   SearchAgent)
    from paddle_tpu_torch.contrib.slim.searcher import SAController
    served, local = SAController(seed=SEED), SAController(seed=SEED)
    for c in (served, local):
        c.reset(SLIM_NAS_TABLE, [0] * len(SLIM_NAS_TABLE))
    server = ControllerServer(served, address=("127.0.0.1", 0))
    ip, port = server.start()
    got, want = [], []
    try:
        agent = SearchAgent(ip, port)
        for _ in range(SLIM_NAS_STEPS):
            tokens, mine = agent.next_tokens(), local.next_tokens()
            reward = float(-sum((t - 2) ** 2 for t in tokens))
            agent.update(tokens, reward)
            local.update(mine, reward)
            got.append(tokens)
            want.append(mine)
    finally:
        server.close()
    return {"address": ip, "tokens": got, "equal": got == want,
            "best": served.best_tokens, "ok": got == want}, got == want


def slim_vision(torch, np, ptt, counters, root):
    """ResNet-50 at SLIM_RESNET_BATCH x 3 x 224 x 224 quant-aware (per
    channel on every conv filter, axis 0, and on the fc, axis 1): a warm
    run and SLIM_RESNET_GRAPHED graphed steps, the step ms beside the
    unquantized ResNet-50's at the same batch; that unquantized model
    pruned (_slim_prune) and swept for sensitivity; a ResNet-50 teacher
    distilled into MobileNet v1 by the Compressor (_slim_distill); the
    NAS controller server on loopback (_nas_round_trip). No hand-written
    kernel on these paths: the counters stay at 0."""
    from paddle_tpu_torch.contrib import slim
    from paddle_tpu_torch.models import resnet, vision
    qat, qat_ok, launches = _slim_qat_resnet(torch, np, ptt, counters,
                                             resnet)
    main, startup, fetch_list, feed = _resnet_program(np, ptt, resnet,
                                                      SLIM_RESNET_BATCH)
    scope, exe = ptt.Scope(), ptt.Executor()
    exe.run(startup, scope=scope)
    plain_ms, plain_losses, _, _ = _steps(
        torch, np, ptt, counters, exe, main, scope, feed, fetch_list,
        1 + SLIM_RESNET_GRAPHED)
    pruned, prune_ok = _slim_prune(torch, np, ptt, slim, resnet, exe, main,
                                   scope, feed, fetch_list)
    close_executor(torch, "slim_vision prune", exe)
    del scope
    distill, distill_ok = _slim_distill(torch, np, ptt, slim, resnet, vision,
                                        root)
    nas, nas_ok = _nas_round_trip()
    ok = qat_ok and prune_ok and distill_ok and nas_ok and \
        not any(launches.values())
    emit({"phase": "slim_vision", "ok": ok, "model": "resnet50",
          "batch": SLIM_RESNET_BATCH, "optimizer": "Momentum(0.1, 0.9)",
          "quant_aware": qat, "plain_step_ms": plain_ms,
          "plain_replay_ms_median": statistics.median(plain_ms[2:]),
          "plain_losses": plain_losses, "prune": pruned,
          "distill": distill, "nas": nas, "launches": launches})
    if not ok:
        raise AssertionError("slim_vision checks failed (see the line "
                             "above)")
    return launches


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
        from paddle_tpu_torch.ops.kernels import numeric_guard as ng
    except ImportError as e:
        print("chip_smoke: run it from a checkout of the repository "
              "(%s)" % e, file=sys.stderr)
        return 2
    import torch.nn.functional as F
    from paddle_tpu_torch.framework.executor import set_precision
    set_precision()                          # no TF32 anywhere
    counters = Counters(fa, ln, fad, bce, ng)
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
        found["finite_flags"], found["guarded_copy"] = guard_cases(
            torch, ng, ptt)
        nan_flash, nan_ce = nan_cases(torch, fa, bce)
        found["flash_attention_fwd"] += nan_flash
        found["ce_fwd"] += nan_ce
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
    s2s_done = phase("seq2seq_train")(seq2seq_train)(torch, np, ptt,
                                                     counters)
    finish("seq2seq_train", s2s_done, "seq2seq train step", host=True)
    s2s_dir = os.path.join(_ROOT, "build", "chip_smoke_seq2seq")
    try:
        by_path["seq2seq_serve"] = phase("seq2seq_serve")(seq2seq_serve)(
            torch, np, ptt, counters, s2s_dir,
            None if s2s_done is None else s2s_done[1][2])
    finally:
        shutil.rmtree(s2s_dir, ignore_errors=True)
    del s2s_done
    by_path["control_flow"] = phase("control_flow")(control_flow)(
        torch, np, ptt, counters)
    phase("seq2seq_parity")(seq2seq_parity)(torch, np, ptt)
    by_path["vision_train"] = phase("vision_train")(vision_train)(
        torch, np, ptt, counters)
    by_path["yolo_train"] = phase("yolo_train")(yolo_train)(
        torch, np, ptt, counters)
    yolo_dir = os.path.join(_ROOT, "build", "chip_smoke_yolo")
    try:
        by_path["yolo_serve"] = phase("yolo_serve")(yolo_serve)(
            torch, np, ptt, counters, yolo_dir)
    finally:
        shutil.rmtree(yolo_dir, ignore_errors=True)
    by_path["dcgan_train"] = phase("dcgan_train")(dcgan_train)(
        torch, np, ptt, counters)
    by_path["simple_train"] = phase("simple_train")(simple_train)(
        torch, np, ptt, counters)
    zoo_dir = os.path.join(_ROOT, "build", "chip_smoke_zoo")
    try:
        phase("zoo_parity")(zoo_parity)(torch, np, ptt, counters, zoo_dir)
    finally:
        shutil.rmtree(zoo_dir, ignore_errors=True)

    by_path["compiled_recipe"] = phase("compiled_recipe")(compiled_recipe)(
        torch, np, ptt, counters)
    by_path["numeric_skip"] = phase("numeric_skip")(numeric_skip)(
        torch, np, ptt, counters)
    by_path["resilient_recipe"] = phase("resilient_recipe")(
        resilient_recipe)(torch, np, ptt, counters)
    by_path["pod_recipe"] = phase("pod_recipe")(pod_recipe)(
        torch, np, ptt, counters)
    phase("compiled_parity")(compiled_parity)(torch, np, ptt)

    dy_done = phase("dygraph_gpt")(dygraph_gpt)(torch, np, ptt, counters)
    by_path["dygraph_gpt"] = None if dy_done is None else dy_done[0]
    by_path["dygraph_traced"] = None
    if dy_done is not None:
        by_path["dygraph_traced"] = phase("dygraph_traced")(
            dygraph_traced)(torch, np, ptt, counters, dy_done[1])
    del dy_done
    phase("dygraph_parity")(dygraph_parity)(torch, np, ptt)
    phase("dygraph_zoo")(dygraph_zoo)(torch, np, ptt)

    by_path["book"] = phase("book")(book)(torch, np, ptt, counters)
    phase("book_parity")(book_parity)(torch, np, ptt, counters)
    phase("op_library")(op_library)(torch, np, ptt, counters)

    recipe = phase("verifier")(verifier)(torch, np, ptt)
    art_dir = os.path.join(_ROOT, "build", "chip_smoke_artifact")
    by_path["fluid_surface"] = None
    try:
        art = phase("serving_artifact")(serving_artifact)(
            torch, np, ptt, counters, art_dir)
        if art is not None:
            by_path["fluid_surface"] = phase("fluid_surface")(
                fluid_surface)(torch, np, ptt, counters, art_dir)
    finally:
        shutil.rmtree(art_dir, ignore_errors=True)
    by_path["serving_artifact"] = None if art is None else art[0]
    if art is not None and recipe is not None:
        phase("spans")(spans)(torch, np, ptt, art[1], art[2], recipe)
    del art, recipe

    amp = phase("amp_bert")(amp_bert)(torch, np, ptt, counters)
    by_path["amp_bert_bf16"] = None if amp is None else amp[0]["bf16"]
    by_path["amp_bert_fp16"] = None if amp is None else amp[0]["fp16"]
    f16_launches = {} if amp is None else amp[2]
    phase("amp_parity")(amp_parity)(torch, np, ptt)
    by_path["amp_resnet"] = phase("amp_resnet")(amp_resnet)(
        torch, np, ptt, counters)
    by_path["grad_merge"] = phase("grad_merge")(grad_merge)(
        torch, np, ptt, counters)
    contrib_dir = os.path.join(_ROOT, "build", "chip_smoke_contrib")
    try:
        by_path["contrib_surface"] = phase("contrib_surface")(
            contrib_surface)(torch, np, ptt, counters,
                             None if amp is None else amp[1], contrib_dir)
    finally:
        shutil.rmtree(contrib_dir, ignore_errors=True)
    del amp
    by_path["vision_extras"] = phase("vision_extras")(vision_extras)(
        torch, np, ptt, counters)
    by_path["detection_ssd"] = phase("detection_ssd")(detection_ssd)(
        torch, np, ptt, counters)
    by_path["detection_rcnn"] = phase("detection_rcnn")(detection_rcnn)(
        torch, np, ptt, counters)
    by_path["detection_ops"] = phase("detection_ops")(detection_ops)(
        torch, np, ptt, counters)
    slim_dir = os.path.join(_ROOT, "build", "chip_smoke_slim")
    try:
        by_path["slim_bert"] = phase("slim_bert")(slim_bert)(
            torch, np, ptt, counters, slim_dir)
        by_path["slim_vision"] = phase("slim_vision")(slim_vision)(
            torch, np, ptt, counters, slim_dir)
    finally:
        shutil.rmtree(slim_dir, ignore_errors=True)

    emit({"phase_seconds": _seconds})
    if _failed or cases is None or None in by_path.values():
        print("chip_smoke: failed phases: %s" % _failed, file=sys.stderr)
        return 1
    summary = [
        _summary(name, "paddle_tpu_torch/ops/kernels/csrc/" + src, replaces,
                 {path: n.get(name, 0) for path, n in by_path.items()},
                 cases[name], f16_launches.get(name))
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


def _summary(name, source, replaces, launches_by_path, cases,
             f16_launches=None):
    """A kernel's line: its numbers at the main path's shape (the first
    case: BERT-base serving at the largest bucket for the flash and
    LayerNorm forward kernels, the BERT-base training step's shapes for
    their backward kernels and Adam, GPT-base's head and logits for the
    head and CE kernels), every case beside them. ``launches`` sums the
    main paths' runs. A flash line also gives its fp16 cases' numbers
    (``float16``; the first at amp_bert's fp16 step's shape) with
    ``f16_launches``, the launches of its fp16 instantiation on amp_bert's
    fp16 path. The
    fused-Adam line also gives its first AdamW
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
    f16 = sorted((c for c in cases if c.get("dtype") == "float16"),
                 key=lambda c: not c["name"].startswith("bert_train_b128"))
    if f16:
        line["float16"] = dict(
            cases=[dict({k: c[k] for k in keys}, shape=c["shape"])
                   for c in f16],
            launches=f16_launches)
    deepfm = [c for c in cases if c["name"] == "deepfm_embedding"]
    if deepfm:
        line["deepfm_embedding"] = dict(
            {k: deepfm[0][k] for k in keys + ("numel",)},
            launches=launches_by_path.get("deepfm_train"))
    return line


if __name__ == "__main__":
    sys.exit(main())
