"""bf16 training and decode of BERT and GPT: the port against the JAX
package.

``BertConfig(dtype="bfloat16")`` and ``GPTConfig(dtype="bfloat16")`` run
the transformer layers in bf16: bf16 weights and activations, f32
embeddings, LayerNorm parameters, Adam moments and loss. A tiny model of
each (2 layers, hidden 64, 4 heads, T = 16; BERT vocab 512 with 4 masked
positions a sequence, GPT vocab 256) trains three Adam steps in both
packages, the port starting from the JAX scope's weights and optimizer
state (``set_params_from_numpy``), through the JAX package's default
Executor (its XLA lowering) and, for GPT, through ``CompiledProgram``
with its Pallas kernels in interpret mode (the fused head, LayerNorm,
flash attention and Adam; marked slow).

Tolerances, and why. The two packages round to bf16 at different points
(attention probabilities, GELU, the bias add) and sum in another order, so
a bf16 value may differ by an ulp or two (2^-8 relative each):

- per-step losses rtol 2e-4: each is a mean over tokens of an f32 CE of
  f32 logits, where per-element bf16 differences average out (measured
  9e-6 to 2.6e-5);
- first-step gradients within a share of each tensor's largest
  magnitude, plus 1e-6: 2^-5 for a matrix (measured under 1e-2 of its
  largest), 2^-4 for a vector. A bias or LayerNorm gradient is a sum over
  the batch's 64-128 tokens of per-token bf16 values that largely cancel,
  each a few bf16 ulps apart between the packages (measured up to 3.7e-2,
  the v part of GPT's ``qkv`` bias at 128 tokens). An attention key
  bias's gradient is zero in exact arithmetic (softmax does not see a
  shift along the keys), so only rounding noise of ~1e-7 is left, which
  the absolute 1e-6 of the f32 tests covers;
- final parameters within 2 * STEPS * LR plus one bf16 ulp of the
  tensor's largest value: Adam moves an element by about LR a step
  whatever its gradient's size, so an element whose gradient is near zero
  may step the other way when rounding flips its sign;
- each parameter tensor's change from its start as the JAX package's:
  the sum of |port's final - JAX's final| within CHANGE_RTOL (0.25) of
  the sum of |JAX's change|, so a tensor the port did not update, or
  stepped the wrong way, misses by its whole change. Measured up to 0.17
  (GPT's ``qkv`` bias, whose key third has only rounding noise for a
  gradient), 0.05 or less elsewhere. A tensor whose whole first-step
  gradient is rounding noise (BERT's attention key biases, largest
  element ~5e-8, under GRAD_NOISE) steps at random in both packages and
  is held to the bound above only.

A one-step case at GPT's vocabulary (32000, where the head op takes the
fused-head route at 128 tokens, plain versions on the CPU) holds the bf16
head, and greedy decode of a bf16 GPT gives the JAX package's tokens.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.framework.compiler import BuildStrategy, CompiledProgram
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.framework.scope import to_numpy
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import gpt as tgpt

STEPS, LR, PREDS = 3, 1e-3, 4
MODELS = {"bert": (jbert, tbert), "gpt": (jgpt, tgpt)}
TINY = {"bert": dict(vocab_size=512, hidden_size=64, num_layers=2,
                     num_heads=4, ff_size=128, max_position=64,
                     hidden_dropout=0.0, attn_dropout=0.0),
        "gpt": dict(vocab_size=256, hidden_size=64, num_layers=2,
                    num_heads=4, ff_size=128, max_position=64,
                    dropout=0.0)}
SHAPE = {"bert": (2, 16), "gpt": (4, 16)}      # batch, seq
BF16_ULP = 2.0 ** -8
GRAD_NOISE, CHANGE_RTOL = 1e-6, 0.25


def config(pkg, model, **kw):
    mod = MODELS[model][0 if pkg is pt else 1]
    cls = mod.BertConfig if model == "bert" else mod.GPTConfig
    return cls(**dict(TINY[model], **kw))


def program(pkg, model, cfg, batch, seq, lr=LR):
    """(main, startup, loss var) of the model's pretraining program with
    ``Adam(lr)``."""
    mod = MODELS[model][0 if pkg is pt else 1]

    def opt(loss):
        return pkg.optimizer.Adam(lr).minimize(loss)
    with pkg.unique_name.guard():
        if model == "bert":
            main, startup, _, fetch = mod.bert_pretrain_program(
                cfg, batch, seq, PREDS, optimizer_fn=opt)
        else:
            main, startup, _, fetch = mod.gpt_pretrain_program(
                cfg, batch, seq, optimizer_fn=opt)
    return main, startup, fetch["loss"]


def batch_feed(model, cfg, batch, seq, seed=0):
    if model == "bert":
        return jbert.synthetic_batch(cfg, batch, seq, PREDS, seed=seed)
    return jgpt.synthetic_batch(cfg, batch, seq, seed=seed)


def jax_program(main, route):
    """What the JAX Executor runs: ``main`` (its XLA lowering) or, for
    route "pallas_interpret", ``main`` compiled with its Pallas kernels
    (in interpret mode on the CPU)."""
    if route == "xla":
        return main
    bs = BuildStrategy()
    bs.mesh_axes = {"dp": 1}
    bs.use_pallas = frozenset({"fused_mlm_head_loss", "layer_norm", "adam"})
    bs.kernel_policy = "pallas"
    return CompiledProgram(main, bs)


def jax_train(model, steps=STEPS, batch=None, seq=None, route="xla", **kw):
    """Train in the JAX package: (initial persistables, losses, first-step
    gradients {name: f32 array}, final parameters, feed)."""
    batch, seq = batch or SHAPE[model][0], seq or SHAPE[model][1]
    cfg = config(pt, model, **kw)
    main, startup, loss = program(pt, model, cfg, batch, seq)
    params = [p.name for p in main.all_parameters()]
    grads = [p + "@GRAD" for p in params]
    feed = batch_feed(model, cfg, batch, seq)
    scope = pt.Scope()
    with pt.scope_guard(scope):
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup)
        init = {v.name: np.asarray(scope.find_var(v.name))
                for v in main.list_vars() if v.persistable}
        prog = jax_program(main, route)
        runs = [exe.run(prog, feed=feed,
                        fetch_list=[loss] + (grads if s == 0 else []))
                for s in range(steps)]
        final = {p: np.asarray(scope.find_var(p)).astype(np.float32)
                 for p in params}
    losses = [float(np.asarray(r[0]).reshape(())) for r in runs]
    first = {g: np.asarray(v).astype(np.float32)
             for g, v in zip(grads, runs[0][1:])}
    return init, losses, first, final, feed


def port_train(model, init, feed, steps=STEPS, batch=None, seq=None,
               **kw):
    """The same steps in the port from ``init``: (losses, first-step
    gradients, final parameters, the Program)."""
    batch, seq = batch or SHAPE[model][0], seq or SHAPE[model][1]
    cfg = config(ptt, model, **kw)
    main, _, loss = program(ptt, model, cfg, batch, seq)
    params = [p.name for p in main.all_parameters()]
    grads = [p + "@GRAD" for p in params]
    scope = ptt.Scope()
    ptt.set_params_from_numpy(init, main, scope, ptt.CPUPlace())
    with ptt.scope_guard(scope):
        exe = ptt.Executor(ptt.CPUPlace())
        runs = [exe.run(main, feed=feed,
                        fetch_list=[loss] + (grads if s == 0 else []))
                for s in range(steps)]
        final = {p: to_numpy(scope.find_var(p)) for p in params}
    losses = [float(r[0].reshape(())) for r in runs]
    return losses, dict(zip(grads, runs[0][1:])), final, main


def assert_bf16_close(jax_run, port_run, steps=STEPS):
    init, jloss, jgrads, jfinal, _ = jax_run
    tloss, tgrads, tfinal, _ = port_run
    np.testing.assert_allclose(tloss, jloss, rtol=2e-4)
    for name, want in jgrads.items():
        err = np.abs(tgrads[name] - want).max()
        share = 2.0 ** -5 if want.ndim > 1 else 2.0 ** -4
        assert err <= share * np.abs(want).max() + 1e-6, (name, err)
    for name, want in jfinal.items():
        bound = 2 * steps * LR + BF16_ULP * np.abs(want).max()
        err = np.abs(tfinal[name] - want).max()
        assert err <= bound, (name, err, bound)
        if np.abs(jgrads[name + "@GRAD"]).max() <= GRAD_NOISE:
            continue
        start = np.asarray(init[name]).astype(np.float32)
        change = np.abs(tfinal[name] - want).sum() / np.abs(
            want - start).sum()
        assert change <= CHANGE_RTOL, (name, change)


@pytest.mark.parametrize("model,route", [
    ("bert", "xla"), ("gpt", "xla"),
    pytest.param("gpt", "pallas_interpret", marks=pytest.mark.slow)])
def test_bf16_trains_like_jax(model, route):
    kw = dict(dtype="bfloat16")
    if route == "pallas_interpret":
        kw["attn_impl"] = "flash"
    run = jax_train(model, route=route, seq=32 if model == "gpt" else None,
                    **kw)
    init = run[0]
    assert {a.dtype.name for a in init.values()} == {"bfloat16", "float32"}
    moments = [n for n in init if "moment" in n]
    assert moments and all(init[n].dtype == np.float32 for n in moments)
    port = port_train(model, init, run[4],
                      seq=32 if model == "gpt" else None, **kw)
    assert_bf16_close(run, port)
    assert port[0][-1] < port[0][0]             # it trained
    main = port[3]
    bf16 = [p.name for p in main.all_parameters() if p.dtype == "bfloat16"]
    assert len(bf16) == 8 * TINY[model]["num_layers"] + \
        (4 if model == "bert" else 0) * TINY[model]["num_layers"]


def test_bf16_head_at_gpt_vocabulary():
    """One step with GPT's vocabulary, 32000, at 4 x 32 tokens: the port's
    head op takes the fused-head autograd Function (bf16 operands, f32
    sums), the JAX package's default Executor its XLA lowering."""
    from paddle_tpu_torch.ops.nn_ops import blockwise_kernel_would_tile
    assert blockwise_kernel_would_tile(128, 32000, 64)
    kw = dict(dtype="bfloat16", vocab_size=32000, num_layers=1)
    run = jax_train("gpt", steps=1, seq=32, **kw)
    port = port_train("gpt", run[0], run[4], steps=1, seq=32, **kw)
    assert_bf16_close(run, port, steps=1)


def test_bf16_greedy_decode_matches_jax():
    """Same weights, same prompt, a bf16 GPT: the JAX package's greedy
    tokens; the logits come back f32 (``matmul(out_dtype="float32")``)."""
    jcfg = config(pt, "gpt", dtype="bfloat16")
    tcfg = config(ptt, "gpt", dtype="bfloat16")
    prompt = np.random.RandomState(7).randint(0, 256, (3, 6))
    with pt.unique_name.guard():
        jprog = jgpt.gpt_logits_program(jcfg, 10)
    with ptt.unique_name.guard():
        tprog = tgpt.gpt_logits_program(tcfg, 10)
    jscope = pt.Scope()
    with pt.scope_guard(jscope):
        exe = pt.Executor(pt.CPUPlace())
        exe.run(jprog[1])
        init = {v.name: np.asarray(jscope.find_var(v.name))
                for v in jprog[0].list_vars() if v.persistable}
        jtoks = jgpt.greedy_generate(exe, jcfg, prompt, 4,
                                     logits_program=jprog)
    tscope = ptt.Scope()
    ptt.set_params_from_numpy(init, tprog[0], tscope, ptt.CPUPlace())
    exe = ptt.Executor(ptt.CPUPlace())
    with ptt.scope_guard(tscope):
        ttoks = tgpt.greedy_generate(exe, tcfg, prompt, 4,
                                     logits_program=tprog)
        logits, = exe.run(tprog[0], feed={
            "token_ids": ttoks[:, :, None],
            "pos_ids": np.tile(np.arange(10).reshape(1, 10, 1), (3, 1, 1))},
            fetch_list=[tprog[3]["logits"]], return_numpy=False)
    np.testing.assert_array_equal(ttoks, jtoks)
    assert logits.dtype == ptt.framework.dtypes.to_torch_dtype("float32")


def test_bf16_bert_trained_in_the_port_serves_from_its_directory(tmp_path):
    """A bf16 BERT trained two steps in the port, its encoder saved
    (bf16 weights as uint16 bits, "bfloat16" in the manifest), served by
    ``create_predictor`` on the CPU: the answers equal, bit for bit, what
    the Executor gives on the trained scope."""
    from paddle_tpu_torch.inference import Config, create_predictor
    import json
    import os
    cfg = config(ptt, "bert", dtype="bfloat16")
    batch, seq = SHAPE["bert"]
    main, startup, loss = program(ptt, "bert", cfg, batch, seq)
    feed = batch_feed("bert", cfg, batch, seq)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    names = ["src_ids", "pos_ids", "sent_ids", "input_mask"]
    with ptt.scope_guard(scope):
        exe.run(startup)
        for _ in range(2):
            exe.run(main, feed=feed, fetch_list=[loss])
        emain, estart = ptt.Program(), ptt.Program()
        with ptt.unique_name.guard(), ptt.program_guard(emain, estart):
            feeds = [ptt.layers.data(n, [seq, 1], dtype=d) for n, d in zip(
                names, ["int64", "int64", "int64", "float32"])]
            outs = tbert.bert_encoder(*feeds, cfg, is_test=True)
        want = exe.run(emain, feed={n: feed[n] for n in names},
                       fetch_list=list(outs))
        ptt.save_inference_model(str(tmp_path), names, list(outs), exe,
                                 main_program=emain)
    with open(os.path.join(str(tmp_path), "__model__.json")) as f:
        manifest = json.load(f)["param_manifest"]
    bf16 = sorted(n for n, spec in manifest.items()
                  if spec["dtype"] == "bfloat16")
    assert len(bf16) == 12 * cfg.num_layers
    trained = scope.find_var(bf16[0])
    config_ = Config(str(tmp_path))
    config_.place = ptt.CPUPlace()
    config_.batch_buckets = (batch,)
    pred = create_predictor(config_)
    got = pred.run({n: feed[n] for n in names})
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    loaded = pred._scope.find_var(bf16[0])
    assert loaded.dtype == trained.dtype
    assert bool((loaded == trained).all())
