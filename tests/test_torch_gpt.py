"""The GPT slice as a whole: the port against the JAX package.

``gpt_pretrain_program`` (with ``optimizer.Adam``) and
``gpt_logits_program`` are built by both packages and must serialize the
same. A tiny GPT (vocab 256, hidden 64, 2 layers, 4 heads, dropout 0)
then trains ten Adam steps in both, the port starting from the JAX scope's
weights and optimizer state (``set_params_from_numpy``). The JAX side runs
twice: with its default Executor (XLA lowering) and through
``CompiledProgram`` with ``use_pallas={"fused_mlm_head_loss",
"layer_norm", "adam"}`` and ``attn_impl="flash"``, where its fused-head
kernels (forward, dhidden, dweight), both LayerNorm and all three flash
kernels and fused Adam run in interpret mode. At batch 4 x 16 (64 tokens)
the port's head takes the plain lowering (the JAX package's compiled
kernels do not tile 64 tokens); at 4 x 32 (128 tokens) it takes the
fused-head autograd Function, whose plain versions run on the CPU.

Tolerances (f32 on both sides; only the order of sums differs), those of
tests/test_torch_bert_training.py: first-step gradients rtol 1e-4 with
atol 1e-6, per-step losses rtol 1e-5, final parameters atol 1e-5 (Adam
moves an element by about lr = 1e-3 a step whatever its gradient's size;
no gradient here sits close enough to zero for its sign to differ).

Greedy decode on copied weights gives the JAX package's tokens, the
port's decode continues a learned pattern, and a future token changes no
earlier position's loss.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework.compiler import BuildStrategy, CompiledProgram
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.models import gpt as tgpt

BATCH, STEPS, LR = 4, 10, 1e-3


def _cfg(gpt, **kw):
    base = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
                ff_size=128, max_position=64, dropout=0.0)
    return gpt.GPTConfig(**dict(base, **kw))


def _build(pkg, gpt, opt, cfg, batch=BATCH, seq=16):
    with pkg.unique_name.guard():
        return gpt.gpt_pretrain_program(
            cfg, batch, seq,
            optimizer_fn=lambda loss: opt.Adam(LR).minimize(loss))


def _normalized(program):
    """The program's JSON with desc_ids renumbered by position and
    grad_of's fwd_id mapped the same way."""
    d = program.to_dict()
    ids = {}
    for blk in d["blocks"]:
        for op in blk["ops"]:
            ids[op.pop("desc_id")] = len(ids)
    for blk in d["blocks"]:
        for op in blk["ops"]:
            if "fwd_id" in op["attrs"]:
                op["attrs"]["fwd_id"] = ids[op["attrs"]["fwd_id"]]
    return d


@pytest.mark.parametrize("size", ["tiny", "base"])
def test_programs_serialize_equal(size):
    """Train and decode programs: same op types, attrs, var and parameter
    names (Adam accumulators included) as the JAX package, at a tiny
    config and at GPT-base's published widths (2 x 4096, the chip run's
    shapes); GPT-base has the op counts behind the chip run's launch
    checks."""
    kw, batch, seq = {}, BATCH, 16
    if size == "base":
        kw = dict(vocab_size=32000, hidden_size=768, num_layers=12,
                  num_heads=12, ff_size=3072, max_position=4096,
                  attn_impl="flash")
        batch, seq = 2, 4096
    jmain, jstart, jfeeds, jfetch = _build(pt, jgpt, jopt, _cfg(jgpt, **kw),
                                           batch, seq)
    tmain, tstart, tfeeds, tfetch = _build(ptt, tgpt, ptt.optimizer,
                                           _cfg(tgpt, **kw), batch, seq)
    assert _normalized(tmain) == _normalized(jmain)
    assert _normalized(tstart) == _normalized(jstart)
    assert tfeeds == jfeeds
    assert {k: v.name for k, v in tfetch.items()} == \
        {k: v.name for k, v in jfetch.items()}
    with pt.unique_name.guard():
        jlog = jgpt.gpt_logits_program(_cfg(jgpt, **kw), seq)
    with ptt.unique_name.guard():
        tlog = tgpt.gpt_logits_program(_cfg(tgpt, **kw), seq)
    for j, t in zip(jlog[:2], tlog[:2]):
        assert _normalized(t) == _normalized(j)
    assert tlog[2] == jlog[2] and tlog[3]["logits"].name == \
        jlog[3]["logits"].name
    if size == "base":
        types = [op.type for op in tmain.global_block().ops]
        assert [types.count(t) for t in (
            "adam", "layer_norm", "scaled_dot_product_attention",
            "fused_mlm_head_loss", "split")] == [148, 25, 12, 1, 12]


def test_synthetic_batch_matches_jax():
    for seed in (0, 3):
        j = jgpt.synthetic_batch(_cfg(jgpt), 3, 16, seed=seed)
        t = tgpt.synthetic_batch(_cfg(tgpt), 3, 16, seed=seed)
        assert sorted(j) == sorted(t)
        for k in j:
            np.testing.assert_array_equal(t[k], j[k])


def _spy_pallas(monkeypatch):
    """Record the kernel function of every pallas_call traced."""
    import jax.experimental.pallas as jpl
    seen, orig = set(), jpl.pallas_call

    def spy(kernel, *args, **kwargs):
        seen.add(getattr(getattr(kernel, "func", kernel), "__name__", ""))
        return orig(kernel, *args, **kwargs)
    monkeypatch.setattr(jpl, "pallas_call", spy)
    return seen


@pytest.mark.parametrize("seq", [16, 32])
@pytest.mark.parametrize("route", ["xla", "pallas_interpret"])
def test_tiny_gpt_trains_like_jax(route, seq, monkeypatch):
    from paddle_tpu_torch.ops.kernels import blockwise_ce as tce
    impl = "flash" if route == "pallas_interpret" else "auto"
    jmain, jstart, _, jfetch = _build(pt, jgpt, jopt,
                                      _cfg(jgpt, attn_impl=impl), seq=seq)
    tmain, _, _, tfetch = _build(ptt, tgpt, ptt.optimizer,
                                 _cfg(tgpt, attn_impl=impl), seq=seq)
    params = [p.name for p in jmain.all_parameters()]
    grads = [p + "@GRAD" for p in params]
    feed = jgpt.synthetic_batch(_cfg(jgpt), BATCH, seq, seed=0)
    seen = _spy_pallas(monkeypatch)

    jscope = pt.Scope()
    with pt.scope_guard(jscope):
        exe = pt.Executor(pt.CPUPlace())
        exe.run(jstart)
        init = {v.name: np.asarray(jscope.find_var(v.name))
                for v in jmain.list_vars() if v.persistable}
        prog = jmain
        if route == "pallas_interpret":
            bs = BuildStrategy()
            bs.mesh_axes = {"dp": 1}
            bs.use_pallas = frozenset({"fused_mlm_head_loss", "layer_norm",
                                       "adam"})
            bs.kernel_policy = "pallas"
            prog = CompiledProgram(jmain, bs)
        jrun = [exe.run(prog, feed=feed,
                        fetch_list=[jfetch["loss"]] + (grads if s == 0
                                                       else []))
                for s in range(STEPS)]
        jfinal = {p: np.asarray(jscope.find_var(p)) for p in params}
    if route == "pallas_interpret":
        assert {"_head_fwd_kernel", "_head_dh_kernel", "_head_dwb_kernel",
                "_fwd_kernel", "_bwd_dkv_kernel", "_bwd_dq_kernel",
                "_ln_fwd_kernel", "_ln_bwd_kernel", "_adam_kernel"} <= seen
    else:
        assert not seen

    heads = tce.head_launches
    tscope = ptt.Scope()
    ptt.set_params_from_numpy(init, tmain, tscope, ptt.CPUPlace())
    with ptt.scope_guard(tscope):
        exe = ptt.Executor(ptt.CPUPlace())
        trun = [exe.run(tmain, feed=feed,
                        fetch_list=[tfetch["loss"]] + (grads if s == 0
                                                       else []))
                for s in range(STEPS)]
        tfinal = {p: tscope.find_var(p).numpy() for p in params}
    assert tce.head_launches == heads        # the CPU runs plain versions

    for name, j, t in zip(grads, jrun[0][1:], trun[0][1:]):
        np.testing.assert_allclose(t, np.asarray(j), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    jloss = [float(np.asarray(r[0]).reshape(())) for r in jrun]
    tloss = [float(r[0].reshape(())) for r in trun]
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    assert tloss[-1] < tloss[0] - 0.5          # it trained
    for p in params:
        np.testing.assert_allclose(tfinal[p], jfinal[p], rtol=0, atol=1e-5,
                                   err_msg=p)


def test_head_route_follows_the_token_count():
    """At 64 tokens the head op takes the plain lowering, at 128 the
    fused-head Function (the JAX package's compiled tiling rule)."""
    from paddle_tpu_torch.ops import nn_ops
    assert not nn_ops.blockwise_kernel_would_tile(BATCH * 16, 256, 64)
    assert nn_ops.blockwise_kernel_would_tile(BATCH * 32, 256, 64)


def test_tiny_greedy_decode_matches_jax():
    """Same weights, same prompt: the same greedy tokens."""
    jcfg, tcfg = _cfg(jgpt), _cfg(tgpt)
    prompt = np.random.RandomState(7).randint(0, 256, (3, 6))
    with pt.unique_name.guard():
        jprog = jgpt.gpt_logits_program(jcfg, 14)
    with ptt.unique_name.guard():
        tprog = tgpt.gpt_logits_program(tcfg, 14)
    jscope = pt.Scope()
    with pt.scope_guard(jscope):
        exe = pt.Executor(pt.CPUPlace())
        exe.run(jprog[1])
        init = {v.name: np.asarray(jscope.find_var(v.name))
                for v in jprog[0].list_vars() if v.persistable}
        jtoks = jgpt.greedy_generate(exe, jcfg, prompt, 8,
                                     logits_program=jprog)
    tscope = ptt.Scope()
    ptt.set_params_from_numpy(init, tprog[0], tscope, ptt.CPUPlace())
    with ptt.scope_guard(tscope):
        ttoks = tgpt.greedy_generate(ptt.Executor(ptt.CPUPlace()), tcfg,
                                     prompt, 8, logits_program=tprog)
    np.testing.assert_array_equal(ttoks, jtoks)
    assert ttoks.shape == (3, 14)


def _tiny(**kw):
    base = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
                ff_size=64, max_position=32, dropout=0.0)
    return tgpt.GPTConfig(**dict(base, **kw))


def test_gpt_generate_continues_learned_pattern():
    """The port's version of tests/test_gpt.py's: train on a period-4
    token stream, then greedy_generate must reproduce the continuation
    exactly (decode shares the trained scope through parameter names)."""
    cfg = _tiny(vocab_size=32, max_position=24)
    with ptt.unique_name.guard():
        main, startup, feeds, fetch = tgpt.gpt_pretrain_program(
            cfg, batch_size=8, seq_len=16,
            optimizer_fn=lambda l: ptt.optimizer.Adam(5e-3).minimize(l))
        logits_prog = tgpt.gpt_logits_program(cfg, 16)
    rng = np.random.RandomState(0)
    period = rng.randint(0, 32, (8, 4))
    stream = np.tile(period, (1, 5))          # (8, 20)
    batch = {"token_ids": stream[:, :16, None].astype(np.int64),
             "pos_ids": np.tile(np.arange(16).reshape(1, 16, 1),
                                (8, 1, 1)).astype(np.int64),
             "labels": stream[:, 1:17, None].astype(np.int64),
             "loss_mask": np.ones((8, 16, 1), np.float32)}
    with ptt.scope_guard(ptt.Scope()):
        exe = ptt.Executor(ptt.CPUPlace())
        exe.run(startup)
        for _ in range(150):
            loss, = exe.run(main, feed=batch, fetch_list=[fetch["loss"]])
        assert float(loss.reshape(-1)[0]) < 0.1
        out = tgpt.greedy_generate(exe, cfg, stream[:, :8], 8,
                                   logits_program=logits_prog)
    np.testing.assert_array_equal(out[:, 8:16], stream[:, 8:16])


def test_gpt_causality():
    """The port's version of tests/test_gpt.py's: changing a future token
    must not change the loss over earlier positions."""
    cfg = _tiny()
    with ptt.unique_name.guard():
        main, startup, feeds, fetch = tgpt.gpt_pretrain_program(
            cfg, batch_size=2, seq_len=8, is_test=True)
    batch = tgpt.synthetic_batch(cfg, 2, 8, seed=3)
    mask = np.zeros((2, 8, 1), np.float32)
    mask[:, :4] = 1.0                   # loss over positions 0..3 only
    batch["loss_mask"] = mask
    with ptt.scope_guard(ptt.Scope()):
        exe = ptt.Executor(ptt.CPUPlace())
        exe.run(startup)
        l1, = exe.run(main, feed=batch, fetch_list=[fetch["loss"]])
        batch2 = {k: v.copy() for k, v in batch.items()}
        batch2["token_ids"][:, 6:] = (batch2["token_ids"][:, 6:] + 1) % \
            cfg.vocab_size             # mutate the future
        l2, = exe.run(main, feed=batch2, fetch_list=[fetch["loss"]])
    np.testing.assert_allclose(l1, l2, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kw,match", [
    ({"dtype": "bfloat16"}, "bf16 slice"),
    ({"recompute": True}, "recompute"),
    ({"tp": True}, "multi-GPU"),
    ({"attn_impl": "ring"}, "multi-GPU"),
    ({"attn_impl": "ulysses"}, "multi-GPU"),
])
def test_later_slices_are_refused(kw, match):
    cfg = _tiny(**kw)
    with pytest.raises(ptt.NotPortedError, match=match):
        tgpt.gpt_pretrain_program(cfg, 2, 8)
    if "recompute" not in kw:       # decode never recomputes
        with pytest.raises(ptt.NotPortedError, match=match):
            tgpt.gpt_logits_program(cfg, 8)
    else:
        tgpt.gpt_logits_program(cfg, 8)
