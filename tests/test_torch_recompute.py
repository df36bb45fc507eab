"""Recompute (``recompute_segment`` / ``remat_block``) and sub-blocks: the
port against the JAX package, and against itself without recompute.

``BertConfig(recompute=True)`` and ``GPTConfig(recompute=True)`` make each
training layer a ``recompute_segment``: a sub-block that one
``remat_block`` op of the global block runs, whose backward runs the
segment again. The programs serialize as the JAX package's do, sub-blocks
included. A tiny model of each (tests/test_torch_bf16_training.py's
configs) trains three Adam steps from the JAX scope's weights, in f32 at
the f32 tolerances of tests/test_torch_gpt.py (first-step gradients rtol
1e-4 with atol 1e-6, losses rtol 1e-5, final parameters atol 1e-5),
through the JAX package's default Executor and through ``CompiledProgram``
with its Pallas kernels in interpret mode. Dropout is 0 there: the two
packages' random streams never agree.

Against the port without recompute the comparison is exact: losses and
gradients bit for bit, with dropout 0.1 (each dropout op given an explicit
``seed``, so both programs draw the same masks whatever the ops'
positions), in f32 and in bf16, because the re-run computes the same
values with the same kernels. A dropout inside a segment with no seed of
its own draws its mask from a generator keyed on its block and position:
the backward's re-run must replay the forward's mask, which the gradient
shows.
"""
import zlib

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from test_torch_bf16_training import (SHAPE, STEPS, TINY, batch_feed,
                                      config, jax_program, program)

BASE = {"bert": dict(vocab_size=30522, hidden_size=768, num_layers=12,
                     num_heads=12, ff_size=3072, max_position=512,
                     hidden_dropout=0.1, attn_dropout=0.1,
                     dtype="bfloat16"),
        "gpt": dict(vocab_size=32000, hidden_size=768, num_layers=12,
                    num_heads=12, ff_size=3072, max_position=4096,
                    dropout=0.0, attn_impl="flash", dtype="bfloat16")}


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
@pytest.mark.parametrize("model", ["bert", "gpt"])
def test_recompute_programs_serialize_equal(model, size):
    """Train and startup programs with ``recompute=True`` (bf16 at base
    size, bench.py's flagship settings; batch 128 x 128 for BERT, 2 x 4096
    for GPT): one sub-block a layer, the same JSON as the JAX package's."""
    if size == "tiny":
        kw, (batch, seq) = dict(TINY[model], recompute=True), SHAPE[model]
    else:
        kw = dict(BASE[model], recompute=True)
        batch, seq = (128, 128) if model == "bert" else (2, 4096)
    jmain, jstart, _ = program(pt, model, config(pt, model, **kw), batch,
                               seq)
    tmain, tstart, _ = program(ptt, model, config(ptt, model, **kw), batch,
                               seq)
    assert _normalized(tmain) == _normalized(jmain)
    assert _normalized(tstart) == _normalized(jstart)
    layers = kw["num_layers"]
    assert tmain.num_blocks == layers + 1
    remat = [op for op in tmain.global_block().ops
             if op.type == "remat_block"]
    assert [op.attrs["sub_block"] for op in remat] == \
        list(range(1, layers + 1))
    assert all(tmain.block(i).parent_idx == 0 for i in range(1, layers + 1))
    assert tmain.current_block_idx == 0
    grads = [op for op in tmain.global_block().ops
             if op.type == "grad_of" and op.attrs["fwd_type"] ==
             "remat_block"]
    assert len(grads) == layers


@pytest.mark.parametrize("model,route", [
    ("bert", "xla"), ("gpt", "xla"),
    pytest.param("gpt", "pallas_interpret", marks=pytest.mark.slow)])
def test_recompute_trains_like_jax(model, route):
    """f32, ``recompute=True`` in both packages, at the f32 tolerances."""
    kw = dict(recompute=True)
    if route == "pallas_interpret":
        kw["attn_impl"] = "flash"
    batch, seq = SHAPE[model]
    jcfg = config(pt, model, **kw)
    jmain, jstart, jloss = program(pt, model, jcfg, batch, seq)
    tmain, _, tloss = program(ptt, model, config(ptt, model, **kw), batch,
                              seq)
    params = [p.name for p in jmain.all_parameters()]
    grads = [p + "@GRAD" for p in params]
    feed = batch_feed(model, jcfg, batch, seq)
    jscope = pt.Scope()
    with pt.scope_guard(jscope):
        exe = pt.Executor(pt.CPUPlace())
        exe.run(jstart)
        init = {v.name: np.asarray(jscope.find_var(v.name))
                for v in jmain.list_vars() if v.persistable}
        prog = jax_program(jmain, route)
        jrun = [exe.run(prog, feed=feed,
                        fetch_list=[jloss] + (grads if s == 0 else []))
                for s in range(STEPS)]
        jfinal = {p: np.asarray(jscope.find_var(p)) for p in params}
    tscope = ptt.Scope()
    ptt.set_params_from_numpy(init, tmain, tscope, ptt.CPUPlace())
    with ptt.scope_guard(tscope):
        exe = ptt.Executor(ptt.CPUPlace())
        trun = [exe.run(tmain, feed=feed,
                        fetch_list=[tloss] + (grads if s == 0 else []))
                for s in range(STEPS)]
        tfinal = {p: tscope.find_var(p).numpy() for p in params}
    for name, j, t in zip(grads, jrun[0][1:], trun[0][1:]):
        np.testing.assert_allclose(t, np.asarray(j), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    np.testing.assert_allclose(
        [float(r[0].reshape(())) for r in trun],
        [float(np.asarray(r[0]).reshape(())) for r in jrun], rtol=1e-5)
    for p in params:
        np.testing.assert_allclose(tfinal[p], jfinal[p], rtol=0, atol=1e-5,
                                   err_msg=p)


def _seed_dropouts(main):
    """Give every dropout op an explicit seed derived from its output's
    name, which both programs share."""
    n = 0
    for blk in main.blocks:
        for op in blk.ops:
            if op.type == "dropout":
                op.attrs["seed"] = 1 + zlib.crc32(
                    op.output("Out")[0].encode()) % (2 ** 30)
                n += 1
    return n


def _port_steps(model, steps=STEPS, **kw):
    """``steps`` port steps of the tiny model from its own seeded startup:
    ([[loss, gradients...] a step, as tensors], its dropout count, the
    Program)."""
    batch, seq = SHAPE[model]
    cfg = config(ptt, model, **kw)
    main, startup, loss = program(ptt, model, cfg, batch, seq)
    startup.random_seed = 11
    n_dropout = _seed_dropouts(main)
    grads = [p.name + "@GRAD" for p in main.all_parameters()]
    feed = batch_feed(model, cfg, batch, seq)
    scope = ptt.Scope()
    with ptt.scope_guard(scope):
        exe = ptt.Executor(ptt.CPUPlace())
        exe.run(startup)
        runs = [exe.run(main, feed=feed, fetch_list=[loss] + grads,
                        return_numpy=False) for _ in range(steps)]
    return runs, n_dropout, main


@pytest.mark.parametrize("model,dtype", [("bert", "float32"),
                                         ("gpt", "float32"),
                                         ("bert", "bfloat16"),
                                         ("gpt", "bfloat16")])
def test_recompute_matches_the_port_without_it_bit_for_bit(model, dtype):
    drop = {"bert": dict(hidden_dropout=0.1, attn_dropout=0.1),
            "gpt": dict(dropout=0.1)}[model]
    plain, n_plain, _ = _port_steps(model, dtype=dtype, **drop)
    remat, n_remat, main = _port_steps(model, dtype=dtype, recompute=True,
                                       **drop)
    assert n_plain == n_remat > TINY[model]["num_layers"]
    assert sum(op.type == "dropout" for op in main.global_block().ops) < \
        n_remat                              # the layers' are in segments
    for a, b in zip(plain, remat):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            assert bool((x == y).all())
    assert float(plain[-1][0]) < float(plain[0][0])


def test_dropout_in_a_segment_replays_its_mask():
    """A dropout with no seed of its own inside a segment: the gradient
    of sum(c * dropout(2 w)) is 4 c where the forward kept an element and
    0 where it dropped it, in two runs (two masks)."""
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        w = ptt.layers.create_parameter(
            [64, 32], "float32", name="w",
            default_initializer=ptt.initializer.ConstantInitializer(1.0))
        c = ptt.layers.data("c", [64, 32], append_batch_size=False)
        h = ptt.layers.recompute_segment(
            lambda a: ptt.layers.dropout(
                ptt.layers.scale(a, scale=2.0), 0.5,
                dropout_implementation="upscale_in_train"), [w])
        loss = ptt.layers.reduce_sum(ptt.layers.elementwise_mul(h, c))
        (_, gw), = ptt.append_backward(loss)
    assert main.block(1).ops[-1].attrs["seed"] == 0
    c_val = np.random.RandomState(0).rand(64, 32).astype(np.float32) + 1
    exe = ptt.Executor(ptt.CPUPlace())
    scope = ptt.Scope()
    masks = []
    with ptt.scope_guard(scope):
        exe.run(startup)
        for _ in range(2):
            hv, g = exe.run(main, feed={"c": c_val}, fetch_list=[h, gw])
            kept = hv != 0
            assert 0.3 < kept.mean() < 0.7
            np.testing.assert_array_equal(hv, np.where(kept, 4.0, 0.0))
            np.testing.assert_array_equal(g, np.where(kept, 4.0 * c_val,
                                                      0.0))
            masks.append(kept)
    assert (masks[0] != masks[1]).any()


def test_sub_blocks_survive_clone_prune_and_json():
    """``_create_block``/``_rollback``, and a recompute program's
    sub-blocks through ``clone`` (``for_test`` sets ``is_test`` inside
    them), ``_prune`` and ``to_json``/``from_json``; the pruned eval
    program runs its segments and answers as the program without
    recompute."""
    p = ptt.Program()
    blk = p._create_block()
    assert (p.current_block_idx, blk.idx, blk.parent_idx) == (1, 1, 0)
    p._rollback()
    assert p.current_block_idx == 0 and p.block(1) is blk
    assert p.num_blocks == 2

    cfg = config(ptt, "gpt", recompute=True, dropout=0.1)
    main, startup, loss = program(ptt, "gpt", cfg, 2, 8, lr=1e-3)
    back = ptt.Program.from_json(main.to_json())
    assert _normalized(back) == _normalized(main)
    test = main.clone(for_test=True)
    assert test.num_blocks == main.num_blocks
    dropouts = [op for b in test.blocks[1:] for op in b.ops
                if op.type == "dropout"]
    assert dropouts and all(op.attrs["is_test"] for op in dropouts)
    feeds = ["token_ids", "pos_ids", "labels", "loss_mask"]
    pruned = test._prune(feeds, [loss.name])
    assert pruned.num_blocks == main.num_blocks
    assert [op.type for op in pruned.global_block().ops].count(
        "remat_block") == cfg.num_layers

    plain, pstart, ploss = program(ptt, "gpt", config(ptt, "gpt"), 2, 8)
    batch = batch_feed("gpt", cfg, 2, 8)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    with ptt.scope_guard(scope):
        exe.run(startup)
        got, = exe.run(pruned, feed=batch, fetch_list=[loss])
        want, = exe.run(plain.clone(for_test=True), feed=batch,
                        fetch_list=[ploss])
    np.testing.assert_array_equal(got, want)
