"""The BERT serving slice as a whole: the port against the JAX package.

A tiny BERT encoder (2 layers, hidden 64, 4 heads, T=16) is composed
inline from ``layers.data`` + ``bert_encoder(is_test=True)`` in both
packages, the way their users build an inference program. The tests hold
the two Programs' JSON equal, serve a model directory written by either
package with the other's predictor, and check the weight-carrying
function's refusals.

Tolerance: f32 on both sides through the whole encoder (2 layers of
matmuls, attention and LayerNorm with values of order 1): rtol/atol 1e-4.
"""
import json
import os

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import inference as jinf
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch.models import bert as tbert

T = 16
FEEDS = ["src_ids", "pos_ids", "sent_ids", "input_mask"]
TOL = dict(rtol=1e-4, atol=1e-4)


def _cfg(bert, dtype="float32"):
    return bert.BertConfig(vocab_size=100, hidden_size=64, num_layers=2,
                           num_heads=4, ff_size=128, max_position=64,
                           dtype=dtype)


def _build(pkg, bert, seed=3, dtype="float32"):
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = seed
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        feeds = [pkg.layers.data(n, [T, 1], dtype=dt) for n, dt in zip(
            FEEDS, ["int64", "int64", "int64", "float32"])]
        seq, pooled = bert.bert_encoder(*feeds, _cfg(bert, dtype),
                                        is_test=True)
    return main, startup, [seq, pooled]


def _save(pkg, bert, dirname, dtype="float32"):
    main, startup, fetch = _build(pkg, bert, dtype=dtype)
    with pkg.scope_guard(pkg.Scope()):
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup)
        pkg.save_inference_model(dirname, FEEDS, fetch, exe,
                                 main_program=main)


def _request(n, seed):
    rng = np.random.RandomState(seed)
    mask = np.ones((n, T, 1), np.float32)
    for row in range(1, n):                    # trailing padding
        mask[row, rng.randint(2, T):] = 0.0
    return {"src_ids": rng.randint(0, 100, (n, T, 1)).astype(np.int64),
            "pos_ids": np.tile(np.arange(T).reshape(1, T, 1),
                               (n, 1, 1)).astype(np.int64),
            "sent_ids": (np.arange(T).reshape(1, T, 1) >= T // 2).repeat(
                n, 0).astype(np.int64),
            "input_mask": mask}


def _port_predictor(dirname, buckets):
    config = tinf.Config(dirname)
    config.place = ptt.CPUPlace()
    config.batch_buckets = buckets
    return tinf.create_predictor(config)


def _jax_predictor(dirname, buckets):
    config = jinf.Config(dirname)
    config.batch_buckets = buckets
    return jinf.create_predictor(config)


def _strip_desc_ids(d):
    for blk in d["blocks"]:
        for op in blk["ops"]:
            op.pop("desc_id")
    return d


def test_encoder_programs_serialize_equal():
    """Op types, attrs, var names and shapes of the main and startup
    Programs match the JAX package's key for key (desc_ids count ops
    process-wide and differ)."""
    jmain, jstart, _ = _build(pt, jbert)
    tmain, tstart, _ = _build(ptt, tbert)
    assert _strip_desc_ids(tmain.to_dict()) == \
        _strip_desc_ids(jmain.to_dict())
    assert _strip_desc_ids(tstart.to_dict()) == \
        _strip_desc_ids(jstart.to_dict())
    # the serving slice's 13 op types and 2 startup op types
    assert {op.type for op in tmain.global_block().ops} == {
        "mul", "elementwise_add", "layer_norm",
        "scaled_dot_product_attention", "lookup_table", "transpose2",
        "reshape2", "unsqueeze2", "slice", "scale", "dropout", "gelu",
        "tanh"}
    assert {op.type for op in tstart.global_block().ops} == {
        "truncated_gaussian_random", "fill_constant"}
    # and the JSON round-trips through the port's parser
    again = ptt.Program.from_json(tmain.to_json())
    assert again.to_dict() == tmain.to_dict()


def test_port_serves_a_model_saved_by_jax(tmp_path):
    _save(pt, jbert, str(tmp_path))
    port = _port_predictor(str(tmp_path), (1, 4))
    ref = _jax_predictor(str(tmp_path), (1, 4))
    assert port.get_input_names() == ref.get_input_names() == FEEDS
    for i, n in enumerate((1, 3, 4)):          # buckets 1, 4 (padded), 4
        feed = _request(n, seed=i)
        got, want = port.run(feed), ref.run(feed)
        seq, pooled = got
        assert seq.shape == (n, T, 64) and pooled.shape == (n, 64)
        np.testing.assert_allclose(seq, np.asarray(want[0]), **TOL)
        # the JAX Predictor slices only fetches declared with a leading
        # -1; pooled's is 0 (a reshape's "copy this dim") and comes back
        # with the bucket's padding rows
        np.testing.assert_allclose(pooled, np.asarray(want[1])[:n], **TOL)


def test_jax_serves_a_model_saved_by_the_port(tmp_path):
    _save(ptt, tbert, str(tmp_path))
    with open(os.path.join(str(tmp_path), "__model__.json")) as f:
        meta = json.load(f)
    assert meta["format_version"] == 2 and meta["fetch_var_names"]
    feed = _request(3, seed=7)
    got = _port_predictor(str(tmp_path), (4,)).run(feed)
    want = _jax_predictor(str(tmp_path), (4,)).run(feed)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(got[1], np.asarray(want[1])[:3], **TOL)
    # the port's own answer for the padded request equals its answer for
    # each row alone: padding rows and padded keys change nothing
    alone = _port_predictor(str(tmp_path), (1,))
    for row in range(3):
        one = alone.run({k: v[row:row + 1] for k, v in feed.items()})
        np.testing.assert_allclose(one[0], got[0][row:row + 1], **TOL)


def _params_and_program(tmp_path):
    _save(ptt, tbert, str(tmp_path))
    program, _, _ = ptt.load_inference_model(
        str(tmp_path), ptt.Executor(ptt.CPUPlace()))
    with np.load(os.path.join(str(tmp_path), "params.npz")) as z:
        return {k: z[k] for k in z.files}, program


def test_set_params_from_numpy_refuses_wrong_names_shapes_dtypes(tmp_path):
    arrays, program = _params_and_program(tmp_path)
    scope = ptt.Scope()
    ptt.set_params_from_numpy(arrays, program, scope, ptt.CPUPlace())
    assert sorted(scope.keys()) == sorted(arrays)
    name = "encoder_layer_0_ffn_fc_0.w_0"
    bad = [({**arrays, "no_such_param": arrays[name]}, "not persistable"),
           ({k: v for k, v in arrays.items() if k != name}, "no array"),
           ({**arrays, name: arrays[name].T}, "shape"),
           ({**arrays, name: arrays[name].astype(np.float64)}, "dtype")]
    for case, match in bad:
        fresh = ptt.Scope()
        with pytest.raises(ValueError, match=match):
            ptt.set_params_from_numpy(case, program, fresh, ptt.CPUPlace())
        assert not list(fresh.keys())          # nothing half-written


def test_load_refuses_params_that_disagree_with_the_manifest(tmp_path):
    arrays, _ = _params_and_program(tmp_path)
    arrays["pooled_fc.w_0"] = arrays["pooled_fc.w_0"][:, :32]
    np.savez(os.path.join(str(tmp_path), "params.npz"), **arrays)
    with pytest.raises(ValueError, match="manifest declares"):
        _port_predictor(str(tmp_path), (1,))


def test_stablehlo_export_waits_for_the_serving_slice(tmp_path):
    main, startup, fetch = _build(ptt, tbert)
    with ptt.scope_guard(ptt.Scope()):
        exe = ptt.Executor(ptt.CPUPlace())
        exe.run(startup)
        with pytest.raises(ptt.NotPortedError, match="serving slice"):
            ptt.save_inference_model(str(tmp_path), FEEDS, fetch, exe,
                                     main_program=main, format="stablehlo")
    assert not os.listdir(str(tmp_path))


def test_bf16_encoder_matches_jax_with_copied_weights(tmp_path):
    """BertConfig(dtype="bfloat16") makes the encoder's weights bf16. The
    JAX scope's weights go into the port through set_params_from_numpy
    and both Executors run the Program. The two packages round to bf16 at
    different points (the attention probabilities, GELU), so they may
    differ by a few bf16 ulps (2^-8 relative) per layer: rtol/atol 2e-2.
    The port saves the bf16 weights as their uint16 bits (once refused),
    and serves both its own directory and the JAX package's (npz's
    ``void16``, which the JAX package's own loader refuses) with the
    answers of its Executor, bit for bit."""
    jmain, jstart, jfetch = _build(pt, jbert, dtype="bfloat16")
    tmain, _, tfetch = _build(ptt, tbert, dtype="bfloat16")
    assert _strip_desc_ids(tmain.to_dict()) == \
        _strip_desc_ids(jmain.to_dict())
    feed = _request(3, seed=5)
    jscope = pt.Scope()
    with pt.scope_guard(jscope):
        exe = pt.Executor(pt.CPUPlace())
        exe.run(jstart)
        want = exe.run(jmain, feed=feed, fetch_list=jfetch)
    arrays = {v.name: np.asarray(jscope.find_var(v.name))
              for v in jmain.list_vars() if v.persistable}
    assert {a.dtype.name for a in arrays.values()} == {"bfloat16",
                                                       "float32"}
    scope = ptt.Scope()
    ptt.set_params_from_numpy(arrays, tmain, scope, ptt.CPUPlace())
    got = ptt.Executor(ptt.CPUPlace()).run(tmain, feed=feed,
                                           fetch_list=tfetch, scope=scope)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w).astype(np.float32),
                                   rtol=2e-2, atol=2e-2)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    with ptt.scope_guard(scope):
        ptt.save_inference_model(port_dir, FEEDS, tfetch, None,
                                 main_program=tmain)
    with pt.scope_guard(jscope):
        pt.save_inference_model(jax_dir, FEEDS, jfetch, exe,
                                main_program=jmain)
    with np.load(os.path.join(jax_dir, "params.npz")) as data:
        assert {data[k].dtype.kind for k in data.files} == {"V", "f"}
    for dirname in (port_dir, jax_dir):
        served = _port_predictor(dirname, (3,)).run(feed)
        for g, w in zip(served, got):
            np.testing.assert_array_equal(g, w)
