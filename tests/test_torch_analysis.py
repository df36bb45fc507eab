"""The port's Program verifier (paddle_tpu_torch/framework/analysis.py,
ops/shape_rules.py) against the JAX package's.

Each non-pipeline program of tests/test_analysis.py is built in both
packages and verified by both: the (pass, severity, block, op, op type,
vars) lists must be equal (the messages may differ where the JAX
package speaks of XLA). The wiring cases (strict raises with every
error, warn counts, off never calls the verifier, the memo, the
allowlist) run against the port's compile seams: ``verify_for_compile``,
``Executor.run`` and ``CompiledProgram``. The port's zoo verifies clean
in strict mode; a model directory written by either package gets the
same verdict; the set of op types with a shape rule is the JAX
package's. No tolerance: every comparison is exact.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.framework import analysis as janalysis
from paddle_tpu.ops import registry as jregistry
from paddle_tpu_torch.framework import analysis, compiler, resilience
from paddle_tpu_torch.framework.analysis import (
    PASS_DCE, PASS_SHAPE, ProgramVerificationError)
from paddle_tpu_torch.ops import registry

PACKAGES = [(pt, janalysis), (ptt, analysis)]


def _key(result):
    return [(d.pass_name, d.severity, d.block_idx, d.op_idx, d.op_type,
             d.vars) for d in result]


# ---------------------------------------------------------------------------
# the corpus: one function per case of tests/test_analysis.py, for either
# package; each returns (program, verify_program kwargs)
# ---------------------------------------------------------------------------

def _dangling(pkg):
    main = pkg.Program()
    blk = main.global_block()
    blk.create_var(name="o", shape=[4], dtype="float32")
    blk.append_op("scale", inputs={"X": ["nope"]},
                  outputs={"Out": ["o"]}, attrs={"scale": 2.0})
    return main, {"feeds": {}}


def _never_produced(pkg, feeds):
    main = pkg.Program()
    blk = main.global_block()
    blk.create_var(name="ghost", shape=[4], dtype="float32")
    blk.create_var(name="o", shape=[4], dtype="float32")
    blk.append_op("scale", inputs={"X": ["ghost"]},
                  outputs={"Out": ["o"]}, attrs={"scale": 2.0})
    return main, {"feeds": feeds}


def _def_before_use(pkg):
    main = pkg.Program()
    blk = main.global_block()
    for n in ("a", "b", "t"):
        blk.create_var(name=n, shape=[4], dtype="float32")
    blk.append_op("scale", inputs={"X": ["t"]}, outputs={"Out": ["a"]},
                  attrs={"scale": 1.0})
    blk.append_op("scale", inputs={"X": ["a"]}, outputs={"Out": ["t"]},
                  attrs={"scale": 1.0})
    return main, {"feeds": {}}


def _backward_after_optimize(pkg):
    main = pkg.Program()
    blk = main.global_block()
    for n in ("x", "y", "z"):
        blk.create_var(name=n, shape=[4], dtype="float32")
    blk.append_op("scale", inputs={"X": ["x"]}, outputs={"Out": ["y"]},
                  attrs={"scale": 1.0, "op_role": "optimize"})
    blk.append_op("scale", inputs={"X": ["y"]}, outputs={"Out": ["z"]},
                  attrs={"scale": 1.0, "op_role": "backward"})
    return main, {"feeds": {"x": (4,)}}


def _two_vars(pkg, sx, sy, dx="float32", dy="float32"):
    main = pkg.Program()
    blk = main.global_block()
    blk.create_var(name="x", shape=sx, dtype=dx, is_data=True)
    blk.create_var(name="y", shape=sy, dtype=dy, is_data=True)
    blk.create_var(name="o", shape=None, dtype=None)
    return main, blk


def _matmul_mismatch(pkg):
    main, blk = _two_vars(pkg, [4, 8], [7, 3])
    blk.append_op("matmul", inputs={"X": ["x"], "Y": ["y"]},
                  outputs={"Out": ["o"]})
    return main, {"feeds": {"x": (4, 8), "y": (7, 3)}}


def _reshape_mismatch(pkg):
    main = pkg.Program()
    blk = main.global_block()
    blk.create_var(name="x", shape=[4, 16], dtype="float32", is_data=True)
    blk.create_var(name="o", shape=None, dtype=None)
    blk.append_op("reshape2", inputs={"X": ["x"]}, outputs={"Out": ["o"]},
                  attrs={"shape": [4, 15]})
    return main, {"feeds": {"x": (4, 16)}}


def _float_mix(pkg):
    main, blk = _two_vars(pkg, [4, 8], [4, 8], "float32", "float16")
    blk.append_op("elementwise_add", inputs={"X": ["x"], "Y": ["y"]},
                  outputs={"Out": ["o"]})
    return main, {"feeds": {"x": (4, 8), "y": (4, 8)}}


def _ce_misaligned(pkg):
    main, blk = _two_vars(pkg, [16, 4], [8, 1], dy="int64")
    blk.append_op("softmax_with_cross_entropy",
                  inputs={"Logits": ["x"], "Label": ["y"]},
                  outputs={"Softmax": ["s"], "Loss": ["o"]})
    blk.create_var(name="s", shape=None, dtype=None)
    return main, {"feeds": {"x": (16, 4), "y": (8, 1)}}


def _not_broadcastable(pkg):
    main, blk = _two_vars(pkg, [4, 8], [4, 7])
    blk.append_op("elementwise_mul", inputs={"X": ["x"], "Y": ["y"]},
                  outputs={"Out": ["o"]})
    return main, {"feeds": {"x": (4, 8), "y": (4, 7)}}


def _unknown_op(pkg):
    main = pkg.Program()
    blk = main.global_block()
    blk.create_var(name="x", shape=[4, 8], dtype="float32", is_data=True)
    for n in ("h", "o"):
        blk.create_var(name=n, shape=None, dtype=None)
    blk.append_op("definitely_not_an_op", inputs={"X": ["x"]},
                  outputs={"Out": ["h"]})
    blk.append_op("matmul", inputs={"X": ["h"], "Y": ["x"]},
                  outputs={"Out": ["o"]})
    return main, {"feeds": {"x": (4, 8)}, "passes": [PASS_SHAPE]}


def _strategy(pkg, mesh, **kw):
    bs = pkg.BuildStrategy(**kw)
    bs.mesh_axes = mesh
    return bs


def _quantize_mp(pkg):
    return pkg.Program(), {"build_strategy": _strategy(
        pkg, {"dp": 2, "mp": 4}, quantize_collectives=True)}


def _feed_not_dp_divisible(pkg):
    main = pkg.Program()
    main.global_block().create_var(name="x", shape=[-1, 8],
                                   dtype="float32", is_data=True)
    return main, {"feeds": {"x": (7, 8)},
                  "build_strategy": _strategy(pkg, {"dp": 2})}


def _mp_axis(pkg, axis):
    main = pkg.Program()
    v = main.global_block().create_var(name="w", shape=[5, 8],
                                       dtype="float32")
    v.sharding = (axis, None)
    return main, {"build_strategy": _strategy(pkg, {"dp": 2, "mp": 2})}


def _dead_ops(pkg):
    main = pkg.Program()
    blk = main.global_block()
    blk.create_var(name="x", shape=[4], dtype="float32", is_data=True)
    for n in ("live", "dead1", "dead2"):
        blk.create_var(name=n, shape=[4], dtype="float32")
    blk.append_op("scale", inputs={"X": ["x"]}, outputs={"Out": ["live"]},
                  attrs={"scale": 2.0})
    blk.append_op("scale", inputs={"X": ["x"]}, outputs={"Out": ["dead1"]},
                  attrs={"scale": 3.0})
    blk.append_op("scale", inputs={"X": ["dead1"]},
                  outputs={"Out": ["dead2"]}, attrs={"scale": 4.0})
    return main


def _dce_chain(pkg):
    return _dead_ops(pkg), {"feeds": {"x": (4,)}, "fetch_list": ["live"]}


def _dce_no_roots(pkg):
    return _dead_ops(pkg), {"feeds": {"x": (4,)}}


def _dce_roots(pkg):
    main = pkg.Program()
    blk = main.global_block()
    blk.create_var(name="x", shape=[4], dtype="float32", is_data=True)
    blk.create_var(name="w", shape=[4], dtype="float32", persistable=True)
    blk.create_var(name="g", shape=[4], dtype="float32")
    blk.create_var(name="out", shape=[4], dtype="float32")
    blk.append_op("c_allreduce_sum", inputs={"X": ["x"]},
                  outputs={"Out": ["g"]})
    blk.append_op("scale", inputs={"X": ["x"]}, outputs={"Out": ["w"]},
                  attrs={"scale": 0.9})
    blk.append_op("scale", inputs={"X": ["x"]}, outputs={"Out": ["out"]},
                  attrs={"scale": 1.0})
    return main, {"feeds": {"x": (4,)}, "fetch_list": []}


def _two_errors(pkg):
    main = pkg.Program()
    blk = main.global_block()
    blk.create_var(name="x", shape=[4, 8], dtype="float32", is_data=True)
    blk.create_var(name="y", shape=[3, 9], dtype="float32", is_data=True)
    for n in ("a", "b"):
        blk.create_var(name=n, shape=None, dtype=None)
    blk.append_op("matmul", inputs={"X": ["x"], "Y": ["y"]},
                  outputs={"Out": ["a"]})
    blk.append_op("reshape2", inputs={"X": ["x"]}, outputs={"Out": ["b"]},
                  attrs={"shape": [5, 5]})
    return main, {"feeds": {"x": (4, 8), "y": (3, 9)}}


CASES = {
    "def_use_dangling": (_dangling, 1),
    "def_use_never_produced_fed": (
        lambda pkg: _never_produced(pkg, {}), 1),
    "def_use_never_produced_unknown_feeds": (
        lambda pkg: _never_produced(pkg, None), 1),
    "def_use_def_before_use": (_def_before_use, 1),
    "def_use_backward_after_optimize": (_backward_after_optimize, 1),
    "shape_matmul_contraction": (_matmul_mismatch, 1),
    "shape_reshape_elements": (_reshape_mismatch, 1),
    "shape_float_mix": (_float_mix, 1),
    "shape_ce_label_misaligned": (_ce_misaligned, 1),
    "shape_not_broadcastable": (_not_broadcastable, 1),
    "shape_unknown_op": (_unknown_op, 0),
    "sharding_quantize_needs_pure_dp": (_quantize_mp, 1),
    "sharding_feed_not_dp_divisible": (_feed_not_dp_divisible, 1),
    "sharding_mp_axis_divisibility": (lambda pkg: _mp_axis(pkg, "mp"), 1),
    "sharding_unknown_axis": (lambda pkg: _mp_axis(pkg, "tp9"), 1),
    "dce_dead_chain": (_dce_chain, 2),
    "dce_needs_fetch_roots": (_dce_no_roots, 0),
    "dce_persistable_and_collective_roots": (_dce_roots, 1),
    "strict_two_errors": (_two_errors, 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_corpus_gives_the_jax_packages_diagnostics(case):
    build, n = CASES[case]
    got = []
    for pkg, mod in PACKAGES:
        program, kw = build(pkg)
        got.append(_key(mod.verify_program(program, **kw)))
    assert got[1] == got[0]
    assert len(got[1]) == n, got[1]


def test_strict_error_lists_every_violation():
    program, kw = _two_errors(ptt)
    result = analysis.verify_program(program, **kw)
    with pytest.raises(ProgramVerificationError) as ei:
        raise ProgramVerificationError(result)
    assert "contraction width" in str(ei.value)
    assert "element count" in str(ei.value)
    assert ei.value.result is result


def test_shape_rules_cover_the_jax_packages_op_types():
    jregistry.get_shape_rule("matmul")
    registry.get_shape_rule("matmul")
    assert sorted(registry._SHAPE_RULES) == sorted(jregistry._SHAPE_RULES)
    from paddle_tpu_torch.ops.shape_rules import TensorMeta

    class _Op(object):
        type = "squared_l2_norm"
    out = registry.get_shape_rule("squared_l2_norm")(
        _Op(), {"X": [TensorMeta((4, 8), "float32")]}, {})
    assert out["Out"][0].shape == ()


# ---------------------------------------------------------------------------
# wiring: strict / warn / off at the port's compile seams
# ---------------------------------------------------------------------------

def _train_program():
    main, startup = ptt.Program(), ptt.Program()
    with ptt.unique_name.guard(), ptt.program_guard(main, startup):
        L = ptt.layers
        x = L.data("x", [8], dtype="float32")
        y = L.data("y", [1], dtype="int64")
        logits = L.fc(L.fc(x, size=16, act="relu"), size=4)
        loss = L.mean(L.softmax_with_cross_entropy(logits, y))
        ptt.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss


def _feed(batch=16):
    rng = np.random.RandomState(0)
    return {"x": rng.rand(batch, 8).astype(np.float32),
            "y": rng.randint(0, 4, (batch, 1)).astype(np.int64)}


def test_executor_seam_strict_catches_malformed_program():
    """The suite pins PADDLE_TPU_VERIFY=strict: Executor.run refuses a
    malformed program with located diagnostics before any op runs."""
    main = ptt.Program()
    blk = main.global_block()
    blk.create_var(name="x", shape=[-1, 8], dtype="float32", is_data=True)
    blk.create_var(name="o", shape=None, dtype=None)
    blk.append_op("matmul", inputs={"X": ["x"], "Y": ["missing_w"]},
                  outputs={"Out": ["o"]})
    assert analysis.env_verify_mode() == "strict"
    exe = ptt.Executor(ptt.CPUPlace())
    with pytest.raises(ProgramVerificationError, match="missing_w"):
        exe.run(main, feed={"x": np.zeros((4, 8), np.float32)},
                fetch_list=["o"], scope=ptt.Scope())
    with pytest.raises(ProgramVerificationError, match="missing_w"):
        exe.run_steps(main, feed={"x": np.zeros((2, 4, 8), np.float32)},
                      fetch_list=["o"], scope=ptt.Scope())


def test_off_mode_never_calls_the_verifier(monkeypatch):
    main, startup, loss = _train_program()
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)

    def boom(*a, **kw):
        raise AssertionError("verifier ran in off mode")
    monkeypatch.setattr(analysis, "verify_program", boom)
    monkeypatch.setenv("PADDLE_TPU_VERIFY", "off")
    out, = exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    assert np.isfinite(out).all()
    comp = ptt.CompiledProgram(main, ptt.BuildStrategy(
        verify_program="off")).with_data_parallel(loss_name=loss.name)
    out, = exe.run(comp, feed=_feed(), fetch_list=[loss], scope=scope)
    assert np.isfinite(out).all()


def test_warn_mode_logs_and_counts_but_does_not_raise():
    resilience.clear_events()
    resilience.clear_analysis()
    program, _ = _reshape_mismatch(ptt)
    result = compiler.verify_for_compile(
        program, ptt.BuildStrategy(verify_program="warn"),
        feeds={"x": (4, 16)}, fetch_names=["o"])
    assert result is not None and result.errors()
    assert resilience.analysis_totals()[(PASS_SHAPE, "error")] == 1
    evs = resilience.events("program_analysis")
    assert evs and evs[-1]["errors"] == 1 and evs[-1]["mode"] == "warn"
    assert 'analysis_diagnostics_total{pass="shape_dtype",' \
        'severity="error"} 1' in resilience.metrics_text()
    resilience.clear_analysis()


def test_memo_is_one_walk_per_program_version(monkeypatch):
    main, startup, loss = _train_program()
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    calls = []
    real = analysis.verify_program

    def counting(*a, **kw):
        calls.append(kw.get("feeds"))
        return real(*a, **kw)
    monkeypatch.setattr(analysis, "verify_program", counting)
    for _ in range(4):
        exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    assert len(calls) == 1
    assert calls[0] == {"x": (16, 8), "y": (16, 1)}   # the real feeds
    exe.run(main, feed=_feed(8), fetch_list=[loss], scope=scope)
    assert len(calls) == 2                   # a new shape is a new walk


def test_memo_is_per_strategy_not_just_per_program():
    main = ptt.Program()
    r1 = compiler.verify_for_compile(main, _strategy(
        ptt, {"dp": 2, "mp": 4}, verify_program="strict"))
    assert r1 is not None and not r1.errors()
    with pytest.raises(ProgramVerificationError,
                       match="pure data-parallel"):
        compiler.verify_for_compile(main, _strategy(
            ptt, {"dp": 2, "mp": 4}, verify_program="strict",
            quantize_collectives=True))


def test_memo_evicts_stale_versions():
    main = ptt.Program()
    blk = main.global_block()
    blk.create_var(name="x", shape=[4], dtype="float32", is_data=True)
    bs = ptt.BuildStrategy(verify_program="strict")
    for i in range(5):
        blk.create_var(name="o%d" % i, shape=[4], dtype="float32")
        blk.append_op("scale", inputs={"X": ["x"]},
                      outputs={"Out": ["o%d" % i]}, attrs={"scale": 1.0})
        compiler.verify_for_compile(main, bs, feeds={"x": (4,)},
                                    fetch_names=["o%d" % i])
    assert {k[0] for k in main._verify_cache} == {main._version}


def test_allowlist_suppresses_and_survives_clone_and_prune():
    main = _dead_ops(ptt)
    kw = {"feeds": {"x": (4,)}, "fetch_list": ["live"]}
    assert [d.pass_name for d in analysis.verify_program(main, **kw)] \
        == [PASS_DCE, PASS_DCE]
    analysis.allowlist(main, PASS_DCE, reason="test: vetted dead ops")
    for derived in (main, main.clone(), main.clone(for_test=True),
                    main._prune(["x"], ["live"])):
        assert not list(analysis.verify_program(derived, **kw))
    with pytest.raises(ValueError, match="unknown analysis pass"):
        analysis.allowlist(main, "no_such_pass")


def test_allowlist_after_a_strict_failure_takes_effect():
    program, _ = _reshape_mismatch(ptt)
    bs = ptt.BuildStrategy(verify_program="strict")
    with pytest.raises(ProgramVerificationError):
        compiler.verify_for_compile(program, bs, feeds={"x": (4, 16)},
                                    fetch_names=["o"])
    analysis.allowlist(program, PASS_SHAPE, reason="test: vetted reshape")
    r = compiler.verify_for_compile(program, bs, feeds={"x": (4, 16)},
                                    fetch_names=["o"])
    assert r is not None and not r.errors()


def test_pipeline_strategy_raises_not_ported_before_the_verifier(
        monkeypatch):
    """The verifier's pipeline pass comes with the multi-GPU slice: a
    pipeline strategy is refused before any verifier walk."""
    main, startup, loss = _train_program()
    calls = []
    monkeypatch.setattr(analysis, "verify_program",
                        lambda *a, **kw: calls.append(1))
    for kw in ({"pp_stages": 2}, {"pp_stages": 2, "pp_micro_batches": 3}):
        bs = ptt.BuildStrategy(verify_program="strict", **kw)
        comp = ptt.CompiledProgram(main, bs).with_mesh({"pp": 1})
        with pytest.raises(ptt.NotPortedError, match="pipeline"):
            comp.compile_plan(torch.device("cpu"))
        exe = ptt.Executor(ptt.CPUPlace())
        with pytest.raises(ptt.NotPortedError, match="pipeline"):
            exe.run(comp, feed=_feed(), fetch_list=[loss],
                    scope=ptt.Scope())
    assert not calls
    assert analysis.PASS_PIPELINE in analysis.PASS_NAMES
    assert analysis.PASS_PIPELINE not in analysis.registered_passes()


# ---------------------------------------------------------------------------
# the zoo verifies clean in strict mode; serialized envelopes alike
# ---------------------------------------------------------------------------

def _zoo():
    from paddle_tpu_torch.models import (bert, dcgan, deepfm, gpt, ocr,
                                         resnet, sequence_labeling, simple,
                                         transformer)
    cfg = bert.BertConfig(vocab_size=128, hidden_size=32, num_layers=2,
                          num_heads=2, ff_size=64, max_position=64)
    yield "bert", bert.bert_pretrain_program(
        cfg, batch_size=4, seq_len=16, max_preds_per_seq=4)
    gcfg = gpt.GPTConfig(vocab_size=128, hidden_size=32, num_layers=2,
                         num_heads=2, max_position=64)
    yield "gpt", gpt.gpt_pretrain_program(gcfg, batch_size=4, seq_len=16)
    yield "mlp", simple.mlp_classifier_program(input_dim=16, hidden=(8,),
                                               classes=4)
    yield "resnet", resnet.resnet_train_program(
        depth=18, class_dim=10, image_shape=(3, 32, 32))
    yield "deepfm", deepfm.deepfm_train_program(
        feature_dim=100, embedding_size=4, sparse_fields=4, dense_dim=3)
    yield "transformer", transformer.transformer_train_program(
        transformer.TransformerConfig(
            src_vocab=64, trg_vocab=64, max_length=32, d_model=32,
            d_inner=64, n_head=2, n_layer=1), src_len=8, trg_len=8)
    yield "ocr", ocr.crnn_ctc_program(num_classes=10,
                                      image_shape=(1, 16, 32))
    yield "lac", sequence_labeling.bigru_crf_program(
        vocab_size=50, num_labels=5, emb_dim=8, hidden=8, seq_len=8)
    yield "dcgan", dcgan.dcgan_train_program(dcgan.DCGANConfig(
        noise_dim=8, base_channels=4, image_size=16))


def _names(seq):
    seq = list(seq.values()) if isinstance(seq, dict) else list(seq)
    return [getattr(f, "name", f) for f in seq]


def test_zoo_verifies_clean_in_strict_mode():
    """Build only, no run: every zoo program verifies with zero errors,
    and its compile seam passes under "strict"."""
    for name, built in _zoo():
        main, _, feeds, fetch = built
        r = analysis.verify_program(main, feeds=_names(feeds),
                                    fetch_list=_names(fetch))
        assert not r.errors(), "%s: %s" % (name, r.summary())
        compiler.verify_for_compile(main, ptt.BuildStrategy(
            verify_program="strict"), fetch_names=_names(fetch))


def test_model_meta_verdict_is_the_same_for_either_packages_directory(
        tmp_path):
    """A model directory written by either package verifies the same
    in both, and a corrupted envelope or program is refused by both."""
    verdicts = []
    for pkg, mod in PACKAGES:
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            x = pkg.layers.data("x", [6], dtype="float32")
            y = pkg.layers.softmax(pkg.layers.fc(
                pkg.layers.fc(x, 8, act="relu"), 3))
        d = tmp_path / pkg.__name__
        with pkg.scope_guard(pkg.Scope()):
            exe = pkg.Executor(pkg.CPUPlace())
            exe.run(startup)
            pkg.save_inference_model(str(d), ["x"], [y], exe,
                                     main_program=main)
        meta = json.loads((d / "__model__.json").read_text())
        for _, other in PACKAGES:
            verdicts.append(_key(other.verify_model_meta(meta)))
        bad = json.loads(json.dumps(meta))
        ops = bad["program"]["blocks"][0]["ops"]
        ops[0]["inputs"] = {k: ["gone_var"] for k in ops[0]["inputs"]}
        for _, other in PACKAGES:
            assert other.verify_model_meta(bad).errors()
            with pytest.raises(ValueError, match="corrupt program IR"):
                other.verify_model_meta({"program": {"format": "?"}})
    assert all(v == verdicts[0] for v in verdicts), verdicts
