"""The port's compiled-program front door on one card
(paddle_tpu_torch/framework/compiler.py, compiler.py,
parallel_executor.py) against the JAX package's: BuildStrategy's knobs,
defaults and validation (the same bad value raises the same error
type), the collective timeout's env default, CompiledProgram /
ParallelExecutor on ``CPUPlace()`` equal to ``Executor.run`` bit for bit
(``run`` and ``run_steps``), and what raises NotPortedError on one card.
No tolerance: every comparison is exact."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.framework import compiler as jcomp
from paddle_tpu_torch.framework import compiler as tcomp
from paddle_tpu_torch.framework.analysis import ProgramVerificationError


def _toy(pkg, lr=0.1, dropout=False):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        L = pkg.layers
        x = L.data("x", [4], dtype="float32")
        y = L.data("y", [1], dtype="int64")
        h = L.fc(x, size=8, act="relu")
        if dropout:
            h = L.dropout(h, 0.5)
        loss = L.mean(L.softmax_with_cross_entropy(L.fc(h, size=3), y))
        pkg.optimizer.Adam(lr).minimize(loss)
    return main, startup, loss


def _feeds(n, seed=0, batch=8):
    rng = np.random.RandomState(seed)
    return [{"x": rng.rand(batch, 4).astype(np.float32),
             "y": rng.randint(0, 3, (batch, 1)).astype(np.int64)}
            for _ in range(n)]


def _state(scope):
    return {n: v.clone() for n, v in scope.items()
            if isinstance(v, torch.Tensor)}


def _same(a, b):
    assert sorted(a) == sorted(b)
    for n in a:
        assert torch.equal(a[n], b[n]), n


@pytest.mark.parametrize("kw,exc", [
    (dict(numeric_policy="retry"), ValueError),
    (dict(numeric_skip_budget=0), ValueError),
    (dict(pp_recut_slots=0, pp_stages=2), ValueError),
    (dict(pp_recut_slots=2), ValueError),
    (dict(no_such_knob=1), TypeError)])
def test_build_strategy_validation_matches_the_jax_package(kw, exc):
    with pytest.raises(exc) as je:
        jcomp.BuildStrategy(**kw)
    with pytest.raises(exc) as te:
        tcomp.BuildStrategy(**kw)
    assert str(te.value) == str(je.value)


def test_build_strategy_knobs_and_defaults_match_the_jax_package():
    j, t = jcomp.BuildStrategy(), tcomp.BuildStrategy()
    assert sorted(vars(t)) == sorted(vars(j))
    for k, v in vars(j).items():
        assert getattr(t, k) == v, k
    assert vars(tcomp.ExecutionStrategy()) == vars(jcomp.ExecutionStrategy())
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import compiler
    assert fluid.BuildStrategy is tcomp.BuildStrategy
    assert fluid.ParallelExecutor is ptt.ParallelExecutor
    assert compiler.CompiledProgram is ptt.CompiledProgram


def test_collective_timeout_env_default(monkeypatch):
    for raw, want in (("12.5", 12.5), ("", None), ("  30 ", 30.0)):
        monkeypatch.setenv("PADDLE_TPU_COLLECTIVE_TIMEOUT_S", raw)
        assert tcomp.BuildStrategy().collective_timeout_s == want == \
            jcomp.BuildStrategy().collective_timeout_s
    monkeypatch.setenv("PADDLE_TPU_COLLECTIVE_TIMEOUT_S", "30s")
    with pytest.raises(ValueError, match="PADDLE_TPU_COLLECTIVE_TIMEOUT_S"):
        tcomp.BuildStrategy()
    with pytest.raises(ValueError, match="PADDLE_TPU_COLLECTIVE_TIMEOUT_S"):
        jcomp.BuildStrategy()


@pytest.mark.parametrize("kw", [dict(kernel_policy="fast"),
                                dict(use_pallas={"adam", "conv2d"})])
def test_kernel_knobs_validate_as_the_jax_package(kw):
    main, _, loss = _toy(pt)
    with pytest.raises(ValueError) as je:
        comp = jcomp.CompiledProgram(main, jcomp.BuildStrategy(**kw))
        comp.with_data_parallel(loss_name=loss.name)
        comp._kernel_policy()
        comp._pallas_ctx(comp._mesh_obj())
    tmain, tstart, tloss = _toy(ptt)
    exe = ptt.Executor(ptt.CPUPlace())
    scope = ptt.Scope()
    exe.run(tstart, scope=scope)
    with pytest.raises(ValueError) as te:
        exe.run(ptt.CompiledProgram(tmain, ptt.BuildStrategy(**kw))
                .with_data_parallel(loss_name=tloss.name),
                feed=_feeds(1)[0], fetch_list=[tloss], scope=scope)
    assert str(te.value) == str(je.value)


def test_with_data_parallel_on_one_device_gives_dp_1():
    main, _, loss = _toy(ptt)
    comp = ptt.CompiledProgram(main).with_data_parallel(loss_name=loss.name)
    assert comp._build_strategy.mesh_axes == {"dp": 1}
    cpu = torch.device("cpu")
    plan = comp.compile_plan(cpu)
    assert plan.kind == "single_jit"
    # the mesh, the numeric guard, then the kernel selection: no
    # use_pallas, no cache, "auto" with the selection layer's fingerprint
    assert plan.token[:3] == ((("dp", 1),), False, "raise")
    assert plan.token[3][:2] == ((), None)
    assert plan.token[3][2][0] == "auto"
    guarded = ptt.CompiledProgram(main, ptt.BuildStrategy(
        numeric_policy="skip")).with_data_parallel()
    assert guarded._cache_token(cpu) != comp._cache_token(cpu)


@pytest.mark.parametrize("dropout", [False, True])
def test_compiled_program_equals_executor_run_bit_for_bit(dropout):
    """run, run_steps and ParallelExecutor through the front door, on
    copies of one started scope (the run counter too): every fetch and
    every persistable equal to Executor.run's."""
    main, startup, loss = _toy(ptt, dropout=dropout)
    start = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=start)
    feeds = _feeds(4)

    def copy():
        out = ptt.Scope()
        for n, v in start.items():
            out.set_var(n, v.clone() if isinstance(v, torch.Tensor) else v)
        return out
    ref_scope, ref = copy(), []
    for f in feeds:
        ref.append(exe.run(main, feed=f, fetch_list=[loss],
                           scope=ref_scope)[0])
    comp = ptt.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, build_strategy=ptt.BuildStrategy(),
        exec_strategy=ptt.ExecutionStrategy())
    scope = copy()
    got = [exe.run(comp, feed=f, fetch_list=[loss], scope=scope)[0]
           for f in feeds]
    np.testing.assert_array_equal(np.stack(got), np.stack(ref))
    _same(_state(scope), _state(ref_scope))
    assert scope.find_var("@EAGER_SALT@") == ref_scope.find_var(
        "@EAGER_SALT@")
    # run_steps on a CompiledProgram: one window of the same feeds
    scope = copy()
    window = {k: np.stack([f[k] for f in feeds]) for k in feeds[0]}
    out, = exe.run_steps(comp, feed=window, fetch_list=[loss], scope=scope)
    np.testing.assert_array_equal(out, np.stack(ref))
    _same(_state(scope), _state(ref_scope))
    # ParallelExecutor (use_cuda=False asks for the CPU)
    scope = copy()
    pe = ptt.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                              main_program=main, scope=scope)
    got = [pe.run([loss], feed=f)[0] for f in feeds]
    np.testing.assert_array_equal(np.stack(got), np.stack(ref))
    _same(_state(scope), _state(ref_scope))
    assert pe.device_count == torch.cuda.device_count()


def test_what_one_card_cannot_run_raises(tmp_path):
    main, startup, loss = _toy(ptt)
    exe = ptt.Executor(ptt.CPUPlace())
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    feed = _feeds(1)[0]

    def run(**kw):
        comp = ptt.CompiledProgram(main, ptt.BuildStrategy(**kw))
        return exe.run(comp.with_data_parallel(loss_name=loss.name),
                       feed=feed, fetch_list=[loss], scope=scope)
    # a mesh larger than the visible devices: make_mesh's ValueError
    with pytest.raises(ValueError, match="needs 2 devices, only 1"):
        run(mesh_axes={"dp": 2})
    # a mesh that fits but spans devices, pipelines, quantized sync
    with pytest.raises(ptt.NotPortedError, match="torch.distributed"):
        tcomp.check_mesh({"dp": 2, "mp": 2}, 4)
    with pytest.raises(ptt.NotPortedError, match="pipeline"):
        run(pp_stages=2, mesh_axes={"pp": 1})
    with pytest.raises(ValueError, match="pipeline"):
        run(pp_stages=2, mesh_axes={"pp": 1}, numeric_policy="skip")
    with pytest.raises(ptt.NotPortedError, match="quantize_collectives"):
        run(quantize_collectives=True)
    # the verifier: every mode runs a sound program (the suite's default
    # is "strict"); "strict" refuses a malformed one with every error
    for mode in ("strict", "warn", "off"):
        run(verify_program=mode)
    bad = main.clone()
    bad.global_block().append_op(
        "scale", inputs={"X": ["no_such_var"]},
        outputs={"Out": [loss.name]}, attrs={"scale": 1.0})
    with pytest.raises(ProgramVerificationError, match="no_such_var"):
        exe.run(ptt.CompiledProgram(bad, ptt.BuildStrategy(
            verify_program="strict")).with_data_parallel(
                loss_name=loss.name),
            feed=feed, fetch_list=[loss], scope=scope)
    # kernel_policy: "xla" has no second lowering on the card (the error
    # points at the per-call-site tuning instead); on the CPU every op
    # runs its plain version whatever the policy, with or without a
    # tuning cache, whose verdicts the call sites still decide by
    comp = ptt.CompiledProgram(main, ptt.BuildStrategy(kernel_policy="xla"))
    with pytest.raises(ptt.NotPortedError, match="xla") as e:
        comp.compile_plan(torch.device("cuda", 0))
    assert "pallas_tune_cache" in str(e.value)
    assert "Queue 1 item 5" not in str(e.value)
    from paddle_tpu_torch.ops import kernel_dispatch as kd
    from paddle_tpu_torch.ops.kernels import autotune as at
    cache = at.AutotuneCache(str(tmp_path / "tune.json"))
    cache.put(kd.cache_key("adam", (32,), "float32", {"dp": 1}, "cpu"),
              {"impl": "pallas", "config": {"blocks_per_sm": 4}})
    cache.save()
    ref = run()
    for policy in ("xla", "auto", "pallas"):
        run(kernel_policy=policy, use_pallas={"adam"})
        got = run(kernel_policy=policy, use_pallas={"adam"},
                  pallas_tune_cache=cache.path)
        assert got[0].shape == ref[0].shape and np.isfinite(got[0]).all()
    # the JAX package's parity no-ops are accepted
    run(fuse_all_reduce_ops=False, memory_optimize=False,
        enable_inplace=False, num_trainers=1, trainer_id=0,
        fuse_elewise_add_act_ops=False)


def test_compiled_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main, startup, loss = _toy(ptt)
    comp = ptt.CompiledProgram(main).with_data_parallel(loss_name=loss.name)
    with pytest.raises(ptt.NoCUDADeviceError):
        ptt.Executor().run(comp, feed=_feeds(1)[0], fetch_list=[loss])
    with pytest.raises(ptt.NoCUDADeviceError):
        ptt.ParallelExecutor(loss_name=loss.name, main_program=main)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    out, = exe.run(comp, feed=_feeds(1)[0], fetch_list=[loss], scope=scope)
    assert out.shape == (1,)


def test_compile_plan_defaults_to_cuda_and_raises_without_it(monkeypatch):
    """compile_plan() with no device plans for CUDAPlace(0), like every
    entry point of the port: without a card it raises NoCUDADeviceError
    (it once planned for the CPU quietly); an explicit CPU device plans."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main, _, loss = _toy(ptt)
    comp = ptt.CompiledProgram(main).with_data_parallel(loss_name=loss.name)
    with pytest.raises(ptt.NoCUDADeviceError):
        comp.compile_plan()
    assert comp.compile_plan(torch.device("cpu")).kind == "single_jit"
