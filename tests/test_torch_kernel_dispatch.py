"""Kernel dispatch in the port (ops/kernel_dispatch.py, the compiler's
per-compile config, the Executor's once-a-compile decisions) held to the
JAX package's pallas_dispatch on the CPU.

The same inputs go through both: ``cache_key`` strings, ``choose`` on one
shared cache file (exact key, the mesh-less fallback, a miss resolved by
a cost model, no signal, a zero-probe entry), the counters and spans a
decision exports, the count of decisions a compile makes for the same
program, and a ``pallas_q`` verdict's loss. The port's own rules: no
cache, no change; an "xla" verdict refused on a card; a config that does
not fit refused by name; a policy flip or a rewritten cache re-plans.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.framework import resilience as jres
from paddle_tpu.ops import pallas_dispatch as pd
from paddle_tpu.ops.pallas import autotune as jat
from paddle_tpu_torch.framework import obs, resilience
from paddle_tpu_torch.framework.executor import _graph_key
from paddle_tpu_torch.ops import kernel_dispatch as kd
from paddle_tpu_torch.ops.kernels import autotune as at

CPU = torch.device("cpu")
CARD = "nvidia-h100-80gb-hbm3"


class _StubModel(object):
    """One fixed prediction, for both packages' ``choose``."""

    def predict_config(self, op, shape, **kw):
        return {"config": {"threads": 512}, "predicted_s": 1.5e-3,
                "source": "fitted"}


@pytest.mark.parametrize("op,shape,dtypes,mesh,backend", [
    ("adam", (4096,), (np.float32, torch.float32), None, "cpu"),
    ("layer_norm", (16384, 768), ("bfloat16", torch.bfloat16),
     {"mp": 2, "dp": 8}, CARD),
    ("fused_mlm_head_loss", (2560, 32768), ("float32", torch.float32),
     None, None),
    ("softmax_with_cross_entropy", (128, 2), (np.float32, "float32"),
     {"dp": 1}, "cpu"),
])
def test_cache_key_strings_equal_the_jax_packages(op, shape, dtypes, mesh,
                                                  backend):
    jdt = np.dtype(dtypes[0]) if dtypes[0] is np.float32 else dtypes[0]
    assert kd.cache_key(op, shape, dtypes[1], mesh, backend) == \
        pd.cache_key(op, shape, jdt, mesh, backend)


def _shared_cache(path):
    """One cache file, written by the port and read by both packages."""
    cache = at.AutotuneCache(path)
    cache.put(kd.cache_key("adam", (4096,), "float32", None, "cpu"),
              {"impl": "pallas", "config": {"blocks_per_sm": 4},
               "pallas_s": 1e-4})
    cache.put(kd.cache_key("layer_norm", (64, 32), "float32", {"dp": 8},
                           "cpu"),
              {"impl": "xla", "xla_s": 5e-5})
    cache.put(kd.cache_key("layer_norm", (128, 32), "float32", None, "cpu"),
              {"impl": "pallas", "config": {"blocks_per_sm": 4},
               "pallas_s": 2e-5, "predicted_s": 3e-5,
               "source": "costmodel"})
    cache.save()
    return path


@pytest.mark.parametrize("case", [
    # (op, shape, mesh axes, with a model)
    ("adam", (4096,), None, False),            # exact key
    ("adam", (4096,), {"dp": 8}, False),       # the mesh-less fallback
    ("layer_norm", (64, 32), {"dp": 8}, False),  # an exact "xla" verdict
    ("layer_norm", (128, 32), None, False),    # a zero-probe entry
    ("softmax_with_cross_entropy", (256, 512), None, True),  # a miss
    ("softmax_with_cross_entropy", (256, 512), None, False),  # no signal
])
def test_choose_matches_the_jax_package_on_one_cache_file(tmp_path, case):
    op, shape, mesh, with_model = case
    path = _shared_cache(str(tmp_path / "shared.json"))
    model = _StubModel() if with_model else None
    jcfg = pd.PallasConfig({op}, interpret=True,
                           tuning=jat.AutotuneCache(path), mesh_axes=mesh,
                           backend="cpu", cost_model=model)
    tcfg = kd.PallasConfig({op}, tuning=at.AutotuneCache(path),
                           mesh_axes=mesh, backend="cpu", cost_model=model)
    j = pd.choose(jcfg, op, shape, np.dtype("float32"))
    t = kd.choose(tcfg, op, shape, torch.float32)
    assert (t.impl, t.config, t.source, t.predicted_s, t.measured_s) == \
        (j.impl, j.config, j.source, j.predicted_s, j.measured_s)
    assert tuple(t) == tuple(j)


def test_kernel_choice_unpacks_as_a_tuple():
    c = kd.KernelChoice("pallas", {"threads": 512}, "predicted",
                        predicted_s=1e-3)
    impl, config = c
    assert (impl, config) == ("pallas", {"threads": 512})
    assert c == ("pallas", {"threads": 512})
    assert c.source == "predicted" and c.predicted_s == 1e-3
    assert kd.choose(None, "adam", (4096,), torch.float32) == \
        ("pallas", None)


def test_a_decision_is_counted_and_spanned(tmp_path):
    resilience.clear_events()
    obs.clear()
    obs.enable()
    try:
        cfg = kd.PallasConfig({"adam"}, backend="cpu",
                              cost_model=_StubModel(),
                              tuning=at.AutotuneCache(str(tmp_path / "n")))
        kd.choose(cfg, "adam", (65536,), torch.float32)
    finally:
        obs.disable()
    assert resilience.kernel_choice_totals() == {
        ("adam", "pallas", "predicted"): 1}
    sp = obs.spans(name="kernel_choice")[-1]
    assert sp["labels"]["op"] == "adam" and sp["labels"]["shape"] == "65536"
    assert sp["labels"]["dtype"] == "float32"
    assert sp["labels"]["predicted_s"] == 1.5e-3
    series = [c for c in resilience.metrics()["counters"]
              if c["name"].endswith("_kernel_choice_total")]
    assert series == [{"name": resilience.METRIC_PREFIX +
                       "_kernel_choice_total",
                       "labels": {"op": "adam", "impl": "pallas",
                                  "source": "predicted"}, "value": 1}]
    assert "_kernel_choice_total" in resilience.metrics_text()
    resilience.clear_events()
    assert resilience.kernel_choice_totals() == {}


def _ce_program(pkg, seed=0):
    """LayerNorm (scale and bias), a blockwise-CE loss over 128 rows of
    256 classes, Adam: one call site of each dispatched op family but the
    head (main, startup, loss)."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", [128, 32], dtype="float32",
                            append_batch_size=False)
        y = pkg.layers.data("y", [128, 1], dtype="int64",
                            append_batch_size=False)
        h = pkg.layers.layer_norm(pkg.layers.fc(x, 64))
        logits = pkg.layers.fc(h, 256)
        loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(
            logits, y))
        pkg.optimizer.Adam(1e-3).minimize(loss)
    return main, startup, loss


def _feed(rng):
    return {"x": rng.randn(128, 32).astype(np.float32),
            "y": rng.randint(0, 256, (128, 1)).astype(np.int64)}


def test_each_call_site_decides_once_a_compile_as_the_jax_package(rng):
    """Three steps through CompiledProgram(kernel_policy="pallas"): one
    compile, so one decision per call site (1 LayerNorm, 1 CE, 6 Adam),
    in both packages; a second program's compile decides again."""
    feeds = [_feed(rng) for _ in range(3)]
    resilience.clear_kernel_choice()
    main, startup, loss = _ce_program(ptt)
    exe = ptt.Executor(ptt.CPUPlace())
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    comp = ptt.CompiledProgram(main, ptt.BuildStrategy(
        kernel_policy="pallas")).with_data_parallel(loss_name=loss.name)
    for f in feeds:
        exe.run(comp, feed=f, fetch_list=[loss], scope=scope)
    port = resilience.kernel_choice_totals()
    jres.clear_kernel_choice()
    jmain, jstart, jloss = _ce_program(pt)
    jexe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        jexe.run(jstart)
        jcomp = pt.CompiledProgram(jmain, pt.BuildStrategy(
            kernel_policy="pallas")).with_data_parallel(
                loss_name=jloss.name)
        for f in feeds:
            jexe.run(jcomp, feed=f, fetch_list=[jloss])
    jax_totals = jres.kernel_choice_totals()
    assert port == jax_totals
    assert port == {
        ("adam", "pallas", "default"): 6,
        ("layer_norm", "pallas", "default"): 1,
        ("softmax_with_cross_entropy", "pallas", "default"): 1}
    jres.clear_kernel_choice()
    resilience.clear_kernel_choice()


def test_no_cache_no_change_and_the_front_door(monkeypatch, tmp_path):
    """Without a cache no compile has a cost model, so every call site
    keeps its kernel's default launch; "xla" has no config (and on a
    card raises, with guidance that names the tuning cache)."""
    main, _, loss = _ce_program(ptt)

    def comp(**kw):
        return ptt.CompiledProgram(main, ptt.BuildStrategy(**kw))
    assert comp()._kernel_config(CPU) is None
    assert comp(kernel_policy="xla", use_pallas={"adam"}) \
        ._kernel_config(CPU) is None
    cfg = comp(kernel_policy="pallas")._kernel_config(CPU)
    assert cfg.ops == frozenset(kd.PALLAS_OPS) and cfg.tuning is None
    assert cfg.cost_model is None
    cfg = comp(use_pallas={"adam"})._kernel_config(CPU)
    assert cfg.tuning is None and cfg.cost_model is None
    with kd.scope(cfg):
        choice = kd.decide("adam", (4096,), torch.float32)
    assert choice == ("pallas", None) and choice.source == "default"
    # an explicit cache under "auto": every op, the fitted model
    path = _shared_cache(str(tmp_path / "c.json"))
    cfg = comp(pallas_tune_cache=path)._kernel_config(CPU)
    assert cfg.ops == frozenset(kd.PALLAS_OPS)
    assert cfg.cost_model is not None and cfg.policy == "auto"
    with pytest.raises(ptt.NotPortedError, match="pallas_tune_cache"):
        comp(kernel_policy="xla").compile_plan(torch.device("cuda", 0))


def test_the_banked_card_file_serves_a_compile_on_that_card(monkeypatch):
    """Under "auto" with use_pallas, a compile for the card reads the
    committed tools/tuned/<card>.json: measured verdicts at the sweep's
    shapes; elsewhere the default launch, since the file sweeps each
    family at one shape and a compile predicts only from a family
    fitted over two."""
    monkeypatch.setattr(kd, "backend_name", lambda device: CARD)
    main, _, loss = _ce_program(ptt)
    comp = ptt.CompiledProgram(main, ptt.BuildStrategy(
        use_pallas=frozenset(kd.PALLAS_OPS)))
    assert comp._resolve_tune(CPU) == at.banked_cache_path(CARD)
    cfg = comp._kernel_config(CPU)
    banked = json.load(open(at.banked_cache_path(CARD)))["entries"]
    for op, shape in at.DEFAULT_SHAPES.items():
        choice = kd.choose(cfg, op, shape, torch.float32, d=at.HEAD_D)
        key = kd.cache_key(op, shape, "float32", None, CARD)
        assert choice.source == "measured"
        assert choice.config == banked[key]["config"]
        assert choice.measured_s == banked[key]["pallas_s"]
    for op, shape in (("fused_mlm_head_loss", (8192, 32000)),
                      ("layer_norm", (16384, 1024)), ("adam", (768,))):
        unswept = kd.choose(cfg, op, shape, torch.float32, d=768)
        assert unswept == ("pallas", None) and unswept.source == "default"


def _ln_rows(shape, dtype, backend):
    """A sweep's entry of layer_norm at ``shape``: each candidate's
    seconds, from the analytic proxy scaled per config."""
    from paddle_tpu_torch.ops.kernels import costmodel as cm
    res = {}
    for i, c in enumerate(at.CANDIDATES["layer_norm"]):
        f = cm.features("layer_norm", shape, c, dtype)
        res[cm.config_tag(c)] = cm.analytic_seconds(f, dtype) * (1 + 0.1 * i)
    return {kd.cache_key("layer_norm", shape, dtype, None, backend): {
        "impl": "pallas", "config": None, "pallas_s": res[""],
        "results": res, "source": "sweep"}}


def test_a_compile_predicts_only_for_a_family_swept_at_two_shapes(
        tmp_path):
    """A compile's cost model: a layer_norm segment fitted over one
    shape (f32 and bf16 rows, more rows than the fit's basis) leaves a
    never-swept shape on its default launch; a second swept shape makes
    it "predicted"."""
    main, _, _ = _ce_program(ptt)
    path = str(tmp_path / "fit.json")
    cache = at.AutotuneCache(path)
    for key, entry in dict(_ln_rows((16384, 768), "float32", "cpu"),
                           **_ln_rows((16384, 768), "bfloat16",
                                      "cpu")).items():
        cache.put(key, entry)
    cache.save()
    comp = ptt.CompiledProgram(main, ptt.BuildStrategy(
        pallas_tune_cache=path))
    cfg = comp._kernel_config(CPU)
    assert cfg.cost_model.stats()["fitted"] == ["layer_norm@cpu"]
    choice = kd.choose(cfg, "layer_norm", (4096, 768), torch.float32)
    assert choice == ("pallas", None) and choice.source == "default"
    for key, entry in _ln_rows((8192, 1024), "float32", "cpu").items():
        cache.put(key, entry)
    cache.save()
    cfg = comp._kernel_config(CPU)
    choice = kd.choose(cfg, "layer_norm", (4096, 768), torch.float32)
    assert choice.source == "predicted" and choice.predicted_s > 0
    assert choice.config in at.CANDIDATES["layer_norm"]


def test_an_xla_verdict_is_refused_on_a_card_by_name(tmp_path):
    path = _shared_cache(str(tmp_path / "x.json"))
    cache = at.AutotuneCache(path)
    key = kd.cache_key("layer_norm", (64, 32), "float32", None, CARD)
    cache.put(key, {"impl": "xla"})
    cache.save()
    for mesh in (None, {"dp": 1}):     # the exact key, the fallback
        card = kd.PallasConfig({"layer_norm"}, tuning=cache, backend=CARD,
                               mesh_axes=mesh)
        with kd.scope(card), pytest.raises(kd.KernelChoiceError) as e:
            kd.decide("layer_norm", (64, 32), torch.float32)
        assert key in str(e.value) and "xla" in str(e.value)
    # on the CPU the op runs its plain version whatever the verdict
    cpu = kd.PallasConfig({"layer_norm"}, tuning=cache,
                          mesh_axes={"dp": 8}, backend="cpu")
    with kd.scope(cpu):
        assert kd.decide("layer_norm", (64, 32), torch.float32).impl == "xla"


@pytest.mark.parametrize("op,shape,d,config", [
    ("fused_mlm_head_loss", (128, 256), 1100, {"stages": 3}),
    ("fused_mlm_head_loss", (128, 256), 16, {"stages": 6}),
    ("adam", (4096,), None, {"threads": 512}),
    ("layer_norm", (64, 2048), None, {"blocks_per_sm": 16}),
    ("softmax_with_cross_entropy", (128, 256), None, {"threads": 64}),
])
def test_a_config_that_does_not_fit_is_refused_by_name(tmp_path, op, shape,
                                                       d, config):
    cache = at.AutotuneCache(str(tmp_path / "bad.json"))
    key = kd.cache_key(op, shape, "float32", None, "cpu")
    cache.put(key, {"impl": "pallas", "config": config})
    cache.save()
    with kd.scope(kd.PallasConfig({op}, tuning=cache, backend="cpu")), \
            pytest.raises(kd.KernelChoiceError) as e:
        kd.decide(op, shape, torch.float32, d=d)
    assert key in str(e.value) and repr(config) in str(e.value)


def test_a_bad_config_stops_the_compile_before_its_op_runs(rng, tmp_path):
    main, startup, loss = _ce_program(ptt)
    cache = at.AutotuneCache(str(tmp_path / "bad.json"))
    key = kd.cache_key("layer_norm", (128, 64), "float32", None, "cpu")
    cache.put(key, {"impl": "pallas", "config": {"blocks_per_sm": 99}})
    cache.save()
    exe, scope = ptt.Executor(ptt.CPUPlace()), ptt.Scope()
    exe.run(startup, scope=scope)
    comp = ptt.CompiledProgram(main, ptt.BuildStrategy(
        pallas_tune_cache=cache.path)).with_data_parallel(
            loss_name=loss.name)
    with pytest.raises(kd.KernelChoiceError, match="blocks_per_sm"):
        exe.run(comp, feed=_feed(rng), fetch_list=[loss], scope=scope)


def test_policy_flips_and_cache_rewrites_re_plan(rng, tmp_path):
    main, startup, loss = _ce_program(ptt)
    path = _shared_cache(str(tmp_path / "t.json"))

    def token(**kw):
        return ptt.CompiledProgram(main, ptt.BuildStrategy(
            use_pallas={"adam"}, **kw))._cache_token(CPU)
    auto, pal, xla = token(), token(kernel_policy="pallas"), \
        token(kernel_policy="xla")
    assert len({auto, pal, xla}) == 3 and token() == auto
    before = token(pallas_tune_cache=path)
    assert before != auto and token(pallas_tune_cache=path) == before
    # through the Executor: a rewritten cache is a new compile, whose
    # call sites decide again; a repeat is a hit
    exe, scope = ptt.Executor(ptt.CPUPlace()), ptt.Scope()
    exe.run(startup, scope=scope)
    comp = ptt.CompiledProgram(main, ptt.BuildStrategy(
        pallas_tune_cache=path)).with_data_parallel(loss_name=loss.name)
    f = _feed(rng)
    resilience.clear_kernel_choice()
    exe.run(comp, feed=f, fetch_list=[loss], scope=scope)
    n1 = sum(resilience.kernel_choice_totals().values())
    exe.run(comp, feed=f, fetch_list=[loss], scope=scope)
    assert sum(resilience.kernel_choice_totals().values()) == n1 == 8
    cache = at.AutotuneCache(path)
    cache.put(kd.cache_key("adam", (32 * 64,), "float32", None, "cpu"),
              {"impl": "pallas", "config": {"blocks_per_sm": 4},
               "pallas_s": 1e-5})
    cache.save()
    assert token(pallas_tune_cache=path) != before
    n_compiled = len(exe._compiled)
    exe.run(comp, feed=f, fetch_list=[loss], scope=scope)
    assert len(exe._compiled) == n_compiled + 1
    totals = resilience.kernel_choice_totals()
    assert sum(totals.values()) == 2 * n1
    assert totals[("adam", "pallas", "measured")] == 1
    resilience.clear_kernel_choice()


def test_the_graph_key_holds_the_kernel_selection():
    class Plan(object):
        key = ("p",)
    a = kd.PallasConfig({"adam"}, token=("a",))
    b = kd.PallasConfig({"adam"}, token=("b",))
    keys = {_graph_key(Plan, {}, [], None, None, k) for k in (None, a, b)}
    assert len(keys) == 3
    assert _graph_key(Plan, {}, [], None, None, a) == _graph_key(
        Plan, {}, [], None, None, kd.PallasConfig({"adam"}, token=("a",)))


def test_a_pallas_q_verdict_gives_the_jax_packages_loss(rng, tmp_path):
    """A banked impl "pallas_q" runs the head on bf16 operands with f32
    sums in both packages: the port's loss (its plain version on the
    bf16-cast operands) within bf16's rounding of the JAX package's
    (its Pallas kernel in interpret mode), and away from the f32 loss."""
    from paddle_tpu.ops.registry import get_op as jget
    from paddle_tpu_torch.ops.registry import get_op as tget
    import jax.numpy as jnp
    t, d, v = 128, 16, 256
    h = rng.rand(t, d).astype(np.float32)
    w = (rng.rand(v, d) * 0.1).astype(np.float32)
    lbl = rng.randint(0, v, (t, 1)).astype(np.int64)
    path = str(tmp_path / "q.json")
    cache = at.AutotuneCache(path)
    cache.put(kd.cache_key("fused_mlm_head_loss", (t, v), "float32", None,
                           "cpu"), {"impl": "pallas_q", "config": None})
    cache.save()
    jcfg = pd.PallasConfig({"fused_mlm_head_loss"}, interpret=True,
                           tuning=jat.AutotuneCache(path), backend="cpu")
    with pd.scope(jcfg):
        jloss = np.asarray(jget("fused_mlm_head_loss").fn(None, {
            "Hidden": [jnp.asarray(h)], "Weight": [jnp.asarray(w)],
            "Label": [jnp.asarray(lbl.astype(np.int32))]}, {})["Loss"])
    tins = {"Hidden": [torch.from_numpy(h)], "Weight": [torch.from_numpy(w)],
            "Label": [torch.from_numpy(lbl)]}
    tfn = tget("fused_mlm_head_loss").fn
    f32 = tfn(None, tins, {})["Loss"].numpy()
    with kd.scope(kd.PallasConfig({"fused_mlm_head_loss"},
                                  tuning=at.AutotuneCache(path),
                                  backend="cpu")):
        q = tfn(None, tins, {})["Loss"].numpy()
    np.testing.assert_allclose(q, jloss, rtol=2.0 ** -8, atol=1e-4)
    assert np.abs(q - f32).max() > 1e-5


def _four_sites_program():
    """One call site of each dispatched family: LayerNorm (scale and
    bias), the blockwise CE over 128 rows of 256 classes, the fused head
    on the same hidden rows, Adam (main, startup, loss)."""
    main, startup = ptt.Program(), ptt.Program()
    main.random_seed = startup.random_seed = 0
    with ptt.unique_name.guard(), ptt.program_guard(main, startup):
        x = ptt.layers.data("x", [128, 32], dtype="float32",
                            append_batch_size=False)
        y = ptt.layers.data("y", [128, 1], dtype="int64",
                            append_batch_size=False)
        h = ptt.layers.layer_norm(ptt.layers.fc(x, 64))
        ce = ptt.layers.softmax_with_cross_entropy(ptt.layers.fc(h, 256), y)
        table = ptt.layers.create_parameter([256, 64], "float32")
        head = ptt.layers.fused_mlm_head_loss(h, table, y)
        loss = ptt.layers.mean(ptt.layers.elementwise_add(ce, head))
        ptt.optimizer.Adam(1e-3).minimize(loss)
    return main, startup, loss


#: a measured verdict other than the default launch for each family
_VERDICTS = {"layer_norm": {"blocks_per_sm": 4},
             "softmax_with_cross_entropy": {"threads": 512},
             "fused_mlm_head_loss": {"stages": 2},
             "adam": {"blocks_per_sm": 4}}


def test_each_call_site_hands_its_verdict_to_its_kernel_wrapper(
        monkeypatch, rng, tmp_path):
    """A CompiledProgram whose cache holds a non-default verdict for
    every key: each kernel wrapper the step reaches (the LayerNorm
    forward through its custom op and its backward, both CE kernels, the
    head forward, Adam) is called with that call site's config, and with
    no cache with None (the default launch). On the CPU each wrapper then
    runs its plain version."""
    from paddle_tpu_torch.ops.kernels import blockwise_ce as bce
    from paddle_tpu_torch.ops.kernels import fused_adam as fad
    from paddle_tpu_torch.ops.kernels import layer_norm as ln
    seen = []

    def spy(mod, name, pos):
        real = getattr(mod, name)

        def wrapper(*args, **kw):
            config = kw["config"] if "config" in kw else \
                (args[pos] if len(args) > pos else None)
            seen.append((name, config))
            return real(*args, **kw)
        monkeypatch.setattr(mod, name, wrapper)
    spy(ln, "layer_norm", 4)
    spy(ln, "layer_norm_bwd", 5)
    spy(bce, "softmax_ce", 2)
    spy(bce, "softmax_ce_bwd", 4)
    spy(bce, "fused_head_loss", 4)
    spy(fad, "fused_adam", 11)
    main, startup, loss = _four_sites_program()
    feed = {"x": rng.randn(128, 32).astype(np.float32),
            "y": rng.randint(0, 256, (128, 1)).astype(np.int64)}

    def step(**kw):
        exe, scope = ptt.Executor(ptt.CPUPlace()), ptt.Scope()
        exe.run(startup, scope=scope)
        comp = ptt.CompiledProgram(main, ptt.BuildStrategy(
            **kw)).with_data_parallel(loss_name=loss.name)
        del seen[:]
        out = exe.run(comp, feed=feed, fetch_list=[loss], scope=scope)
        return list(seen), out[0]
    # the call sites' keys, from one tuned run's kernel_choice spans
    path = str(tmp_path / "verdicts.json")
    at.AutotuneCache(path).save()
    obs.clear()
    obs.enable()
    try:
        step(pallas_tune_cache=path)
    finally:
        obs.disable()
    cache = at.AutotuneCache(path)
    keys = {(sp["labels"]["op"], sp["labels"]["shape"])
            for sp in obs.spans(name="kernel_choice")}
    assert {op for op, _ in keys} == set(_VERDICTS)
    for op, shape in keys:
        shape = tuple(int(s) for s in shape.split("x"))
        cache.put(kd.cache_key(op, shape, "float32", None, "cpu"),
                  {"impl": "pallas", "config": _VERDICTS[op],
                   "pallas_s": 1e-4, "source": "sweep"})
    cache.save()
    untuned, base = step()
    tuned, got = step(pallas_tune_cache=path)
    want = {"layer_norm": _VERDICTS["layer_norm"],
            "layer_norm_bwd": _VERDICTS["layer_norm"],
            "softmax_ce": _VERDICTS["softmax_with_cross_entropy"],
            "softmax_ce_bwd": _VERDICTS["softmax_with_cross_entropy"],
            "fused_head_loss": _VERDICTS["fused_mlm_head_loss"],
            "fused_adam": _VERDICTS["adam"]}
    assert {name for name, _ in tuned} == set(want)
    assert all(config == want[name] for name, config in tuned), tuned
    assert sum(name == "fused_adam" for name, _ in tuned) == 7
    assert sorted(n for n, _ in untuned) == sorted(n for n, _ in tuned)
    assert all(config is None for _, config in untuned), untuned
    # the plain versions take no config: the same loss either way
    np.testing.assert_array_equal(got, base)
