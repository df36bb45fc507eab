"""The port's cost model, sweep harness, cache and CLIs (ops/kernels/
costmodel.py, ops/kernels/autotune.py, tools/autotune.py,
tools/tunecheck.py), the counterparts of the JAX package's, mirroring
tests/test_costmodel.py's cases on the CPU.

The kernels run only on the card; here every wrapper runs its plain
version, so a sweep exercises the harness (candidates, checks against the
plain version, ranking, pruning, banking) with a timer the test injects.
The size guards are checked against the kernels' own numbers (the head
backward's tiles and the forward's ring from their sources), the fit
against synthetic rows, the cache format against the JAX package's
reader.
"""
import json
import os

import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import autotune as jat
from paddle_tpu.ops.pallas import costmodel as jcm
from paddle_tpu_torch.ops import kernel_dispatch as kd
from paddle_tpu_torch.ops.kernels import autotune as at
from paddle_tpu_torch.ops.kernels import costmodel as cm
from paddle_tpu_torch.ops.kernels import layer_norm as ln
from paddle_tpu_torch.tools import autotune as autotune_cli
from paddle_tpu_torch.tools import tunecheck

CPU = torch.device("cpu")
CARD = "nvidia-h100-80gb-hbm3"


# ---------------------------------------------------------------------------
# the guards, features and the analytic ranking
# ---------------------------------------------------------------------------

def test_the_guards_are_the_kernels_own():
    # fused_head_bwd.cu launch_d: D alone picks the backward's tiles;
    # fused_head_fwd.cu: a ring stage is 64 KB f32 (hi and lo planes),
    # 32 KB bf16, and three f32 stages fit the 227 KB a block may use
    assert [cm.head_tiles(d) for d in (99, 256, 512, 768, 1000)] \
        == [(2, 4), (2, 4), (2, 8), (2, 12), (1, 16)]
    assert cm.head_fwd_smem("float32", 3) == 3 * 65536 + 1024 <= 232448
    assert cm.head_fwd_smem("bfloat16", 4) == 4 * 32768 + 1024
    assert cm.resolve("adam", (4096,), {}) == cm.ADAM_DEFAULT
    assert cm.resolve("fused_mlm_head_loss", (128, 256), {}, "bfloat16",
                      768) == {"stages": 4}
    assert cm.resolve("fused_mlm_head_loss", (128, 256), {}, "float32",
                      768) == {"stages": 3}
    assert cm.resolve("layer_norm", (64, 768), {"blocks_per_sm": 4}) == \
        {"blocks_per_sm": 4}
    assert cm.resolve("layer_norm", (64, 768), {}) == {}
    bad = [("adam", (4096,), {"threads": 512}, "float32", None),
           ("adam", (4096,), {"blocks_per_sm": True}, "float32", None),
           ("adam", (4096,), {"blocks_per_sm": 65}, "float32", None),
           ("layer_norm", (64, 768), {"row_warps": 4}, "float32", None),
           ("layer_norm", (64, 768), {"blocks_per_sm": 9}, "float32", None),
           ("softmax_with_cross_entropy", (8, 8), {"threads": 128},
            "float32", None),
           ("fused_mlm_head_loss", (8, 8), {"mt": 1, "nt": 16}, "float32",
            768),
           ("fused_mlm_head_loss", (8, 8), {"stages": 6}, "float32", 16),
           ("fused_mlm_head_loss", (8, 8), {"stages": 2}, "bfloat16", 16),
           ("fused_mlm_head_loss", (8, 8), {}, "float32", 1100),
           ("adam", (4096,), {"block_rows": 8}, "float32", None),
           ("adam", (4096,), {}, "float16", None)]
    for op, shape, config, dtype, d in bad:
        with pytest.raises(cm.KernelConfigError):
            cm.resolve(op, shape, config, dtype, d)
        assert cm.features(op, shape, config, dtype, d) is None


def test_the_layer_norm_plan_takes_a_config():
    plan = ln._ln_plan(16384, 768, torch.float32, True, blocks_per_sm=4)
    assert plan.threads == 256 and plan.grid == 4 * 132
    base = ln._ln_plan(16384, 768, torch.float32, True)
    assert (base.threads, base.grid) == (256, 2 * 132)
    assert ln._ln_plan(16384, 768, torch.float32, True, backward=True,
                       blocks_per_sm=2).partial_rows == 264


def test_the_analytic_ranking_orders_without_any_data():
    model = at.fit_cost_model()
    for op, shape in at.DEFAULT_SHAPES.items():
        for dtype in ("float32", "bfloat16"):
            ranked = model.rank(op, shape, dtype=dtype, d=at.HEAD_D)
            feasible = [c for c in at.CANDIDATES[op]
                        if cm.feasible(op, shape, c, dtype, at.HEAD_D)]
            assert len(ranked) == len(feasible) >= 2
            secs = [s for _c, s, _src in ranked]
            assert secs == sorted(secs) and min(secs) > 0
            assert {src for _c, _s, src in ranked} == {"analytic"}
            f = cm.features(op, shape, ranked[0][0], dtype, at.HEAD_D)
            assert secs[0] >= cm.bound_seconds(f, dtype)
    # bf16 has no 2-stage head forward: dropped, never ranked
    ranked = model.rank("fused_mlm_head_loss", (2560, 32768),
                        dtype="bfloat16")
    assert {"stages": 2} not in [c for c, _s, _src in ranked]


def _synthetic_seconds(op, shape, config, dtype, d=None, theta=None):
    f = cm.features(op, shape, config, dtype, d)
    return float(np.exp(np.dot(cm._phi(f, dtype), theta)))


THETA = {
    "adam": np.array([-11.0, 0.3, 0.9, 0.0, 0.0]),
    "layer_norm": np.array([-10.5, 0.02, 0.8, 0.01, 0.0]),
    "softmax_with_cross_entropy": np.array([-9.0, 0.05, 1.2, 0.1, 0.0]),
    "fused_mlm_head_loss": np.array([-6.0, 0.01, 0.02, 0.005, 0.05]),
}
SHAPES = {
    "adam": [(2097152,), (3145728,), (4194304,), (8388608,)],
    "layer_norm": [(1024, 768), (4096, 768), (16384, 768), (8192, 1024)],
    "softmax_with_cross_entropy": [(512, 8192), (2560, 32768),
                                   (1024, 50304), (4096, 30720)],
    "fused_mlm_head_loss": [(512, 8192), (2560, 32768), (1024, 50304),
                            (4096, 30720)],
}


def _rows(op, shapes, dtype="float32"):
    """{key: entry} of synthetic sweeps of ``op`` at ``shapes``."""
    out = {}
    for shape in shapes:
        d = at.HEAD_D if op == "fused_mlm_head_loss" else None
        res = {cm.config_tag(c): _synthetic_seconds(op, shape, c, dtype, d,
                                                    THETA[op])
               for c in at.CANDIDATES[op]
               if cm.feasible(op, shape, c, dtype, d)}
        best = min(res, key=res.get)
        out[kd.cache_key(op, shape, dtype, None, "card")] = dict(
            {"impl": "pallas", "config": cm.parse_tag(best) or None,
             "pallas_s": res[best], "results": res},
            **({"hidden": d} if d else {}))
    return out


@pytest.mark.parametrize("op", sorted(SHAPES))
def test_a_fit_on_synthetic_rows_keeps_the_best_in_its_top3(op):
    """In sample, and with one shape held out: the fitted model places
    the measured best of the held-out shape in its top 3 (in first place
    for a family of fewer than four candidates, where a top 3 holds
    them all)."""
    k, least = (3, cm.MIN_RANK_ROWS) if len(at.CANDIDATES[op]) >= 4 \
        else (1, 2)
    rows = _rows(op, SHAPES[op])
    hits, judged = cm.measured_best_in_topk(rows, k=k, min_rows=least)
    assert judged == len(SHAPES[op]) and hits == judged
    model = cm.CostModel().fit_cache(rows)
    assert model.stats()["fitted"] == ["%s@card" % op]
    for held in SHAPES[op]:
        train = _rows(op, [s for s in SHAPES[op] if s != held])
        m = cm.CostModel(candidates=at.CANDIDATES).fit_cache(train)
        test = _rows(op, [held])
        h, j = cm.measured_best_in_topk(test, model=m, k=k,
                                        min_rows=least)
        assert (h, j) == (1, 1), held


def test_a_compile_model_predicts_only_from_two_shapes():
    """With predict_min_shapes (a compile's model) a family fitted over
    one shape predicts nothing, however many rows it holds; over two
    shapes it predicts from the fit. Without it (the JAX package's
    rule) the one-shape fit predicts, and an unfitted family falls back
    to the analytic proxy."""
    one = dict(_rows("layer_norm", [(16384, 768)]),
               **_rows("layer_norm", [(16384, 768)], "bfloat16"))
    two = dict(one, **_rows("layer_norm", [(8192, 1024)]))
    strict = at.fit_cost_model(one, predict_min_shapes=2)
    assert strict.stats()["fitted"] == ["layer_norm@card"]
    assert strict.predict_config("layer_norm", (4096, 768),
                                 backend="card") is None
    assert strict.predict_config("adam", (4096,), backend="card") is None
    loose = at.fit_cost_model(one)
    assert loose.predict_config("layer_norm", (4096, 768),
                                backend="card")["source"] == "fitted"
    assert loose.predict_config("adam", (4096,),
                                backend="card")["source"] == "analytic"
    pred = at.fit_cost_model(two, predict_min_shapes=2).predict_config(
        "layer_norm", (4096, 768), backend="card")
    assert pred["source"] == "fitted" and pred["predicted_s"] > 0


def test_fingerprint_tracks_rows_and_candidates():
    rows = _rows("adam", SHAPES["adam"])
    m1 = cm.CostModel().fit_cache(rows)
    m2 = cm.CostModel().fit_cache(rows)
    assert m1.fingerprint() == m2.fingerprint()
    assert m2.add_row("adam", (4096,), {"blocks_per_sm": 4}, 1e-5,
                      backend="card")
    assert m1.fingerprint() != m2.fingerprint()
    assert cm.CostModel({"adam": [{}]}).fingerprint() != \
        cm.CostModel().fingerprint()


def test_tags_and_keys_parse_as_the_jax_packages():
    for cfg in ({}, {"threads": 512}, {"blocks_per_sm": 8},
                {"stages": 3, "blocks_per_sm": 2}):
        tag = cm.config_tag(cfg)
        assert tag == jcm.config_tag(cfg)
        assert cm.parse_tag(tag) == jcm.parse_tag(tag) == cfg
    for key in ("adam|1048576|float32|-|" + CARD,
                "layer_norm|16384x768|bfloat16|dp=8,mp=2|cpu",
                "fused_mlm_head_loss|2560x32768|float32|-|-", "a|b|c",
                "adam|1x2y|float32|-|cpu"):
        assert cm.parse_key(key) == jcm.parse_key(key)


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

def _timer(op, shape, dtype="float32", d=None):
    """A deterministic timer: the synthetic seconds of each config."""
    def timer(config, fn, probes, deadline_s):
        fn()                              # the harness's closure runs
        if config is None:
            return 1.0                    # the library call
        return _synthetic_seconds(op, shape, config, dtype, d, THETA[op])
    return timer


@pytest.mark.parametrize("op,shape", [
    ("layer_norm", (256, 64)), ("softmax_with_cross_entropy", (256, 512)),
    ("adam", (8192,)), ("fused_mlm_head_loss", (128, 256))])
def test_top_k_agrees_with_exhaustive_under_an_injected_timer(tmp_path, op,
                                                              shape):
    d = 16 if op == "fused_mlm_head_loss" else None
    ex = at.autotune_op(op, shape, device=CPU, d=d, probes=1,
                        backend="card",
                        cache=at.AutotuneCache(str(tmp_path / "ex.json")),
                        timer=_timer(op, shape, d=d))
    model = cm.CostModel(candidates=at.CANDIDATES).fit_cache(
        _rows(op, SHAPES[op]))
    # every distinct launch of the family (the f32 head's 3 stages are
    # its default's); a top 3 of fewer than four prunes nothing, so those
    # families keep their best predicted one
    n = ex["candidates_total"]
    assert n == len(at.CANDIDATES[op]) - (op == "fused_mlm_head_loss")
    k = 3 if n >= 4 else 1
    pr = at.autotune_op(op, shape, device=CPU, d=d, probes=1, top_k=k,
                        cost_model=model, backend="card",
                        cache=at.AutotuneCache(str(tmp_path / "pr.json")),
                        timer=_timer(op, shape, d=d))
    assert ex["candidates_measured"] == n and pr["candidates_measured"] == k
    statuses = [r["status"] for r in pr["results"].values()]
    assert statuses.count("pruned") == n - k
    assert all(r["predicted_s"] is not None
               for r in pr["results"].values()
               if cm.feasible(op, shape, cm.parse_tag(
                   next(t for t, rr in pr["results"].items() if rr is r)),
                   "float32", d))
    assert at.best_within(pr, ex, 0.03)
    # every measured candidate was held against the plain version
    assert all(r["max_abs_err"] == 0.0 for r in ex["results"].values()
               if r["status"] == "ok")
    entry = ex["entry"]
    # the library yardstick (fused torch.optim.Adam is timed on a card)
    assert entry["impl"] == "pallas"
    assert entry["library_s"] == (None if op == "adam" else 1.0)
    assert entry["results"] == {t: r["measured_s"]
                                for t, r in ex["results"].items()
                                if r["status"] == "ok"}


def test_a_candidate_its_kernel_does_not_take_is_failed(tmp_path):
    s = at.autotune_op("fused_mlm_head_loss", (128, 256), device=CPU, d=16,
                       probes=1, candidates=[{}, {"stages": 6}],
                       cache=at.AutotuneCache(str(tmp_path / "c.json")),
                       timer=lambda c, fn, p, dl: 1e-3)
    assert s["results"]["stages=6"]["status"] == "failed"
    assert s["entry"]["results"] == {"": 1e-3}


def test_cost_model_only_banks_with_zero_probes(tmp_path):
    cache = at.AutotuneCache(str(tmp_path / "cm.json"))
    model = cm.CostModel(candidates=at.CANDIDATES).fit_cache(
        _rows("layer_norm", SHAPES["layer_norm"]))

    def no_timer(*a):
        raise AssertionError("a zero-probe bank measures nothing")
    s = at.autotune_op("layer_norm", (2048, 768), device=CPU, cache=cache,
                       cost_model=model, cost_model_only=True,
                       backend="card", timer=no_timer)
    entry = s["entry"]
    assert s["candidates_measured"] == 0 and entry["probes"] == 0
    assert entry["source"] == "costmodel" and entry["pallas_s"] is None
    assert entry["predicted_s"] > 0
    cfg = kd.PallasConfig({"layer_norm"}, tuning=cache, backend="card")
    choice = kd.choose(cfg, "layer_norm", (2048, 768), torch.float32)
    assert choice.config == entry["config"]
    assert choice.source == "predicted" and choice.measured_s is None


# ---------------------------------------------------------------------------
# the cache, tunecheck and the CLI
# ---------------------------------------------------------------------------

def test_concurrent_writers_merge_and_the_jax_reader_agrees(tmp_path):
    path = str(tmp_path / "shared.json")
    a, b = at.AutotuneCache(path), at.AutotuneCache(path)
    a.put("k1", {"impl": "pallas"})
    b.put("k2", {"impl": "pallas"})
    a.save()
    b.save()      # must not erase a's k1
    fresh = at.AutotuneCache(path)
    assert fresh.lookup("k1") and fresh.lookup("k2")
    raw = json.load(open(path))
    assert raw["format_version"] == at.FORMAT_VERSION == jat.FORMAT_VERSION
    # one envelope for both packages
    assert jat.AutotuneCache(path).load() == fresh.load()


def test_a_future_format_loads_empty_but_tunecheck_fails_loudly(tmp_path):
    path = str(tmp_path / "card.json")
    with open(path, "w") as f:
        json.dump({"format_version": at.FORMAT_VERSION + 99,
                   "backend": "card", "entries": {"k": {}}}, f)
    assert at.AutotuneCache(path).lookup("k") is None
    report = tunecheck.check_file(path)
    assert not report["ok"]
    assert any("format_version" in p for p in report["problems"])


def test_tunecheck_is_green_on_the_committed_file_and_loud_on_bad_ones(
        tmp_path, capsys):
    assert tunecheck.main([]) == 0
    report = json.loads(capsys.readouterr().out.strip())
    f, = report["files"]
    assert report["ok"] and f["top3_rate"] >= 0.8
    assert f["coverage_missing"] == 0 and f["backend"] == CARD
    assert f["card"].startswith("NVIDIA H100")
    committed = json.load(open(at.banked_cache_path(CARD)))
    torn = str(tmp_path / (CARD + ".json"))
    with open(torn, "w") as fh:
        fh.write('{"format_version": 1, "entries": {tor')
    assert tunecheck.main(["--file", torn]) == 1
    capsys.readouterr()

    def variant(name, **change):
        blob = json.loads(json.dumps(committed))
        for k, v in change.items():
            blob[k] = v
        path = str(tmp_path / name / (CARD + ".json"))
        os.makedirs(os.path.dirname(path))
        with open(path, "w") as fh:
            json.dump(blob, fh)
        return tunecheck.check_file(path)
    holes = variant("holes", entries={
        k: v for k, v in committed["entries"].items()
        if not k.startswith("adam")})
    assert any("coverage" in p for p in holes["problems"])
    xla = dict(committed["entries"])
    k = next(iter(xla))
    xla[k] = dict(xla[k], impl="xla")
    assert any("'xla'" in p for p in variant("xla", entries=xla)[
        "problems"])
    nocard = variant("nocard", card=None)
    assert any("card" in p for p in nocard["problems"])
    unfit = dict(committed["entries"])
    k = next(k for k in unfit if k.startswith("adam"))
    unfit[k] = dict(unfit[k], config={"threads": 48})
    assert any("not one its kernel takes" in p
               for p in variant("unfit", entries=unfit)["problems"])


def test_the_cli_guards_the_tuned_dir_and_dry_runs_on_the_cpu(tmp_path,
                                                               capsys):
    for argv in (["--dry-run", "--cache",
                  os.path.join(at.tuned_dir(), CARD + ".json")],
                 ["--dry-run", "--bank", CARD],
                 ["--bank", CARD, "--cost-model-only"],
                 ["--ops", "conv2d", "--dry-run"]):
        with pytest.raises(SystemExit):
            autotune_cli.main(argv)
    capsys.readouterr()
    out = str(tmp_path / "dry.json")
    assert autotune_cli.main(["--dry-run", "--cache", out, "--ops",
                              "layer_norm,adam"]) == 0
    summary = json.loads(capsys.readouterr().out.strip())
    assert summary["ok"] and summary["backend"] == "cpu"
    assert summary["entries"] == 2
    assert set(json.load(open(out))["entries"]) == {
        kd.cache_key("layer_norm", at.DRY_SHAPES["layer_norm"], "float32",
                     None, "cpu"),
        kd.cache_key("adam", at.DRY_SHAPES["adam"], "float32", None, "cpu")}
