"""Training state to disk and back: the port against the JAX package.

``save_params``/``save_persistables``/``load_params``/``load_persistables``
and ``save_checkpoint``/``load_checkpoint``/``scrub_checkpoint`` write the
JAX package's files, and each package reads what the other wrote: f32
state bit for bit, with ``compress`` None, "zlib" and "q8" (a q8 value is
the JAX codec's decode of the same file, exactly). bf16 is pinned as it
is: the port writes uint16 bits and reads those and the JAX package's
``void16`` bit for bit, while the JAX package's ``_stitch`` value-casts
either (its own void16 raises, the port's bits come back as numbers; a
difference by design, ROADMAP.md Queue 3). The resilience cases mirror
tests/test_io.py's with damage written by the test. A 2-layer BERT with
the recipe, EMA and dropout 0.1 resumed from a checkpoint in a fresh
scope equals an uninterrupted run bit for bit on the CPU.
"""
import json
import os
import shutil
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.io as jio
import paddle_tpu_torch as ptt
import paddle_tpu_torch.io as tio
from paddle_tpu.ops import quant_ops as jquant
from paddle_tpu_torch.framework.executor import _SALT_VAR
from paddle_tpu_torch.framework.scope import to_numpy
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops import quant_ops as tquant

CPU = ptt.CPUPlace()


def _texe():
    return ptt.Executor(CPU)


def _fc_programs(pkg):
    """A two-layer fc regression trained by Adam under a decayed rate
    (persistables: parameters, moments, beta powers, the rate's
    ``@LR_DECAY_COUNTER@``)."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", [4, 8], append_batch_size=False)
        y = pkg.layers.fc(pkg.layers.fc(x, 16, act="tanh"), 3)
        loss = pkg.layers.mean(pkg.layers.square(y - 0.5))
        lr = pkg.layers.exponential_decay(0.05, 10, 0.5)
        pkg.optimizer.Adam(lr).minimize(loss)
    return main, startup, loss


_FEED = {"x": np.random.RandomState(1).randn(4, 8).astype(np.float32)}


def _jax_trained(steps=2):
    main, startup, loss = _fc_programs(pt)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(scope):
        exe.run(startup)
        for _ in range(steps):
            exe.run(main, feed=_FEED, fetch_list=[loss])
    return main, scope, exe


def _port_trained(steps=2):
    main, startup, loss = _fc_programs(ptt)
    scope, exe = ptt.Scope(), _texe()
    exe.run(startup, scope=scope)
    for _ in range(steps):
        exe.run(main, feed=_FEED, fetch_list=[loss], scope=scope)
    return main, scope, exe


def _persistables(main, keep=lambda v: v.persistable):
    return sorted(v.name for v in main.list_vars() if keep(v))


def _is_param(v):
    return v.name in {p.name for p in v.block.program.all_parameters()}


# ---------------------------------------------------------------------------
# params and persistables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what", ["params", "persistables"])
def test_params_and_persistables_from_the_port_load_in_jax(what, tmp_path):
    tmain, tscope, texe = _port_trained()
    with ptt.scope_guard(tscope):
        getattr(ptt, "save_" + what)(texe, str(tmp_path), tmain)
    with np.load(str(tmp_path / "params.npz")) as z:
        names = sorted(z.files)
    keep = _is_param if what == "params" else \
        (lambda v: v.persistable and not v.name.startswith("@"))
    assert names == _persistables(tmain, keep)
    # the decay's step counter stays behind, as in the JAX package
    assert "@LR_DECAY_COUNTER@" in tscope.keys()
    assert what == "params" or "@LR_DECAY_COUNTER@" not in names
    jmain, _, _ = _fc_programs(pt)
    jscope = pt.Scope()
    with pt.scope_guard(jscope):
        getattr(pt, "load_" + what)(None, str(tmp_path), jmain)
    for n in names:
        np.testing.assert_array_equal(np.asarray(jscope.find_var(n)),
                                      to_numpy(tscope.find_var(n)), n)


@pytest.mark.parametrize("what", ["params", "persistables"])
def test_params_and_persistables_from_jax_load_in_the_port(what, tmp_path):
    jmain, jscope, jexe = _jax_trained()
    with pt.scope_guard(jscope):
        getattr(pt, "save_" + what)(jexe, str(tmp_path), jmain)
    tmain, _, _ = _fc_programs(ptt)
    tscope = ptt.Scope()
    with ptt.scope_guard(tscope):
        getattr(ptt, "load_" + what)(_texe(), str(tmp_path), tmain)
    keep = _is_param if what == "params" else \
        (lambda v: v.persistable and not v.name.startswith("@"))
    names = _persistables(tmain, keep)
    assert sorted(tscope.keys()) == names
    for n in names:
        t = tscope.find_var(n)
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        np.testing.assert_array_equal(to_numpy(t),
                                      np.asarray(jscope.find_var(n)), n)


def test_load_params_raises_on_a_missing_parameter(tmp_path):
    tmain, tscope, texe = _port_trained(0)
    w = tmain.all_parameters()[0].name
    arrays = {n: to_numpy(v) for n, v in tscope.items()
              if n not in (w, _SALT_VAR)}
    np.savez(str(tmp_path / "params.npz"), **arrays)
    fresh = ptt.Scope()
    with ptt.scope_guard(fresh):
        with pytest.raises(ValueError, match="parameter %r missing" % w):
            ptt.load_params(texe, str(tmp_path), tmain)
    assert list(fresh.keys()) == []


def test_load_persistables_takes_a_new_shape_unchecked(tmp_path):
    """The reference checks no shape: the value comes in at the stored
    shape (the Executor keys a captured step on it)."""
    tmain, tscope, texe = _port_trained(0)
    b = next(p.name for p in tmain.all_parameters() if len(p.shape) == 1)
    np.savez(str(tmp_path / "params.npz"), **{b: np.ones(1, np.float32)})
    with ptt.scope_guard(tscope):
        ptt.load_persistables(texe, str(tmp_path), tmain)
    assert tuple(tscope.find_var(b).shape) == (1,)


def test_bf16_persistables_travel_as_bits(tmp_path):
    """A bf16 persistable is written as uint16 bits and decoded through
    the program variable's dtype; the JAX package's void16 file too."""
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        w = ptt.layers.create_parameter([5], "bfloat16", name="w16")
    vals = torch.tensor([1.5, -2.25, 3e-3, 7.0, -0.1]).to(torch.bfloat16)
    scope = ptt.Scope()
    scope.set_var("w16", vals.clone())
    with ptt.scope_guard(scope):
        ptt.save_persistables(_texe(), str(tmp_path), main)
    with np.load(str(tmp_path / "params.npz")) as z:
        assert z["w16"].dtype == np.uint16
    back = ptt.Scope()
    with ptt.scope_guard(back):
        ptt.load_persistables(_texe(), str(tmp_path), main)
    assert back.find_var("w16").dtype == torch.bfloat16
    assert torch.equal(back.find_var("w16"), vals)
    jscope = pt.Scope()
    jscope.set_var("w16", jnp.asarray(to_numpy(vals)).astype(jnp.bfloat16))
    jmain = pt.Program()
    with pt.program_guard(jmain, pt.Program()):
        pt.layers.create_parameter([5], "bfloat16", name="w16")
    with pt.scope_guard(jscope):
        pt.save_persistables(None, str(tmp_path / "j"), jmain)
    with np.load(str(tmp_path / "j" / "params.npz")) as z:
        assert z["w16"].dtype.kind == "V"
    back = ptt.Scope()
    with ptt.scope_guard(back):
        ptt.load_persistables(_texe(), str(tmp_path / "j"), main)
    assert torch.equal(back.find_var("w16"), vals)
    assert w.dtype == "bfloat16"


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------

def _q8_expected(arr):
    q, scale = jquant.np_block_quantize(arr)
    return jquant.np_block_dequantize(q, scale, arr.shape, arr.dtype)


@pytest.mark.parametrize("compress", [None, "zlib", "q8"])
def test_port_checkpoint_restores_in_jax(compress, tmp_path):
    tmain, tscope, texe = _port_trained()
    big = np.random.RandomState(3).randn(40, 16).astype(np.float32)
    tscope.set_var("big/w", torch.from_numpy(big.copy()))
    assert tio.save_checkpoint(texe, str(tmp_path), tmain, step=7,
                               scope=tscope, compress=compress) is None
    jscope = pt.Scope()
    assert jio.load_checkpoint(None, str(tmp_path), scope=jscope) == 7
    assert sorted(jscope.keys()) == sorted(tscope.keys())
    for n, v in tscope.items():
        want = np.asarray(v) if not isinstance(v, torch.Tensor) else \
            to_numpy(v)
        if compress == "q8" and want.dtype == np.float32 and \
                want.size >= 256:
            want = _q8_expected(want)
        np.testing.assert_array_equal(np.asarray(jscope.find_var(n)), want,
                                      n)


@pytest.mark.parametrize("compress", [None, "zlib", "q8"])
def test_jax_checkpoint_restores_in_the_port(compress, tmp_path):
    jmain, jscope, jexe = _jax_trained()
    big = np.random.RandomState(3).randn(40, 16).astype(np.float32)
    jscope.set_var("big/w", jnp.asarray(big))
    jio.save_checkpoint(jexe, str(tmp_path), step=5, scope=jscope,
                        compress=compress)
    tmain, _, _ = _fc_programs(ptt)
    tscope = ptt.Scope()
    assert tio.load_checkpoint(_texe(), str(tmp_path), tmain,
                               scope=tscope) == 5
    # the JAX package's run counters are not the port's: @EAGER_SALT@ is
    # ignored (the scope keeps its own, none here), @STEP_COUNTER@ kept
    assert tscope.find_var(_SALT_VAR) is None
    assert sorted(tscope.keys()) == sorted(
        n for n in jscope.keys() if n != _SALT_VAR)
    for n in tscope.keys():
        want = np.asarray(jscope.find_var(n))
        if compress == "q8" and want.dtype == np.float32 and \
                want.size >= 256:
            want = _q8_expected(want)
        got = tscope.find_var(n)
        var = tmain.global_block()._find_var_recursive(n)
        if var is not None and var.dtype == "int64":
            assert got.dtype == torch.int64, n      # widened
        np.testing.assert_array_equal(to_numpy(got), want, n)


def test_the_port_run_counter_travels_as_a_python_int(tmp_path):
    tmain, tscope, texe = _port_trained(3)
    salt = tscope.find_var(_SALT_VAR)
    assert type(salt) is int and salt == 4          # startup + 3 steps
    tio.save_checkpoint(texe, str(tmp_path), step=1, scope=tscope)
    back = ptt.Scope()
    back.set_var(_SALT_VAR, 99)
    tio.load_checkpoint(texe, str(tmp_path), tmain, scope=back)
    assert type(back.find_var(_SALT_VAR)) is int
    assert back.find_var(_SALT_VAR) == salt
    # the JAX package reads the port's counter as its own eager salt
    jscope = pt.Scope()
    jio.load_checkpoint(None, str(tmp_path), scope=jscope)
    assert int(np.asarray(jscope.find_var(_SALT_VAR))) == salt
    # a JAX checkpoint's counter leaves the port scope's own in place
    jio.save_checkpoint(None, str(tmp_path / "j"), step=2, scope=jscope)
    tio.load_checkpoint(texe, str(tmp_path / "j"), tmain, scope=back)
    assert back.find_var(_SALT_VAR) == salt


def test_bf16_checkpoints_between_the_packages(tmp_path):
    vals = torch.tensor([1.5, -2.25, 3e-3, 7.0]).to(torch.bfloat16)
    bits = vals.view(torch.int16).numpy().view(np.uint16)
    tscope = ptt.Scope()
    tscope.set_var("w16", vals.clone())
    tio.save_checkpoint(_texe(), str(tmp_path / "t"), step=1, scope=tscope)
    with open(str(tmp_path / "t" / "step_1" / "manifest.json")) as f:
        assert json.load(f)["vars"]["w16"]["dtype"] == "bfloat16"
    back = ptt.Scope()
    tio.load_checkpoint(_texe(), str(tmp_path / "t"), scope=back)
    assert torch.equal(back.find_var("w16"), vals)
    # the JAX package's own bf16 checkpoint (void16 members): the port
    # reads the bits; the JAX package itself refuses it, and its healthy
    # step dir is not quarantined
    jscope = pt.Scope()
    jscope.set_var("w16", jnp.asarray(to_numpy(vals)).astype(jnp.bfloat16))
    jio.save_checkpoint(None, str(tmp_path / "j"), step=1, scope=jscope)
    back = ptt.Scope()
    tio.load_checkpoint(_texe(), str(tmp_path / "j"), scope=back)
    assert torch.equal(back.find_var("w16"), vals)
    with pytest.raises(ValueError, match="cast"):
        jio.load_checkpoint(None, str(tmp_path / "j"), scope=pt.Scope())
    assert os.path.isdir(str(tmp_path / "j" / "step_1"))
    # the port's uint16 bits reach the JAX package as numbers, value-cast
    jback = pt.Scope()
    jio.load_checkpoint(None, str(tmp_path / "t"), scope=jback)
    got = np.asarray(jback.find_var("w16")).astype(np.float32)
    np.testing.assert_array_equal(got, bits.astype(np.float32).astype(
        jnp.bfloat16).astype(np.float32))
    assert not np.array_equal(got, to_numpy(vals))


def test_q8_codec_is_the_jax_packages():
    rng = np.random.RandomState(0)
    for arr in (rng.randn(1000).astype(np.float32),
                np.zeros((3, 256), np.float32),
                rng.randn(7, 70).astype(np.float64) * 1e3):
        tq, ts = tquant.np_block_quantize(arr)
        jq, js = jquant.np_block_quantize(arr)
        np.testing.assert_array_equal(tq, jq)
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(
            tquant.np_block_dequantize(tq, ts, arr.shape, arr.dtype),
            jquant.np_block_dequantize(jq, js, arr.shape, arr.dtype))
        for mode in ("zlib", "q8"):
            np.testing.assert_array_equal(
                tquant.decode_array(tquant.encode_array(arr, mode)),
                jquant.decode_array(jquant.encode_array(arr, mode)))


def test_a_compressed_npz_is_a_zip_that_np_load_reads(tmp_path,
                                                       monkeypatch):
    """compress="zlib" deflates each member in pieces on threads: one
    deflate stream a member, a zip64 archive that zipfile verifies and
    np.load reads exactly."""
    monkeypatch.setattr(tio, "_DEFLATE_CHUNK", 4096)
    rng = np.random.RandomState(0)
    arrays = {"big##full": rng.randn(300, 70).astype(np.float32),
              "a#SL#b##full": np.arange(5, dtype=np.int64),
              "@EAGER_SALT@##full": np.array(12), "empty": np.zeros((0, 3)),
              "bits": np.arange(9, dtype=np.uint16),
              "fortran": np.asfortranarray(rng.randn(6, 5))}
    path = str(tmp_path / "x.npz")
    tio._write_npz(path, arrays, compressed=True)
    with zipfile.ZipFile(path) as z:
        assert z.testzip() is None
        infos = {i.filename: i for i in z.infolist()}
    assert sorted(infos) == sorted(k + ".npy" for k in arrays)
    assert all(i.compress_type == zipfile.ZIP_DEFLATED
               for i in infos.values())
    assert infos["big##full.npy"].file_size > 4 * 4096
    with np.load(path) as z:
        for k, v in arrays.items():
            assert z[k].dtype == v.dtype and z[k].shape == v.shape, k
            np.testing.assert_array_equal(z[k], v, k)


def test_shardings_is_a_later_slice(tmp_path):
    with pytest.raises(ptt.NotPortedError, match="parallelism slice"):
        tio.load_checkpoint(_texe(), str(tmp_path), shardings={"w": 1})


# ---------------------------------------------------------------------------
# resilience (tests/test_io.py's cases, with damage written by the test)
# ---------------------------------------------------------------------------

def _two_steps(tmp_path):
    """A checkpoint dir holding step_1 (w_q = 1s) and step_2 (2s),
    'latest' at step_2."""
    scope = ptt.Scope()
    for k in (1, 2):
        scope.set_var("w_q", torch.ones(4) * k)
        tio.save_checkpoint(_texe(), str(tmp_path), step=k, scope=scope)
    return str(tmp_path)


def _restored(d, **kw):
    scope = ptt.Scope()
    step = tio.load_checkpoint(_texe(), d, scope=scope, **kw)
    return step, scope.find_var("w_q")


def test_a_torn_manifest_is_quarantined_and_the_previous_step_restored(
        tmp_path):
    d = _two_steps(tmp_path)
    with open(os.path.join(d, "step_2", "manifest.json"), "w") as f:
        f.write("{ not json")
    step, w = _restored(d)
    assert step == 1 and torch.equal(w, torch.ones(4))
    assert os.path.isdir(os.path.join(d, "step_2.corrupt"))
    assert not os.path.exists(os.path.join(d, "step_2"))
    with open(os.path.join(d, "latest")) as f:
        assert f.read().strip() == "step_1"          # repaired


def test_missing_shards_are_quarantined(tmp_path):
    d = _two_steps(tmp_path)
    os.unlink(os.path.join(d, "step_2", "shards_p0.npz"))
    assert _restored(d)[0] == 1
    assert os.path.isdir(os.path.join(d, "step_2.corrupt"))


@pytest.mark.parametrize("pointer", ["missing", "stale"])
def test_a_missing_or_stale_latest_pointer_falls_back(pointer, tmp_path):
    d = _two_steps(tmp_path)
    if pointer == "missing":
        os.unlink(os.path.join(d, "latest"))
    else:
        tio._write_text(os.path.join(d, "latest"), "step_99")
    step, w = _restored(d)
    assert step == 2 and torch.equal(w, torch.ones(4) * 2)


def test_all_corrupt_raises_the_first_error(tmp_path):
    d = _two_steps(tmp_path)
    for s in ("step_1", "step_2"):
        os.unlink(os.path.join(d, s, "shards_p0.npz"))
    with pytest.raises(OSError):
        _restored(d)
    assert os.path.isdir(os.path.join(d, "step_1.corrupt"))
    assert os.path.isdir(os.path.join(d, "step_2.corrupt"))


def test_retention_counts_only_scrub_valid_dirs(tmp_path):
    d = str(tmp_path / "ckpt")
    scope = ptt.Scope()
    scope.set_var("w_r", torch.ones(4))

    def torn(step):
        os.makedirs(os.path.join(d, "step_%d" % step))
        open(os.path.join(d, "step_%d" % step, "shards_p0.npz"), "wb").close()
    tio.save_checkpoint(_texe(), d, step=0, keep_last=2, scope=scope)
    torn(1)
    tio.save_checkpoint(_texe(), d, step=3, keep_last=2, scope=scope)
    for s in (4, 5, 6, 7, 8):
        torn(s)
    tio.save_checkpoint(_texe(), d, step=9, keep_last=2, scope=scope)
    report = tio.scrub_checkpoint(d)
    assert report["valid_steps"] == [3, 9]
    assert not os.path.exists(os.path.join(d, "step_0"))
    assert not os.path.exists(os.path.join(d, "step_1"))
    assert all(os.path.isdir(os.path.join(d, "step_%d" % s))
               for s in (4, 5, 6, 7, 8))
    assert report["steps"][4]["status"] == "incomplete"
    tio.save_checkpoint(_texe(), d, step=12, keep_last=0, scope=scope)
    assert all(os.path.isdir(os.path.join(d, "step_%d" % s))
               for s in (3, 9, 12))
    # pruning steps past a quarantined dir
    os.unlink(os.path.join(d, "step_12", "shards_p0.npz"))
    assert _restored(d)[0] == 9
    tio.save_checkpoint(_texe(), d, step=13, keep_last=1, scope=scope)
    assert os.path.isdir(os.path.join(d, "step_12.corrupt"))
    assert not os.path.exists(os.path.join(d, "step_3"))


def test_a_caller_side_error_is_not_quarantined(tmp_path, monkeypatch):
    d = _two_steps(tmp_path)

    def boom(*a, **k):
        raise ValueError("caller-side restore bug")
    monkeypatch.setattr(tio, "_stitch", boom)
    with pytest.raises(ValueError, match="caller-side"):
        _restored(d)
    assert os.path.isdir(os.path.join(d, "step_2"))
    assert not os.path.exists(os.path.join(d, "step_2.corrupt"))


def test_a_newer_format_raises_and_is_not_quarantined(tmp_path):
    d = _two_steps(tmp_path)
    path = os.path.join(d, "step_2", "manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    manifest["format_version"] = 999
    with open(path, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(tio.CheckpointFormatError, match="newer"):
        _restored(d)
    assert os.path.isdir(os.path.join(d, "step_2"))
    report = tio.scrub_checkpoint(d)
    assert report["steps"][2]["status"] == "valid"
    assert report["valid_steps"] == [1]


def test_an_async_failure_is_raised_exactly_once(tmp_path):
    d = str(tmp_path)
    os.makedirs(d, exist_ok=True)
    open(os.path.join(d, "step_1"), "w").close()    # a file: no step dir
    scope = ptt.Scope()
    scope.set_var("w_once", torch.arange(4.0))
    h = tio.save_checkpoint(_texe(), d, step=1, blocking=False, scope=scope)
    assert isinstance(h, tio.AsyncCheckpoint)
    with pytest.raises(OSError):
        tio.wait_for_pending_saves()
    tio.wait_for_pending_saves()                   # a clean no-op
    scope.set_var("w_once", torch.arange(4.0) * 3)
    h = tio.save_checkpoint(_texe(), d, step=2, blocking=False, scope=scope)
    # the snapshot was taken before returning: a later in-place write
    # does not reach the file
    scope.find_var("w_once").add_(100.0)
    h.result()
    step, _ = _restored(d)
    back = ptt.Scope()
    tio.load_checkpoint(_texe(), d, scope=back)
    assert step == 2
    assert torch.equal(back.find_var("w_once"), torch.arange(4.0) * 3)


def test_scrub_classifies_without_reading_payloads(tmp_path, monkeypatch):
    d = _two_steps(tmp_path)
    os.makedirs(os.path.join(d, "step_3"))
    shutil.copy(os.path.join(d, "step_1", "shards_p0.npz"),
                os.path.join(d, "step_3", "shards_p0.npz"))
    shutil.copytree(os.path.join(d, "step_2"), os.path.join(d, "step_4"))
    os.unlink(os.path.join(d, "step_4", "shards_p0.npz"))
    os.makedirs(os.path.join(d, "step_5"))
    shutil.copytree(os.path.join(d, "step_2"),
                    os.path.join(d, "step_9.corrupt"))
    path = os.path.join(d, "step_1", "manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    shutil.copytree(os.path.join(d, "step_1"), os.path.join(d, "step_6"))
    manifest["vars"]["w_q"]["shards"][0]["key"] = "ghost"
    with open(os.path.join(d, "step_6", "manifest.json"), "w") as f:
        json.dump(manifest, f)

    def boom(self, key):
        raise AssertionError("scrub read payload %r" % key)
    monkeypatch.setattr(np.lib.npyio.NpzFile, "__getitem__", boom)
    report = tio.scrub_checkpoint(d)
    monkeypatch.undo()
    assert report["latest"] == "step_2" and report["valid_steps"] == [1, 2]
    assert {s: v["status"] for s, v in report["steps"].items()} == {
        1: "valid", 2: "valid", 3: "incomplete", 4: "corrupt",
        5: "incomplete", 6: "corrupt"}
    assert "missing keys" in report["steps"][6]["reason"]
    assert report["quarantined"] == ["step_9.corrupt"]
    assert tio.scrub_checkpoint(str(tmp_path / "never"))["steps"] == {}
    # the load agrees with the scrub: it restores the newest valid step
    assert _restored(d)[0] == 2


def test_a_legacy_step_dir_loads(tmp_path):
    os.makedirs(str(tmp_path / "step_4"))
    np.savez(str(tmp_path / "step_4" / "params.npz"),
             **{"w": np.arange(3, dtype=np.float32),
                "__AT__LR_DECAY_COUNTER__AT__": np.array([5], np.int64)})
    scope = ptt.Scope()
    assert tio.load_checkpoint(_texe(), str(tmp_path), scope=scope) == 4
    assert torch.equal(scope.find_var("w"), torch.arange(3.0))
    assert scope.find_var("@LR_DECAY_COUNTER@").tolist() == [5]


def test_checkpoint_dir_bytes(tmp_path):
    scope = ptt.Scope()
    scope.set_var("w", torch.zeros(1000))
    scope.set_var("h", torch.zeros(10, dtype=torch.bfloat16))
    tio.save_checkpoint(_texe(), str(tmp_path), step=1, scope=scope,
                        compress="zlib")
    raw, wire = tio.checkpoint_dir_bytes(str(tmp_path), 1)
    assert raw == 4000 + 20 and 0 < wire < raw


# ---------------------------------------------------------------------------
# the recipe, resumed
# ---------------------------------------------------------------------------

def _recipe_program():
    cfg = tbert.BertConfig(vocab_size=512, hidden_size=64, num_layers=2,
                           num_heads=4, ff_size=128, max_position=64,
                           hidden_dropout=0.1, attn_dropout=0.1)
    fetch = {}

    def opt(loss):
        layers = ptt.layers
        lr = layers.linear_lr_warmup(
            layers.polynomial_decay(1e-3, decay_steps=6,
                                    end_learning_rate=0.0),
            warmup_steps=2, start_lr=0.0, end_lr=1e-3)
        ptt.optimizer.AdamW(lr, weight_decay=0.01).minimize(
            loss, grad_clip=ptt.clip.GradientClipByGlobalNorm(1.0))
        fetch["ema"] = ptt.optimizer.ExponentialMovingAverage(0.999)
        fetch["ema"].update()
        fetch["lr"] = lr
    with ptt.unique_name.guard():
        main, startup, _, out = tbert.bert_pretrain_program(
            cfg, 2, 16, 4, optimizer_fn=opt)
    startup.random_seed = 7
    feed = tbert.synthetic_batch(cfg, 2, 16, 4, seed=0)
    return main, startup, [out["loss"], fetch["lr"]], feed, fetch["ema"]


def test_the_recipe_with_ema_resumes_bit_for_bit(tmp_path):
    main, startup, fetch_list, feed, ema = _recipe_program()
    names = _persistables(main)
    assert len([n for n in names if ".ema" in n]) == len(
        main.all_parameters())

    def steps(exe, scope, n):
        return [[float(np.asarray(v).reshape(())) for v in
                 exe.run(main, feed=feed, fetch_list=fetch_list,
                         scope=scope)] for _ in range(n)]
    exe, scope = _texe(), ptt.Scope()
    exe.run(startup, scope=scope)
    first = steps(exe, scope, 3)
    tio.save_checkpoint(exe, str(tmp_path), main, step=3, scope=scope,
                        compress="zlib")
    rest = steps(exe, scope, 3)
    fresh_exe, fresh = _texe(), ptt.Scope()
    assert tio.load_checkpoint(fresh_exe, str(tmp_path), main,
                               scope=fresh) == 3
    assert type(fresh.find_var(_SALT_VAR)) is int
    resumed = steps(fresh_exe, fresh, 3)
    assert resumed == rest and rest != first
    assert sorted(fresh.keys()) == sorted(scope.keys())
    for n in names:
        assert torch.equal(fresh.find_var(n), scope.find_var(n)), n
    assert fresh.find_var(_SALT_VAR) == scope.find_var(_SALT_VAR)
    # back to step 3 in the live scope and Executor: the same steps again
    end = {n: scope.find_var(n).clone() for n in names}
    assert tio.load_checkpoint(exe, str(tmp_path), main, scope=scope) == 3
    assert steps(exe, scope, 3) == rest
    for n in names:
        assert torch.equal(scope.find_var(n), end[n]), n


def test_loads_run_on_the_card_unless_told_otherwise(tmp_path,
                                                      monkeypatch):
    scope = ptt.Scope()
    scope.set_var("w", torch.ones(3))
    tio.save_checkpoint(None, str(tmp_path), step=1, scope=scope)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ptt.NoCUDADeviceError):
        tio.load_checkpoint(None, str(tmp_path), scope=ptt.Scope())
    main, _, _ = _fc_programs(ptt)
    with pytest.raises(ptt.NoCUDADeviceError):
        ptt.load_persistables(None, str(tmp_path), main)
