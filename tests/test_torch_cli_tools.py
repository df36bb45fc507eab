"""The port's two CLIs, ``python -m paddle_tpu_torch.tools.progcheck`` and
``python -m paddle_tpu_torch.tools.serving_probe``, against the JAX
package's ``tools/progcheck.py`` and ``tools/serving_probe.py``, on a
narrow BERT encoder (2 layers, hidden 64, T = 16) exported on the CPU at
buckets 1 and 4.

progcheck: exit code by the highest severity (0 clean, 1 warnings, 2
errors or an unreadable envelope), the same ``--json`` line as the JAX
tool's on the same ``__model__.json`` (the model directory formats are
interchangeable). serving_probe: 0 ready, 1 loaded but cold (or, with
``--strict``, degraded or a failed metrics scrape), 2 broken; the
default place is CUDAPlace(0), ``--cpu`` serves a CPU export; the
``--metrics-url`` summary equals the JAX tool's on the same exposition,
read over ``file://`` (no port is bound). One subprocess run of each.
"""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.framework import resilience
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.tools import progcheck, serving_probe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 16


def _jax_tool(name):
    path = os.path.join(ROOT, "tools")
    if path not in sys.path:
        sys.path.insert(0, path)
    return __import__(name)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """(model dir with its serving artifact, the program's JSON dump)."""
    root = tmp_path_factory.mktemp("cli")
    cfg = bert.BertConfig(vocab_size=100, hidden_size=64, num_layers=2,
                          num_heads=4, ff_size=128, max_position=64)
    main, startup = ptt.Program(), ptt.Program()
    startup.random_seed = 3
    with ptt.unique_name.guard(), ptt.program_guard(main, startup):
        feeds = [ptt.layers.data(n, [T, 1], dtype=dt) for n, dt in (
            ("src_ids", "int64"), ("pos_ids", "int64"),
            ("sent_ids", "int64"), ("input_mask", "float32"))]
        seq, pooled = bert.bert_encoder(*feeds, cfg, is_test=True)
    d = str(root / "bert")
    with ptt.scope_guard(ptt.Scope()):
        exe = ptt.Executor(ptt.CPUPlace())
        exe.run(startup)
        ptt.save_inference_model(d, [f.name for f in feeds], [seq, pooled],
                                 exe, main_program=main, format="stablehlo",
                                 batch_sizes=(1, 4))
    # a bare program dump whose first op reads a declared var that
    # nothing produces: with the feeds unknown, a warning
    prog = json.loads(main.to_json())
    block = prog["blocks"][0]
    block["vars"].append(dict(block["vars"][0], name="ghost", is_data=False))
    block["ops"][0]["inputs"]["Ids"] = ["ghost"]
    dump = str(root / "program.json")
    with open(dump, "w") as f:
        json.dump(prog, f)
    return d, dump


@pytest.fixture(autouse=True)
def _clean():
    resilience.clear_events()
    resilience.clear_bytes()
    yield
    resilience.clear_events()
    resilience.clear_bytes()


def _json_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _broken_copy(src, dst, how):
    shutil.copytree(src, dst)
    model = os.path.join(dst, "__model__.json")
    if how == "truncate":
        with open(model) as f:
            text = f.read()
        with open(model, "w") as f:
            f.write(text[:len(text) // 2])
        return dst
    with open(model) as f:
        meta = json.load(f)
    op = meta["program"]["blocks"][0]["ops"][0]
    slot = sorted(op["inputs"])[0]
    op["inputs"][slot] = ["renamed_by_corruption"]
    with open(model, "w") as f:
        json.dump(meta, f)
    return dst


# ---- progcheck --------------------------------------------------------------

def test_progcheck_exit_codes_and_json_match_the_jax_tool(artifact,
                                                          tmp_path, capsys):
    jtool = _jax_tool("progcheck")
    d, dump = artifact
    renamed = _broken_copy(d, str(tmp_path / "renamed"), "rename")
    truncated = _broken_copy(d, str(tmp_path / "trunc"), "truncate")
    for args, code in (([d], 0), ([dump], 1),
                       ([dump, "--feed", "ghost", "--feed", "pos_ids",
                         "--feed", "sent_ids", "--feed", "input_mask"], 0),
                       ([renamed], 2), ([truncated], 2),
                       ([str(tmp_path)], 2), ([d, renamed], 2)):
        assert progcheck.main(args + ["--json"]) == code, args
        got = _json_line(capsys)
        assert jtool.main(args + ["--json"]) == code, args
        want = _json_line(capsys)
        assert got["exit_code"] == want["exit_code"] == code
        for g, w in zip(got["programs"], want["programs"]):
            assert g["ok"] == w["ok"]
            if "load_error" in w:
                assert "load_error" in g
                continue
            assert g["counts"] == w["counts"], args
            assert [(x["severity"], x["pass"]) for x in g["diagnostics"]] \
                == [(x["severity"], x["pass"]) for x in w["diagnostics"]]
    # text mode names each diagnostic
    assert progcheck.main([renamed]) == 2
    out = capsys.readouterr().out
    assert "1 error(s)" in out and "renamed_by_corruption" in out


# ---- serving_probe ----------------------------------------------------------

def test_serving_probe_exit_codes(artifact, tmp_path, capsys):
    d, _ = artifact
    assert serving_probe.main([d, "--cpu"]) == 1          # bucket 4 cold
    h = _json_line(capsys)
    assert h["status"] == "cold" and h["warm_buckets"] == [1] and \
        h["requests"] == 1
    assert serving_probe.main([d, "--cpu", "--no-request"]) == 1
    assert _json_line(capsys)["requests"] == 0
    assert serving_probe.main([d, "--cpu", "--warmup", "--strict"]) == 0
    h = _json_line(capsys)
    assert h["ready"] and h["status"] == "ok" and \
        h["warm_buckets"] == h["buckets"] == [1, 4] and h["requests"] == 1
    truncated = _broken_copy(d, str(tmp_path / "trunc"), "truncate")
    assert serving_probe.main([truncated, "--cpu"]) == 2
    h = _json_line(capsys)
    assert h["status"] == "broken" and not h["live"]
    assert serving_probe.main([str(tmp_path / "missing"), "--cpu"]) == 2


def test_serving_probe_defaults_to_cuda_and_fails_without_it(
        artifact, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d, _ = artifact
    assert serving_probe.main([d, "--warmup"]) == 2
    assert "NoCUDADeviceError" in _json_line(capsys)["error"]
    with pytest.raises(ptt.NoCUDADeviceError):
        serving_probe.probe(d)


def test_serving_probe_strict_deadline(artifact, capsys):
    """A probe request past its deadline is counted, not fatal: loadable
    but degraded, exit 1 under --strict."""
    d, _ = artifact
    with resilience.inject("serve:slow=0.3@1"):
        assert serving_probe.main([d, "--cpu", "--warmup", "--strict",
                                   "--deadline-s", "0.05"]) == 1
    h = _json_line(capsys)
    assert h["deadline_misses"] == 1 and h["status"] == "degraded"


def _write_metrics(path, armed=False):
    resilience.record_event("restore", host=1)
    resilience.record_analysis("def_use", "warning")
    resilience.record_bytes("ckpt", 100, 40)
    text = resilience.metrics_text()
    if armed:
        text += "paddle_tpu_resilience_faultinject_armed 2\n"
    with open(path, "w") as f:
        f.write(text)
    return "file://" + path


def test_serving_probe_metrics_url(artifact, tmp_path, capsys):
    jtool = _jax_tool("serving_probe")
    d, _ = artifact
    url = _write_metrics(str(tmp_path / "m.txt"))
    summary = serving_probe.scrape_metrics(url)
    assert summary == jtool.scrape_metrics(url)
    assert summary["samples"] > 0 and "restore" in summary["events_total"]
    assert summary["bytes"] == {"ckpt_bytes_total/raw": 100,
                                "ckpt_bytes_total/wire": 40}
    assert serving_probe.main([d, "--cpu", "--warmup", "--strict",
                               "--metrics-url", url]) == 0
    assert _json_line(capsys)["metrics"] == summary
    armed = _write_metrics(str(tmp_path / "armed.txt"), armed=True)
    assert serving_probe.main([d, "--cpu", "--warmup", "--strict",
                               "--metrics-url", armed]) == 1
    h = _json_line(capsys)
    assert h["faults_armed"] and \
        h["faults_armed"] == jtool.fault_plane_flags(
            jtool.scrape_metrics(armed))
    assert serving_probe.main([d, "--cpu", "--warmup",
                               "--metrics-url", armed]) == 0
    missing = "file://" + str(tmp_path / "none.txt")
    assert serving_probe.main([d, "--cpu", "--warmup", "--strict",
                               "--metrics-url", missing]) == 1
    assert "metrics_error" in _json_line(capsys)
    for flags in ("obs_overflow_flags", "fault_plane_flags"):
        sample = {"events_total": {},
                  "obs": {"trace_spans_dropped_total": 3},
                  "faults": {"faultinject_armed": 1}}
        assert getattr(serving_probe, flags)(sample) == \
            getattr(jtool, flags)(sample) != []
        assert getattr(serving_probe, flags)({"events_total": {}}) == []


# ---- one subprocess run of each --------------------------------------------

def _module(args):
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-m"] + args, cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    return out.returncode, out.stdout, out.stderr


def test_progcheck_runs_as_a_module(artifact):
    rc, out, err = _module(["paddle_tpu_torch.tools.progcheck",
                            artifact[0], "--json"])
    assert rc == 0, err
    assert json.loads(out.splitlines()[-1])["exit_code"] == 0


def test_serving_probe_runs_as_a_module(artifact):
    rc, out, err = _module(["paddle_tpu_torch.tools.serving_probe",
                            artifact[0], "--cpu", "--warmup", "--strict"])
    assert rc == 0, err
    assert json.loads(out.splitlines()[-1])["status"] == "ok"
