"""Offline Program verifier — vet serialized/exported programs before
they serve (counterpart of the JAX package's tools/progcheck.py).

Runs the framework/analysis.py pass framework (def-use/liveness,
shape/dtype inference, sharding feasibility, dead-op report) over
serialized Program JSON WITHOUT running an op, a device, or the
exporting process — so a serving artifact can be vetted in CI or at a
deploy gate and a corrupt export fails the drain step, never the first
live request (ServingPredictor runs the same check at load). The port
has no pipeline-feasibility pass yet (it comes with the multi-GPU
slice): a program's pipeline stages are not vetted.

Accepts, per path argument:
  * an inference-model directory (``__model__.json`` — io.py's
    save_inference_model layout; feeds/fetches come from the meta)
  * a ``__model__.json``-style meta file itself
  * a bare ``Program.to_json()`` dump (feeds/fetches unknown unless
    passed via --feed/--fetch)

Exit code = max severity over every checked program: 0 clean (infos
allowed), 1 warnings, 2 errors. ``--json`` prints one machine-readable
line instead of the per-diagnostic text.

Usage:
  python -m paddle_tpu_torch.tools.progcheck model_dir/      # exported model
  python -m paddle_tpu_torch.tools.progcheck prog.json --fetch loss
  python -m paddle_tpu_torch.tools.progcheck model_dir/ --json
"""
import argparse
import json
import os
import sys

MODEL_FILE = "__model__.json"


def check_path(path, feeds=None, fetches=None):
    """Verify one path; returns (AnalysisResult, display_name).

    The envelope contract (meta["program"] + feed/fetch lists, or a
    bare Program dump) lives in analysis.verify_model_meta — ONE
    implementation shared with the ServingPredictor load gate."""
    from paddle_tpu_torch.framework import analysis
    if os.path.isdir(path):
        model = os.path.join(path, MODEL_FILE)
        if not os.path.exists(model):
            raise ValueError(
                "%s is a directory without %s — not an exported "
                "inference model" % (path, MODEL_FILE))
        path = model
    with open(path) as f:
        meta = json.load(f)
    result = analysis.verify_model_meta(meta, feeds=feeds,
                                        fetches=fetches)
    return result, path


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="verify serialized paddle_tpu_torch programs "
                    "(exit code = max severity: 0 clean, 1 warnings, "
                    "2 errors)")
    ap.add_argument("paths", nargs="+",
                    help="inference-model dirs, __model__.json metas, "
                         "or Program.to_json() dumps")
    ap.add_argument("--feed", action="append", default=None,
                    help="feed var name (repeatable; overrides the "
                         "meta's feed list)")
    ap.add_argument("--fetch", action="append", default=None,
                    help="fetch var name (repeatable; overrides the "
                         "meta's fetch list; enables the dead-op "
                         "report)")
    ap.add_argument("--json", action="store_true",
                    help="one machine-readable JSON line")
    args = ap.parse_args(argv)

    from paddle_tpu_torch.framework import analysis
    reports, exit_code = [], 0
    for path in args.paths:
        try:
            result, name = check_path(path, feeds=args.feed,
                                      fetches=args.fetch)
        except (OSError, ValueError, KeyError) as e:
            # an unreadable/corrupt envelope is as fatal as any error
            # diagnostic — the artifact cannot be vetted, refuse it
            reports.append({"path": path, "ok": False,
                            "load_error": "%s: %s"
                            % (type(e).__name__, e)})
            exit_code = max(exit_code, 2)
            if not args.json:
                print("%s: LOAD ERROR: %s" % (path, e))
            continue
        analysis.report(result, mode="progcheck", source="progcheck")
        exit_code = max(exit_code, result.exit_code())
        reports.append({"path": name,
                        "ok": result.exit_code() == 0,
                        **result.to_dict()})
        if not args.json:
            c = result.counts()
            print("%s: %d error(s), %d warning(s), %d info"
                  % (name, c["error"], c["warning"], c["info"]))
            for d in result:
                print("  " + str(d))
    if args.json:
        print(json.dumps({"metric": "progcheck", "exit_code": exit_code,
                          "programs": reports}))
    return exit_code


if __name__ == "__main__":
    sys.exit(main())
