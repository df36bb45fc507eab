"""Banked tuned-cache validator (counterpart of the JAX package's
tools/tunecheck.py).

The per-card caches committed under ``paddle_tpu_torch/tools/tuned/``
are shared state: every ``CompiledProgram`` with ``use_pallas`` under
``kernel_policy="auto"`` on that card launches their verdicts. A torn,
stale or hand-mangled file would mistune every one of them, so this tool
fails fast. Per file it checks:

  1. format: parseable JSON, the versioned envelope with
     ``format_version == autotune.FORMAT_VERSION``, ``backend`` meta
     matching the file name, the card's name and power limit in ``card``;
  2. entries: every key parses into a known kernel family with integer
     shapes and the file's card; impls are ``pallas`` or ``pallas_q``
     (never ``xla``: the port has no second lowering on a card); a
     winner config is one its kernel takes at that shape
     (costmodel.resolve, the kernels' own guards);
  3. coverage: every (op, shape) of ``autotune.DEFAULT_SHAPES`` is
     banked;
  4. ranking quality: a cost model fit on the file's own rows puts the
     measured-best config in its top 3 on at least ``--min-top3`` (80%)
     of the keys with enough rows to judge.

Prints ONE JSON line; exit 0 only when every checked file passes.

Usage:
  python -m paddle_tpu_torch.tools.tunecheck       # every tuned/*.json
  python -m paddle_tpu_torch.tools.tunecheck --file x.json --min-top3 0.9
"""
import argparse
import glob
import json
import os
import sys


def check_file(path, min_top3=0.8):
    """Validate one banked cache; the per-file report dict (``ok`` False
    with a ``problems`` list on any failure)."""
    from paddle_tpu_torch.ops.kernels import autotune as at
    from paddle_tpu_torch.ops.kernels import costmodel as cm
    problems = []
    name = os.path.splitext(os.path.basename(path))[0]
    try:
        with open(path) as f:
            raw = json.load(f)
    except (OSError, ValueError) as e:
        return {"file": path, "ok": False,
                "problems": ["unreadable/torn JSON: %s" % e]}
    if not isinstance(raw, dict) or "format_version" not in raw:
        return {"file": path, "ok": False,
                "problems": ["not a versioned banked cache (no "
                             "format_version envelope)"]}
    entries, meta = at.AutotuneCache.parse_blob(raw)
    try:
        ver = int(raw["format_version"])
    except (TypeError, ValueError):
        ver = None
    if ver != at.FORMAT_VERSION:
        problems.append("format_version %r unsupported (this build "
                        "speaks %d)" % (raw["format_version"],
                                        at.FORMAT_VERSION))
    if meta.get("backend") != name:
        problems.append("backend meta %r does not match filename %r"
                        % (meta.get("backend"), name))
    if not meta.get("card"):
        problems.append("no card meta: the card's name and power limit "
                        "(nvidia-smi) belong beside every verdict")

    banked = set()
    for key, entry in sorted(entries.items()):
        parsed = cm.parse_key(key)
        if parsed is None:
            problems.append("unparseable key %r" % key)
            continue
        op, shape, dtype, _axes, backend = parsed
        if op not in at.CANDIDATES:
            problems.append("key %r names unknown kernel family %r"
                            % (key, op))
            continue
        if backend != name:
            problems.append("key %r banked for backend %r in the %s file"
                            % (key, backend, name))
        if not isinstance(entry, dict) or entry.get("impl") not in (
                "pallas", "pallas_q"):
            problems.append("key %r has impl %r (a card's verdict is "
                            "'pallas' or 'pallas_q')"
                            % (key, entry.get("impl")
                               if isinstance(entry, dict) else entry))
            continue
        config = entry.get("config")
        if config is not None and not cm.feasible(
                op, shape, config,
                "bfloat16" if entry["impl"] == "pallas_q" else dtype,
                entry.get("hidden")):
            problems.append("key %r winner config %r is not one its "
                            "kernel takes at that shape" % (key, config))
        banked.add((op, shape))

    missing = ["%s@%s" % (op, "x".join(map(str, shape)))
               for op, shape in sorted(at.DEFAULT_SHAPES.items())
               if (op, tuple(shape)) not in banked]
    if missing:
        problems.append("grid coverage holes: %s" % ", ".join(missing))

    model = cm.CostModel().fit_cache(entries)
    hits, judged = cm.measured_best_in_topk(entries, model=model)
    top3_rate = round(hits / judged, 4) if judged else None
    if judged and top3_rate < min_top3:
        problems.append("cost-model ranking too weak: measured-best in "
                        "model top-3 on only %.0f%% of %d keys (< %.0f%%)"
                        % (100 * top3_rate, judged, 100 * min_top3))
    return {"file": path, "ok": not problems, "backend": name,
            "card": meta.get("card"), "entries": len(entries),
            "coverage_missing": len(missing), "rank_keys_judged": judged,
            "top3_rate": top3_rate, "model_rows": model.rows_total(),
            "problems": problems or None}


def main(argv=None):
    from paddle_tpu_torch.ops.kernels import autotune as at
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--file", action="append", default=[],
                    help="banked cache file(s) to check (default: every "
                         "tuned/*.json)")
    ap.add_argument("--min-top3", type=float, default=0.8,
                    help="minimum measured-best-in-model-top-3 rate")
    args = ap.parse_args(argv)
    files = args.file or sorted(glob.glob(
        os.path.join(at.tuned_dir(), "*.json")))
    reports = [check_file(p, min_top3=args.min_top3) for p in files]
    ok = bool(reports) and all(r["ok"] for r in reports)
    print(json.dumps({"metric": "tunecheck", "ok": ok,
                      "files": reports or
                      [{"problems": ["no banked caches found under %s"
                                     % at.tuned_dir()]}]}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
