"""Inspect serialized model artifacts from the command line.

Counterpart of paddle_tpu/utils/show_pb.py. Reference parity:
python/paddle/utils/show_pb.py (print a serialized
ProgramDesc protobuf). This framework serializes Programs as JSON
(framework/program.py to_json) and inference artifacts as
model.json+manifest, so ``show`` pretty-prints those; ``read_proto``
keeps the reference entry-point name and explains the format change.
"""
import json
import os
import sys

__all__ = ["read_proto", "show", "main"]


def read_proto(file, message=None):
    """The reference parsed framework.proto ProgramDesc here; this
    framework has no protobuf IR — point callers at the JSON loader."""
    raise NotImplementedError(
        "paddle_tpu_torch serializes Programs as JSON, not protobuf; use "
        "show(path) here or paddle_tpu_torch.Program.from_json directly")


def _summarize_program(doc):
    blocks = doc.get("blocks", [])
    lines = ["Program: %d block(s), version %s"
             % (len(blocks), doc.get("version", "?"))]
    for bi, blk in enumerate(blocks):
        ops = blk.get("ops", [])
        vars_ = blk.get("vars", {})
        lines.append("  block %d: %d vars, %d ops" % (bi, len(vars_),
                                                      len(ops)))
        for op in ops:
            outs = op.get("outputs", {})
            out0 = next(iter(outs.values()), [""])
            lines.append("    %-24s -> %s" % (op.get("type", "?"),
                                              ", ".join(out0)))
    return "\n".join(lines)


def show(path, out=None):
    """Pretty-print a Program JSON file or a saved inference-model
    directory (model.json)."""
    out = out or sys.stdout
    if os.path.isdir(path):
        path = os.path.join(path, "__model__.json")
    with open(path, "r") as f:
        doc = json.load(f)
    if isinstance(doc, dict) and "program" in doc:
        # inference artifact (io.py save_inference_model): header + IR
        header = {k: v for k, v in doc.items()
                  if k not in ("program", "param_manifest")}
        out.write("Inference artifact %s\n" % json.dumps(header,
                                                         sort_keys=True))
        doc = doc["program"]
    out.write(_summarize_program(doc) + "\n")


def main(argv):  # pragma: no cover - CLI veneer
    if len(argv) != 1:
        sys.stderr.write("usage: python -m paddle_tpu_torch.utils.show_pb "
                         "<program.json | inference_model_dir>\n")
        return 1
    show(argv[0])
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main(sys.argv[1:]))
