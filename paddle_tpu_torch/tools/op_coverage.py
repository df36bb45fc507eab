"""Kernel-coverage audit of the port's op registry: which registered op
types did a run never invoke (counterpart of the JAX package's
tools/op_coverage.py, same report and exit codes).

Usage:
  PADDLE_TPU_OP_COVERAGE=/tmp/opcov.txt python -m pytest tests/ -q
  python -m paddle_tpu_torch.tools.op_coverage /tmp/opcov.txt

With ``PADDLE_TPU_OP_COVERAGE`` set, every op kernel that runs appends
its type to the file once (ops/registry.py). Exit 0 when every
registered type ran, 1 when some did not, 2 when the file is missing.
"""
import sys


def main(path):
    import paddle_tpu_torch  # noqa: F401 - populate the registry
    from paddle_tpu_torch.ops.registry import registered_ops
    try:
        with open(path) as f:
            exercised = {ln.strip() for ln in f if ln.strip()}
    except OSError:
        print("coverage file %s missing — run the suite with "
              "PADDLE_TPU_OP_COVERAGE=%s first" % (path, path))
        return 2
    registered = set(registered_ops())
    uncovered = sorted(registered - exercised)
    print("registered: %d  exercised: %d  uncovered: %d"
          % (len(registered), len(exercised), len(uncovered)))
    for n in uncovered:
        print("  " + n)
    return 0 if not uncovered else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "/tmp/opcov.txt"))
