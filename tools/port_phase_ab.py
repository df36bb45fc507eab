#!/usr/bin/env python3
"""Run some of ``chip_smoke.py``'s phases in several checkouts, one after
the other on the same card, to compare the step times of two versions of
the port.

    python3 tools/port_phase_ab.py --phases train_recipe,gpt_train_bf16 \
        A B B A

Each of A and B is the root of a checkout (with ``chip_smoke.py`` and
``paddle_tpu_torch/``). Every argument runs in its own process, in the
order given, which builds that tree's kernels into its own ``build/``,
runs the named phases of that tree's ``chip_smoke.py`` (each a function
``phase(torch, np, ptt, counters)``, its Executor closed after it) and
prints one JSON line: the tree, the card's name and power limit, and for
each phase its step times (``step_ms``; for ``gpt_train_bf16`` the
recomputed run's) and whether it passed. The phases keep their own
checks; a phase that fails is reported, and the tool exits non-zero.

Needs a CUDA card; prints nothing and exits non-zero without one.
"""
import argparse
import json
import os
import subprocess
import sys


def _step_ms(line):
    """The step times in a phase's JSON line."""
    if "step_ms" in line:
        return line["step_ms"]
    return line.get("recompute_run", {}).get("step_ms")


def _one_tree(phases):
    import numpy as np
    import torch
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.framework.executor import set_precision
    from paddle_tpu_torch.ops import kernels
    set_precision()                          # no TF32 anywhere
    lines = []
    chip_smoke.emit = lines.append           # keep the phases' lines here
    kernels.build.load()
    counters = chip_smoke.Counters(
        kernels.flash_attention, kernels.layer_norm, kernels.fused_adam,
        kernels.blockwise_ce, kernels.numeric_guard)
    out = {"tree": os.getcwd(), "card": chip_smoke.nvidia_smi(),
           "phases": {}}
    for name in phases:
        done = chip_smoke.phase(name)(getattr(chip_smoke, name))(
            torch, np, ptt, counters)
        line = next((x for x in reversed(lines)
                     if x.get("phase") == name), {})
        out["phases"][name] = {"ok": bool(line.get("ok")) and
                               name not in chip_smoke._failed,
                               "step_ms": _step_ms(line)}
        state = None if done is None else done[1]
        if isinstance(state, tuple) and hasattr(state[0], "close"):
            state[0].close()                 # the phase's Executor
        del done, state
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 1 if chip_smoke._failed else 0


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", required=True,
                    help="comma-separated chip_smoke.py phase functions")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("trees", nargs="*")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if args.one:
        import torch
        if not torch.cuda.is_available():
            return 2
        return _one_tree(phases)
    rc = 0
    for tree in args.trees:
        done = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", "--phases", args.phases], cwd=tree)
        rc = rc or done.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
