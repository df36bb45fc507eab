"""Install sanity check (counterpart of paddle_tpu/install_check.py).

Reference parity: python/paddle/fluid/install_check.py — builds a tiny
model, runs one train step, verifies the stack end-to-end.
"""
import numpy as np


def run_check(place=None):
    """Train a tiny fc one SGD step on ``place`` (CUDAPlace(0) unless
    CPUPlace() is passed; NoCUDADeviceError without a CUDA device) and
    check that its loss is finite."""
    from . import Program, program_guard, Executor, layers, optimizer
    from .framework.scope import Scope, scope_guard
    main, startup = Program(), Program()
    with scope_guard(Scope()):
        with program_guard(main, startup):
            x = layers.data("install_check_x", [2], dtype="float32")
            y = layers.data("install_check_y", [1], dtype="float32")
            pred = layers.fc(x, size=1)
            loss = layers.mean(layers.square_error_cost(pred, y))
            optimizer.SGD(0.01).minimize(loss)
        exe = Executor(place)
        exe.run(startup)
        out = exe.run(main,
                      feed={"install_check_x":
                            np.random.rand(4, 2).astype(np.float32),
                            "install_check_y":
                            np.random.rand(4, 1).astype(np.float32)},
                      fetch_list=[loss.name])
        exe.close()
    assert np.isfinite(out[0]).all(), "install check produced non-finite loss"
    print("Your paddle_tpu_torch works well on %s!" % exe.device)
    return True
