"""The port's Executor keeps what a run derives from the program alone
(the ported-op check, the forward/grad pairing, each value's last
reader) per program version and fetch list, and makes it anew when the
program changes."""
import numpy as np

import paddle_tpu_torch as ptt
from paddle_tpu_torch import layers


def _program():
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = layers.data("x", [2, 3], dtype="float32", append_batch_size=False)
        y = layers.scale(x, scale=2.0)
    return main, x, y


def test_plan_is_made_once_per_program_version_and_fetch_list():
    main, x, y = _program()
    other, _, other_y = _program()
    exe = ptt.Executor(ptt.CPUPlace())
    feed = {"x": np.arange(6, dtype=np.float32).reshape(2, 3)}
    for _ in range(2):
        out, = exe.run(main, feed=feed, fetch_list=[y], scope=ptt.Scope())
        np.testing.assert_array_equal(out, feed["x"] * 2)
        exe.run(other, feed=feed, fetch_list=[other_y], scope=ptt.Scope())
    assert len(exe._plans) == 2
    plan = exe._plan(main, [y.name], True)
    assert plan is exe._plan(main, [y.name], True)

    # a fetch list of its own: another plan, the first is kept
    exe.run(main, feed=feed, fetch_list=[x, y], scope=ptt.Scope())
    assert len(exe._plans) == 3

    # an op appended after a run: the program's version moves on, and the
    # new op runs
    with ptt.program_guard(main):
        z = layers.scale(y, scale=3.0)
    out, = exe.run(main, feed=feed, fetch_list=[z], scope=ptt.Scope())
    np.testing.assert_array_equal(out, feed["x"] * 6)
    assert exe._plan(main, [y.name], True) is not plan


def test_plan_cache_off_keeps_nothing():
    main, _, y = _program()
    exe = ptt.Executor(ptt.CPUPlace())
    feed = {"x": np.ones((2, 3), np.float32)}
    out, = exe.run(main, feed=feed, fetch_list=[y], scope=ptt.Scope(),
                   use_program_cache=False)
    np.testing.assert_array_equal(out, 2 * feed["x"])
    assert exe._plans == {}
