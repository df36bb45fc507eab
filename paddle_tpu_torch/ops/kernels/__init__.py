"""Hand-written CUDA kernels of the port (counterpart of
paddle_tpu/ops/pallas/): each module holds its kernels' wrappers, their
plain PyTorch versions and their launch counters; ``build`` compiles
csrc/ at first use.

``launch_counts()`` reads every counter at once and
``credit_launches(delta)`` adds to them: a captured step's launches
happen on the device when its graph replays, with no wrapper called, so
the Executor credits each replay with what its capture counted."""
from . import (blockwise_ce, build, flash_attention, fused_adam,  # noqa: F401
               layer_norm, numeric_guard)

# (module, counter) of each kernel, in a fixed order
LAUNCH_COUNTERS = (
    (flash_attention, "launches"), (flash_attention, "dkv_launches"),
    (flash_attention, "dq_launches"), (layer_norm, "launches"),
    (layer_norm, "bwd_launches"), (fused_adam, "launches"),
    (blockwise_ce, "head_launches"), (blockwise_ce, "head_dh_launches"),
    (blockwise_ce, "head_dw_launches"), (blockwise_ce, "ce_launches"),
    (blockwise_ce, "ce_bwd_launches"), (numeric_guard, "launches"),
    (numeric_guard, "copy_launches"), (flash_attention, "f16_launches"),
    (flash_attention, "f16_dkv_launches"),
    (flash_attention, "f16_dq_launches"))


def launch_counts():
    """Every kernel's launch counter, in LAUNCH_COUNTERS order."""
    return tuple(getattr(mod, attr) for mod, attr in LAUNCH_COUNTERS)


def credit_launches(delta):
    """Add ``delta`` (a tuple in LAUNCH_COUNTERS order, may be negative)
    to the counters."""
    for (mod, attr), d in zip(LAUNCH_COUNTERS, delta):
        if d:
            setattr(mod, attr, getattr(mod, attr) + d)
