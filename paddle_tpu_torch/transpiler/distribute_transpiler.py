"""DistributeTranspiler (counterpart of paddle_tpu/transpiler/
distribute_transpiler.py; ref python/paddle/fluid/transpiler/
distribute_transpiler.py).

The reference rewrites a single-process Program into a trainer half
(send/recv ops to pservers) or, in collective mode, inserts NCCL
allreduce ops. The port's equivalent is the device mesh under
``CompiledProgram``: the Program's IR is unchanged, and the step runs
over the mesh. This adapter keeps the fluid call sequence working:

    t = DistributeTranspiler(config)
    t.transpile(trainer_id, trainers=N, pservers=..., program=prog)
    train_prog = t.get_trainer_program()     # the same Program

With one trainer, or more trainers than this process sees devices (a
multi-host job built in one process), no mesh is installed, as in the
JAX package; a mesh over more than one device arrives with the
torch.distributed slice (``distributed.mesh.init_mesh`` raises
NotPortedError for one). ``get_pserver_program`` raises with guidance:
there is no pserver process in the port.
"""
from ..distributed import mesh as mesh_mod
from ..framework import program as program_mod
from ..framework.compiler import visible_devices
from .ps_dispatcher import RoundRobin

__all__ = ["DistributeTranspiler", "DistributeTranspilerConfig"]


class DistributeTranspilerConfig(object):
    """Knobs of the reference transpiler (ref :134). slice_var_up /
    min_block_size governed pserver block slicing; on a mesh they say
    whether distributed embedding tables are row-sharded ("dp" rows)."""

    slice_var_up = True
    split_method = RoundRobin
    min_block_size = 8192
    enable_dc_asgd = False
    mode = "collective"
    print_log = False
    wait_port = True

    def __init__(self):
        pass


class DistributeTranspiler(object):
    """Configure a Program for multi-device or multi-host execution
    (ref :243). ``transpile`` records the job layout, installs a dp mesh
    when this process sees enough devices and none is active, and
    annotates distributed lookup tables; the Program IR is unchanged."""

    def __init__(self, config=None):
        self.config = config or DistributeTranspilerConfig()
        if self.config.split_method is None:
            self.config.split_method = RoundRobin
        if self.config.min_block_size < 8192:
            raise ValueError("min_block_size must be at least 8192")
        if self.config.split_method.__name__ not in ("RoundRobin",
                                                     "HashName"):
            raise ValueError("split_method must be RoundRobin or HashName")
        self._transpiled = False

    def transpile(self, trainer_id, program=None, pservers="127.0.0.1:6174",
                  trainers=1, sync_mode=True, startup_program=None,
                  current_endpoint="127.0.0.1:6174"):
        """Record the job layout and install a dp mesh sized to
        ``trainers`` when none is active and the devices are visible
        (ref :522)."""
        if program is None:
            program = program_mod.default_main_program()
        if not sync_mode:
            raise NotImplementedError(
                "async (pserver) mode has no counterpart in "
                "paddle_tpu_torch: data-parallel training syncs its "
                "gradients inside the step, over the mesh")
        self.trainer_id = trainer_id
        self.trainer_num = trainers
        self.sync_mode = sync_mode
        self.origin_program = program
        self.startup_program = (startup_program or
                                program_mod.default_startup_program())
        self.pserver_endpoints = [e.strip() for e in pservers.split(",")
                                  if e.strip()]
        if mesh_mod.get_mesh() is None and trainers > 1 and \
                visible_devices() >= trainers:
            mesh_mod.init_mesh({"dp": trainers})
        # else: one trainer, or a multi-host job built in one process:
        # the mesh is installed at launch, where every host's devices
        # are visible
        if self.config.slice_var_up:
            for var in program.global_block().all_parameters():
                if getattr(var, "is_distributed", False):
                    var.sharding = ("dp",) + (None,) * (len(var.shape) - 1)
        self._transpiled = True

    def get_trainer_program(self, wait_port=True):
        """The trainer-side Program (ref :961): the same IR object; run it
        through CompiledProgram."""
        if not self._transpiled:
            raise RuntimeError("call transpile() first")
        return self.origin_program

    def get_startup_program(self, endpoint=None, pserver_program=None,
                            startup_program=None):
        """The trainer's startup Program (ref :1398)."""
        if not self._transpiled:
            raise RuntimeError("call transpile() first")
        return self.startup_program

    def _no_pserver(self):
        raise NotImplementedError(
            "paddle_tpu_torch has no pserver process: dense gradients "
            "sync inside the step over the device mesh, and sparse "
            "tables are row-sharded mesh state (both multi-device paths "
            "arrive with the torch.distributed slice). Port a pserver "
            "job by dropping the pserver launch and running the trainer "
            "program under CompiledProgram.")

    def get_pserver_program(self, endpoint):  # ref :1096
        self._no_pserver()

    def get_pserver_programs(self, endpoint):  # ref :1367
        self._no_pserver()
