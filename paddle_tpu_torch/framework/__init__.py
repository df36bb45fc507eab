from .program import (Program, Block, Operator, Variable, Parameter,  # noqa
                      default_main_program, default_startup_program,
                      program_guard, name_scope, switch_main_program,
                      switch_startup_program)
from .place import (CUDAPlace, CPUPlace, NoCUDADeviceError,  # noqa
                    _current_expected_place, is_compiled_with_cuda)
from .scope import Scope, global_scope, scope_guard  # noqa
from .executor import Executor  # noqa
from .compiler import (CompiledProgram, BuildStrategy,  # noqa
                       ExecutionStrategy)
from . import unique_name  # noqa
from . import analysis  # noqa
from . import obs  # noqa
from . import resilience  # noqa
from . import coordination  # noqa
from . import transport  # noqa
from . import watchdog  # noqa
from .watchdog import (CollectiveTimeoutError, wait_with_timeout,  # noqa
                       StragglerDetector)
from .resilience import (FaultInjector, RetryPolicy,  # noqa
                         ResilientTrainer, SimulatedPreemptionError,
                         ServerOverloadedError, DeadlineExceededError,
                         RestartBudgetExceededError)
from .coordination import (Coordinator, LocalCoordinator,  # noqa
                           FileCoordinator, SocketCoordinator,
                           PodResilientTrainer,
                           CoordinationError, HostLostError,
                           NoQuorumError)
from .transport import (CoordServer, CoordClient, TransportError,  # noqa
                        replicated_group)
