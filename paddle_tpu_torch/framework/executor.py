"""Executor: run a Program op by op on torch tensors; on a CUDA card,
capture each warm step into a CUDA graph and replay it.

Counterpart of paddle_tpu/framework/executor.py + trace.py. ``run``
interprets the global block's ops in order: feeds and persistable scope
values go in, persistable outputs go back to the scope, fetches come out.
A training program (``minimize`` appended ``grad_of`` and optimizer ops)
runs the same way: each forward op that a ``grad_of`` names runs with
autograd on the inputs that op asks a gradient for, and the ``grad_of``
op computes them (framework/trace.py); every other op runs under
``torch.no_grad()``. The loop is ``run_block``, which also runs a
sub-block's ops for the op that owns it (``remat_block`` runs its segment
once in the forward and again in the backward). A var's value is dropped
after the last op that reads it, unless it is persistable or fetched.
Optimizer ops may update parameters and moments in place (the fused-Adam
kernel does); a gradient that runs after such an op and needs the old
value reads a copy its forward op's record kept (the in-place rule,
framework/trace.py ``overwritten_inputs``: decided once per plan, and a
program whose gradients all run before its updates copies nothing).
What a run derives from the program alone (the check that every op is
ported, the forward/grad pairing, each value's last reader,
the random ops' generators) is made once per program version and fetch
list and reused.

The compiled step (the JAX package's ``_run_jitted``): on a CUDA place a
run with a fetch list is keyed as the JAX package keys its jitted step:
the program and its version, the feeds' names, shapes and dtypes, the
fetch names, the scope's persistable names, shapes and dtypes, and the
scope (``_graph_key``).
The first run of a key goes op by op; it is the warm-up that builds the
kernels and runs every lazy initialisation. The second captures that
same op-by-op step into a CUDA graph and replays it; later runs only
replay (framework/compiled_step.py). Every run of a key, op by op or
replayed, runs on the Executor's own stream, which waits for the
caller's stream first and which the caller's stream waits for after.
Startup programs (no fetch list), ``use_program_cache=False`` and a CPU
place always run op by op. A capture that fails raises, naming the op.
A program holding an op that reads a device value on the host
(``cond`` and ``while_loop`` choose on the host, ``print`` prints there;
``OpDef.syncs_host``), in any block, is never captured: its CUDA runs go
op by op and ``Executor.refusals`` records the op and why. The loops
whose trip count the program fixes (``bounded_while``,
``recurrent_scan``: ``StaticRNN``, ``DynamicRNN``, ``layers.rnn``) keep
their predicates on the device and are captured like any other op.
``run_steps`` runs a window of steps from stacked feeds with one host
sync, at its end. ``close()`` drops the graphs and their memory pool.

The compile seam (the JAX package's compile-cache miss): a step whose
(plan key, feed shapes, strategy token) this Executor has not run, or any
step under ``use_program_cache=False``, first runs the Program verifier
(``compiler.verify_for_compile`` with the feeds' shapes and the fetch
roots; "strict" raises ProgramVerificationError before any op runs) and
builds its plan. A hit costs one dict probe. Every step is an
``exec.step`` span (framework/obs.py; labels ``entry`` and ``cache``)
over ``exec.compile`` (the seam on a miss; on the card also the run that
captures the graph, which labels its step a miss too), ``exec.execute``
and ``exec.writeback``, and each phase is observed in the
``executor_step_seconds{kind=}`` histogram ("compile", "execute",
"writeback", "total").

A CompiledProgram (framework/compiler.py) runs the same way on one card:
``_unwrap`` checks its strategy against the Executor's device; its
kernel selection (``use_pallas``, ``pallas_tune_cache``,
``kernel_policy``) gives each compile its ``kernel_dispatch.PallasConfig``,
under which the compile's runs decide each kernel call site's launch
config once (ops/kernel_dispatch.py), and whose token is part of the CUDA
graph's key; its numeric guard (``check_numerics``, ``numeric_policy``;
framework/guard.py) is part of the key: the finite check and, under
"skip", the revert run
inside the captured step, and the host reads the verdict once a run or
once a ``run_steps`` window (``_settle_run``, ``_run_window``). A run with
a fetch list is a step for the fault hooks: the legacy injector's
``step`` point, the ``executor.step`` failpoint (which may poison a feed)
and, when armed, the straggler detector and the collective timeout
(``_await_pending``, ``_after_dispatch``).

Random draws: each random op draws from a generator seeded from
(program.random_seed, the scope's run counter, the op's block and
position), so run k draws other numbers than run k - 1 and a fresh
Executor on the same scope carries the stream on. On a CUDA card the
generators are Philox generators held by the plan and re-seeded at the
start of every run, so a replayed run k draws what op-by-op run k draws
(``_Generators``); on the CPU each draw takes a new generator.

Precision: f32 matmuls and convolutions run in full f32 — TF32 is
switched off where the Executor is made
(``torch.backends.cuda.matmul.allow_tf32 = False``) — bf16 matmuls sum
in f32, and cuDNN runs deterministic algorithms (``set_precision``).

Threads: the Executors of one process take their steps one at a time
(``run``, ``run_steps`` and ``close`` hold one process-wide re-entrant
lock, ``_STEP_LOCK``), so a pod of simulated hosts on one card
(framework/coordination.py) never has another host's kernels, mallocs
or syncs inside a capture window, and a capture's launch count is its
own. A caller that holds the lock around a step reads the kernels'
launch counters before and after it as that step's own.
"""
import functools
import hashlib
import threading
import time

import numpy as np
import torch

from ..ops import kernel_dispatch
from ..ops.registry import NotPortedError, get_op, has_op
from . import faultinject, obs, resilience, trace, watchdog
from .compiled_step import CompiledStep, GraphCaptureError
from .compiler import verify_for_compile
from .dtypes import to_torch_dtype
from .guard import StepGuard
from .place import _current_expected_place
from .program import default_main_program
from .scope import global_scope, to_numpy
from .trace import EMPTY_VAR, GRAD_OP_TYPE

_SALT_VAR = "@EAGER_SALT@"

# one Executor step at a time in the process (see the module docstring)
_STEP_LOCK = threading.RLock()


def _one_step_at_a_time(fn):
    """``fn`` (an Executor method) under the process-wide step lock."""
    @functools.wraps(fn)
    def locked(self, *args, **kwargs):
        with _STEP_LOCK:
            return fn(self, *args, **kwargs)
    return locked


def set_precision():
    """Full-f32 math on the card: no TF32 in matmuls or convolutions, and
    bf16 and fp16 matmuls sum in f32 to the end (no split-K partial sums
    rounded to bf16 or fp16). cuDNN picks deterministic convolution
    algorithms by its heuristics, never by timing (a filter gradient
    summed with atomics would make two runs of a step, or a replay and an
    op-by-op run, differ in their last bits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def _next_salt(scope):
    """The scope's run counter: this run's value, advanced by one."""
    salt = scope.find_var(_SALT_VAR) or 0
    scope.set_var(_SALT_VAR, salt + 1)
    return salt


def _numeric_config(program, strategy):
    """(check_numerics, policy, skip_budget) of one run (paddle_tpu's
    ``_numeric_config``): a numeric_policy other than "raise" implies the
    finite guard even when check_numerics was left False."""
    policy, budget = "raise", 3
    if strategy is not None:
        bs = strategy._build_strategy
        policy = getattr(bs, "numeric_policy", "raise") or "raise"
        budget = int(getattr(bs, "numeric_skip_budget", 3) or 1)
    check = bool(
        getattr(program, "_check_numerics", False)
        or (strategy is not None and
            getattr(strategy._build_strategy, "check_numerics", False))
        or policy != "raise")
    return check, policy, budget


def _hit_step_feed(feed):
    """The executor.step failpoint: a chaos schedule may NaN-poison or
    bit-flip a named feed array (or raise, or delay) at a chosen step."""
    out = faultinject.hit("executor.step", feed)
    return feed if out is faultinject.DROP else out


def _draw_seed(attr_seed, random_seed, salt, pos):
    """The seed of a random op's draw in one run: its ``seed`` attr, else
    one derived from (program.random_seed, the scope's run counter, the
    op's block and position)."""
    if attr_seed:
        return int(attr_seed)
    tag = "%d/%d/%s" % (random_seed, salt, pos)
    return int.from_bytes(hashlib.sha256(tag.encode()).digest()[:8],
                          "little") >> 1


class _Generators(object):
    """A plan's Philox generators on a CUDA card: one for each (op
    position, n-th draw of that position in a run), kept for the plan's
    life and registered with every graph that draws from them. ``seat``
    re-seeds each at the start of every run, op by op or replayed, with
    the seed the CPU path draws from (``_draw_seed``); a replay writes a
    registered generator's seed and offset into the graph, so replay k
    draws what op-by-op run k draws. A second draw of a position in one
    run (a recomputed segment's op) takes a twin generator seeded alike,
    so it draws the forward's numbers again: inside a capture a
    generator's state cannot be set back, and the twin is how that state
    is restored. A ``fixed`` generator is seated with run 0's salt at
    every run (``RunContext.generator``'s unflagged draws)."""

    def __init__(self, device, random_seed):
        self._device = device
        self._random_seed = random_seed
        self._gens = {}    # (position, n) -> (generator, seed attr, fixed)
        self._salt = 0

    def generators(self):
        return [g for g, _, _ in self._gens.values()]

    def seat(self, salt):
        self._salt = salt
        for (pos, _), (g, attr_seed, fixed) in self._gens.items():
            g.manual_seed(_draw_seed(attr_seed, self._random_seed,
                                     0 if fixed else salt, pos))

    def get(self, pos, n, attr_seed, capturing, fixed=False):
        entry = self._gens.get((pos, n))
        if entry is None:
            if capturing:
                raise RuntimeError(
                    "the op at %s draws from a generator its warm run did "
                    "not make" % pos)
            g = torch.Generator(device=self._device)
            g.manual_seed(_draw_seed(attr_seed, self._random_seed,
                                     0 if fixed else self._salt, pos))
            entry = self._gens[(pos, n)] = (g, attr_seed, fixed)
        return entry[0]


class RunContext(object):
    """What an op kernel sees as ``ctx``: the device, the program (a
    block-running op finds its sub-block there), seeded generators for
    random ops, constants made once per plan and ``run_block`` for a
    sub-block's ops."""

    def __init__(self, device, program, salt, rng=None, constants=None,
                 capturing=False, keyed=True):
        self.device = device
        self.program = program
        self.op = None
        self._salt = salt
        self._keyed = keyed
        self._rng = rng
        self._constants = constants
        self._capturing = capturing
        self._draws = {}
        self._op_pos = "0"

    def begin_op(self, block_idx, op_idx, op=None):
        # a global-block op keeps the key it had before sub-blocks ran
        self._op_pos = "%d" % op_idx if block_idx == 0 else \
            "%d.%d" % (block_idx, op_idx)
        self.op = op

    @property
    def site(self):
        """The current op's position in its program ("i", or "block.i"
        in a sub-block): a kernel call site's name for its decisions
        (ops/kernel_dispatch.decide)."""
        return self._op_pos

    def generator(self, attrs, flagged=True):
        """A seeded torch.Generator on the run's device for the current
        op, seeded from the op's ``seed`` attr, else from
        (program.random_seed, run salt, the op's block and position)
        (``_draw_seed``): on a CUDA card the plan's generator of the op's
        position and draw (``_Generators``), on the CPU a new one. Either
        way an op run again in the same run (a recomputed segment) draws
        what it drew the first time.

        ``flagged=False`` is the draw of an op the registry does not flag
        ``uses_rng`` (rpn_target_assign, generate_proposal_labels): the
        JAX package keys its trace by the step counter only when a
        flagged op is in the program, else by the program seed alone
        (paddle_tpu/framework/executor.py:711-717), so such an op draws
        from the run counter only beside a flagged op, else run 0's
        numbers at every run."""
        seed = attrs.get("seed", 0)
        fixed = not flagged and not self._keyed
        if self._rng is not None:
            n = self._draws.get(self._op_pos, 0)
            self._draws[self._op_pos] = n + 1
            return self._rng.get(self._op_pos, n, seed, self._capturing,
                                 fixed)
        g = torch.Generator(device=self.device)
        g.manual_seed(_draw_seed(seed, self.program.random_seed,
                                 0 if fixed else self._salt, self._op_pos))
        return g

    def constant(self, make):
        """A copy of ``make()``'s tensor. Where the run may be captured,
        the tensor is made once per plan (its first run is op by op) and
        copied on the device after, so no host data enters the step."""
        if self._constants is None:
            return make()
        t = self._constants.get(self._op_pos)
        if t is None:
            t = self._constants[self._op_pos] = make()
        return t.clone()

    def run_block(self, block, env, keep=()):
        """Run a sub-block's ops on ``env`` (its inputs bound by name),
        freeing each value after its last reader unless it is an input or
        in ``keep``."""
        run_block(block, env, self,
                  drop=_last_uses(block.ops, set(env) | set(keep)))


def _check_runnable(program):
    """Refuse, before any op runs, a program holding an op the port has
    no kernel for, in any block."""
    for blk in program.blocks:
        for op in blk.ops:
            if op.type != GRAD_OP_TYPE and not has_op(op.type):
                raise NotPortedError(
                    "op %r (op_role=%r) is not ported to paddle_tpu_torch "
                    "yet; ROADMAP.md lists the slices to come"
                    % (op.type, op.attrs.get("op_role")))


def _host_sync(program):
    """Why a step of ``program`` cannot be captured into a CUDA graph: the
    first op, in any block, that reads a device value on the host
    (``OpDef.syncs_host``), or None."""
    for blk in program.blocks:
        for i, op in enumerate(blk.ops):
            if op.type != GRAD_OP_TYPE and get_op(op.type).syncs_host:
                return ("op {%s} (block %d, op %d) reads a device value on "
                        "the host" % (op.type, blk.idx, i))
    return None


def _last_uses(ops, keep):
    """{op index: [var names whose value no later op reads]}, sparing
    ``keep``."""
    last = {}
    for i, op in enumerate(ops):
        for n in op.input_names() + op.output_names():
            last[n] = i
    drop = {}
    for n, i in last.items():
        if n not in keep and n != EMPTY_VAR:
            drop.setdefault(i, []).append(n)
    return drop


def _fetch_names(fetch_list):
    return [f.name if hasattr(f, "name") else f for f in fetch_list]


def _pull_readers(program, feed):
    """``feed`` with the next batch of each started py_reader of
    ``program`` whose variables it does not name (paddle_tpu's
    ``Executor.run``, the reference's create_py_reader_op). Two phases: a
    reader's EOF (or error) pushes the batches its siblings already gave
    back to them, so no data is lost; a fed name is never overwritten."""
    pulled = []
    try:
        for rdr in getattr(program, "_py_readers", ()):
            if rdr._started and any(n not in feed for n in rdr._names):
                pulled.append((rdr, rdr._next_feed()))
    except Exception:
        for rdr, batch in pulled:
            rdr._push_back(batch)
        raise
    for rdr, batch in pulled:
        for n, v in batch.items():
            feed.setdefault(n, v)
    return feed


def _fetch(env, names, state=None):
    """The fetches' tensors: from ``state`` (a replayed step's persistables,
    written back) where it has the name, else from ``env``."""
    out = []
    for name in names:
        if state is not None and name in state:
            out.append(state[name])
        elif name in env:
            out.append(env[name])
        else:
            raise KeyError("fetch %r has no value after the run: it was "
                           "neither fed, in scope, nor produced by an op"
                           % name)
    return out


class _RunPlan(object):
    """What ``run`` derives from the program alone: made once per
    (program, version, fetch names) and reused by later runs; on a CUDA
    card it also holds the random ops' generators and the constants of a
    step that may be captured."""
    __slots__ = ("key", "program", "persistable", "want", "last_grad",
                 "keep", "drop", "rng", "constants", "reads", "syncs_host",
                 "writes", "uses_rng")

    def __init__(self, key, program, fetch_names, device):
        _check_runnable(program)
        blk = program.global_block()
        self.key = key
        self.program = program
        self.persistable = sorted({v.name for v in program.list_vars()
                                   if v.persistable})
        self.want, self.last_grad = trace.wanted_grads(blk)
        self.keep = trace.overwritten_inputs(blk, self.last_grad)
        self.drop = _last_uses(blk.ops,
                               set(self.persistable) | set(fetch_names))
        self.rng = _Generators(device, program.random_seed) \
            if device.type == "cuda" else None
        self.constants = {}
        # the names some op of some block reads, and the fetches: a fed
        # name outside these and the program's vars is read by nothing
        self.reads = set(fetch_names).union(
            n for b in program.blocks for op in b.ops
            for n in op.input_names())
        self.syncs_host = _host_sync(program)
        # the persistables a step writes (some op of some block outputs
        # them): what the numeric guard's "skip" keeps and reverts
        kept = set(self.persistable)
        self.writes = sorted({n for b in program.blocks for op in b.ops
                              for n in op.output_names() if n in kept})
        self.uses_rng = any(
            op.type != GRAD_OP_TYPE and get_op(op.type).uses_rng
            for b in program.blocks for op in b.ops)


def _plan_key(program, fetch_names):
    # the key holds the var count too: creating a var bumps no version
    return (id(program), program._version,
            sum(len(b.vars) for b in program.blocks), tuple(fetch_names),
            program.random_seed)


def _feed_shapes(feed, lead=0):
    """((name, shape), ...) of a feed dict, sorted, each shape without its
    first ``lead`` dims (a ``run_steps`` window's steps axis); a shape is
    read without a copy or a device sync."""
    return tuple(sorted(
        (n, tuple(v.shape if hasattr(v, "shape") else np.shape(v))[lead:])
        for n, v in feed.items()))


def _check_feed_shape(name, got, var):
    """Raise ValueError when a feed of shape ``got`` does not fit the
    shape its variable ``var`` declares (a -1 dim fits any size)."""
    if var is None or var.shape is None:
        return
    want = var.shape
    if len(want) != len(got):
        raise ValueError(
            "feed %r has rank %d (shape %s) but the program declares rank "
            "%d (shape %s)" % (name, len(got), got, len(want), tuple(want)))
    for w, g in zip(want, got):
        if w not in (-1, g):
            raise ValueError("feed %r shape %s incompatible with declared "
                             "%s" % (name, got, tuple(want)))


def _graph_key(plan, feeds, state, scope, guard=None, kernels=None):
    """The key of a CUDA run's captured step: the plan's key, each feed's
    name, shape and dtype, each state tensor's name, shape and dtype, the
    scope, the numeric guard's policy (None: no guard; as paddle_tpu's
    step cache holds check_numerics and the policy) and the kernel
    selection's token (``kernels``, a PallasConfig or None: a captured
    step holds its launch configs). A persistable of a new shape is a new
    key (its first run goes op by op, as ``jax.jit`` traces again on a
    new shape), never a copy into the captured shape."""
    return (plan.key, tuple(sorted((n, tuple(t.shape), d)
                                   for n, (t, d) in feeds.items())),
            tuple((n, tuple(v.shape), v.dtype) for n, v in state), id(scope),
            guard, None if kernels is None else kernels.token)


def _checked(fetch_names, fetches, state):
    """The numeric guard's mask order: the fetches, then the state
    ([(name, tensor)] in name order)."""
    return list(zip(fetch_names, fetches)) + list(state)


class Executor(object):
    """``Executor(place=None)``: place defaults to CUDAPlace(0) and raises
    NoCUDADeviceError without a CUDA device; pass CPUPlace() to run on the
    CPU. ``capture_log`` lists each capture: its feeds' shapes, its
    time, the memory the pool grew by, and the launches of each kernel
    a replay is credited (in ``ops.kernels.LAUNCH_COUNTERS`` order).
    ``graph_runs`` counts the runs of CUDA keys: ``warm`` (a key's first
    run, op by op), ``capture`` (its second, captured and replayed),
    ``replay``, and ``refused`` (a ``run`` or ``run_steps`` call of a
    program that is never captured, which goes op by op). ``refusals``
    maps each such program's plan key to the reason (``_host_sync``)."""

    def __init__(self, place=None):
        self.place = place if place is not None else _current_expected_place()
        self.device = self.place.torch_device()
        self._plans = {}
        self._graphs = {}
        self._warm = set()
        self._pool = None
        self._stream = None
        self.capture_log = []
        self.refusals = {}
        self.graph_runs = {"warm": 0, "capture": 0, "replay": 0,
                           "refused": 0}
        # the compile seam's cache: (plan key, feed shapes, strategy
        # token) -> plan; and the last capture's (wall t0, t1, seconds)
        self._compiled = {}
        self._last_capture = None
        self._guards = {}
        # numeric_policy="skip": consecutive steps discarded; a clean step
        # resets it, crossing the budget escalates
        self._numeric_skips = 0
        # the last dispatch's end (a CUDA event), when a collective
        # timeout is armed and that call did not wait for it
        self._pending = None
        set_precision()

    @_one_step_at_a_time
    def close(self):
        """Drop the captured graphs, their memory pool and the plans (the
        counterpart of paddle_tpu's ``Executor.close``); the scope keeps
        its tensors."""
        self._graphs.clear()
        self._warm.clear()
        self._plans.clear()
        self._compiled.clear()
        self._guards.clear()
        self.refusals.clear()
        self._pending = None
        self._pool = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def _plan(self, program, fetch_names, use_program_cache):
        key = _plan_key(program, fetch_names)
        plan = self._plans.get(key) if use_program_cache else None
        if plan is None or plan.program is not program:
            plan = _RunPlan(key, program, fetch_names, self.device)
            if use_program_cache:
                self._plans[key] = plan
        return plan

    def _compile(self, program, strategy, shapes, fetch_names,
                 use_program_cache, sp):
        """(the step's plan, the compile's kernel dispatch config or
        None). On a compile-cache miss (see the module docstring), under
        an ``exec.compile`` span: the verifier with the feeds' ``shapes``
        and the fetch roots, then the plan and a fresh dispatch config
        (whose decisions the compile's first run makes); the step's span
        is labelled "miss" and the "compile" histogram observes the seam.
        A hit is one probe of ``_compiled``."""
        key = (_plan_key(program, fetch_names), shapes,
               None if strategy is None else
               strategy._cache_token(self.device))
        hit = self._compiled.get(key) if use_program_cache else None
        if hit is not None and hit[0].program is program:
            sp.set(cache="hit")
            return hit
        sp.set(cache="miss")
        t0 = time.perf_counter()
        with obs.span("exec.compile"):
            # a feed that does not fit its declaration is the caller's
            # error, named before the verifier sees its shape
            blk = program.global_block()
            for name, shape in shapes:
                _check_feed_shape(name, shape, blk._find_var_recursive(name))
            verify_for_compile(
                program,
                None if strategy is None else strategy._build_strategy,
                feeds=dict(shapes), fetch_names=fetch_names,
                source="compile")
            plan = self._plan(program, fetch_names, use_program_cache)
            kernels = None if strategy is None else \
                strategy._kernel_config(self.device)
        if use_program_cache:
            self._compiled[key] = (plan, kernels)
        resilience.observe_executor_step("compile",
                                         time.perf_counter() - t0)
        return plan, kernels

    def _note_capture(self, captures, sp):
        """After a step: when it captured a graph (``graph_runs``'
        capture count moved past ``captures``), label its span a miss,
        record the capture as an ``exec.compile`` span under it and
        observe it in the "compile" histogram."""
        if self.graph_runs["capture"] == captures:
            return
        w0, w1, seconds = self._last_capture
        sp.set(cache="miss")
        obs.record("exec.compile", w0, w1, trace_id=sp.trace,
                   parent=sp.id, what="capture")
        resilience.observe_executor_step("compile", seconds)

    def _feed_tensors(self, program, feed, plan):
        """{name: (tensor as given, dtype it runs in)}, each checked against
        the shape the program declares. A feed the program neither
        declares nor reads (``plan.reads``; a dataset's ``<slot>__lens``
        beside a model that reads only the padded slot) is dropped, so it
        is no part of a graph's key and no static buffer copies it each
        replay; paddle_tpu passes it into its jitted step, where nothing
        reads it either."""
        out = {}
        blk = program.global_block()
        for name, val in feed.items():
            var = blk._find_var_recursive(name)
            if var is None and name not in plan.reads:
                continue
            if isinstance(val, torch.Tensor):
                t = val
            else:
                t = torch.from_numpy(np.ascontiguousarray(np.asarray(val)))
            _check_feed_shape(name, tuple(t.shape), var)
            out[name] = (t, to_torch_dtype(var.dtype) if var is not None
                         else t.dtype)
        return out

    def _graphed(self, plan, fetch_names, use_program_cache):
        """Whether this run goes through the compiled step; a program that
        reads a device value on the host is refused, and the refusal
        recorded under its plan's key."""
        if not (fetch_names and use_program_cache and
                self.device.type == "cuda"):
            return False
        if plan.syncs_host is None:
            return True
        self.graph_runs["refused"] += 1
        self.refusals[plan.key] = plan.syncs_host
        return False

    @_one_step_at_a_time
    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name=None, fetch_var_name=None, scope=None,
            return_numpy=True, use_program_cache=True):
        """One step of ``program`` (a Program or a CompiledProgram). A
        started py_reader of the program (``layers.py_reader``) feeds its
        variables unless ``feed`` names them; an exhausted one raises
        ``layers.EOFException``.

        A run with a fetch list is a step: the legacy injector's ``step``
        point and the ``executor.step`` failpoint fire first, the
        straggler detector (when armed) observes it, and a
        CompiledProgram's numeric guard and collective timeout apply
        (``_settle_run``, ``_after_dispatch``)."""
        program, strategy = self._unwrap(program)
        scope = scope if scope is not None else global_scope()
        feed = _pull_readers(program, dict(feed or {}))
        fetch_names = _fetch_names(fetch_list or [])
        if not fetch_names:          # a startup program: not a step
            plan = self._plan(program, fetch_names, use_program_cache)
            self._run_ops(program, plan, self._feed_tensors(
                program, feed, plan), fetch_names, scope)
            return []
        resilience.fire("step", what="Executor.run")
        feed = _hit_step_feed(feed)
        t0 = time.perf_counter()
        with obs.span("exec.step", entry="run") as sp:
            timeout = self._await_pending(strategy)
            check, policy, budget = _numeric_config(program, strategy)
            plan, kernels = self._compile(program, strategy,
                                          _feed_shapes(feed), fetch_names,
                                          use_program_cache, sp)
            feeds = self._feed_tensors(program, feed, plan)
            salt = scope.find_var(_SALT_VAR) or 0
            captures = self.graph_runs["capture"]
            t1 = time.perf_counter()
            with obs.span("exec.execute"), kernel_dispatch.scope(kernels):
                fetches, guard = self._step(
                    program, plan, feeds, fetch_names, scope,
                    self._graphed(plan, fetch_names, use_program_cache),
                    policy if check else None, fresh=True,
                    copy=not return_numpy, kernels=kernels)
                self._after_dispatch(timeout,
                                     return_numpy or guard is not None,
                                     "Executor.run step")
            resilience.observe_executor_step("execute",
                                             time.perf_counter() - t1)
            self._note_capture(captures, sp)
            t1 = time.perf_counter()
            with obs.span("exec.writeback"):
                if guard is not None:
                    self._settle_run(guard, guard.flags.cpu().numpy(),
                                     policy, budget, scope, salt,
                                     plan.uses_rng)
                out = [to_numpy(t) for t in fetches] if return_numpy \
                    else fetches
            resilience.observe_executor_step("writeback",
                                             time.perf_counter() - t1)
        resilience.observe_executor_step("total", time.perf_counter() - t0)
        watchdog.observe_step_latency(time.perf_counter() - t0,
                                      what="Executor.run")
        return out

    def train_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100,
                           steps_per_dispatch=1):
        """Every batch of ``dataset`` through ``program``'s step (paddle_tpu's
        ``train_from_dataset``; reference executor.py / MultiTrainer): a
        host thread collates the next batches while this one runs the
        step. ``steps_per_dispatch`` = W runs each W like-shaped batches
        as one ``run_steps`` window. Returns (steps run, the last step's
        fetches as numpy arrays)."""
        from ..trainer_factory import TrainerFactory
        if dataset is None:
            raise ValueError("dataset is required")
        program = program if program is not None else default_main_program()
        trainer_cls = TrainerFactory()._create_trainer(
            getattr(program, "_fleet_opt", None))
        trainer = trainer_cls(self, program)
        return trainer.run(dataset, fetch_list=fetch_list,
                           fetch_info=fetch_info,
                           print_period=print_period, debug=debug,
                           scope=scope,
                           steps_per_dispatch=steps_per_dispatch)

    def infer_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100):
        """The same loop over an inference program. A program holding
        parameter-update or learning-rate-schedule ops is refused, as
        paddle_tpu refuses it: inference on a training program would
        train."""
        program = program if program is not None else default_main_program()
        update_ops = sorted({
            op.type for blk in program.blocks for op in blk.ops
            if op.attrs.get("op_role") in ("optimize", "lr_sched")})
        if update_ops:
            raise ValueError(
                "infer_from_dataset got a program containing parameter-"
                "update ops %s; pass the inference program (e.g. "
                "program.clone(for_test=True) taken BEFORE minimize(), or "
                "use train_from_dataset to train)" % (update_ops,))
        return self.train_from_dataset(program, dataset, scope, thread,
                                       debug, fetch_list, fetch_info,
                                       print_period)

    @_one_step_at_a_time
    def run_steps(self, program=None, feed=None, fetch_list=None,
                  scope=None, return_numpy=True, use_program_cache=True):
        """Run N consecutive steps of ``program`` (a Program or a
        CompiledProgram): ``feed`` maps each feed name to an array with a
        leading steps axis, and step i consumes ``feed[name][i]``. Returns
        the fetches of every step, stacked on a leading axis of length N;
        step i draws what the i-th of N ``run`` calls would draw, and the
        state moves as N runs move it.

        Counterpart of paddle_tpu's ``Executor.run_steps`` (one
        ``lax.scan`` device program) without its pipeline branch. On a
        CUDA card the window is copied to the device once, each step is
        one replay of the key's graph (the key's first run and capture as
        in ``run``) fed by a device-to-device copy of its slice, each
        fetch goes into a slot of a stacked output, and the host waits
        once, at the end (and at a capture). On the CPU it is N op-by-op
        steps. A window is one dispatch for the ``step`` injection point
        and the ``executor.step`` failpoint; the numeric guard's
        per-step verdicts are read once, at the window's end
        (``_run_window``)."""
        program, strategy = self._unwrap(program)
        if any(r._started for r in getattr(program, "_py_readers", ())):
            raise ValueError("run_steps needs explicit stacked feeds, not "
                             "started py_readers")
        scope = scope if scope is not None else global_scope()
        feed = dict(feed or {})
        fetch_names = _fetch_names(fetch_list or [])
        if not feed or not fetch_names:
            raise ValueError("run_steps requires stacked feeds and a "
                             "fetch_list")
        lens = {k: (np.shape(v)[0] if np.ndim(v) else None)
                for k, v in feed.items()}
        if None in lens.values() or len(set(lens.values())) != 1:
            raise ValueError(
                "every run_steps feed needs the same leading steps axis; "
                "got %r" % lens)
        n_steps = next(iter(lens.values()))
        if n_steps == 0:
            raise ValueError("run_steps needs at least one step; the "
                             "stacked feeds have a leading axis of 0")
        resilience.fire("step", what="Executor.run_steps")
        feed = _hit_step_feed(feed)
        t0 = time.perf_counter()
        with obs.span("exec.step", entry="run_steps", steps=n_steps) as sp:
            timeout = self._await_pending(strategy)
            check, policy, budget = _numeric_config(program, strategy)
            plan, kernels = self._compile(program, strategy,
                                          _feed_shapes(feed, 1), fetch_names,
                                          use_program_cache, sp)
            window = {n: v if isinstance(v, torch.Tensor) else
                      torch.from_numpy(np.ascontiguousarray(np.asarray(v)))
                      for n, v in feed.items()}
            dtypes = {n: d for n, (_, d) in self._feed_tensors(
                program, {n: w[0] for n, w in window.items()},
                plan).items()}
            window = {n: window[n].to(device=self.device, dtype=d)
                      for n, d in dtypes.items()}
            captures = self.graph_runs["capture"]
            t1 = time.perf_counter()
            with obs.span("exec.execute"), kernel_dispatch.scope(kernels):
                stacked = self._run_window(
                    program, plan, window, dtypes, fetch_names, scope,
                    self._graphed(plan, fetch_names, use_program_cache),
                    policy if check else None, budget, n_steps, timeout,
                    return_numpy, kernels)
            resilience.observe_executor_step("execute",
                                             time.perf_counter() - t1)
            self._note_capture(captures, sp)
            t1 = time.perf_counter()
            with obs.span("exec.writeback"):
                out = [to_numpy(s) for s in stacked] if return_numpy \
                    else stacked
            resilience.observe_executor_step("writeback",
                                             time.perf_counter() - t1)
        resilience.observe_executor_step("total", time.perf_counter() - t0)
        watchdog.observe_step_latency((time.perf_counter() - t0) / n_steps,
                                      what="Executor.run_steps")
        return out

    # -- a step, a window, the guard's verdicts and the watchdog ---------
    def _unwrap(self, program):
        """(Program, CompiledProgram or None); a CompiledProgram is
        checked against this Executor's device first."""
        from .compiler import CompiledProgram
        if isinstance(program, CompiledProgram):
            program.compile_plan(self.device)
            return program._program, program
        return (program if program is not None else default_main_program(),
                None)

    def _guard_for(self, key, policy, plan):
        guard = self._guards.get(key)
        if guard is None:
            guard = self._guards[key] = StepGuard(self.device, policy,
                                                  plan.writes)
        return guard

    def _step(self, program, plan, feeds, fetch_names, scope, graphed,
              policy, fresh, copy, kernels=None):
        """One step, graphed or op by op: (fetch tensors, its StepGuard
        or None). ``policy``: the numeric guard's (None: no guard);
        ``fresh``: clear the guard's sticky flag first; ``kernels``: the
        compile's kernel dispatch config (part of a graph's key)."""
        if graphed:
            return self._run_graphed(program, plan, feeds, fetch_names,
                                     scope, copy, policy, fresh, kernels)
        guard = None
        if policy is not None:
            guard = self._guard_for((plan.key, policy), policy, plan)
            if fresh:
                guard.reset()
        return self._run_ops(program, plan, feeds, fetch_names, scope,
                             guard=guard), guard

    def _run_window(self, program, plan, window, dtypes, fetch_names, scope,
                    graphed, policy, budget, n_steps, timeout, sync,
                    kernels=None):
        """The steps of a ``run_steps`` window: the fetches stacked.

        With the numeric guard each step's flags go into a row of a
        stacked buffer and the host reads them once, at the end. Under
        "skip" a poisoned step k is reverted on the device and so is
        every later step of the window (the sticky flag); the run counter
        goes back to step k's, so the window's remaining batches run
        again from step k + 1 with the draws the JAX package's reverted
        counter gives them (step k + 1 draws what step k drew). "raise"
        and "rewind" raise at the first poisoned step, naming its
        ``window_offset``, with the window's final state written back,
        as paddle_tpu's scan does."""
        stacked = rows = None
        start = 0
        while True:
            salt0 = scope.find_var(_SALT_VAR) or 0
            guard = None
            for i in range(start, n_steps):
                feeds = {n: (w[i], dtypes[n]) for n, w in window.items()}
                outs, guard = self._step(program, plan, feeds, fetch_names,
                                         scope, graphed, policy,
                                         fresh=i == start, copy=False,
                                         kernels=kernels)
                if stacked is None:
                    stacked = [torch.empty((n_steps,) + tuple(o.shape),
                                           dtype=o.dtype, device=o.device)
                               for o in outs]
                for s, o in zip(stacked, outs):
                    s[i].copy_(o)
                if guard is not None:
                    if rows is None:
                        rows = torch.zeros((n_steps, guard.flags.numel()),
                                           dtype=torch.uint8,
                                           device=guard.flags.device)
                    rows[i].copy_(guard.flags)
            self._after_dispatch(timeout, sync or guard is not None,
                                 "Executor.run_steps window")
            if guard is None:
                return stacked
            got = rows.cpu().numpy()
            m = len(guard.names)
            bad = [i for i in range(start, n_steps) if got[i][m]]
            if not bad:
                if policy == "skip" and start < n_steps:
                    self._numeric_skips = 0
                return stacked
            k = bad[0]
            culprit = guard.offender(got[k])
            resilience.record_event(
                "numeric_fault", policy=policy, step=k,
                **({} if culprit is None else {"culprit": culprit}))
            tail = "" if culprit is None \
                else " (first offender: %r)" % culprit
            if policy == "skip":
                self._numeric_skips = 1 if k > start \
                    else self._numeric_skips + 1
                if self._numeric_skips > budget:
                    raise resilience.SkipBudgetExceededError(
                        "numeric_policy='skip' discarded %d consecutive "
                        "steps (budget %d) inside one run_steps window%s"
                        % (self._numeric_skips, budget, tail),
                        step=k, culprit=culprit, window_offset=k)
                scope.set_var(_SALT_VAR, salt0 + (k - start))
                start = k + 1
                if start == n_steps:
                    return stacked
                continue
            if policy == "rewind":
                raise resilience.NumericFaultError(
                    "numeric fault: non-finite value first detected at "
                    "step %d of this run_steps window%s — rewinding with "
                    "the poison batch skipped on replay" % (k, tail),
                    step=k, culprit=culprit, window_offset=k)
            raise FloatingPointError(
                "check_numerics: non-finite value (NaN/Inf) first "
                "detected at step %d of this run_steps window%s"
                % (k, tail))

    def _settle_run(self, guard, row, policy, budget, scope, salt,
                    uses_rng):
        """A run's numeric verdict (paddle_tpu's ``_numeric_fault``):
        nothing on a clean step (which ends a skip streak); else a
        ``numeric_fault`` event naming the first offender and the
        policy's tail. "skip": the device already reverted the state and
        the run counter steps back, so the next run draws this one's
        numbers; past the budget, SkipBudgetExceededError. "rewind" /
        "raise": the poisoned state is in the scope already;
        NumericFaultError / FloatingPointError. The event's ``step`` is
        the run counter after the step, for a program with random ops."""
        m = len(guard.names)
        if not row[m]:
            if policy == "skip":
                self._numeric_skips = 0
            return
        culprit = guard.offender(row)
        if policy == "skip":
            scope.set_var(_SALT_VAR, salt)
        step_no = (salt if policy == "skip" else salt + 1) if uses_rng \
            else None
        evt = {"policy": policy}
        if culprit is not None:
            evt["culprit"] = culprit
        if step_no is not None:
            evt["step"] = step_no
        resilience.record_event("numeric_fault", **evt)
        where = "var %r" % culprit if culprit is not None \
            else "fetches or updated state"
        if policy == "skip":
            self._numeric_skips += 1
            if self._numeric_skips > budget:
                raise resilience.SkipBudgetExceededError(
                    "numeric_policy='skip' discarded %d consecutive "
                    "steps (budget %d); last offender: %s — the fault "
                    "is persistent, not a poison batch"
                    % (self._numeric_skips, budget, where),
                    step=step_no, culprit=culprit)
            return
        if policy == "rewind":
            raise resilience.NumericFaultError(
                "numeric fault: non-finite value (NaN/Inf) in %s of "
                "this step — rewinding to the last checkpoint with the "
                "poison batch skipped on replay" % where,
                step=step_no, culprit=culprit)
        raise FloatingPointError(
            "check_numerics: non-finite value (NaN/Inf) detected in "
            "%s of this step (reference parity: check_nan_inf)" % where)

    def _await_pending(self, strategy):
        """A CompiledProgram's collective_timeout_s (None: no guard), after
        a bounded wait for the previous dispatch that nothing waited for
        (one step late, as paddle_tpu's compiled step waits)."""
        timeout = None if strategy is None else getattr(
            strategy._build_strategy, "collective_timeout_s", None)
        ev, self._pending = self._pending, None
        if timeout is not None and ev is not None:
            watchdog.wait_with_timeout(ev, timeout,
                                       what="the previous step")
        return timeout

    def _after_dispatch(self, timeout, sync, what):
        """With a timeout armed on the card: the dispatch's end, as a CUDA
        event on the caller's stream; waited for now, bounded, when this
        call syncs anyway (``sync``: fetches to numpy, the guard's
        verdict), else at the next call's entry. No timeout: nothing, and
        no sync is added."""
        if timeout is None or self.device.type != "cuda":
            return
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        if sync:
            watchdog.wait_with_timeout(ev, timeout, what=what)
        else:
            self._pending = ev

    def _context(self, program, plan, salt, graphable, capturing=False):
        if plan.rng is not None and not capturing:
            plan.rng.seat(salt)
        return RunContext(self.device, program, salt, plan.rng,
                          plan.constants if graphable else None, capturing,
                          keyed=plan.uses_rng)

    def _run_ops(self, program, plan, feeds, fetch_names, scope,
                 graphable=False, guard=None):
        """One op-by-op run: the scope's persistables and the feeds in,
        the persistables back to the scope; returns the fetch tensors.
        ``guard``: the step's StepGuard (save, check, and under "skip" the
        revert on the host, which rebinds the written names to their
        copies, so a fetch keeps the step's value)."""
        env = {}
        for n in plan.persistable:
            v = scope.find_var(n)
            if v is not None:
                env[n] = v.to(self.device)
        env.update({n: t.to(device=self.device, dtype=d)
                    for n, (t, d) in feeds.items()})
        ctx = self._context(program, plan, _next_salt(scope), graphable)
        saved = guard.save(env) if guard is not None else None
        with torch.no_grad():
            run_block(program.global_block(), env, ctx, plan.want,
                      plan.last_grad, plan.drop, plan.keep)
        fetches = _fetch(env, fetch_names)
        if guard is not None:
            guard.settle(_checked(fetch_names, fetches, [
                (n, env[n]) for n in plan.persistable
                if n in env and n not in feeds]), env, saved)
        for n in plan.persistable:
            if n in env:
                scope.set_var(n, env[n])
        return fetches

    def _run_graphed(self, program, plan, feeds, fetch_names, scope, copy,
                     policy=None, fresh=True, kernels=None):
        """A run of a CUDA key on the Executor's stream: op by op the first
        time, captured and replayed the second, replayed after. ``copy``:
        return clones of a replay's outputs, and of a first run's fetched
        persistables (the next replay overwrites them). ``policy``: the
        numeric guard's (part of the key), and ``fresh``: clear its sticky
        flag first. Returns (outputs, the key's StepGuard or None)."""
        state = [(n, v) for n in plan.persistable
                 for v in (scope.find_var(n),) if v is not None]
        key = _graph_key(plan, feeds, state, scope, policy, kernels)
        guard = None if policy is None else self._guard_for(key, policy,
                                                            plan)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        caller = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(caller)
        with torch.cuda.stream(self._stream):
            if guard is not None and fresh:
                guard.reset()
            step = self._graphs.get(key)
            if step is None and key not in self._warm:
                out = self._run_ops(program, plan, feeds, fetch_names,
                                    scope, graphable=True, guard=guard)
                if copy:
                    # a fetched persistable is the scope's tensor, which
                    # the key's capture takes as a static input and every
                    # replay overwrites
                    held = {id(scope.find_var(n)) for n in plan.persistable}
                    out = [t.clone() if id(t) in held else t for t in out]
                self._warm.add(key)
                self.graph_runs["warm"] += 1
            else:
                salt = _next_salt(scope)
                if step is None:
                    w0, t0 = obs.now(), time.perf_counter()
                    step = self._capture(program, plan, feeds, fetch_names,
                                         scope, state, salt, guard)
                    self._last_capture = (w0, obs.now(),
                                          time.perf_counter() - t0)
                    self._graphs[key] = step
                    self.graph_runs["capture"] += 1
                else:
                    step.load(feeds, scope)
                    self.graph_runs["replay"] += 1
                plan.rng.seat(salt)
                step.replay()
                out = [t.clone() for t in step.outputs] if copy \
                    else step.outputs
        caller.wait_stream(self._stream)
        return out, guard

    def _capture(self, program, plan, feeds, fetch_names, scope, state,
                 salt, guard=None):
        """The key's step captured into a CompiledStep (not replayed yet),
        its feeds loaded. With a ``guard``, the captured step begins with
        its backup (under "skip") and ends with its finite check and gated
        revert."""
        static = {}
        for n, v in state:
            if v.device != self.device:
                v = v.to(self.device)
                scope.set_var(n, v)
            static[n] = v
        step = CompiledStep(self.device, static, {
            n: (tuple(t.shape), d) for n, (t, d) in feeds.items()})
        step.load(feeds, scope)
        ctx = self._context(program, plan, salt, True, capturing=True)

        def run(env):
            if guard is not None:
                guard.save_static(static)
            with torch.no_grad():
                run_block(program.global_block(), env, ctx, plan.want,
                          plan.last_grad, plan.drop, plan.keep)
            stray = [n for n in plan.persistable
                     if n in env and n not in static]
            if stray:
                raise RuntimeError(
                    "the step writes persistables the scope had no value "
                    "for when it was captured: %s" % stray[:5])

        def fetch(env):
            outs = _fetch(env, fetch_names, static)
            if guard is None:
                return outs
            # a fetched persistable shows the step's value, not a revert
            outs = [o.clone() if n in static else o
                    for n, o in zip(fetch_names, outs)]
            guard.check(_checked(fetch_names, outs, [
                (n, v) for n, v in static.items() if n not in feeds]))
            guard.restore_static(static)
            return outs

        if guard is not None:
            guard.reserve(static)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        try:
            step.capture(run, fetch, plan.rng.generators(), self._pool)
        except Exception as e:
            op = ctx.op
            raise GraphCaptureError(
                "capturing the step of program %d failed at op {%s} (%s): "
                "%s: %s" % (id(program), op.type if op is not None else
                            "none", ctx._op_pos, type(e).__name__, e)) from e
        if guard is not None:
            guard.flush()
        self.capture_log.append({
            "feeds": {n: list(t.shape) for n, (t, _) in feeds.items()},
            "capture_ms": step.capture_ms, "pool_bytes": step.pool_bytes,
            "launches": step.launches,
            "guard": None if guard is None else guard.policy,
            "guard_bytes": 0 if guard is None else guard.pool_bytes})
        return step


def run_block(block, env, ctx, want=None, last_grad=None, drop=None,
              keep=None):
    """Run ``block``'s ops in order on ``env`` ({var name: tensor}).

    ``want``/``last_grad`` (``trace.wanted_grads``) pair each forward op
    a ``grad_of`` names with that ``grad_of``; ``keep``
    (``trace.overwritten_inputs``) names the inputs a record copies
    because a later op overwrites them in place; ``drop`` ({op index: var
    names}) frees values after their last reader. Under ``no_grad`` (the
    Executor's step, a segment's forward) an output that carries an
    autograd graph is stored detached: the graph stays with its record.
    Under ``enable_grad`` (a recomputed segment) outputs keep theirs."""
    want = want or {}
    records = {}
    for i, op in enumerate(block.ops):
        ctx.begin_op(block.idx, i, op)
        if op.type == GRAD_OP_TYPE:
            outs = trace.run_grad_op(op, env, records, ctx,
                                     last_grad[op.attrs["fwd_id"]] == i)
        else:
            outs = _run_fwd_op(op, env, ctx, want, records, keep)
        _bind(op, outs, env)
        for n in (drop or {}).get(i, ()):
            env.pop(n, None)


def _run_fwd_op(op, env, ctx, want, records, keep=None):
    ins = {}
    for slot, names in op.inputs.items():
        vals = []
        for n in names:
            if n == EMPTY_VAR:
                continue
            if n not in env:
                raise KeyError(
                    "op {%s} needs input var %r which has no value; it "
                    "was neither fed, nor in scope, nor produced by an "
                    "earlier op" % (op.type, n))
            vals.append(env[n])
        ins[slot] = vals
    opdef = get_op(op.type)
    if op.desc_id in want and opdef.differentiable:
        outs, records[op.desc_id] = trace.run_recorded(
            opdef, ins, op.attrs, ctx, want[op.desc_id],
            (keep or {}).get(op.desc_id))
        return outs
    return opdef.fn(ctx, ins, op.attrs)


def _bind(op, outs, env):
    detach = not torch.is_grad_enabled()
    for slot, names in op.outputs.items():
        vals = outs.get(slot)
        if vals is None:
            continue
        if not isinstance(vals, (list, tuple)):
            vals = [vals]
        if len(vals) != len(names):
            raise RuntimeError("op {%s} slot %r produced %d values for "
                               "%d vars" % (op.type, slot, len(vals),
                                            len(names)))
        for name, val in zip(names, vals):
            if name != EMPTY_VAR:
                env[name] = val.detach() if detach and val.requires_grad \
                    else val


__all__ = ["Executor", "GraphCaptureError", "RunContext", "run_block",
           "set_precision"]
