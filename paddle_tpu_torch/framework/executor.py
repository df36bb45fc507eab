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
kernel does). What a run derives from the program alone (the check that
every op is ported, the forward/grad pairing, each value's last reader,
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
``run_steps`` runs a window of steps from stacked feeds with one host
sync, at its end. ``close()`` drops the graphs and their memory pool.

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
"""
import hashlib

import numpy as np
import torch

from ..ops.registry import NotPortedError, get_op, has_op
from . import trace
from .compiled_step import CompiledStep, GraphCaptureError
from .dtypes import to_torch_dtype
from .place import _current_expected_place
from .program import default_main_program
from .scope import global_scope, to_numpy
from .trace import EMPTY_VAR, GRAD_OP_TYPE

_SALT_VAR = "@EAGER_SALT@"


def set_precision():
    """Full-f32 math on the card: no TF32 in matmuls or convolutions, and
    bf16 matmuls sum in f32 to the end (no split-K partial sums rounded
    to bf16). cuDNN picks deterministic convolution algorithms by its
    heuristics, never by timing (a filter gradient summed with atomics
    would make two runs of a step, or a replay and an op-by-op run,
    differ in their last bits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def _next_salt(scope):
    """The scope's run counter: this run's value, advanced by one."""
    salt = scope.find_var(_SALT_VAR) or 0
    scope.set_var(_SALT_VAR, salt + 1)
    return salt


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
    is restored."""

    def __init__(self, device, random_seed):
        self._device = device
        self._random_seed = random_seed
        self._gens = {}           # (position, n) -> (generator, seed attr)
        self._salt = 0

    def generators(self):
        return [g for g, _ in self._gens.values()]

    def seat(self, salt):
        self._salt = salt
        for (pos, _), (g, attr_seed) in self._gens.items():
            g.manual_seed(_draw_seed(attr_seed, self._random_seed, salt,
                                     pos))

    def get(self, pos, n, attr_seed, capturing):
        entry = self._gens.get((pos, n))
        if entry is None:
            if capturing:
                raise RuntimeError(
                    "the op at %s draws from a generator its warm run did "
                    "not make" % pos)
            g = torch.Generator(device=self._device)
            g.manual_seed(_draw_seed(attr_seed, self._random_seed,
                                     self._salt, pos))
            entry = self._gens[(pos, n)] = (g, attr_seed)
        return entry[0]


class RunContext(object):
    """What an op kernel sees as ``ctx``: the device, the program (a
    block-running op finds its sub-block there), seeded generators for
    random ops, constants made once per plan and ``run_block`` for a
    sub-block's ops."""

    def __init__(self, device, program, salt, rng=None, constants=None,
                 capturing=False):
        self.device = device
        self.program = program
        self.op = None
        self._salt = salt
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

    def generator(self, attrs):
        """A seeded torch.Generator on the run's device for the current
        op, seeded from the op's ``seed`` attr, else from
        (program.random_seed, run salt, the op's block and position)
        (``_draw_seed``): on a CUDA card the plan's generator of the op's
        position and draw (``_Generators``), on the CPU a new one. Either
        way an op run again in the same run (a recomputed segment) draws
        what it drew the first time."""
        seed = attrs.get("seed", 0)
        if self._rng is not None:
            n = self._draws.get(self._op_pos, 0)
            self._draws[self._op_pos] = n + 1
            return self._rng.get(self._op_pos, n, seed, self._capturing)
        g = torch.Generator(device=self.device)
        g.manual_seed(_draw_seed(seed, self.program.random_seed, self._salt,
                                 self._op_pos))
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
                 "drop", "rng", "constants", "reads")

    def __init__(self, key, program, fetch_names, device):
        _check_runnable(program)
        blk = program.global_block()
        self.key = key
        self.program = program
        self.persistable = sorted({v.name for v in program.list_vars()
                                   if v.persistable})
        self.want, self.last_grad = trace.wanted_grads(blk)
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


def _graph_key(plan, feeds, state, scope):
    """The key of a CUDA run's captured step: the plan's key, each feed's
    name, shape and dtype, each state tensor's name, shape and dtype, and
    the scope. A persistable of a new shape is a new key (its first run
    goes op by op, as ``jax.jit`` traces again on a new shape), never a
    copy into the captured shape."""
    return (plan.key, tuple(sorted((n, tuple(t.shape), d)
                                   for n, (t, d) in feeds.items())),
            tuple((n, tuple(v.shape), v.dtype) for n, v in state), id(scope))


class Executor(object):
    """``Executor(place=None)``: place defaults to CUDAPlace(0) and raises
    NoCUDADeviceError without a CUDA device; pass CPUPlace() to run on the
    CPU. ``capture_log`` lists each capture: its feeds' shapes, its
    time, the memory the pool grew by, and the launches of each kernel
    a replay is credited (in ``ops.kernels.LAUNCH_COUNTERS`` order).
    ``graph_runs`` counts the runs of CUDA keys: ``warm`` (a key's first
    run, op by op), ``capture`` (its second, captured and replayed) and
    ``replay``."""

    def __init__(self, place=None):
        self.place = place if place is not None else _current_expected_place()
        self.device = self.place.torch_device()
        self._plans = {}
        self._graphs = {}
        self._warm = set()
        self._pool = None
        self._stream = None
        self.capture_log = []
        self.graph_runs = {"warm": 0, "capture": 0, "replay": 0}
        set_precision()

    def close(self):
        """Drop the captured graphs, their memory pool and the plans (the
        counterpart of paddle_tpu's ``Executor.close``); the scope keeps
        its tensors."""
        self._graphs.clear()
        self._warm.clear()
        self._plans.clear()
        self._pool = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def _plan(self, program, fetch_names, use_program_cache):
        # the key holds the var count too: creating a var bumps no version
        key = (id(program), program._version,
               sum(len(b.vars) for b in program.blocks), tuple(fetch_names),
               program.random_seed)
        plan = self._plans.get(key) if use_program_cache else None
        if plan is None or plan.program is not program:
            plan = _RunPlan(key, program, fetch_names, self.device)
            if use_program_cache:
                self._plans[key] = plan
        return plan

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
            if var is not None and var.shape is not None:
                want, got = var.shape, tuple(t.shape)
                if len(want) != len(got):
                    raise ValueError(
                        "feed %r has rank %d (shape %s) but the program "
                        "declares rank %d (shape %s)"
                        % (name, len(got), got, len(want), tuple(want)))
                for w, g in zip(want, got):
                    if w not in (-1, g):
                        raise ValueError(
                            "feed %r shape %s incompatible with declared %s"
                            % (name, got, tuple(want)))
            out[name] = (t, to_torch_dtype(var.dtype) if var is not None
                         else t.dtype)
        return out

    def _graphed(self, fetch_names, use_program_cache):
        return bool(fetch_names) and use_program_cache and \
            self.device.type == "cuda"

    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name=None, fetch_var_name=None, scope=None,
            return_numpy=True, use_program_cache=True):
        """One step of ``program``. A started py_reader of the program
        (``layers.py_reader``) feeds its variables unless ``feed`` names
        them; an exhausted one raises ``layers.EOFException``."""
        program = program if program is not None else default_main_program()
        scope = scope if scope is not None else global_scope()
        feed = _pull_readers(program, dict(feed or {}))
        fetch_names = _fetch_names(fetch_list or [])
        plan = self._plan(program, fetch_names, use_program_cache)
        feeds = self._feed_tensors(program, feed, plan)
        if self._graphed(fetch_names, use_program_cache):
            fetches = self._run_graphed(program, plan, feeds, fetch_names,
                                        scope, copy=not return_numpy)
        else:
            fetches = self._run_ops(program, plan, feeds, fetch_names,
                                    scope)
        if return_numpy:
            return [to_numpy(t) for t in fetches]
        return fetches

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

    def run_steps(self, program=None, feed=None, fetch_list=None,
                  scope=None, return_numpy=True, use_program_cache=True):
        """Run N consecutive steps of ``program``: ``feed`` maps each feed
        name to an array with a leading steps axis, and step i consumes
        ``feed[name][i]``. Returns the fetches of every step, stacked on a
        leading axis of length N; step i draws what the i-th of N ``run``
        calls would draw, and the state moves as N runs move it.

        Counterpart of paddle_tpu's ``Executor.run_steps`` (one
        ``lax.scan`` device program) without its pipeline and
        ``CompiledProgram`` branches. On a CUDA card the window is copied
        to the device once, each step is one replay of the key's graph
        (the key's first run and capture as in ``run``) fed by a
        device-to-device copy of its slice, each fetch goes into a slot
        of a stacked output, and the host waits once, at the end (and at
        a capture). On the CPU it is N op-by-op steps."""
        program = program if program is not None else default_main_program()
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
        plan = self._plan(program, fetch_names, use_program_cache)
        window = {n: v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(np.asarray(v))) for n, v in feed.items()}
        dtypes = {n: d for n, (_, d) in self._feed_tensors(
            program, {n: w[0] for n, w in window.items()}, plan).items()}
        window = {n: window[n].to(device=self.device, dtype=d)
                  for n, d in dtypes.items()}
        graphed = self._graphed(fetch_names, use_program_cache)
        stacked = None
        for i in range(n_steps):
            feeds = {n: (w[i], dtypes[n]) for n, w in window.items()}
            if graphed:
                outs = self._run_graphed(program, plan, feeds, fetch_names,
                                         scope, copy=False)
            else:
                outs = self._run_ops(program, plan, feeds, fetch_names,
                                     scope)
            if stacked is None:
                stacked = [torch.empty((n_steps,) + tuple(o.shape),
                                       dtype=o.dtype, device=o.device)
                           for o in outs]
            for s, o in zip(stacked, outs):
                s[i].copy_(o)
        if return_numpy:
            return [to_numpy(s) for s in stacked]
        return stacked

    def _context(self, program, plan, salt, graphable, capturing=False):
        if plan.rng is not None and not capturing:
            plan.rng.seat(salt)
        return RunContext(self.device, program, salt, plan.rng,
                          plan.constants if graphable else None, capturing)

    def _run_ops(self, program, plan, feeds, fetch_names, scope,
                 graphable=False):
        """One op-by-op run: the scope's persistables and the feeds in,
        the persistables back to the scope; returns the fetch tensors."""
        env = {}
        for n in plan.persistable:
            v = scope.find_var(n)
            if v is not None:
                env[n] = v.to(self.device)
        env.update({n: t.to(device=self.device, dtype=d)
                    for n, (t, d) in feeds.items()})
        ctx = self._context(program, plan, _next_salt(scope), graphable)
        with torch.no_grad():
            run_block(program.global_block(), env, ctx, plan.want,
                      plan.last_grad, plan.drop)
        for n in plan.persistable:
            if n in env:
                scope.set_var(n, env[n])
        return _fetch(env, fetch_names)

    def _run_graphed(self, program, plan, feeds, fetch_names, scope, copy):
        """A run of a CUDA key on the Executor's stream: op by op the first
        time, captured and replayed the second, replayed after. ``copy``:
        return clones of a replay's outputs (the next replay overwrites
        them)."""
        state = [(n, v) for n in plan.persistable
                 for v in (scope.find_var(n),) if v is not None]
        key = _graph_key(plan, feeds, state, scope)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        caller = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(caller)
        with torch.cuda.stream(self._stream):
            step = self._graphs.get(key)
            if step is None and key not in self._warm:
                out = self._run_ops(program, plan, feeds, fetch_names,
                                    scope, graphable=True)
                self._warm.add(key)
                self.graph_runs["warm"] += 1
            else:
                salt = _next_salt(scope)
                if step is None:
                    step = self._capture(program, plan, feeds, fetch_names,
                                         scope, state, salt)
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
        return out

    def _capture(self, program, plan, feeds, fetch_names, scope, state,
                 salt):
        """The key's step captured into a CompiledStep (not replayed yet),
        its feeds loaded."""
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
            with torch.no_grad():
                run_block(program.global_block(), env, ctx, plan.want,
                          plan.last_grad, plan.drop)
            stray = [n for n in plan.persistable
                     if n in env and n not in static]
            if stray:
                raise RuntimeError(
                    "the step writes persistables the scope had no value "
                    "for when it was captured: %s" % stray[:5])

        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        try:
            step.capture(run, lambda env: _fetch(env, fetch_names, static),
                         plan.rng.generators(), self._pool)
        except Exception as e:
            op = ctx.op
            raise GraphCaptureError(
                "capturing the step of program %d failed at op {%s} (%s): "
                "%s: %s" % (id(program), op.type if op is not None else
                            "none", ctx._op_pos, type(e).__name__, e)) from e
        self.capture_log.append({
            "feeds": {n: list(t.shape) for n, (t, _) in feeds.items()},
            "capture_ms": step.capture_ms, "pool_bytes": step.pool_bytes,
            "launches": step.launches})
        return step


def run_block(block, env, ctx, want=None, last_grad=None, drop=None):
    """Run ``block``'s ops in order on ``env`` ({var name: tensor}).

    ``want``/``last_grad`` (``trace.wanted_grads``) pair each forward op
    a ``grad_of`` names with that ``grad_of``; ``drop`` ({op index: var
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
            outs = _run_fwd_op(op, env, ctx, want, records)
        _bind(op, outs, env)
        for n in (drop or {}).get(i, ()):
            env.pop(n, None)


def _run_fwd_op(op, env, ctx, want, records):
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
            opdef, ins, op.attrs, ctx, want[op.desc_id])
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
