"""Program IR verifier: analysis passes over Program/Block/Op.

Counterpart of paddle_tpu/framework/analysis.py. The reference lowers
every Program through its framework/ir graph-pass layer (Pass /
PassRegistry and each op's InferShape) before execution; here a pass
manager walks the Program (the op registry's shape rules and the
VarDesc metadata only: no torch call, no device) and emits structured
:class:`ProgramDiagnostic`s, reporting every violation in one shot.

Passes (PASS_NAMES order):
  def_use    — def-before-use / dangling reads + op_role section
               ordering (forward < backward < optimize)
  shape_dtype— static shape/dtype propagation through the registry's
               shape rules (ops/shape_rules.py; unknown ops infer top
               and never false-positive)
  sharding   — dp-divisibility of feed batch dims against the declared
               mesh, quantize_collectives' pure-dp requirement, mp-axis
               divisibility of annotated vars
  dce        — dead-op report against fetch-list + optimizer-update +
               collective liveness roots

``PASS_PIPELINE`` is a name the allowlist accepts, as in the JAX
package, but no pass runs under it yet: pipeline programs arrive with
the multi-GPU slice, and ``CompiledProgram.compile_plan`` refuses a
pipeline strategy before the verifier runs.

Wiring: ``BuildStrategy.verify_program = "strict"|"warn"|"off"``
(default from PADDLE_TPU_VERIFY, else "warn") runs :func:`verify_program`
through ``compiler.verify_for_compile`` at ``compile_plan`` and at the
Executor's compile-cache misses; ``ServingPredictor`` refuses a corrupt
shipped program at load. Diagnostics feed the resilience metrics as
``analysis_diagnostics_total{pass,severity}`` plus a
``program_analysis`` event (:func:`report`).
"""
import collections

from .program import Program
# the tracer's own sentinels: the verifier models trace.py, so it shares
# them rather than re-declaring
from .trace import EMPTY_VAR, GRAD_OP_TYPE

# the JAX package's step counter (a persistable its Executor adds to the
# state); a program that reads it reads a value the run provides
STEP_VAR = "@STEP_COUNTER@"

SEVERITIES = ("info", "warning", "error")
_SEV_RANK = {s: i for i, s in enumerate(SEVERITIES)}

PASS_DEF_USE = "def_use"
PASS_SHAPE = "shape_dtype"
PASS_SHARDING = "sharding"
PASS_PIPELINE = "pipeline"
PASS_DCE = "dce"
PASS_NAMES = (PASS_DEF_USE, PASS_SHAPE, PASS_SHARDING, PASS_PIPELINE,
              PASS_DCE)

# ops that are live roots regardless of dataflow (their effect is the
# collective / the persistable write, not a read of their outputs)
_SIDE_EFFECT_OPS = frozenset({"barrier", "ppermute", "c_sync_comm_stream"})


def _is_side_effect_op(op):
    return op.type in _SIDE_EFFECT_OPS or op.type.startswith("c_")


class ProgramDiagnostic(object):
    """One structured verifier finding.

    severity   -- "info" | "warning" | "error"
    pass_name  -- the analysis pass that produced it (PASS_NAMES)
    block_idx / op_idx / op_type -- program location (op_idx None for
                  program-level findings like a bad mesh)
    vars       -- tuple of involved var names
    message    -- what is wrong
    hint       -- how to fix it (may be "")
    """

    __slots__ = ("severity", "pass_name", "block_idx", "op_idx",
                 "op_type", "vars", "message", "hint")

    def __init__(self, severity, pass_name, message, block_idx=0,
                 op_idx=None, op_type=None, vars=(), hint=""):
        assert severity in SEVERITIES, severity
        self.severity = severity
        self.pass_name = pass_name
        self.block_idx = block_idx
        self.op_idx = op_idx
        self.op_type = op_type
        self.vars = tuple(vars)
        self.message = message
        self.hint = hint

    def location(self):
        loc = "block%d" % self.block_idx
        if self.op_idx is not None:
            loc += ":op%d" % self.op_idx
        if self.op_type:
            loc += "{%s}" % self.op_type
        return loc

    def to_dict(self):
        return {"severity": self.severity, "pass": self.pass_name,
                "block": self.block_idx, "op": self.op_idx,
                "op_type": self.op_type, "vars": list(self.vars),
                "message": self.message, "hint": self.hint}

    def __str__(self):
        s = "[%s] %s %s: %s" % (self.severity, self.pass_name,
                                self.location(), self.message)
        if self.vars:
            s += " (vars: %s)" % ", ".join(self.vars)
        if self.hint:
            s += " — " + self.hint
        return s

    __repr__ = __str__


class AnalysisResult(object):
    """All diagnostics of one verifier run, queryable by severity."""

    def __init__(self, diagnostics=()):
        self.diagnostics = list(diagnostics)

    def __iter__(self):
        return iter(self.diagnostics)

    def __len__(self):
        return len(self.diagnostics)

    def by_severity(self, severity):
        return [d for d in self.diagnostics if d.severity == severity]

    def errors(self):
        return self.by_severity("error")

    def warnings(self):
        return self.by_severity("warning")

    def infos(self):
        return self.by_severity("info")

    def max_severity(self):
        """Highest severity present, or None for a clean program."""
        if not self.diagnostics:
            return None
        return max((d.severity for d in self.diagnostics),
                   key=_SEV_RANK.__getitem__)

    def exit_code(self):
        """A checker's exit code: 0 clean/info, 1 warnings, 2 errors."""
        sev = self.max_severity()
        return {None: 0, "info": 0, "warning": 1, "error": 2}[sev]

    def counts(self):
        c = collections.Counter(d.severity for d in self.diagnostics)
        return {s: c.get(s, 0) for s in SEVERITIES}

    def summary(self):
        c = self.counts()
        head = "program verification: %d error(s), %d warning(s), " \
            "%d info" % (c["error"], c["warning"], c["info"])
        return "\n".join([head] + [str(d) for d in self.diagnostics])

    def to_dict(self):
        return {"counts": self.counts(),
                "diagnostics": [d.to_dict() for d in self.diagnostics]}


class ProgramVerificationError(ValueError):
    """Strict-mode failure: carries the FULL diagnostics list, so a bad
    program reads as located findings instead of one stack trace."""

    def __init__(self, result):
        self.result = result
        super(ProgramVerificationError, self).__init__(result.summary())


def allowlist(program, *pass_names, **kw):
    """Suppress the named passes' diagnostics for ``program`` — the
    explicit escape hatch for a vetted exception. Always pair the call
    with a comment explaining WHY the program is allowed to fail the
    pass. ``reason=`` is kept for introspection."""
    reason = kw.pop("reason", "")
    if kw:
        raise TypeError("unexpected kwargs %r" % sorted(kw))
    current = dict(getattr(program, "_analysis_allowlist", {}))
    for name in pass_names:
        if name not in PASS_NAMES:
            raise ValueError("unknown analysis pass %r (have %r)"
                             % (name, PASS_NAMES))
        current[name] = reason
    program._analysis_allowlist = current
    # drop memoized verdicts: an allowlist applied AFTER a program's
    # first compile must take effect on the next one, not only after
    # the program version happens to bump
    program._verify_cache = {}
    return program


# ---------------------------------------------------------------------------
# pass manager
# ---------------------------------------------------------------------------

_PASSES = []


def analysis_pass(name):
    """Register fn(ctx) -> iterable of ProgramDiagnostic under `name`."""
    def deco(fn):
        _PASSES.append((name, fn))
        return fn
    return deco


def registered_passes():
    return [name for name, _ in _PASSES]


class AnalysisContext(object):
    """Per-run state shared by the passes: the program plus everything
    the call site knows (feed shapes, fetch roots, mesh, strategy)."""

    def __init__(self, program, feeds=None, fetch_names=None,
                 mesh_axes=None, data_axis="dp", build_strategy=None):
        self.program = program
        self.fetch_names = tuple(fetch_names) \
            if fetch_names is not None else None
        self.mesh_axes = dict(mesh_axes) if mesh_axes else None
        self.data_axis = data_axis
        self.bs = build_strategy
        # feeds: {name: shape tuple or None}; None = feed set unknown
        if feeds is None:
            self.feeds = None
        elif isinstance(feeds, dict):
            self.feeds = {str(k): _np_shape(v) for k, v in feeds.items()}
        else:
            self.feeds = {str(k): None for k in feeds}
        blk = program.global_block()
        self.block0 = blk
        self.persistable = {v.name for b in program.blocks
                            for v in b.vars.values() if v.persistable}
        self.data_vars = {v.name for b in program.blocks
                          for v in b.vars.values()
                          if getattr(v, "is_data", False)}
        self.declared = {v.name for b in program.blocks
                         for v in b.vars.values()}
        # name -> index of the FIRST block-0 op producing it
        self.producer_idx = {}
        for i, op in enumerate(blk.ops):
            for n in op.output_names():
                if n != EMPTY_VAR:
                    self.producer_idx.setdefault(n, i)

    def bs_attr(self, name, default=None):
        return getattr(self.bs, name, default) if self.bs is not None \
            else default

    def pp_stages(self):
        k = self.bs_attr("pp_stages")
        if k:
            return int(k)
        if self.mesh_axes and int(self.mesh_axes.get("pp", 1) or 1) > 1:
            return int(self.mesh_axes["pp"])
        return None

    def feed_shape(self, name):
        """Best-known shape of a feed/var: the actual fed shape when the
        call site provided one, else the declared shape (-1 -> None)."""
        if self.feeds is not None and self.feeds.get(name) is not None:
            return self.feeds[name]
        var = self.block0._find_var_recursive(name)
        if var is not None and var.shape is not None:
            return tuple(None if d == -1 else d for d in var.shape)
        return None


def _np_shape(v):
    """Normalize a feed value or shape into a dim tuple (or None)."""
    if v is None:
        return None
    s = getattr(v, "shape", None)
    if s is None:
        s = v    # already a shape-like iterable
    try:
        return tuple(None if d is None or int(d) < 0 else int(d)
                     for d in s)
    except TypeError:
        return None


def verify_program(program, feeds=None, fetch_list=None, mesh_axes=None,
                   data_axis="dp", build_strategy=None, passes=None):
    """Run the analysis passes over ``program``; returns AnalysisResult.

    Pure and side-effect free: no counters, no events, no mutation of
    the program (pass :func:`report` the result to export metrics). The
    verifier never traces — a verify is a linear Python walk, safe to
    keep on by default.

    feeds       -- {name: shape} (the compile seam's actual feed
                   shapes), an iterable of feed names, or None (feed
                   set unknown — availability checks degrade to
                   warnings for declared vars)
    fetch_list  -- fetch names/Variables (the dce pass's liveness
                   roots); None disables the dead-op report
    mesh_axes / data_axis / build_strategy -- the strategy context for
                   the sharding pass
    """
    if build_strategy is not None:
        if mesh_axes is None:
            mesh_axes = getattr(build_strategy, "mesh_axes", None)
        data_axis = getattr(build_strategy, "data_axis", data_axis)
    fetch_names = None
    if fetch_list is not None:
        fetch_names = [getattr(f, "name", f) for f in fetch_list]
    ctx = AnalysisContext(program, feeds=feeds, fetch_names=fetch_names,
                          mesh_axes=mesh_axes, data_axis=data_axis,
                          build_strategy=build_strategy)
    allow = getattr(program, "_analysis_allowlist", {})
    wanted = set(passes) if passes is not None else None
    out = []
    for name, fn in _PASSES:
        if wanted is not None and name not in wanted:
            continue
        if name in allow:
            continue
        try:
            out.extend(fn(ctx))
        except Exception as e:  # a pass bug must never block a compile
            out.append(ProgramDiagnostic(
                "warning", name,
                "analysis pass crashed: %s: %s" % (type(e).__name__, e),
                hint="report this — the pass is skipped, the program "
                     "still compiles"))
    return AnalysisResult(out)


def env_verify_mode():
    """The env-selected verifier mode: PADDLE_TPU_VERIFY = "strict" |
    "warn" | "off" (unset/unknown = "warn"). One parser for every
    consumer — BuildStrategy's default, the serving load gate."""
    import os
    raw = os.environ.get("PADDLE_TPU_VERIFY", "").strip().lower()
    return raw if raw in ("strict", "warn", "off") else "warn"


def verify_model_meta(meta, feeds=None, fetches=None):
    """Verify a serialized program envelope: an exported
    ``__model__.json`` meta (``{"program": ..., "feed_var_names": ...,
    "fetch_var_names": ...}``) or a bare ``Program.to_dict()`` dump.

    One implementation of the envelope contract for every gate
    (``ServingPredictor``'s load, an offline checker), so they cannot
    drift. Raises ValueError
    when the envelope itself is corrupt (as fatal as any error
    diagnostic: the artifact cannot be vetted); returns the
    AnalysisResult otherwise. ``feeds``/``fetches`` override the
    envelope's own lists."""
    if "program" in meta:
        prog_dict = meta["program"]
        if feeds is None:
            feeds = meta.get("feed_var_names")
        if fetches is None:
            fetches = meta.get("fetch_var_names")
    else:
        prog_dict = meta
    try:
        program = Program.from_dict(prog_dict)
    except (ValueError, KeyError, TypeError) as e:
        raise ValueError("corrupt program IR (%s: %s)"
                         % (type(e).__name__, e))
    return verify_program(program, feeds=feeds, fetch_list=fetches)


def report(result, mode="warn", source="compile"):
    """Export one verification's outcome: bump the
    ``analysis_diagnostics_total{pass,severity}`` counters and record a
    ``program_analysis`` event on the resilience surface."""
    from . import resilience
    for d in result:
        resilience.record_analysis(d.pass_name, d.severity)
    c = result.counts()
    resilience.record_event("program_analysis", source=source, mode=mode,
                            errors=c["error"], warnings=c["warning"],
                            infos=c["info"])


# ---------------------------------------------------------------------------
# pass 1: def-use / liveness forward walk + section ordering
# ---------------------------------------------------------------------------

@analysis_pass(PASS_DEF_USE)
def _pass_def_use(ctx):
    out = []
    blk = ctx.block0
    # section ordering: forward < backward < optimize. Info severity:
    # backward-after-optimize is how SUPPORTED patterns look too —
    # pt.gradients() after minimize(), DCGAN's two-optimizer
    # adversarial step — but the report still flags where the sections
    # interleave, because gradients taken there flow through
    # ALREADY-UPDATED params (exactly what an adversarial step wants
    # and an accidental re-minimize does not).
    first_opt = next((i for i, op in enumerate(blk.ops)
                      if op.attrs.get("op_role") == "optimize"), None)
    if first_opt is not None:
        for i in range(first_opt + 1, len(blk.ops)):
            op = blk.ops[i]
            if op.attrs.get("op_role") == "backward":
                out.append(ProgramDiagnostic(
                    "info", PASS_DEF_USE,
                    "backward-role op appears after the optimize section "
                    "began (op %d) — sections interleave (forward < "
                    "backward < optimize); its gradients flow through "
                    "already-updated params" % first_opt,
                    op_idx=i, op_type=op.type,
                    hint="intentional for adversarial/two-optimizer "
                         "steps and gradients()-after-minimize; "
                         "otherwise rebuild via minimize()"))
    if ctx.program.num_blocks > 1:
        # control-flow sub-blocks resolve reads through the parent env
        # at run time — the straight-line walk below would
        # false-positive, so multi-block programs skip it (conservative)
        return out
    available = set(ctx.persistable) | {EMPTY_VAR, STEP_VAR}
    if ctx.feeds is not None:
        available |= set(ctx.feeds)
    else:
        available |= ctx.data_vars
    produced = set()
    for i, op in enumerate(blk.ops):
        for n in op.input_names():
            if n in available or n in produced or n == EMPTY_VAR:
                continue
            later = n in ctx.producer_idx and ctx.producer_idx[n] >= i
            feedable = ctx.feeds is None and n in ctx.declared
            if later:
                if feedable:
                    sev, what = "warning", \
                        "read before its producer (op %d) and not known " \
                        "to be fed" % ctx.producer_idx[n]
                else:
                    sev, what = "error", \
                        "read before its producer (op %d)" \
                        % ctx.producer_idx[n]
                hint = "move the producer above, or feed the var"
            elif n in ctx.declared:
                sev = "error" if ctx.feeds is not None else "warning"
                what = "is never produced, fed, or persistable — the " \
                    "trace would fail with a missing-value error"
                hint = "feed it, mark it persistable+initialized, or " \
                    "add the producing op"
            else:
                sev = "error"
                what = "is not declared in any block and never produced " \
                    "— a dangling read"
                hint = "the op references a var that does not exist; " \
                    "check the program transform that renamed it"
            out.append(ProgramDiagnostic(
                sev, PASS_DEF_USE,
                "op input %r %s" % (n, what),
                op_idx=i, op_type=op.type, vars=(n,), hint=hint))
        produced.update(x for x in op.output_names() if x != EMPTY_VAR)
    return out


# ---------------------------------------------------------------------------
# pass 2: static shape/dtype inference through the registry rules
# ---------------------------------------------------------------------------

def _declared_meta(ctx, name):
    from ..ops.shape_rules import TensorMeta
    var = ctx.block0._find_var_recursive(name)
    if var is None:
        return TensorMeta(None, None)
    shape = None
    if var.shape is not None:
        shape = tuple(None if d == -1 else d for d in var.shape)
    return TensorMeta(shape, var.dtype)


@analysis_pass(PASS_SHAPE)
def _pass_shape_dtype(ctx):
    from ..ops.registry import get_shape_rule
    from ..ops.shape_rules import ShapeError, TensorMeta
    out = []
    env = {}

    def meta_of(name):
        if name == EMPTY_VAR:
            return TensorMeta(None, None)
        m = env.get(name)
        if m is None:
            m = _declared_meta(ctx, name)
            if ctx.feeds is not None and \
                    ctx.feeds.get(name) is not None:
                m = TensorMeta(ctx.feeds[name], m.dtype)
            env[name] = m
        return m

    def bind(op, results):
        for slot, names in op.outputs.items():
            vals = (results or {}).get(slot) or []
            for j, n in enumerate(names):
                if n == EMPTY_VAR:
                    continue
                env[n] = vals[j] if j < len(vals) else TensorMeta()

    for i, op in enumerate(ctx.block0.ops):
        if op.type == GRAD_OP_TYPE:
            # a gradient has its forward input's metadata, by definition
            for slot, names in op.outputs.items():
                if not slot.startswith("IG:"):
                    continue
                fwd = op.inputs.get("X:" + slot[len("IG:"):], [])
                for j, n in enumerate(names):
                    if n == EMPTY_VAR:
                        continue
                    env[n] = meta_of(fwd[j]) if j < len(fwd) \
                        else TensorMeta()
            continue
        rule = get_shape_rule(op.type)
        if rule is None:
            bind(op, None)
            continue
        ins = {slot: [meta_of(n) for n in names]
               for slot, names in op.inputs.items()}
        try:
            results = rule(op, ins, op.attrs)
        except ShapeError as e:
            out.append(ProgramDiagnostic(
                e.severity, PASS_SHAPE, str(e), op_idx=i,
                op_type=op.type, vars=tuple(op.input_names()[:4]),
                hint="fix the operand shapes/dtypes at this op's "
                     "program location (build time), not in the run"))
            results = None
        except Exception as e:  # a broken rule must not block compiles
            out.append(ProgramDiagnostic(
                "warning", PASS_SHAPE,
                "shape rule for {%s} crashed: %s: %s"
                % (op.type, type(e).__name__, e), op_idx=i,
                op_type=op.type,
                hint="report this — the op infers unknown"))
            results = None
        bind(op, results)
    return out


# ---------------------------------------------------------------------------
# pass 3: sharding feasibility against the declared mesh
# ---------------------------------------------------------------------------

@analysis_pass(PASS_SHARDING)
def _pass_sharding(ctx):
    out = []
    mesh = ctx.mesh_axes
    if not mesh:
        return out
    if ctx.bs_attr("quantize_collectives", False):
        allow = {ctx.data_axis, "pp"}
        bad = {a: int(s) for a, s in mesh.items()
               if a not in allow and int(s) > 1}
        if bad:
            out.append(ProgramDiagnostic(
                "error", PASS_SHARDING,
                "quantize_collectives supports pure data-parallel "
                "meshes only; model axes %r would lose their "
                "collectives" % (bad,),
                hint="drop quantize_collectives or the model axes"))
    dp = int(mesh.get(ctx.data_axis, 1) or 1)
    if dp > 1 and ctx.feeds is not None:
        for name in sorted(ctx.feeds):
            shape = ctx.feed_shape(name)
            if not shape or shape[0] is None:
                continue
            if shape[0] % dp != 0:
                out.append(ProgramDiagnostic(
                    "warning", PASS_SHARDING,
                    "feed %r batch dim %d does not divide the %r mesh "
                    "axis (%d) — the feed stays replicated and every "
                    "shard computes the full batch"
                    % (name, shape[0], ctx.data_axis, dp),
                    vars=(name,),
                    hint="pad the batch to a multiple of %d or resize "
                         "the mesh" % dp))
    for blk in ctx.program.blocks:
        for var in blk.vars.values():
            if not getattr(var, "sharding", None):
                continue
            shape = var.shape or ()
            for dim_i, axis in enumerate(var.sharding):
                if axis is None:
                    continue
                if axis not in mesh:
                    out.append(ProgramDiagnostic(
                        "info", PASS_SHARDING,
                        "var %r is annotated to shard dim %d over mesh "
                        "axis %r which the mesh %r does not have — the "
                        "dim stays replicated" % (var.name, dim_i, axis,
                                                  sorted(mesh)),
                        block_idx=blk.idx, vars=(var.name,)))
                    continue
                size = int(mesh[axis])
                if dim_i < len(shape) and shape[dim_i] not in (None, -1) \
                        and size > 1 and shape[dim_i] % size != 0:
                    out.append(ProgramDiagnostic(
                        "warning", PASS_SHARDING,
                        "var %r dim %d (%d) does not divide mesh axis "
                        "%r (%d) — the dim stays replicated instead of "
                        "sharding" % (var.name, dim_i, shape[dim_i],
                                      axis, size),
                        block_idx=blk.idx, vars=(var.name,),
                        hint="size the dim to a multiple of %d" % size))
    return out


# ---------------------------------------------------------------------------
# pass 4: dead-op / DCE report
# ---------------------------------------------------------------------------

@analysis_pass(PASS_DCE)
def _pass_dce(ctx):
    out = []
    if ctx.fetch_names is None or ctx.program.num_blocks > 1:
        # without fetch roots any leaf could be the fetch; with
        # sub-blocks reads cross block boundaries — both would
        # false-positive, so the report needs the compile seam's roots
        return out
    live = set(ctx.fetch_names)
    dead = []
    for i in range(len(ctx.block0.ops) - 1, -1, -1):
        op = ctx.block0.ops[i]
        outs = [n for n in op.output_names() if n != EMPTY_VAR]
        is_live = (_is_side_effect_op(op)
                   or any(n in live for n in outs)
                   or any(n in ctx.persistable for n in outs))
        if is_live:
            live.update(n for n in op.input_names() if n != EMPTY_VAR)
        else:
            dead.append((i, op, outs))
    for i, op, outs in reversed(dead):
        out.append(ProgramDiagnostic(
            "info", PASS_DCE,
            "dead op: no output reaches the fetch list, a persistable "
            "update, or a collective — it still runs and costs device "
            "time", op_idx=i, op_type=op.type,
            vars=tuple(outs[:4]),
            hint="drop the op or fetch its output"))
    return out
