"""CompiledProgram / BuildStrategy / ExecutionStrategy on one card.

Counterpart of paddle_tpu/framework/compiler.py (ref python/paddle/fluid/
compiler.py). Fluid training scripts begin with
``fluid.CompiledProgram(main).with_data_parallel(loss_name=...,
build_strategy=..., exec_strategy=...)``; the port takes them as the JAX
package does, with every ``BuildStrategy`` knob, its default and its
validation.

What one card means:

- a mesh whose sizes multiply to 1 (``with_data_parallel()`` with no mesh
  on one visible card gives ``{"dp": 1}``) runs the program exactly as
  ``Executor.run`` does: the same plan, the same CUDA graph, the same
  launches, plus what the strategy asks for (the numeric guard, the
  collective-timeout watchdog);
- a mesh larger than the visible devices raises ValueError, as the JAX
  package's ``make_mesh`` does;
- a mesh that fits but spans more than one device, ``pp_stages`` and
  ``quantize_collectives=True`` raise NotPortedError: they arrive with
  the torch.distributed slice;
- ``kernel_policy`` ("auto", "xla", "pallas") and ``use_pallas`` are
  validated as the JAX package validates them. Every op of the port
  reaches its one hand-written kernel under "auto" and "pallas";
  ``"xla"`` on a CUDA place raises NotPortedError: the port has no
  second lowering, and a plain version never runs on the card. On the
  CPU every op runs its plain version whatever the policy;
- ``verify_program`` runs the Program verifier (framework/analysis.py)
  through ``verify_for_compile``, as the JAX package does: "strict"
  raises ProgramVerificationError listing every error, "warn" logs and
  counts, "off" skips it. A pipeline strategy raises NotPortedError
  before the verifier runs (the verifier's pipeline pass comes with the
  multi-GPU slice);
- the JAX package's parity no-ops (``fuse_all_reduce_ops``,
  ``memory_optimize``, ...) are accepted and change nothing.
"""
import logging
import os

import numpy as np
import torch

from ..ops.registry import NotPortedError
from . import analysis
from .place import _current_expected_place

# kernel_policy values BuildStrategy accepts (paddle_tpu/ops/
# pallas_dispatch.py KERNEL_POLICIES)
KERNEL_POLICIES = ("auto", "xla", "pallas")
# the op names use_pallas may name (paddle_tpu/ops/pallas_dispatch.py
# PALLAS_OPS)
PALLAS_OPS = ("softmax_with_cross_entropy", "adam", "layer_norm",
              "fused_mlm_head_loss")
VERIFY_MODES = ("strict", "warn", "off")


def verify_for_compile(program, build_strategy=None, feeds=None,
                       fetch_names=None, source="compile"):
    """Run the Program verifier at a compile seam (framework/analysis.py;
    paddle_tpu/framework/compiler.py's function of the same name).

    The mode is BuildStrategy.verify_program (PADDLE_TPU_VERIFY for the
    plain Executor): "off" returns at once; "warn" logs errors and
    warnings and records the analysis metrics; "strict" raises
    ProgramVerificationError when any error-severity diagnostic
    survives, listing all of them.

    Memoized per (program version, mode, mesh, strategy knobs, feed and
    fetch signature) on the program object, as the JAX package keys it,
    so only compile-cache misses pay the walk and a repeat costs one
    dict probe."""
    mode = getattr(build_strategy, "verify_program", None) \
        if build_strategy is not None else None
    if mode is None:
        mode = analysis.env_verify_mode()
    if mode == "off":
        return None
    feed_sig = None if feeds is None else tuple(
        sorted((k, tuple(np.shape(v)) if not isinstance(v, tuple)
                else v) for k, v in feeds.items()))
    bs = build_strategy
    if bs is None:
        mesh, strat_sig = None, None
    else:
        mesh = getattr(bs, "mesh_axes", None)
        # every strategy knob a pass reads joins the memo key: two
        # strategies sharing one Program never share a verdict
        strat_sig = (getattr(bs, "data_axis", "dp"),
                     getattr(bs, "quantize_collectives", False),
                     getattr(bs, "pp_stages", None),
                     getattr(bs, "pp_micro_batches", 1),
                     getattr(bs, "pp_schedule", "1f1b"),
                     getattr(bs, "pp_recut_slots", None))
    key = (program._version, mode,
           None if mesh is None else tuple(sorted(mesh.items())),
           strat_sig, feed_sig,
           None if fetch_names is None else tuple(fetch_names))
    cache = getattr(program, "_verify_cache", None)
    if cache is None:
        cache = program._verify_cache = {}
    if key in cache:
        result = cache[key]
    else:
        # evict verdicts of older program versions: a mutate-run loop
        # must not keep one AnalysisResult per historical version
        for k in [k for k in cache if k[0] != program._version]:
            del cache[k]
        result = analysis.verify_program(
            program, feeds=feeds, fetch_list=fetch_names,
            build_strategy=build_strategy)
        analysis.report(result, mode=mode, source=source)
        cache[key] = result
        if result.errors() or result.warnings():
            logging.getLogger("paddle_tpu_torch").warning(
                "program verification (%s mode): %s", mode,
                result.summary())
    if mode == "strict" and result.errors():
        raise analysis.ProgramVerificationError(result)
    return result


def _env_timeout_default():
    """BuildStrategy's collective_timeout_s defaults to
    PADDLE_TPU_COLLECTIVE_TIMEOUT_S (seconds; unset/empty = no guard)."""
    raw = os.environ.get("PADDLE_TPU_COLLECTIVE_TIMEOUT_S", "").strip()
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        raise ValueError(
            "PADDLE_TPU_COLLECTIVE_TIMEOUT_S=%r is not a number of "
            "seconds (use e.g. '30' or '12.5', or unset for no guard)"
            % raw)


class BuildStrategy(object):
    """The JAX package's BuildStrategy knobs (any can be passed as a
    constructor kwarg):

      - mesh_axes: dict axis name -> size; on one card the sizes multiply
        to 1 (see the module docstring)
      - data_axis: the mesh axis feeds are batch-split over ("dp")
      - check_numerics: a finite guard on every fetch and state tensor
        (reference check_nan_inf)
      - numeric_policy: what happens when the guard trips:
          "raise"  -- FloatingPointError naming the first offending var;
                      the poisoned state is written back first
          "skip"   -- the step is discarded on the device: every
                      persistable the step writes goes back to its
                      pre-step value inside the captured step, the run
                      counter steps back, and a numeric_fault event names
                      the culprit; bounded by numeric_skip_budget
                      consecutive skips (SkipBudgetExceededError)
          "rewind" -- resilience.NumericFaultError (a FloatingPointError
                      carrying step and culprit): ResilientTrainer
                      restores the last checkpoint and replays without
                      the poison batch
        "skip" and "rewind" imply check_numerics. Part of the cache
        token: the guarded step is another step.
      - collective_timeout_s: bound the wait for each step's completion
        (None = no guard; env PADDLE_TPU_COLLECTIVE_TIMEOUT_S)
      - use_pallas / pallas_tune_cache / kernel_policy: kernel selection
      - pp_stages / pp_micro_batches / pp_schedule / pp_recut_slots:
        pipeline parallelism (NotPortedError)
      - quantize_collectives and its block/bits/min-size/merge knobs:
        quantized gradient sync (NotPortedError when True)
      - verify_program: "strict" | "warn" | "off" (env PADDLE_TPU_VERIFY)
    Reference flags like fuse_all_reduce_ops / memory_optimize are
    no-ops, kept for API parity."""

    def __init__(self, **kw):
        self.mesh_axes = None
        self.data_axis = "dp"
        self.check_numerics = False
        self.numeric_policy = "raise"
        # max CONSECUTIVE steps numeric_policy="skip" may discard
        # before escalating (a clean step resets the streak)
        self.numeric_skip_budget = 3
        self.collective_timeout_s = _env_timeout_default()
        self.quantize_collectives = False
        self.quantize_block_size = 256
        self.quantize_bits = 8
        self.quantize_min_size = None
        self.use_pallas = frozenset()
        self.pallas_tune_cache = None
        self.kernel_policy = "auto"
        self.pp_stages = None
        self.pp_micro_batches = 1
        self.pp_schedule = "1f1b"
        self.pp_recut_slots = None
        self.verify_program = analysis.env_verify_mode()
        self.quantize_merge_sync = False
        # parity no-ops
        self.fuse_all_reduce_ops = True
        self.fuse_elewise_add_act_ops = True
        self.memory_optimize = True
        self.enable_inplace = True
        self.num_trainers = 1
        self.trainer_id = 0
        for k, v in kw.items():
            if not hasattr(self, k):
                raise TypeError("BuildStrategy has no knob %r" % k)
            setattr(self, k, v)
        if self.numeric_policy not in ("raise", "skip", "rewind"):
            raise ValueError(
                "numeric_policy must be 'raise', 'skip' or 'rewind', "
                "got %r" % (self.numeric_policy,))
        if int(self.numeric_skip_budget) < 1:
            raise ValueError("numeric_skip_budget must be >= 1")
        if self.pp_recut_slots is not None:
            if int(self.pp_recut_slots) < 1:
                raise ValueError("pp_recut_slots must be >= 1 (a re-cut "
                                 "keeps every logical stage resident)")
            if not self.pp_stages:
                raise ValueError(
                    "pp_recut_slots needs pp_stages: the re-cut maps K "
                    "logical stages (pp_stages) onto n_slots mesh slots")


class ExecutionStrategy(object):
    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 1
        self.use_experimental_executor = True


class CompilePlan(object):
    """How a (program, strategy) pair runs: ``kind`` "single_jit" on one
    card (the JAX package's "pipeline" kind, with its cut and schedule,
    is the torch.distributed slice's); ``token`` is the strategy's cache
    token."""

    __slots__ = ("kind", "token")

    def __init__(self, kind, token):
        self.kind = kind
        self.token = token


def visible_devices(device=None):
    """The devices a mesh may span: the visible CUDA devices, or the CPU
    (one device) for a CPU place or where torch sees no card."""
    if device is not None and device.type == "cpu":
        return 1
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def check_mesh(mesh_axes, n_devices):
    """Refuse a mesh this card cannot run: ValueError when it needs more
    devices than ``n_devices`` (the JAX package's make_mesh), and
    NotPortedError when it fits but spans more than one."""
    sizes = [int(s) for s in (mesh_axes or {}).values()]
    n = 1
    for s in sizes:
        n *= s
    if n > n_devices:
        raise ValueError("mesh %r needs %d devices, only %d available"
                         % (mesh_axes, n, n_devices))
    if n > 1:
        raise NotPortedError(
            "mesh %r spans %d devices: data, tensor and pipeline "
            "parallelism arrive with the torch.distributed slice of "
            "paddle_tpu_torch; on one card give a mesh whose sizes "
            "multiply to 1" % (mesh_axes, n))


class CompiledProgram(object):
    """fluid.CompiledProgram work-alike on one card.

    ``with_data_parallel(...)`` without an explicit mesh splits the batch
    over every visible device ("dp" axis); on one card that is
    ``{"dp": 1}`` and the program runs as ``Executor.run`` runs it."""

    def __init__(self, program, build_strategy=None):
        self._program = program
        self._build_strategy = build_strategy or BuildStrategy()
        self._exec_strategy = ExecutionStrategy()
        self._devices = None

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None):
        if build_strategy is not None:
            self._build_strategy = build_strategy
        if exec_strategy is not None:
            self._exec_strategy = exec_strategy
        if self._build_strategy.mesh_axes is None:
            n_dev = len(places) if places else visible_devices()
            k = int(getattr(self._build_strategy, "pp_stages", 0) or 0)
            if k > 1:
                self._build_strategy.mesh_axes = {
                    "pp": k, "dp": max(1, n_dev // k)}
            else:
                self._build_strategy.mesh_axes = {"dp": n_dev}
        return self

    def with_mesh(self, mesh_axes, devices=None):
        """Explicit mesh, e.g. {"dp": 1}."""
        self._build_strategy.mesh_axes = dict(mesh_axes)
        self._devices = devices
        return self

    def set_mesh_axes(self, mesh_axes, devices=None):
        """Re-target onto a new mesh (the cache token holds the axes, so
        returning to an earlier mesh reuses its captured steps)."""
        self._build_strategy.mesh_axes = dict(mesh_axes)
        if devices is not None:
            self._devices = devices
        return self

    # ------------------------------------------------------------------
    def _kernel_policy(self):
        policy = getattr(self._build_strategy, "kernel_policy",
                         "auto") or "auto"
        if policy not in KERNEL_POLICIES:
            raise ValueError(
                "kernel_policy must be one of %r, got %r"
                % (list(KERNEL_POLICIES), policy))
        return policy

    def _check_kernels(self, device):
        """kernel_policy and use_pallas, validated as the JAX package
        validates them; "xla" on a CUDA place has no lowering here."""
        policy = self._kernel_policy()
        ops = frozenset(getattr(self._build_strategy, "use_pallas", ())
                        or ())
        if policy != "xla":
            unknown = sorted(set(ops) - set(PALLAS_OPS))
            if unknown:
                raise ValueError(
                    "use_pallas names ops with no Pallas lowering: %r "
                    "(available: %r)" % (unknown, list(PALLAS_OPS)))
        elif device.type == "cuda":
            raise NotPortedError(
                "kernel_policy='xla' asks for each op's second lowering; "
                "every op of paddle_tpu_torch has one hand-written kernel "
                "on the card, and a plain version never runs there — use "
                "'auto' or 'pallas' (kernel dispatch between two kernels "
                "of one op is ROADMAP.md Queue 1 item 5)")

    def _cache_token(self):
        """What changes the port's step: the numeric guard and its policy,
        and the mesh axes."""
        bs = self._build_strategy
        return (tuple(sorted((bs.mesh_axes or {}).items())),
                bool(getattr(bs, "check_numerics", False)),
                getattr(bs, "numeric_policy", "raise"))

    def _pp_enabled(self):
        bs = self._build_strategy
        if getattr(bs, "pp_stages", None):
            return True
        return int((bs.mesh_axes or {}).get("pp", 1) or 1) > 1

    def compile_plan(self, device=None):
        """The route of this (program, strategy) pair on ``device``
        (default: CUDAPlace(0)'s device, NoCUDADeviceError without a
        card): kind "single_jit". Raises what the card cannot run (see
        the module docstring), then runs the Program verifier unless
        this program version was verified already (the Executor verifies
        with the real feeds at its compile-cache misses)."""
        bs = self._build_strategy
        if device is None:
            device = _current_expected_place().torch_device()
        mode = getattr(bs, "verify_program", "warn")
        if mode not in VERIFY_MODES:
            raise ValueError("verify_program must be one of %r, got %r"
                             % (list(VERIFY_MODES), mode))
        if self._pp_enabled():
            if getattr(bs, "numeric_policy", "raise") != "raise":
                raise ValueError(
                    "numeric_policy=%r is not supported with pipeline "
                    "parallelism yet — the pp lowering keeps raise-only "
                    "check_numerics" % (bs.numeric_policy,))
            raise NotPortedError(
                "pipeline parallelism (pp_stages / a 'pp' mesh axis) "
                "arrives with the torch.distributed slice of "
                "paddle_tpu_torch")
        if getattr(bs, "quantize_collectives", False):
            raise NotPortedError(
                "quantize_collectives=True quantizes the data-parallel "
                "gradient sync across devices; it arrives with the "
                "torch.distributed slice of paddle_tpu_torch")
        check_mesh(bs.mesh_axes or {"dp": 1},
                   len(self._devices) if self._devices
                   else visible_devices(device))
        self._check_kernels(device)
        cache = getattr(self._program, "_verify_cache", None)
        if not cache or all(k[0] != self._program._version
                            for k in cache):
            verify_for_compile(self._program, bs, source="compile_plan")
        return CompilePlan("single_jit", self._cache_token())


__all__ = ["BuildStrategy", "ExecutionStrategy", "CompilePlan",
           "CompiledProgram", "check_mesh", "verify_for_compile",
           "visible_devices"]
