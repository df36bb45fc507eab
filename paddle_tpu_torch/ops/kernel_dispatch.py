"""Kernel dispatch: which launch config each kernel call site takes.

Counterpart of paddle_tpu/ops/pallas_dispatch.py. The JAX package's
``ops/pallas/`` is the port's ``ops/kernels/`` (hand-written CUDA
kernels), so "Pallas" in the names kept from the JAX package
(``PALLAS_OPS``, ``PallasConfig``, ``impl`` "pallas" and "pallas_q")
means the port's hand-written kernel.

``BuildStrategy(use_pallas=..., pallas_tune_cache=..., kernel_policy=...)``
makes a ``CompiledProgram`` build one :class:`PallasConfig` per compile
(``framework/compiler.py``); the Executor installs it with :func:`scope`
around the step, and the op kernels of ``layer_norm``,
``softmax_with_cross_entropy``, ``fused_mlm_head_loss`` and
``adam``/``adamw`` ask :func:`decide` for their call site's
:class:`KernelChoice`:

  * a cached entry is a MEASURED verdict (exact key, then the key
    without the mesh): its ``config`` is the launch config the kernel
    takes (``ops/kernels/costmodel.py`` lists each family's knobs), and
    ``impl`` "pallas_q" runs the head on bf16 operands with f32 sums;
  * a cache miss with a fitted cost model gets a PREDICTED config;
  * no signal keeps the kernel's default launch, today's.

Decisions are made once per compile and call site: the first run of a
compile decides (the op-by-op run), later op-by-op runs and the capture
read the decision back from the config, and a CUDA graph's replay runs no
Python at all. Each decision is counted in ``resilience``'s
``kernel_choice_total{op=,impl=,source=}`` and, with spans on, recorded
as a ``kernel_choice`` span (framework/obs.py).

The port has one lowering on the card, the hand-written kernel: an
``impl: "xla"`` verdict read for a CUDA backend raises
:class:`KernelChoiceError` naming the key, and a config its kernel does
not take raises it too, before the kernel launches. On the CPU every op
runs its plain version whatever the decision.

The ops pay one thread-local read when no config is installed; the
tuning harness (``ops/kernels/autotune.py``) is never imported here.
"""
import contextlib
import re
import threading

from .kernels import costmodel as _cm

#: ops with a kernel behind this dispatch (flash attention has one kernel
#: and no entry here, as in the JAX package)
PALLAS_OPS = ("softmax_with_cross_entropy", "adam", "layer_norm",
              "fused_mlm_head_loss")

#: kernel_policy values BuildStrategy accepts
KERNEL_POLICIES = ("auto", "xla", "pallas")

_local = threading.local()


class KernelChoiceError(ValueError):
    """A tuning verdict this call cannot run: an ``impl: "xla"`` entry on
    a CUDA backend, or a config its kernel does not take."""


class PallasConfig(object):
    """Per-compile kernel dispatch state.

    ops:        op-type names whose call sites consult the tuning
    tuning:     autotune cache (``lookup(key)``) or None
    mesh_axes:  dict axis->size of the compile's mesh (cache-key part)
    backend:    the card the compile targets (``backend_name``; "cpu")
    cost_model: fitted ``costmodel.CostModel`` or None
    policy:     the BuildStrategy.kernel_policy that built this config
    token:      the compile token's kernel-selection part (the CUDA
                graph key holds it)
    """

    def __init__(self, ops, tuning=None, mesh_axes=None, backend=None,
                 cost_model=None, policy=None, token=None):
        unknown = sorted(set(ops) - set(PALLAS_OPS))
        if unknown:
            raise ValueError(
                "use_pallas names ops with no Pallas lowering: %r "
                "(available: %r)" % (unknown, list(PALLAS_OPS)))
        self.ops = frozenset(ops)
        self.tuning = tuning
        self.mesh_axes = dict(mesh_axes or {})
        self.backend = backend
        self.cost_model = cost_model
        self.policy = policy
        self.token = token
        # (call site, op, shape, dtype) -> KernelChoice: this compile's
        # decisions
        self.decisions = {}


@contextlib.contextmanager
def scope(config):
    """Install ``config`` for the current thread (the Executor's step runs
    under it). Nesting restores the outer config on exit."""
    prev = getattr(_local, "config", None)
    _local.config = config
    try:
        yield config
    finally:
        _local.config = prev


def active():
    return getattr(_local, "config", None)


def enabled(op_type):
    """The active PallasConfig if ``op_type`` consults it, else None."""
    cfg = getattr(_local, "config", None)
    if cfg is not None and op_type in cfg.ops:
        return cfg
    return None


def dtype_name(dtype):
    """"float32" for torch.float32 (the JAX package's ``str(dtype)``)."""
    return str(dtype).replace("torch.", "")


def backend_name(device):
    """The cache-key backend of a torch device: "cpu", or the card's name
    in lower case with dashes (``nvidia-h100-80gb-hbm3``): a verdict
    belongs to one card."""
    if device.type != "cuda":
        return device.type
    import torch
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    name = torch.cuda.get_device_name(index)
    return re.sub(r"[^a-z0-9]+", "-", name.lower()).strip("-")


def cache_key(op, shape, dtype, mesh_axes=None, backend=None):
    """Autotune cache key: one winning config per (op, shape, dtype,
    topology, backend); the JAX package's string for the same parts."""
    axes = ",".join("%s=%d" % (a, int(s))
                    for a, s in sorted((mesh_axes or {}).items()))
    return "%s|%s|%s|%s|%s" % (
        op, "x".join(str(int(d)) for d in shape), dtype_name(dtype),
        axes or "-", backend or "-")


class KernelChoice(tuple):
    """One call site's decision, unpackable as ``(impl, config)``, plus
    provenance:

      impl        -- "pallas" (the hand-written kernel) | "pallas_q" (the
                     head on bf16 operands, f32 sums) | "xla" (a verdict
                     the card refuses; the CPU runs the plain version)
      config      -- the launch config, or None for the kernel's default
      source      -- "measured" | "predicted" | "analytic" | "default"
      predicted_s -- model-predicted seconds (predicted/analytic)
      measured_s  -- banked sweep seconds (measured)
      key         -- the cache key whose entry gave the verdict (None
                     when no entry did)
    """

    def __new__(cls, impl, config=None, source="default",
                predicted_s=None, measured_s=None, key=None):
        self = tuple.__new__(cls, (impl, config))
        self.impl = impl
        self.config = config
        self.source = source
        self.predicted_s = predicted_s
        self.measured_s = measured_s
        self.key = key
        return self


def _export_choice(op, shape, dtype, choice):
    """One decision through the observability layer: the cumulative
    counter always, a span when spans are on."""
    from ..framework import obs, resilience
    resilience.record_kernel_choice(op, choice.impl, choice.source)
    if obs.enabled():
        t = obs.now()
        obs.record("kernel_choice", t, t, op=op,
                   shape="x".join(str(int(d)) for d in shape),
                   dtype=dtype_name(dtype), impl=choice.impl,
                   source=choice.source, predicted_s=choice.predicted_s,
                   measured_s=choice.measured_s)


def choose(cfg, op, shape, dtype, d=None):
    """The :class:`KernelChoice` of one kernel call (the JAX package's
    priority and labels): a banked MEASURED verdict (exact key, then the
    mesh-less key) > a cost-model PREDICTION for a never-swept shape >
    the kernel's default. ``d``: the head's hidden width (its key is
    (tokens, vocab))."""
    if cfg is None:
        return KernelChoice("pallas", None)
    choice = None
    entry = key = None
    if cfg.tuning is not None:
        key = cache_key(op, shape, dtype, cfg.mesh_axes, cfg.backend)
        entry = cfg.tuning.lookup(key)
        if not entry and cfg.mesh_axes:
            key = cache_key(op, shape, dtype, None, cfg.backend)
            entry = cfg.tuning.lookup(key)
    if entry:
        if entry.get("impl") == "xla":
            choice = KernelChoice("xla", None, "measured",
                                  measured_s=entry.get("xla_s"), key=key)
        else:
            config = entry.get("config")
            # a --cost-model-only entry was never measured
            src = "predicted" if entry.get("source") == "costmodel" \
                else "measured"
            choice = KernelChoice(
                entry.get("impl") or "pallas",
                dict(config) if config else None, src,
                predicted_s=entry.get("predicted_s"),
                measured_s=entry.get("pallas_s"), key=key)
    elif cfg.cost_model is not None:
        pred = cfg.cost_model.predict_config(
            op, shape, backend=cfg.backend, dtype=dtype_name(dtype), d=d)
        if pred is not None:
            choice = KernelChoice(
                "pallas", pred["config"],
                "predicted" if pred["source"] == "fitted"
                else "analytic", predicted_s=pred["predicted_s"])
    if choice is None:
        choice = KernelChoice("pallas", None)
    _export_choice(op, shape, dtype, choice)
    return choice


_DEFAULT = KernelChoice("pallas", None)


def decide(op, shape, dtype, ctx=None, d=None, also=None):
    """The call site's decision under the installed config, made once per
    compile (the call site: ``ctx.site``, the op's position in its
    program; without one it decides at every call); the kernel's default
    launch, counted nowhere, when no config covers ``op`` or ``also``.
    Raises KernelChoiceError for a verdict the call cannot run: "xla" on
    a CUDA backend, or a config its kernel does not take."""
    cfg = enabled(op) or (enabled(also) if also else None)
    if cfg is None:
        return _DEFAULT
    site = getattr(ctx, "site", None)
    memo = (site, op, tuple(int(s) for s in shape), dtype_name(dtype))
    if site is not None and memo in cfg.decisions:
        return cfg.decisions[memo]
    choice = choose(cfg, op, shape, dtype, d=d)
    key = choice.key or cache_key(op, shape, dtype, cfg.mesh_axes,
                                  cfg.backend)
    if choice.impl == "xla" and cfg.backend != "cpu":
        raise KernelChoiceError(
            "the tuning verdict for %s is impl 'xla': paddle_tpu_torch has "
            "one lowering on the card, its hand-written kernel, and never "
            "runs a plain version there; re-sweep this key with "
            "paddle_tpu_torch.tools.autotune or drop it from the cache"
            % key)
    if choice.impl not in ("pallas", "pallas_q", "xla"):
        raise KernelChoiceError("the tuning verdict for %s names impl %r "
                                "(known: pallas, pallas_q)"
                                % (key, choice.impl))
    if choice.config:
        try:
            _cm.resolve(op, shape, choice.config,
                        "bfloat16" if choice.impl == "pallas_q" else dtype,
                        d)
        except _cm.KernelConfigError as e:
            raise KernelChoiceError("the %s config %r for %s does not fit "
                                    "its call: %s" % (choice.source,
                                                      choice.config, key, e))
    if site is not None:
        cfg.decisions[memo] = choice
    return choice
