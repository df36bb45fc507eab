"""Deployable serving artifacts: "train here, serve anywhere" on one host.

Counterpart of paddle_tpu/serving.py. The JAX package traces the pruned
inference Program once into a StableHLO computation per batch bucket;
here the pruned Program's ``run_block`` is exported once per bucket with
``torch.export.export(..., strict=False)`` on the device that will serve
it, and saved with ``torch.export.save``:

  serving/meta.json          feed/fetch names, shapes, dtypes, buckets,
                             the runtime stamp and the device type
  serving/export_b{N}.pt2    the exported program of bucket N
  serving/module_b{N}.txt    its graph as text
  serving/weights.npz        the weights (plain layout), or
  serving/weights_q8.npz     block-quantized int8 weights (q8 layout)

The weights enter every exported program as leading arguments, sorted by
name, in both layouts, and ship once beside the exports: baking them
into each bucket's ``.pt2`` would repeat BERT-base's 438 MB of f32 in
every bucket. The hand-written forward kernels are the custom ops
``paddle_tpu_torch::flash_attention_fwd`` and ``layer_norm_fwd``
(ops/kernels/), which the exported graph holds as ops: the dispatcher
runs the CUDA kernel for a CUDA tensor and the plain version for a CPU
one. A non-Python client has no path to these artifacts.

``ServingPredictor`` pads a request up to the nearest exported bucket
and slices the results back (the ``inference.Predictor`` contract). On
the card a bucket's first call runs the exported program and then
captures it into a CUDA graph with static input buffers (the port's
"cold compile"); later calls copy the request in and replay. Each bucket
has its own stream, memory pool and lock, and captures with
``capture_error_mode="thread_local"``, so an orphaned deadline worker
may capture one bucket while another thread serves from another.
"""
import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from .framework import obs, resilience
from .framework.dtypes import to_torch_dtype
from .framework.executor import (RunContext, _check_runnable, _host_sync,
                                 _last_uses, run_block)
from .framework.place import resolve_device
from .framework.program import default_main_program
from .framework.scope import global_scope
from .io import (_decode, _decode_member, _encode_payload,
                 _persistable_arrays)
from .ops import kernels

MODULE_SUBDIR = "serving"
# 2: plain layout (feed_batch_factor / fetch_batch_factor). 3: the lossy
# q8 layout, stamped apart so an older loader refuses it. The numbers
# are the JAX package's.
SERVING_FORMAT_VERSION = 3
WEIGHTS_FILE = "weights.npz"
WEIGHTS_Q8_FILE = "weights_q8.npz"
# the runtime stamp: which library exported the artifact (the JAX
# package's artifacts have none and hold export_b*.bin)
RUNTIME = "paddle_tpu_torch"


class _Infer(torch.nn.Module):
    """(weights..., feeds...) -> fetches: the pruned program's ops on one
    environment, each value freed after its last reader."""

    def __init__(self, program, weight_names, feed_names, fetch_names,
                 device):
        super(_Infer, self).__init__()
        self._program = program
        self._weight_names = list(weight_names)
        self._feed_names = list(feed_names)
        self._fetch_names = list(fetch_names)
        self._device = device
        blk = program.global_block()
        self._drop = _last_uses(blk.ops, set(self._weight_names) |
                                set(self._feed_names) |
                                set(self._fetch_names))

    def forward(self, *args):
        n = len(self._weight_names)
        env = dict(zip(self._weight_names, args[:n]))
        env.update(zip(self._feed_names, args[n:]))
        ctx = RunContext(self._device, self._program, 0)
        run_block(self._program.global_block(), env, ctx,
                  drop=self._drop)
        return tuple(env[name] for name in self._fetch_names)


def infer_batch_factors(dyn_dims, overrides=None):
    """Batch-factor inference, shared by the serving export and the
    in-process Predictor: ``dyn_dims`` is [(name, dim0)] for the
    batch-dynamic feeds. A feed's dim0 = factor * batch; the smallest
    dim0 is taken as the batch unless ``overrides`` ({name: factor})
    pins a feed — then the batch derives from the overridden feeds (they
    must agree). Returns ({name: factor}, batch). batch 0 (empty request)
    gives factor 1 to every non-overridden feed."""
    overrides = overrides or {}
    if not dyn_dims:
        return {}, None
    base = None
    for name, d0 in dyn_dims:
        if name in overrides:
            f = int(overrides[name])
            if f <= 0 or d0 % f:
                raise ValueError(
                    "feed %r dim0 %d is not a multiple of its declared "
                    "batch factor %r" % (name, d0, overrides[name]))
            b2 = d0 // f
            if base is None:
                base = b2
            elif b2 != base:
                raise ValueError(
                    "overridden feeds disagree on the batch: %r implies "
                    "%d, earlier feeds %d" % (name, b2, base))
    if base is None:
        base = min(d0 for _, d0 in dyn_dims)
    factors = {}
    for name, d0 in dyn_dims:
        if name in overrides:
            factors[name] = int(overrides[name])
        elif base == 0:
            factors[name] = 1
        else:
            if d0 % base:
                raise ValueError(
                    "feed %r leading dim %d is not a multiple of the "
                    "batch %d" % (name, d0, base))
            factors[name] = d0 // base
    return factors, base


def _feed_factors(program, feed_names, example_feed, overrides=None):
    """Per-feed batch factors: feed i's leading dim is factor[i] *
    request_batch (0 = static feed). Factor 1 is the default for
    batch-dynamic feeds; an example feed dict refines it for feeds whose
    leading dim scales as a multiple of the batch (BERT's flat mask_pos
    with dim0 = batch * max_preds), through ``infer_batch_factors``."""
    blk = program.global_block()
    dyn = []
    for name in feed_names:
        shape = list(blk.var(name).shape)
        dyn.append(bool(shape) and shape[0] == -1)
    if not any(dyn):
        return [0] * len(feed_names)
    overrides = overrides or {}
    if example_feed is None:
        return [overrides.get(n, 1) if d else 0
                for n, d in zip(feed_names, dyn)]
    dyn_dims = [(n, np.asarray(example_feed[n]).shape[0])
                for n, d in zip(feed_names, dyn) if d]
    fmap, _ = infer_batch_factors(dyn_dims, overrides)
    return [fmap[n] if d else 0 for n, d in zip(feed_names, dyn)]


def _feed_specs(program, feed_names, batch, factors):
    """[(shape, torch dtype)] of the feeds at one bucket size; a leading
    -1 (append_batch_size) dim becomes factor * bucket batch."""
    blk = program.global_block()
    specs = []
    for name, factor in zip(feed_names, factors):
        var = blk.var(name)
        shape = list(var.shape)
        if factor:
            shape[0] = batch * factor
        if any(s is None or s < 0 for s in shape):
            raise ValueError(
                "serving export: feed %r has non-batch dynamic dims %s — "
                "an exported program is static-shape" % (name, shape))
        specs.append((tuple(shape), to_torch_dtype(var.dtype)))
    return specs


def _zeros(specs, device):
    return [torch.zeros(shape, dtype=dtype, device=device)
            for shape, dtype in specs]


def _out_shapes(module, weights, specs, device):
    """The fetches' shapes for feeds of ``specs``, from fake tensors (no
    kernel runs; the counterpart of the JAX export's ``eval_shape``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(), torch.no_grad():
        args = [torch.empty(w.shape, dtype=w.dtype, device=device)
                for w in weights]
        args += [torch.empty(shape, dtype=dtype, device=device)
                 for shape, dtype in specs]
        return [tuple(o.shape) for o in module(*args)]


def _weight_payload(program, scope, device, compress):
    """(names, {name: host array}, {name: dtype name}, device tensors):
    the program's persistables that ``scope`` holds, sorted by name, in
    their file encoding (q8-encoded when ``compress``) and as the
    tensors the export is traced against (dequantized again for q8, so
    export-time and load-time values agree)."""
    arrays, dtypes = _persistable_arrays(program, scope)
    names = sorted(arrays)
    payload = _encode_payload(arrays, compress)
    return names, payload, dtypes, [
        _decode(_decode_member(payload, n), dtypes[n]).to(device)
        for n in names]


def export_serving_artifact(dirname, feeded_var_names, target_vars,
                            executor=None, main_program=None,
                            batch_sizes=(1, 8, 32), scope=None,
                            pruned_program=None, example_feed=None,
                            feed_batch_factors=None,
                            weight_compress=None):
    """Export the inference program for serving, under dirname/serving/.

    ``target_vars`` may be Variables or names. ``pruned_program`` skips
    the clone and prune when the caller (``save_inference_model``)
    already froze the program. ``example_feed`` (one representative
    feed dict) teaches the export which batch-dynamic feeds scale as a
    multiple of the request batch; without it every dynamic feed is
    factor 1. The export runs on ``executor``'s place (default
    CUDAPlace(0)), which the artifact is stamped with and served on.
    ``weight_compress="q8"`` ships the weights block-quantized (lossy:
    the answers match the plain artifact's only to the codec's
    tolerance; stamped format_version 3). Refuses, naming the op, a
    program holding an op that reads a device value on the host
    (``OpDef.syncs_host``: ``cond``, an unbounded ``while_loop``,
    ``print``, ``range``, ...): an exported program is one traced
    graph. Returns the list of written export paths."""
    if not batch_sizes:
        raise ValueError("serving export needs at least one batch size")
    if weight_compress not in (None, "q8"):
        raise ValueError("serving export weight_compress must be None "
                         "or 'q8', got %r" % (weight_compress,))
    device = resolve_device(executor.place if executor is not None
                            else None)
    scope = scope if scope is not None else global_scope()
    feed_names = list(feeded_var_names)
    target_names = [getattr(v, "name", v) for v in target_vars]
    if pruned_program is not None:
        pruned = pruned_program
    else:
        program = main_program or default_main_program()
        pruned = program.clone(for_test=True)._prune(feed_names,
                                                     target_names)
    _check_runnable(pruned)
    why = _host_sync(pruned)
    if why is not None:
        raise ValueError("serving export: %s; an exported program is one "
                         "traced graph and cannot branch on it" % why)

    names, payload, dtypes, weights = _weight_payload(
        pruned, scope, device, weight_compress)
    module = _Infer(pruned, names, feed_names, target_names, device)
    factors = _feed_factors(pruned, feed_names, example_feed,
                            overrides=feed_batch_factors)
    dynamic = any(factors)
    buckets = sorted(set(batch_sizes)) if dynamic else [0]
    # which outputs scale with the batch, and by what factor: output
    # shapes at batches 1 and 2 from fake tensors, recorded at export so
    # the loader never guesses from runtime shapes
    fetch_factors = [0] * len(target_names)
    if dynamic:
        o1 = _out_shapes(module, weights, _feed_specs(
            pruned, feed_names, 1, factors), device)
        o2 = _out_shapes(module, weights, _feed_specs(
            pruned, feed_names, 2, factors), device)
        for i, (s1, s2) in enumerate(zip(o1, o2)):
            if s1 and s2 and s2[0] != s1[0]:
                fetch_factors[i] = s2[0] - s1[0]

    # build the whole artifact in a temp dir and swap it in at the end:
    # an interrupted re-export never leaves a loadable mix of old and new
    final_dir = os.path.join(dirname, MODULE_SUBDIR)
    out_dir = final_dir + ".tmp.%d" % os.getpid()
    if os.path.exists(out_dir):
        shutil.rmtree(out_dir)
    os.makedirs(out_dir)
    weight_file = WEIGHTS_Q8_FILE if weight_compress else WEIGHTS_FILE
    np.savez(os.path.join(out_dir, weight_file), **payload)
    written, bucket_meta, export_s = [], {}, {}
    for b in buckets:
        specs = _feed_specs(pruned, feed_names, b or 1, factors)
        t0 = time.perf_counter()
        with torch.no_grad():
            exported = torch.export.export(
                module, tuple(weights + _zeros(specs, device)),
                strict=False)
        # the example inputs are the weights and zero feeds: saved, they
        # would put every weight into every bucket's file
        exported.example_inputs = None
        path = os.path.join(out_dir, "export_b%d.pt2" % b)
        torch.export.save(exported, path)
        export_s[str(b)] = time.perf_counter() - t0
        with open(os.path.join(out_dir, "module_b%d.txt" % b), "w") as f:
            f.write(str(exported.graph))
        written.append(path)
        bucket_meta[str(b)] = {
            "feeds": [{"name": n, "shape": list(shape),
                       "dtype": str(dtype).replace("torch.", "")}
                      for n, (shape, dtype) in zip(feed_names, specs)]}

    # plain exports are stamped 2 and q8 ones 3, as in the JAX package
    meta = {"format_version": 3 if weight_compress else 2,
            "feed_var_names": feed_names,
            "fetch_var_names": target_names,
            "dynamic_batch": dynamic,
            "feed_batch_factor": factors,
            "fetch_batch_factor": fetch_factors,
            "buckets": bucket_meta,
            "weight_names": names,
            "weight_dtypes": [dtypes[n] for n in names],
            "weight_file": weight_file,
            "runtime": {"library": RUNTIME, "torch": torch.__version__},
            "device": device.type,
            "export_seconds": export_s}
    if weight_compress:
        meta["weight_compress"] = weight_compress
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    if os.path.exists(final_dir):
        shutil.rmtree(final_dir)
    os.rename(out_dir, final_dir)
    return [p.replace(out_dir, final_dir) for p in written]


class _Bucket(object):
    """One exported bucket on the serving device: the loaded program and,
    on a CUDA card, its graph, static input buffers, stream and memory
    pool. ``lock`` guards the static buffers from copy-in to copy-out,
    so two requests never share them."""

    def __init__(self, module, weights, specs, device):
        self.module = module
        self.weights = weights
        self.specs = specs
        self.device = device
        self.lock = threading.Lock()
        self.graph = None
        self.feeds = None
        self.outputs = None
        self.launches = None
        self.capture_ms = None
        self.stream = torch.cuda.Stream(device) \
            if device.type == "cuda" else None

    def __call__(self, feeds):
        """Numpy outputs for numpy ``feeds`` (already at the bucket's
        shapes and dtypes)."""
        with self.lock, torch.no_grad():
            if self.stream is None:
                outs = self.module(*self.weights, *[
                    torch.from_numpy(np.ascontiguousarray(a))
                    for a in feeds])
                return [o.numpy() for o in outs]
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self.stream):
                if self.graph is None:
                    return self._first_call(feeds)
                for buf, a in zip(self.feeds, feeds):
                    buf.copy_(torch.from_numpy(np.ascontiguousarray(a)))
                self.graph.replay()
                kernels.credit_launches(self.launches)
                return [o.cpu().numpy() for o in self.outputs]

    def _first_call(self, feeds):
        """The bucket's first call: the exported program run on the
        request, then captured into a CUDA graph over static buffers
        that hold the same request (not replayed)."""
        self.feeds = [torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device) for a in feeds]
        outs = [o.cpu().numpy() for o in
                self.module(*self.weights, *self.feeds)]
        self.stream.synchronize()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        before = kernels.launch_counts()
        graph.capture_begin(pool=torch.cuda.graph_pool_handle(),
                            capture_error_mode="thread_local")
        try:
            outputs = self.module(*self.weights, *self.feeds)
        finally:
            graph.capture_end()
            launches = tuple(a - b for a, b in zip(kernels.launch_counts(),
                                                   before))
            kernels.credit_launches(tuple(-d for d in launches))
        self.stream.synchronize()
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.graph, self.outputs, self.launches = graph, outputs, launches
        return outs


class ServingPredictor(object):
    """Loader for the exported artifact: load and call.

    Pads requests up to the nearest exported bucket and slices results
    back (the ``inference.Predictor`` contract). ``place`` (default
    CUDAPlace(0)) must be of the device type the artifact was exported
    for.

    Resilience (framework/resilience.py):
      * ``run(..., deadline_s=)`` bounds each request's wall clock
        (host-side slowness, a cold bucket's first call and capture,
        device waits alike) via resilience.run_with_deadline ->
        DeadlineExceededError.
      * ``max_in_flight`` sheds excess concurrency with
        ServerOverloadedError instead of letting a queue collapse.
      * degraded mode: when a cold bucket blows the deadline and a warm
        larger bucket exists, the request is padded up and served from
        the warm bucket while the abandoned cold call finishes in the
        background. The fallback is new work and claims its own
        in-flight slot: under cap pressure it sheds rather than exceed
        the cap.
    """

    def __init__(self, dirname, max_in_flight=None, deadline_s=None,
                 place=None):
        self._device = resolve_device(place)
        out_dir = os.path.join(dirname, MODULE_SUBDIR)
        self._max_in_flight = max_in_flight
        self._deadline_s = deadline_s
        self._in_flight = 0
        self._lock = threading.Lock()
        self._warm = set()   # buckets that served already
        # per-replica health counters (the orchestrator-facing twin of
        # the process-global resilience event log)
        self._stats = {"requests": 0, "deadline_misses": 0, "sheds": 0,
                       "degraded_serves": 0, "errors": 0}
        with open(os.path.join(out_dir, "meta.json")) as f:
            self._meta = json.load(f)
        runtime = self._meta.get("runtime") or {}
        if runtime.get("library") != RUNTIME:
            raise ValueError(
                "serving artifact %s was not exported by %s (no runtime "
                "stamp; the JAX package's artifacts hold jax.export "
                "blobs, export_b*.bin): re-export it with "
                "paddle_tpu_torch's save_inference_model(format="
                "'stablehlo')" % (dirname, RUNTIME))
        if self._meta["format_version"] > SERVING_FORMAT_VERSION:
            raise ValueError(
                "serving artifact %s has format_version %d, newer than "
                "this library's %d"
                % (dirname, self._meta["format_version"],
                   SERVING_FORMAT_VERSION))
        if self._meta["device"] != self._device.type:
            raise ValueError(
                "serving artifact %s was exported for the %s and cannot "
                "serve on %s: its graph holds %s tensors; export it on "
                "the place that serves it"
                % (dirname, self._meta["device"], self._device,
                   self._meta["device"]))
        wc = self._meta.get("weight_compress")
        if wc not in (None, "q8"):
            raise ValueError(
                "serving artifact %s has unknown weight_compress %r"
                % (dirname, wc))
        # a corrupt shipped program refuses to load, so a bad artifact
        # fails the rolling deploy's drain step and not the first live
        # request; only PADDLE_TPU_VERIFY=off skips it
        self._verify_exported_program(dirname)
        self._feed_names = self._meta["feed_var_names"]
        self._fetch_names = self._meta["fetch_var_names"]
        self._weights = self._load_weights(out_dir)
        self._fns = {}
        for key, spec in self._meta["buckets"].items():
            program = torch.export.load(
                os.path.join(out_dir, "export_b%s.pt2" % key))
            self._fns[int(key)] = _Bucket(
                program.module(), self._weights,
                [(tuple(f["shape"]), np.dtype(f["dtype"]))
                 for f in spec["feeds"]], self._device)

    def _load_weights(self, out_dir):
        """The weights on the device, in ``weight_names`` order; a q8
        file dequantized once."""
        with np.load(os.path.join(out_dir, self._meta["weight_file"]),
                     allow_pickle=False) as z:
            return [_decode(_decode_member(z, n), dt).to(self._device)
                    for n, dt in zip(self._meta["weight_names"],
                                     self._meta["weight_dtypes"])]

    @property
    def weight_compress(self):
        """None for the plain layout, "q8" when the weights ship as
        block-quantized int8."""
        return self._meta.get("weight_compress")

    @staticmethod
    def _verify_exported_program(dirname):
        from .framework import analysis
        if analysis.env_verify_mode() == "off":
            return
        model_path = os.path.join(dirname, "__model__.json")
        if not os.path.exists(model_path):
            return    # serving-only artifact: no IR shipped to vet
        try:
            with open(model_path) as f:
                meta = json.load(f)
            result = analysis.verify_model_meta(meta)
        except (ValueError, TypeError) as e:
            raise ValueError(
                "serving artifact %s ships a corrupt program IR "
                "(%s) — refusing to load it" % (dirname, e))
        analysis.report(result, mode="strict", source="serving_load")
        if result.errors():
            raise ValueError(
                "serving artifact %s failed program verification — "
                "refusing to load it:\n%s" % (dirname, result.summary()))

    def get_input_names(self):
        return list(self._feed_names)

    def get_output_names(self):
        return list(self._fetch_names)

    def feed_batch_factors(self):
        """{feed name: batch factor}: feed i's leading dim is factor *
        request_batch (0 = static feed), the export's recorded
        contract."""
        return dict(zip(self._feed_names,
                        self._meta["feed_batch_factor"]))

    def fetch_batch_factors(self):
        """{fetch name: batch factor}: output i's leading dim is
        factor * request_batch (0 = static output)."""
        return dict(zip(self._fetch_names,
                        self._meta["fetch_batch_factor"]))

    def feed_dtypes(self):
        """{feed name: numpy dtype name} from the export's bucket specs:
        what a request is cast to before the exported program is
        called."""
        first = self._meta["buckets"][sorted(self._meta["buckets"])[0]]
        return {f["name"]: f["dtype"] for f in first["feeds"]}

    def feed_inner_shapes(self):
        """{feed name: fixed dims}: for a batch-dynamic feed the trailing
        dims (everything after the batch-scaled leading dim); for a
        static feed (factor 0) the full shape."""
        first = self._meta["buckets"][sorted(self._meta["buckets"])[0]]
        factors = self.feed_batch_factors()
        out = {}
        for f in first["feeds"]:
            shape = list(f["shape"])
            out[f["name"]] = shape[1:] if factors.get(f["name"]) \
                else shape
        return out

    @property
    def dynamic_batch(self):
        return bool(self._meta["dynamic_batch"])

    @property
    def max_bucket(self):
        """Largest exported batch bucket (0 for a static artifact)."""
        return max(self._fns)

    def _bump(self, key):
        with self._lock:
            self._stats[key] += 1

    def health(self):
        """Readiness and liveness snapshot for orchestrator probes, a
        JSON-ready dict. ``ready`` is the rotation signal: True only
        while the replica can take traffic at full quality now (every
        exported bucket warm, the in-flight cap not saturated).
        ``status`` says why not: "cold", "saturated", "degraded"
        (serving, but deadline misses, warm-bucket fallbacks or errors
        happened), else "ok". The counters are cumulative over this
        predictor's life."""
        with self._lock:
            warm = sorted(self._warm)
            stats = dict(self._stats)
            in_flight = self._in_flight
        buckets = sorted(self._fns)
        cold = [b for b in buckets if b not in warm]
        saturated = self._max_in_flight is not None \
            and in_flight >= self._max_in_flight
        if saturated:
            status = "saturated"
        elif cold:
            status = "cold"
        elif stats["degraded_serves"] or stats["deadline_misses"] \
                or stats["errors"]:
            status = "degraded"
        else:
            status = "ok"
        snapshot = {"live": True, "ready": not saturated and not cold,
                    "status": status, "in_flight": in_flight,
                    "max_in_flight": self._max_in_flight,
                    "buckets": buckets, "warm_buckets": warm,
                    "cold_buckets": cold}
        snapshot.update(stats)
        return snapshot

    def _bucket(self, n):
        for b in sorted(self._fns):
            if n <= b:
                return b
        raise ValueError(
            "request batch %d exceeds the largest exported bucket %d — "
            "re-export with a larger batch_sizes entry"
            % (n, max(self._fns)))

    # -- admission control ------------------------------------------------
    @property
    def in_flight(self):
        """Live backend work, not callers inside run(): a request whose
        deadline expired keeps its slot until the orphaned worker
        finishes, so a timeout storm cannot stack unbounded work behind
        a cap reading 0."""
        return self._in_flight

    def _acquire_slot(self):
        """Claim an in-flight slot (ServerOverloadedError when full).
        Returns an idempotent release callable; the running work calls
        it on completion, so abandoned deadline workers keep their slot
        until they exit."""
        if self._max_in_flight is None:
            return lambda: None
        with self._lock:
            if self._in_flight >= self._max_in_flight:
                self._stats["sheds"] += 1
                resilience.record_event(
                    "shed", in_flight=self._in_flight,
                    cap=self._max_in_flight)
                raise resilience.ServerOverloadedError(
                    "serving predictor is at its in-flight cap "
                    "(%d) — shedding load; retry with backoff"
                    % self._max_in_flight)
            self._in_flight += 1
        released = []

        def release():
            with self._lock:
                if not released:
                    released.append(True)
                    self._in_flight -= 1
        return release

    # -- request batch / bucket handling ----------------------------------
    def _request_batch(self, inputs):
        """Request batch from the feeds' recorded batch factors (feed i's
        dim0 = factor_i * batch), never from dict order."""
        factors = self._meta["feed_batch_factor"]
        n = None
        for name, f in zip(self._feed_names, factors):
            if f:
                got = np.asarray(inputs[name]).shape[0]
                if got % f:
                    raise ValueError(
                        "feed %r has %d rows, not a multiple of its "
                        "batch factor %d" % (name, got, f))
                if n is None:
                    n = got // f
                elif got // f != n:
                    raise ValueError(
                        "batch-dynamic feeds disagree on batch size: "
                        "feed %r implies batch %d, earlier feeds %d"
                        % (name, got // f, n))
        return n

    def warmup(self, buckets=None):
        """Run (and on the card capture) the given buckets, all by
        default, and mark them warm: run at deploy time so live traffic
        never pays a bucket's first call."""
        for b in sorted(self._fns) if buckets is None else buckets:
            fn = self._fns[b]
            fn([np.zeros(shape, dtype) for shape, dtype in fn.specs])
            self._mark_warm(b)

    def _mark_warm(self, b):
        # orphaned deadline workers finish cold calls in the background
        # and land here concurrently with caller-thread reads
        with self._lock:
            self._warm.add(b)

    def _warm_fallback_bucket(self, n):
        """Smallest warm bucket that fits a batch-n request, or None."""
        with self._lock:
            warm = sorted(self._warm)
        fits = [b for b in warm if b >= (n or 0)]
        return fits[0] if fits else None

    def _call_bucket(self, b, feeds):
        fn = self._fns[b]
        feeds = [np.asarray(a, dtype=dtype)
                 for a, (_, dtype) in zip(feeds, fn.specs)]
        with obs.span("serve.call", bucket=b):
            return fn(feeds)

    def _run_impl(self, inputs, force_bucket=None):
        # injection point: a chaos 'slow' fault sleeps inside the
        # deadline-bounded region; 'error' raises like a dying backend
        actions = resilience.fire("serve", what="ServingPredictor.run")
        if actions.get("slow_s"):
            time.sleep(actions["slow_s"])
        if not self._meta["dynamic_batch"]:
            outs = self._call_bucket(
                0, [np.asarray(inputs[n]) for n in self._feed_names])
            self._mark_warm(0)
            return outs
        factors = self._meta["feed_batch_factor"]
        n = self._request_batch(inputs)
        b = self._bucket(n) if force_bucket is None else force_bucket
        feeds = []
        for name, f in zip(self._feed_names, factors):
            arr = np.asarray(inputs[name])
            if f and arr.shape[0] != b * f:
                pad = [(0, b * f - arr.shape[0])] + \
                    [(0, 0)] * (arr.ndim - 1)
                arr = np.pad(arr, pad)
            feeds.append(arr)
        outs = self._call_bucket(b, feeds)
        self._mark_warm(b)
        # slice batch-scaled outputs per the export-time factors, never
        # guessed from runtime shapes (a static dim that happens to
        # equal b*f must not be truncated)
        fetch_factors = self._meta["fetch_batch_factor"]
        sliced = []
        for o, f in zip(outs, fetch_factors):
            if f and np.ndim(o) > 0 and o.shape[0] == b * f:
                o = o[:n * f]
            sliced.append(o)
        return sliced

    def run(self, inputs, deadline_s=None, degraded_ok=True):
        """inputs: dict name -> array (or a list aligned with the feed
        names). Returns a list of numpy arrays aligned with the fetch
        names.

        deadline_s (defaults to the constructor's): wall-clock budget for
        this request; DeadlineExceededError past it. degraded_ok: a
        deadline miss on a cold bucket falls back to a warm larger
        bucket when one exists (recorded as a 'degraded' event)."""
        if isinstance(inputs, (list, tuple)):
            inputs = dict(zip(self._feed_names, inputs))
        deadline = deadline_s if deadline_s is not None \
            else self._deadline_s
        self._bump("requests")
        parent = obs.current()

        def bounded(what, **impl_kw):
            # the slot is released by the work when it finishes: on a
            # deadline miss the orphaned worker keeps it until then
            release = self._acquire_slot()

            def body():
                try:
                    with obs.span("serve.request", what=what,
                                  **({} if parent is None else
                                     {"trace_id": parent[0],
                                      "parent": parent[1]})):
                        return self._run_impl(inputs, **impl_kw)
                finally:
                    release()
            return resilience.run_with_deadline(body, deadline, what=what)

        try:
            return bounded("serving request")
        except resilience.DeadlineExceededError:
            self._bump("deadline_misses")
            if not degraded_ok or not self._meta["dynamic_batch"]:
                raise
            n = self._request_batch(inputs)
            natural = self._bucket(n)
            fb = self._warm_fallback_bucket(n)
            if natural in self._warm or fb is None:
                raise   # the slot itself is slow, not a cold bucket
            resilience.record_event("degraded", batch=n,
                                    cold_bucket=natural, warm_bucket=fb)
            try:
                out = bounded("degraded serving request", force_bucket=fb)
            except resilience.DeadlineExceededError:
                self._bump("deadline_misses")
                raise
            except Exception:
                # the outer except never sees failures raised inside
                # this handler: count them here, or health() undercounts
                self._bump("errors")
                raise
            self._bump("degraded_serves")
            return out
        except resilience.ServerOverloadedError:
            raise                     # counted where the slot was denied
        except Exception:
            self._bump("errors")
            raise


def load_serving_artifact(dirname, max_in_flight=None, deadline_s=None,
                          place=None):
    return ServingPredictor(dirname, max_in_flight=max_in_flight,
                            deadline_s=deadline_s, place=place)


__all__ = ["ServingPredictor", "export_serving_artifact",
           "infer_batch_factors", "load_serving_artifact",
           "SERVING_FORMAT_VERSION", "WEIGHTS_FILE", "WEIGHTS_Q8_FILE"]
