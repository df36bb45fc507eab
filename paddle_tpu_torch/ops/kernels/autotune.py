"""Sweeps of the kernels' launch configs, and the cache that banks them.

Counterpart of paddle_tpu/ops/pallas/autotune.py. A hand-written
kernel's launch config (costmodel.py lists each family's knobs) wins only
for the (op, shape, dtype, topology, card) it was measured on, so the
sweep and the kernels ship together. For one (op, shape, dtype) this
module:

  1. enumerates the family's candidates (``CANDIDATES``; ``{}`` is the
     kernel's default launch),
  2. optionally prunes them through the cost model (``top_k=K``
     measures the K best-predicted ones; ``cost_model_only`` measures
     none and banks the prediction),
  3. runs each surviving candidate once and holds its outputs against
     the plain version on the same inputs (the tolerances below): a
     candidate outside them is "failed" and never banked,
  4. times the survivors with CUDA events, in ``probes`` rounds of one
     run of each, and keeps each one's best (a deadline per candidate).
     A run replays a CUDA graph of back-to-back calls, as the Executor
     replays a step: the wrapper's host work (checks, allocation, the
     config's resolution) is not in it, only the kernels,
  5. times the library call PERF.md names for the op (``library_s``),
     a yardstick and never a verdict: the port runs no library kernel,
  6. banks the winner and every candidate's seconds in a versioned JSON
     cache keyed like the Executor's step (``kernel_dispatch.cache_key``);
     the per-candidate rows are what the cost model fits. On a CUDA
     backend an entry's impl is always "pallas": there is no second
     lowering to fall back to.

``CompiledProgram`` reads the cache through ``BuildStrategy.
pallas_tune_cache`` (or the banked ``paddle_tpu_torch/tools/tuned/
<card>.json`` under ``kernel_policy="auto"``); ``tools/autotune.py`` is
the CLI and ``tools/tunecheck.py`` validates a banked file.

torch is imported inside the functions that need it.
"""
import hashlib
import json
import os
import time

from . import costmodel as cm
from .. import kernel_dispatch as kd

DEFAULT_CACHE_ENV = "PADDLE_TPU_TORCH_TUNE_CACHE"

#: banked-cache JSON format (the AutotuneCache envelope): bump on schema
#: breaks. Unknown versions load empty and fail tools/tunecheck.py.
FORMAT_VERSION = 1

#: candidate launch configs per op; ``{}`` is the kernel's default, and
#: a knob left out keeps its default (costmodel.resolve). A candidate a
#: call cannot take (a head's bf16 forward at 2 stages) is dropped by the
#: ranking and failed by the sweep; one that resolves to an earlier
#: candidate's launch (the f32 head at 3 stages, its default) is not
#: swept. The grid knobs are arguments of one instance; CE's 512 threads
#: and the head's other ring depth are one instance each.
CANDIDATES = {
    "softmax_with_cross_entropy": [{}, {"threads": 512}],
    "adam": [{}, {"blocks_per_sm": 2}, {"blocks_per_sm": 4},
             {"blocks_per_sm": 8}],
    "layer_norm": [{}, {"blocks_per_sm": 1}, {"blocks_per_sm": 4},
                   {"blocks_per_sm": 8}],
    "fused_mlm_head_loss": [{}, {"stages": 2}, {"stages": 3}],
}

#: a compile's cost model predicts a config for a never-swept shape only
#: from a segment fitted over rows of at least this many shapes
#: (costmodel.CostModel predict_min_shapes); elsewhere the call keeps its
#: kernel's default launch
PREDICT_MIN_SHAPES = 2

#: tiny shapes of ``--dry-run`` (the harness end to end, on any device)
DRY_SHAPES = {
    "softmax_with_cross_entropy": (32, 128),
    "adam": (2048,),
    "layer_norm": (32, 128),
    "fused_mlm_head_loss": (32, 256),
}
DRY_HEAD_D = 64

#: the sweep shapes a banked file covers (the JAX package's, its
#: ERNIE-base headline geometry); the head's at D = HEAD_D
DEFAULT_SHAPES = {
    "softmax_with_cross_entropy": (2560, 32768),
    "adam": (1024 * 1024,),
    "layer_norm": (16384, 768),
    "fused_mlm_head_loss": (2560, 32768),
}
HEAD_D = cm.HEAD_D

# A candidate's outputs against the plain version's on the same inputs
# (chip_smoke.py's kernel tolerances, with their reasons there): LayerNorm
# y and dx absolute (f32 a few ulps of values of order 1; bf16 one bf16
# ulp of values up to 4-8), dscale/dbias relative to their largest
# magnitude; CE and head losses absolute (values ~10), gradients relative
# to their largest magnitude; Adam each output relative to its own change
# in the step plus one ulp of its dtype.
TOL = {
    ("layer_norm", "float32"): (1e-4, 1e-4, 5e-5),
    ("layer_norm", "bfloat16"): (6.25e-2, 1.6e-2, 5e-5),
    ("softmax_with_cross_entropy", "float32"): (1e-4, 1e-6),
    ("softmax_with_cross_entropy", "bfloat16"): (1e-4, 2.0 ** -8),
    ("fused_mlm_head_loss", "float32"): (1e-4, 5e-5),
    ("fused_mlm_head_loss", "bfloat16"): (1e-4, 2.0 ** -7),
    "adam": 1e-4,
}


def candidates_for(op):
    """The candidate space prediction and sweeps rank over."""
    return CANDIDATES.get(op, [])


_SEL_FP = None


def selection_fingerprint():
    """Identity of the selection machinery (cost-model version and the
    candidate space): part of the compile token, so changing either
    re-plans."""
    global _SEL_FP
    if _SEL_FP is None:
        h = hashlib.sha1()
        h.update(b"model-v%d|min-shapes-%d|" % (cm.MODEL_VERSION,
                                                 PREDICT_MIN_SHAPES))
        h.update(json.dumps(CANDIDATES, sort_keys=True).encode())
        _SEL_FP = h.hexdigest()[:12]
    return _SEL_FP


def default_cache_path():
    env = os.environ.get(DEFAULT_CACHE_ENV)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "paddle_tpu_torch", "kernel_autotune.json")


def tuned_dir():
    """The banked-cache directory, ``paddle_tpu_torch/tools/tuned/``."""
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "tools", "tuned")


def banked_cache_path(backend):
    """The committed cache of one card (``tools/tuned/<backend>.json``)."""
    return os.path.join(tuned_dir(), str(backend) + ".json")


class AutotuneCache(object):
    """Versioned JSON-file persistence of sweep results.

    On-disk envelope (``FORMAT_VERSION``):
    ``{"format_version": 1, ...meta..., "entries": {key: entry}}`` where
    key is ``kernel_dispatch.cache_key`` and entry is ``{"impl":
    "pallas"|"pallas_q"|"xla", "config": {...}|None, "pallas_s": the
    kernel's best seconds (the JAX package's field name), "library_s":
    the yardstick's, "results": {tag: seconds}, ...}``. A legacy flat
    ``{key: entry}`` file still loads; every save writes the envelope.

    Loads lazily and re-reads on a file-stat change; :meth:`save` merges
    across processes: it re-reads the file, overlays only this object's
    unsaved puts and replaces it atomically, so concurrent sweeps keep
    each other's keys. A missing, torn or future-versioned file loads
    empty (tunecheck is where it fails loudly)."""

    def __init__(self, path=None, meta=None):
        self.path = path or default_cache_path()
        self._data = None
        self.meta = dict(meta or {})
        self._dirty = {}
        self._loaded_stat = None

    @staticmethod
    def parse_blob(raw):
        """(entries, meta) from a parsed JSON blob. An unknown format
        version gives empty entries with the meta kept."""
        if not isinstance(raw, dict):
            return {}, {}
        if "format_version" in raw:
            meta = {k: v for k, v in raw.items() if k != "entries"}
            try:
                ver = int(raw["format_version"])
            except (TypeError, ValueError):
                ver = None
            entries = raw.get("entries")
            if ver != FORMAT_VERSION or not isinstance(entries, dict):
                return {}, meta
            return dict(entries), meta
        return dict(raw), {}

    def _stat(self):
        try:
            st = os.stat(self.path)
            return (st.st_mtime_ns, st.st_size)
        except OSError:
            return None

    def _read_disk(self):
        try:
            with open(self.path) as f:
                return self.parse_blob(json.load(f))
        except (OSError, ValueError):
            return {}, {}

    def load(self):
        """The entries, re-read when the file changed on disk, unless this
        object holds unsaved puts."""
        st = self._stat()
        if self._data is None or (not self._dirty and
                                  st != self._loaded_stat):
            self._data, file_meta = self._read_disk()
            if file_meta:
                merged = dict(file_meta)
                merged.update(self.meta)
                self.meta = merged
            self._loaded_stat = st
        return self._data

    def lookup(self, key):
        return self.load().get(key)

    def put(self, key, entry):
        self.load()[key] = entry
        self._dirty[key] = entry

    def save(self):
        self.load()
        d = os.path.dirname(os.path.abspath(self.path))
        if d and not os.path.isdir(d):
            os.makedirs(d, exist_ok=True)
        disk_entries, disk_meta = self._read_disk()
        merged = dict(disk_entries)
        if self._dirty:
            merged.update(self._dirty)
        else:
            merged.update(self._data or {})
        meta = dict(disk_meta)
        meta.update(self.meta)
        meta.pop("format_version", None)
        blob = {"format_version": FORMAT_VERSION}
        blob.update(sorted(meta.items()))
        blob["entries"] = merged
        tmp = self.path + ".tmp.%d" % os.getpid()
        with open(tmp, "w") as f:
            json.dump(blob, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        self._data = merged
        self._dirty = {}
        self._loaded_stat = self._stat()
        return self.path

    def __len__(self):
        return len(self.load())


def fit_cost_model(cache=None, predict_min_shapes=0):
    """A :class:`costmodel.CostModel` over ``CANDIDATES``, fit from every
    measured row ``cache`` banked (analytic only when there is none);
    ``predict_min_shapes`` as the model's (a compile passes
    :data:`PREDICT_MIN_SHAPES`)."""
    model = cm.CostModel(candidates={op: candidates_for(op)
                                     for op in CANDIDATES},
                         predict_min_shapes=predict_min_shapes)
    if cache is not None:
        model.fit_cache(cache)
    return model


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

_FILL_S = 5e-3           # a probe's back-to-back calls fill about this
_MAX_REPS = 16           # calls a captured graph holds (their outputs too)


def time_fn(fn, probes, deadline_s, device):
    """Best-of-``probes`` seconds of one ``fn()``, after one untimed call.
    On a card: ``fn`` is captured ``reps`` times into one CUDA graph
    (enough calls to fill ~5 ms, at most _MAX_REPS) and each probe is CUDA
    events around one replay, so only the kernels are timed, as a
    replayed step runs them. On the CPU: the host clock around
    back-to-back calls. None when the candidate overruns its deadline
    before a probe finished."""
    import torch
    t_start = time.perf_counter()
    t0 = time.perf_counter()
    fn()
    if device.type != "cuda":
        once = time.perf_counter() - t0
        reps = max(1, min(200, int(_FILL_S / max(once, 1e-7))))

        def timed():
            t1 = time.perf_counter()
            for _ in range(reps):
                fn()
            return (time.perf_counter() - t1) / reps
    else:
        torch.cuda.synchronize(device)
        once = time.perf_counter() - t0
        reps = max(1, min(_MAX_REPS, int(_FILL_S / max(once, 1e-7))))
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn()                       # a warm-up on a side stream
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)

        def timed():
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3 / reps
    best = None
    for _ in range(max(1, probes)):
        if best is not None and time.perf_counter() - t_start > deadline_s:
            break
        dt = timed()
        best = dt if best is None else min(best, dt)
    return best


def _max_rel(got, want):
    scale = float(want.abs().max())
    return float((got.float() - want.float()).abs().max()) / max(scale,
                                                                 1e-30)


def _max_abs(got, want):
    return float((got.float() - want.float()).abs().max())


class _Workload(object):
    """One (op, shape, dtype)'s inputs on ``device`` and three closures:
    ``run(config)`` the timed unit (forward and backward; Adam one
    update), ``check(config)`` -> (ok, max_abs_err of the primary
    output) against the plain version, and ``library`` (or None)."""

    def __init__(self, op, shape, dtype, device, d, seed=0):
        import numpy as np
        import torch
        from . import blockwise_ce as bce
        from . import fused_adam as fad
        from . import layer_norm as ln
        self.op = op
        rng = np.random.RandomState(seed)
        tdt = getattr(torch, dtype)

        def t(a, dt=tdt):
            return torch.as_tensor(np.asarray(a, np.float32)).to(
                device=device, dtype=dt)
        if op == "layer_norm":
            rows, cols = shape
            x = t(rng.randn(rows, cols))
            sc = t(1.0 + 0.1 * rng.randn(cols), torch.float32)
            bi = t(0.1 * rng.randn(cols), torch.float32)
            g = t(rng.randn(rows, cols))
            tol = TOL[(op, dtype)]

            def run(config):
                y, mean, rstd = ln.layer_norm(x, sc, bi, 1e-5, config)
                return ln.layer_norm_bwd(x, g, sc, mean, rstd, config)

            def check(config):
                y, mean, rstd = ln.layer_norm(x, sc, bi, 1e-5, config)
                dx, ds, db = ln.layer_norm_bwd(x, g, sc, mean, rstd, config)
                py, pm, pr = ln.layer_norm_plain(x, sc, bi, 1e-5)
                pdx, pds, pdb = ln.layer_norm_bwd_plain(x, g, sc, pm, pr)
                err = _max_abs(y, py)
                ok = err <= tol[0] and _max_abs(dx, pdx) <= tol[1] and \
                    _max_rel(ds, pds) <= tol[2] and \
                    _max_rel(db, pdb) <= tol[2]
                return ok, err
            xl = x.detach().clone().requires_grad_(True)
            scl = sc.detach().clone().requires_grad_(True)
            bil = bi.detach().clone().requires_grad_(True)

            def library():
                y = torch.nn.functional.layer_norm(
                    xl, (cols,), scl.to(tdt), bil.to(tdt), 1e-5)
                torch.autograd.grad(y, (xl, scl, bil), g)
        elif op == "softmax_with_cross_entropy":
            rows, v = shape
            x = t(rng.randn(rows, v))
            lab = torch.as_tensor(rng.randint(0, v, rows)).to(device)
            dl = t(rng.rand(rows), torch.float32)
            tol = TOL[(op, dtype)]

            def run(config):
                loss, lse = bce.softmax_ce(x, lab, config)
                return bce.softmax_ce_bwd(x, lab, lse, dl, config)

            def check(config):
                loss, lse = bce.softmax_ce(x, lab, config)
                dx = bce.softmax_ce_bwd(x, lab, lse, dl, config)
                pl, plse = bce.softmax_ce_plain(x, lab)
                pdx = bce.softmax_ce_bwd_plain(x, lab, plse, dl)
                err = _max_abs(loss, pl)
                ok = err <= tol[0] and _max_abs(lse, plse) <= tol[0] and \
                    _max_abs(dx, pdx) <= tol[1]
                return ok, err
            xl = x.detach().clone().requires_grad_(True)

            def library():
                loss = torch.nn.functional.cross_entropy(
                    xl, lab, reduction="none")
                torch.autograd.grad(loss, xl, dl.to(loss.dtype))
        elif op == "fused_mlm_head_loss":
            rows, v = shape
            h = t(0.3 * rng.randn(rows, d))
            w = t(0.2 * rng.randn(v, d))
            b = t(0.1 * rng.randn(v), torch.float32)
            lab = torch.as_tensor(rng.randint(0, v, rows)).to(device)
            dl = t(rng.rand(rows), torch.float32)
            tol = TOL[(op, dtype)]

            def run(config):
                loss, lse = bce.fused_head_loss(h, w, lab, b, config)
                return bce.fused_head_bwd(h, w, lab, b, lse, dl)

            def check(config):
                loss, lse = bce.fused_head_loss(h, w, lab, b, config)
                dh, dw, db = bce.fused_head_bwd(h, w, lab, b, lse, dl)
                pl, plse = bce.fused_head_loss_plain(h, w, lab, b)
                pdh, pdw, pdb = bce.fused_head_bwd_plain(h, w, lab, b,
                                                         plse, dl)
                err = _max_abs(loss, pl)
                ok = err <= tol[0] and _max_abs(lse, plse) <= tol[0] and \
                    _max_rel(dh, pdh) <= tol[1] and \
                    _max_rel(dw, pdw) <= tol[1] and \
                    _max_rel(db, pdb) <= tol[1]
                return ok, err
            hl = h.detach().clone().requires_grad_(True)
            wl = w.detach().clone().requires_grad_(True)
            bl = b.detach().clone().requires_grad_(True)

            def library():
                s = torch.matmul(hl, wl.t()).float() + bl
                loss = torch.nn.functional.cross_entropy(
                    s, lab, reduction="none")
                torch.autograd.grad(loss, (hl, wl, bl), dl)
        elif op == "adam":
            n = int(np.prod(shape))
            p0 = t(rng.randn(n))
            g = t(rng.randn(n), torch.float32)
            m10 = t(0.1 * rng.randn(n), torch.float32)
            m20 = t(0.01 * rng.rand(n), torch.float32)
            lr = t([1e-3], torch.float32)
            b1p = t([0.9 ** 3], torch.float32)
            b2p = t([0.999 ** 3], torch.float32)
            # timing copies of the state, used in turn, enough that their
            # bytes are twice the L2: each call finds its state in HBM, as
            # a step's update does
            copies = max(1, min(8, -(-2 * cm.L2_BYTES // (
                n * (cm.ES[dtype] + 12)))))
            live = [(p0.clone(), g.clone(), m10.clone(), m20.clone())
                    for _ in range(copies)]
            turn = [0]

            def run(config):
                # in place: each call is one step of the next copy
                p, g_, m1, m2 = live[turn[0] % copies]
                turn[0] += 1
                return fad.fused_adam(p, g_, m1, m2, lr, b1p, b2p,
                                      config=config)

            def check(config):
                p, m1, m2 = fad.fused_adam(p0.clone(), g, m10.clone(),
                                           m20.clone(), lr, b1p, b2p,
                                           config=config)
                want = fad.fused_adam_plain(p0, g, m10, m20, lr, b1p, b2p)
                ok = True
                for got, w_, old in zip((p, m1, m2), want, (p0, m10, m20)):
                    change = float((w_.float() - old.float()).abs().max())
                    ulp = float(torch.finfo(w_.dtype).eps) * float(
                        w_.float().abs().max())
                    ok = ok and _max_abs(got, w_) <= \
                        TOL["adam"] * change + ulp
                return ok, _max_abs(p, want[0])
            library = None
            if device.type == "cuda":
                opts = []
                for _ in range(copies):
                    lib_p = p0.clone().requires_grad_(True)
                    lib_p.grad = g.to(tdt)
                    opts.append(torch.optim.Adam([lib_p], lr=1e-3,
                                                 fused=True, capturable=True))

                def library():
                    opts[turn[0] % copies].step()
                    turn[0] += 1
        else:
            raise ValueError("no autotune workload for op %r" % op)
        self.run, self.check, self.library = run, check, library


def autotune_op(op, shape, dtype="float32", probes=3, device=None,
                cache=None, candidates=None, mesh_axes=None, backend=None,
                candidate_deadline_s=120.0, top_k=None, cost_model=None,
                cost_model_only=False, d=None, timer=None):
    """Tune one (op, shape, dtype): rank every candidate through the cost
    model, check and time the ``top_k`` best-predicted ones (None: all)
    and the library yardstick, bank the winner and every candidate's
    seconds under the Executor-style key, and return the summary dict.

    ``device``: the torch device the kernels run on (default the card);
    ``d``: the head's hidden width (default HEAD_D); ``cost_model_only``
    measures nothing and banks the top-ranked predicted config (entry
    ``source: "costmodel"``); ``cost_model`` injects a fitted model
    (default: fit from ``cache``); ``timer(config, fn, probes,
    deadline_s)`` replaces the CUDA-event timer (config None for the
    library call; tests inject a deterministic one).

    Per-candidate summary rows: ``{tag: {"predicted_s", "source",
    "measured_s", "status", "max_abs_err"}}`` with status "ok" |
    "failed" | "pruned"."""
    import torch
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if backend is None:
        backend = kd.backend_name(device)
    if cache is None:
        cache = AutotuneCache()
    if op == "fused_mlm_head_loss" and d is None:
        d = HEAD_D
    shape = tuple(int(s) for s in shape)
    if candidates is None:
        candidates = candidates_for(op)
    launches, unique = [], []
    for config in candidates:
        # a config that resolves to an earlier one's launch is that launch
        try:
            launch = cm.resolve(op, shape, config, dtype, d)
        except cm.KernelConfigError:
            launch = None
        if launch is None or launch not in launches:
            unique.append(config)
            if launch is not None:
                launches.append(launch)
    candidates = unique
    model = cost_model
    if model is None and (top_k or cost_model_only):
        model = fit_cost_model(cache)
    results = {}
    predicted = {}
    if model is not None:
        for cfg, sec, src in model.rank(op, shape, candidates,
                                        backend=backend, dtype=dtype, d=d):
            predicted[cm.config_tag(cfg)] = (sec, src)
    for config in candidates:
        tag = cm.config_tag(config)
        sec_src = predicted.get(tag)
        results[tag] = {
            "predicted_s": round(sec_src[0], 9) if sec_src else None,
            "source": sec_src[1] if sec_src else None,
            "measured_s": None, "max_abs_err": None,
            "status": "pruned" if (top_k or cost_model_only) else
                      "pending"}
    key = kd.cache_key(op, shape, dtype, mesh_axes, backend)
    extra = {"hidden": int(d)} if d is not None else {}
    if cost_model_only:
        ranked = model.top_k(op, shape, candidates, k=1, backend=backend,
                             dtype=dtype, d=d)
        entry = dict({
            "impl": "pallas",
            "config": (ranked[0][0] or None) if ranked else None,
            "pallas_s": None, "library_s": None, "probes": 0,
            "backend": backend,
            "predicted_s": round(ranked[0][1], 9) if ranked else None,
            "source": "costmodel"}, **extra)
        cache.put(key, entry)
        cache.save()
        return {"op": op, "key": key, "entry": entry, "results": results,
                "cache": cache.path, "candidates_total": len(candidates),
                "candidates_measured": 0, "top_k": top_k}
    if top_k:
        measure = [c for c, _s, _src in model.top_k(
            op, shape, candidates, k=top_k, backend=backend, dtype=dtype,
            d=d)] or list(candidates)
    else:
        measure = list(candidates)

    timer = timer or (lambda _cfg, fn, n, dl: time_fn(fn, n, dl, device))
    work = _Workload(op, shape, dtype, device, d)
    alive = []
    for config in measure:
        tag = cm.config_tag(config)
        row = results.setdefault(tag, {"predicted_s": None, "source": None})
        row["measured_s"], row["status"] = None, "failed"
        if not cm.feasible(op, shape, config, dtype, d):
            continue
        # a candidate whose launch fails or whose outputs leave the
        # tolerance is failed and never banked
        try:
            ok, err = work.check(config)
        except (RuntimeError, ValueError) as e:
            row["error"] = "%s: %s" % (type(e).__name__, e)
            continue
        row["max_abs_err"] = err
        if ok:
            alive.append(config)
    # the survivors are timed in rounds, one probe of each a round, so a
    # drift of the card's clocks over the sweep favours none of them
    best_of, spent = {}, {}
    for _ in range(max(1, probes)):
        for config in alive:
            tag = cm.config_tag(config)
            if spent.get(tag, 0.0) > candidate_deadline_s:
                continue
            t0 = time.perf_counter()
            dt = timer(config, lambda c=config: work.run(c), 1,
                       candidate_deadline_s)
            spent[tag] = spent.get(tag, 0.0) + time.perf_counter() - t0
            if dt is not None:
                best_of[tag] = min(dt, best_of.get(tag, dt))
    best_cfg, best_s = None, None
    measured_rows = {}
    for config in alive:
        tag = cm.config_tag(config)
        if tag not in best_of:
            continue
        dt = best_of[tag]
        results[tag]["measured_s"], results[tag]["status"] = \
            round(dt, 9), "ok"
        measured_rows[tag] = round(dt, 9)
        if best_s is None or dt < best_s:
            best_cfg, best_s = dict(config), dt
    for row in results.values():
        if row.get("status") == "pending":
            row["status"] = "failed"
    library_s = None
    if work.library is not None:
        library_s = timer(None, work.library, probes, candidate_deadline_s)
    best_pred = predicted.get(cm.config_tag(best_cfg)) if best_cfg \
        is not None else None
    entry = dict({
        "impl": "pallas",
        "config": best_cfg or None,
        "pallas_s": round(best_s, 9) if best_s is not None else None,
        "library_s": round(library_s, 9) if library_s is not None
        else None,
        "probes": probes, "backend": backend, "results": measured_rows,
        "source": "sweep"}, **extra)
    if best_pred is not None:
        entry["predicted_s"] = round(best_pred[0], 9)
    cache.put(key, entry)
    cache.save()
    return {"op": op, "key": key, "entry": entry, "results": results,
            "cache": cache.path, "candidates_total": len(candidates),
            "candidates_measured": len(measure), "top_k": top_k}


def best_within(pruned, exhaustive, rel=0.03):
    """Whether a pruned sweep's winner is the exhaustive sweep's, or
    within ``rel`` of it as the exhaustive sweep timed both (summaries
    of autotune_op on one key)."""
    won = pruned["entry"]["config"]
    rows = exhaustive["entry"]["results"]
    best = exhaustive["entry"]["pallas_s"]
    if won == exhaustive["entry"]["config"]:
        return True
    got = rows.get(cm.config_tag(won))
    return got is not None and best is not None and got <= best * (1 + rel)
