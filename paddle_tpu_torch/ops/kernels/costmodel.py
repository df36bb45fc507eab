"""Analytic and fitted cost model of the port's kernel launch configs.

Counterpart of paddle_tpu/ops/pallas/costmodel.py. The fitted half is
the JAX package's: a least-squares fit of measured seconds over a small
feature basis, one weight vector per (kernel family, backend) segment,
from every ``(key, config, seconds)`` row an
:class:`~.autotune.AutotuneCache` banked; :meth:`CostModel.rank`,
:meth:`CostModel.top_k` (the pruned sweep) and
:meth:`CostModel.predict_config` (a config for a never-swept shape).

The analytic half is this card's. Each family's launch config is what
its CUDA kernel takes at launch (csrc/*.cu headers); the size guards
below are the single source of truth for which configs a call can take,
and the kernel wrappers refuse by name (:class:`KernelConfigError`)
what they do not accept:

- ``adam``: ``blocks_per_sm``, the grid-stride grid's cap (1-64);
  default 16.
- ``layer_norm``: ``blocks_per_sm`` of the persistent grid (1-8);
  default the plan's own (2 forward and 1 backward in the warp tier).
- ``softmax_with_cross_entropy``: ``threads`` a row's block (256 or
  512); default 256.
- ``fused_mlm_head_loss``: the forward's ring ``stages`` (f32 2 or 3,
  bf16 3 or 4; default 3 and 4); D runs to 1024. The backward kernels
  take no config: their tiles follow D. Head keys are (tokens, vocab),
  as the JAX package keys them; D comes from the call site (``d``),
  else :data:`HEAD_D`.

Features per (op, shape, config, dtype): blocks, waves over the SMs,
shared memory a block, threads a block, HBM bytes of one forward and
backward (Adam: one update), FLOPs (the head) and padding waste. The
no-data proxy is ``max(bytes / 3.35 TB/s, flops / peak)`` over the share
of the card the launch keeps busy (wave quantisation, and for the
bandwidth-bound kernels the bytes in flight), plus a per-wave overhead;
peaks are PERF.md's: f32 at 495/3 TFLOP/s (3xTF32), bf16 at 989.

numpy and the standard library only: ``ops/kernel_dispatch.py`` and
``framework/compiler.py`` consult the model without importing torch's
kernel modules.
"""
import hashlib
import json
import math

import numpy as np

#: bumped whenever the feature map or the fit changes shape: part of the
#: Executor's compile token and of the banked cache's meta
MODEL_VERSION = 1

SMS = 132
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
THREADS_PER_SM = 2048
WAVE_S = 2e-6                        # a wave's start and drain
LAUNCH_S = 3e-6                      # a launch's own cost
#: bytes in flight an SM needs to reach the memory rate
INFLIGHT_BYTES_SM = 32 * 1024
L2_BYTES = 50 * 2 ** 20

#: assumed hidden size of the head when the call site gives no D
HEAD_D = 768

ES = {"float32": 4, "bfloat16": 2}        # bytes an element


class KernelConfigError(ValueError):
    """A launch config that its kernel does not take for this call."""


def _dtype(dtype):
    d = str(dtype).replace("torch.", "")
    return d if d in ES else None


def _cdiv(a, b):
    return -(-int(a) // int(b))


# ---------------------------------------------------------------------------
# the kernels' size guards: a config completed with its defaults, or None
# ---------------------------------------------------------------------------

ADAM_THREADS = 256
ADAM_DEFAULT = {"blocks_per_sm": 16}
CE_THREADS = (256, 512)
CE_DEFAULT = {"threads": 256}
LN_ROW_WARPS = 8
LN_MAX_BLOCKS_PER_SM = 8
LN_WARP_TIER_COLS = 1024
HEAD_STAGES = {"float32": (2, 3), "bfloat16": (3, 4)}
HEAD_DEFAULT_STAGES = {"float32": 3, "bfloat16": 4}
HEAD_MAX_D = 1024
_HEAD_WARPS = 8

_KNOBS = {"adam": ("blocks_per_sm",),
          "layer_norm": ("blocks_per_sm",),
          "softmax_with_cross_entropy": ("threads",),
          "fused_mlm_head_loss": ("stages",)}


def head_tiles(d):
    """The backward's (mt, nt), which D alone picks (fused_head_bwd.cu
    launch_d)."""
    if d <= 256:
        return 2, 4
    if d <= 512:
        return 2, 8
    if d <= 768:
        return 2, 12
    return 1, 16


def head_fwd_smem(dtype, stages):
    """Shared bytes of a head forward block (fused_head_fwd.cu Cfg)."""
    planes = 2 if dtype == "float32" else 1
    return stages * 2 * planes * 128 * 128 + 1024


def _knobs(op, config):
    cfg = dict(config or {})
    unknown = sorted(set(cfg) - set(_KNOBS.get(op, ())))
    if unknown:
        raise KernelConfigError(
            "%s takes no launch knob %s (its knobs: %s)"
            % (op, ", ".join(unknown), ", ".join(_KNOBS.get(op, ()))))
    for k, v in cfg.items():
        if not isinstance(v, (int, np.integer)) or isinstance(v, bool):
            raise KernelConfigError("%s config %r: %s must be an integer"
                                    % (op, config, k))
    return {k: int(v) for k, v in cfg.items()}


def resolve(op, shape, config, dtype="float32", d=None):
    """``config`` completed with the kernel's defaults for a call of
    ``shape`` and ``dtype`` (the head's hidden width ``d``), or
    KernelConfigError naming what does not fit. LayerNorm's
    ``blocks_per_sm`` stays absent when not given: the plan picks it."""
    dt = _dtype(dtype)
    cfg = _knobs(op, config)
    shape = tuple(int(s) for s in shape)
    if dt is None:
        raise KernelConfigError("%s has no kernel for dtype %s"
                                % (op, dtype))
    if op == "adam":
        out = dict(ADAM_DEFAULT, **cfg)
        if not 1 <= out["blocks_per_sm"] <= 64:
            raise KernelConfigError(
                "adam config %r: blocks_per_sm must be 1-64" % (config,))
        return out
    if op == "softmax_with_cross_entropy":
        out = dict(CE_DEFAULT, **cfg)
        if out["threads"] not in CE_THREADS:
            raise KernelConfigError(
                "softmax_with_cross_entropy config %r: threads must be "
                "one of %s" % (config, CE_THREADS))
        return out
    if op == "layer_norm":
        out = dict(cfg)
        if not 1 <= out.get("blocks_per_sm", 1) <= LN_MAX_BLOCKS_PER_SM:
            raise KernelConfigError(
                "layer_norm config %r: blocks_per_sm must be 1-%d"
                % (config, LN_MAX_BLOCKS_PER_SM))
        return out
    if op == "fused_mlm_head_loss":
        d = HEAD_D if d is None else int(d)
        out = dict({"stages": HEAD_DEFAULT_STAGES[dt]}, **cfg)
        if out["stages"] not in HEAD_STAGES[dt]:
            raise KernelConfigError(
                "fused_mlm_head_loss config %r: a %s forward takes %s "
                "stages" % (config, dt, HEAD_STAGES[dt]))
        if d > HEAD_MAX_D:
            raise KernelConfigError(
                "fused_mlm_head_loss config %r: the call's hidden width %d "
                "is above the kernels' %d" % (config, d, HEAD_MAX_D))
        return out
    raise KernelConfigError("no launch config for op %r" % op)


def feasible(op, shape, config, dtype="float32", d=None):
    try:
        resolve(op, shape, config, dtype, d)
        return True
    except KernelConfigError:
        return False


# ---------------------------------------------------------------------------
# analytic features
# ---------------------------------------------------------------------------

def _ln_default_bps(cols, es, backward):
    """_ln_plan's blocks an SM for the warp tier (ops/kernels/
    layer_norm.py): two forward blocks while a lane holds up to 24
    values, else one."""
    vec = 16 // es if cols % (16 // es) == 0 else 1
    k = _cdiv(cols, 32 * vec)
    for r in (1, 2, 3, 4, 6, 8, 16, 32):
        if r >= k:
            k = r
            break
    return 1 if backward or k * vec > 24 else 2, k * vec


def features(op, shape, config, dtype="float32", d=None):
    """Feature dict for one (op, shape, config, dtype), or None when the
    config cannot run the call (:func:`resolve`):

      blocks      -- blocks launched over the op's forward and backward
      waves       -- rounds of resident blocks those take
      smem        -- shared bytes of the largest block
      threads     -- threads a block (the largest)
      total_bytes -- HBM bytes read and written
      flops       -- operations (the head's products; else the
                     elementwise work, which never bounds)
      pad_waste   -- padded / real work - 1
      busy        -- share of the card the launch keeps at work
    """
    try:
        cfg = resolve(op, shape, config, dtype, d)
    except KernelConfigError:
        return None
    dt = _dtype(dtype)
    es = ES[dt]
    shape = tuple(int(s) for s in shape)
    if op == "adam":
        n = int(np.prod(shape, dtype=np.int64))
        th, bps = ADAM_THREADS, cfg["blocks_per_sm"]
        work = _cdiv(n, 4) if dt == "float32" else n
        blocks = max(1, min(_cdiv(work, th), SMS * bps))
        resident = min(THREADS_PER_SM // th, 32)
        waves = _cdiv(blocks, SMS * resident)
        live = min(blocks, SMS * resident) * th
        busy = min(1.0, live / float(SMS * THREADS_PER_SM))
        return {"blocks": blocks, "waves": waves, "smem": 0,
                "threads": th, "total_bytes": n * (2 * es + 20),
                "flops": 12 * n, "pad_waste": 0.0,
                "busy": max(busy, 0.05)}
    if op == "softmax_with_cross_entropy":
        if len(shape) != 2:
            return None
        t, v = shape
        th = cfg["threads"]
        resident = min(THREADS_PER_SM // th, 32)
        waves = _cdiv(t, SMS * resident)
        # the last wave's share of rows, and each row's serial tail (the
        # merge over the block's warps) against its streaming
        quant = t / float(waves * SMS * resident)
        per_row = v * es * 3 / HBM_BYTES_S * SMS * resident
        tail = (th // 32) * 2e-8 / max(per_row, 1e-9)
        return {"blocks": 2 * t, "waves": 2 * waves, "smem": 8 * (th // 32),
                "threads": th, "total_bytes": 3 * t * v * es + 16 * t,
                "flops": 4 * t * v, "pad_waste": 0.0,
                "busy": max(quant / (1.0 + tail), 0.05)}
    if op == "layer_norm":
        if len(shape) != 2:
            return None
        rows, cols = shape
        rw = LN_ROW_WARPS
        vals = []
        blocks = waves = 0
        busy = 1.0
        for backward in (False, True):
            bps_default, per_lane = _ln_default_bps(cols, es, backward)
            if cols > LN_WARP_TIER_COLS:
                team = 2
                while 32 * team * 32 < cols:
                    team *= 2
                th = 32 * team
                bps = cfg.get("blocks_per_sm", max(1, 256 // th))
                grid = max(1, min(rows, bps * SMS))
                resident = max(1, 256 // th)
            else:
                th = 32 * rw
                bps = cfg.get("blocks_per_sm", bps_default)
                grid = max(1, min(_cdiv(rows, rw), bps * SMS))
                # registers: the forward keeps 512 threads an SM while a
                # lane holds up to 24 values, else 256, as the backward
                res_threads = 512 if not backward and per_lane <= 24 \
                    else 256
                resident = max(1, res_threads // th)
            w = _cdiv(grid, SMS * resident)
            live_warps = min(grid, SMS * resident) * th // 32
            inflight = live_warps * (1 if th > 256 else 2) * cols * es * \
                (2 if backward else 1)
            busy = min(busy, min(1.0, inflight / float(
                SMS * INFLIGHT_BYTES_SM)))
            vals.append(grid)
            blocks += grid
            waves += w
        grid_bwd = vals[1]
        total = 5 * rows * cols * es + 2 * 2 * grid_bwd * cols * 4
        return {"blocks": blocks, "waves": waves,
                "smem": 32 * 1024, "threads": 32 * rw,
                "total_bytes": total, "flops": 20 * rows * cols,
                "pad_waste": 0.0, "busy": max(busy, 0.05)}
    if op == "fused_mlm_head_loss":
        if len(shape) != 2:
            return None
        t, v = shape
        d = HEAD_D if d is None else int(d)
        (mt, nt), st = head_tiles(d), cfg["stages"]
        dp = _HEAD_WARPS * 8 * nt
        br = 16 * mt
        fwd_tiles = _cdiv(t, 128) * _cdiv(v, 128)
        dh_blocks, dw_blocks = _cdiv(t, br), _cdiv(v, br)
        waves = [_cdiv(fwd_tiles, SMS), _cdiv(dh_blocks, SMS),
                 _cdiv(dw_blocks, SMS)]
        quant = [fwd_tiles / float(waves[0] * SMS),
                 dh_blocks / float(waves[1] * SMS),
                 dw_blocks / float(waves[2] * SMS)]
        # the forward hides its copies behind stages - 1 steps of wgmma
        depth = min(1.0, (st - 1) / 2.0)
        flops = 2 * t * d * v + 8 * t * dp * v
        busy = (2 * quant[0] * depth + 4 * quant[1] + 4 * quant[2]) / 10.0
        return {"blocks": fwd_tiles + dh_blocks + dw_blocks,
                "waves": sum(waves),
                "smem": head_fwd_smem(dt, st),
                "threads": 256,
                "total_bytes": 3 * (t + v) * d * es * 2 + 16 * t + 8 * v,
                "flops": flops, "pad_waste": dp / float(d) - 1.0,
                "busy": max(busy, 0.05)}
    return None


def bound_seconds(f, dtype="float32"):
    """The card's least time for the features' work: bytes over the
    memory rate or operations over the peak of ``dtype``."""
    return max(f["total_bytes"] / HBM_BYTES_S,
               f["flops"] / PEAK_FLOPS.get(_dtype(dtype) or "float32"))


def _phi(f, dtype):
    """Fit basis: [1, waves, bound_ms / busy, smem_KB, waste x bound_ms]:
    small, each physically monotonic, shared by every family (each
    segment's weights give it its own physics)."""
    b = bound_seconds(f, dtype) * 1e3
    return np.array([1.0, float(f["waves"]), b / f["busy"],
                     f["smem"] / 1024.0, f["pad_waste"] * b],
                    dtype=np.float64)


def analytic_seconds(f, dtype="float32"):
    """The no-data proxy: the bound over the busy share, a per-wave
    overhead and the launches' own cost. Until a segment has rows only
    the ranking it induces matters."""
    return bound_seconds(f, dtype) / f["busy"] + f["waves"] * WAVE_S + \
        LAUNCH_S


# ---------------------------------------------------------------------------
# cache-key / tag plumbing shared with autotune
# ---------------------------------------------------------------------------

def config_tag(config):
    """The sweep's per-candidate tag: ``"blocks_per_sm=4"``, ``""`` for
    the default launch."""
    return ",".join("%s=%s" % kv for kv in sorted((config or {}).items()))


def parse_tag(tag):
    """Inverse of :func:`config_tag` (int-valued knobs)."""
    cfg = {}
    for item in str(tag).split(","):
        if not item:
            continue
        k, _, v = item.partition("=")
        try:
            cfg[k] = int(v)
        except ValueError:
            cfg[k] = v
    return cfg


def parse_key(key):
    """Split a ``kernel_dispatch.cache_key`` back into
    ``(op, shape, dtype, axes, backend)``, or None for a key this model
    version cannot parse (skipped, never fatal)."""
    parts = str(key).split("|")
    if len(parts) != 5:
        return None
    op, dims, dtype, axes, backend = parts
    try:
        shape = tuple(int(d) for d in dims.split("x"))
    except ValueError:
        return None
    return op, shape, dtype, axes, backend


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

#: fewer measured rows than this on a key and "best in top-k" is moot
MIN_RANK_ROWS = 4


def measured_best_in_topk(entries, model=None, k=3,
                          min_rows=MIN_RANK_ROWS):
    """Ranking-quality census over banked entries: ``(hits, judged)``
    where judged counts keys with >= ``min_rows`` numeric per-candidate
    rows and hits counts those whose measured-best config lands in the
    model's top-``k`` ranking of exactly those rows' configs. ``model``
    defaults to an in-sample fit over ``entries``."""
    data = entries.load() if hasattr(entries, "load") else dict(entries)
    if model is None:
        model = CostModel().fit_cache(data)
    hits = judged = 0
    for key, entry in data.items():
        parsed = parse_key(key)
        if parsed is None or not isinstance(entry, dict):
            continue
        results = {t: s for t, s in (entry.get("results") or {}).items()
                   if isinstance(s, (int, float))}
        if len(results) < min_rows:
            continue
        op, shape, dtype, _axes, backend = parsed
        ranked = model.rank(op, shape, [parse_tag(t) for t in results],
                            backend=backend, dtype=dtype,
                            d=entry.get("hidden"))
        topk = [config_tag(c) for c, _s, _src in ranked[:k]]
        judged += 1
        hits += min(results, key=results.get) in topk
    return hits, judged


class CostModel(object):
    """Per-family analytic and fitted cost model.

    ``candidates`` maps op -> candidate config list: the space
    :meth:`rank` / :meth:`predict_config` search when the caller hands
    none in (normally ``autotune.CANDIDATES``). Rows are segmented by
    (op, backend): one card's measurements never fit another's.

    ``predict_min_shapes``: with 0 (the JAX package's rule)
    :meth:`predict_config` predicts from the fit where a segment has one
    and from the analytic proxy elsewhere; with N > 0 it predicts only
    from a segment fitted over rows of at least N distinct shapes, and
    gives None (the kernel's default launch) elsewhere. A fit over one
    shape says which config wins there, not how the winner moves with
    the shape."""

    def __init__(self, candidates=None, predict_min_shapes=0):
        self.candidates = {op: [dict(c) for c in cfgs]
                           for op, cfgs in (candidates or {}).items()}
        self.predict_min_shapes = int(predict_min_shapes)
        self._rows = {}          # segment -> [(phi, seconds)]
        self._shapes = {}        # segment -> {shape}
        self._theta = {}         # segment -> weight vector
        self._n_rows = 0
        self._src = None         # (path, entry count) of the last fit

    # -- rows ----------------------------------------------------------
    def add_row(self, op, shape, config, seconds, backend=None,
                dtype="float32", d=None):
        """One measured (op, shape, config, dtype) -> seconds row."""
        f = features(op, shape, config, dtype, d)
        if f is None or seconds is None:
            return False
        seg = (op, backend or "-")
        self._rows.setdefault(seg, []).append(
            (_phi(f, dtype), float(seconds)))
        self._shapes.setdefault(seg, set()).add(
            tuple(int(s) for s in shape))
        self._n_rows += 1
        self._theta.pop(seg, None)     # refit lazily
        return True

    def fit_cache(self, cache):
        """Ingest every measured row an AutotuneCache banked: each
        entry's per-candidate ``results`` plus the winner's own
        ``pallas_s`` (the JAX package's field name: the hand-written
        kernel's seconds). Unparseable keys or tags are skipped: a
        hand-edited cache degrades the fit, never the load."""
        data = cache.load() if hasattr(cache, "load") else dict(cache)
        for key, entry in data.items():
            parsed = parse_key(key)
            if parsed is None or not isinstance(entry, dict):
                continue
            op, shape, dtype, _axes, backend = parsed
            d = entry.get("hidden")
            results = entry.get("results") or {}
            seen = False
            for tag, sec in results.items():
                if isinstance(sec, dict):      # rich summary row
                    sec = sec.get("measured_s")
                if not isinstance(sec, (int, float)):
                    continue
                seen |= self.add_row(op, shape, parse_tag(tag), sec,
                                     backend=backend, dtype=dtype, d=d)
            if not seen and entry.get("impl") == "pallas" and \
                    entry.get("config") and entry.get("pallas_s"):
                self.add_row(op, shape, entry["config"],
                             entry["pallas_s"], backend=backend,
                             dtype=dtype, d=d)
        self._src = (getattr(cache, "path", None), len(data))
        return self

    # -- fit / predict -------------------------------------------------
    def _weights(self, seg):
        """Per-segment weight vector over log-seconds (predictions are
        ``exp(phi . theta)``, always positive), or None below the row
        floor."""
        if seg in self._theta:
            return self._theta[seg]
        rows = self._rows.get(seg)
        theta = None
        if rows and len(rows) > len(rows[0][0]):   # never underdetermined
            A = np.stack([r[0] for r in rows])
            b = np.log(np.maximum([r[1] for r in rows], 1e-12))
            scale = np.maximum(np.abs(A).max(axis=0), 1e-12)
            sol = np.linalg.lstsq(A / scale, b, rcond=None)[0]
            theta = sol / scale
        self._theta[seg] = theta
        return theta

    #: reported predicted seconds stay within this factor of the analytic
    #: proxy (the raw fit still orders the candidates)
    REPORT_ENVELOPE = 50.0

    def _predict_raw(self, op, shape, config, backend=None,
                     dtype="float32", d=None):
        """(reported_s, raw_score, source) or None when infeasible."""
        f = features(op, shape, config, dtype, d)
        if f is None:
            return None
        ana = analytic_seconds(f, dtype)
        theta = self._weights((op, backend or "-"))
        if theta is not None:
            logt = float(np.dot(_phi(f, dtype), theta))
            if math.isfinite(logt):
                raw = math.exp(min(max(logt, -46.0), 46.0))
                env = self.REPORT_ENVELOPE
                return min(max(raw, ana / env), ana * env), raw, "fitted"
        return ana, ana, "analytic"

    def predict(self, op, shape, config, backend=None, dtype="float32",
                d=None):
        """(seconds, source) for one candidate, or (None, None) when it
        cannot run the call. source is "fitted" | "analytic"."""
        out = self._predict_raw(op, shape, config, backend, dtype, d)
        if out is None:
            return None, None
        return out[0], out[2]

    def rank(self, op, shape, candidates=None, backend=None,
             dtype="float32", d=None):
        """Candidates ordered by predicted seconds (infeasible ones
        dropped): list of ``(config, predicted_s, source)``."""
        if candidates is None:
            candidates = self.candidates.get(op, ())
        scored = []
        for cfg in candidates:
            out = self._predict_raw(op, shape, cfg, backend, dtype, d)
            if out is not None:
                scored.append((dict(cfg), out[0], out[2], out[1]))
        scored.sort(key=lambda x: x[3])
        return [(c, t, src) for c, t, src, _raw in scored]

    def top_k(self, op, shape, candidates=None, k=3, backend=None,
              dtype="float32", d=None):
        """The pruned sweep: the K best-predicted feasible candidates."""
        return self.rank(op, shape, candidates, backend, dtype,
                         d)[:max(1, int(k))]

    def predict_config(self, op, shape, backend=None, dtype="float32",
                       d=None):
        """Best predicted config for a never-swept shape, or None when
        nothing in the candidate space runs it or the segment falls short
        of ``predict_min_shapes`` (the caller keeps the kernel's
        default)."""
        seg = (op, backend or "-")
        if self.predict_min_shapes and (
                self._weights(seg) is None or
                len(self._shapes.get(seg, ())) < self.predict_min_shapes):
            return None
        best = self.top_k(op, shape, k=1, backend=backend, dtype=dtype,
                          d=d)
        if not best:
            return None
        cfg, sec, src = best[0]
        return {"config": cfg, "predicted_s": sec, "source": src}

    # -- identity ------------------------------------------------------
    def rows_total(self):
        return self._n_rows

    def fingerprint(self):
        """Stable identity of (model version, candidate space, fitted
        rows): joins the Executor's compile token, so a re-banked cache
        re-plans."""
        h = hashlib.sha1()
        h.update(b"v%d|" % MODEL_VERSION)
        h.update(json.dumps(self.candidates, sort_keys=True,
                            default=str).encode())
        for seg in sorted(self._rows):
            rows = self._rows[seg]
            h.update(("%s|%d|" % (seg, len(rows))).encode())
            h.update(np.array([r[1] for r in rows]).tobytes())
        return h.hexdigest()[:16]

    def stats(self):
        segs = sorted(self._rows)
        return {"model_version": MODEL_VERSION,
                "rows": self._n_rows,
                "segments": ["%s@%s" % seg for seg in segs],
                "fitted": ["%s@%s" % seg for seg in segs
                           if self._weights(seg) is not None],
                "fingerprint": self.fingerprint()}
